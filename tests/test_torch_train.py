"""FusionNet training of the port (rcfd_tpu_torch.fusionnet_main) against
the JAX package's (rcfd_tpu.fusionnet_main) on the CPU: the train step in
float64, learning on a fixed batch, checkpoints both ways and
auto-resume, validation, the training loop in process, and the CLI. The
tiny configuration is tests/test_learning_sanity.py's. Each test states
its tolerance."""

import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rcfd_tpu import fusionnet_main as jax_main  # noqa: E402
from rcfd_tpu.data import datasets as jax_datasets  # noqa: E402
from rcfd_tpu.data import loader as jax_loader  # noqa: E402
from rcfd_tpu.data.transforms import Transforms as JaxTransforms  # noqa
from rcfd_tpu.models import FusionNetModel as JaxFusionNet  # noqa: E402
from rcfd_tpu.utils import checkpoint as jax_ckpt  # noqa: E402

from rcfd_tpu_torch import fusionnet_main  # noqa: E402
from rcfd_tpu_torch import train_fusionnet  # noqa: E402
from rcfd_tpu_torch.data import datasets  # noqa: E402
from rcfd_tpu_torch.data.transforms import Transforms  # noqa: E402
from rcfd_tpu_torch.models import FusionNetModel  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

from fixtures import make_fusionnet_fixture  # noqa: E402
from torch_parity import randomize_batch_norm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_learning_sanity.py:20-28
CONFIG = dict(
    input_channels_image=3, input_channels_depth=2,
    encoder_type='fusionnet18_batch_norm',
    n_filters_encoder_image=[8, 12, 16, 16, 16],
    n_filters_encoder_depth=[4, 6, 8, 8, 8],
    fusion_type='weight_and_project', decoder_type='multiscale_batch_norm',
    n_resolution_decoder=1, n_filters_decoder=[16, 12, 8, 8, 8],
    min_predict_depth=1.0, max_predict_depth=100.0)
# train()'s network and training arguments at CONFIG, augmentation off
NET = dict(
    input_channels_image=3, input_channels_depth=2,
    normalized_image_range=[0, 1], encoder_type='fusionnet18_batch_norm',
    n_filters_encoder_image=CONFIG['n_filters_encoder_image'],
    n_filters_encoder_depth=CONFIG['n_filters_encoder_depth'],
    fusion_type='weight_and_project', decoder_type='multiscale_batch_norm',
    n_filters_decoder=CONFIG['n_filters_decoder'], n_resolutions_decoder=1,
    min_predict_depth=1.0, max_predict_depth=100.0,
    weight_initializer='kaiming_uniform', activation_func='leaky_relu')
TRAIN = dict(
    batch_size=2, n_height=32, n_width=32, learning_rates=[1e-3],
    learning_schedule=[1], loss_func='l1', w_smoothness=0.0,
    w_lidar_loss=2.0, w_weight_decay=0.0, loss_smoothness_kernel_size=-1,
    outlier_removal_kernel_size=7, outlier_removal_threshold=1.5,
    ground_truth_dilation_kernel_size=-1, augmentation_probabilities=[0.0],
    augmentation_schedule=[-1],
    augmentation_random_crop_type=['horizontal', 'vertical'],
    augmentation_random_brightness=[-1, -1],
    augmentation_random_contrast=[-1, -1],
    augmentation_random_saturation=[-1, -1],
    augmentation_random_flip_type=['none'], min_evaluate_depth=0.0,
    max_evaluate_depth=100.0, n_step_per_checkpoint=1,
    n_step_per_summary=100, start_step_validation=10 ** 9, n_thread=2,
    seed=0)
FRAME = (40, 48)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The port's tiny steps on one thread: the tests' maps are 32 x 32, and
    a thread per core, in each of several test processes at once, spends
    the time waiting on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    m = make_fusionnet_fixture(str(tmp_path_factory.mktemp('fn')),
                               n_samples=4, height=FRAME[0], width=FRAME[1])
    return dict(train_image_path=m['image'], train_depth_path=m['depth'],
                train_response_path=m['response'],
                train_ground_truth_path=m['ground_truth'],
                train_lidar_map_path=m['lidar'],
                val_image_path=m['image'], val_depth_path=m['depth'],
                val_response_path=m['response'],
                val_ground_truth_path=m['ground_truth'])


def _batch(rng, n=2, h=32, w=32):
    image = rng.integers(0, 256, (n, h, w, 3)).astype(np.float64)
    depth = rng.random((n, h, w, 1)) * 60
    depth[depth < 30] = 0.0
    response = rng.random((n, h, w, 1))
    gt = rng.random((n, h, w, 1)) * 70 + 1
    gt[rng.random((n, h, w, 1)) < 0.6] = 0.0
    lidar = rng.random((n, h, w, 1)) * 70 + 1
    lidar[rng.random((n, h, w, 1)) < 0.9] = 0.0
    return image, depth, response, gt, lidar


@functools.lru_cache(maxsize=None)
def _jax_init_fn():
    """JAX's init of CONFIG, jitted once for every seed (a compile takes
    about 15 s on the CPU; the eager init dispatches op by op for half a
    minute)."""
    return jax.jit(JaxFusionNet(**CONFIG).init)


@functools.lru_cache(maxsize=None)
def _jax_init(seed):
    """JAX's init at PRNGKey(seed); callers copy before they change it."""
    return jax.device_get(_jax_init_fn()(jax.random.PRNGKey(seed)))


def _jax_variables(seed, rng, dtype=np.float32):
    params, state = _jax_init(seed)
    params, state = randomize_batch_norm(params, state, rng)
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: np.asarray(x, dtype)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
        else np.asarray(x), t)
    return cast(params), cast(state)


def _port_model(params, state, dtype=torch.float32):
    model = FusionNetModel(**CONFIG, device='cpu', trainable=True)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return model.to(dtype)


STEP_KW = dict(loss_func='l1', w_lidar_loss=2.0, w_weight_decay=0.0,
               outlier_kernel_size=7, outlier_threshold=1.5,
               dilation_kernel_size=3)


@pytest.mark.parametrize('smoothness_kernel', [1, 7])
def test_train_step_matches_jax_float64(rng, smoothness_kernel, monkeypatch):
    """One train step in float64 on both sides (JAX's own
    _make_train_step, its Adam swapped for a function that hands back the
    gradients), augmentation off, w_smoothness 0.1 at the kernel,
    w_lidar_loss 2.0, outlier removal 7/1.5, dilation 3: loss rtol 1e-10,
    every gradient within 1e-8 of its max-abs, the running statistics
    rtol 1e-10 and the batch counts equal."""
    # the weights are drawn before x64 is on, so that the init compiled
    # for the other tests serves this one too
    params, state = _jax_variables(0, rng, np.float64)
    jax.config.update('jax_enable_x64', True)
    try:
        batch = _batch(rng)
        monkeypatch.setattr(jax_main, 'adam_step',
                            lambda p, grads, opt, lr, weight_decay: (grads,
                                                                     opt))
        step = jax.jit(jax_main._make_train_step(
            JaxFusionNet(**CONFIG), JaxTransforms(normalized_image_range=[
                0, 1]), w_smoothness=0.1,
            loss_smoothness_kernel_size=smoothness_kernel, **STEP_KW))
        grads, new_state, _, info = step(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state), None,
            tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(3),
            1e-3, 0.0)
        grads = jax_ckpt.tree_to_torch_state_dict(jax.device_get(grads))
        ref_state = state_dict_from_jax(params, jax.device_get(new_state))
    finally:
        jax.config.update('jax_enable_x64', False)

    model = _port_model(params, state, torch.float64)
    transforms = Transforms(normalized_image_range=[0, 1])
    kw = {k: v for k, v in STEP_KW.items() if k != 'w_weight_decay'}
    port = fusionnet_main.TrainStep(
        model, transforms, fusionnet_main.make_optimizer(model, 1e-3, 0.0),
        w_smoothness=0.1, loss_smoothness_kernel_size=smoothness_kernel,
        **kw)
    draws = transforms.draws(torch.Generator().manual_seed(0), 2, 0.0)
    info_port = port.backward(tuple(torch.from_numpy(a) for a in batch),
                              draws)
    for k in ('loss', 'loss_supervised', 'loss_smoothness', 'loss_lidar'):
        np.testing.assert_allclose(float(info_port[k]), float(info[k]),
                                   rtol=1e-10, err_msg=k)
    checked = 0
    for name, p in model.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        ref = grads[name]
        scale = max(np.abs(ref).max(), 1e-300)
        assert np.abs(g - ref).max() <= 1e-8 * scale, name
        checked += int(np.abs(ref).max() > 0)
    assert checked > 100
    for name, buf in model.named_buffers():
        if name.endswith('num_batches_tracked'):
            assert int(buf) == int(ref_state[name]) == 1, name
        else:
            np.testing.assert_allclose(buf.numpy(), ref_state[name].numpy(),
                                       rtol=1e-10, err_msg=name)


def test_overfits_a_fixed_batch(rng):
    """tests/test_learning_sanity.py's protocol on the port, from the same
    initial weights (JAX's init at PRNGKey(0)) and batch: a constant 20 m
    target, 60 steps of Adam at 3e-3 without augmentation; the last loss
    below 0.3 of the first."""
    batch = (rng.random((2, 32, 32, 3), dtype=np.float32) * 255,
             rng.random((2, 32, 32, 1), dtype=np.float32) * 60,
             rng.random((2, 32, 32, 1), dtype=np.float32),
             np.full((2, 32, 32, 1), 20.0, np.float32),
             np.zeros((2, 32, 32, 1), np.float32))
    model = _port_model(*_jax_init(0))
    transforms = Transforms(normalized_image_range=[0, 1])
    step = fusionnet_main.TrainStep(
        model, transforms, fusionnet_main.make_optimizer(model, 3e-3, 0.0),
        'l1', 0.0, 0.0, -1, -1, -1, -1)
    batch = tuple(torch.from_numpy(a) for a in batch)
    gen = torch.Generator().manual_seed(1)
    loss = [float(step(batch, transforms.draws(gen, 2, 0.0), 3e-3)['loss'])
            for _ in range(60)]
    assert np.isfinite(loss).all()
    assert loss[-1] < 0.3 * loss[0], loss[::10]


def _trained_port_model(rng, steps=2):
    """A port model and its Adam after ``steps`` steps on random batches
    (nonzero moments and running statistics)."""
    params, state = _jax_variables(0, rng)
    model = _port_model(params, state)
    transforms = Transforms(normalized_image_range=[0, 1])
    optimizer = fusionnet_main.make_optimizer(model, 1e-3, 1e-4)
    step = fusionnet_main.TrainStep(model, transforms, optimizer, 'l1', 0.0,
                                    2.0, -1, 7, 1.5, -1)
    gen = torch.Generator().manual_seed(2)
    for _ in range(steps):
        batch = tuple(torch.from_numpy(a.astype(np.float32))
                      for a in _batch(rng))
        step(batch, transforms.draws(gen, 2, 0.0), 1e-3)
    return model, optimizer


def test_port_checkpoints_restore_in_jax(rng, tmp_path):
    """A port .pth restores in rcfd_tpu's FusionNetModel.restore_checkpoint
    with the params, state and step exact, and torch_adam_to_optax gives
    the port's Adam moments exact (zeros for the parameters that never had
    a gradient, as JAX keeps them); a port .npz restores exact too."""
    model, optimizer = _trained_port_model(rng)
    jax_model = JaxFusionNet(**CONFIG)
    want = model.state_dict()
    for ext in ('npz', 'pth'):
        path = str(tmp_path / 'model-7.{}'.format(ext))
        model.save_checkpoint(path, 7, optimizer.state_dict())
        params, state, step, opt_sd = jax_model.restore_checkpoint(path)
        assert step == 7
        got = state_dict_from_jax(params, state)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k].cpu()), (ext, k)
    opt = jax_ckpt.torch_adam_to_optax(params, opt_sd)
    assert int(opt['count']) == 2
    mu, nu = (state_dict_from_jax(opt[k]) for k in ('mu', 'nu'))
    for name, p in model.named_parameters():
        # a parameter that never had a gradient has zero moments
        s = optimizer.state.get(p) or {'exp_avg': torch.zeros_like(p),
                                       'exp_avg_sq': torch.zeros_like(p)}
        assert torch.equal(mu[name], s['exp_avg']), name
        assert torch.equal(nu[name], s['exp_avg_sq']), name


def test_jax_checkpoints_restore_in_port(rng, tmp_path):
    """A JAX .pth (with an Adam state of random moments at step 3, as JAX
    exports it) restores in the port: weights, step and the loaded
    optimizer's moments exact."""
    params, state = _jax_variables(1, rng)
    opt = {'count': np.int32(3),
           'mu': jax.tree_util.tree_map(
               lambda x: rng.normal(size=x.shape).astype(x.dtype), params),
           'nu': jax.tree_util.tree_map(
               lambda x: rng.random(x.shape).astype(x.dtype), params)}
    path = str(tmp_path / 'model-3.pth')
    JaxFusionNet(**CONFIG).save_checkpoint(
        path, params, state, step=3,
        optimizer_state_dict=jax_ckpt.optax_adam_to_torch_state(
            params, opt, 1e-3, 0.0))
    model = FusionNetModel(**CONFIG, device='cpu', trainable=True)
    step, opt_sd = model.restore_checkpoint(path, device='cpu',
                                            return_optimizer_state=True)
    assert step == 3
    want = state_dict_from_jax(params, state)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    optimizer = fusionnet_main.make_optimizer(model, 1e-3, 0.0)
    optimizer.load_state_dict(opt_sd)
    mu, nu = (state_dict_from_jax(opt[k]) for k in ('mu', 'nu'))
    for name, p in model.named_parameters():
        s = optimizer.state[p]
        assert int(s['step']) == 3
        assert torch.equal(s['exp_avg'], mu[name]), name
        assert torch.equal(s['exp_avg_sq'], nu[name]), name


def test_validate_matches_jax(data, rng):
    """The port's validate against rcfd_tpu.fusionnet_main.validate on the
    fixture's frames at the same weights: the best results rtol 1e-5, the
    same step, and the same vote from a best that is better in two metrics
    (no update) and one better in one (an update)."""
    params, state = _jax_variables(2, rng)
    jax_model = JaxFusionNet(**CONFIG)
    paths = [datasets_read(data[k]) for k in (
        'val_image_path', 'val_depth_path', 'val_response_path',
        'val_ground_truth_path')]
    jax_fn = jax_main.make_forward_fn(
        jax_model, JaxTransforms(normalized_image_range=[0, 1]))
    model = _port_model(params, state)
    port_fn = fusionnet_main.make_forward_fn(
        model, Transforms(normalized_image_range=[0, 1]))
    inf = {'step': -1, 'mae': np.inf, 'rmse': np.inf, 'imae': np.inf,
           'irmse': np.inf}
    ref = jax_main.validate(
        jax_model, params, state, jax_fn,
        jax_datasets.FusionNetInferenceDataset(*paths, transport=True), 5,
        dict(inf), 0.0, 100.0, None, eval_batch_size=1)
    got = fusionnet_main.validate(
        port_fn, datasets.FusionNetInferenceDataset(*paths, device='cpu'), 5,
        dict(inf), 0.0, 100.0, eval_batch_size=3, device='cpu')
    assert got['step'] == ref['step'] == 5
    for k in ('mae', 'rmse', 'imae', 'irmse'):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    assert model.training  # validate leaves the model's mode as it was
    for better in (('mae', 'rmse'), ('mae',)):
        best = dict(ref, step=1, **{k: ref[k] - 1.0 for k in better})
        ref2 = jax_main.validate(
            jax_model, params, state, jax_fn,
            jax_datasets.FusionNetInferenceDataset(*paths, transport=True),
            6, dict(best), 0.0, 100.0, None)
        got2 = fusionnet_main.validate(
            port_fn, datasets.FusionNetInferenceDataset(*paths,
                                                        device='cpu'),
            6, dict(best), 0.0, 100.0, device='cpu')
        assert got2['step'] == ref2['step'] == (1 if len(better) == 2 else 6)


def datasets_read(path):
    from rcfd_tpu_torch.data import io
    return io.read_paths(path)


def _record(store, prefetch):
    def wrapped(iterator, *args, **kwargs):
        for batch in prefetch(iterator, *args, **kwargs):
            store.append([np.asarray(t).copy() for t in batch])
            yield batch
    return wrapped


def _structure(path):
    """results.txt with every number and path replaced by #."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r'/\S+', '#', text)
    return re.sub(r'[-+]?(\d+\.?\d*(e[-+]?\d+)?|inf|nan)', '#', text
                  ).splitlines()


def test_train_matches_jax_train(data, tmp_path, rng, monkeypatch):
    """fusionnet_main.train of both packages in process from one JAX-saved
    step-0 .pth, augmentation off, 2 steps with a checkpoint at each: the
    batches fed exactly; the step-1 loss rtol 1e-4; the checkpoints' steps,
    keys and shapes; the results.txt line structure."""
    params, state = _jax_variables(3, rng)
    start = str(tmp_path / 'model-0.pth')
    JaxFusionNet(**CONFIG).save_checkpoint(start, params, state, step=0)
    fed = {'jax': [], 'port': []}
    monkeypatch.setattr(jax_loader, 'device_prefetch',
                        _record(fed['jax'], jax_loader.device_prefetch))
    monkeypatch.setattr(fusionnet_main, 'device_prefetch',
                        _record(fed['port'], fusionnet_main.device_prefetch))
    dirs = {k: str(tmp_path / k) for k in fed}
    jax_main.train(checkpoint_dirpath=dirs['jax'], restore_path=start,
                   device='cpu', n_data_parallel=1, **data, **NET, **TRAIN)
    timings = []
    fusionnet_main.train(checkpoint_dirpath=dirs['port'], restore_path=start,
                         device='cpu', timings=timings, **data, **NET,
                         **TRAIN)
    assert len(fed['port']) == len(fed['jax']) == 2
    for a, b in zip(fed['port'], fed['jax']):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    losses = {}
    for k, d in dirs.items():
        with open(os.path.join(d, 'results.txt')) as f:
            losses[k] = [float(v) for v in re.findall(
                r'Step=\s+\d+/\d+\s+Loss=(\S+)', f.read())]
    assert len(losses['port']) == len(losses['jax']) == 2
    np.testing.assert_allclose(losses['port'][0], losses['jax'][0],
                               rtol=1e-4)
    assert [t['step'] for t in timings] == [1, 2]
    names = sorted(f for f in os.listdir(dirs['jax']) if f.endswith('.pth'))
    assert names == ['model-1.pth', 'model-2.pth']
    assert sorted(f for f in os.listdir(dirs['port'])
                  if f.endswith('.pth')) == names
    for name in names:
        a, b = (torch.load(os.path.join(dirs[k], name), weights_only=True)
                for k in ('port', 'jax'))
        assert sorted(a) == sorted(b)
        assert a['train_step'] == b['train_step'] == int(name[6])
        for key in ('encoder_state_dict', 'decoder_state_dict'):
            # JAX writes its keys sorted, the port in registration order
            assert sorted(a[key]) == sorted(b[key])
            for k in a[key]:
                if k.endswith('num_batches_tracked'):
                    # one count: torch and the port keep a scalar, the JAX
                    # package writes shape (1,)
                    assert a[key][k].numel() == b[key][k].numel() == 1
                else:
                    assert a[key][k].shape == b[key][k].shape, k
        sa, sb = (c['optimizer_state_dict']['state'] for c in (a, b))
        assert sorted(sa) == sorted(sb)
        for i in sa:
            assert int(sa[i]['step']) == int(sb[i]['step']) == int(name[6])
            assert sa[i]['exp_avg'].shape == tuple(sb[i]['exp_avg'].shape)
    assert _structure(os.path.join(dirs['port'], 'results.txt')) == \
        _structure(os.path.join(dirs['jax'], 'results.txt'))


def test_restore_latest_resumes_at_the_newest_step(data, tmp_path):
    """--restore_path latest restores the newest checkpoint, with its Adam
    state, and runs the schedule's remaining steps: 2 steps, then resumed
    at schedule 2 the steps 3 and 4, ending with an Adam step of 4."""
    ckpt = str(tmp_path / 'ckpt')
    timings = []
    fusionnet_main.train(checkpoint_dirpath=ckpt, restore_path=None,
                         device='cpu', **data, **NET, **TRAIN)
    fusionnet_main.train(checkpoint_dirpath=ckpt, restore_path='latest',
                         device='cpu', timings=timings, **data, **NET,
                         **dict(TRAIN, learning_schedule=[2]))
    assert [t['step'] for t in timings] == [3, 4]
    assert sorted(f for f in os.listdir(ckpt) if f.endswith('.pth')) == [
        'model-{}.pth'.format(i) for i in range(1, 5)]
    last = torch.load(os.path.join(ckpt, 'model-4.pth'), weights_only=True)
    assert last['train_step'] == 4
    assert int(last['optimizer_state_dict']['state'][0]['step']) == 4
    with open(os.path.join(ckpt, 'results.txt')) as f:
        assert 'Auto-resume from: {}'.format(
            os.path.join(ckpt, 'model-2.pth')) in f.read()


def test_resumed_run_feeds_and_draws_as_an_uninterrupted_run(
        data, tmp_path, monkeypatch):
    """With augmentation on (probability 1, the photometric ops, flips):
    2 steps, then resumed from 'latest' to 4, feed the same batches, draw
    the same augmentation and give the same losses (exactly: the same
    float32 ops on the CPU from exactly restored weights and Adam state) as
    4 steps straight through."""
    augment = dict(TRAIN, augmentation_probabilities=[1.0],
                   augmentation_random_brightness=[0.8, 1.2],
                   augmentation_random_contrast=[0.8, 1.2],
                   augmentation_random_saturation=[0.8, 1.2],
                   augmentation_random_flip_type=['horizontal', 'vertical'])
    runs = {}
    prefetch, draws = fusionnet_main.device_prefetch, Transforms.draws
    for name, schedules in (('straight', [[2]]), ('resumed', [[1], [2]])):
        fed, drawn, timings = [], [], []
        monkeypatch.setattr(
            Transforms, 'draws',
            lambda self, *a: drawn.append(draws(self, *a)) or drawn[-1])
        monkeypatch.setattr(fusionnet_main, 'device_prefetch',
                            _record(fed, prefetch))
        for schedule in schedules:
            fusionnet_main.train(
                checkpoint_dirpath=str(tmp_path / name),
                restore_path='latest' if schedule != schedules[0] else None,
                device='cpu', timings=timings, **data, **NET,
                **dict(augment, learning_schedule=schedule))
        runs[name] = fed, drawn, timings
    (fed_a, drawn_a, t_a), (fed_b, drawn_b, t_b) = runs.values()
    assert [t['step'] for t in t_a] == [t['step'] for t in t_b] == [1, 2, 3,
                                                                    4]
    assert len(fed_a) == len(fed_b) == len(drawn_a) == len(drawn_b) == 4
    for a, b in zip(fed_a, fed_b):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(drawn_a, drawn_b):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    # augmentation was on: every gate opened at least once
    assert all(any(bool(d[k].any()) for d in drawn_a)
               for k in drawn_a[0] if not k.endswith('_factor'))
    assert [t['loss'] for t in t_a] == [t['loss'] for t in t_b]


def test_cli_trains_on_the_cpu(data, tmp_path):
    """python -m rcfd_tpu_torch.train_fusionnet --device cpu, 2 steps."""
    flags = []
    for k, v in dict(data, **NET, **TRAIN).items():
        if k == 'n_resolutions_decoder':
            continue
        if k in ('encoder_type', 'decoder_type'):
            v = v.split('_', 1)
        flags.append('--' + k)
        flags += [str(x) for x in v] if isinstance(v, (list, tuple)) \
            else [str(v)]
    out = str(tmp_path / 'out')
    proc = subprocess.run(
        [sys.executable, '-m', 'rcfd_tpu_torch.train_fusionnet', *flags,
         '--checkpoint_dirpath', out, '--device', 'cpu'], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS='1'), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'TF32 off' in proc.stdout
    assert sorted(f for f in os.listdir(out) if f.endswith('.pth')) == [
        'model-1.pth', 'model-2.pth']


@pytest.mark.parametrize('kwargs,env,match', [
    (dict(device='tpu'), None, 'tpu'),
    # a global batch (2) that the ranks (3) do not divide, as JAX asserts
    (dict(device='cpu', n_data_parallel=3), None, 'n_data_parallel'),
    (dict(device='cpu'), 'float16', 'RCFD_TRAIN_DTYPE'),
])
def test_train_refuses_what_is_not_ported(data, tmp_path, monkeypatch,
                                          kwargs, env, match):
    if env:
        monkeypatch.setenv('RCFD_TRAIN_DTYPE', env)
    with pytest.raises(ValueError, match=match):
        fusionnet_main.train(checkpoint_dirpath=str(tmp_path), restore_path=None,
                             **kwargs, **data, **NET, **TRAIN)
    assert not os.listdir(tmp_path)


def test_train_needs_a_card_unless_asked_for_cpu(data, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_fusionnet.main([
            '--train_image_path', data['train_image_path'],
            '--train_depth_path', data['train_depth_path'],
            '--train_response_path', data['train_response_path'],
            '--train_ground_truth_path', data['train_ground_truth_path'],
            '--train_lidar_map_path', data['train_lidar_map_path'],
            '--val_image_path', data['val_image_path'],
            '--val_depth_path', data['val_depth_path'],
            '--val_response_path', data['val_response_path'],
            '--val_ground_truth_path', data['val_ground_truth_path'],
            '--checkpoint_dirpath', str(tmp_path)], device=None)
