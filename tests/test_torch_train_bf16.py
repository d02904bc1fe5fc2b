"""bf16 training of the port (RCFD_TRAIN_DTYPE=bfloat16) against the JAX
package's on the CPU: the training batch norm on bf16 input, the gradient
of the column crop in bf16, one train step of each model (JAX's own step,
its Adam swapped for a function that hands back the gradients, the same
weights, batch and draws), checkpoints of bf16 training, and the dtypes
that are refused. Each test states its tolerance.

What a bf16 gradient can be held to. JAX's steps run here on XLA's CPU
backend, which sums a bf16 cotangent over the pixels of a map (the
gradients of the batch norms' scale and shift, and every gradient that
flows through them) in bf16, one term after another: 2048 terms of about 1
stop growing at 512. PyTorch sums them in float32 and rounds once. So the
port's bf16 gradients are held to the float64 step of the same weights and
batch, the truth both approximate, and the JAX step's distance from it is
the bound of the port's; the port's distance from the JAX step is JAX's own
error and is held only loosely. Sizes are such that no batch norm
normalizes fewer than 16 values: over 2 values, E[x^2] - mean^2 in bf16 is
all cancellation and both packages' gradients are noise."""

import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rcfd_tpu import fusionnet_main as jax_fusionnet_main  # noqa: E402
from rcfd_tpu import radarnet_main as jax_radarnet_main  # noqa: E402
from rcfd_tpu.data.transforms import Transforms as JaxTransforms  # noqa
from rcfd_tpu.models import FusionNetModel as JaxFusionNet  # noqa: E402
from rcfd_tpu.models import RadarNetModel as JaxRadarNet  # noqa: E402
from rcfd_tpu.nn.layers import BatchNorm2d as JaxBatchNorm2d  # noqa: E402
from rcfd_tpu.utils import checkpoint as jax_ckpt  # noqa: E402

from rcfd_tpu_torch import fusionnet_main, radarnet_main  # noqa: E402
from rcfd_tpu_torch import train_fusionnet, train_radarnet  # noqa: E402
from rcfd_tpu_torch import training  # noqa: E402
from rcfd_tpu_torch.data.transforms import Transforms  # noqa: E402
from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel  # noqa
from rcfd_tpu_torch.nn.layers import BatchNorm2d  # noqa: E402
from rcfd_tpu_torch.ops.crop_cuda import \
    batch_column_crop_backward_plain  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

from fixtures import make_fusionnet_fixture  # noqa: E402
from fixtures import make_radarnet_fixture  # noqa: E402
from torch_parity import RADARNET_TINY, randomize_batch_norm  # noqa: E402

BF16_EPS = 2.0 ** -8  # a bf16 rounding, relative
FUSIONNET = dict(
    input_channels_image=3, input_channels_depth=2,
    encoder_type='fusionnet18_batch_norm',
    n_filters_encoder_image=[8, 12, 16, 16, 16],
    n_filters_encoder_depth=[4, 6, 8, 8, 8],
    fusion_type='weight_and_project', decoder_type='multiscale_batch_norm',
    n_resolution_decoder=1, n_filters_decoder=[16, 12, 8, 8, 8],
    min_predict_depth=1.0, max_predict_depth=100.0)
# the bf16 step: its loss within LOSS_RTOL of JAX's; every gradient within
# TRUTH_TOL of the largest gradient of the float64 step (measured
# 0.035-0.20), and the port's largest distance from it no larger than the
# JAX step's (measured 0.10-0.40); the port's distance from the JAX step
# within JAX_TOL of it (measured up to 0.40: JAX's own error); the running
# statistics within STATS_TOL of their largest (bf16 activations)
LOSS_RTOL, TRUTH_TOL, JAX_TOL, STATS_TOL = 2.0 ** -7, 0.25, 0.5, 2e-2


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The port's tiny steps on one thread (tests/test_torch_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(a):
    """numpy float32 values rounded to bf16 (as float32)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# -- batch norm ----------------------------------------------------------------


@pytest.mark.parametrize('shape', [(2, 16, 16, 8), (4, 9, 7, 5),
                                   (3, 4, 4, 16)])
def test_bf16_batch_norm_matches_jax_training(rng, shape):
    """The training batch norm on bf16 input against JAX's BatchNorm2d in
    training: the output within one bf16 rounding of its magnitude
    (measured: equal), the running mean and variance within 1e-5, the
    batch counted; float32 parameters and statistics stay float32."""
    n, h, w, c = shape
    x = _bf16((rng.standard_normal(shape) * 3 + 1).astype(np.float32))
    weight = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.3, c).astype(np.float32)
    mean0 = rng.normal(0, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jbn = JaxBatchNorm2d(c)
    y, state = jax.jit(lambda p, s, x: jbn(p, s, x, training=True))(
        {'weight': jnp.asarray(weight), 'bias': jnp.asarray(bias)},
        {'running_mean': jnp.asarray(mean0), 'running_var': jnp.asarray(var0),
         'num_batches_tracked': jnp.zeros((), jnp.int32)},
        jnp.asarray(x, jnp.bfloat16))
    ref = np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2)

    bn = BatchNorm2d(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    out = bn(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().detach().numpy() - ref).max() <= \
        BF16_EPS * np.abs(ref).max()
    for name in ('running_mean', 'running_var'):
        buf = getattr(bn, name)
        assert buf.dtype == torch.float32
        np.testing.assert_allclose(buf.numpy(), np.asarray(state[name]),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert int(bn.num_batches_tracked) == 1
    assert bn.weight.dtype == torch.float32


def test_float32_training_batch_norm_is_torchs(rng):
    """On float32 input the training batch norm is torch's
    batch_norm(training=True), bit for bit, its statistics too."""
    x = torch.from_numpy(rng.standard_normal((3, 6, 5, 4)).astype(np.float32))
    bn = BatchNorm2d(6).train()
    mean, var = torch.zeros(6), torch.ones(6)
    ref = torch.nn.functional.batch_norm(x, mean, var, bn.weight, bn.bias,
                                         True, 0.1, 1e-5)
    assert torch.equal(bn(x), ref)
    assert torch.equal(bn.running_mean, mean) and \
        torch.equal(bn.running_var, var)


# -- the column crop's gradient ------------------------------------------------


@pytest.mark.parametrize('n,c,ph,w,k,win', [
    (6, 8, 4, 25, 4, 10),   # a 900x300 train step's windows a frame
    (2, 4, 3, 40, 24, 12),  # up to 13 windows over one column
])
def test_crop_backward_bf16_matches_jax_transpose(rng, n, c, ph, w, k, win):
    """The crop's gradient in bf16 (the card's backward of K2) against
    jax.vjp of the JAX package's XLA formulation (a vmapped dynamic_slice of
    the padded rows, rcfd_tpu/ops/roi_pool.py:246-256) in bf16. JAX adds
    overlapping windows' gradients in bf16 one after another; the port adds
    them in float32 and rounds once: within one bf16 rounding of the exact
    sum, and within JAX's own rounding bound of JAX's (m roundings of at
    most 2^-8 of the sum of the terms' magnitudes, m the windows over a
    column; measured: 0.28%-0.73% of the largest gradient)."""
    rows = rng.standard_normal((n, ph, w, c)).astype(np.float32)
    starts = rng.integers(0, w + 1, (n, k)).astype(np.int32)
    g = _bf16(rng.standard_normal((n, k, ph, win, c)).astype(np.float32))

    def crop(r):
        rp = jnp.pad(r, ((0, 0), (0, 0), (0, win), (0, 0)))

        def one(rn, s):
            return jax.lax.dynamic_slice(rn, (0, s, 0), (ph, win, c))
        return jax.vmap(lambda rn, sk: jax.vmap(lambda s: one(rn, s))(sk))(
            rp, jnp.asarray(starts))

    _, vjp = jax.vjp(crop, jnp.asarray(rows, jnp.bfloat16))
    ref = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0].astype(
        jnp.float32))                                      # (N, ph, W, C)
    grad = torch.from_numpy(g).permute(0, 1, 4, 2, 3).reshape(
        n * k, c, ph, win).to(torch.bfloat16)
    out = batch_column_crop_backward_plain(
        grad, torch.from_numpy(starts), (n, c, ph, w), win)
    assert out.dtype == torch.bfloat16
    out = out.float().permute(0, 2, 3, 1).numpy()

    exact = np.zeros((n, ph, w + win, c))
    magnitude = np.zeros_like(exact)
    over = np.zeros((n, w + win))
    for i in range(n):
        for j in range(k):
            s = starts[i, j]
            exact[i, :, s:s + win] += g[i, j]
            magnitude[i, :, s:s + win] += np.abs(g[i, j])
            over[i, s:s + win] += 1
    exact, magnitude = exact[:, :, :w], magnitude[:, :, :w]
    assert np.all(np.abs(out - exact) <= BF16_EPS * np.abs(exact))
    m = over.max()
    assert np.all(np.abs(out - ref) <= m * BF16_EPS * magnitude)
    share = np.abs(out - ref).max() / np.abs(ref).max()
    print('crop gradient: {} windows over a column at most; the port from '
          'JAX\'s: {:.3g} of the largest gradient, {} of {} values differ'
          .format(int(m), share, int((out != ref).sum()), out.size))
    assert share <= 2.0 ** -7


# -- a bf16 train step against JAX's -----------------------------------------


def _jax_gradient_step(make_step, monkeypatch):
    """JAX's train step with its Adam handing back the gradients."""
    module = make_step.__module__
    monkeypatch.setattr(
        {'rcfd_tpu.radarnet_main': jax_radarnet_main,
         'rcfd_tpu.fusionnet_main': jax_fusionnet_main}[module],
        'adam_step', lambda p, grads, opt, lr, weight_decay: (grads, opt))


def _radarnet_case(rng, patch, monkeypatch):
    """RadarNet at RADARNET_TINY's widths and ``patch``: 2 frames of 96
    columns, 3 points each, ground truth near the points' depths; JAX's
    gradients, statistics and loss; the port's model and step inputs."""
    ph, pw = patch
    cfg = dict(RADARNET_TINY, input_patch_size_image=patch)
    params, state = randomize_batch_norm(*jax.device_get(
        JaxRadarNet(**cfg).init(jax.random.PRNGKey(0))), rng)
    b, k, w, pad = 2, 3, 96, pw // 2
    x = rng.integers(0, w, (b, k)).astype(np.float32) + 0.25
    points = np.stack([x + pad, rng.random((b, k)) * ph,
                       rng.random((b, k)) * 60 + 5], -1).astype(np.float32)
    boxes = np.stack([x, np.zeros_like(x), x + 2 * pad,
                      np.full_like(x, ph)], -1).astype(np.float32)
    gt = points[..., 2, None, None, None] + rng.uniform(
        -0.8, 0.8, (b, k, ph, pw, 1))
    gt[rng.random(gt.shape) < 0.4] = 0.0
    batch = (rng.integers(0, 256, (b, ph, w + 2 * pad, 3)).astype(
        np.float32), points, boxes, gt.astype(np.float32))
    kw = dict(max_distance_correspondence=0.4, w_positive_class=2.0)
    _jax_gradient_step(jax_radarnet_main._make_train_step, monkeypatch)
    step = jax.jit(jax_radarnet_main._make_train_step(
        JaxRadarNet(**cfg), JaxTransforms(normalized_image_range=[0, 1]),
        patch, set_invalid_to_negative_class=False, w_weight_decay=0.0,
        **kw))
    grads, new_state, _, info = step(params, state, None, tuple(
        jnp.asarray(a) for a in batch), jax.random.PRNGKey(3), 1e-3, 0.0)

    def port_step(dtype=torch.float32):
        model = RadarNetModel(**cfg, device='cpu', trainable=True)
        model.load_state_dict(state_dict_from_jax(params, state))
        model.to(dtype)
        return model, radarnet_main.TrainStep(
            model, Transforms(normalized_image_range=[0, 1]),
            radarnet_main.make_optimizer(model, 1e-3, 0.0), patch,
            set_invalid_to_negative_class=False, **kw)
    return (grads, new_state, info, params), port_step, batch


def _fusionnet_case(rng, monkeypatch):
    """FusionNet at FUSIONNET's widths: 2 frames of 128x128 (its deepest
    batch norm normalizes 2 x 4 x 4 values)."""
    params, state = randomize_batch_norm(*jax.device_get(
        JaxFusionNet(**FUSIONNET).init(jax.random.PRNGKey(0))), rng)
    n, h, w = 2, 128, 128
    image = rng.integers(0, 256, (n, h, w, 3)).astype(np.float32)
    depth = rng.random((n, h, w, 1)) * 60
    depth[depth < 30] = 0.0
    response = rng.random((n, h, w, 1))
    gt = rng.random((n, h, w, 1)) * 70 + 1
    gt[rng.random((n, h, w, 1)) < 0.6] = 0.0
    lidar = rng.random((n, h, w, 1)) * 70 + 1
    lidar[rng.random((n, h, w, 1)) < 0.9] = 0.0
    batch = tuple(a.astype(np.float32) for a in (image, depth, response, gt,
                                                 lidar))
    kw = dict(loss_func='l1', w_smoothness=0.1, w_lidar_loss=2.0,
              loss_smoothness_kernel_size=7, outlier_kernel_size=7,
              outlier_threshold=1.5, dilation_kernel_size=3)
    _jax_gradient_step(jax_fusionnet_main._make_train_step, monkeypatch)
    step = jax.jit(jax_fusionnet_main._make_train_step(
        JaxFusionNet(**FUSIONNET), JaxTransforms(normalized_image_range=[
            0, 1]), w_weight_decay=0.0, **kw))
    grads, new_state, _, info = step(params, state, None, tuple(
        jnp.asarray(a) for a in batch), jax.random.PRNGKey(3), 1e-3, 0.0)

    def port_step(dtype=torch.float32):
        model = FusionNetModel(**FUSIONNET, device='cpu', trainable=True)
        model.load_state_dict(state_dict_from_jax(params, state))
        model.to(dtype)
        return model, fusionnet_main.TrainStep(
            model, Transforms(normalized_image_range=[0, 1]),
            fusionnet_main.make_optimizer(model, 1e-3, 0.0), **kw)
    return (grads, new_state, info, params), port_step, batch


@pytest.mark.parametrize('case', ['radarnet', 'radarnet_wide', 'fusionnet'])
def test_bf16_train_step_matches_jax(rng, monkeypatch, case):
    """One train step under RCFD_TRAIN_DTYPE=bfloat16 in both packages,
    augmentation off: RadarNet at a 64x64 patch and at 64x72 (the 1/16 and
    1/32 pools take the variable-bin branch: the column crop and its
    gradient), FusionNet at 128x128. The loss and the summary scalars
    within LOSS_RTOL of JAX's; the running statistics within STATS_TOL of
    their largest; the gradients by TRUTH_TOL and JAX_TOL (the module's
    docstring says why); the master weights and their gradients float32."""
    monkeypatch.setenv('RCFD_TRAIN_DTYPE', 'bfloat16')
    if case == 'fusionnet':
        (grads, new_state, info, params), port_step, batch = \
            _fusionnet_case(rng, monkeypatch)
    else:
        patch = (64, 72) if case == 'radarnet_wide' else (64, 64)
        (grads, new_state, info, params), port_step, batch = \
            _radarnet_case(rng, patch, monkeypatch)
    grads = {n: np.asarray(g, np.float64) for n, g in
             jax_ckpt.tree_to_torch_state_dict(jax.device_get(grads)).items()}
    ref_state = state_dict_from_jax(params, jax.device_get(new_state))

    model, step = port_step()
    assert step.compute_dtype == torch.bfloat16
    info_port = step.backward(tuple(torch.from_numpy(a) for a in batch), {})
    assert sorted(info_port) == sorted(info)
    for k in info:
        np.testing.assert_allclose(float(info_port[k]), float(info[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert info_port['loss'].dtype == torch.float32
    port = {n: p.grad.double().numpy() for n, p in model.named_parameters()
            if p.grad is not None}
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.grad.dtype == torch.float32 for p in model.parameters()
               if p.grad is not None)
    for name, buf in model.named_buffers():
        if name.endswith('num_batches_tracked'):
            assert int(buf) == 1, name
            continue
        ref = ref_state[name].numpy()
        assert buf.dtype == torch.float32
        assert np.abs(buf.numpy() - ref).max() <= STATS_TOL * max(
            np.abs(ref).max(), 1.0), name

    monkeypatch.setenv('RCFD_TRAIN_DTYPE', 'float32')
    model64, step64 = port_step(torch.float64)
    step64.backward(tuple(torch.from_numpy(a).double() for a in batch), {})
    truth = {n: p.grad.numpy() for n, p in model64.named_parameters()
             if p.grad is not None}
    assert sorted(port) == sorted(truth)
    scale = max(np.abs(g).max() for g in truth.values())

    def distance(a):
        return max((np.abs(a[n] - g).max() / scale, n)
                   for n, g in truth.items())
    port_err, jax_err = distance(port), distance(grads)
    apart = max(np.abs(port[n] - grads[n]).max() for n in truth) / scale
    print('{}: gradients of the largest float64 gradient ({:.3g}) apart: '
          'port from float64 {:.3g} ({}), JAX from float64 {:.3g} ({}), port '
          'from JAX {:.3g}'.format(case, scale, port_err[0], port_err[1],
                                   jax_err[0], jax_err[1], apart))
    assert port_err[0] <= TRUTH_TOL and port_err[0] <= jax_err[0]
    assert apart <= JAX_TOL


# -- bf16 training runs --------------------------------------------------------


@pytest.fixture(scope='module')
def radarnet_data(tmp_path_factory):
    m = make_radarnet_fixture(str(tmp_path_factory.mktemp('rn')),
                              n_samples=4, height=64, width=96, n_points=6)
    return dict(train_image_path=m['image'], train_radar_path=m['radar'],
                train_ground_truth_path=m['ground_truth'],
                val_image_path=m['image'], val_radar_path=m['radar'],
                val_ground_truth_path=m['ground_truth'])


@pytest.fixture(scope='module')
def fusionnet_data(tmp_path_factory):
    m = make_fusionnet_fixture(str(tmp_path_factory.mktemp('fn')),
                               n_samples=4, height=64, width=64)
    return dict(train_image_path=m['image'], train_depth_path=m['depth'],
                train_response_path=m['response'],
                train_ground_truth_path=m['ground_truth'],
                train_lidar_map_path=m['lidar'], val_image_path=m['image'],
                val_depth_path=m['depth'], val_response_path=m['response'],
                val_ground_truth_path=m['ground_truth'])


def _flags(data, **kw):
    out = []
    for k, v in dict(data, **kw).items():
        out.append('--' + k)
        out += [str(x) for x in v] if isinstance(v, (list, tuple)) \
            else [str(v)]
    return out


RN_FLAGS = dict(batch_size=2, patch_size=[64, 72], total_points_sampled=3,
                n_filters_encoder_image=RADARNET_TINY[
                    'n_filters_encoder_image'],
                n_neurons_encoder_depth=RADARNET_TINY[
                    'n_neurons_encoder_depth'],
                n_filters_decoder=RADARNET_TINY['n_filters_decoder'],
                learning_schedule=[1], n_step_per_checkpoint=1,
                start_step_validation=2, n_thread=2, device='cpu')
FN_FLAGS = dict(batch_size=2, n_height=64, n_width=64,
                n_filters_encoder_image=FUSIONNET['n_filters_encoder_image'],
                n_filters_encoder_depth=FUSIONNET['n_filters_encoder_depth'],
                fusion_type='weight_and_project',
                n_filters_decoder=FUSIONNET['n_filters_decoder'],
                min_predict_depth=1.0, w_lidar_loss=2.0,
                learning_schedule=[1], n_step_per_checkpoint=1,
                start_step_validation=2, n_thread=2, device='cpu')


@pytest.mark.parametrize('model', ['radarnet', 'fusionnet'])
def test_bf16_training_writes_float32_checkpoints(
        radarnet_data, fusionnet_data, tmp_path, monkeypatch, capsys, model):
    """train_radarnet / train_fusionnet with RCFD_TRAIN_DTYPE=bfloat16, two
    steps on the CPU: finite losses; model-1.pth and model-2.pth with the
    reference keys, every tensor float32; FusionNet's Adam state in float32
    at step 2, RadarNet's empty, as the JAX package writes them; the JAX
    package restores model-2.pth; the run names its dtype; validation
    (float32, from the masters) logs its rows at step 2 (RadarNet's errors
    are NaN where no output pixel meets the ground truth, as the JAX
    package's, so its pixel counts are checked)."""
    monkeypatch.setenv('RCFD_TRAIN_DTYPE', 'bfloat16')
    out = str(tmp_path / 'ckpt')
    timings = []
    if model == 'radarnet':
        train_radarnet.main(_flags(radarnet_data, checkpoint_dirpath=out,
                                   **RN_FLAGS), timings=timings)
        keys = ['radarnet_decoder_state_dict', 'radarnet_encoder_state_dict',
                'radarnet_optimizer_state_dict', 'train_step']
        jax_model = JaxRadarNet(**dict(RADARNET_TINY,
                                       input_patch_size_image=(64, 72)))
    else:
        train_fusionnet.main(_flags(fusionnet_data, checkpoint_dirpath=out,
                                    **FN_FLAGS), timings=timings)
        keys = ['decoder_state_dict', 'encoder_state_dict',
                'optimizer_state_dict', 'train_step']
        jax_model = JaxFusionNet(**FUSIONNET)
    assert [t['step'] for t in timings] == [1, 2]
    assert all(np.isfinite(t['loss']) for t in timings)
    assert 'Numerics: bf16 network inputs' in capsys.readouterr().out
    assert sorted(f for f in os.listdir(out) if f.endswith('.pth')) == [
        'model-1.pth', 'model-2.pth']
    ckpt = torch.load(os.path.join(out, 'model-2.pth'), weights_only=True)
    assert sorted(ckpt) == keys and ckpt['train_step'] == 2
    for part in keys[:2]:
        assert all(v.dtype in (torch.float32, torch.int64)
                   for v in ckpt[part].values())
    opt = ckpt[keys[2]]
    if model == 'radarnet':
        assert opt == {}
    else:
        states = list(opt['state'].values())
        assert states and all(int(s['step']) == 2 and
                              s['exp_avg'].dtype == torch.float32
                              for s in states)
    params, _, step, _ = jax_model.restore_checkpoint(
        os.path.join(out, 'model-2.pth'))
    assert step == 2
    assert all(np.asarray(a).dtype == np.float32
               for a in jax.tree_util.tree_leaves(params))
    with open(os.path.join(out, 'results.txt')) as f:
        rows = [line for line in f.read().splitlines()
                if line.strip().startswith('2 ')]
    values = [float(v) for v in rows[0].split()]
    assert all(np.isfinite(values[-3:] if model == 'radarnet' else values))


@pytest.mark.parametrize('value', ['float16', 'float64', 'bf16'])
def test_other_train_dtypes_are_refused(radarnet_data, fusionnet_data,
                                        tmp_path, monkeypatch, value):
    """RCFD_TRAIN_DTYPE other than '', float32 and bfloat16 is refused by
    both training CLIs before anything is written."""
    monkeypatch.setenv('RCFD_TRAIN_DTYPE', value)
    with pytest.raises(ValueError, match='RCFD_TRAIN_DTYPE'):
        training.train_dtype()
    with pytest.raises(ValueError, match='RCFD_TRAIN_DTYPE'):
        train_radarnet.main(_flags(radarnet_data, checkpoint_dirpath=str(
            tmp_path / 'rn'), **RN_FLAGS))
    with pytest.raises(ValueError, match='RCFD_TRAIN_DTYPE'):
        train_fusionnet.main(_flags(fusionnet_data, checkpoint_dirpath=str(
            tmp_path / 'fn'), **FN_FLAGS))
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize('value,dtype', [(None, None), ('', None),
                                         ('float32', None),
                                         ('bfloat16', torch.bfloat16)])
def test_train_dtype_reads_the_jax_variable(monkeypatch, value, dtype):
    if value is None:
        monkeypatch.delenv('RCFD_TRAIN_DTYPE', raising=False)
    else:
        monkeypatch.setenv('RCFD_TRAIN_DTYPE', value)
    assert training.train_dtype() == dtype
    assert training.numerics_line(dtype).startswith(
        'Numerics: float32,' if dtype is None else
        'Numerics: bf16 network inputs')
