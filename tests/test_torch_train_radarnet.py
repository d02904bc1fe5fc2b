"""RadarNet training of the port (rcfd_tpu_torch.radarnet_main) against the
JAX package's (rcfd_tpu.radarnet_main) on the CPU: the training dataset,
the augmentation of labels, points and boxes, the train step in float64
(at a patch width that is a multiple of 32 and at one that is not),
validation, the training loop, checkpoints both ways, auto-resume, the CLI,
the gradient of the column crop and the scatter rule of validation. The
tiny configuration is tests/torch_parity.py's RADARNET_TINY. Each test
states its tolerance."""

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

from rcfd_tpu import radarnet_main as jax_main  # noqa: E402
from rcfd_tpu.data import datasets as jax_datasets  # noqa: E402
from rcfd_tpu.data import loader as jax_loader  # noqa: E402
from rcfd_tpu.data.transforms import Transforms as JaxTransforms  # noqa
from rcfd_tpu.models import RadarNetModel as JaxRadarNet  # noqa: E402
from rcfd_tpu.parallel.optim import adam_step, init_adam  # noqa: E402
from rcfd_tpu.utils import checkpoint as jax_ckpt  # noqa: E402

from rcfd_tpu_torch import radarnet_main  # noqa: E402
from rcfd_tpu_torch import train_radarnet  # noqa: E402
from rcfd_tpu_torch.data import datasets, io, transport  # noqa: E402
from rcfd_tpu_torch.data.loader import iter_device_batches  # noqa: E402
from rcfd_tpu_torch.data.transforms import Transforms  # noqa: E402
from rcfd_tpu_torch.models import RadarNetModel  # noqa: E402
from rcfd_tpu_torch.ops import crop_cuda  # noqa: E402
from rcfd_tpu_torch.ops import scatter as exact_scatter  # noqa: E402
from rcfd_tpu_torch.ops import scatter_cuda  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

from fixtures import make_radarnet_fixture  # noqa: E402
from test_torch_train_ops import jax_draws as photometric_jax_draws  # noqa
from torch_parity import RADARNET_TINY, randomize_batch_norm  # noqa: E402

REPO = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))
FRAME = (40, 64)
# 36 / 8, 36 / 16 and 36 / 32 are no integers: the 1/8, 1/16 and 1/32
# pools take the variable-bin branch, as at 900x300
WIDE = (32, 36)
PATCHES = [(32, 32), WIDE]
K = 3
AUGMENT = dict(random_brightness=[0.8, 1.2], random_contrast=[0.8, 1.2],
               random_saturation=[0.8, 1.2],
               random_flip_type=['horizontal'])
# train()'s network and training arguments at RADARNET_TINY and WIDE
NET = dict(
    input_channels_image=3, input_channels_depth=3,
    normalized_image_range=[0, 1], encoder_type='radarnetv1-batch_norm',
    n_filters_encoder_image=RADARNET_TINY['n_filters_encoder_image'],
    n_neurons_encoder_depth=RADARNET_TINY['n_neurons_encoder_depth'],
    decoder_type='multiscale-batch_norm',
    n_filters_decoder=RADARNET_TINY['n_filters_decoder'],
    weight_initializer='kaiming_uniform', activation_func='leaky_relu')
TRAIN = dict(
    batch_size=2, patch_size=list(WIDE), total_points_sampled=K,
    sample_probability_of_lidar=0.5, learning_rates=[1e-3],
    learning_schedule=[1], augmentation_probabilities=[1.0],
    augmentation_schedule=[-1],
    augmentation_random_brightness=AUGMENT['random_brightness'],
    augmentation_random_contrast=AUGMENT['random_contrast'],
    augmentation_random_saturation=AUGMENT['random_saturation'],
    augmentation_random_noise_type='gaussian',
    augmentation_random_noise_spread=2.0,
    augmentation_random_flip_type=AUGMENT['random_flip_type'],
    w_weight_decay=0.0, w_positive_class=2.0,
    max_distance_correspondence=0.4, set_invalid_to_negative_class=True,
    n_step_per_checkpoint=1, n_step_per_summary=100, start_step_validation=2,
    min_evaluate_depth=0.0, max_evaluate_depth=100.0, n_thread=2, seed=0)


def config(patch):
    return dict(RADARNET_TINY, input_patch_size_image=tuple(patch))


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The port's tiny steps on one thread (tests/test_torch_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    m = make_radarnet_fixture(str(tmp_path_factory.mktemp('rn')),
                              n_samples=4, height=FRAME[0], width=FRAME[1],
                              n_points=6)
    return dict(train_image_path=m['image'], train_radar_path=m['radar'],
                train_ground_truth_path=m['ground_truth'],
                val_image_path=m['image'], val_radar_path=m['radar'],
                val_ground_truth_path=m['ground_truth'])


def _paths(data, split='train'):
    return [io.read_paths(data['{}_{}_path'.format(split, k)])
            for k in ('image', 'radar', 'ground_truth')]


@functools.lru_cache(maxsize=None)
def _jax_init(patch, seed):
    """JAX's init at PRNGKey(seed) (jitted once a configuration); callers
    copy before they change it."""
    return jax.device_get(jax.jit(JaxRadarNet(**config(patch)).init)(
        jax.random.PRNGKey(seed)))


def _jax_variables(patch, seed, rng, dtype=np.float32):
    params, state = randomize_batch_norm(*_jax_init(patch, seed), rng)
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: np.asarray(x, dtype)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
        else np.asarray(x), t)
    return cast(params), cast(state)


def _port_model(patch, params, state, dtype=torch.float32):
    model = RadarNetModel(**config(patch), device='cpu', trainable=True)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return model.to(dtype)


def jax_draws(key, transforms, n_batch, p, points_shape):
    """The draws the JAX transform takes from ``key`` for one image, its
    point noise included (the noise key split into a gate key and one
    value key for the one points array), in the port's ``draws``
    layout."""
    out = photometric_jax_draws(key, transforms, n_batch, p)
    if transforms.do_random_noise:
        k_gate, _, k_noise, _, _ = jax.random.split(key, 5)
        do = jax.random.uniform(k_gate, (n_batch,)) <= p
        k_gate2, k_value = jax.random.split(k_noise, 2)
        gate = do & (jax.random.uniform(k_gate2, (n_batch,)) <= 0.5)
        if transforms.random_noise_type == 'gaussian':
            noise = jax.random.normal(k_value, points_shape)
        else:
            noise = jax.random.uniform(k_value, points_shape) - 0.5
        out['noise_gate'] = torch.from_numpy(np.array(gate))
        out['points_noise'] = torch.from_numpy(np.array(
            transforms.random_noise_spread * noise))
    return out


# -- dataset, augmentation, transport, feeder --------------------------------


@pytest.mark.parametrize('k', [K, 8])
@pytest.mark.parametrize('lidar', [0.0, 1.0])
@pytest.mark.parametrize('transport_on', [True, False])
def test_training_dataset_matches_jax(data, k, lidar, transport_on):
    """RadarNetTrainingDataset against the JAX package's from the same
    Generators: bit for bit, dtypes too (uint8 / uint16 under integer
    transport, float32 without), with K below and above the frames' 6
    points (the repeat) and lidar sampling never and always."""
    paths = _paths(data)
    kw = dict(patch_size=WIDE, total_points_sampled=k,
              sample_probability_of_lidar=lidar, transport=transport_on)
    port = datasets.RadarNetTrainingDataset(*paths, device='cpu', **kw)
    ref = jax_datasets.RadarNetTrainingDataset(*paths, **kw)
    for i in range(len(port)):
        a = port.get(i, np.random.default_rng((5, i)))
        b = ref.get(i, np.random.default_rng((5, i)))
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    assert a[0].dtype == (np.uint8 if transport_on else np.float32)
    assert a[3].dtype == (np.uint16 if transport_on else np.float32)
    assert a[0].shape == (WIDE[0], FRAME[1] + 2 * (WIDE[1] // 2), 3)
    assert a[3].shape == (k, WIDE[0], WIDE[1], 1)


@pytest.mark.parametrize('noise', ['gaussian', 'uniform', 'none'])
def test_transforms_on_labels_points_and_boxes_match_jax(rng, noise):
    """Transforms.apply and noise_points fed the draws of JAX's key
    sequence against rcfd_tpu's Transforms.transform with labels, points
    and boxes: images exact ([0, 255] images), label maps (B, K, h, w, 1)
    flipped with them exact, boxes exact, points exact (noise added in
    float32 on both sides; never flipped)."""
    n, k = 6, 3
    image = rng.integers(0, 256, (n, 12, 20, 3)).astype(np.float32)
    labels = (rng.random((n, k, 12, 8, 1)) * 70).astype(np.float32)
    points = (rng.random((n, k, 3)) * 20).astype(np.float32)
    boxes = rng.integers(0, 12, (n, k, 4)).astype(np.float32)
    kw = dict(normalized_image_range=[0, 1], random_noise_type=noise,
              random_noise_spread=2.0 if noise != 'none' else -1, **AUGMENT)
    key = jax.random.PRNGKey(7)
    ref = JaxTransforms(**kw).transform(
        key, [jnp.asarray(image)], labels_arr=[jnp.asarray(labels)],
        points_arr=[jnp.asarray(points)],
        bounding_boxes_arr=[jnp.asarray(boxes)],
        random_transform_probability=0.8)
    (im_ref,), (labels_ref,), (points_ref,), (boxes_ref,) = ref
    port = Transforms(**kw)
    draws = jax_draws(key, port, n, 0.8, points.shape)
    assert bool(draws['horizontal_flip'].any())
    assert ('noise_gate' in draws) == (noise != 'none')
    im, (labels_out,), (boxes_out,) = port.apply(
        draws, torch.from_numpy(image), [torch.from_numpy(labels)],
        [torch.from_numpy(boxes)])
    points_out = port.noise_points(draws, torch.from_numpy(points))
    np.testing.assert_array_equal(im.numpy(), np.asarray(im_ref))
    for a, b in ((labels_out, labels_ref), (boxes_out, boxes_ref),
                 (points_out, points_ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if noise != 'none':
        assert not np.array_equal(points_out.numpy(), points)


@pytest.mark.parametrize('noise', ['gaussian', 'uniform'])
def test_point_noise_draws(noise):
    """The noise is drawn per coordinate, spread x N(0, 1) or spread x
    (U(0, 1) - 0.5), behind a gate that p = 0 keeps shut."""
    port = Transforms(random_noise_type=noise, random_noise_spread=3.0)
    d = port.draws(torch.Generator().manual_seed(1), 64, 1.0, (64, 4, 3))
    assert d['points_noise'].shape == (64, 4, 3)
    assert 0 < int(d['noise_gate'].sum()) < 64
    if noise == 'uniform':
        assert float(d['points_noise'].abs().max()) <= 1.5
    off = port.draws(torch.Generator().manual_seed(1), 64, 0.0, (64, 4, 3))
    points = torch.rand(64, 4, 3)
    assert torch.equal(port.noise_points(off, points), points)
    with pytest.raises(ValueError, match='noise type'):
        Transforms(random_noise_type='laplace', random_noise_spread=1.0)


def test_transport_decode_of_a_training_batch(data):
    """The four-field batch (uint8 image, float32 points and boxes, uint16
    crops) decodes to the JAX package's host decode, exactly."""
    from rcfd_tpu.data import transport as jax_transport
    ds = datasets.RadarNetTrainingDataset(
        *_paths(data), patch_size=WIDE, total_points_sampled=K,
        sample_probability_of_lidar=0.0, device='cpu')
    batch = tuple(np.stack(f) for f in zip(*[
        ds.get(i, np.random.default_rng(i)) for i in range(2)]))
    out = transport.decode(tuple(torch.from_numpy(a) for a in batch))
    assert isinstance(out, tuple) and len(out) == 4
    for a, b in zip(out, jax_transport.decode_np(batch)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)


def test_iter_device_batches_pads_the_tail(data):
    """Batches of 3 over 4 frames: the indices in order, the tail padded by
    repeating its last sample, only the picked fields sent, the host
    samples as the dataset made them."""
    ds = datasets.RadarNetInferenceDataset(*_paths(data, 'val'),
                                           max_points=8, device='cpu')
    out = list(iter_device_batches(ds, 3, 'cpu', fields=(0, 1, 2)))
    assert [idxs for idxs, _, _ in out] == [[0, 1, 2], [3]]
    idxs, samples, tensors = out[1]
    assert len(samples) == 1 and len(samples[0]) == 4 and len(tensors) == 3
    for j, t in enumerate(tensors):
        assert t.shape[0] == 3
        for row in t:
            np.testing.assert_array_equal(row.numpy(), ds.get(3)[j])


def test_background_surfaces_errors_and_stops_early():
    """The loader's thread helper: items in order, the producer's exception
    raised in the consumer, and a consumer that leaves early ends the
    producer (which then closes its generator)."""
    from rcfd_tpu_torch.data.loader import background

    assert list(background(lambda: iter(range(5)), 2)) == [0, 1, 2, 3, 4]

    def failing():
        yield 1
        raise OSError('corrupt frame')

    with pytest.raises(OSError, match='corrupt frame'):
        list(background(failing, 2))
    closed = []

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.append(True)

    items = background(endless, 2)
    assert [next(items) for _ in range(3)] == [0, 1, 2]
    items.close()
    assert closed == [True]


# -- the train step ------------------------------------------------------------


def _batch(rng, patch, b=2, k=K, w=48, dtype=np.float64):
    """A training batch as the dataset builds it: the padded image's
    bottom rows, points with x shifted by the pad, full-height boxes, and
    ground-truth crops near the points' depths where they have depth."""
    ph, pw = patch
    pad = pw // 2
    image = rng.integers(0, 256, (b, ph, w + 2 * pad, 3)).astype(dtype)
    x = rng.integers(0, w, (b, k)).astype(dtype) + 0.25
    points = np.stack([x + pad, rng.random((b, k)) * ph,
                       rng.random((b, k)) * 60 + 5], -1).astype(dtype)
    boxes = np.stack([x, np.zeros_like(x), x + 2 * pad,
                      np.full_like(x, ph)], -1).astype(dtype)
    gt = points[..., 2, None, None, None] + rng.uniform(
        -0.8, 0.8, (b, k, ph, pw, 1))
    gt[rng.random(gt.shape) < 0.4] = 0.0
    return image, points, boxes, gt.astype(dtype)


STEP_KW = dict(max_distance_correspondence=0.4, w_positive_class=2.0)


@pytest.mark.parametrize('patch', PATCHES, ids=['288like', 'wide'])
def test_train_step_matches_jax_float64(rng, patch, monkeypatch):
    """One train step in float64 on both sides (JAX's own
    _make_train_step, its Adam swapped for a function that hands back the
    gradients) with augmentation on (JAX's draws fed to the port: the
    photometric ops, gaussian point noise and horizontal flips at p 0.8)
    and validity from the ground truth: loss and the two summary scalars
    rtol 1e-10, every gradient within 1e-8 of its max-abs, the running
    statistics rtol 1e-10, the batch counts equal; then the port's Adam
    update against JAX's adam_step on the JAX gradients (weight decay
    1e-4), within 2e-5 of each update's max-abs: JAX takes the bias
    correction in float32, where 0.999 is 0.99900001287, so that its
    1 - b2 is 1.3e-5 low and the update 6.4e-6 high."""
    params, state = _jax_variables(patch, 0, rng, np.float64)
    # the JAX package's variable-bin window (rcfd_tpu/ops/roi_pool.py:247)
    # mixes int64 literals and int32 starts in dynamic_slice, which x64
    # refuses; the same slices with the indices as int32
    dynamic_slice = jax.lax.dynamic_slice
    monkeypatch.setattr(jax.lax, 'dynamic_slice', lambda x, idx, size: (
        dynamic_slice(x, [jnp.asarray(i, jnp.int32) for i in idx], size)))
    kw = dict(normalized_image_range=[0, 1], random_noise_type='gaussian',
              random_noise_spread=1.0, **AUGMENT)
    key = jax.random.PRNGKey(3)
    jax.config.update('jax_enable_x64', True)
    try:
        batch = _batch(rng, patch)
        monkeypatch.setattr(jax_main, 'adam_step',
                            lambda p, grads, opt, lr, weight_decay: (grads,
                                                                     opt))
        step = jax.jit(jax_main._make_train_step(
            JaxRadarNet(**config(patch)), JaxTransforms(**kw), patch,
            set_invalid_to_negative_class=False, w_weight_decay=0.0,
            **STEP_KW))
        jp, js = (jax.tree_util.tree_map(jnp.asarray, t)
                  for t in (params, state))
        grads, new_state, _, info = step(
            jp, js, None, tuple(jnp.asarray(a) for a in batch), key, 1e-3,
            0.8)
        port_transforms = Transforms(**kw)
        draws = jax_draws(key, port_transforms, 2, 0.8, (2, K, 3))
        adam_ref, _ = adam_step(jp, grads, init_adam(jp), 1e-3,
                                weight_decay=1e-4)
        adam_ref = state_dict_from_jax(jax.device_get(adam_ref))
        grads = jax_ckpt.tree_to_torch_state_dict(jax.device_get(grads))
        ref_state = state_dict_from_jax(params, jax.device_get(new_state))
    finally:
        jax.config.update('jax_enable_x64', False)
    assert bool(draws['horizontal_flip'].any())

    model = _port_model(patch, params, state, torch.float64)
    port = radarnet_main.TrainStep(
        model, port_transforms, radarnet_main.make_optimizer(model, 1e-3,
                                                             1e-4),
        patch, set_invalid_to_negative_class=False, **STEP_KW)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    info_port = port.backward(tuple(torch.from_numpy(a) for a in batch),
                              draws)
    assert sorted(info_port) == sorted(info)
    for k in info:
        np.testing.assert_allclose(float(info_port[k]), float(info[k]),
                                   rtol=1e-10, err_msg=k)
    checked = 0
    for name, p in model.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        ref = grads[name]
        scale = max(np.abs(ref).max(), 1e-300)
        assert np.abs(g - ref).max() <= 1e-8 * scale, name
        checked += int(np.abs(ref).max() > 0)
    assert checked > 60
    for name, buf in model.named_buffers():
        if name.endswith('num_batches_tracked'):
            assert int(buf) == int(ref_state[name]) == 1, name
        else:
            np.testing.assert_allclose(buf.numpy(), ref_state[name].numpy(),
                                       rtol=1e-10, err_msg=name)
    # the Adam update of the same gradients
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(np.asarray(grads[name], np.float64))
    port.optimizer.step()
    for name, p in model.named_parameters():
        update = (p.detach() - before[name]).numpy()
        ref = (adam_ref[name] - before[name]).numpy()
        assert np.abs(update - ref).max() <= 2e-5 * max(
            np.abs(ref).max(), 1e-300), name


def test_the_wide_step_runs_the_column_crop(rng, monkeypatch):
    """At a patch width that is not a multiple of 32 the step's forward
    crops windows for the 1/8, 1/16 and 1/32 pools (the plain version on
    the CPU), and their gradients reach the image encoder: every parameter
    of it that the forward uses has a nonzero gradient (the projections of
    blocks that keep their input's shape are unused: none)."""
    calls = []
    plain = crop_cuda.batch_column_crop_plain
    monkeypatch.setattr(crop_cuda, 'batch_column_crop_plain',
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    params, state = _jax_variables(WIDE, 0, rng)
    model = _port_model(WIDE, params, state)
    step = radarnet_main.TrainStep(
        model, Transforms(normalized_image_range=[0, 1]),
        radarnet_main.make_optimizer(model, 1e-3, 0.0), WIDE,
        set_invalid_to_negative_class=True, **STEP_KW)
    batch = tuple(torch.from_numpy(a) for a in _batch(rng, WIDE,
                                                      dtype=np.float32))
    step.backward(batch, {})
    assert len(calls) == 3
    unused = {name + '.projection.' + n for name, block in
              model.encoder.encoder_image.named_modules()
              if getattr(block, 'use_projection', True) is False
              for n, _ in block.projection.named_parameters()}
    assert unused  # the projections of blocks that keep their shape
    for name, p in model.encoder.encoder_image.named_parameters():
        if name in unused:
            assert p.grad is None, name
        else:
            assert p.grad is not None and bool(p.grad.abs().max() > 0), name


# -- validation ----------------------------------------------------------------


def test_validate_matches_jax(data, rng):
    """The port's validate against rcfd_tpu.radarnet_main.validate on the
    fixture's frames at the same weights, both on the exact scatter (JAX's
    off the TPU, the port's on the CPU): the intersection metrics rtol
    1e-5, the pixel counts equal, the same step; and the 4-of-5 vote from
    a best that is better in two errors (no update: 3 of 5) and in one
    (an update: 4 of 5)."""
    params, state = _jax_variables(WIDE, 2, rng)
    jax_model = JaxRadarNet(**config(WIDE))
    paths = _paths(data, 'val')
    jax_fn = jax_main.make_forward_fn_batched(
        jax_model, JaxTransforms(normalized_image_range=[0, 1]), *FRAME)
    model = _port_model(WIDE, params, state)
    port_fn = radarnet_main.make_forward_fn_batched(
        model, Transforms(normalized_image_range=[0, 1]), *FRAME)
    inf = dict({k: np.inf for k in radarnet_main.METRICS}, step=-1,
               n_valid_points_output=0, n_valid_points_ground_truth=0,
               n_valid_points_intersection=0)

    def run(best, step, eval_batch_size=1):
        ref = jax_main.validate(
            jax_model, params, state, jax_fn,
            jax_datasets.RadarNetInferenceDataset(*paths, max_points=8,
                                                  transport=True),
            step, dict(best), 0.0, 100.0, None)
        got = radarnet_main.validate(
            port_fn, datasets.RadarNetInferenceDataset(
                *paths, max_points=8, device='cpu'), step, dict(best), 0.0,
            100.0, eval_batch_size=eval_batch_size, device='cpu')
        return ref, got

    ref, got = run(inf, 5, eval_batch_size=3)
    assert got['step'] == ref['step'] == 5
    assert sorted(got) == sorted(ref)
    for k in radarnet_main.METRICS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    for k in ('n_valid_points_output', 'n_valid_points_ground_truth',
              'n_valid_points_intersection'):
        assert got[k] == ref[k] > 0, k
    assert model.training  # validate leaves the model's mode as it was
    for better in (('mae_intersection', 'rmse_intersection'),
                   ('mae_intersection',)):
        best = dict(ref, step=1, **{k: ref[k] - 1.0 for k in better})
        ref2, got2 = run(best, 6)
        assert got2['step'] == ref2['step'] == (1 if len(better) == 2 else 6)


@pytest.mark.parametrize('pallas_scatter,device,k,route', [
    (None, 'cpu', 64, exact_scatter), (None, 'cuda', 64, scatter_cuda),
    (None, 'cuda:0', scatter_cuda.MAX_POINTS + 1, exact_scatter),
    (True, 'cpu', 64, scatter_cuda), (False, 'cuda', 64, exact_scatter)])
def test_scatter_route_is_k1_on_the_card_by_default(pallas_scatter, device,
                                                    k, route):
    """JAX's rule of RadarNet's scatter inference with the card in the
    TPU's place: the perf gate when set, else K1 on a CUDA device and the
    exact max on the CPU; the exact max above K1's point limit."""
    assert radarnet_main.scatter_route(pallas_scatter, device, k) is route


def test_forward_on_the_cpu_takes_the_exact_scatter(rng):
    """make_forward_fn at pallas_scatter=None on the CPU gives the exact
    scatter's maps of its own crops, bit for bit, and the batched forward
    the same frame's."""
    params, state = _jax_variables(WIDE, 1, rng)
    model = _port_model(WIDE, params, state)
    image = torch.from_numpy(rng.integers(0, 256, (1, *FRAME, 3),
                                          dtype=np.uint8))
    points = torch.from_numpy(np.stack([
        rng.integers(0, FRAME[1], 5), rng.integers(0, FRAME[0], 5),
        rng.random(5) * 50 + 1], -1).astype(np.float32))
    valid = torch.tensor([True, True, True, True, False])
    transforms = Transforms(normalized_image_range=[0, 1])
    depth, response = radarnet_main.make_forward_fn(
        model, transforms, *FRAME)(image, points, valid)
    from rcfd_tpu_torch.pipeline import radarnet_crops
    with torch.no_grad(), radarnet_main.eval_mode(model):
        _, crops, xs, zs = radarnet_crops(model, transforms, image,
                                          points[None], FRAME[0])
    ref = exact_scatter.scatter_quasi_dense(
        crops[0], xs[0], zs[0], valid, *FRAME, patch_size=WIDE)
    assert torch.equal(depth, ref[0]) and torch.equal(response, ref[1])
    assert float(response.max()) > 0.5


# -- checkpoints ---------------------------------------------------------------


def _trained_port_model(rng, steps=1):
    params, state = _jax_variables(WIDE, 0, rng)
    model = _port_model(WIDE, params, state)
    transforms = Transforms(normalized_image_range=[0, 1])
    step = radarnet_main.TrainStep(
        model, transforms, radarnet_main.make_optimizer(model, 1e-3, 0.0),
        WIDE, set_invalid_to_negative_class=True, **STEP_KW)
    for _ in range(steps):
        step(tuple(torch.from_numpy(a) for a in _batch(
            rng, WIDE, dtype=np.float32)), {}, 1e-3)
    return model


def test_port_checkpoints_restore_in_jax(rng, tmp_path):
    """A port .pth (the reference keys, an empty optimizer state as the
    JAX package's training writes) and a port .npz restore in rcfd_tpu's
    RadarNetModel.restore_checkpoint with params, state and step exact."""
    model = _trained_port_model(rng)
    jax_model = JaxRadarNet(**config(WIDE))
    want = model.state_dict()
    for ext in ('npz', 'pth'):
        path = str(tmp_path / 'model-7.{}'.format(ext))
        model.save_checkpoint(path, 7)
        params, state, step, opt_sd = jax_model.restore_checkpoint(path)
        assert step == 7
        got = state_dict_from_jax(params, state)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k].cpu()), (ext, k)
    assert opt_sd == {}
    assert sorted(torch.load(path, weights_only=True)) == [
        'radarnet_decoder_state_dict', 'radarnet_encoder_state_dict',
        'radarnet_optimizer_state_dict', 'train_step']


def test_jax_checkpoints_restore_in_port(rng, tmp_path):
    """A .pth of the JAX package's save_checkpoint restores in the port:
    weights and step exact, and its empty optimizer state reads as none
    (a restored run starts Adam afresh, as JAX's does)."""
    params, state = _jax_variables(WIDE, 1, rng)
    path = str(tmp_path / 'model-3.pth')
    JaxRadarNet(**config(WIDE)).save_checkpoint(path, params, state, step=3)
    model = RadarNetModel(**config(WIDE), device='cpu', trainable=True)
    assert model.restore_checkpoint(path, device='cpu',
                                    return_optimizer_state=True) == (3, None)
    want = state_dict_from_jax(params, state)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


# -- the training loop ---------------------------------------------------------


def _record(store, prefetch):
    def wrapped(iterator, *args, **kwargs):
        for batch in prefetch(iterator, *args, **kwargs):
            store.append([np.asarray(t).copy() for t in batch])
            yield batch
    return wrapped


def _recording_optimizer(store, make_optimizer):
    """make_optimizer whose optimizer records, at each step, the
    parameters' gradients by name and its learning rate."""
    def make(model, *args, **kwargs):
        optimizer = make_optimizer(model, *args, **kwargs)
        step = optimizer.step

        def recorded(*a, **kw):
            store.append(({n: p.grad.detach().clone()
                           for n, p in model.named_parameters()
                           if p.grad is not None},
                          optimizer.param_groups[0]['lr']))
            return step(*a, **kw)
        optimizer.step = recorded
        return optimizer
    return make


def _structure(path):
    """results.txt with every number and path replaced by #."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r'/\S+', '#', text)
    return re.sub(r'[-+]?(\d+\.?\d*(e[-+]?\d+)?|inf|nan)', '#', text
                  ).splitlines()


def _validation_rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return [[float(v) for v in lines[i + 2].split()]
            for i, line in enumerate(lines) if line == 'Validation results:']


@pytest.fixture(scope='module')
def trained(data, tmp_path_factory):
    """radarnet_main.train of both packages in process from one JAX-saved
    step-0 .pth, with augmentation (the photometric ops, gaussian point
    noise, horizontal flips) and lidar sampling on, JAX's draws fed to the
    port; 2 steps, a checkpoint at each, validation at step 2 and at the
    end: the batches fed, the checkpoint directories, the timings."""
    tmp = tmp_path_factory.mktemp('train')
    params, state = _jax_variables(WIDE, 3, np.random.default_rng(3))
    start = str(tmp / 'model-0.pth')
    JaxRadarNet(**config(WIDE)).save_checkpoint(start, params, state,
                                                step=0)
    fed = {'jax': [], 'port': []}
    dirs = {k: str(tmp / k) for k in fed}
    steps = []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(radarnet_main, 'make_optimizer', _recording_optimizer(
            steps, radarnet_main.make_optimizer))
        mp.setattr(jax_loader, 'device_prefetch',
                   _record(fed['jax'], jax_loader.device_prefetch))
        mp.setattr(radarnet_main, 'device_prefetch',
                   _record(fed['port'], radarnet_main.device_prefetch))
        jax_main.train(checkpoint_dirpath=dirs['jax'], restore_path=start,
                       n_data_parallel=1, **data, **NET, **TRAIN)
        # JAX's step keys (rng = PRNGKey(seed + 1), split every step) and
        # their draws, handed to the port's steps in turn
        transforms = Transforms(
            normalized_image_range=[0, 1], random_noise_type='gaussian',
            random_noise_spread=2.0, **AUGMENT)
        rng, draws = jax.random.PRNGKey(TRAIN['seed'] + 1), []
        for _ in range(2):
            rng, key = jax.random.split(rng)
            draws.append(jax_draws(key, transforms, 2, 1.0, (2, K, 3)))
        handed = iter(draws)
        mp.setattr(Transforms, 'draws', lambda self, *a: next(handed))
        timings = []
        radarnet_main.train(checkpoint_dirpath=dirs['port'],
                            restore_path=start, device='cpu',
                            timings=timings, **data, **NET, **TRAIN)
    finally:
        mp.undo()
    return dict(fed=fed, dirs=dirs, timings=timings, draws=draws,
                start=start, steps=steps)


def test_train_feeds_jax_train_batches(trained):
    """The two loops are fed the same batches, bit for bit and dtype for
    dtype, lidar-sampled points included."""
    fed = trained['fed']
    assert len(fed['port']) == len(fed['jax']) == 2
    for a, b in zip(fed['port'], fed['jax']):
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert [t['step'] for t in trained['timings']] == [1, 2]
    assert any(bool(d['horizontal_flip'].any()) for d in trained['draws'])


def test_train_checkpoints_match_jax_train(trained):
    """The same checkpoints model-1.pth and model-2.pth with the same keys,
    steps and an empty optimizer state as JAX's train; and the port's two
    optimizer steps equal to JAX's adam_step over the port's gradients.
    Against JAX's checkpoints: Adam's first steps move a weight
    by about lr = 1e-3 whatever its gradient's size, so a gradient near 0
    that float32 sums in another order give the other sign moves it 2e-3
    the other way (3 of the 19,188 weights at step 1): at step 1 all but
    0.1% of the weights within 1e-4; at both steps every weight within
    2e-3 a step (step 2's gradients are taken at those weights, and Adam's
    normalized update spreads the differences: 7% of the weights are 1e-4
    apart at step 2, and so are weights whose gradients at both steps
    exceed 1% of their tensor's max-abs, by up to 1.3e-3, so no sharper
    bound holds step 2 to JAX's checkpoint); the running statistics, which
    step 2 takes through
    those weights, within 1e-3 (atol and rtol); the batch counts
    equal."""
    dirs = trained['dirs']
    names = sorted(f for f in os.listdir(dirs['jax']) if f.endswith('.pth'))
    assert names == ['model-1.pth', 'model-2.pth']
    assert sorted(f for f in os.listdir(dirs['port'])
                  if f.endswith('.pth')) == names
    for name in names:
        a, b = (torch.load(os.path.join(dirs[k], name), weights_only=True)
                for k in ('port', 'jax'))
        assert sorted(a) == sorted(b)
        step = int(name[6])
        assert a['train_step'] == b['train_step'] == step
        assert a['radarnet_optimizer_state_dict'] == \
            b['radarnet_optimizer_state_dict'] == {}
        n_weights = n_apart = 0
        for key in ('radarnet_encoder_state_dict',
                    'radarnet_decoder_state_dict'):
            assert sorted(a[key]) == sorted(b[key])
            for k in a[key]:
                x, y = a[key][k], b[key][k]
                if k.endswith('num_batches_tracked'):
                    assert int(x) == int(y.reshape(())) == step, k
                elif 'running' in k:
                    np.testing.assert_allclose(x.numpy(), y.numpy(),
                                               rtol=1e-3, atol=1e-3,
                                               err_msg=k)
                else:
                    diff = (x - y).abs()
                    assert float(diff.max()) <= 2e-3 * step + 1e-6, k
                    n_weights += diff.numel()
                    n_apart += int((diff > 1e-4).sum())
        assert n_weights == 19188
        assert step == 2 or n_apart <= 1e-3 * n_weights, n_apart
    # the loop's optimizer over both steps, its Adam state carried from
    # step 1 to step 2 and the learning rate of each step, against the JAX
    # package's adam_step on the same gradients: JAX's Adam from model-0
    # through the port's two recorded steps lands on the port's model-1 and
    # model-2 within 1e-6 (a fresh Adam at step 2 lands up to 1.7e-3 away)
    steps = trained['steps']
    assert [lr for _, lr in steps] == TRAIN['learning_rates'] * 2
    model = RadarNetModel(**config(WIDE), device='cpu', trainable=True)
    model.restore_checkpoint(trained['start'], device='cpu')
    params = {n: jnp.asarray(p.detach().numpy())
              for n, p in model.named_parameters()}
    opt = init_adam(params)
    for step, (grads, lr) in enumerate(steps, 1):
        # the projections the forward never uses have no gradient in the
        # port (Adam leaves them) and a zero one in JAX (Adam moves them 0)
        assert len(grads) == len(params) - 4 and set(grads) < set(params)
        params, opt = adam_step(
            params, {n: jnp.asarray(grads[n].numpy()) if n in grads else
                     jnp.zeros_like(p) for n, p in params.items()},
            opt, lr, weight_decay=TRAIN['w_weight_decay'])
        model.restore_checkpoint(os.path.join(
            dirs['port'], 'model-{}.pth'.format(step)), device='cpu')
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[n]), rtol=0,
                                       atol=1e-6, err_msg=(step, n))


def test_train_logs_as_jax_train(trained):
    """results.txt has JAX's lines (numbers and paths aside), the losses
    of step 1 and 2 rtol 1e-4 and the validation rows (step, 4 errors, 3
    counts) within rtol 1e-3."""
    paths = {k: os.path.join(d, 'results.txt')
             for k, d in trained['dirs'].items()}
    assert _structure(paths['port']) == _structure(paths['jax'])
    losses = {}
    for k, p in paths.items():
        with open(p) as f:
            losses[k] = [float(v) for v in re.findall(r'Loss=(\S+)',
                                                      f.read())]
    assert len(losses['port']) == len(losses['jax']) == 2
    np.testing.assert_allclose(losses['port'], losses['jax'], rtol=1e-4)
    rows = {k: _validation_rows(p) for k, p in paths.items()}
    assert len(rows['port']) == len(rows['jax']) == 2
    np.testing.assert_allclose(rows['port'], rows['jax'], rtol=1e-3)


def test_restore_latest_resumes_at_the_newest_step(data, tmp_path):
    """--restore_path latest restores the newest checkpoint and runs the
    schedule's remaining steps: 2 steps, then resumed at schedule 2 the
    steps 3 and 4, with Adam started afresh (the checkpoints hold no
    optimizer state, as the JAX package's)."""
    ckpt = str(tmp_path / 'ckpt')
    kw = dict(data, **NET, **dict(TRAIN, start_step_validation=10 ** 9))
    radarnet_main.train(checkpoint_dirpath=ckpt, restore_path=None,
                        device='cpu', **kw)
    timings = []
    radarnet_main.train(checkpoint_dirpath=ckpt, restore_path='latest',
                        device='cpu', timings=timings,
                        **dict(kw, learning_schedule=[2]))
    assert [t['step'] for t in timings] == [3, 4]
    assert sorted(f for f in os.listdir(ckpt) if f.endswith('.pth')) == [
        'model-{}.pth'.format(i) for i in range(1, 5)]
    last = torch.load(os.path.join(ckpt, 'model-4.pth'), weights_only=True)
    assert last['train_step'] == 4
    assert last['radarnet_optimizer_state_dict'] == {}
    with open(os.path.join(ckpt, 'results.txt')) as f:
        assert 'Auto-resume from: {}'.format(
            os.path.join(ckpt, 'model-2.pth')) in f.read()


def _cli_flags(data):
    flags = []
    for k, v in dict(data, **NET, **TRAIN).items():
        if k == 'sample_probability_of_lidar':
            k = 'sample_probability_lidar'
        if k in ('encoder_type', 'decoder_type'):
            v = v.split('-', 1)
        if k == 'set_invalid_to_negative_class':
            flags += ['--' + k] if v else []
            continue
        flags.append('--' + k)
        flags += [str(x) for x in v] if isinstance(v, (list, tuple)) \
            else [str(v)]
    return flags


def test_cli_trains_on_the_cpu(data, tmp_path):
    """python -m rcfd_tpu_torch.train_radarnet --device cpu, 2 steps."""
    out = str(tmp_path / 'out')
    proc = subprocess.run(
        [sys.executable, '-m', 'rcfd_tpu_torch.train_radarnet',
         *_cli_flags(data), '--checkpoint_dirpath', out, '--device', 'cpu'],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS='1'),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'TF32 off' in proc.stdout
    assert sorted(f for f in os.listdir(out) if f.endswith('.pth')) == [
        'model-1.pth', 'model-2.pth']


@pytest.mark.parametrize('device', [None, 'cuda'])
def test_cli_needs_a_card_unless_asked_for_cpu(data, tmp_path, monkeypatch,
                                               device):
    """Without a card the CLI's default device and an explicit cuda raise
    before anything is written; there is no CPU fallback."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    argv = _cli_flags(data) + ['--checkpoint_dirpath', str(tmp_path / 'o')]
    if device:
        argv += ['--device', device]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_radarnet.main(argv)
    assert not os.path.exists(str(tmp_path / 'o'))


@pytest.mark.parametrize('flags,env,match', [
    (['--device', 'tpu'], None, 'tpu'),
    # a global batch (2) that the ranks (3) do not divide, as JAX asserts
    (['--device', 'cpu', '--n_data_parallel', '3'], None, 'n_data_parallel'),
    (['--device', 'cpu'], 'float16', 'RCFD_TRAIN_DTYPE'),
])
def test_cli_refuses_what_is_not_ported(data, tmp_path, monkeypatch, flags,
                                        env, match):
    if env:
        monkeypatch.setenv('RCFD_TRAIN_DTYPE', env)
    with pytest.raises(ValueError, match=match):
        train_radarnet.main(_cli_flags(data) + flags + [
            '--checkpoint_dirpath', str(tmp_path / 'o')])
    assert not os.path.exists(str(tmp_path / 'o'))


def test_cli_reads_the_perf_gates(data, tmp_path, monkeypatch):
    """RCFD_PALLAS_SCATTER, RCFD_FUSED_POOL2/4 and RCFD_DECODE_CHUNKS reach
    train() as RadarNet's PerfConfig."""
    got = {}
    monkeypatch.setattr(radarnet_main, 'train',
                        lambda **kw: got.update(kw))
    for name, value in (('RCFD_PALLAS_SCATTER', '0'),
                        ('RCFD_FUSED_POOL2', '1'), ('RCFD_FUSED_POOL4', '1'),
                        ('RCFD_DECODE_CHUNKS', '2')):
        monkeypatch.setenv(name, value)
    train_radarnet.main(_cli_flags(data) + ['--checkpoint_dirpath', 'o'])
    perf = got['perf']
    assert (perf.pallas_scatter, perf.fused_pool2, perf.fused_pool4,
            perf.decode_chunks) == (False, True, True, 2)
    assert got['sample_probability_of_lidar'] == 0.5
    assert got['encoder_type'] == 'radarnetv1-batch_norm'


# -- summaries -----------------------------------------------------------------


class _Writer:
    enabled = True

    def __init__(self):
        self.calls = []

    def add_histogram(self, tag, values, global_step=None):
        self.calls.append(('histogram', tag, np.asarray(values).shape))

    def add_image(self, tag, image, global_step=None):
        self.calls.append(('image', tag, np.asarray(image).shape))


def test_training_summary(rng):
    """summary_tensors' display tensors for the first 4 points, and
    log_image_summary's three distributions and, with matplotlib, the
    six-row montage of 4 patches."""
    pytest.importorskip('matplotlib')
    params, state = _jax_variables(WIDE, 0, rng)
    model = _port_model(WIDE, params, state)
    batch = tuple(torch.from_numpy(a) for a in _batch(rng, WIDE,
                                                      dtype=np.float32))
    t = radarnet_main.summary_tensors(
        model, Transforms(normalized_image_range=[0, 1]), batch, 0.4)
    assert model.training
    assert t['image'].shape == (4, *WIDE, 3)
    for k in ('response', 'output_label', 'ground_truth_label',
              'validity_map'):
        assert t[k].shape == (4, *WIDE, 1), k
    writer = _Writer()
    radarnet_main.log_image_summary(writer, 'train', 1, t)
    assert [c[0] for c in writer.calls] == ['histogram'] * 3 + ['image']
    assert writer.calls[-1][2] == (6 * WIDE[0], 4 * WIDE[1], 3)


# -- the column crop's gradient ------------------------------------------------


def _crop_case(rng, dtype=torch.float64):
    """Rows of two images and starts that take the first column, windows
    that reach past W, a start at W (a window of zeros) and starts beyond
    W (clipped to W)."""
    rows = torch.from_numpy(rng.standard_normal((2, 3, 4, 10))).to(dtype)
    starts = torch.tensor([[0, 7, 10, 3], [9, 14, 2, 2]], dtype=torch.int32)
    return rows, starts, 6


def test_crop_backward_equals_autograd_of_the_plain_crop(rng):
    """batch_column_crop_backward_plain against autograd of
    batch_column_crop_plain, float64, exact; the columns the windows never
    cover get 0."""
    rows, starts, win = _crop_case(rng)
    rows.requires_grad_(True)
    out = crop_cuda.batch_column_crop_plain(rows, starts, win)
    grad = torch.from_numpy(rng.standard_normal(out.shape))
    ref, = torch.autograd.grad(out, rows, grad)
    got = crop_cuda.batch_column_crop_backward_plain(grad, starts,
                                                     rows.shape, win)
    assert got.shape == rows.shape
    assert torch.equal(got, ref)


def test_column_crop_function_passes_gradcheck(rng):
    """The crop's gradient as ColumnCrop takes it on the card, a Function
    of the plain crop forward and batch_column_crop_backward_plain
    backward, through torch.autograd.gradcheck in float64; and the
    backward is the crop's adjoint: <crop(r), g> == <r, backward(g)>."""
    rows, starts, win = _crop_case(rng)

    class PlainCrop(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r):
            return crop_cuda.batch_column_crop_plain(r, starts, win)

        @staticmethod
        def backward(ctx, grad):
            return crop_cuda.batch_column_crop_backward_plain(
                grad, starts, rows.shape, win)

    assert torch.autograd.gradcheck(PlainCrop.apply,
                                    (rows.clone().requires_grad_(True),))
    grad = torch.from_numpy(rng.standard_normal((8, 3, 4, win)))
    lhs = float((crop_cuda.batch_column_crop_plain(rows, starts, win) *
                 grad).sum())
    rhs = float((rows * crop_cuda.batch_column_crop_backward_plain(
        grad, starts, rows.shape, win)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
