"""The pieces of the port's FusionNet training on the CPU against the JAX
package, on the same inputs made with numpy: the losses, the ground-truth
ops (dilation, min pool, outlier removal), batch norm in training mode,
the augmentation (fed the draws of JAX's key sequence), the random crop,
the datasets, the loader's order and Adam. Each test states its
tolerance."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rcfd_tpu.data import datasets as jax_datasets  # noqa: E402
from rcfd_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from rcfd_tpu.data.transforms import Transforms as JaxTransforms  # noqa
from rcfd_tpu.models import losses as jax_losses  # noqa: E402
from rcfd_tpu.nn import functional as JF  # noqa: E402
from rcfd_tpu.nn.layers import BatchNorm2d as JaxBatchNorm  # noqa: E402
from rcfd_tpu.parallel.optim import adam_step, init_adam  # noqa: E402

from rcfd_tpu_torch.data import datasets, transport  # noqa: E402
from rcfd_tpu_torch.data.loader import DataLoader, device_prefetch  # noqa
from rcfd_tpu_torch.data.transforms import PHOTOMETRIC, Transforms  # noqa
from rcfd_tpu_torch.models import losses  # noqa: E402
from rcfd_tpu_torch.nn import BatchNorm2d  # noqa: E402
from rcfd_tpu_torch.nn import functional as F  # noqa: E402

from fixtures import make_fusionnet_fixture  # noqa: E402
from torch_parity import nchw, nhwc  # noqa: E402


def _maps(rng, shape=(2, 16, 20, 1), empty=0.6):
    m = (rng.random(shape) * 70 + 1).astype(np.float32)
    m[rng.random(shape) < empty] = 0.0
    return m


# -- losses ---------------------------------------------------------------


@pytest.mark.parametrize('name', ['l1_loss', 'l2_loss', 'smooth_l1_loss'])
@pytest.mark.parametrize('masked', [False, True])
def test_supervised_losses_match_jax(rng, name, masked):
    """rtol 1e-6 (float32 sums in another order)."""
    src = (rng.random((2, 16, 20, 1)) * 3).astype(np.float32)
    tgt = _maps(rng)
    weight = (tgt > 0).astype(np.float32) if masked else None
    ref = getattr(jax_losses, name)(
        jnp.asarray(src), jnp.asarray(tgt),
        weight=None if weight is None else jnp.asarray(weight))
    out = getattr(losses, name)(nchw(src), nchw(tgt),
                                weight=None if weight is None
                                else nchw(weight))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


def test_bce_with_logits_matches_jax(rng):
    """Elementwise, rtol 1e-6."""
    logits = (rng.normal(size=(3, 7)) * 4).astype(np.float32)
    targets = (rng.random((3, 7)) < 0.4).astype(np.float32)
    ref = jax_losses.binary_cross_entropy_with_logits(
        jnp.asarray(logits), jnp.asarray(targets), pos_weight=2.0)
    out = losses.binary_cross_entropy_with_logits(
        torch.from_numpy(logits), torch.from_numpy(targets), pos_weight=2.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize('kernel', [1, 3, 7])
def test_smoothness_losses_match_jax(rng, kernel):
    """Kernel 1 the edge-aware first differences, else the sobel form with
    validity weights; rtol 1e-6."""
    predict = (rng.random((2, 16, 20, 1)) * 50 + 1).astype(np.float32)
    image = rng.random((2, 16, 20, 3)).astype(np.float32)
    weights = (rng.random((2, 16, 20, 1)) < 0.5).astype(np.float32)
    if kernel == 1:
        ref = jax_losses.smoothness_loss_func(jnp.asarray(predict),
                                              jnp.asarray(image))
        out = losses.smoothness_loss_func(nchw(predict), nchw(image))
    else:
        size = (1, 1, kernel, kernel)
        ref = jax_losses.sobel_smoothness_loss_func(
            jnp.asarray(predict), jnp.asarray(image), jnp.asarray(weights),
            filter_size=size)
        out = losses.sobel_smoothness_loss_func(
            nchw(predict), nchw(image), nchw(weights), filter_size=size)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


# -- ground-truth ops and batch norm -----------------------------------------


@pytest.mark.parametrize('kernel', [3, 7])
def test_dilation_min_pool_and_outlier_removal_match_jax(rng, kernel):
    """Max pool at stride 1 (the GT dilation), min pool and outlier
    removal: exact."""
    gt = _maps(rng, (2, 24, 30, 1), empty=0.8)
    pad = kernel // 2
    np.testing.assert_array_equal(
        nhwc(F.max_pool2d(nchw(gt), kernel, 1, pad)),
        np.asarray(JF.max_pool2d(jnp.asarray(gt), kernel, 1, pad)))
    np.testing.assert_array_equal(
        nhwc(F.min_pool2d(nchw(gt), kernel, 1, pad)),
        np.asarray(JF.min_pool2d(jnp.asarray(gt), kernel, 1, pad)))
    ref = np.asarray(JF.outlier_removal(jnp.asarray(gt), kernel, 1.5))
    out = nhwc(F.outlier_removal(nchw(gt), kernel, 1.5))
    np.testing.assert_array_equal(out, ref)
    assert (ref == 0).sum() > (gt == 0).sum()  # some outliers were removed


def test_batch_norm_training_matches_jax(rng):
    """Training mode: output, running mean and variance and count against
    the JAX layer, rtol 1e-5; back in eval mode, the JAX layer's inference
    on the port's running statistics, rtol 1e-6."""
    x = (rng.normal(size=(3, 6, 7, 5)) * 2 + 1).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.normal(0, 0.1, 5).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 5).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    state = {'running_mean': jnp.asarray(mean0),
             'running_var': jnp.asarray(var0),
             'num_batches_tracked': jnp.zeros((), jnp.int32)}
    y_ref, s_ref = JaxBatchNorm(5)(
        {'weight': jnp.asarray(weight), 'bias': jnp.asarray(bias)}, state,
        jnp.asarray(x), training=True)
    bn = BatchNorm2d(5)
    with torch.no_grad():
        for t, v in ((bn.weight, weight), (bn.bias, bias),
                     (bn.running_mean, mean0), (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    bn.train()
    y = bn(nchw(x))
    np.testing.assert_allclose(nhwc(y.detach()), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(s_ref['running_mean']), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(s_ref['running_var']), rtol=1e-5)
    assert int(bn.num_batches_tracked) == int(s_ref['num_batches_tracked'])
    bn.eval()
    y_eval, _ = JaxBatchNorm(5)(
        {'weight': jnp.asarray(weight), 'bias': jnp.asarray(bias)},
        {'running_mean': jnp.asarray(bn.running_mean.numpy()),
         'running_var': jnp.asarray(bn.running_var.numpy())},
        jnp.asarray(x), training=False)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(bn(nchw(x))), np.asarray(y_eval),
                                   rtol=1e-6, atol=1e-6)


# -- augmentation ------------------------------------------------------------

AUGMENT = dict(random_brightness=[0.8, 1.2], random_contrast=[0.7, 1.3],
               random_saturation=[0.6, 1.4],
               random_flip_type=['horizontal', 'vertical'])


def jax_draws(key, transforms, n_batch, p):
    """The draws the JAX transform takes from ``key`` for one image
    (rcfd_tpu/data/transforms.py ``transform``: the key split five ways,
    the photometric key once for the one image and three ways, each op's
    key two ways), in the port's ``draws`` layout."""
    k_gate, k_photo, _, k_h, k_v = jax.random.split(key, 5)
    do = jax.random.uniform(k_gate, (n_batch,)) <= p
    keys = jax.random.split(jax.random.split(k_photo, 1)[0], 3)
    out = {}
    for name, k in zip(PHOTOMETRIC, keys):
        if name in transforms.ranges:
            lo, hi = transforms.ranges[name]
            k1, k2 = jax.random.split(k)
            out[name + '_gate'] = do & (jax.random.uniform(k1, (n_batch,))
                                        <= 0.5)
            out[name + '_factor'] = (hi - lo) * jax.random.uniform(
                k2, (n_batch,)) + lo
    if transforms.do_random_horizontal_flip:
        out['horizontal_flip'] = do & (jax.random.uniform(k_h, (n_batch,))
                                       <= 0.5)
    if transforms.do_random_vertical_flip:
        out['vertical_flip'] = do & (jax.random.uniform(k_v, (n_batch,))
                                     <= 0.5)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('scale', ['int', 'unit'])
def test_transforms_apply_matches_jax(rng, seed, scale):
    """Transforms.apply fed the draws of JAX's key sequence against
    rcfd_tpu.data.transforms.Transforms.transform: images exact for [0,
    255] images (floor and clip apply), within 1e-6 for [0, 1] ones; range
    maps and boxes exact."""
    n = 6
    image = rng.integers(0, 256, (n, 12, 16, 3)).astype(np.float32)
    if scale == 'unit':
        image = image / 255.0
    maps = [_maps(rng, (n, 12, 16, 1)) for _ in range(2)]
    boxes = rng.integers(0, 16, (n, 3, 4)).astype(np.float32)
    kw = dict(normalized_image_range=[0, 1], **AUGMENT)
    key = jax.random.PRNGKey(seed)
    (im_ref,), maps_ref, boxes_ref = JaxTransforms(**kw).transform(
        key, [jnp.asarray(image)], range_maps_arr=[jnp.asarray(m)
                                                   for m in maps],
        bounding_boxes_arr=[jnp.asarray(boxes)],
        random_transform_probability=0.8)
    port = Transforms(**kw)
    draws = jax_draws(key, port, n, 0.8)
    assert any(bool(v.any()) for k, v in draws.items() if 'gate' in k)
    im, maps_out, boxes_out = port.apply(
        draws, torch.from_numpy(image), [torch.from_numpy(m) for m in maps],
        [torch.from_numpy(boxes)])
    if scale == 'int':
        np.testing.assert_array_equal(im.numpy(), np.asarray(im_ref))
    else:
        np.testing.assert_allclose(im.numpy(), np.asarray(im_ref),
                                   rtol=0, atol=1e-6)
    for a, b in zip(maps_out + boxes_out, list(maps_ref) + list(boxes_ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_draws_come_from_the_generator():
    """The same generator state gives the same draws; p = 0 gates nothing
    and flips nothing."""
    port = Transforms(normalized_image_range=[0, 1], **AUGMENT)
    a = port.draws(torch.Generator().manual_seed(5), 8, 1.0)
    b = port.draws(torch.Generator().manual_seed(5), 8, 1.0)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert sorted(a) == sorted(
        [n + s for n in PHOTOMETRIC for s in ('_gate', '_factor')] +
        ['horizontal_flip', 'vertical_flip'])
    lo, hi = AUGMENT['random_contrast']
    assert bool(((a['contrast_factor'] >= lo) &
                 (a['contrast_factor'] <= hi)).all())
    off = port.draws(torch.Generator().manual_seed(5), 8, 0.0)
    assert not any(bool(v.any()) for k, v in off.items()
                   if k.endswith(('gate', 'flip')))


# -- crop, datasets, loader --------------------------------------------------

CROP_TYPES = [('none',), ('horizontal',), ('vertical',),
              ('horizontal', 'vertical'), ('anchored', 'horizontal',
                                           'vertical'),
              ('top', 'left'), ('bottom', 'right'), ('center',)]


@pytest.mark.parametrize('crop_type', CROP_TYPES, ids='-'.join)
def test_random_crop_matches_jax(rng, crop_type):
    """The same windows from the same Generator seeds: bit for bit."""
    inputs = [rng.random((20, 30, c)) for c in (3, 1)]
    for seed in range(8):
        ref = jax_datasets.random_crop(inputs, (12, 14), crop_type,
                                       np.random.default_rng(seed))
        out = datasets.random_crop(inputs, (12, 14), crop_type,
                                   np.random.default_rng(seed))
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    return make_fusionnet_fixture(str(tmp_path_factory.mktemp('fn')),
                                  n_samples=5, height=24, width=32)


def _paths(fixture, names):
    from rcfd_tpu_torch.data import io
    return [io.read_paths(fixture[n]) for n in names]


TRAIN_STREAMS = ('image', 'depth', 'response', 'ground_truth', 'lidar')


def test_fusionnet_datasets_match_jax(fixture):
    """FusionNetTrainingDataset (crop from the same Generator) and
    FusionNetInferenceDataset against the JAX package's, integer transport:
    bit for bit, dtypes too."""
    paths = _paths(fixture, TRAIN_STREAMS)
    port = datasets.FusionNetTrainingDataset(
        *paths, shape=(16, 20), random_crop_type=('horizontal', 'vertical'),
        device='cpu')
    ref = jax_datasets.FusionNetTrainingDataset(
        *paths, shape=(16, 20), random_crop_type=('horizontal', 'vertical'),
        transport=True)
    for i in range(len(port)):
        a = port.get(i, np.random.default_rng((3, i)))
        b = ref.get(i, np.random.default_rng((3, i)))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    assert a[0].dtype == np.uint8 and a[1].dtype == np.uint16
    val = _paths(fixture, ('image', 'depth', 'response', 'ground_truth'))
    port = datasets.FusionNetInferenceDataset(*val, device='cpu')
    ref = jax_datasets.FusionNetInferenceDataset(*val, transport=True)
    for i in range(len(port)):
        for x, y in zip(port.get(i), ref.get(i)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('crop_type', [('none',), ('horizontal', 'vertical'),
                                       ('anchored', 'horizontal')],
                         ids='-'.join)
def test_loader_batches_match_jax(fixture, crop_type):
    """Two epochs of shuffled, drop_last batches of 2 against the JAX
    DataLoader on the same datasets and seed: bit for bit, whatever the
    worker counts; device_prefetch on the CPU hands the arrays over as
    tensors."""
    paths = _paths(fixture, TRAIN_STREAMS)
    port = DataLoader(datasets.FusionNetTrainingDataset(
        *paths, shape=(16, 20), random_crop_type=crop_type, device='cpu'),
        batch_size=2, shuffle=True, num_workers=3, seed=7, drop_last=True)
    ref = JaxDataLoader(jax_datasets.FusionNetTrainingDataset(
        *paths, shape=(16, 20), random_crop_type=crop_type, transport=True),
        batch_size=2, shuffle=True, num_workers=1, seed=7, drop_last=True)
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = list(device_prefetch(port, 'cpu'))
        want = list(ref)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), y)
    # a resumed epoch yields its batches from start_batch on
    port.set_epoch(2, start_batch=1)
    rest = list(port)
    assert len(rest) == 1
    for x, y in zip(rest[0], want[1]):
        np.testing.assert_array_equal(x, y)


def test_transport_decode_of_loader_batches(fixture):
    """The decode of a transported batch equals the JAX host decode."""
    from rcfd_tpu.data import transport as jax_transport
    paths = _paths(fixture, TRAIN_STREAMS)
    batch = next(iter(DataLoader(datasets.FusionNetTrainingDataset(
        *paths, device='cpu'), batch_size=2)))
    for a, b in zip(batch, jax_transport.decode_np(batch)):
        out = transport.decode(torch.from_numpy(a))
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), b)


# -- Adam ---------------------------------------------------------------------


@pytest.mark.parametrize('weight_decay', [0.0, 1e-4])
def test_adam_matches_jax(rng, weight_decay):
    """torch.optim.Adam (the port's optimizer) against adam_step over 3
    steps on the same gradients: float32, rtol 1e-6."""
    from rcfd_tpu_torch.fusionnet_main import make_optimizer

    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10 ** -i
              for s in shapes] for i in range(3)]
    tree = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    opt = init_adam(tree)
    module = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(
        p.copy())) for p in params])
    optimizer = make_optimizer(module, 1e-3, weight_decay)
    for step, g in enumerate(grads):
        lr = 1e-3 / (step + 1)
        tree, opt = adam_step(tree, {str(i): jnp.asarray(x)
                                     for i, x in enumerate(g)}, opt,
                              jnp.float32(lr), weight_decay=weight_decay)
        for p, x in zip(module, g):
            p.grad = torch.from_numpy(x)
        for group in optimizer.param_groups:
            group['lr'] = lr
        optimizer.step()
    for i, p in enumerate(module):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(tree[str(i)]), rtol=1e-6,
                                   atol=1e-7)
        state = optimizer.state[p]
        np.testing.assert_allclose(state['exp_avg'].numpy(),
                                   np.asarray(opt['mu'][str(i)]), rtol=1e-6)
        np.testing.assert_allclose(state['exp_avg_sq'].numpy(),
                                   np.asarray(opt['nu'][str(i)]), rtol=1e-6)
        assert int(state['step']) == int(opt['count']) == 3
