"""The model configurations of the JAX package that the port took last:
the bilinear align-corners resize, the transposed deconvolution, the
bottleneck and VGG blocks, the twin ResNet-based encoder, the multiscale
decoder at 2 to 4 output resolutions and with the 'upsample' output, and
FusionNet with the image-only ResNet encoders, with fusionnet34 and with
transposed deconvolutions; one train step of the multi-resolution
FusionNet; the shapes at which both packages fail; the CLIs' flags.

Each test builds the JAX module and the port's, draws the JAX module's
parameters (its tree, from ``jax.eval_shape`` of its init) with numpy from
a seed, carries them across with the port's ``state_dict_from_jax``, and
compares on numpy inputs from a seed. Tolerances: float32 within ATOL
(tests/test_torch_models.py's), bf16 within BF16_TOL of the values'
largest magnitude; the float64 train step as tests/test_torch_train.py's.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rcfd_tpu import fusionnet_main as jax_main  # noqa: E402
from rcfd_tpu.data.transforms import Transforms as JaxTransforms  # noqa
from rcfd_tpu.models import networks as jax_networks  # noqa: E402
from rcfd_tpu.models.fusionnet import FusionNetModel as JaxFusionNet  # noqa
from rcfd_tpu.nn import functional as JF  # noqa: E402
from rcfd_tpu.nn import layers as jax_layers  # noqa: E402
from rcfd_tpu.nn.optimize import fold_batch_norm as jax_fold  # noqa: E402
from rcfd_tpu.nn.perf import PerfConfig  # noqa: E402
from rcfd_tpu.utils import checkpoint as jax_ckpt  # noqa: E402

from rcfd_tpu_torch import fusionnet_main  # noqa: E402
from rcfd_tpu_torch import run_fusionnet, train_fusionnet  # noqa: E402
from rcfd_tpu_torch.data.transforms import Transforms  # noqa: E402
from rcfd_tpu_torch.models import networks  # noqa: E402
from rcfd_tpu_torch.models.fusionnet import FusionNetModel  # noqa: E402
from rcfd_tpu_torch.nn import functional as F  # noqa: E402
from rcfd_tpu_torch.nn import layers  # noqa: E402
from rcfd_tpu_torch.nn.optimize import fold_batch_norm  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

from torch_parity import (FUSIONNET_TINY, nchw, nhwc,  # noqa: E402
                          randomize_batch_norm)

ATOL = 1e-4
BF16_TOL = 2.0 ** -7
# the JAX package's plain math (its CPU default packs the decoder's tail)
PLAIN = PerfConfig(packed_tail=False)
ACT = ('leaky_relu_default', 0.10)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_tree(module, rng, dtype=np.float32):
    """(params, state) of the JAX ``module`` as numpy trees: its init's
    tree (``jax.eval_shape``, nothing compiled), each weight drawn from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in every axis but the
    last (HWIO, (I, O)), each bias from U(-0.1, 0.1), every batch norm
    from ``randomize_batch_norm``."""
    params, state = jax.eval_shape(module.init, jax.random.PRNGKey(0))

    def draw(leaf):
        shape = leaf.shape
        if not np.issubdtype(leaf.dtype, np.floating):
            return np.zeros(shape, leaf.dtype)
        if len(shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
        else:
            bound = 0.1
        return rng.uniform(-bound, bound, shape)
    params, state = randomize_batch_norm(
        jax.tree_util.tree_map(draw, params),
        jax.tree_util.tree_map(draw, state), rng)

    def cast(a):
        a = np.asarray(a)
        return a.astype(dtype) if np.issubdtype(a.dtype, np.floating) else a
    return (jax.tree_util.tree_map(cast, params),
            jax.tree_util.tree_map(cast, state))


def port_of(module, params, state):
    module.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return module


def close(out, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=atol,
                               rtol=0)


# -- resize_bilinear_align_corners ---------------------------------------

RESIZES = [((5, 7), (10, 14)), ((4, 6), (8, 12)), ((9, 4), (4, 9)),
           ((5, 7), (1, 1)), ((5, 7), (1, 6)), ((6, 8), (6, 8)),
           ((113, 3), (226, 5))]


@pytest.mark.parametrize('src, dst', RESIZES)
def test_resize_bilinear_align_corners_matches_jax(src, dst, rng):
    """Odd and even sizes, up and down, out == 1, equal size (the
    identity): float32 within ATOL of JAX's."""
    x = rng.normal(size=(2, *src, 3)).astype(np.float32)
    ref = JF.resize_bilinear_align_corners(jnp.asarray(x), dst)
    out = F.resize_bilinear_align_corners(nchw(x), dst)
    assert tuple(out.shape) == (2, 3, *dst)
    close(nhwc(out), ref)
    if src == dst:
        assert out.data_ptr() == nchw(x).data_ptr() or torch.equal(
            out, nchw(x))


def test_resize_bilinear_align_corners_bf16(rng):
    """bf16 in, bf16 out, within BF16_TOL of the largest magnitude of
    JAX's bf16 resize."""
    x = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    ref = np.asarray(JF.resize_bilinear_align_corners(
        jnp.asarray(x, jnp.bfloat16), (14, 18)).astype(jnp.float32))
    out = F.resize_bilinear_align_corners(nchw(x).to(torch.bfloat16),
                                          (14, 18))
    assert out.dtype == torch.bfloat16
    close(nhwc(out.float()), ref, BF16_TOL * np.abs(ref).max())


@pytest.mark.parametrize('src, dst', [((5, 7), (10, 14)), ((9, 4), (4, 9))])
def test_resize_bilinear_align_corners_gradient(src, dst, rng):
    """The gradient through the gathers and lerps against ``jax.grad``."""
    x = rng.normal(size=(2, *src, 3)).astype(np.float32)
    g = rng.normal(size=(2, *dst, 3)).astype(np.float32)
    ref = jax.grad(lambda a: jnp.sum(JF.resize_bilinear_align_corners(
        a, dst) * jnp.asarray(g)))(jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    (F.resize_bilinear_align_corners(xt, dst) * nchw(g)).sum().backward()
    close(nhwc(xt.grad), ref)


# -- layers -----------------------------------------------------------------

def _layer_pair(name, rng, *args, **kwargs):
    jm = getattr(jax_layers, name)(*args, **kwargs)
    p, s = jax_tree(jm, rng)
    return jm, p, s, port_of(getattr(layers, name)(*args, **kwargs), p, s)


def _apply(jm, p, s, x, port, training):
    ref, _ = jm(p, s, jnp.asarray(x), training=training)
    port.train(training)
    with torch.no_grad():
        out = port(nchw(x))
    return nhwc(out), ref


@pytest.mark.parametrize('training', [False, True])
@pytest.mark.parametrize('batch_norm', [False, True])
def test_transpose_conv2d_matches_jax(batch_norm, training, rng):
    """TransposeConv2d (stride 2, output padding 1: each side doubles),
    with and without batch norm, in eval and training mode."""
    jm, p, s, port = _layer_pair('TransposeConv2d', rng, 6, 5, 3,
                                 'kaiming_uniform', ACT, batch_norm)
    x = rng.normal(size=(2, 7, 5, 6)).astype(np.float32)
    out, ref = _apply(jm, p, s, x, port, training)
    assert out.shape == (2, 14, 10, 5)
    close(out, ref)


def test_transpose_conv2d_fold_matches_jax(rng):
    """The batch norm folded into the transposed conv (IOHW axis 1) gives
    the JAX package's folded tree and the unfolded output."""
    jm, p, s, port = _layer_pair('TransposeConv2d', rng, 6, 5, 3,
                                 'kaiming_uniform', ACT, True)
    fp, fs = jax_fold(p, s)
    folded = fold_batch_norm(port.eval())
    assert folded.batch_norm is None
    want = state_dict_from_jax(jax.device_get(fp), jax.device_get(fs))
    got = folded.state_dict()
    assert sorted(got) == sorted(want) == ['deconv.bias', 'deconv.weight']
    for k in want:
        close(got[k], want[k], 1e-6)
    x = rng.normal(size=(2, 7, 5, 6)).astype(np.float32)
    with torch.no_grad():
        close(folded(nchw(x)), port(nchw(x)))


def test_deconv_weight_round_trip(rng, tmp_path):
    """The transposed deconvolution's weight is IOHW in the reference
    layout: the port's mapping gives the JAX package's own
    ``tree_to_torch_state_dict`` and maps back to its tree, and a .pth and
    a .npz of a transposed FusionNet restore across, both ways, exactly."""
    jm, p, s, port = _layer_pair('TransposeConv2d', rng, 6, 5, 3,
                                 'kaiming_uniform', ACT, True)
    want = jax_ckpt.tree_to_torch_state_dict(p, s)
    got = state_dict_from_jax(p, s)
    assert want['deconv.weight'].shape == (6, 5, 3, 3)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    back, _ = jax_ckpt.torch_state_dict_to_tree(port.state_dict())
    np.testing.assert_array_equal(back['deconv']['weight'],
                                  p['deconv']['weight'])

    cfg = dict(FUSIONNET_TINY, deconv_type='transpose')
    jfn = JaxFusionNet(**cfg, perf=PLAIN)
    fp, fs = jax_tree(jfn, rng)
    model = port_of(FusionNetModel(**cfg, device='cpu'), fp, fs)
    for ext in ('pth', 'npz'):
        path = str(tmp_path / 'port.{}'.format(ext))
        model.save_checkpoint(path, 3)
        rp, rs, step, _ = jfn.restore_checkpoint(path)
        assert step == 3
        for tree, ref in ((rp, fp), (rs, fs)):
            flat, ref_flat = (jax_ckpt.tree_to_torch_state_dict(t)
                              for t in (tree, ref))
            assert sorted(flat) == sorted(ref_flat)
            for k in ref_flat:
                np.testing.assert_array_equal(flat[k], ref_flat[k], k)
        jpath = str(tmp_path / 'jax.{}'.format(ext))
        jfn.save_checkpoint(jpath, fp, fs, step=4)
        restored = FusionNetModel(**cfg, device='cpu')
        assert restored.restore_checkpoint(jpath, device='cpu') == 4
        for k, v in model.state_dict().items():
            assert torch.equal(restored.state_dict()[k], v), k
    assert any(k.endswith('deconv.deconv.weight')
               for k in model.state_dict())


@pytest.mark.parametrize('training', [False, True])
@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('name, args', [
    ('ResNetBottleneckBlock', (6, 4)), ('VGGNetBlock', (6, 5, 3))])
def test_bottleneck_and_vgg_blocks_match_jax(name, args, stride, training,
                                             rng):
    kwargs = dict(stride=stride, use_batch_norm=True)
    jm, p, s, port = _layer_pair(name, rng, *args, **kwargs)
    x = rng.normal(size=(2, 9, 8, 6)).astype(np.float32)
    out, ref = _apply(jm, p, s, x, port, training)
    assert out.shape == ref.shape
    close(out, ref)


def test_resnet_based_encoder_matches_jax(rng):
    kw = dict(input_channels_image=3, input_channels_depth=1,
              n_filters_image=[6, 8, 8, 12, 12],
              n_filters_depth=[4, 4, 6, 6, 6], use_batch_norm=True)
    jm = jax_networks.ResNetBasedEncoder(18, **kw)
    p, s = jax_tree(jm, rng)
    port = port_of(networks.ResNetBasedEncoder(18, **kw), p, s).eval()
    image = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    depth = rng.normal(size=(2, 64, 96, 1)).astype(np.float32)
    latent, skips, _ = jm(p, s, jnp.asarray(image), jnp.asarray(depth))
    with torch.no_grad():
        out, out_skips = port(nchw(image), nchw(depth))
    close(nhwc(out), latent)
    assert len(out_skips) == len(skips) == 4
    for a, b in zip(out_skips, skips):
        close(nhwc(a), b)


# -- the multiscale decoder ---------------------------------------------------

DECODER = dict(input_channels=8, output_channels=1,
               n_filters=[8, 8, 6, 6, 4], n_skips=[8, 8, 6, 4, 0],
               use_batch_norm=True)
DECODER_CASES = [(2, 'linear', 'up'), (3, 'linear', 'up'),
                 (4, 'linear', 'up'), (1, 'linear_upsample', 'up'),
                 (3, 'linear_upsample', 'up'), (3, 'linear', 'transpose')]


def _decoder_inputs(rng, h=64, w=96):
    """The latent at 1/32 and the skips at 1/2 to 1/16 of (h, w)."""
    x = rng.normal(size=(2, h // 32, w // 32, 8)).astype(np.float32)
    skips = [rng.normal(size=(2, h // f, w // f, c)).astype(np.float32)
             for f, c in ((2, 4), (4, 6), (8, 8), (16, 8))]
    return x, skips


@pytest.mark.parametrize('n_resolution, output_func, deconv_type',
                         DECODER_CASES)
def test_multiscale_decoder_matches_jax(n_resolution, output_func,
                                        deconv_type, rng):
    """Every output, from the coarsest side head to output0, within ATOL
    of the JAX decoder's, with the side heads' keys (output1..3)."""
    kw = dict(DECODER, n_resolution=n_resolution, output_func=output_func,
              deconv_type=deconv_type)
    jm = jax_networks.MultiScaleDecoder(**kw, perf=PLAIN)
    p, s = jax_tree(jm, rng)
    port = port_of(networks.MultiScaleDecoder(**kw), p, s).eval()
    want = max(n_resolution, 2 if 'upsample' in output_func else 1)
    heads = sorted(k.split('.')[0] for k in port.state_dict()
                   if k.startswith('output'))
    assert sorted(set(heads)) == ['output{}'.format(i) for i in range(want)]
    x, skips = _decoder_inputs(rng)
    ref, _ = jm(p, s, jnp.asarray(x), [jnp.asarray(a) for a in skips],
                shape=(64, 96))
    with torch.no_grad():
        out = port(nchw(x), [nchw(a) for a in skips], shape=(64, 96))
    assert len(out) == len(ref) == want
    for a, b in zip(out, ref):
        assert nhwc(a).shape == b.shape
        close(nhwc(a), b)


# -- FusionNet --------------------------------------------------------------

FUSIONNET_CASES = {
    'resnet18': dict(encoder_type='resnet18_batch_norm'),
    'resnet34': dict(encoder_type='resnet34_batch_norm'),
    'fusionnet34': dict(encoder_type='fusionnet34_batch_norm'),
    'transpose': dict(deconv_type='transpose'),
    'resnet18_multiscale': dict(encoder_type='resnet18_batch_norm',
                                n_resolution_decoder=3),
    'fusionnet18_multiscale': dict(n_resolution_decoder=4),
}


@pytest.mark.parametrize('case', sorted(FUSIONNET_CASES))
def test_fusionnet_configurations_match_jax(case, rng):
    """apply with and without return_multiscale, eval mode, at 64 x 128
    (every side halves evenly down the 6-level encoder, as the transposed
    route needs); an image-only encoder ignores the input depth."""
    cfg = dict(FUSIONNET_TINY, **FUSIONNET_CASES[case])
    jm = JaxFusionNet(**cfg, perf=PLAIN)
    p, s = jax_tree(jm, rng)
    port = port_of(FusionNetModel(**cfg, device='cpu'), p, s)
    image = rng.random((2, 64, 128, 3)).astype(np.float32)
    depth = (rng.random((2, 64, 128, 2)) * 2).astype(np.float32)
    ref, _ = jm.apply(p, s, jnp.asarray(image), jnp.asarray(depth),
                      return_multiscale=True)
    out = port.apply(torch.from_numpy(image), torch.from_numpy(depth),
                     return_multiscale=True)
    assert len(out) == len(ref) == max(cfg['n_resolution_decoder'], 1)
    for a, b in zip(out, ref):
        close(a.numpy(), b)
    single = port.apply(torch.from_numpy(image), torch.from_numpy(depth))
    assert torch.equal(single, out[-1])
    if port.image_only:
        other = port.apply(torch.from_numpy(image),
                           torch.zeros(2, 64, 128, 2))
        assert torch.equal(other, single)


def _fits(fn):
    """'runs' or 'fails' (the exception's type name ignored: torch raises a
    RuntimeError, JAX a TypeError or ValueError from its concat)."""
    try:
        fn()
    except (RuntimeError, TypeError, ValueError):
        return 'fails'
    return 'runs'


@pytest.mark.parametrize('h, w, extra, expect', [
    # 100 rows: the encoder gives 50, 25, 13, 7, 4, 2; output3 at 13
    # resizes to 26 against a skip of 25, output2 at 25 to 50 fits (the
    # bash configuration at 900 rows: 113 -> 226 against 225)
    (100, 96, dict(n_resolution_decoder=3), 'runs'),
    (100, 96, dict(n_resolution_decoder=4), 'fails'),
    # the transposed route doubles 2 to 4 against a skip of 3 at 96 wide
    # (test_fusionnet_configurations_match_jax runs both at 64 x 128)
    (64, 96, dict(deconv_type='transpose'), 'fails'),
    (100, 128, dict(deconv_type='transpose'), 'fails'),
])
def test_shapes_fail_where_jax_fails(h, w, extra, expect, rng):
    """At sizes that do not halve evenly down the encoder the side outputs'
    2x resize, or the transposed deconvolution, misses its skip and the
    concat fails in both packages; where JAX runs, the port runs and
    agrees."""
    cfg = dict(FUSIONNET_TINY, **extra)
    jm = JaxFusionNet(**cfg, perf=PLAIN)
    p, s = jax_tree(jm, rng)
    port = port_of(FusionNetModel(**cfg, device='cpu'), p, s)
    image = rng.random((1, h, w, 3)).astype(np.float32)
    depth = rng.random((1, h, w, 2)).astype(np.float32)
    results = {}

    def run_jax():
        results['jax'] = jm.apply(p, s, jnp.asarray(image),
                                  jnp.asarray(depth))[0]

    def run_port():
        results['port'] = port.apply(torch.from_numpy(image),
                                     torch.from_numpy(depth))

    assert _fits(run_jax) == _fits(run_port) == expect
    if expect == 'runs':
        close(results['port'].numpy(), results['jax'])


# -- one train step of the multi-resolution FusionNet ---------------------------

TRAIN_CFG = dict(FUSIONNET_TINY, n_filters_encoder_image=[4, 6, 8, 8, 8],
                 n_filters_encoder_depth=[4, 4, 6, 6, 6],
                 n_filters_decoder=[8, 8, 6, 6, 4])
STEP_KW = dict(loss_func='l1', w_lidar_loss=2.0, outlier_kernel_size=7,
               outlier_threshold=1.5, dilation_kernel_size=3)
# float64 on both sides, weights drawn by jax_tree: the single-resolution
# step of TRAIN_CFG, which tests/test_torch_train.py holds within 1e-10 /
# 1e-8 from JAX's own init, differs here by 4e-10 in the loss and 2.4e-7
# of a gradient's max-abs (JAX's batch-norm variance, E[x^2] - mean^2,
# cancels on these batches); the multi-resolution step is held to the same
STEP_LOSS_RTOL, STEP_GRAD_TOL = 1e-8, 1e-5


@pytest.mark.parametrize('n_resolution', [1, 3])
def test_multiresolution_train_step_matches_jax_float64(n_resolution, rng,
                                                        monkeypatch):
    """One step of FusionNet with --n_resolutions_decoder 3 (and 1, its
    yardstick) in float64, JAX's own _make_train_step (its Adam swapped for
    a function that hands back the gradients) against the port's
    TrainStep: the loss (of output0 alone on both sides: the step applies
    the model without return_multiscale) within STEP_LOSS_RTOL, every
    gradient within STEP_GRAD_TOL of its max-abs. The side heads' outputs
    join the next block's skip, so they have gradients, on both sides
    alike."""
    cfg = dict(TRAIN_CFG, n_resolution_decoder=n_resolution)
    params, state = jax_tree(JaxFusionNet(**cfg, perf=PLAIN), rng,
                             np.float64)
    n, h, w = 2, 32, 32
    image = rng.integers(0, 256, (n, h, w, 3)).astype(np.float64)
    depth = rng.random((n, h, w, 1)) * 60
    response = rng.random((n, h, w, 1))
    gt = rng.random((n, h, w, 1)) * 70 + 1
    gt[rng.random((n, h, w, 1)) < 0.6] = 0.0
    lidar = rng.random((n, h, w, 1)) * 70 + 1
    lidar[rng.random((n, h, w, 1)) < 0.9] = 0.0
    batch = (image, depth, response, gt, lidar)
    jax.config.update('jax_enable_x64', True)
    try:
        monkeypatch.setattr(jax_main, 'adam_step',
                            lambda p, grads, opt, lr, weight_decay: (grads,
                                                                     opt))
        step = jax.jit(jax_main._make_train_step(
            JaxFusionNet(**cfg, perf=PLAIN),
            JaxTransforms(normalized_image_range=[0, 1]), w_smoothness=0.0,
            loss_smoothness_kernel_size=-1, w_weight_decay=0.0, **STEP_KW))
        grads, _, _, info = step(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state), None,
            tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(3),
            1e-3, 0.0)
        grads = jax_ckpt.tree_to_torch_state_dict(jax.device_get(grads))
        loss = float(info['loss'])
    finally:
        jax.config.update('jax_enable_x64', False)
    model = FusionNetModel(**cfg, device='cpu', trainable=True)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    model = model.double()
    transforms = Transforms(normalized_image_range=[0, 1])
    port = fusionnet_main.TrainStep(
        model, transforms, fusionnet_main.make_optimizer(model, 1e-3, 0.0),
        w_smoothness=0.0, loss_smoothness_kernel_size=-1, **STEP_KW)
    draws = transforms.draws(torch.Generator().manual_seed(0), n, 0.0)
    info_port = port.backward(tuple(torch.from_numpy(a) for a in batch),
                              draws)
    np.testing.assert_allclose(float(info_port['loss']), loss,
                               rtol=STEP_LOSS_RTOL)
    heads = 0
    for name, p in model.named_parameters():
        ref = grads[name]
        scale = max(np.abs(ref).max(), 1e-300)
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        assert np.abs(g - ref).max() <= STEP_GRAD_TOL * scale, name
        if name.startswith('decoder.output') and \
                not name.startswith('decoder.output0'):
            heads += 1
            assert np.abs(ref).max() > 0, name
    assert heads == n_resolution - 1  # output1 and output2, weights only


# -- the CLIs -----------------------------------------------------------------

def _jax_parser(script):
    """The module-level ``parser`` of a root script of the JAX package,
    loaded without running it."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), script)
    spec = importlib.util.spec_from_file_location(
        'jax_' + script[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.parser


TRAIN_PATHS = ['--{}_path'.format(k) for k in (
    'train_image', 'train_depth', 'train_response', 'train_ground_truth',
    'train_lidar_map', 'val_image', 'val_depth', 'val_response',
    'val_ground_truth')]
RUN_PATHS = ['--restore_path', '--image_path', '--depth_path',
             '--response_path', '--output_dirpath']
CLI_FLAGS = [['--n_resolutions_decoder', '3'],
             ['--encoder_type', 'resnet18', 'batch_norm'],
             ['--encoder_type', 'resnet34', 'batch_norm',
              '--n_resolutions_decoder', '2'],
             ['--encoder_type', 'fusionnet34', 'batch_norm']]


@pytest.mark.parametrize('flags', CLI_FLAGS, ids=lambda f: '_'.join(
    a.strip('-') for a in f))
@pytest.mark.parametrize('cli, script, paths', [
    (train_fusionnet, 'train_fusionnet.py',
     TRAIN_PATHS + ['--checkpoint_dirpath']),
    (run_fusionnet, 'run_fusionnet.py', RUN_PATHS)],
    ids=['train', 'run'])
def test_clis_parse_and_build_the_configurations(cli, script, paths, flags,
                                                 monkeypatch):
    """The port's CLI parses the flags as the JAX script's ``parser``
    (every argument but ``--device``, whose default is the card), and its
    ``main`` hands the model its encoder type and decoder resolutions
    (0 -> 1, as JAX's) through ``fusionnet_main.build_model``."""
    argv = [t for p in paths for t in (p, 'x')] + flags
    ours = vars(cli.parser.parse_args(argv))
    theirs = vars(_jax_parser(script).parse_args(argv))
    assert {k: v for k, v in ours.items() if k != 'device'} == \
        {k: v for k, v in theirs.items() if k != 'device'}
    entry = 'train' if cli is train_fusionnet else 'run'
    seen = {}

    class Reached(Exception):
        pass

    def entry_point(**kwargs):
        seen.update(kwargs)
        raise Reached

    monkeypatch.setattr(fusionnet_main, entry, entry_point)
    with pytest.raises(Reached):
        cli.main(argv + ['--n_filters_encoder_image', '4', '6', '8', '8',
                         '8', '8', '--n_filters_encoder_depth', '4', '4',
                         '6', '6', '6', '6', '--n_filters_decoder', '8', '8',
                         '8', '6', '6', '4'],
                 **({'device': 'cpu'} if entry == 'run' else {}))
    names = ('input_channels_image', 'input_channels_depth', 'encoder_type',
             'n_filters_encoder_image', 'n_filters_encoder_depth',
             'fusion_type', 'decoder_type', 'n_resolutions_decoder',
             'n_filters_decoder', 'weight_initializer', 'activation_func',
             'min_predict_depth', 'max_predict_depth')
    model = fusionnet_main.build_model(*(seen[k] for k in names),
                                       device='cpu')
    encoder = '-'.join(flags[flags.index('--encoder_type') + 1:][:2]) \
        if '--encoder_type' in flags else 'fusionnet18-batch_norm'
    n_res = int(flags[flags.index('--n_resolutions_decoder') + 1]) \
        if '--n_resolutions_decoder' in flags else 1
    assert seen['encoder_type'] == encoder
    assert seen['n_resolutions_decoder'] == n_res
    assert model.image_only == encoder.startswith('resnet')
    assert isinstance(model.encoder, networks.ResNetEncoder
                      if model.image_only else networks.FusionNetEncoder)
    assert sorted(model.decoder.heads.values()) == [
        'output{}'.format(i) for i in range(1, n_res)]
    jm = jax_main._build_model(*(seen[k] for k in names))
    jp, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert sorted(jax_ckpt.tree_to_torch_state_dict(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), jp))) == sorted(
            n for n, _ in model.named_parameters())
