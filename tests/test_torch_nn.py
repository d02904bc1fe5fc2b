"""rcfd_tpu_torch substrate (nn/, data/, default_device) against the JAX
package on the CPU: the same numpy inputs and weights through both."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rcfd_tpu.data import transport as jax_transport  # noqa: E402
from rcfd_tpu.data.transforms import Transforms as JaxTransforms  # noqa: E402
from rcfd_tpu.nn import functional as JF  # noqa: E402
from rcfd_tpu.nn import layers as JL  # noqa: E402
from rcfd_tpu.nn.perf import PerfConfig  # noqa: E402

import rcfd_tpu_torch  # noqa: E402
from rcfd_tpu_torch.data import transport  # noqa: E402
from rcfd_tpu_torch.data.transforms import Transforms  # noqa: E402
from rcfd_tpu_torch.nn import functional as TF  # noqa: E402
from rcfd_tpu_torch.nn import layers as TL  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

from torch_parity import jax_variables, nchw, nhwc  # noqa: E402

# float32 layers: both frameworks sum the same products in another order
ATOL = RTOL = 1e-5


def _port(module, params, state):
    module.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return module.requires_grad_(False).eval()


@pytest.mark.parametrize('name', ['relu', 'leaky_relu', 'elu', 'sigmoid',
                                  'linear'])
def test_activation_fn_matches_jax(name):
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    ref = JF.activation_fn(name)
    out = TF.activation_fn(name)
    if ref is None:
        assert out is None
        return
    # elementwise float32: the two may differ in the last bit of exp
    np.testing.assert_allclose(out(torch.from_numpy(x)).numpy(),
                               np.asarray(ref(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_leaky_relu_slopes():
    """'leaky_relu' by name is slope 0.20; the layer default is 0.10."""
    x = torch.tensor([-1.0, 0.0, 2.0])
    assert TF.activation_fn('leaky_relu')(x).tolist() == \
        pytest.approx([-0.2, 0.0, 2.0])
    default = TL._resolve_activation(('leaky_relu_default', 0.10))
    assert default(x).tolist() == pytest.approx([-0.1, 0.0, 2.0])


@pytest.mark.parametrize('src,dst', [(29, 57), (57, 113), (113, 225),
                                     (112, 225), (9, 18)])
def test_resize_nearest_integer_map(src, dst, rng):
    """The integer map (dst * in) // out at the odd ratios of the full-width
    decoders, exactly."""
    x = rng.random((1, src, src + 3, 2), dtype=np.float32)
    ref = np.asarray(JF.resize_nearest(jnp.asarray(x), (dst, dst + 5)))
    out = nhwc(TF.resize_nearest(nchw(x), (dst, dst + 5)))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize('k,stride,bn,act', [
    (3, 1, True, 'leaky_relu'), (7, 2, True, 'relu'), (1, 2, False, None),
    (3, 2, False, ('leaky_relu_default', 0.10)), (1, 1, True, 'sigmoid')])
def test_conv2d_matches_jax(k, stride, bn, act, rng):
    jm = JL.Conv2d(5, 6, k, stride, activation_func=act, use_batch_norm=bn)
    p, s = jax_variables(jm, 0, rng)
    tm = _port(TL.Conv2d(5, 6, k, stride, activation_func=act,
                         use_batch_norm=bn), p, s)
    x = rng.standard_normal((2, 11, 13, 5)).astype(np.float32)
    ref, _ = jm(p, s, jnp.asarray(x))
    np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_batch_norm_matches_jax(rng):
    jm = JL.BatchNorm2d(7)
    p, s = jax_variables(JL.Conv2d(7, 7, 1, use_batch_norm=True), 0, rng)
    p, s = p['batch_norm'], s['batch_norm']
    tm = _port(TL.BatchNorm2d(7), p, s)
    x = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    ref, _ = jm(p, s, jnp.asarray(x))
    np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_upconv2d_matches_jax(rng):
    jm = JL.UpConv2d(4, 3, use_batch_norm=True, perf=PerfConfig())
    p, s = jax_variables(jm, 1, rng)
    tm = _port(TL.UpConv2d(4, 3, use_batch_norm=True), p, s)
    x = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)
    ref, _ = jm(p, s, jnp.asarray(x), (13, 19))
    np.testing.assert_allclose(nhwc(tm(nchw(x), (13, 19))), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('with_skip', [True, False])
def test_decoder_block_matches_jax(with_skip, rng):
    skip_ch = 3 if with_skip else 0
    jm = JL.DecoderBlock(6, skip_ch, 4, use_batch_norm=True,
                         perf=PerfConfig())
    p, s = jax_variables(jm, 2, rng)
    tm = _port(TL.DecoderBlock(6, skip_ch, 4, use_batch_norm=True), p, s)
    x = rng.standard_normal((2, 7, 9, 6)).astype(np.float32)
    if with_skip:
        skip = rng.standard_normal((2, 13, 18, 3)).astype(np.float32)
        ref, _ = jm(p, s, jnp.asarray(x), skip=jnp.asarray(skip))
        out = tm(nchw(x), skip=nchw(skip))
    else:
        ref, _ = jm(p, s, jnp.asarray(x), shape=(15, 17))
        out = tm(nchw(x), shape=(15, 17))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize('cin,cout,stride', [(4, 4, 1), (4, 6, 2)])
def test_resnet_block_matches_jax(cin, cout, stride, rng):
    act = JF.activation_fn('leaky_relu')
    jm = JL.ResNetBlock(cin, cout, stride, activation_func=act,
                        use_batch_norm=True)
    p, s = jax_variables(jm, 3, rng)
    tm = _port(TL.ResNetBlock(cin, cout, stride,
                              activation_func=TF.activation_fn('leaky_relu'),
                              use_batch_norm=True), p, s)
    x = rng.standard_normal((2, 9, 10, cin)).astype(np.float32)
    ref, _ = jm(p, s, jnp.asarray(x))
    np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_fully_connected_matches_jax(rng):
    jm = JL.FullyConnected(5, 7, activation_func='leaky_relu')
    p, s = jax_variables(jm, 4, rng)
    tm = _port(TL.FullyConnected(5, 7, activation_func='leaky_relu'), p, s)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    ref, _ = jm(p, s, jnp.asarray(x))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(),
                               np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('initializer', ['kaiming_uniform', 'kaiming_normal',
                                         'xavier_uniform', 'xavier_normal'])
def test_init_parameters_is_seeded(initializer):
    """Weights drawn in the JAX package's initializer styles from an
    explicit generator: the same seed gives the same weights; uniform
    draws stay inside the JAX package's bounds."""
    def build(seed):
        m = TL.ResNetBlock(4, 6, 2, weight_initializer=initializer,
                           use_batch_norm=True)
        return TL.init_parameters(m, torch.Generator().manual_seed(seed))
    a, b, c = build(0), build(0), build(1)
    w = a.conv1.conv.weight.detach()
    fan_in, fan_out = 4 * 9, 6 * 9
    bound = {'kaiming_uniform': 1.0 / np.sqrt(fan_in),
             'xavier_uniform': np.sqrt(6.0 / (fan_in + fan_out))}
    if initializer in bound:
        assert float(w.abs().max()) <= bound[initializer]
    assert torch.equal(w, b.conv1.conv.weight)
    assert not torch.equal(w, c.conv1.conv.weight)
    assert float(a.conv1.batch_norm.running_var.min()) == 1.0


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16, np.float32])
def test_transport_decode_matches_jax(dtype, rng):
    x = rng.integers(0, 255, (2, 5, 4)).astype(dtype)
    ref = np.asarray(jax_transport.decode(jnp.asarray(x)))
    np.testing.assert_array_equal(transport.decode(torch.from_numpy(x))
                                  .numpy(), ref)


@pytest.mark.parametrize('value_range', [(0, 1), (-1, 1), (0, 255)])
def test_transforms_normalize_matches_jax(value_range, rng):
    x = rng.integers(0, 256, (1, 6, 7, 3)).astype(np.float32)
    (ref,) = JaxTransforms(normalized_image_range=list(value_range)) \
        .transform(jax.random.PRNGKey(0), [jnp.asarray(x)],
                   random_transform_probability=0.0)
    out = Transforms(value_range).transform(torch.from_numpy(x))
    # a division by 255 in float32 on both sides
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-7,
                               atol=1e-7)


def test_default_device(monkeypatch):
    """cuda by default; the CPU only when asked; no card and no
    device='cpu' raises."""
    assert rcfd_tpu_torch.default_device('cpu') == torch.device('cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rcfd_tpu_torch.default_device()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert rcfd_tpu_torch.default_device() == torch.device('cuda')
