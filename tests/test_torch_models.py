"""RadarNet and FusionNet of rcfd_tpu_torch against the JAX package on the
CPU, with the JAX weights carried across by state_dict_from_jax: the JAX
package with PerfConfig(packed_tail=False) (the plain math) and at its CPU
defaults (the packed tail on)."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from rcfd_tpu.models import networks as jax_networks  # noqa: E402
from rcfd_tpu.models.fusionnet import FusionNetModel as JaxFusionNet  # noqa
from rcfd_tpu.models.radarnet import RadarNetModel as JaxRadarNet  # noqa
from rcfd_tpu.nn.perf import PerfConfig  # noqa: E402

from rcfd_tpu_torch.models import networks  # noqa: E402
from rcfd_tpu_torch.models.fusionnet import FusionNetModel  # noqa: E402
from rcfd_tpu_torch.models.radarnet import RadarNetModel  # noqa: E402
from rcfd_tpu_torch.nn.perf import PerfConfig as PortPerfConfig  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

from torch_parity import (FUSIONNET_TINY, H, RADARNET_FUSED_JAX_PERF,  # noqa
                          RADARNET_TINY, RADARNET_WIDE, RADARNET_WIDE_JAX_PERF,
                          W, jax_variables, nchw, nhwc)

# float32 networks of ~20 layers; sums in another order on each side
ATOL = 1e-4
PERFS = {'plain': PerfConfig(packed_tail=False), 'cpu_default': None}


@pytest.fixture(scope='module')
def radarnet():
    rng = np.random.default_rng(10)
    p, s = jax_variables(JaxRadarNet(**RADARNET_TINY), 0, rng)
    port = RadarNetModel(**RADARNET_TINY, device='cpu')
    port.load_state_dict(state_dict_from_jax(p, s), strict=True)
    return p, s, port


@pytest.fixture(scope='module')
def fusionnet():
    rng = np.random.default_rng(11)
    p, s = jax_variables(JaxFusionNet(**FUSIONNET_TINY), 1, rng)
    port = FusionNetModel(**FUSIONNET_TINY, device='cpu')
    port.load_state_dict(state_dict_from_jax(p, s), strict=True)
    return p, s, port


def _radarnet_inputs(rng, k=6, config=RADARNET_TINY):
    pad = config['input_patch_size_image'][1] // 2
    image = rng.random((1, H, W + 2 * pad, 3), dtype=np.float32)
    x = rng.integers(0, W, k).astype(np.float32)
    points = np.stack([x + pad, rng.integers(0, H, k),
                       rng.random(k) * 60 + 1], 1).astype(np.float32)
    return image, points, x[None]


@pytest.mark.parametrize('perf', sorted(PERFS))
@pytest.mark.parametrize('return_logits', [True, False])
def test_radarnet_apply_matches_jax(radarnet, perf, return_logits, rng):
    p, s, port = radarnet
    jm = JaxRadarNet(**RADARNET_TINY, perf=PERFS[perf])
    image, points, x1 = _radarnet_inputs(rng)
    ref, _ = jm.apply(p, s, jnp.asarray(image), jnp.asarray(points),
                      jnp.asarray(x1), box_height=H,
                      return_logits=return_logits)
    out = port.apply(torch.from_numpy(image), torch.from_numpy(points),
                     torch.from_numpy(x1), box_height=H,
                     return_logits=return_logits)
    assert out.shape == (6, 32, 32, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize('perf', sorted(PERFS))
def test_radarnet_deferred_skip_pools_match_jax(radarnet, perf, rng):
    """The port with the deferred 1/2- and 1/4-scale pools (fused skip
    gather-add, plain version on the CPU) against the JAX package's fused
    path under both baselines, within its own tolerance for the fusion
    (tests/test_fused_skip.py)."""
    p, s, port = radarnet
    fused = RadarNetModel(**RADARNET_TINY, device='cpu',
                          perf=PortPerfConfig(fused_pool2=True,
                                              fused_pool4=True))
    fused.load_state_dict(port.state_dict(), strict=True)
    base = PERFS[perf] or PerfConfig()
    jm = JaxRadarNet(**RADARNET_TINY, perf=base.replace(
        **RADARNET_FUSED_JAX_PERF))
    image, points, x1 = _radarnet_inputs(rng)
    ref, _ = jm.apply(p, s, jnp.asarray(image), jnp.asarray(points),
                      jnp.asarray(x1), box_height=H, return_logits=False)
    out = fused.apply(torch.from_numpy(image), torch.from_numpy(points),
                      torch.from_numpy(x1), box_height=H,
                      return_logits=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4,
                               rtol=0)


def test_radarnet_variable_bin_patch_matches_jax(rng):
    """A patch whose width is not a multiple of 32: the 1/16 and 1/32
    pools take the variable-bin branch (the crop's plain version here),
    against the JAX package's XLA branch."""
    p, s = jax_variables(JaxRadarNet(**RADARNET_WIDE), 3,
                         np.random.default_rng(12))
    port = RadarNetModel(**RADARNET_WIDE, device='cpu')
    port.load_state_dict(state_dict_from_jax(p, s), strict=True)
    jm = JaxRadarNet(**RADARNET_WIDE,
                     perf=PerfConfig(**RADARNET_WIDE_JAX_PERF))
    image, points, x1 = _radarnet_inputs(rng, config=RADARNET_WIDE)
    ref, _ = jm.apply(p, s, jnp.asarray(image), jnp.asarray(points),
                      jnp.asarray(x1), box_height=H)
    out = port.apply(torch.from_numpy(image), torch.from_numpy(points),
                     torch.from_numpy(x1), box_height=H)
    assert out.shape == (6,) + RADARNET_WIDE['input_patch_size_image'] + (1,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize('perf', sorted(PERFS))
def test_fusionnet_apply_matches_jax(fusionnet, perf, rng):
    p, s, port = fusionnet
    jm = JaxFusionNet(**FUSIONNET_TINY, perf=PERFS[perf])
    image = rng.random((1, H, W, 3), dtype=np.float32)
    depth = np.stack([rng.random((1, H, W)) * 60,
                      rng.random((1, H, W)) * 64], -1).astype(np.float32)
    ref, _ = jm.apply(p, s, jnp.asarray(image), jnp.asarray(depth))
    out = port.apply(torch.from_numpy(image), torch.from_numpy(depth))
    assert out.shape == (1, H, W, 1)
    assert float(out.min()) >= 1.0 and float(out.max()) <= 100.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize('fusion_type', ['add', 'weight', 'concat'])
def test_fusionnet_encoder_fusion_types_match_jax(fusion_type, rng):
    kw = dict(n_layer=18, input_channels_image=3, input_channels_depth=2,
              n_filters_encoder_image=[4, 8, 8, 8, 8],
              # 'weight' adds the weighted depth features to the image's
              n_filters_encoder_depth=([4, 8, 8, 8, 8] if fusion_type == 'weight'
                                       else [4, 4, 8, 8, 8]),
              use_batch_norm=True,
              fusion_type=fusion_type)
    jm = jax_networks.FusionNetEncoder(**kw, perf=PerfConfig())
    p, s = jax_variables(jm, 2, rng)
    port = networks.FusionNetEncoder(**kw)
    port.load_state_dict(state_dict_from_jax(p, s), strict=True)
    port.requires_grad_(False).eval()
    image = rng.random((1, 32, 40, 3), dtype=np.float32)
    depth = rng.random((1, 32, 40, 2), dtype=np.float32)
    ref_latent, ref_skips, _ = jm(p, s, jnp.asarray(image),
                                  jnp.asarray(depth))
    latent, skips = port(nchw(image), nchw(depth))
    for a, b in zip([latent] + skips, [ref_latent] + list(ref_skips)):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=ATOL,
                                   rtol=0)


def test_state_dict_keys_match_reference_layout(radarnet, fusionnet):
    """The port's parameter names are the keys the JAX package writes for
    the reference (tree_to_torch_state_dict), with the same shapes."""
    from rcfd_tpu.utils.checkpoint import tree_to_torch_state_dict
    for p, s, port in (radarnet, fusionnet):
        ref = tree_to_torch_state_dict(p, s)
        ours = port.state_dict()
        assert set(ours) == set(ref)
        for k, v in ref.items():
            assert tuple(ours[k].shape) == tuple(np.shape(v)), k


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        FusionNetModel(**dict(FUSIONNET_TINY, n_resolution_decoder=2),
                       device='cpu')
    with pytest.raises(NotImplementedError):
        FusionNetModel(**dict(FUSIONNET_TINY, deconv_type='transpose'),
                       device='cpu')


def test_models_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        RadarNetModel(**RADARNET_TINY)
    with pytest.raises(RuntimeError, match='CUDA'):
        FusionNetModel(**FUSIONNET_TINY)
