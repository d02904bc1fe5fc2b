"""The port's inference rewrites against the JAX package on the CPU: the
batch-norm fold (rcfd_tpu/nn/optimize.py), the integer branch of the
nearest resize, and the pipeline's ``optimize`` option, with the JAX
weights carried across by state_dict_from_jax."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from rcfd_tpu import pipeline as jax_pipeline  # noqa: E402
from rcfd_tpu.models.fusionnet import FusionNetModel as JaxFusionNet  # noqa
from rcfd_tpu.models.radarnet import RadarNetModel as JaxRadarNet  # noqa
from rcfd_tpu.nn import functional as JF  # noqa: E402
from rcfd_tpu.nn.optimize import fold_batch_norm as jax_fold  # noqa: E402
from rcfd_tpu.nn.perf import PerfConfig  # noqa: E402

from rcfd_tpu_torch import pipeline  # noqa: E402
from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel  # noqa: E402
from rcfd_tpu_torch.nn import (DecoderBlock, fold_batch_norm,  # noqa: E402
                               init_parameters)
from rcfd_tpu_torch.nn import functional as F  # noqa: E402
from rcfd_tpu_torch.nn.perf import PerfConfig as PortPerfConfig  # noqa: E402
from rcfd_tpu_torch.ops import fused_skip as fs  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

import test_torch_pipeline as tp  # noqa: E402
from torch_parity import (FUSIONNET_TINY, H, RADARNET_FUSED_JAX_PERF,  # noqa
                          RADARNET_TINY, W, frame_and_points, jax_variables,
                          nchw)

# tests/test_optimize.py's tolerance for the fold: float32 products of the
# folded weights round differently from batch norm after the conv
TOL = 1e-4
# the JAX package's own tolerance for the deferred pools
# (tests/test_fused_skip.py), which the fused configuration adds
FUSED_TOL = 5e-4

CONFIGS = {
    'slice': (None, None, TOL),
    'fused': (RADARNET_FUSED_JAX_PERF,
              PortPerfConfig(fused_pool2=True, fused_pool4=True), FUSED_TOL),
}


@pytest.fixture(scope='module')
def variables():
    """JAX RadarNet and FusionNet variables with batch norm drawn from a
    seed (so the fold is not the identity), drawn as
    tests/test_torch_pipeline.py draws them."""
    rng = np.random.default_rng(20)
    rv = jax_variables(JaxRadarNet(**RADARNET_TINY), 0, rng)
    fv = jax_variables(JaxFusionNet(**FUSIONNET_TINY), 1, rng)
    return rv, fv


def _port(cls, config, variables, **kw):
    model = cls(**config, device='cpu', **kw)
    model.load_state_dict(state_dict_from_jax(*variables), strict=True)
    return model


def _radarnet_inputs(rng, k=6):
    pad = RADARNET_TINY['input_patch_size_image'][1] // 2
    image = rng.random((1, H, W + 2 * pad, 3), dtype=np.float32)
    x = rng.integers(0, W, k).astype(np.float32)
    points = np.stack([x + pad, rng.integers(0, H, k),
                       rng.random(k) * 60 + 1], 1).astype(np.float32)
    return image, points, x[None]


def test_fold_radarnet_matches_jax(variables, rng):
    """The port's folded RadarNet against the JAX package's folded one, and
    against the port's unfolded RadarNet (the fused configuration is held
    in test_optimize_pipeline_matches_jax)."""
    rv = variables[0]
    port = _port(RadarNetModel, RADARNET_TINY, rv)
    image, points, x1 = _radarnet_inputs(rng)
    ref, _ = JaxRadarNet(**RADARNET_TINY).apply(
        *jax_fold(*rv), jnp.asarray(image), jnp.asarray(points),
        jnp.asarray(x1), box_height=H)
    args = (torch.from_numpy(image), torch.from_numpy(points),
            torch.from_numpy(x1))
    out = fold_batch_norm(port).apply(*args, box_height=H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out.numpy(),
                               port.apply(*args, box_height=H).numpy(),
                               rtol=TOL, atol=TOL)


def test_fold_fusionnet_matches_jax(variables, rng):
    fv = variables[1]
    jm = JaxFusionNet(**FUSIONNET_TINY)
    port = _port(FusionNetModel, FUSIONNET_TINY, fv)
    image = rng.random((1, H, W, 3), dtype=np.float32)
    depth = (rng.random((1, H, W, 2), dtype=np.float32) * 80).astype(
        np.float32)
    ref, _ = jm.apply(*jax_fold(*fv), jnp.asarray(image), jnp.asarray(depth))
    out = fold_batch_norm(port).apply(torch.from_numpy(image),
                                      torch.from_numpy(depth))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize('model', ['radarnet', 'fusionnet'])
def test_fold_equals_the_jax_folded_tree(variables, model):
    """The port's fold gives the state_dict of a JAX-folded tree carried
    across, key for key and bit for bit (the same float32 scale, product
    and difference), and keeps the caller's module as it was."""
    cls, config, var = {
        'radarnet': (RadarNetModel, RADARNET_TINY, variables[0]),
        'fusionnet': (FusionNetModel, FUSIONNET_TINY, variables[1])}[model]
    port = _port(cls, config, var)
    before = copy.deepcopy(port.state_dict())
    folded = fold_batch_norm(port).state_dict()
    ref = state_dict_from_jax(*jax_fold(*var))
    assert sorted(folded) == sorted(ref)
    assert any(k.endswith('.conv.bias') for k in folded)
    assert not any('batch_norm' in k for k in folded)
    for key, value in ref.items():
        assert torch.equal(folded[key], value), key
    after = port.state_dict()
    assert sorted(after) == sorted(before)
    assert any('batch_norm' in k for k in after)
    for key, value in before.items():
        assert torch.equal(after[key], value), key


@pytest.mark.parametrize('shape', [(14, 18), (21, 27), (7, 27), (15, 18)])
def test_resize_nearest_integer_branch_matches_the_gather(shape, rng):
    """The broadcast of the integer branch equals the index gather and the
    JAX package's resize, bit for bit (tests/test_optimize.py:40); a factor
    that is not an integer still gathers."""
    x = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    rows = (np.arange(shape[0]) * 7) // shape[0]
    cols = (np.arange(shape[1]) * 9) // shape[1]
    out = F.resize_nearest(nchw(x), shape)
    assert out.is_contiguous()
    ref = np.transpose(x[:, rows][:, :, cols], (0, 3, 1, 2))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        out.numpy(), np.transpose(np.asarray(
            JF.resize_nearest(jnp.asarray(x), shape)), (0, 3, 1, 2)))


def test_fused_decoder_block_adds_the_folded_bias(rng):
    """A folded DecoderBlock given a deferred skip (the fused skip
    gather-add) against the same block given the eager windows: the bias
    the fold put into the post-conv is added after the gather-add."""
    block = init_parameters(DecoderBlock(6, 4, 5, use_batch_norm=True),
                            torch.Generator().manual_seed(0)).eval()
    bn = block.conv.batch_norm
    with torch.no_grad():
        for p in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
            p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 5).astype(
                np.float32)))
    folded = fold_batch_norm(block)
    assert folded.conv.conv.bias is not None
    g = torch.from_numpy(rng.standard_normal((1, 4, 8, 30), dtype=np.float32))
    lazy = fs.LazyColumnWindows(g, torch.tensor([[0, 7, 20]],
                                                dtype=torch.int32), 10)
    x = torch.from_numpy(rng.standard_normal((3, 6, 4, 5), dtype=np.float32))
    with torch.no_grad():
        out = folded(x, skip=lazy)
        ref = folded(x, skip=lazy.materialize())
        unfolded = block(x, skip=lazy.materialize())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), unfolded.numpy(), atol=TOL,
                               rtol=TOL)


@pytest.fixture(scope='module')
def pipelines(variables):
    """(JAX, port) pipelines with optimize=True per configuration, and the
    JAX models and folded variables for the stage-by-stage reference."""
    rv, fv = variables
    jf = JaxFusionNet(**FUSIONNET_TINY)
    fn = _port(FusionNetModel, FUSIONNET_TINY, fv)
    out = {}
    for config, (jax_perf, port_perf, _) in CONFIGS.items():
        jr = JaxRadarNet(**RADARNET_TINY, perf=jax_perf and PerfConfig(
            **jax_perf))
        rn = _port(RadarNetModel, RADARNET_TINY, rv, perf=port_perf)
        ref = jax_pipeline.TwoStagePipeline(jr, jf, rv, fv, H, W,
                                            optimize=True)
        port = pipeline.TwoStagePipeline(rn, fn, H, W, optimize=True,
                                         device='cpu')
        out[config] = (ref, port, jr, jf, jax_fold(*rv), jax_fold(*fv))
    return out


@pytest.mark.parametrize('config', sorted(CONFIGS))
def test_optimize_pipeline_matches_jax(pipelines, config):
    """TwoStagePipeline(optimize=True) against the JAX package's, end to end
    with the rule of tests/test_torch_pipeline.py: the response within one
    2^-14 step, every quasi pixel that differs a same-step tie or at an
    edge of the folded crops, dense within 1e-3 m where none differ; and
    the port's crops against the JAX folded ones."""
    ref, port, jr, jf, rv, fv = pipelines[config]
    tol = CONFIGS[config][2]
    image, points, valid = frame_and_points(np.random.default_rng(21))
    crops_ref = tp._jax_stages(jr, jf, rv, fv, image, points, valid)[0]
    with torch.inference_mode():
        crops = port.radarnet_stage(image, points)[1]
    np.testing.assert_allclose(crops.numpy(), crops_ref, atol=tol, rtol=0)
    dense_ref, quasi_ref, response_ref = [np.asarray(a) for a in ref(
        jnp.asarray(image), jnp.asarray(points), jnp.asarray(valid))]
    dense, quasi, response = [a.numpy() for a in port(image, points, valid)]
    assert np.abs(response - response_ref).max() <= 1.0 / tp.Q
    differ = np.argwhere(quasi != quasi_ref)
    assert tp._explained(crops_ref, points, valid, differ).all()
    assert (response_ref > 0).sum() > 100
    if len(differ) == 0:
        np.testing.assert_allclose(dense, dense_ref, atol=1e-3, rtol=0)
