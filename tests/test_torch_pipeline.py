"""The two-stage serving slice of rcfd_tpu_torch against the JAX package on
the CPU, stage by stage and end to end, with the JAX weights carried
across by state_dict_from_jax."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rcfd_tpu import pipeline as jax_pipeline  # noqa: E402
from rcfd_tpu.data import transport as jax_transport  # noqa: E402
from rcfd_tpu.data.transforms import Transforms as JaxTransforms  # noqa: E402
from rcfd_tpu.models.fusionnet import FusionNetModel as JaxFusionNet  # noqa
from rcfd_tpu.models.radarnet import RadarNetModel as JaxRadarNet  # noqa
from rcfd_tpu.nn.perf import PerfConfig  # noqa: E402
from rcfd_tpu.ops.scatter import scatter_quasi_dense as xla_scatter  # noqa
from rcfd_tpu.ops.scatter_pallas import scatter_quasi_dense_pallas  # noqa

from rcfd_tpu_torch import pipeline  # noqa: E402
from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel  # noqa: E402
from rcfd_tpu_torch.nn.perf import PerfConfig as PortPerfConfig  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

from torch_parity import (FUSIONNET_TINY, H, RADARNET_FUSED_JAX_PERF,  # noqa
                          RADARNET_TINY, RADARNET_WIDE, RADARNET_WIDE_JAX_PERF,
                          W, frame_and_points, jax_variables)

Q = 2.0 ** 14
PATCH = RADARNET_TINY['input_patch_size_image']


@pytest.fixture(scope='module')
def models():
    rng = np.random.default_rng(20)
    jr, jf = JaxRadarNet(**RADARNET_TINY), JaxFusionNet(**FUSIONNET_TINY)
    rv = jax_variables(jr, 0, rng)
    fv = jax_variables(jf, 1, rng)
    rn = RadarNetModel(**RADARNET_TINY, device='cpu')
    rn.load_state_dict(state_dict_from_jax(*rv), strict=True)
    fn = FusionNetModel(**FUSIONNET_TINY, device='cpu')
    fn.load_state_dict(state_dict_from_jax(*fv), strict=True)
    port = pipeline.TwoStagePipeline(rn, fn, H, W, device='cpu')
    ref = jax_pipeline.TwoStagePipeline(jr, jf, rv, fv, H, W)
    return jr, jf, rv, fv, port, ref


def _jax_stages(jr, jf, rv, fv, image, points, valid, pallas=False):
    """rcfd_tpu/pipeline.py:121-196, step by step, with the default XLA
    scatter (or, with ``pallas``, the Pallas scatter kernel in interpret
    mode): returns (crops, dense, quasi, response)."""
    patch = jr.input_patch_size_image
    pad = patch[1] // 2
    (image_t,) = JaxTransforms(normalized_image_range=[0, 1]).transform(
        jax.random.PRNGKey(0), [jax_transport.decode(jnp.asarray(image))],
        random_transform_probability=0.0)
    image_pad = jnp.pad(image_t, ((0, 0), (0, 0), (pad, pad), (0, 0)),
                        mode='edge')
    points = jnp.asarray(points)
    x_shifted = points[:, 0] + pad
    responses, _ = jr.apply(*rv, image_pad, points.at[:, 0].set(x_shifted),
                            (x_shifted - pad)[None, :], box_height=H,
                            training=False, return_logits=False)
    crops = responses[..., 0]
    if pallas:
        depth, response = scatter_quasi_dense_pallas(
            crops, x_shifted, points[:, 2], jnp.asarray(valid), H, W, patch,
            interpret=True)
    else:
        depth, response = xla_scatter(crops, x_shifted, points[:, 2],
                                      jnp.asarray(valid), H, W, patch)
    depth = jnp.floor(depth * 256.0) / 256.0
    response = jnp.floor(response * Q) / Q
    input_depth = jnp.stack(
        [depth, response * jax_pipeline.RESPONSE_DECODE_SCALE], -1)[None]
    dense, _ = jf.apply(*fv, image_t, input_depth, training=False)
    return [np.array(a) for a in (crops, dense[0, :, :, 0], depth,
                                    response)]


@pytest.fixture(scope='module')
def request_overlapping():
    """Eight points (two of them padding) whose 32-wide windows overlap."""
    return frame_and_points(np.random.default_rng(21))


@pytest.fixture(scope='module')
def request_separate():
    """Three valid points with disjoint windows: no two points compete."""
    image, points, valid = frame_and_points(np.random.default_rng(22))
    points[:3, 0] = [10, 50, 85]
    valid[:] = False
    valid[:3] = True
    return image, points, valid


def _port_downstream_of_jax_crops(port, crops, image, points, valid):
    """The JAX crops through the port's scatter, bridge and FusionNet:
    (quasi, response, dense)."""
    patch = port.radarnet.input_patch_size_image
    pad = patch[1] // 2
    with torch.inference_mode():
        maps = port.scatter(torch.from_numpy(crops),
                            torch.from_numpy(points[:, 0] + pad),
                            torch.from_numpy(points[:, 2].copy()),
                            torch.from_numpy(valid), H, W, patch)
        quasi, response, input_depth = port.bridge(*maps)
        image_t = port.transforms.transform(
            torch.from_numpy(image).float()).permute(0, 3, 1, 2)
        dense = port.fusionnet(image_t, input_depth)[0, 0]
    return quasi.numpy(), response.numpy(), dense.numpy()


def test_slice_stage_by_stage(models, request_overlapping):
    """The JAX crops through the port's scatter, bridge and FusionNet
    against the JAX composition: at the default the exact scatter against
    the XLA scatter, and with pallas_scatter=True the scatter kernel's
    plain version against the interpret-mode Pallas kernel; quasi and
    response exact, dense within 1e-4 m (float32 sums in another order)."""
    jr, jf, rv, fv, port, _ = models
    image, points, valid = request_overlapping
    k1 = _with_k1(port)
    for pipe, pallas in ((port, False), (k1, True)):
        crops, dense_ref, quasi_ref, response_ref = _jax_stages(
            jr, jf, rv, fv, image, points, valid, pallas=pallas)
        quasi, response, dense = _port_downstream_of_jax_crops(
            pipe, crops, image, points, valid)
        np.testing.assert_array_equal(quasi, quasi_ref)
        np.testing.assert_array_equal(response, response_ref)
        np.testing.assert_allclose(dense, dense_ref, atol=1e-4, rtol=0)
        assert (response_ref > 0).sum() > 100


def _with_k1(port):
    """The port's pipeline on the same weights with RadarNet's
    PerfConfig(pallas_scatter=True): the scatter kernel's route."""
    rn = RadarNetModel(**RADARNET_TINY, device='cpu',
                       perf=PortPerfConfig(pallas_scatter=True))
    rn.load_state_dict(port.radarnet.state_dict(), strict=True)
    pipe = pipeline.TwoStagePipeline(rn, port.fusionnet, H, W, device='cpu')
    assert pipe.pallas_scatter and not port.pallas_scatter
    return pipe


def test_pipeline_routes_the_scatter_by_pallas_scatter(models,
                                                       request_overlapping):
    """pallas_scatter None (the default) or False serves the exact scatter,
    True the scatter kernel's route, as rcfd_tpu/pipeline.py:161-175; the
    maps of each equal the route's own function on the same crops."""
    from rcfd_tpu_torch.ops import scatter as exact_scatter
    from rcfd_tpu_torch.ops import scatter_cuda

    _, _, _, _, port, _ = models
    assert port.scatter is exact_scatter.scatter_quasi_dense
    assert port.scatter_batched is exact_scatter.scatter_quasi_dense_batched
    k1 = _with_k1(port)
    assert k1.scatter is scatter_cuda.scatter_quasi_dense
    assert k1.scatter_batched is scatter_cuda.scatter_quasi_dense_batched
    image, points, valid = request_overlapping
    pad = PATCH[1] // 2
    with torch.inference_mode():
        crops = port.radarnet_stage(image, points)[1]
    args = (crops, torch.from_numpy(points[:, 0] + pad),
            torch.from_numpy(points[:, 2].copy()), torch.from_numpy(valid),
            H, W, PATCH)
    for pipe, fn in ((port, exact_scatter.scatter_quasi_dense),
                     (k1, scatter_cuda.scatter_quasi_dense)):
        _, quasi, response = pipe(image, points, valid)
        depth_map, response_map = pipeline.quantize_bridge(*fn(*args))
        assert torch.equal(quasi, depth_map)
        assert torch.equal(response, response_map)


# RadarNet configurations beside the canonical one: (config, JAX perf, port
# perf, crop tolerance). The deferred pools are held within the JAX
# package's own tolerance for that fusion (tests/test_fused_skip.py), the
# variable-bin patch within tests/test_torch_models.py's ATOL.
RADARNET_CONFIGS = {
    'deferred_pools': (RADARNET_TINY, RADARNET_FUSED_JAX_PERF,
                       PortPerfConfig(fused_pool2=True, fused_pool4=True),
                       5e-4),
    'variable_bin_patch': (RADARNET_WIDE, RADARNET_WIDE_JAX_PERF, None, 1e-4),
}


@pytest.mark.parametrize('config', sorted(RADARNET_CONFIGS))
def test_slice_stage_by_stage_radarnet_configs(models, config,
                                               request_overlapping):
    """The slice with RadarNet's deferred skip pools, or at a patch width
    that takes the variable-bin pool: the port's crops against the JAX
    package's with the same perf, then, from the JAX crops on, the maps and
    dense depth as in test_slice_stage_by_stage."""
    _, jf, _, fv, base, _ = models
    radarnet_kw, jax_perf, port_perf, crop_tol = RADARNET_CONFIGS[config]
    jr = JaxRadarNet(**radarnet_kw, perf=PerfConfig(**jax_perf))
    # the weights are drawn as the models fixture draws its RadarNet's
    rv = jax_variables(jr, 0, np.random.default_rng(20))
    rn = RadarNetModel(**radarnet_kw, device='cpu', perf=port_perf)
    rn.load_state_dict(state_dict_from_jax(*rv), strict=True)
    port = pipeline.TwoStagePipeline(rn, base.fusionnet, H, W, device='cpu')
    image, points, valid = request_overlapping
    crops_ref, dense_ref, quasi_ref, response_ref = _jax_stages(
        jr, jf, rv, fv, image, points, valid)
    with torch.inference_mode():
        crops = port.radarnet_stage(image, points)[1]
    np.testing.assert_allclose(crops.numpy(), crops_ref, atol=crop_tol,
                               rtol=0)
    quasi, response, dense = _port_downstream_of_jax_crops(
        port, crops_ref, image, points, valid)
    np.testing.assert_array_equal(quasi, quasi_ref)
    np.testing.assert_array_equal(response, response_ref)
    np.testing.assert_allclose(dense, dense_ref, atol=1e-4, rtol=0)
    assert (response_ref > 0).sum() > 100


@pytest.mark.parametrize('case', ['overlapping', 'separate'])
def test_slice_end_to_end(models, case, request):
    """The port's slice at the default against
    rcfd_tpu.pipeline.TwoStagePipeline at its default (both the exact float
    max): quasi depth and response bit for bit, dense within 1e-3 m."""
    _, _, _, _, port, ref = models
    image, points, valid = request.getfixturevalue('request_' + case)
    dense_ref, quasi_ref, response_ref = [np.asarray(a) for a in ref(
        jnp.asarray(image), jnp.asarray(points), jnp.asarray(valid))]
    dense, quasi, response = [a.numpy() for a in port(image, points, valid)]
    assert dense.shape == quasi.shape == response.shape == (H, W)
    np.testing.assert_array_equal(response, response_ref)
    np.testing.assert_array_equal(quasi, quasi_ref)
    np.testing.assert_allclose(dense, dense_ref, atol=1e-3, rtol=0)
    assert (response_ref > 0).sum() > 100


def _explained(crops, points, valid, pixels):
    """For each (row, col): does a tie inside one 2^-14 step, or a top
    response within 1e-5 of the 0.5 threshold or of a step edge, explain a
    different winner between the kernel's rule and the XLA scatter's?"""
    ph, pw = PATCH
    pad = pw // 2
    out = []
    for r, c in pixels:
        vals = []
        for p in np.flatnonzero(valid):
            j = c - (int(points[p, 0] + pad) - 2 * pad)
            if 0 <= j < pw:
                vals.append(crops[p, r - (H - ph), j])
        vals = np.sort(np.asarray(vals, np.float64))[::-1]
        top = vals[0]
        tie = len(vals) > 1 and np.floor(vals[1] * Q) == np.floor(top * Q) \
            and top >= 0.5
        edge = abs(top - 0.5) < 1e-5 or \
            abs(top * Q - np.round(top * Q)) < 1e-5 * Q
        out.append(tie or edge)
    return np.asarray(out)


@pytest.mark.parametrize('case', ['overlapping', 'separate'])
def test_slice_end_to_end_pallas_scatter(models, case, request):
    """The port's slice with pallas_scatter=True (the scatter kernel)
    against rcfd_tpu.pipeline.TwoStagePipeline's default (XLA scatter,
    exact float max). The response agrees within one 2^-14 step
    everywhere. The quasi depth differs only where the kernel's rule (first
    index wins inside one 2^-14 step) and the float max pick different
    points: every such pixel must be a same-step tie or sit within 1e-5 of
    the threshold or a step edge. Where none differ, dense within 1e-3 m."""
    jr, jf, rv, fv, port, ref = models
    port = _with_k1(port)
    image, points, valid = request.getfixturevalue('request_' + case)
    dense_ref, quasi_ref, response_ref = [np.asarray(a) for a in ref(
        jnp.asarray(image), jnp.asarray(points), jnp.asarray(valid))]
    dense, quasi, response = [a.numpy() for a in port(image, points, valid)]
    assert dense.shape == quasi.shape == response.shape == (H, W)
    assert np.abs(response - response_ref).max() <= 1.0 / Q
    differ = np.argwhere(quasi != quasi_ref)
    crops = _jax_stages(jr, jf, rv, fv, image, points, valid)[0]
    assert _explained(crops, points, valid, differ).all()
    print('{}: quasi depth differs from the XLA scatter at {} of {} pixels, '
          'each a same-step tie or at an edge'.format(case, len(differ),
                                                      quasi.size))
    if case == 'separate':
        assert len(differ) <= 0.001 * quasi.size
    if len(differ) == 0:
        np.testing.assert_allclose(dense, dense_ref, atol=1e-3, rtol=0)


def test_codec_encode_matches_jax(rng):
    dense = (rng.random((5, 7)) * 99 + 1).astype(np.float32)
    quasi = np.floor(rng.random((5, 7)) * 80).astype(np.float32)
    resp = rng.random((5, 7)).astype(np.float32)
    ref = jax_pipeline._codec_encode_outputs(
        jnp.asarray(dense), jnp.asarray(quasi), jnp.asarray(resp))
    out = pipeline.codec_encode(torch.from_numpy(dense),
                                torch.from_numpy(quasi),
                                torch.from_numpy(resp))
    for a, b in zip(out, ref):
        assert a.dtype == torch.uint16
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      np.asarray(b).astype(np.int64))


def test_pipeline_codec_encode_option(models, request_overlapping):
    _, _, _, _, port, _ = models
    enc = pipeline.TwoStagePipeline(port.radarnet, port.fusionnet, H, W,
                                    codec_encode=True, device='cpu')
    floats = port(*request_overlapping)
    codes = enc(*request_overlapping)
    for f, c, m in zip(floats, codes, (256.0, 256.0, Q)):
        np.testing.assert_array_equal(
            c.numpy().astype(np.int64),
            np.floor(f.numpy().astype(np.float64) * m).astype(np.int64))


def test_bridge_constants_match_jax():
    assert pipeline.RESPONSE_DECODE_SCALE == \
        jax_pipeline.RESPONSE_DECODE_SCALE == 64.0
    d = torch.tensor([1.00390625 + 1e-4, 7.3])
    r = torch.tensor([0.5 + 2.0 ** -15, 0.99])
    qd, qr = pipeline.quantize_bridge(d, r)
    np.testing.assert_array_equal(
        qd.numpy(), np.floor(d.numpy() * 256.0) / 256.0)
    np.testing.assert_array_equal(qr.numpy(),
                                  np.floor(r.numpy() * Q) / Q)


def test_pipeline_needs_a_card_unless_asked_for_cpu(models, monkeypatch):
    _, _, _, _, port, _ = models
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.TwoStagePipeline(port.radarnet, port.fusionnet, H, W)


def _numerics():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
            matmul.allow_tf32)


@pytest.mark.parametrize('outside', [(False, False, True, True),
                                     (True, True, False, False)])
def test_pipeline_serves_in_float32_and_restores_the_flags(
        models, request_overlapping, outside):
    """A request runs with TF32 off and cuDNN autotuning among
    deterministic algorithms, whatever the caller had set; the caller's
    settings are back afterwards."""
    _, _, _, _, port, _ = models
    seen = []
    stage = port.radarnet_stage

    def watched(*args):
        seen.append(_numerics())
        return stage(*args)

    saved = _numerics()
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    try:
        (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
         matmul.allow_tf32) = outside
        port.radarnet_stage = watched
        port(*request_overlapping)
        assert seen == [(True, True, False, False)]
        assert _numerics() == outside
    finally:
        del port.radarnet_stage
        (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
         matmul.allow_tf32) = saved
