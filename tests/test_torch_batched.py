"""Batched serving of rcfd_tpu_torch on the CPU: TwoStagePipeline.
forward_batched against the port's own __call__ frame by frame and against
the JAX package's forward_batched (same weights, carried across by
state_dict_from_jax), RadarNet's chunked decode against its one-shot
decode, the decode-chunk policy against the JAX package's expression, and
the batched plain scatter against the per-frame one."""

import dataclasses

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
from rcfd_tpu.ops.scatter_pallas import scatter_quasi_dense_pallas  # noqa

from rcfd_tpu_torch import pipeline  # noqa: E402
from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel  # noqa: E402
from rcfd_tpu_torch.nn.perf import PerfConfig as PortPerfConfig  # noqa: E402
from rcfd_tpu_torch.ops import scatter_cuda as sc  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

from torch_parity import (FUSIONNET_TINY, H, RADARNET_FUSED_JAX_PERF,  # noqa
                          RADARNET_TINY, RADARNET_WIDE, RADARNET_WIDE_JAX_PERF,
                          SCATTER_CASES, W, frame_and_points, jax_variables,
                          scatter_case)

Q = 2.0 ** -14
B, K = 3, 8
# the tiny RadarNet configurations: (config, JAX perf, port perf)
CONFIGS = {
    'canonical': (RADARNET_TINY, {}, None),
    'fused': (RADARNET_TINY, RADARNET_FUSED_JAX_PERF,
              PortPerfConfig(fused_pool2=True, fused_pool4=True)),
    'wide': (RADARNET_WIDE, RADARNET_WIDE_JAX_PERF, None),
}


def _jax_radarnet(config):
    """The JAX RadarNet of ``config`` and its weights, drawn as
    tests/test_torch_pipeline.py draws them."""
    radarnet_kw, jax_perf, _ = CONFIGS[config]
    jr = JaxRadarNet(**radarnet_kw, perf=PerfConfig(**jax_perf))
    return jr, jax_variables(jr, 0, np.random.default_rng(20))


@pytest.fixture(scope='module')
def weights():
    """FusionNet's JAX weights, and RadarNet's for each configuration."""
    rng = np.random.default_rng(20)
    jax_variables(JaxRadarNet(**RADARNET_TINY), 0, rng)
    fv = jax_variables(JaxFusionNet(**FUSIONNET_TINY), 1, rng)
    return {config: _jax_radarnet(config) for config in CONFIGS}, fv


def _port(weights, config='canonical', **perf):
    radarnets, fv = weights
    radarnet_kw, _, port_perf = CONFIGS[config]
    if perf:
        port_perf = dataclasses.replace(port_perf or PortPerfConfig(),
                                        **perf)
    rn = RadarNetModel(**radarnet_kw, device='cpu', perf=port_perf)
    rn.load_state_dict(state_dict_from_jax(*radarnets[config][1]),
                       strict=True)
    fn = FusionNetModel(**FUSIONNET_TINY, device='cpu')
    fn.load_state_dict(state_dict_from_jax(*fv), strict=True)
    return pipeline.TwoStagePipeline(rn, fn, H, W, device='cpu')


@pytest.fixture(scope='module')
def port(weights):
    return _port(weights)


@pytest.fixture(scope='module')
def batch():
    """B frames of K points: frame 0 with 2 padding points and overlapping
    windows; frame 1 ragged (5 of its 8 points are padding); frame 2 with
    three valid points whose windows (32 or 40 wide) are disjoint, so that
    no two points compete."""
    rng = np.random.default_rng(30)
    frames = [frame_and_points(rng, k=K, n_invalid=5 if i == 1 else 2)
              for i in range(B)]
    images = np.concatenate([f[0] for f in frames])
    points = np.stack([f[1] for f in frames])
    valid = np.stack([f[2] for f in frames])
    points[2, :3, 0] = [8, 48, 88]
    valid[2] = False
    valid[2, :3] = True
    return images, points, valid


def _numpy(outs):
    return [o.numpy() for o in outs]


def test_forward_batched_matches_call_per_frame(port, batch):
    """Frame b of the batched path equals __call__ of frame b: quasi and
    response exactly, dense within 1e-5 m."""
    images, points, valid = batch
    dense_b, quasi_b, resp_b = _numpy(port.forward_batched(images, points,
                                                           valid))
    assert dense_b.shape == quasi_b.shape == resp_b.shape == (B, H, W)
    for i in range(B):
        dense, quasi, resp = _numpy(port(images[i:i + 1], points[i],
                                         valid[i]))
        np.testing.assert_array_equal(quasi_b[i], quasi)
        np.testing.assert_array_equal(resp_b[i], resp)
        np.testing.assert_allclose(dense_b[i], dense, rtol=0, atol=1e-5)
        assert (resp > 0).sum() > 100


def test_forward_batched_codec_encode(port, batch):
    """codec_encode applies to the batched outputs as to __call__'s."""
    enc = pipeline.TwoStagePipeline(port.radarnet, port.fusionnet, H, W,
                                    codec_encode=True, device='cpu')
    floats = _numpy(port.forward_batched(*batch))
    codes = enc.forward_batched(*batch)
    for f, c, m in zip(floats, codes, (256.0, 256.0, 2.0 ** 14)):
        assert c.dtype == torch.uint16 and tuple(c.shape) == (B, H, W)
        np.testing.assert_array_equal(
            c.numpy().astype(np.int64),
            np.floor(f.astype(np.float64) * m).astype(np.int64))


def _jax_crops(jr, rv, images, points):
    """rcfd_tpu/pipeline.py:224-293, the batched RadarNet stage of the JAX
    package: (B, K, ph, pw) crops."""
    pad = jr.input_patch_size_image[1] // 2
    (image_t,) = JaxTransforms(normalized_image_range=[0, 1]).transform(
        jax.random.PRNGKey(0), [jax_transport.decode(jnp.asarray(images))],
        random_transform_probability=0.0)
    image_pad = jnp.pad(image_t, ((0, 0), (0, 0), (pad, pad), (0, 0)),
                        mode='edge')
    points = jnp.asarray(points)
    x_shifted = points[..., 0] + pad
    responses, _ = jr.apply(*rv, image_pad,
                            points.at[..., 0].set(x_shifted).reshape(-1, 3),
                            x_shifted - pad, box_height=H, training=False,
                            return_logits=False)
    return np.asarray(responses[..., 0]).reshape(
        points.shape[0], points.shape[1], *responses.shape[1:3])


def _unexplained(crops, points, valid, pixels, tol=1e-5):
    """The pixels (frame, row, col) of ``pixels`` where neither a tie inside
    one 2^-14 step nor a top response within ``tol`` of the 0.5 threshold
    or of a step edge explains a different winner between the kernel's
    rule (first index wins inside a step) and the XLA scatter's exact float
    max."""
    _, _, ph, pw = crops.shape
    pad = pw // 2
    bad = []
    for f, r, c in pixels:
        cols = c - (points[f, :, 0].astype(int) + pad - 2 * pad)
        hit = valid[f] & (cols >= 0) & (cols < pw)
        vals = np.sort(crops[f, hit, r - (H - ph), cols[hit]].astype(
            np.float64))[::-1]
        top = vals[0]
        tie = len(vals) > 1 and top >= 0.5 and \
            np.floor(vals[1] / Q) == np.floor(top / Q)
        edge = abs(top - 0.5) < tol or abs(top / Q - np.round(top / Q)) < \
            tol / Q
        if not (tie or edge):
            bad.append((int(f), int(r), int(c)))
    return bad


@pytest.mark.parametrize('config', sorted(CONFIGS))
def test_forward_batched_matches_jax(weights, batch, config):
    """The port's forward_batched against rcfd_tpu.pipeline.
    TwoStagePipeline.forward_batched (XLA scatter, exact float max) on the
    same weights and frames: the response within one 2^-14 step
    everywhere; the quasi depth differs only where the kernel's rule and
    the float max pick different points (a same-step tie or a response
    within 1e-5 of an edge, ROADMAP.md section 3); in each frame where no
    quasi pixel differs, frame 2 among them, dense within 1e-3 m
    (test_slice_end_to_end's rule)."""
    radarnets, fv = weights
    jr, rv = radarnets[config]
    ref = jax_pipeline.TwoStagePipeline(
        jr, JaxFusionNet(**FUSIONNET_TINY), rv, fv, H, W)
    images, points, valid = batch
    dense_ref, quasi_ref, resp_ref = [np.asarray(a) for a in
                                      ref.forward_batched(
                                          jnp.asarray(images),
                                          jnp.asarray(points),
                                          jnp.asarray(valid))]
    dense, quasi, resp = _numpy(_port(weights, config).forward_batched(
        images, points, valid))
    assert dense.shape == quasi.shape == resp.shape == (B, H, W)
    assert np.abs(resp - resp_ref).max() <= Q
    differ = np.argwhere(quasi != quasi_ref)
    crops = _jax_crops(jr, rv, images, points)
    assert not _unexplained(crops, points, valid, differ)
    print('{}: quasi depth differs from the JAX batched path at {} of {} '
          'pixels, each a same-step tie or at an edge'.format(
              config, len(differ), quasi.size))
    checked = [f for f in range(B) if not (differ[:, 0] == f).any()]
    for f in checked:
        np.testing.assert_allclose(dense[f], dense_ref[f], rtol=0,
                                   atol=1e-3)
    # the frame whose windows are disjoint has no competing points
    assert 2 in checked
    assert (resp_ref > 0).sum() > 300


@pytest.mark.parametrize('n_chunks', [1, 2, 4])
def test_apply_chunked_matches_apply(port, n_chunks):
    """RadarNet's chunked decode against its one-shot decode (the JAX
    package's test_apply_chunked_matches_apply), NHWC, within 1e-6."""
    rng = np.random.default_rng(31)
    b, k = 2, 4
    pad = RADARNET_TINY['input_patch_size_image'][1] // 2
    image = torch.from_numpy(rng.random((b, H, W + 2 * pad, 3),
                                        dtype=np.float32))
    points = torch.from_numpy(np.stack([
        rng.integers(pad, W + pad, (b, k)).astype(np.float32),
        rng.integers(0, H, (b, k)).astype(np.float32),
        rng.random((b, k), dtype=np.float32) * 60 + 1], -1))
    x1 = points[..., 0] - pad
    rn = port.radarnet
    with torch.inference_mode():
        ref = rn.apply(image, points.reshape(b * k, 3), x1, box_height=H)
        out = rn.apply_chunked(image, points, x1, n_chunks=n_chunks,
                               box_height=H)
    assert tuple(out.shape) == (b, k) + tuple(ref.shape[1:])
    np.testing.assert_allclose(out.numpy(),
                               ref.reshape(out.shape).numpy(), rtol=1e-6,
                               atol=1e-6)


def test_apply_chunked_refuses_chunks_that_do_not_divide_k(port):
    image = torch.zeros((1, H, W + 32, 3))
    points = torch.zeros((1, 6, 3))
    with pytest.raises(ValueError, match='divide'):
        port.radarnet.apply_chunked(image, points, points[..., 0], 4)


def test_chunked_pipeline_matches_unchunked(weights, port, batch):
    """PerfConfig(decode_chunks=2) runs RadarNet's decode in two chunks:
    the same maps as one chunk, dense within 1e-5 m."""
    chunked = _port(weights, decode_chunks=2)
    assert pipeline.decode_chunk_count(
        B, K, chunked.radarnet.perf.decode_chunks) == 2
    out = _numpy(chunked.forward_batched(*batch))
    ref = _numpy(port.forward_batched(*batch))
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_array_equal(out[2], ref[2])
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-5)


def _jax_decode_chunks(b, k, decode_chunks):
    """rcfd_tpu/pipeline.py:263-268, verbatim."""
    if decode_chunks is not None:
        n_chunks = max(1, decode_chunks)
    else:
        n_chunks = max(1, (b * k) // 512)
    while n_chunks > 1 and k % n_chunks != 0:
        n_chunks -= 1
    return n_chunks


@pytest.mark.parametrize('b,k,decode_chunks', [
    (1, 64, None), (8, 64, None), (9, 64, None), (16, 64, None),
    (24, 64, None), (40, 64, None), (32, 64, None), (16, 60, None),
    (100, 7, None), (1, 1, None), (8, 64, 2), (8, 64, 0), (8, 64, -3),
    (8, 64, 3), (2, 7, 4), (4, 12, 5), (16, 64, 1)])
def test_decode_chunk_count_matches_jax(b, k, decode_chunks):
    assert pipeline.decode_chunk_count(b, k, decode_chunks) == \
        _jax_decode_chunks(b, k, decode_chunks)


@pytest.mark.parametrize('name', SCATTER_CASES)
def test_batched_plain_scatter_matches_per_frame(name):
    """The batched plain scatter (one scatter_reduce_ over all frames)
    against the single-frame plain version and the TPU kernel's interpret
    mode, frame by frame, bit for bit; frame 2 has no valid point."""
    rng = np.random.default_rng(32)
    frames = [scatter_case(name, rng) for _ in range(3)]
    h, w, patch = frames[0][4:]
    crops, x, z, valid = [np.stack([f[i] for f in frames])
                          for i in range(4)]
    valid[2] = False
    t = torch.from_numpy
    before = sc.scatter_quasi_dense.launches
    d_b, r_b = sc.scatter_quasi_dense_batched(t(crops), t(x), t(z),
                                              t(valid), h, w, patch)
    assert sc.scatter_quasi_dense.launches == before
    assert tuple(d_b.shape) == tuple(r_b.shape) == (3, h, w)
    for f in range(3):
        d, r = sc.scatter_quasi_dense_plain(t(crops[f]), t(x[f]), t(z[f]),
                                            t(valid[f]), h, w, patch)
        assert torch.equal(d_b[f], d) and torch.equal(r_b[f], r)
        d_ref, r_ref = scatter_quasi_dense_pallas(
            jnp.asarray(crops[f]), jnp.asarray(x[f]), jnp.asarray(z[f]),
            jnp.asarray(valid[f]), h, w, patch, interpret=True)
        np.testing.assert_array_equal(d_b[f].numpy(), np.asarray(d_ref))
        np.testing.assert_array_equal(r_b[f].numpy(), np.asarray(r_ref))
    assert bool((r_b[:2] > 0).any()) and not bool((r_b[2] > 0).any())


def test_batched_scatter_wrapper_checks_shapes():
    rng = np.random.default_rng(33)
    crops, x, z, valid, h, w, patch = scatter_case('random', rng)
    t = torch.from_numpy
    with pytest.raises(ValueError, match='B, K, ph, pw'):
        sc.scatter_quasi_dense_batched(t(crops), t(x), t(z), t(valid), h, w,
                                       patch)
    with pytest.raises(ValueError, match='patch_size'):
        sc.scatter_quasi_dense_batched(t(crops)[None], t(x)[None],
                                       t(z)[None], t(valid)[None], h, w,
                                       (patch[0], patch[1] + 2))
