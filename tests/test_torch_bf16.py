"""bf16 serving of rcfd_tpu_torch (``TwoStagePipeline(compute_dtype=
torch.bfloat16)``) against the JAX package's ``compute_dtype=jnp.bfloat16``
on the CPU, with the same numpy inputs and the JAX weights carried across by
state_dict_from_jax: the layers' dtype rules, the plain versions of the
three serving kernels with bf16 inputs, and the pipeline stage by stage and
end to end. The Pallas kernels run in interpret mode, as the JAX package's
own tests run them.

torch and XLA round bf16 convolutions at other places, so the networks
agree within bf16 tolerances; the kernels and the scatter's key math are
held bit for bit. The dense-depth bounds are the JAX package's own for bf16
serving (tests/test_bf16_serving.py)."""

import copy

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
from rcfd_tpu.nn import functional as JF  # noqa: E402
from rcfd_tpu.nn import layers as JL  # noqa: E402
from rcfd_tpu.nn.core import cast_tree  # noqa: E402
from rcfd_tpu.nn.optimize import fold_batch_norm as jax_fold  # noqa: E402
from rcfd_tpu.nn.perf import PerfConfig  # noqa: E402
from rcfd_tpu.ops import crop_pallas as jax_crop  # noqa: E402
from rcfd_tpu.ops import fused_skip as jax_fs  # noqa: E402
from rcfd_tpu.ops.scatter_pallas import scatter_quasi_dense_pallas  # noqa

from rcfd_tpu_torch import pipeline  # noqa: E402
from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel  # noqa: E402
from rcfd_tpu_torch.nn import functional as TF  # noqa: E402
from rcfd_tpu_torch.nn import layers as TL  # noqa: E402
from rcfd_tpu_torch.nn.perf import PerfConfig as PortPerfConfig  # noqa: E402
from rcfd_tpu_torch.ops import crop_cuda as cc  # noqa: E402
from rcfd_tpu_torch.ops import fused_skip as fs  # noqa: E402
from rcfd_tpu_torch.ops import roi_pool  # noqa: E402
from rcfd_tpu_torch.ops import scatter_cuda as sc  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

import test_torch_fused_skip as tfs  # noqa: E402
import test_torch_roi_pool as trp  # noqa: E402
from torch_parity import (FUSIONNET_TINY, H, RADARNET_FUSED_JAX_PERF,  # noqa
                          RADARNET_TINY, RADARNET_WIDE, RADARNET_WIDE_JAX_PERF,
                          SCATTER_CASES, W, frame_and_points, jax_variables,
                          nchw, nhwc, scatter_case)

BF16 = jnp.bfloat16
# the JAX package's bounds for bf16 serving (tests/test_bf16_serving.py)
DENSE_MAE = 0.25
DENSE_P99_REL = 0.02
# RadarNet's bf16 crops, port against JAX: torch and XLA round the bf16
# convolutions at other places; measured at most 2^-8, one bf16 step in
# [0.5, 1), where the tiny models' responses lie. Two steps allowed.
CROP_TOL = 2.0 ** -7
# bf16 layer outputs, port against JAX: measured at most 2^-9 (one bf16
# step of a value in [0.25, 0.5)); one step of a value in [1, 2) allowed
LAYER_TOL = 2.0 ** -7
# the RadarNet configurations of the serving paths: (config, JAX perf, port
# perf), as in tests/test_torch_batched.py
CONFIGS = {
    'canonical': (RADARNET_TINY, {}, None),
    'fused': (RADARNET_TINY, RADARNET_FUSED_JAX_PERF,
              PortPerfConfig(fused_pool2=True, fused_pool4=True)),
    'wide': (RADARNET_WIDE, RADARNET_WIDE_JAX_PERF, None),
}


def _bf16(a):
    """A numpy or JAX array as a torch bf16 tensor, through float32 (exact
    for bf16 values)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(t):
    return t.float().numpy()


def _no_launch(*wrappers):
    return [(w.launches, w.launches_bf16) for w in wrappers]


def _close(out, ref, label):
    """A bf16 NCHW layer output against the JAX package's NHWC one, within
    LAYER_TOL (absolute and relative); prints the largest difference."""
    out, ref = nhwc(out.float()), np.asarray(ref, np.float32)
    print('{}: max abs diff {:.3g}'.format(label, np.abs(out - ref).max()))
    np.testing.assert_allclose(out, ref, atol=LAYER_TOL, rtol=LAYER_TOL)


# ---------------------------------------------------------------------------
# (a) layers
# ---------------------------------------------------------------------------

def test_batch_norm_bf16_scale_and_shift_equal_jax(rng):
    """bf16 statistics: scale and shift computed in float32 and rounded to
    bf16 equal the JAX package's bit for bit; the layer's output agrees
    within LAYER_TOL."""
    p, s = jax_variables(JL.Conv2d(7, 7, 1, use_batch_norm=True), 0, rng)
    p, s = cast_tree(p['batch_norm'], BF16), cast_tree(s['batch_norm'], BF16)
    stats = [p['weight'], p['bias'], s['running_mean'], s['running_var']]
    zeros = jnp.zeros_like(p['bias'])
    ones = jnp.ones((1, 1, 1, 7), BF16)
    # x = 1 with bias and mean 0 gives scale; x = 0 gives shift, exactly
    ref_scale = JF.batch_norm_apply(ones, stats[0], zeros, zeros, stats[3])
    ref_shift = JF.batch_norm_apply(0 * ones, *stats)
    t_stats = [_bf16(a) for a in stats]
    t_zeros = torch.zeros(7, dtype=torch.bfloat16)
    t_ones = torch.ones((1, 7, 1, 1), dtype=torch.bfloat16)
    scale = TF.batch_norm_apply(t_ones, t_stats[0], t_zeros, t_zeros,
                                t_stats[3])
    shift = TF.batch_norm_apply(0 * t_ones, *t_stats)
    assert scale.dtype == shift.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(scale).ravel(),
                                  np.asarray(ref_scale, np.float32).ravel())
    np.testing.assert_array_equal(_f32(shift).ravel(),
                                  np.asarray(ref_shift, np.float32).ravel())
    x = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    ref = JF.batch_norm_apply(jnp.asarray(x).astype(BF16), *stats)
    out = TF.batch_norm_apply(_bf16(nchw(x)), *t_stats)
    _close(out, ref, 'batch norm')


def _port_layer(module, params, state, dtype=torch.bfloat16):
    module.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return module.requires_grad_(False).eval().to(dtype)


@pytest.mark.parametrize('k,stride,act,fold', [
    (3, 1, 'leaky_relu', False), (1, 2, None, False), (3, 2, 'relu', True)])
def test_conv2d_batch_norm_bf16_matches_jax(k, stride, act, fold, rng):
    """Conv2d + batch norm with bf16 parameters (cast_tree) on a bf16 input
    against the JAX layer; with ``fold`` the batch norm folded into the
    convolution first (in float32, then cast), so the bias is added in the
    output's dtype."""
    from rcfd_tpu_torch.nn import fold_batch_norm

    jm = JL.Conv2d(5, 6, k, stride, activation_func=act, use_batch_norm=True)
    p, s = jax_variables(jm, 0, rng)
    tm = TL.Conv2d(5, 6, k, stride, activation_func=act, use_batch_norm=True)
    tm = _port_layer(tm, p, s, torch.float32)
    if fold:
        p, s = jax_fold(p, s)
        tm = fold_batch_norm(tm)
    tm = tm.to(torch.bfloat16)
    x = rng.standard_normal((2, 11, 13, 5)).astype(np.float32)
    ref, _ = jm(cast_tree(p, BF16), cast_tree(s, BF16),
                jnp.asarray(x).astype(BF16))
    out = tm(_bf16(nchw(x)))
    assert out.dtype == torch.bfloat16
    _close(out, ref, 'conv2d k={} stride={} fold={}'.format(k, stride, fold))


def test_fully_connected_bf16_params_on_float32_input(rng):
    """bf16 weights serve float32 points in float32 (the JAX package casts
    the weights to the input's dtype): a float32 output within float32
    tolerance of the JAX layer's."""
    jm = JL.FullyConnected(5, 7, activation_func='leaky_relu')
    p, s = jax_variables(jm, 4, rng)
    tm = _port_layer(TL.FullyConnected(5, 7, activation_func='leaky_relu'),
                     p, s)
    assert tm.fully_connected.weight.dtype == torch.bfloat16
    x = rng.standard_normal((3, 5)).astype(np.float32)
    ref, _ = jm(cast_tree(p, BF16), s, jnp.asarray(x))
    out = tm(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# (b)-(d) the kernels' plain versions with bf16 inputs
# ---------------------------------------------------------------------------

def _bf16_scatter_case(name, rng):
    """scatter_case's inputs with the crops rounded to bf16 (as a JAX array
    and as a torch tensor); x, z and valid stay float32 and bool. Pairs
    inside one 2^-14 step become exact ties, which both sides break by the
    first index."""
    crops, x, z, valid, h, w, patch = scatter_case(name, rng)
    crops_j = jnp.asarray(crops).astype(BF16)
    return crops_j, _bf16(crops_j), x, z, valid, h, w, patch


@pytest.mark.parametrize('name', SCATTER_CASES)
def test_scatter_bf16_crops_match_pallas_interpret(name, rng):
    """K1's wrapper on CPU tensors (its plain version) with bf16 crops
    against scatter_quasi_dense_pallas(interpret=True) with the same bf16
    crops: bit for bit; no kernel launched."""
    crops_j, crops_t, x, z, valid, h, w, patch = _bf16_scatter_case(name,
                                                                     rng)
    d_ref, r_ref = scatter_quasi_dense_pallas(
        crops_j, jnp.asarray(x), jnp.asarray(z), jnp.asarray(valid), h, w,
        patch, interpret=True)
    before = _no_launch(sc.scatter_quasi_dense)
    d, r = sc.scatter_quasi_dense(crops_t, torch.from_numpy(x),
                                  torch.from_numpy(z),
                                  torch.from_numpy(valid), h, w, patch)
    assert _no_launch(sc.scatter_quasi_dense) == before
    assert d.dtype == r.dtype == torch.float32
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    assert (r.numpy() > 0).sum() > 0


@pytest.mark.parametrize('name', SCATTER_CASES)
def test_batched_scatter_bf16_crops_match_pallas_interpret(name, rng):
    """The batched wrapper over three frames of one case with bf16 crops
    against the interpret-mode Pallas kernel frame by frame, bit for
    bit."""
    frames = [_bf16_scatter_case(name, rng) for _ in range(3)]
    h, w, patch = frames[0][5:]
    crops = torch.stack([f[1] for f in frames])
    x, z, valid = (torch.from_numpy(np.stack([f[i] for f in frames]))
                   for i in (2, 3, 4))
    d, r = sc.scatter_quasi_dense_batched(crops, x, z, valid, h, w, patch)
    for i, f in enumerate(frames):
        d_ref, r_ref = scatter_quasi_dense_pallas(
            f[0], jnp.asarray(f[2]), jnp.asarray(f[3]), jnp.asarray(f[4]),
            h, w, patch, interpret=True)
        np.testing.assert_array_equal(r[i].numpy(), np.asarray(r_ref))
        np.testing.assert_array_equal(d[i].numpy(), np.asarray(d_ref))


def _fused_skip_bf16_case(rng):
    """tests/test_torch_fused_skip.py's pool2 case with the global map and
    the weights rounded to bf16, in both packages: (JAX lazy, port lazy,
    w_skip HWIO bf16, y1 NHWC bf16, w_a HWIO bf16), as numpy/JAX arrays."""
    lazy_j, lazy_t, _, w_skip, y1, w_a = tfs._case(rng)
    lazy_j = jax_fs.LazyColumnWindows(lazy_j.g.astype(BF16), lazy_j.starts,
                                      lazy_j.pooled_w)
    lazy_t = fs.LazyColumnWindows(lazy_t.g.to(torch.bfloat16),
                                  lazy_t.starts, lazy_t.pooled_w)
    cast = lambda a: jnp.asarray(a).astype(BF16)  # noqa: E731
    return lazy_j, lazy_t, cast(w_skip), cast(y1), cast(w_a)


def _oihw_bf16(w_hwio):
    return _bf16(np.transpose(np.asarray(w_hwio, np.float32), (3, 2, 0, 1)))


def test_gather_add_plain_bf16_matches_fused_xla(rng):
    """K3's wrapper on CPU tensors (its plain version) in bf16 against the
    JAX package's _fused_xla in bf16 on the same a, conv(G) and float32
    corrections: the sum rounded to bf16, the edge columns corrected in
    float32 and rounded again, bit for bit."""
    lazy_j, lazy_t, w_skip, _, _ = _fused_skip_bf16_case(rng)
    nk = lazy_t.shape[0]
    ph, pw = lazy_t.shape[2:]
    a = jnp.asarray(rng.standard_normal((nk, ph, pw, 6), dtype=np.float32)
                    ).astype(BF16)
    cg = JF.conv2d(lazy_j.g, w_skip, stride=1)
    corr_l, corr_r = jax_fs._corrections(lazy_j, w_skip)
    assert cg.dtype == BF16 and corr_l.dtype == jnp.float32
    ref = jax_fs._fused_xla(a, cg, lazy_j, corr_l, corr_r)
    before = _no_launch(fs.fused_skip_gather_add)
    out = fs.fused_skip_gather_add(
        _bf16(nchw(np.asarray(a, np.float32))),
        _bf16(nchw(np.asarray(cg, np.float32))), lazy_t.starts,
        tfs._corr_nchw(corr_l), tfs._corr_nchw(corr_r))
    assert _no_launch(fs.fused_skip_gather_add) == before
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(nhwc(out.float()),
                                  np.asarray(ref, np.float32))


def test_fused_skip_conv_add_bf16_matches_jax(rng):
    """fused_skip_conv_add in bf16 (bf16 convolutions, float32 corrections)
    against the JAX package's (use_pallas=False) in bf16: the corrections
    within float32 tolerance, the result within LAYER_TOL."""
    lazy_j, lazy_t, w_skip, y1, w_a = _fused_skip_bf16_case(rng)
    ref_l, ref_r = jax_fs._corrections(lazy_j, w_skip)
    corr_l, corr_r = fs._corrections(lazy_t, _oihw_bf16(w_skip))
    assert corr_l.dtype == torch.float32
    np.testing.assert_allclose(corr_l.numpy(), tfs._corr_nchw(ref_l).numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(corr_r.numpy(), tfs._corr_nchw(ref_r).numpy(),
                               atol=1e-5, rtol=0)
    ref = jax_fs.fused_skip_conv_add(y1, w_a, lazy_j, w_skip,
                                     use_pallas=False)
    out = fs.fused_skip_conv_add(_bf16(nchw(np.asarray(y1, np.float32))),
                                 _oihw_bf16(w_a), lazy_t, _oihw_bf16(w_skip))
    assert out.dtype == torch.bfloat16
    _close(out, ref, 'fused_skip_conv_add')


@pytest.mark.parametrize('case', ['random', 'clipped'])
def test_column_crop_plain_bf16_matches_pallas_interpret(case, rng):
    """K2's wrapper on CPU tensors (its plain version) with bf16 rows
    against batch_column_crop(interpret=True) in bf16, bit for bit, with
    tests/test_torch_roi_pool.py's cases (zeros past W)."""
    if case == 'random':
        ph, w, c, k, win = 20, 53, 8, 7, 12
        starts = rng.integers(0, w, size=(k,)).astype(np.int32)
    else:
        ph, w, c, win = 8, 24, 4, 6
        starts = np.array([-3, w + 10, w, w - 2], np.int32)
    rows = jnp.asarray(rng.random((ph, w, c), dtype=np.float32)).astype(BF16)
    ref = jax_crop.batch_column_crop(rows, jnp.asarray(starts), win,
                                     interpret=True)
    assert ref.dtype == BF16
    rows_t = _bf16(np.transpose(np.asarray(rows, np.float32), (2, 0, 1)))
    before = _no_launch(cc.batch_column_crop)
    out = cc.batch_column_crop(rows_t[None], torch.from_numpy(starts)[None],
                               win)
    assert _no_launch(cc.batch_column_crop) == before
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(nhwc(out.float()),
                                  np.asarray(ref, np.float32))


def test_roi_pool_variable_bin_bf16_matches_jax(rng):
    """The variable-bin column pool on a bf16 map passes its bf16 rows to
    the crop unchanged: bit for bit the JAX package's bf16 pool."""
    scale, box_width = 1 / 8., 76
    feat = rng.standard_normal((2, 8, 16, 3)).astype(np.float32)
    feat_j = jnp.asarray(feat).astype(BF16)
    x1 = np.array([[0, 3.5, 40.5, 95, 127], [1, 33.3, 60, 126, 200]],
                  np.float32)
    kw = dict(box_width=box_width, box_y1=0, box_y2=64,
              spatial_scale=scale, output_size=(8, int(box_width * scale)))
    ref = trp.jax_roi.roi_pool_column(feat_j, jnp.asarray(x1),
                                      use_pallas_crop=False, **kw)
    out = roi_pool.roi_pool_column(
        _bf16(nchw(np.asarray(feat_j, np.float32))), torch.from_numpy(x1),
        **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(nhwc(out.float()),
                                  np.asarray(ref, np.float32))


# ---------------------------------------------------------------------------
# (e)-(i) the pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def weights():
    """FusionNet's JAX weights, and RadarNet's for each configuration,
    drawn as tests/test_torch_batched.py draws them."""
    rng = np.random.default_rng(20)
    jax_variables(JaxRadarNet(**RADARNET_TINY), 0, rng)
    fv = jax_variables(JaxFusionNet(**FUSIONNET_TINY), 1, rng)
    radarnets = {}
    for config, (radarnet_kw, jax_perf, _) in CONFIGS.items():
        jr = JaxRadarNet(**radarnet_kw, perf=PerfConfig(**jax_perf))
        radarnets[config] = jr, jax_variables(jr, 0,
                                              np.random.default_rng(20))
    return radarnets, fv


def _port(weights, config, **kw):
    """The port's pipeline of ``config`` on the JAX weights, on the CPU."""
    radarnets, fv = weights
    radarnet_kw, _, port_perf = CONFIGS[config]
    rn = RadarNetModel(**radarnet_kw, device='cpu', perf=port_perf)
    rn.load_state_dict(state_dict_from_jax(*radarnets[config][1]),
                       strict=True)
    fn = FusionNetModel(**FUSIONNET_TINY, device='cpu')
    fn.load_state_dict(state_dict_from_jax(*fv), strict=True)
    return pipeline.TwoStagePipeline(rn, fn, H, W, device='cpu', **kw)


def _jax_bf16_stages(jr, jf, rv, fv, image, points, valid, optimize=False):
    """rcfd_tpu/pipeline.py's forward with compute_dtype=bfloat16
    (:100-112, :130-196) step by step, the Pallas scatter in interpret
    mode, under one jit: (crops, dense, quasi, response) as float32 numpy
    (crops and dense bf16 values)."""
    if optimize:
        rv, fv = jax_fold(*rv), jax_fold(*fv)
    rv = tuple(cast_tree(t, BF16) for t in rv)
    fv = tuple(cast_tree(t, BF16) for t in fv)
    stages = jax.jit(lambda *args: _jax_bf16_forward(jr, jf, *args))
    return [np.asarray(a, np.float32) for a in stages(
        rv, fv, jnp.asarray(image), jnp.asarray(points), jnp.asarray(valid))]


def _jax_bf16_forward(jr, jf, rv, fv, image, points, valid):
    patch = jr.input_patch_size_image
    pad = patch[1] // 2
    (image_t,) = JaxTransforms(normalized_image_range=[0, 1]).transform(
        jax.random.PRNGKey(0), [jax_transport.decode(image)],
        random_transform_probability=0.0)
    image_t = image_t.astype(BF16)
    image_pad = jnp.pad(image_t, ((0, 0), (0, 0), (pad, pad), (0, 0)),
                        mode='edge')
    x_shifted = points[:, 0] + pad
    responses, _ = jr.apply(*rv, image_pad, points.at[:, 0].set(x_shifted),
                            (x_shifted - pad)[None, :], box_height=H,
                            training=False, return_logits=False)
    crops = responses[..., 0]
    depth, response = scatter_quasi_dense_pallas(
        crops, x_shifted, points[:, 2], valid, H, W, patch, interpret=True)
    depth = jnp.floor(depth * 256.0) / 256.0
    response = jnp.floor(response * 2.0 ** 14) / 2.0 ** 14
    input_depth = jnp.stack(
        [depth, response * jax_pipeline.RESPONSE_DECODE_SCALE], -1)[None]
    dense, _ = jf.apply(*fv, image_t, input_depth.astype(BF16),
                        training=False)
    return crops, dense[0, :, :, 0], depth, response


def _dense_bounds(dense, dense_ref, p99=True):
    """tests/test_bf16_serving.py's bounds: MAE < 0.25 m and, with ``p99``,
    a 99th-percentile relative error below 0.02. Returns both."""
    err = np.abs(dense - dense_ref)
    mae = err.mean()
    p99_rel = np.percentile(err / np.maximum(dense_ref, 1.0), 99)
    assert mae < DENSE_MAE, mae
    if p99:
        assert p99_rel < DENSE_P99_REL, p99_rel
    return mae, p99_rel


def _crop_changed(crops, crops_ref, points, valid, patch):
    """(H, W) mask of the pixels that some valid point's window covers where
    its crops differ between the two runs: only there may the maps of the
    two differ."""
    ph, pw = patch
    pad = pw // 2
    mask = np.zeros((H, W), bool)
    for p in np.flatnonzero(valid):
        x0 = int(points[p, 0] + pad) - 2 * pad
        changed = (crops[p] != crops_ref[p])
        for j in range(pw):
            if 0 <= x0 + j < W:
                mask[H - ph:, x0 + j] |= changed[:, j]
    return mask


@pytest.mark.parametrize('config', sorted(CONFIGS))
def test_bf16_pipeline_stage_by_stage(weights, config):
    """The port's bf16 pipeline against the JAX package's bf16 forward,
    stage by stage: RadarNet's bf16 crops within CROP_TOL; the scatter and
    bridge of the JAX crops bit for bit equal; FusionNet on the same maps
    and image within the JAX package's dense bounds."""
    radarnets, fv = weights
    jr, rv = radarnets[config]
    jf = JaxFusionNet(**FUSIONNET_TINY)
    port = _port(weights, config, compute_dtype=torch.bfloat16)
    image, points, valid = frame_and_points(np.random.default_rng(21))
    crops_ref, dense_ref, quasi_ref, response_ref = _jax_bf16_stages(
        jr, jf, rv, fv, image, points, valid)
    patch = port.radarnet.input_patch_size_image
    with torch.inference_mode():
        image_t, crops, xs, zs = port.radarnet_stage(image, points)
        assert image_t.dtype == crops.dtype == torch.bfloat16
        assert xs.dtype == zs.dtype == torch.float32
        err = np.abs(_f32(crops) - crops_ref).max()
        assert err <= CROP_TOL, err
        maps = port.scatter(_bf16(crops_ref), xs, zs,
                            torch.from_numpy(valid), H, W, patch)
        quasi, response, input_depth = port.bridge(*maps)
        assert input_depth.dtype == torch.bfloat16
        dense = port.fusionnet(image_t, input_depth)[0, 0]
    np.testing.assert_array_equal(quasi.numpy(), quasi_ref)
    np.testing.assert_array_equal(response.numpy(), response_ref)
    assert (response_ref > 0).sum() > 100
    mae, p99 = _dense_bounds(_f32(dense), dense_ref)
    print('{}: crops max abs diff {:.3g}; FusionNet on the same maps: dense '
          'MAE {:.3g} m, p99 relative {:.3g}'.format(config, err, mae, p99))


def _end_to_end(port, ref, jr, jf, rv, fv, optimize=False):
    image, points, valid = frame_and_points(np.random.default_rng(21))
    dense_ref, quasi_ref, response_ref = [np.asarray(a) for a in ref(
        jnp.asarray(image), jnp.asarray(points), jnp.asarray(valid))]
    dense, quasi, response = [a.numpy() for a in port(image, points, valid)]
    assert dense.dtype == quasi.dtype == response.dtype == np.float32
    assert dense.shape == quasi.shape == response.shape == (H, W)
    crops_ref = _jax_bf16_stages(jr, jf, rv, fv, image, points, valid,
                                 optimize)[0]
    with torch.inference_mode():
        crops = _f32(port.radarnet_stage(image, points)[1])
    assert np.abs(crops - crops_ref).max() <= CROP_TOL
    differ = (quasi != quasi_ref) | (response != response_ref)
    changed = _crop_changed(crops, crops_ref, points, valid,
                            port.radarnet.input_patch_size_image)
    assert not (differ & ~changed).any()
    mae, _ = _dense_bounds(dense, dense_ref, p99=False)
    return int(differ.sum()), mae


@pytest.mark.parametrize('config', sorted(CONFIGS))
def test_bf16_pipeline_end_to_end(weights, config):
    """The port's bf16 __call__ against the JAX package's
    TwoStagePipeline(compute_dtype=bfloat16) (its XLA scatter: on bf16
    crops the exact float max and the 14-bit kernel pick the same winner,
    since a bf16 value at or above 0.5 is a whole number of 2^-14 steps).
    The maps differ only under windows whose crops differ; dense MAE below
    0.25 m. The p99 bound is held at the FusionNet stage
    (test_bf16_pipeline_stage_by_stage): end to end the two runs feed
    FusionNet different maps wherever a crop crosses the threshold, which
    at the tiny models, whose responses all lie within 0.02 of 0.5, is
    most of the windows."""
    radarnets, fv = weights
    jr, rv = radarnets[config]
    jf = JaxFusionNet(**FUSIONNET_TINY)
    ref = jax_pipeline.TwoStagePipeline(jr, jf, rv, fv, H, W,
                                        compute_dtype=BF16)
    port = _port(weights, config, compute_dtype=torch.bfloat16)
    n_differ, mae = _end_to_end(port, ref, jr, jf, rv, fv)
    print('{}: maps differ at {} of {} pixels, each under a changed crop; '
          'dense MAE {:.3g} m'.format(config, n_differ, H * W, mae))


def test_bf16_optimize_matches_jax(weights):
    """optimize=True with bf16 (fold in float32, then cast) against the
    JAX package's optimize=True, compute_dtype=bfloat16, end to end by
    test_bf16_pipeline_end_to_end's rule, over the deferred pools so that
    the folded bias is added after K3's plain version in bf16."""
    radarnets, fv = weights
    jr, rv = radarnets['fused']
    jf = JaxFusionNet(**FUSIONNET_TINY)
    ref = jax_pipeline.TwoStagePipeline(jr, jf, rv, fv, H, W, optimize=True,
                                        compute_dtype=BF16)
    port = _port(weights, 'fused', optimize=True,
                 compute_dtype=torch.bfloat16)
    assert port.radarnet.decoder.deconv1.conv.conv.bias.dtype == \
        torch.bfloat16
    _end_to_end(port, ref, jr, jf, rv, fv, optimize=True)


def test_forward_batched_bf16_matches_call_per_frame(weights):
    """forward_batched in bf16, frame b against __call__ in bf16 of frame
    b: maps bit for bit, dense within two bf16 steps (2^-6) of its own
    depth, the card's bound in chip_smoke.py (0 m apart measured on the
    CPU)."""
    port = _port(weights, 'fused', compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(30)
    frames = [frame_and_points(rng, k=8, n_invalid=2 + 3 * i)
              for i in range(2)]
    images = np.concatenate([f[0] for f in frames])
    points = np.stack([f[1] for f in frames])
    valid = np.stack([f[2] for f in frames])
    outs = [o.numpy() for o in port.forward_batched(images, points, valid)]
    for b in range(2):
        dense, quasi, response = [o.numpy() for o in port(
            images[b:b + 1], points[b], valid[b])]
        np.testing.assert_array_equal(outs[1][b], quasi)
        np.testing.assert_array_equal(outs[2][b], response)
        np.testing.assert_allclose(outs[0][b], dense, rtol=2.0 ** -6,
                                   atol=0)
        assert outs[0].dtype == np.float32
        print('frame {}: dense max abs diff {:.3g} m'.format(
            b, np.abs(outs[0][b] - dense).max()))


def test_bf16_scatter_placement_matches_float32():
    """tests/test_bf16_serving.py's placement test on the port: a point at
    x = 1203 (no bf16 value; bf16 steps by 8 above 1024) in a 1536-wide
    frame. The response's column support is identical in the port's
    float32 and bf16 pipelines and in the JAX package's bf16 pipeline: the
    coordinates never pass through bf16."""
    h, w = 64, 1536
    rn_kw = dict(RADARNET_TINY, input_patch_size_image=(64, 32),
                 encoder_type='radarnetv1_batch_norm',
                 decoder_type='multiscale_batch_norm')
    jr, jf = JaxRadarNet(**rn_kw), JaxFusionNet(**FUSIONNET_TINY)
    rng = np.random.default_rng(40)
    rv, fv = jax_variables(jr, 0, rng), jax_variables(jf, 1, rng)
    rn = RadarNetModel(**rn_kw, device='cpu')
    rn.load_state_dict(state_dict_from_jax(*rv), strict=True)
    fn = FusionNetModel(**FUSIONNET_TINY, device='cpu')
    fn.load_state_dict(state_dict_from_jax(*fv), strict=True)
    image = (rng.random((1, h, w, 3)) * 255).astype(np.float32)
    points = np.array([[1203.0, 40.0, 17.0]], np.float32)
    valid = np.ones((1,), bool)
    ref = jax_pipeline.TwoStagePipeline(jr, jf, rv, fv, h, w,
                                        compute_dtype=BF16)
    r_ref = np.asarray(ref(jnp.asarray(image), jnp.asarray(points),
                           jnp.asarray(valid))[2])
    support = lambda r: np.flatnonzero(r.sum(axis=0))  # noqa: E731
    cols_ref = support(r_ref)
    assert cols_ref.size > 0 and cols_ref.min() > 1024
    for dtype in (None, torch.bfloat16):
        port = pipeline.TwoStagePipeline(rn, fn, h, w, compute_dtype=dtype,
                                         device='cpu')
        np.testing.assert_array_equal(
            support(port(image, points, valid)[2].numpy()), cols_ref)


@pytest.mark.parametrize('dtype', [torch.float16, torch.float64])
def test_compute_dtype_refuses_other_dtypes(weights, dtype):
    with pytest.raises(NotImplementedError, match='compute_dtype'):
        _port(weights, 'canonical', compute_dtype=dtype)


def test_compute_dtype_none_and_float32_serve_float32(weights):
    """compute_dtype None and torch.float32 are the float32 path, bit for
    bit; bf16 serves copies of the models, cast, and leaves the caller's
    models in float32 (the batch norms' step counts stay int64)."""
    image, points, valid = frame_and_points(np.random.default_rng(21))
    base = _port(weights, 'canonical')
    outs = [o.numpy() for o in base(image, points, valid)]
    same = pipeline.TwoStagePipeline(base.radarnet, base.fusionnet, H, W,
                                     compute_dtype=torch.float32,
                                     device='cpu')
    for a, b in zip(outs, same(image, points, valid)):
        np.testing.assert_array_equal(a, b.numpy())
    bf16 = pipeline.TwoStagePipeline(base.radarnet, base.fusionnet, H, W,
                                     compute_dtype=torch.bfloat16,
                                     device='cpu')
    for caller, served in ((base.radarnet, bf16.radarnet),
                           (base.fusionnet, bf16.fusionnet)):
        assert served is not caller
        for (name, t), (_, u) in zip(caller.state_dict().items(),
                                     served.state_dict().items()):
            if name.endswith('num_batches_tracked'):
                assert t.dtype == u.dtype == torch.int64
            else:
                assert (t.dtype, u.dtype) == (torch.float32, torch.bfloat16)
    for a, b in zip(outs, base(image, points, valid)):
        np.testing.assert_array_equal(a, b.numpy())


def test_from_checkpoints_passes_compute_dtype(tmp_path, weights):
    """from_checkpoints hands compute_dtype to the constructor."""
    port = _port(weights, 'canonical')
    paths = []
    for model, keys in ((port.radarnet, ('radarnet_encoder_state_dict',
                                         'radarnet_decoder_state_dict')),
                        (port.fusionnet, ('encoder_state_dict',
                                          'decoder_state_dict'))):
        paths.append(str(tmp_path / '{}.pth'.format(len(paths))))
        torch.save({key: getattr(model, part).state_dict() for key, part in
                    zip(keys, ('encoder', 'decoder'))}, paths[-1])
    small = {k: v for k, v in RADARNET_TINY.items()
             if k.startswith('n_')}
    restored = pipeline.TwoStagePipeline.from_checkpoints(
        *paths, image_height=H, image_width=W,
        patch_size=RADARNET_TINY['input_patch_size_image'],
        radarnet_kwargs=small,
        fusionnet_kwargs={k: v for k, v in FUSIONNET_TINY.items()
                          if k.startswith('n_filters')},
        compute_dtype=torch.bfloat16, device='cpu')
    assert restored.compute_dtype == torch.bfloat16
    assert next(restored.radarnet.parameters()).dtype == torch.bfloat16
    ref = pipeline.TwoStagePipeline(copy.deepcopy(port.radarnet),
                                    copy.deepcopy(port.fusionnet), H, W,
                                    compute_dtype=torch.bfloat16,
                                    device='cpu')
    image, points, valid = frame_and_points(np.random.default_rng(21))
    for a, b in zip(restored(image, points, valid), ref(image, points,
                                                        valid)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
