"""The deferred column ROI pool and the fused skip gather-add of
rcfd_tpu_torch against the JAX package (rcfd_tpu/ops/fused_skip.py) on the
CPU, where the port's wrapper runs the kernel's plain version."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import sys  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import rcfd_tpu.ops.roi_pool  # noqa: E402,F401
from rcfd_tpu.nn import functional as JF  # noqa: E402
from rcfd_tpu.ops import fused_skip as jax_fs  # noqa: E402

from rcfd_tpu_torch.ops import fused_skip as fs  # noqa: E402
from rcfd_tpu_torch.ops import roi_pool  # noqa: E402

from torch_parity import nchw, nhwc  # noqa: E402

# the package's ops/__init__ re-exports a function named roi_pool
jax_roi = sys.modules['rcfd_tpu.ops.roi_pool']

# float32 convolutions summed in another order on each side, as in
# tests/test_fused_skip.py
ATOL = 2e-5


def _case(rng, x1=None, n=2, k=5, h=64, w=96, c=8, co=6, patch_w=32):
    """A pool2 case through both packages' roi_pool_column at scale 1/2:
    (JAX lazy, port lazy, JAX eager windows, w_skip HWIO, y1 NHWC, w_a
    HWIO), with boxes at both edges of the padded range by default."""
    feat = rng.standard_normal((n, h // 2, (w + patch_w) // 2, c),
                               dtype=np.float32)
    if x1 is None:
        x1 = np.stack([
            np.concatenate([[0.0], rng.uniform(0, w, k - 2), [float(w)]])
            for _ in range(n)]).astype(np.float32)
    size = (h // 2, patch_w // 2)
    kw = dict(box_width=patch_w, box_y1=0, box_y2=h, spatial_scale=0.5,
              output_size=size)
    lazy_j = jax_roi.roi_pool_column(jnp.asarray(feat), jnp.asarray(x1),
                                     return_global=True, **kw)
    lazy_t = roi_pool.roi_pool_column(nchw(feat), torch.from_numpy(x1),
                                      return_global=True, **kw)
    eager = jax_roi.roi_pool_column(jnp.asarray(feat), jnp.asarray(x1), **kw)
    nk = x1.size
    w_skip = rng.standard_normal((3, 3, c, co), dtype=np.float32) * 0.1
    y1 = rng.standard_normal((nk,) + size + (c,), dtype=np.float32)
    w_a = rng.standard_normal((3, 3, c, co), dtype=np.float32) * 0.1
    return lazy_j, lazy_t, eager, w_skip, y1, w_a


def oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w_hwio, (3, 2, 0, 1))))


def _corr_nchw(corr):
    """JAX (N, K, ph, Co) corrections -> the port's (N * K, Co, ph)."""
    n, k, ph, co = corr.shape
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(corr), (0, 1, 3, 2)).reshape(n * k, co, ph)))


def test_lazy_windows_match_jax(rng):
    """roi_pool_column(return_global=True): the same zeroed global map and
    starts as the JAX package, and materialize() gives the eager windows."""
    lazy_j, lazy_t, eager, _, _, _ = _case(rng)
    assert isinstance(lazy_t, fs.LazyColumnWindows)
    assert lazy_t.pooled_w == lazy_j.pooled_w
    assert lazy_t.starts.dtype == torch.int32
    np.testing.assert_array_equal(nhwc(lazy_t.g), np.asarray(lazy_j.g))
    np.testing.assert_array_equal(lazy_t.starts.numpy(),
                                  np.asarray(lazy_j.starts))
    n, ph, pw, c = np.asarray(eager).shape
    assert lazy_t.shape == (n, c, ph, pw)
    assert lazy_t.dtype == torch.float32
    np.testing.assert_array_equal(nhwc(lazy_t.materialize()),
                                  np.asarray(eager))
    np.testing.assert_array_equal(nhwc(lazy_t.materialize()),
                                  np.asarray(lazy_j.materialize()))


def test_corrections_match_jax(rng):
    lazy_j, lazy_t, _, w_skip, _, _ = _case(rng)
    ref_l, ref_r = jax_fs._corrections(lazy_j, jnp.asarray(w_skip))
    corr_l, corr_r = fs._corrections(lazy_t, oihw(w_skip))
    assert corr_l.is_contiguous() and corr_r.is_contiguous()
    np.testing.assert_allclose(corr_l.numpy(), _corr_nchw(ref_l).numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(corr_r.numpy(), _corr_nchw(ref_r).numpy(),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize('reference', ['pallas_interpret', 'xla'])
def test_gather_add_plain_matches_jax_exactly(reference, rng):
    """The kernel's plain version against _fused_pallas(interpret=True) and
    _fused_xla on the same a, conv(G) and corrections: the same float32
    adds and subtracts in the same order, so equal bit for bit."""
    lazy_j, lazy_t, _, w_skip, _, _ = _case(rng)
    nk = lazy_t.shape[0]
    ph, pw = lazy_t.shape[2:]
    a = rng.standard_normal((nk, ph, pw, 6), dtype=np.float32)
    cg = JF.conv2d(lazy_j.g, jnp.asarray(w_skip), stride=1)
    corr_l, corr_r = jax_fs._corrections(lazy_j, jnp.asarray(w_skip))
    if reference == 'xla':
        ref = jax_fs._fused_xla(jnp.asarray(a), cg, lazy_j, corr_l, corr_r)
    else:
        ref = jax_fs._fused_pallas(jnp.asarray(a), cg, lazy_j, corr_l,
                                   corr_r, interpret=True)
    before = fs.fused_skip_gather_add.launches
    out = fs.fused_skip_gather_add(nchw(a), nchw(np.asarray(cg)),
                                   lazy_t.starts, _corr_nchw(corr_l),
                                   _corr_nchw(corr_r))
    assert fs.fused_skip_gather_add.launches == before  # CPU: plain version
    np.testing.assert_array_equal(nhwc(out), np.asarray(ref))


def test_fused_skip_conv_add_matches_jax(rng):
    """Within JAX's own tolerance for the fusion (tests/test_fused_skip.py),
    against both its fused function and the composition it replaces."""
    lazy_j, lazy_t, eager, w_skip, y1, w_a = _case(rng)
    ref = jax_fs.fused_skip_conv_add(jnp.asarray(y1), jnp.asarray(w_a),
                                     lazy_j, jnp.asarray(w_skip),
                                     use_pallas=False)
    composition = JF.conv2d(jnp.asarray(y1), jnp.asarray(w_a), stride=1) + \
        JF.conv2d(eager, jnp.asarray(w_skip), stride=1)
    out = fs.fused_skip_conv_add(nchw(y1), oihw(w_a), lazy_t, oihw(w_skip))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(nhwc(out), np.asarray(composition), atol=ATOL,
                               rtol=ATOL)


def test_windows_at_start_zero_and_right_edge(rng):
    """Boxes whose windows start at column 0 and end at the last column of
    the map before its apron: the left correction has no column to its
    left, the right one reads the zero apron."""
    x1 = np.array([[0.0, 0.4, 96.0, 95.6]], np.float32)
    lazy_j, lazy_t, eager, w_skip, y1, w_a = _case(rng, x1=x1, n=1)
    wg = lazy_t.g.shape[3]
    assert lazy_t.starts.tolist() == [[0, 0, wg - 2 * 16, wg - 2 * 16]]
    ref = JF.conv2d(jnp.asarray(y1), jnp.asarray(w_a), stride=1) + \
        JF.conv2d(eager, jnp.asarray(w_skip), stride=1)
    out = fs.fused_skip_conv_add(nchw(y1), oihw(w_a), lazy_t, oihw(w_skip))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


def test_refuses_pooled_width_one(rng):
    """At pooled_w == 1 the first and the last column coincide."""
    g = torch.zeros(1, 2, 4, 6)
    lazy = fs.LazyColumnWindows(g, torch.zeros(1, 3, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match='pooled_w >= 2'):
        fs.fused_skip_conv_add(torch.zeros(3, 2, 4, 1), torch.zeros(2, 2, 3, 3),
                               lazy, torch.zeros(2, 2, 3, 3))


def test_gather_add_refuses_shapes_that_do_not_fit():
    a = torch.zeros(4, 3, 5, 6)
    cg = torch.zeros(2, 3, 5, 20)
    corr = torch.zeros(4, 3, 5)
    starts = torch.zeros(2, 2, dtype=torch.int32)
    fs.fused_skip_gather_add(a, cg, starts, corr, corr)
    with pytest.raises(ValueError, match='do not fit'):
        fs.fused_skip_gather_add(a, cg, starts[:, :1], corr, corr)
    with pytest.raises(ValueError, match='do not fit'):
        fs.fused_skip_gather_add(a, cg[:, :2], starts, corr, corr)
