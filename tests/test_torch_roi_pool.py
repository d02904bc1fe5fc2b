"""Column ROI pooling of rcfd_tpu_torch against the JAX package, exactly:
max pooling moves values and computes none."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import sys  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import rcfd_tpu.ops.roi_pool  # noqa: E402,F401

from rcfd_tpu_torch.ops import roi_pool  # noqa: E402

from torch_parity import nchw, nhwc  # noqa: E402

# the package's ops/__init__ re-exports a function named roi_pool
jax_roi = sys.modules['rcfd_tpu.ops.roi_pool']

SCALES = [1 / 2., 1 / 4., 1 / 8., 1 / 16., 1 / 32.]


@pytest.mark.parametrize('box_y2,scale,pooled_h', [
    (36, 1 / 8., 4), (900 // 8, 1 / 8., 14), (64, 1 / 2., 16),
    (64, 1 / 32., 1), (90, 1 / 4., 22)])
def test_pool_rows_static_matches_jax(box_y2, scale, pooled_h, rng):
    """Row bins with std::round half away from zero (e.g. 36 / 8 = 4.5)."""
    h = int(np.ceil(box_y2 * scale)) + 1
    feat = rng.standard_normal((2, h, 7, 3)).astype(np.float32)
    ref = jax_roi.pool_rows_static(jnp.asarray(feat), 0, box_y2, scale,
                                   pooled_h)
    out = roi_pool.pool_rows_static(nchw(feat), 0, box_y2, scale, pooled_h)
    np.testing.assert_array_equal(nhwc(out), np.asarray(ref))


@pytest.mark.parametrize('scale', SCALES)
def test_roi_pool_column_constant_bin_matches_jax(scale, rng):
    """The constant-bin branch at every scale of a 32-wide patch over a
    64x128 padded frame, boxes at both edges and beyond the right one."""
    patch_h, patch_w, frame_h, frame_w = 32, 32, 64, 128
    hf, wf = int(frame_h * scale), int(frame_w * scale)
    feat = rng.standard_normal((1, hf, wf, 5)).astype(np.float32)
    x1 = np.array([[0, 3.5, 17, 40.49, 40.5, 95, 96, 127, 140]],
                  np.float32)
    size = (int(patch_h * scale), int(patch_w * scale))
    ref = jax_roi.roi_pool_column(
        jnp.asarray(feat), jnp.asarray(x1), box_width=patch_w, box_y1=0,
        box_y2=frame_h, spatial_scale=scale, output_size=size)
    out = roi_pool.roi_pool_column(nchw(feat), torch.from_numpy(x1),
                                   box_width=patch_w, box_y1=0,
                                   box_y2=frame_h, spatial_scale=scale,
                                   output_size=size)
    assert out.shape == (x1.shape[1], 5) + size
    np.testing.assert_array_equal(nhwc(out), np.asarray(ref))


def test_roi_pool_column_batched_images(rng):
    feat = rng.standard_normal((2, 8, 16, 3)).astype(np.float32)
    x1 = np.array([[0, 9, 30], [2, 50, 61]], np.float32)
    kw = dict(box_width=16, box_y1=0, box_y2=32, spatial_scale=1 / 4.,
              output_size=(4, 4))
    ref = jax_roi.roi_pool_column(jnp.asarray(feat), jnp.asarray(x1), **kw)
    out = roi_pool.roi_pool_column(nchw(feat), torch.from_numpy(x1), **kw)
    np.testing.assert_array_equal(nhwc(out), np.asarray(ref))


def test_roi_pool_column_variable_bin_raises(rng):
    """box_width * scale not an integer: the variable-bin branch, whose
    crop kernel is not ported yet."""
    feat = torch.from_numpy(rng.standard_normal((1, 3, 8, 16)).astype(
        np.float32))
    with pytest.raises(NotImplementedError, match='variable-bin'):
        roi_pool.roi_pool_column(feat, torch.zeros(1, 2), box_width=30,
                                 box_y1=0, box_y2=32, spatial_scale=1 / 4.,
                                 output_size=(8, 7))
