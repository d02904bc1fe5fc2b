"""Column ROI pooling of rcfd_tpu_torch against the JAX package, exactly:
max pooling moves values and computes none."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import sys  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import rcfd_tpu.ops.roi_pool  # noqa: E402,F401

from rcfd_tpu.ops import crop_pallas as jax_crop  # noqa: E402
from rcfd_tpu_torch.ops import crop_cuda, roi_pool  # noqa: E402

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


# box widths whose scaled width is not an integer (40 is one only at 1/16)
VARIABLE_BIN = [(bw, scale) for bw in (30, 50) for scale in
                (1 / 4., 1 / 8., 1 / 16.)] + [(40, 1 / 16.)]


@pytest.mark.parametrize('box_width,scale', VARIABLE_BIN)
def test_roi_pool_column_variable_bin_matches_jax(box_width, scale, rng):
    """box_width * scale not an integer: the variable-bin branch (windows
    through the crop's plain version) against the JAX package's XLA branch,
    exactly, with boxes at both edges and beyond the right one."""
    frame_h, frame_w = 64, 128
    hf, wf = int(frame_h * scale), int(frame_w * scale)
    feat = rng.standard_normal((2, hf, wf, 3)).astype(np.float32)
    x1 = np.array([[0, 3.5, 17, 40.49, 40.5, 95, 127, 140],
                   [1, 2.5, 33.3, 60, 88, frame_w - box_width, 126, 200]],
                  np.float32)
    size = (int(frame_h * scale), int(box_width * scale))
    assert not float(box_width * scale).is_integer()
    kw = dict(box_width=box_width, box_y1=0, box_y2=frame_h,
              spatial_scale=scale, output_size=size)
    ref = jax_roi.roi_pool_column(jnp.asarray(feat), jnp.asarray(x1),
                                  use_pallas_crop=False, **kw)
    out = roi_pool.roi_pool_column(nchw(feat), torch.from_numpy(x1), **kw)
    assert out.shape == (x1.size, 3) + size
    np.testing.assert_array_equal(nhwc(out), np.asarray(ref))


@pytest.mark.parametrize('return_global', [False, True])
def test_roi_pool_column_variable_bin_ignores_return_global(return_global,
                                                             rng):
    """Without the constant-bin branch there is no global map to defer:
    return_global gives the windows, as in the JAX package."""
    feat = rng.standard_normal((1, 8, 16, 3)).astype(np.float32)
    x1 = np.array([[0, 9, 30]], np.float32)
    kw = dict(box_width=30, box_y1=0, box_y2=32, spatial_scale=1 / 4.,
              output_size=(8, 7))
    ref = jax_roi.roi_pool_column(jnp.asarray(feat), jnp.asarray(x1),
                                  use_pallas_crop=False, **kw)
    out = roi_pool.roi_pool_column(nchw(feat), torch.from_numpy(x1),
                                   return_global=return_global, **kw)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(nhwc(out), np.asarray(ref))


@pytest.mark.parametrize('case', ['random', 'clipped'])
def test_column_crop_plain_matches_pallas_interpret(case, rng):
    """The crop's plain version against batch_column_crop(interpret=True),
    exactly, with tests/test_crop_pallas.py's shapes and clip cases: a
    negative start clips to 0, starts at and past W give zeros."""
    if case == 'random':
        ph, w, c, k, win = 20, 53, 8, 7, 12
        starts = rng.integers(0, w, size=(k,)).astype(np.int32)
    else:
        ph, w, c, win = 8, 24, 4, 6
        starts = np.array([-3, w + 10, w, w - 2], np.int32)
    rows = rng.random((ph, w, c), dtype=np.float32)
    ref = np.asarray(jax_crop.batch_column_crop(
        jnp.asarray(rows), jnp.asarray(starts), win, interpret=True))
    rows_t = torch.from_numpy(np.ascontiguousarray(
        np.transpose(rows, (2, 0, 1))))[None]
    out = crop_cuda.batch_column_crop(rows_t, torch.from_numpy(starts)[None],
                                      win)
    assert out.shape == (len(starts), c, ph, win)
    np.testing.assert_array_equal(nhwc(out), ref)


def _boxes(rng, n, k, h, w):
    """Boxes [x1, y1, x2, y2] at the frame's scale: inside, across the
    edges, a point box, one of zero size, one inverted, the whole frame and
    one wholly right of the map."""
    x = np.sort(rng.uniform(-20, w + 20, (n, k, 2)), -1)
    y = np.sort(rng.uniform(-20, h + 20, (n, k, 2)), -1)
    boxes = np.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)
    boxes[:, 0] = [3.5, 4.5, 3.5, 4.5]
    boxes[:, 1] = [40, 30, 40, 30]
    boxes[:, 2] = [60, 50, 20, 10]
    boxes[:, 3] = [0, 0, w - 1, h - 1]
    boxes[:, 4] = [w + 30, 0, w + 60, 20]  # wholly right of the map
    return boxes.astype(np.float32)


@pytest.mark.parametrize('scale,output_size,max_roi', [
    (1 / 8., (7, 7), None), (1 / 4., (3, 5), None), (1 / 8., (2, 3),
                                                     (20, 30))])
def test_general_roi_pool_matches_jax(rng, scale, output_size, max_roi):
    """The general box pool (rcfd_tpu/ops/roi_pool.py:270) against JAX's,
    exactly: boxes inside and across the map's edges, a one-cell box, an
    inverted box (a size of 1), the whole frame; a box right of the map
    (its bins empty: 0); with and without max_roi_size; five boxes a frame
    more than ROI_POOL_CHUNK, so that the last gather is a partial one."""
    h, w = 96, 160
    feat = rng.standard_normal((2, int(h * scale), int(w * scale),
                                4)).astype(np.float32)
    boxes = _boxes(rng, 2, roi_pool.ROI_POOL_CHUNK + 5, h, w)
    ref = jax_roi.roi_pool(jnp.asarray(feat), jnp.asarray(boxes), scale,
                           output_size, max_roi)
    out = roi_pool.roi_pool(nchw(feat), torch.from_numpy(boxes), scale,
                            output_size, max_roi)
    assert out.shape == (2 * (roi_pool.ROI_POOL_CHUNK + 5), 4) + output_size
    np.testing.assert_array_equal(nhwc(out), np.asarray(ref))
    assert (np.asarray(ref) == 0).any()


def test_general_roi_pool_with_torchvision_semantics(rng):
    """On a map of distinct values each bin's max is the max over
    [floor(i * bin), ceil((i + 1) * bin)) of the rounded box, computed
    here in numpy."""
    feat = rng.permutation(12 * 20).reshape(1, 1, 12, 20).astype(np.float32)
    box = np.array([[[2.4, 1.6, 13.5, 9.49]]], np.float32)
    out = roi_pool.roi_pool(torch.from_numpy(feat), torch.from_numpy(box),
                            1.0, (3, 4))[0, 0].numpy()
    x1, y1, x2, y2 = 2, 2, 14, 9
    bh, bw = np.float32(y2 - y1 + 1) / 3, np.float32(x2 - x1 + 1) / 4
    for i in range(3):
        for j in range(4):
            r0, r1 = y1 + int(np.floor(i * bh)), y1 + int(np.ceil((i + 1) *
                                                                  bh))
            c0, c1 = x1 + int(np.floor(j * bw)), x1 + int(np.ceil((j + 1) *
                                                                  bw))
            assert out[i, j] == feat[0, 0, r0:min(r1, 12),
                                     c0:min(c1, 20)].max()
