"""ROI max pooling for the radar column boxes (counterpart of
rcfd_tpu/ops/roi_pool.py), NCHW.

Every box is a full-height, fixed-width column window around a radar
point, with torchvision.ops.roi_pool's bin arithmetic:
``roi_start = round(coord * scale)``, ``roi_size = max(end - start + 1, 1)``,
bin j covers ``[floor(j * bin), ceil((j + 1) * bin))`` in float32, clamped
to the map; empty bins give 0.

Two branches, as in the JAX package:

- constant-bin: when ``box_width * scale`` is an integer equal to
  ``pooled_w`` (every scale of the canonical 288-wide patch), each bin is
  exactly ``[j, j + 2)``, so the pool is a box-independent 2-tap column max
  followed by a contiguous window per box. It can also be returned
  deferred, as a LazyColumnWindows, for the fused skip of the decoder.
- variable-bin: otherwise (any patch width that is not a multiple of 32),
  each box takes one contiguous window of the row-pooled map through the
  column crop kernel (ops/crop_cuda.py; its plain version on the CPU), and
  the bin maxima are masked maxima over a few static shifts of it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .crop_cuda import batch_column_crop
from .fused_skip import LazyColumnWindows


# boxes of one gather of the general pool (``roi_pool``): a gather holds
# C * this many boxes * (pooled_h * max_bin_h) * (pooled_w * max_bin_w) cells
ROI_POOL_CHUNK = 16


def _round_half_away(v):
    """C++ std::round for non-negative inputs (torchvision uses round())."""
    return torch.floor(v + 0.5)


def _static_bins(roi_size: int, pooled: int):
    """Static (start, end) bins for a fixed roi size, in float32 like
    torchvision's kernel."""
    bin_size = np.float32(roi_size) / np.float32(pooled)
    idx = np.arange(pooled, dtype=np.float32)
    starts = np.floor(idx * bin_size).astype(np.int64)
    ends = np.ceil((idx + np.float32(1)) * bin_size).astype(np.int64)
    return starts, ends


def _bins_are_j_j2(pw: int) -> bool:
    """True when torchvision's f32 bins over pw + 1 columns are exactly
    [j, j + 2) for every j."""
    b = np.float32(pw + 1) / np.float32(pw)
    j = np.arange(pw, dtype=np.float32)
    return bool((np.floor(j * b) == np.arange(pw)).all() and
                (np.ceil((j + np.float32(1)) * b) == np.arange(pw) + 2).all())


def pool_rows_static(feat, box_y1: int, box_y2: int, spatial_scale: float,
                     pooled_h: int):
    """Max-pool the rows of NCHW ``feat`` into ``pooled_h`` bins of a static
    box y-extent. Returns (N, C, pooled_h, W), shared by every column box."""
    h = feat.shape[2]
    # half away from zero like std::round: 900 * 0.125 = 112.5 -> 113
    roi_start_h = int(np.floor(box_y1 * spatial_scale + 0.5))
    roi_end_h = int(np.floor(box_y2 * spatial_scale + 0.5))
    roi_height = max(roi_end_h - roi_start_h + 1, 1)
    starts, ends = _static_bins(roi_height, pooled_h)
    starts = np.clip(starts + roi_start_h, 0, h)
    ends = np.clip(ends + roi_start_h, 0, h)
    max_bin = int(np.max(ends - starts))

    neg_inf = torch.tensor(float('-inf'), dtype=feat.dtype,
                           device=feat.device)
    out = None
    for t in range(max_bin):
        idx = np.clip(starts + t, 0, h - 1)
        valid = (starts + t) < ends
        rows = feat.index_select(2, torch.from_numpy(idx).to(feat.device))
        if not valid.all():
            mask = torch.from_numpy(valid).to(feat.device).view(1, 1, -1, 1)
            rows = torch.where(mask, rows, neg_inf)
        out = rows if out is None else torch.maximum(out, rows)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def variable_bin_window(box_width: int, spatial_scale: float,
                        pooled_w: int):
    """(shifts, win) of the variable-bin branch. roi_width is at most
    ceil(box_width * scale) + 2, so every bin is at most max_bin_w wide, and
    bin j's taps lie at local columns j + s, s < shifts, of a window of win
    columns from the box's start."""
    max_roi_w = int(math.ceil(box_width * spatial_scale)) + 2
    max_bin_w = int(math.ceil(max_roi_w / pooled_w)) + 1
    shifts = (max_roi_w - pooled_w) + max_bin_w
    return shifts, pooled_w + shifts


def roi_pool_column(feat, x1, box_width: int, box_y1: int, box_y2: int,
                    spatial_scale: float, output_size: Tuple[int, int],
                    return_global: bool = False):
    """ROI max pool of full-height, fixed-width column boxes.

    Arg(s):
        feat : (N, C, H_f, W_f) feature map
        x1 : (N, K) left box edges in input coordinates (x2 = x1 + box_width),
            non-negative
        box_width : static box width in input coordinates
        box_y1, box_y2 : static vertical box extent in input coordinates
        spatial_scale : feature scale (e.g. 1/32)
        output_size : (pooled_h, pooled_w)
        return_global : when the constant-bin branch applies, return the
            pool deferred, as a LazyColumnWindows of the global 2-tap-max map
            (its -inf apron zeroed) and the window starts; ``materialize()``
            gives the windows this function returns otherwise. Without the
            constant-bin branch, the windows are returned.
    Returns:
        (N * K, C, pooled_h, pooled_w), image-major like
        torchvision.ops.roi_pool; or a LazyColumnWindows (see return_global)
    """
    n, c, h_f, w_f = feat.shape
    k = x1.shape[1]
    pooled_h, pooled_w = output_size
    rows = pool_rows_static(feat, box_y1, box_y2, spatial_scale, pooled_h)
    # rows: (N, C, pooled_h, W_f)
    x1f = x1.float()
    roi_start_w = _round_half_away(x1f * spatial_scale).to(torch.int32)
    bw_scaled = box_width * spatial_scale

    if float(bw_scaled).is_integer() and pooled_w == int(bw_scaled) and \
            _bins_are_j_j2(pooled_w):
        # right tap rows[..., w + 1], -inf past the map (the last column's
        # bin is the column alone); rows are finite, so g is, and a zero
        # apron past w_f makes bins wholly beyond the map 0 like empty bins
        neg_inf = torch.full_like(rows[..., :1], float('-inf'))
        g = torch.maximum(rows, torch.cat([rows[..., 1:], neg_inf], dim=3))
        g = F.pad(g, (0, pooled_w))
        start = torch.clamp(roi_start_w, 0, w_f)                 # (N, K)
        lazy = LazyColumnWindows(g, start, pooled_w)
        return lazy if return_global else lazy.materialize()

    roi_end_w = _round_half_away((x1f + box_width) * spatial_scale).to(
        torch.int32)
    roi_width = torch.clamp_min(roi_end_w - roi_start_w + 1, 1)  # (N, K)

    shifts, win = variable_bin_window(box_width, spatial_scale, pooled_w)

    # a true division, as torchvision's and the JAX package's: divided by a
    # Python number, a CUDA tensor is multiplied by its reciprocal, which
    # can put a bin's end one column further (14 / 12 at the 1/8 pool of a
    # 100-wide patch)
    bin_w = roi_width.float() / torch.full_like(roi_width, pooled_w,
                                                dtype=torch.float32)
    j = torch.arange(pooled_w, dtype=torch.float32, device=feat.device)
    wstart = torch.floor(j * bin_w[..., None])                   # (N, K, pw)
    wend = torch.ceil((j + 1.0) * bin_w[..., None])
    wstart = torch.clamp(wstart.to(torch.int32) + roi_start_w[..., None],
                         0, w_f)
    wend = torch.clamp(wend.to(torch.int32) + roi_start_w[..., None], 0, w_f)

    # the crop clips its start to [0, W_f] (x1 >= 0 keeps start >= 0); boxes
    # wholly right of the map give empty bins, so 0
    start = torch.clamp_max(roi_start_w, w_f)                    # (N, K)
    windows = batch_column_crop(rows.contiguous(), start.contiguous(), win)
    windows = windows.reshape(n, k, c, pooled_h, win)
    ws_l = (wstart - start[..., None])[:, :, None, None, :]      # (N,K,1,1,pw)
    we_l = (wend - start[..., None])[:, :, None, None, :]

    neg_inf = torch.tensor(float('-inf'), dtype=rows.dtype,
                           device=feat.device)
    jj = torch.arange(pooled_w, dtype=torch.int32, device=feat.device)
    acc = None
    for s in range(shifts):
        a = jj + s  # local column of this shift for every output bin
        seg = torch.where((a >= ws_l) & (a < we_l),
                          windows[..., s:s + pooled_w], neg_inf)
        acc = seg if acc is None else torch.maximum(acc, seg)
    pooled = torch.where(torch.isfinite(acc), acc, torch.zeros_like(acc))
    return pooled.reshape(n * k, c, pooled_h, pooled_w)


def roi_pool(feat, boxes, spatial_scale: float, output_size: Tuple[int, int],
             max_roi_size: Tuple[int, int] = None):
    """General ROI max pool with torchvision's semantics
    (rcfd_tpu/ops/roi_pool.py:270 ``roi_pool``), NCHW, in plain PyTorch:
    no kernel stands behind it in the JAX package, and no path of either
    package calls it.

    Each box [x1, y1, x2, y2] starts at round(coord * scale) (half away
    from zero) and spans max(end - start + 1, 1) cells; bin i covers
    [floor(i * bin), ceil((i + 1) * bin)) of it in float32, clamped to the
    map, and an empty bin gives 0. ``max_roi_size`` (h, w) bounds the box
    at the feature scale, as in the JAX package (each bin gathers at most
    ceil(max / pooled) + 1 cells a side); by default the whole map.

    Arg(s): feat (N, C, H, W); boxes (N, K, 4). Returns (N * K, C,
    pooled_h, pooled_w). The boxes are pooled ROI_POOL_CHUNK at a time."""
    n, c, h_f, w_f = feat.shape
    k = boxes.shape[1]
    pooled_h, pooled_w = output_size
    if max_roi_size is None:
        max_roi_size = (h_f + 1, w_f + 1)
    device = feat.device

    coords = _round_half_away(boxes.to(device, torch.float32) *
                              spatial_scale).to(torch.int32)
    start_w, start_h, end_w, end_h = coords.unbind(-1)
    roi_w = torch.clamp_min(end_w - start_w + 1, 1)
    roi_h = torch.clamp_min(end_h - start_h + 1, 1)
    max_bin_h = int(math.ceil(max_roi_size[0] / pooled_h)) + 1
    max_bin_w = int(math.ceil(max_roi_size[1] / pooled_w)) + 1

    def bins(start, size, pooled, max_bin, limit):
        # a division by a tensor: by a Python number the card multiplies
        # by its reciprocal, which is not the JAX package's quotient
        b = size.float() / torch.full_like(size, pooled, dtype=torch.float32)
        i = torch.arange(pooled, dtype=torch.float32, device=device)
        s = torch.floor(i * b[..., None]).to(torch.int32)
        e = torch.ceil((i + 1.0) * b[..., None]).to(torch.int32)
        s = torch.clamp(s + start[..., None], 0, limit)
        e = torch.clamp(e + start[..., None], 0, limit)
        idx = s[..., None] + torch.arange(max_bin, dtype=torch.int32,
                                          device=device)
        return torch.clamp(idx, 0, limit - 1).long(), idx < e[..., None]

    ridx, rvalid = bins(start_h, roi_h, pooled_h, max_bin_h, h_f)
    cidx, cvalid = bins(start_w, roi_w, pooled_w, max_bin_w, w_f)
    neg_inf = torch.tensor(float('-inf'), dtype=feat.dtype, device=device)
    out = []
    for b_ in range(n):
        for k0 in range(0, k, ROI_POOL_CHUNK):
            rows = slice(k0, k0 + ROI_POOL_CHUNK)
            ri, rv = ridx[b_, rows], rvalid[b_, rows]
            ci, cv = cidx[b_, rows], cvalid[b_, rows]
            m = ri.shape[0]
            # (C, m, ph, Th, pw, Tw): rows, then columns, of each bin
            g = feat[b_][:, ri.reshape(m, -1)[:, :, None],
                         ci.reshape(m, -1)[:, None, :]]
            g = g.reshape(c, m, pooled_h, max_bin_h, pooled_w, max_bin_w)
            mask = rv[:, :, :, None, None] & cv[:, None, None, :, :]
            g = torch.where(mask, g, neg_inf).amax(dim=(3, 5))
            g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
            out.append(g.permute(1, 0, 2, 3))
    return torch.cat(out).reshape(n * k, c, pooled_h, pooled_w)
