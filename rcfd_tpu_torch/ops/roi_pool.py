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

    bin_w = roi_width.float() / pooled_w                         # (N, K)
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
