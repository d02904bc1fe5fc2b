"""ROI max pooling for the radar column boxes (counterpart of
rcfd_tpu/ops/roi_pool.py), NCHW.

Every box is a full-height, fixed-width column window around a radar
point, with torchvision.ops.roi_pool's bin arithmetic:
``roi_start = round(coord * scale)``, ``roi_size = max(end - start + 1, 1)``,
bin j covers ``[floor(j * bin), ceil((j + 1) * bin))`` in float32, clamped
to the map; empty bins give 0.

Only the constant-bin branch is ported. When ``box_width * scale`` is an
integer equal to ``pooled_w`` (every scale of the canonical 288-wide
patch), each bin is exactly ``[j, j + 2)``, so the pool is a
box-independent 2-tap column max followed by a contiguous window per box.
The variable-bin branch, which the JAX package serves with its Pallas crop
kernel, raises NotImplementedError.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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


def roi_pool_column(feat, x1, box_width: int, box_y1: int, box_y2: int,
                    spatial_scale: float, output_size: Tuple[int, int]):
    """ROI max pool of full-height, fixed-width column boxes.

    Arg(s):
        feat : (N, C, H_f, W_f) feature map
        x1 : (N, K) left box edges in input coordinates (x2 = x1 + box_width)
        box_width : static box width in input coordinates
        box_y1, box_y2 : static vertical box extent in input coordinates
        spatial_scale : feature scale (e.g. 1/32)
        output_size : (pooled_h, pooled_w)
    Returns:
        (N * K, C, pooled_h, pooled_w), image-major like torchvision.ops.roi_pool
    """
    n, c, h_f, w_f = feat.shape
    k = x1.shape[1]
    pooled_h, pooled_w = output_size
    bw_scaled = box_width * spatial_scale
    if not (float(bw_scaled).is_integer() and pooled_w == int(bw_scaled)
            and _bins_are_j_j2(pooled_w)):
        raise NotImplementedError(
            'roi_pool_column: only the constant-bin branch is ported '
            '(box_width * spatial_scale == pooled_w); the variable-bin '
            'branch and its crop kernel are in the port queue of ROADMAP.md')

    rows = pool_rows_static(feat, box_y1, box_y2, spatial_scale, pooled_h)
    # right tap rows[..., w + 1], -inf past the map; then -inf past w_f
    # so bins wholly beyond the map give 0 like empty bins
    neg_inf = torch.full_like(rows[..., :1], float('-inf'))
    g = torch.maximum(rows, torch.cat([rows[..., 1:], neg_inf], dim=3))
    g = torch.cat([g, neg_inf.expand(-1, -1, -1, pooled_w)], dim=3)

    start = _round_half_away(x1.float() * spatial_scale).to(torch.int64)
    start = torch.clamp(start, 0, w_f)                        # (N, K)
    cols = start[:, :, None] + torch.arange(pooled_w, device=feat.device)
    pooled = torch.stack([g[i][:, :, cols[i]] for i in range(n)])
    # (N, C, ph, K, pw) -> (N * K, C, ph, pw)
    pooled = pooled.permute(0, 3, 1, 2, 4).reshape(n * k, c, pooled_h,
                                                   pooled_w)
    return torch.where(torch.isfinite(pooled), pooled,
                       torch.zeros_like(pooled))
