"""Depth-map rasterization and the z-buffer merge of stage 0 (counterpart of
rcfd_tpu/geometry/rasterize.py).

Projected points go into an (H, W) map by a scatter-min on ``device``:
duplicate pixels keep the nearest depth, which is order-free, so the
card's atomics give the same map as the CPU. Masked points write +inf
into a buffer of +inf, and every pixel left at +inf becomes 0.

A masked point's +inf goes to a pixel of its own (its index modulo H*W),
not to its pixel clipped into the frame: min(z, +inf) = z wherever it
lands, and on the card the ~1.4 M empty pixels of a reprojected map would
otherwise all write into the one pixel their lifted origin projects to,
one float atomic after another (some 0.3 ms of a 900x1600 merge on an
H100).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from .transforms import _on

# coordinates are clamped to this before the cast to int32, so that a point
# far off the frame stays off it (and the cast stays defined)
_COORD_LIMIT = float(2 ** 30)


def _pixel_index(c, quantize_round: bool):
    """Round half to even (np.round, jnp.round) or truncate toward zero,
    then int32; NaN becomes 0, as XLA's conversion gives it."""
    if quantize_round:
        c = torch.round(c)
    c = torch.nan_to_num(c, nan=0.0).clamp(-_COORD_LIMIT, _COORD_LIMIT)
    return c.to(torch.int32)


def points_to_depth_map(xy, depth, mask, image_height: int,
                        image_width: int, quantize_round: bool = True,
                        device=None) -> torch.Tensor:
    """Scatter (N, 2) projected points into an (H, W) depth map on
    ``device``. Duplicate pixels keep the minimum depth; masked points and
    points off the frame are ignored (``mask`` None masks nothing)."""
    device = default_device(device)
    xy = _on(xy, device)
    depth = _on(depth, device)
    xi = _pixel_index(xy[..., 0], quantize_round)
    yi = _pixel_index(xy[..., 1], quantize_round)
    use = (xi >= 0) & (xi < image_width) & (yi >= 0) & (yi < image_height)
    if mask is not None:
        use = use & _on(mask, device, torch.bool)
    vals = torch.where(use, depth, torch.full_like(depth, float('inf')))
    n_pixels = image_height * image_width
    index = yi.long() * image_width + xi.long()
    own = torch.arange(index.numel(), device=device).view(index.shape) % \
        n_pixels
    zbuf = torch.full((n_pixels,), float('inf'), dtype=depth.dtype,
                      device=device)
    zbuf.scatter_reduce_(0, torch.where(use, index, own).reshape(-1),
                         vals.reshape(-1), 'amin', include_self=True)
    zbuf = zbuf.view(image_height, image_width)
    return torch.where(torch.isfinite(zbuf), zbuf, torch.zeros_like(zbuf))


def keep_nearer(main_depth_map, incoming) -> torch.Tensor:
    """The reference's occlusion rule: fill empty pixels, keep the nearer
    depth where both are set."""
    valid_main = main_depth_map > 0
    valid_in = incoming > 0
    return torch.where(valid_main & valid_in,
                       torch.minimum(main_depth_map, incoming),
                       torch.where(valid_in, incoming, main_depth_map))


def z_buffer_merge(main_depth_map, xy, depth, mask,
                   device=None) -> torch.Tensor:
    """Merge projected points into an existing depth map: write where the
    pixel is empty or the new depth is strictly nearer."""
    device = default_device(device)
    main_depth_map = _on(main_depth_map, device)
    h, w = main_depth_map.shape
    incoming = points_to_depth_map(xy, depth, mask, h, w, device=device)
    return keep_nearer(main_depth_map, incoming)


def zero_boxes(depth_map, boxes_np) -> np.ndarray:
    """Zero axis-aligned pixel boxes [min_x, min_y, max_x, max_y] (mover
    removal), on the host: a copy of the map as numpy."""
    out = np.array(depth_map.cpu() if torch.is_tensor(depth_map)
                   else depth_map)
    for (min_x, min_y, max_x, max_y) in boxes_np:
        out[int(min_y):int(max_y), int(min_x):int(max_x)] = 0
    return out


def zero_mask(depth_map, mover_mask, device=None) -> torch.Tensor:
    """Zero the mover pixels of a boolean H x W (panoptic) mask."""
    device = default_device(device)
    depth_map = _on(depth_map, device)
    return torch.where(_on(mover_mask, device, torch.bool),
                       torch.zeros_like(depth_map), depth_map)


def depth_map_to_points(depth_map):
    """The nonzero pixels of an (H, W) map as host arrays (xs, ys, zs), in
    row-major order (np.nonzero's)."""
    dm = depth_map.cpu().numpy() if torch.is_tensor(depth_map) \
        else np.asarray(depth_map)
    ys, xs = np.nonzero(dm)
    return xs, ys, dm[ys, xs]
