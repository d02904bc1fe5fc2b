"""Depth-map reprojection and the multi-frame merge of stage 0 (counterpart
of rcfd_tpu/geometry/reproject.py).

One neighbor frame's step of the reference's multi-frame ground truth, with
static shapes over the pixel grid on ``device``: every pixel of the
neighbor's depth map is lifted into its camera (empty pixels masked),
moved into the main camera, projected, masked and scatter-min merged.
"""

from __future__ import annotations

import torch

from .. import default_device
from .rasterize import keep_nearer, points_to_depth_map
from .transforms import _on, backproject_to_camera, transform_points, \
    view_points


def depth_map_pixel_grid(height: int, width: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """(H*W, 2) pixel coordinates as (x, y), row-major (indexing 'ij')."""
    device = default_device(device)
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device), indexing='ij')
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def reprojected_points(src_depth_map, src_intrinsics, src_to_dst_matrix,
                       dst_intrinsics, dst_height: int, dst_width: int,
                       src_mover_mask=None,
                       min_distance_from_camera: float = 1.0, device=None):
    """Every source pixel in the destination camera: (x (H_s*W_s,), y, z,
    mask), where the mask holds the pixels with depth > 0 that land in the
    destination frame (strictly: z > min_distance_from_camera, 1 < x <
    W_d - 1, 1 < y < H_d - 1). Source movers are zeroed first."""
    device = default_device(device)
    depth = _on(src_depth_map, device)
    h_s, w_s = depth.shape
    if src_mover_mask is not None:
        depth = torch.where(_on(src_mover_mask, device, torch.bool),
                            torch.zeros_like(depth), depth)
    xy = depth_map_pixel_grid(h_s, w_s, depth.dtype, device)
    z = depth.reshape(-1)
    valid = z > 0

    points_src = backproject_to_camera(xy, z, src_intrinsics, device)
    points_dst = transform_points(points_src, src_to_dst_matrix, device)

    z_dst = points_dst[:, 2]
    proj = view_points(points_dst, dst_intrinsics, True, device)
    x, y = proj[:, 0], proj[:, 1]
    mask = valid & (z_dst > min_distance_from_camera) & \
        (x > 1) & (x < dst_width - 1) & (y > 1) & (y < dst_height - 1)
    return x, y, z_dst, mask


def reproject_depth_map(src_depth_map, src_intrinsics, src_to_dst_matrix,
                        dst_intrinsics, dst_height: int, dst_width: int,
                        src_mover_mask=None, dst_mover_mask=None,
                        min_distance_from_camera: float = 1.0,
                        device=None) -> torch.Tensor:
    """Reproject a source camera's (H_s, W_s) metric depth map into a
    destination camera: an (H_d, W_d) map, 0 where no point lands.

    src_intrinsics / dst_intrinsics are 3x3 K matrices, src_to_dst_matrix
    the 4x4 rigid transform from the source camera to the destination.
    ``src_mover_mask`` (H_s, W_s) bool zeroes source movers before the
    lift; ``dst_mover_mask`` (H_d, W_d) drops the points that land on
    destination movers."""
    device = default_device(device)
    x, y, z_dst, mask = reprojected_points(
        src_depth_map, src_intrinsics, src_to_dst_matrix, dst_intrinsics,
        dst_height, dst_width, src_mover_mask, min_distance_from_camera,
        device)
    out = points_to_depth_map(torch.stack([x, y], dim=-1), z_dst, mask,
                              dst_height, dst_width, device=device)
    if dst_mover_mask is not None:
        out = torch.where(_on(dst_mover_mask, device, torch.bool),
                          torch.zeros_like(out), out)
    return out


def merge_neighbor_into_main(main_depth_map, neighbor_depth_map,
                             neighbor_intrinsics, neighbor_to_main_matrix,
                             main_intrinsics, neighbor_mover_mask=None,
                             main_mover_mask=None,
                             min_distance_from_camera: float = 1.0,
                             device=None) -> torch.Tensor:
    """One step of the reference's multi-frame merge: reproject a neighbor
    frame into the main camera and z-buffer merge it (fill empty pixels,
    keep the nearer depth)."""
    device = default_device(device)
    main_depth_map = _on(main_depth_map, device)
    h, w = main_depth_map.shape
    reprojected = reproject_depth_map(
        neighbor_depth_map, neighbor_intrinsics, neighbor_to_main_matrix,
        main_intrinsics, h, w, src_mover_mask=neighbor_mover_mask,
        dst_mover_mask=main_mover_mask,
        min_distance_from_camera=min_distance_from_camera, device=device)
    return keep_nearer(main_depth_map, reprojected)
