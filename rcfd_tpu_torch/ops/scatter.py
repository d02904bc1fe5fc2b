"""Quasi-dense scatter with the exact float max, and the legacy rewrite
(counterpart of rcfd_tpu/ops/scatter.py).

``scatter_quasi_dense`` is the JAX package's default serving scatter: a
scatter-max of the thresholded crops into the response map, then a
scatter-min of the point index among the points whose response equals the
map's max exactly (so ties go to the smallest index, as torch.max's
argmax), then the legacy index -> depth rewrite. JAX computes it in XLA
outside any Pallas kernel, and so does the port, with ``scatter_reduce_``
on whatever device the tensors are on. The hand-written kernel of
``scatter_cuda.py`` is the other route (``PerfConfig(pallas_scatter=
True)``): it quantizes the response to 14 bits before the max.
"""

from __future__ import annotations

from typing import Tuple

import torch


def legacy_rewrite(idx_map, response_map, z_values, valid, n_points: int):
    """The reference's index -> z rewrite loop, bit for bit
    (src/radarnet_main.py:576-583, rcfd_tpu/ops/scatter.py:45).

    Each pixel starts at ``m = winner`` (0 where the response is 0); then
    for p = 0 .. n_points - 1, ``if valid[p] and m == p: m = trunc(z[p])``.
    The rewrites cascade: a depth written as an integer equal to a later
    point's index is rewritten again by that point. Padding points are
    skipped, as the reference loops over the real points only.

    For a batch of frames the maps are (B, ph, w) and z_values and valid
    (B, K), a table per frame.
    """
    z_int = z_values.to(torch.int32)  # truncation toward zero
    valid = valid.to(torch.bool)
    m = torch.where(response_map > 0, idx_map.to(torch.int32),
                    torch.zeros((), dtype=torch.int32,
                                device=idx_map.device))
    for p in range(n_points):
        m = torch.where(valid[..., p, None, None] & (m == p),
                        z_int[..., p, None, None], m)
    return torch.where(response_map > 0, m.to(response_map.dtype),
                       torch.zeros((), dtype=response_map.dtype,
                                   device=response_map.device))


def scatter_quasi_dense_batched(response_crops, x_positions, z_values,
                                valid, image_height: int, image_width: int,
                                patch_size: Tuple[int, int],
                                threshold: float = 0.5,
                                legacy_depth_semantics: bool = True):
    """The exact scatter over a batch of frames: crops (B, K, ph, pw) in
    float32 or bf16, x_positions (padded x, x + pw // 2), z_values and
    valid (B, K) -> depth_map, response_map (B, H, W) float32. Frame b's
    maps equal ``scatter_quasi_dense`` of frame b bit for bit.

    The max and the index min accumulate in the crops' dtype (a max and an
    equality are exact in any dtype); the maps come back float32. With
    ``legacy_depth_semantics=False`` the depth is the winner's float z
    instead of the legacy rewrite."""
    b, k, ph, pw = response_crops.shape
    if tuple(patch_size) != (ph, pw):
        raise ValueError('patch_size {} does not match crops {}'.format(
            tuple(patch_size), tuple(response_crops.shape)))
    h, w = image_height, image_width
    device = response_crops.device
    zero = torch.zeros((), dtype=response_crops.dtype, device=device)
    vals = torch.where(response_crops < threshold, zero, response_crops)
    vals = torch.where(valid.to(torch.bool)[..., None, None], vals, zero)
    # column of crop pixel (k, j) in the unpadded frame; those outside it
    # are clipped onto the edge with value 0, which a max over values >= 0
    # ignores
    cols = x_positions.to(torch.int32)[..., None] - 2 * (pw // 2) + \
        torch.arange(pw, dtype=torch.int32, device=device)
    in_bounds = (cols >= 0) & (cols < w)
    vals = torch.where(in_bounds[:, :, None, :], vals, zero)
    cols = cols.clamp(0, w - 1).long().reshape(b, 1, k * pw).expand(
        b, ph, k * pw)
    vals = vals.permute(0, 2, 1, 3).reshape(b, ph, k * pw)

    response = torch.zeros((b, ph, w), dtype=vals.dtype, device=device)
    response.scatter_reduce_(2, cols, vals, 'amax')
    # the winner: the smallest index whose value equals the max (> 0)
    current = response.gather(2, cols)
    k_idx = torch.arange(k, device=device).repeat_interleave(pw)
    candidate = torch.where((vals > 0) & (vals == current), k_idx,
                            torch.full((), k, device=device))
    idx = torch.full((b, ph, w), k, dtype=torch.long, device=device)
    idx.scatter_reduce_(2, cols, candidate, 'amin')

    response = response.float()
    if legacy_depth_semantics:
        depth = legacy_rewrite(idx, response, z_values, valid, k)
    else:
        z_ext = torch.cat([z_values.float(),
                           torch.zeros((b, 1), device=device)], 1)
        depth = torch.where(response > 0,
                            z_ext.gather(1, idx.reshape(b, -1)).reshape(
                                b, ph, w), torch.zeros((), device=device))
    depth_map = torch.zeros((b, h, w), dtype=torch.float32, device=device)
    response_map = torch.zeros((b, h, w), dtype=torch.float32,
                               device=device)
    depth_map[:, h - ph:] = depth
    response_map[:, h - ph:] = response
    return depth_map, response_map


def scatter_quasi_dense(response_crops, x_positions, z_values, valid,
                        image_height: int, image_width: int,
                        patch_size: Tuple[int, int], threshold: float = 0.5,
                        legacy_depth_semantics: bool = True):
    """The exact scatter of one frame (rcfd_tpu/ops/scatter.py
    ``scatter_quasi_dense``): crops (K, ph, pw), x_positions, z_values and
    valid (K,) -> depth_map, response_map (H, W) float32; the crop rows are
    the bottom ph rows of the frame."""
    depth_map, response_map = scatter_quasi_dense_batched(
        response_crops[None], x_positions[None], z_values[None], valid[None],
        image_height, image_width, patch_size, threshold,
        legacy_depth_semantics)
    return depth_map[0], response_map[0]
