"""Quasi-dense scatter: the hand-written CUDA kernel, its wrapper and its
plain PyTorch version (counterpart of rcfd_tpu/ops/scatter_pallas.py).

The function is the Pallas kernel's. Each point's thresholded response is
quantized to the response PNG codec's 14 bits and packed with its index
into one int32 key, ``(q << 16) | (65535 - k)``, so a plain max picks the
strongest response with the first point winning ties inside one 2^-14
step; invalid points write 0. The max is unpacked into the response and
the winner, and the legacy rewrite turns the winner into integer depth.

``scatter_quasi_dense`` is the wrapper. On a CUDA tensor it launches the
kernel of ``csrc/scatter_quasi_dense.cu`` (built with nvcc at first use)
or raises; on a CPU tensor, and only there, it runs
``scatter_quasi_dense_plain``. ``scatter_quasi_dense.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .scatter import legacy_rewrite

Q_BITS = 14
Q_SCALE = float(2 ** Q_BITS)
IDX_BITS = 16
MAX_POINTS = (1 << IDX_BITS) - 1
SOURCE = 'scatter_quasi_dense.cu'

_fn = None


def _kernel():
    """The ctypes entry point of the kernel, built and bound at first use."""
    global _fn
    if _fn is None:
        from ._build import load_library
        fn = load_library(SOURCE).rcfd_scatter_quasi_dense
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 +
                       [ctypes.c_float] + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def point_tables(x_positions, z_values, valid, pw: int, w: int):
    """Per-point int32 tables: the first padded column each window covers
    (the map carries a pw-column apron on each side, and the start is
    clipped to [0, w + pw] as in scatter_quasi_dense_pallas), the valid
    flag and the depth truncated toward zero."""
    pad = pw // 2
    x_start = x_positions.to(torch.int32) - 2 * pad + pw
    x_start = torch.clamp(x_start, 0, w + pw)
    return (x_start.contiguous(), valid.to(torch.int32).contiguous(),
            z_values.to(torch.int32).contiguous())


def packed_keys(response_crops, valid_i32, threshold: float = 0.5):
    """(K, ph, pw) int32 keys ``(min(trunc(v * 2^14), 2^14) << 16) |
    (65535 - k)`` with ``v = crop >= threshold ? crop : 0``; 0 for an
    invalid point."""
    k = response_crops.shape[0]
    crops = response_crops.float()
    vals = torch.where(crops < threshold, torch.zeros_like(crops), crops)
    q = torch.clamp_max(vals * Q_SCALE, Q_SCALE).to(torch.int32)
    idx = MAX_POINTS - torch.arange(k, dtype=torch.int32,
                                    device=crops.device)
    keys = (q << IDX_BITS) | idx[:, None, None]
    return torch.where(valid_i32[:, None, None] > 0, keys,
                       torch.zeros_like(keys))


def window_columns(x_start, pw: int):
    """(K, pw) padded columns covered by each point's window."""
    return x_start.long()[:, None] + torch.arange(pw,
                                                  device=x_start.device)


def scatter_quasi_dense_plain(response_crops, x_positions, z_values, valid,
                              image_height: int, image_width: int,
                              patch_size: Tuple[int, int],
                              threshold: float = 0.5):
    """Plain PyTorch version of the kernel: the same keys, their max over
    the points by ``scatter_reduce_(amax)`` into a map with a pw-column
    apron, then the same unpacking and legacy rewrite. Returns
    (depth_map, response_map), each (H, W) float32."""
    k, ph, pw = response_crops.shape
    h, w = image_height, image_width
    device = response_crops.device
    x_start, valid_i32, z_int = point_tables(x_positions, z_values, valid,
                                             pw, w)
    keys = packed_keys(response_crops, valid_i32, threshold)
    cols = window_columns(x_start, pw).reshape(1, k * pw).expand(ph, -1)
    packed = torch.zeros((ph, w + 2 * pw), dtype=torch.int32, device=device)
    packed.scatter_reduce_(1, cols, keys.permute(1, 0, 2).reshape(ph, -1),
                           'amax')
    packed = packed[:, pw:pw + w]

    response_q = (packed >> IDX_BITS).float() / Q_SCALE
    winner = torch.clamp_max(MAX_POINTS - (packed & MAX_POINTS), k)
    depth_rows = legacy_rewrite(winner, response_q, z_int, valid_i32, k)
    depth_map = torch.zeros((h, w), dtype=torch.float32, device=device)
    response_map = torch.zeros((h, w), dtype=torch.float32, device=device)
    depth_map[h - ph:] = depth_rows
    response_map[h - ph:] = response_q
    return depth_map, response_map


def scatter_quasi_dense(response_crops, x_positions, z_values, valid,
                        image_height: int, image_width: int,
                        patch_size: Tuple[int, int],
                        threshold: float = 0.5):
    """Scatter per-point response crops into quasi-dense maps.

    Arg(s):
        response_crops : (K, ph, pw) sigmoid responses
        x_positions : (K,) padded-coordinate x of each point (x + pw // 2)
        z_values : (K,) metric depth of each point
        valid : (K,) bool mask of the real (non-padding) points
        image_height, image_width : size of the unpadded frame
        patch_size : (ph, pw)
        On CUDA the four tensors must be contiguous, float32 (bool for
        valid), and on one device.
    Returns:
        depth_map, response_map : (H, W) float32 each; the crop rows are
        the bottom ph rows of the frame.
    """
    k, ph, pw = response_crops.shape
    h, w = image_height, image_width
    if tuple(patch_size) != (ph, pw):
        raise ValueError('patch_size {} does not match crops {}'.format(
            tuple(patch_size), tuple(response_crops.shape)))
    device = response_crops.device
    if device.type == 'cpu':
        return scatter_quasi_dense_plain(
            response_crops, x_positions, z_values, valid, h, w, patch_size,
            threshold)
    if device.type != 'cuda':
        raise ValueError('scatter_quasi_dense runs on CUDA or CPU tensors, '
                         'got {}'.format(device))
    for name, t, dtype in (('response_crops', response_crops, torch.float32),
                           ('x_positions', x_positions, torch.float32),
                           ('z_values', z_values, torch.float32),
                           ('valid', valid, torch.bool)):
        if t.device != device:
            raise ValueError('{} is on {}, the crops on {}'.format(
                name, t.device, device))
        if t.dtype != dtype:
            raise NotImplementedError(
                'the scatter kernel takes {} {}, got {} (other types, bf16 '
                'crops among them, are in the port queue of ROADMAP.md)'
                .format(dtype, name, t.dtype))
        if not t.is_contiguous():
            raise ValueError('the scatter kernel needs a contiguous '
                             '{}'.format(name))
    if tuple(x_positions.shape) != (k,) or tuple(z_values.shape) != (k,) \
            or tuple(valid.shape) != (k,):
        raise ValueError('x_positions, z_values and valid must be ({},)'
                         .format(k))
    if not 1 <= k <= MAX_POINTS:
        raise ValueError('the scatter kernel takes 1 <= K <= {}, got {}'
                         .format(MAX_POINTS, k))
    if not (0 < ph <= h and pw > 0 and w > 0):
        raise ValueError('bad shapes: crops {}, frame {}x{}'.format(
            tuple(response_crops.shape), h, w))

    depth_map = torch.empty((h, w), dtype=torch.float32, device=device)
    response_map = torch.empty((h, w), dtype=torch.float32, device=device)
    crop_top = h - ph
    if crop_top:
        depth_map[:crop_top].zero_()
        response_map[:crop_top].zero_()
    row_bytes = w * depth_map.element_size()
    fn = _kernel()
    with torch.cuda.device(device):
        err = fn(response_crops.data_ptr(), x_positions.data_ptr(),
                 z_values.data_ptr(), valid.data_ptr(), k, ph, pw, w,
                 threshold, depth_map.data_ptr() + crop_top * row_bytes,
                 response_map.data_ptr() + crop_top * row_bytes,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError('scatter kernel launch failed: CUDA error '
                           '{}'.format(err))
    scatter_quasi_dense.launches += 1
    return depth_map, response_map


scatter_quasi_dense.launches = 0
