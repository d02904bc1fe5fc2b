"""Quasi-dense scatter: the hand-written CUDA kernel, its wrapper and its
plain PyTorch version (counterpart of rcfd_tpu/ops/scatter_pallas.py).

The function is the Pallas kernel's. Each point's thresholded response is
quantized to the response PNG codec's 14 bits and packed with its index
into one int32 key, ``(q << 16) | (65535 - k)``, so a plain max picks the
strongest response with the first point winning ties inside one 2^-14
step; invalid points write 0. The max is unpacked into the response and
the winner, and the legacy rewrite turns the winner into integer depth.

``scatter_quasi_dense_batched`` (a batch of frames in one launch) is the
wrapper, and ``scatter_quasi_dense`` its case of one frame. The crops are
float32 or bf16 (bf16 serving); the point tables stay float32. On a CUDA
tensor it launches the kernel of ``csrc/scatter_quasi_dense.cu`` (built
with nvcc at first use), its instance for the crops' dtype, or raises; on a
CPU tensor, and only there, it runs its plain version,
``scatter_quasi_dense_batched_plain`` (of one frame:
``scatter_quasi_dense_plain``), which widens bf16 crops to float32 exactly.
``scatter_quasi_dense.launches`` counts the float32 instance's launches and
``scatter_quasi_dense.launches_bf16`` the bf16 instance's, by either entry.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .scatter import legacy_rewrite

Q_BITS = 14
Q_SCALE = float(2 ** Q_BITS)
IDX_BITS = 16
MAX_POINTS = (1 << IDX_BITS) - 1
# frames of one launch: the grid's second dimension
MAX_FRAMES = 65535
SOURCE = 'scatter_quasi_dense.cu'

# the C entry point of the kernel's instance for each dtype of the crops
ENTRIES = {torch.float32: 'rcfd_scatter_quasi_dense',
           torch.bfloat16: 'rcfd_scatter_quasi_dense_bf16'}
ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + \
    (ctypes.c_float,) + (ctypes.c_void_p,) * 2 + \
    (ctypes.c_longlong, ctypes.c_void_p)


def _kernel(dtype=torch.float32):
    """The ctypes entry point of the kernel's instance for crops of
    ``dtype``, built and bound at first use."""
    return _build.bind(SOURCE, ENTRIES[dtype], ARGTYPES)


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
    """(..., K, ph, pw) int32 keys ``(min(trunc(v * 2^14), 2^14) << 16) |
    (65535 - k)`` with ``v = crop >= threshold ? crop : 0``; 0 for an
    invalid point."""
    k = response_crops.shape[-3]
    crops = response_crops.float()
    vals = torch.where(crops < threshold, torch.zeros_like(crops), crops)
    q = torch.clamp_max(vals * Q_SCALE, Q_SCALE).to(torch.int32)
    idx = MAX_POINTS - torch.arange(k, dtype=torch.int32,
                                    device=crops.device)
    keys = (q << IDX_BITS) | idx[:, None, None]
    return torch.where(valid_i32[..., None, None] > 0, keys,
                       torch.zeros_like(keys))


def window_columns(x_start, pw: int):
    """(..., K, pw) padded columns covered by each point's window."""
    return x_start.long()[..., None] + torch.arange(pw,
                                                    device=x_start.device)


def scatter_quasi_dense_batched_plain(response_crops, x_positions, z_values,
                                      valid, image_height: int,
                                      image_width: int,
                                      patch_size: Tuple[int, int],
                                      threshold: float = 0.5):
    """Plain PyTorch version of the kernel over a batch of frames: the same
    keys, their max over each frame's points by one ``scatter_reduce_
    (amax)`` into (B, ph, w + 2 pw) maps with a pw-column apron, then the
    same unpacking and legacy rewrite. Returns (depth_map, response_map),
    each (B, H, W) float32."""
    b, k, ph, pw = response_crops.shape
    h, w = image_height, image_width
    device = response_crops.device
    x_start, valid_i32, z_int = point_tables(x_positions, z_values, valid,
                                             pw, w)
    keys = packed_keys(response_crops, valid_i32, threshold)
    cols = window_columns(x_start, pw).reshape(b, 1, k * pw).expand(
        -1, ph, -1)
    packed = torch.zeros((b, ph, w + 2 * pw), dtype=torch.int32,
                         device=device)
    packed.scatter_reduce_(2, cols,
                           keys.permute(0, 2, 1, 3).reshape(b, ph, -1),
                           'amax')
    packed = packed[..., pw:pw + w]

    response_q = (packed >> IDX_BITS).float() / Q_SCALE
    winner = torch.clamp_max(MAX_POINTS - (packed & MAX_POINTS), k)
    depth_rows = legacy_rewrite(winner, response_q, z_int, valid_i32, k)
    depth_map = torch.zeros((b, h, w), dtype=torch.float32, device=device)
    response_map = torch.zeros((b, h, w), dtype=torch.float32,
                               device=device)
    depth_map[:, h - ph:] = depth_rows
    response_map[:, h - ph:] = response_q
    return depth_map, response_map


def scatter_quasi_dense_plain(response_crops, x_positions, z_values, valid,
                              image_height: int, image_width: int,
                              patch_size: Tuple[int, int],
                              threshold: float = 0.5):
    """Plain PyTorch version of the kernel for one frame: the batched plain
    version over a batch of one. Returns (depth_map, response_map), each
    (H, W) float32."""
    depth_map, response_map = scatter_quasi_dense_batched_plain(
        response_crops[None], x_positions[None], z_values[None], valid[None],
        image_height, image_width, patch_size, threshold)
    return depth_map[0], response_map[0]


def _check_cuda_inputs(response_crops, x_positions, z_values, valid):
    """The kernel's demands on its CUDA inputs: one device, float32 or bf16
    crops, float32 x and z, bool valid, contiguous, tables shaped as the
    crops' leading dimensions."""
    device = response_crops.device
    if device.type != 'cuda':
        raise ValueError('the scatter runs on CUDA or CPU tensors, got '
                         '{}'.format(device))
    for name, t, dtypes in (('response_crops', response_crops,
                             tuple(ENTRIES)),
                            ('x_positions', x_positions, (torch.float32,)),
                            ('z_values', z_values, (torch.float32,)),
                            ('valid', valid, (torch.bool,))):
        if t.device != device:
            raise ValueError('{} is on {}, the crops on {}'.format(
                name, t.device, device))
        if t.dtype not in dtypes:
            raise NotImplementedError(
                'the scatter kernel takes {} {}, got {}'.format(
                    ' or '.join(map(str, dtypes)), name, t.dtype))
        if not t.is_contiguous():
            raise ValueError('the scatter kernel needs a contiguous '
                             '{}'.format(name))
    lead = tuple(response_crops.shape[:-2])
    if tuple(x_positions.shape) != lead or tuple(z_values.shape) != lead \
            or tuple(valid.shape) != lead:
        raise ValueError('x_positions, z_values and valid must be {}, got '
                         '{}, {}, {}'.format(lead, tuple(x_positions.shape),
                                             tuple(z_values.shape),
                                             tuple(valid.shape)))


def _launch(response_crops, x_positions, z_values, valid, h, w, threshold):
    """Launch the kernel over (B, K, ph, pw) crops; returns (B, H, W)
    maps."""
    b, k, ph, pw = response_crops.shape
    if not 1 <= k <= MAX_POINTS:
        raise ValueError('the scatter kernel takes 1 <= K <= {}, got {}'
                         .format(MAX_POINTS, k))
    if not 1 <= b <= MAX_FRAMES:
        raise ValueError('the scatter kernel takes 1 <= B <= {} frames, '
                         'got {}'.format(MAX_FRAMES, b))
    if not (0 < ph <= h and pw > 0 and w > 0):
        raise ValueError('bad shapes: crops {}, frame {}x{}'.format(
            tuple(response_crops.shape), h, w))
    device = response_crops.device
    depth_map = torch.empty((b, h, w), dtype=torch.float32, device=device)
    response_map = torch.empty((b, h, w), dtype=torch.float32,
                               device=device)
    crop_top = h - ph
    if crop_top:
        depth_map[:, :crop_top].zero_()
        response_map[:, :crop_top].zero_()
    row_bytes = w * depth_map.element_size()
    fn = _kernel(response_crops.dtype)
    with torch.cuda.device(device):
        err = fn(response_crops.data_ptr(), x_positions.data_ptr(),
                 z_values.data_ptr(), valid.data_ptr(), b, k, ph, pw, w,
                 threshold, depth_map.data_ptr() + crop_top * row_bytes,
                 response_map.data_ptr() + crop_top * row_bytes, h * w,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError('scatter kernel launch failed: CUDA error '
                           '{}'.format(err))
    _build.count_launch(scatter_quasi_dense, response_crops.dtype)
    return depth_map, response_map


def _check_patch(response_crops, patch_size):
    if tuple(patch_size) != tuple(response_crops.shape[-2:]):
        raise ValueError('patch_size {} does not match crops {}'.format(
            tuple(patch_size), tuple(response_crops.shape)))


def scatter_quasi_dense(response_crops, x_positions, z_values, valid,
                        image_height: int, image_width: int,
                        patch_size: Tuple[int, int],
                        threshold: float = 0.5):
    """Scatter per-point response crops into quasi-dense maps: one frame
    through ``scatter_quasi_dense_batched``.

    Arg(s):
        response_crops : (K, ph, pw) sigmoid responses, float32 or bf16
        x_positions : (K,) padded-coordinate x of each point (x + pw // 2)
        z_values : (K,) metric depth of each point
        valid : (K,) bool mask of the real (non-padding) points
        image_height, image_width : size of the unpadded frame
        patch_size : (ph, pw)
        On CUDA the four tensors must be contiguous, float32 (bf16 crops
        too; bool for valid), and on one device.
    Returns:
        depth_map, response_map : (H, W) float32 each; the crop rows are
        the bottom ph rows of the frame.
    """
    if response_crops.dim() != 3:
        raise ValueError('crops must be (K, ph, pw), got {}'.format(
            tuple(response_crops.shape)))
    depth_map, response_map = scatter_quasi_dense_batched(
        response_crops[None], x_positions[None], z_values[None], valid[None],
        image_height, image_width, patch_size, threshold)
    return depth_map[0], response_map[0]


scatter_quasi_dense.launches = 0
scatter_quasi_dense.launches_bf16 = 0


def scatter_quasi_dense_batched(response_crops, x_positions, z_values,
                                valid, image_height: int, image_width: int,
                                patch_size: Tuple[int, int],
                                threshold: float = 0.5):
    """``scatter_quasi_dense`` over a batch of frames, one kernel launch
    for all of them: crops (B, K, ph, pw), x_positions, z_values and valid
    (B, K) -> depth_map, response_map (B, H, W). Frame b's maps equal
    ``scatter_quasi_dense`` of frame b's inputs bit for bit. The same
    demands on CUDA tensors; B and K up to 65,535."""
    if response_crops.dim() != 4:
        raise ValueError('crops must be (B, K, ph, pw), got {}'.format(
            tuple(response_crops.shape)))
    _check_patch(response_crops, patch_size)
    if response_crops.device.type == 'cpu':
        return scatter_quasi_dense_batched_plain(
            response_crops, x_positions, z_values, valid, image_height,
            image_width, patch_size, threshold)
    _check_cuda_inputs(response_crops, x_positions, z_values, valid)
    return _launch(response_crops, x_positions, z_values, valid,
                   image_height, image_width, threshold)
