"""Batched column-window crop: the hand-written CUDA kernels of the crop and
of its gradient, their wrappers and their plain PyTorch versions
(counterpart of rcfd_tpu/ops/crop_pallas.py), NCHW.

The variable-bin branch of the column ROI pool takes, for every radar point
k, the contiguous window ``rows[n, :, :, s_k : s_k + win]`` of the
row-pooled feature map of its image, with starts clipped to [0, W] and
zeros past W, and then its bin maxima over that window.

``batch_column_crop`` is the wrapper, for float32 or bf16 rows. On a CUDA
tensor it launches the kernel of ``csrc/column_crop.cu`` (built with nvcc
at first use) in the rows' dtype or raises; on a CPU tensor, and only
there, it runs ``batch_column_crop_plain``. ``batch_column_crop.launches``
counts the float32 instance's launches, ``batch_column_crop.launches_bf16``
the bf16 instance's. Both instances stage row tiles in shared memory
(``crop_tile``, which refuses a row too wide for it).

The crop is differentiable on both routes. On the CPU autograd
differentiates the plain version. On the card, where the rows need a
gradient, the launch runs inside ``ColumnCrop``, a torch.autograd.Function
whose backward is ``batch_column_crop_backward``: the kernel of
``csrc/column_crop_backward.cu``, counted by
``batch_column_crop_backward.launches`` / ``.launches_bf16``, which adds
each window's gradient into its rows' columns in window order, in float32,
and drops those past W. That is the gradient of the JAX package's XLA
formulation (rcfd_tpu/ops/roi_pool.py: 234-256), which has no backward
kernel to port; ``batch_column_crop_backward_plain`` is its plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .fused_skip import (MAX_WINDOW_ELEMS, MAX_WINDOWS, SMEM_LIMIT,
                         gather_windows, row_tile)

SOURCE = 'column_crop.cu'
BACKWARD_SOURCE = 'column_crop_backward.cu'

# the C entry point of each kernel's instance for each dtype of the rows
ENTRIES = {torch.float32: 'rcfd_column_crop',
           torch.bfloat16: 'rcfd_column_crop_bf16'}
BACKWARD_ENTRIES = {torch.float32: 'rcfd_column_crop_backward',
                    torch.bfloat16: 'rcfd_column_crop_backward_bf16'}
# both kernels: (input, starts, nk, k_per_image, n_rows, w, win, output,
# stream)
# a crop tile grows while its rows move at most this many bytes (csrc/
# column_crop.cu kBlockBytes)
BLOCK_BYTES = 32768
ARGTYPES = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 5 + \
    (ctypes.c_void_p,) * 2


def _kernel(dtype=torch.float32):
    """The ctypes entry point of the crop kernel's instance for ``dtype``,
    built and bound at first use."""
    return _build.bind(SOURCE, ENTRIES[dtype], ARGTYPES)


def _backward_kernel(dtype=torch.float32):
    """The ctypes entry point of the backward kernel's instance for
    ``dtype``, built and bound at first use."""
    return _build.bind(BACKWARD_SOURCE, BACKWARD_ENTRIES[dtype], ARGTYPES)


def crop_tile(n_rows: int, w: int, win: int, n_images: int,
              k_per_image: int, elem_bytes: int):
    """The crop kernel's launch geometry (``fused_skip.row_tile``): rows of
    w + win elements staged, w + K * win moved a row; ValueError when one
    row does not fit in shared memory."""
    return row_tile(n_rows, w + win, n_images, elem_bytes,
                    (w + k_per_image * win) * elem_bytes, BLOCK_BYTES)


def crop_bytes(rows, starts, win: int) -> int:
    """The bytes the crop must move, the bound of its kernel: each column of
    the rows that a window covers, read once (the windows' columns past W
    are zeros, read from nowhere), the windows written once, and the
    starts."""
    n, c, ph, w = rows.shape
    k = starts.shape[1]
    cols = torch.clamp(starts.long().cpu(), 0, w)[:, :, None] + \
        torch.arange(win)
    covered = torch.zeros((n, w + win), dtype=torch.bool)
    covered.scatter_(1, cols.reshape(n, k * win), True)
    read = int(covered[:, :w].sum())
    return rows.element_size() * c * ph * (read + n * k * win) + 4 * n * k


def crop_backward_bytes(rows, starts, win: int) -> int:
    """The bytes the crop's backward must move, the bound of its kernel: the
    windows' gradient at the columns below W read once (those past W, the
    forward's zero padding, are dropped unread), the rows' gradient written
    once, and the starts."""
    n, c, ph, w = rows.shape
    cols = torch.clamp(starts.long().cpu(), 0, w)[:, :, None] + \
        torch.arange(win)
    return rows.element_size() * c * ph * (int((cols < w).sum()) + n * w) + \
        4 * starts.numel()


def batch_column_crop_plain(rows, starts, win: int):
    """Plain PyTorch version of the kernel: the rows padded with ``win``
    zero columns on the right, and the windows at the starts clipped to
    [0, W]."""
    w = rows.shape[3]
    starts = torch.clamp(starts.long(), 0, w)
    return gather_windows(F.pad(rows, (0, win)), starts, win)


def batch_column_crop_backward_plain(grad_windows, starts, rows_shape,
                                     win: int):
    """The gradient of the crop in the rows: ``grad_windows`` (N * K, C, ph,
    win), image-major, added into zeros of ``rows_shape`` (N, C, ph, W) at
    columns ``s_k .. s_k + win - 1`` of each window's image (starts clipped
    to [0, W] as the forward clips them); the columns past W, the forward's
    zero padding, are dropped. One window of every image at a time, in
    ascending k, into a float32 (or wider) buffer padded to W + win columns,
    then the slice and one cast: bf16 windows' gradients are summed in
    float32 and the sum rounded once to bf16. Within one window the columns
    are distinct, so each scatter_add_ adds once into each element and the
    order is k's on any device; the kernel adds in the same order, bit for
    bit. The JAX package's transpose of its XLA formulation adds bf16
    gradients in bf16, one window after another; the rounded float32 sum is
    within one bf16 rounding of the exact sum, and within that sequence's
    own rounding error of JAX's."""
    n, c, ph, w = rows_shape
    k = starts.shape[1]
    device = grad_windows.device
    acc = torch.promote_types(grad_windows.dtype, torch.float32)
    g = grad_windows.reshape(n, k, c, ph, win)
    cols = (torch.clamp(starts.long(), 0, w)[:, :, None] +
            torch.arange(win, device=device))
    out = torch.zeros((n, c, ph, w + win), dtype=acc, device=device)
    for j in range(k):
        index = cols[:, j, None, None, :].expand(n, c, ph, win)
        out.scatter_add_(3, index, g[:, j].to(acc))
    return out[..., :w].to(grad_windows.dtype)


def batch_column_crop_backward(grad_windows, starts, rows_shape, win: int):
    """The crop's gradient in the rows, ``batch_column_crop_backward_plain``'s
    function: on a CUDA tensor one launch of the backward kernel in the
    gradient's dtype (float32 or bf16; contiguous, with int32 starts on the
    same device), counted, or an error; on a CPU tensor, and only there, the
    plain version."""
    if grad_windows.device.type == 'cpu':
        return batch_column_crop_backward_plain(grad_windows, starts,
                                                rows_shape, win)
    n, c, ph, w = rows_shape
    k = starts.shape[1]
    if starts.dim() != 2 or starts.shape[0] != n or \
            tuple(grad_windows.shape) != (n * k, c, ph, win):
        raise ValueError('batch_column_crop_backward: gradient {}, starts {} '
                         'do not fit rows {} and win {}'.format(
                             tuple(grad_windows.shape), tuple(starts.shape),
                             tuple(rows_shape), win))
    device = _check_cuda_inputs('column crop backward', 'gradient',
                                grad_windows, starts, BACKWARD_ENTRIES)
    if 4 * w > SMEM_LIMIT:
        raise ValueError('the column crop backward kernel sums a row of {} '
                         'columns in float32 in shared memory; at most {} '
                         'fit'.format(w, SMEM_LIMIT // 4))
    out = torch.empty(rows_shape, dtype=grad_windows.dtype, device=device)
    _run(_backward_kernel(grad_windows.dtype), 'column crop backward',
         grad_windows, starts, n * k, k, c * ph, w, win, out)
    _build.count_launch(batch_column_crop_backward, grad_windows.dtype)
    return out


class ColumnCrop(torch.autograd.Function):
    """The crop on the card with its gradient in the rows (none in the
    starts): a launch of the crop kernel forward, of the backward kernel
    backward. It saves the starts and the rows' shape, never the rows."""

    @staticmethod
    def forward(ctx, rows, starts, win):
        ctx.save_for_backward(starts)
        ctx.rows_shape = tuple(rows.shape)
        ctx.win = win
        return _launch(rows, starts, win)

    @staticmethod
    def backward(ctx, grad_windows):
        starts, = ctx.saved_tensors
        return (batch_column_crop_backward(
            grad_windows.contiguous(), starts, ctx.rows_shape, ctx.win),
            None, None)


def batch_column_crop(rows, starts, win: int):
    """Crop K contiguous column windows from each image's row-pooled map.

    Arg(s):
        rows : (N, C, ph, W) row-pooled feature map
        starts : (N, K) window starts, clipped to [0, W]; columns past W
            read as zeros
        win : window width
        On CUDA: float32 or bf16 rows and int32 starts, contiguous, on one
        device.
    Returns:
        (N * K, C, ph, win) windows, image-major:
        ``out[n * K + k] == rows[n, :, :, s_k : s_k + win]``, zero past W;
        with a gradient in ``rows`` where they need one and autograd is on
        (on the card through ``ColumnCrop``; a crop that needs none records
        no graph).
    """
    n, c, ph, w = rows.shape
    if starts.dim() != 2 or starts.shape[0] != n or win < 1:
        raise ValueError('batch_column_crop: rows {}, starts {}, win {} do '
                         'not fit'.format(tuple(rows.shape),
                                          tuple(starts.shape), win))
    if rows.device.type == 'cpu':
        return batch_column_crop_plain(rows, starts, win)
    _check_cuda_inputs('column crop', 'rows', rows, starts, ENTRIES)
    nk = n * starts.shape[1]
    if c * ph * win > MAX_WINDOW_ELEMS or not 1 <= nk <= MAX_WINDOWS:
        raise ValueError('batch_column_crop: {} windows of {} elements; the '
                         'kernel takes 1 to {} windows of at most {}'.format(
                             nk, c * ph * win, MAX_WINDOWS,
                             MAX_WINDOW_ELEMS))

    crop_tile(c * ph, w, win, n, starts.shape[1],
              rows.element_size())  # raises if a row does not fit
    if rows.requires_grad and torch.is_grad_enabled():
        return ColumnCrop.apply(rows, starts, win)
    return _launch(rows, starts, win)


def _check_cuda_inputs(what, data_name, data, starts, entries):
    """Raise unless ``data`` (of a dtype of ``entries``) and int32 ``starts``
    are contiguous CUDA tensors on one device; returns that device."""
    device = data.device
    if device.type != 'cuda':
        raise ValueError('the {} runs on CUDA or CPU tensors, got {}'.format(
            what, device))
    for name, t, dtypes in ((data_name, data, tuple(entries)),
                            ('starts', starts, (torch.int32,))):
        if t.device != device:
            raise ValueError('{} is on {}, {} on {}'.format(
                name, t.device, data_name, device))
        if t.dtype not in dtypes:
            raise NotImplementedError(
                'the {} kernel takes {} {}, got {}'.format(
                    what, ' or '.join(map(str, dtypes)), name, t.dtype))
        if not t.is_contiguous():
            raise ValueError('the {} kernel needs a contiguous {}'.format(
                what, name))
    return device


def _run(fn, what, data, starts, nk, k_per_image, n_rows, w, win, out):
    """One call of a kernel's C entry point on the current stream of the
    data's device; raises on a failed launch."""
    device = data.device
    with torch.cuda.device(device):
        err = fn(data.data_ptr(), starts.data_ptr(), nk, k_per_image, n_rows,
                 w, win, out.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError('{} kernel launch failed: CUDA error {}'.format(
            what, err))


def _launch(rows, starts, win: int):
    """One launch of the crop kernel's instance for the rows' dtype on
    checked inputs, counted."""
    n, c, ph, w = rows.shape
    nk = n * starts.shape[1]
    out = torch.empty((nk, c, ph, win), dtype=rows.dtype, device=rows.device)
    _run(_kernel(rows.dtype), 'column crop', rows, starts, nk,
         starts.shape[1], c * ph, w, win, out)
    _build.count_launch(batch_column_crop, rows.dtype)
    return out


batch_column_crop.launches = 0
batch_column_crop.launches_bf16 = 0
batch_column_crop_backward.launches = 0
batch_column_crop_backward.launches_bf16 = 0
