"""Batched column-window crop: the hand-written CUDA kernel, its wrapper and
its plain PyTorch version (counterpart of rcfd_tpu/ops/crop_pallas.py),
NCHW.

The variable-bin branch of the column ROI pool takes, for every radar point
k, the contiguous window ``rows[n, :, :, s_k : s_k + win]`` of the
row-pooled feature map of its image, with starts clipped to [0, W] and
zeros past W, and then its bin maxima over that window.

``batch_column_crop`` is the wrapper, for float32 or bf16 rows. On a CUDA
tensor it launches the kernel of ``csrc/column_crop.cu`` (built with nvcc
at first use) in the rows' dtype or raises; on a CPU tensor, and only
there, it runs ``batch_column_crop_plain``. ``batch_column_crop.launches``
counts the float32 instance's launches, ``batch_column_crop.launches_bf16``
the bf16 instance's. The bf16 instance stages row tiles in shared memory
(``fused_skip.row_tile``, which refuses a row too wide for it).

The crop is differentiable on both routes. On the CPU autograd
differentiates the plain version. On the card, where the rows need a
gradient, the launch runs inside ``ColumnCrop``, a torch.autograd.Function
whose backward is ``batch_column_crop_backward_plain``: each window's
gradient added into its rows' columns, those past W dropped. That is the
gradient of the JAX package's XLA formulation (rcfd_tpu/ops/roi_pool.py:
234-256), which has no backward kernel to port.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .fused_skip import (MAX_WINDOW_ELEMS, MAX_WINDOWS, gather_windows,
                         row_tile)

SOURCE = 'column_crop.cu'

# the C entry point of the kernel's instance for each dtype of the rows
ENTRIES = {torch.float32: 'rcfd_column_crop',
           torch.bfloat16: 'rcfd_column_crop_bf16'}
ARGTYPES = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 5 + \
    (ctypes.c_void_p,) * 2


def _kernel(dtype=torch.float32):
    """The ctypes entry point of the kernel's instance for ``dtype``, built
    and bound at first use."""
    return _build.bind(SOURCE, ENTRIES[dtype], ARGTYPES)


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
    zero padding, are dropped. One ``index_add_`` over the images' padded
    rows laid side by side, column ``n * (W + win) + s_k + j``, in at least
    float32: bf16 windows' gradients are summed in float32 and the sum
    rounded once to bf16. The JAX package's transpose of its XLA
    formulation adds them in bf16 one window after another; the rounded
    float32 sum is within one bf16 rounding of the exact sum, and within
    that sequence's own rounding error of JAX's. The order of the card's
    float32 atomics moves only the float32 sum's last bits, which the
    rounding to bf16 hides but where a sum lies at a rounding boundary."""
    n, c, ph, w = rows_shape
    k = starts.shape[1]
    span = w + win
    device = grad_windows.device
    cols = (torch.clamp(starts.long(), 0, w)[:, :, None] +
            torch.arange(win, device=device) +
            span * torch.arange(n, device=device)[:, None, None])
    # (N * K, C, ph, win) -> (C, ph, N * K * win), the order of cols
    acc = torch.promote_types(grad_windows.dtype, torch.float32)
    g = grad_windows.reshape(n, k, c, ph, win).permute(2, 3, 0, 1, 4)
    out = grad_windows.new_zeros((c, ph, n * span), dtype=acc)
    out.index_add_(2, cols.reshape(-1), g.reshape(c, ph, n * k * win).to(acc))
    return out.view(c, ph, n, span).permute(2, 0, 1, 3)[..., :w].to(
        grad_windows.dtype)


class ColumnCrop(torch.autograd.Function):
    """The crop on the card with its gradient in the rows (none in the
    starts): the kernel's launch forward, ``batch_column_crop_backward_plain``
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
        return (batch_column_crop_backward_plain(
            grad_windows, starts, ctx.rows_shape, ctx.win), None, None)


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
    device = rows.device
    if device.type == 'cpu':
        return batch_column_crop_plain(rows, starts, win)
    if device.type != 'cuda':
        raise ValueError('batch_column_crop runs on CUDA or CPU tensors, got '
                         '{}'.format(device))
    for name, t, dtypes in (('rows', rows, tuple(ENTRIES)),
                            ('starts', starts, (torch.int32,))):
        if t.device != device:
            raise ValueError('{} is on {}, rows on {}'.format(
                name, t.device, device))
        if t.dtype not in dtypes:
            raise NotImplementedError(
                'the column crop kernel takes {} {}, got {}'.format(
                    ' or '.join(map(str, dtypes)), name, t.dtype))
        if not t.is_contiguous():
            raise ValueError('the column crop kernel needs a contiguous '
                             '{}'.format(name))
    nk = n * starts.shape[1]
    if c * ph * win > MAX_WINDOW_ELEMS or not 1 <= nk <= MAX_WINDOWS:
        raise ValueError('batch_column_crop: {} windows of {} elements; the '
                         'kernel takes 1 to {} windows of at most {}'.format(
                             nk, c * ph * win, MAX_WINDOWS,
                             MAX_WINDOW_ELEMS))

    if rows.dtype == torch.bfloat16:
        row_tile(c * ph, w + win, n)  # raises if a row does not fit
    if rows.requires_grad and torch.is_grad_enabled():
        return ColumnCrop.apply(rows, starts, win)
    return _launch(rows, starts, win)


def _launch(rows, starts, win: int):
    """One launch of the kernel's instance for the rows' dtype on checked
    inputs, counted."""
    n, c, ph, w = rows.shape
    device = rows.device
    nk = n * starts.shape[1]
    out = torch.empty((nk, c, ph, win), dtype=rows.dtype, device=device)
    fn = _kernel(rows.dtype)
    with torch.cuda.device(device):
        err = fn(rows.data_ptr(), starts.data_ptr(), nk, starts.shape[1],
                 c * ph, w, win, out.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError('column crop kernel launch failed: CUDA error '
                           '{}'.format(err))
    _build.count_launch(batch_column_crop, rows.dtype)
    return out


batch_column_crop.launches = 0
batch_column_crop.launches_bf16 = 0
