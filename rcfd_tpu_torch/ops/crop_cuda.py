"""Batched column-window crop: the hand-written CUDA kernel, its wrapper and
its plain PyTorch version (counterpart of rcfd_tpu/ops/crop_pallas.py),
NCHW.

The variable-bin branch of the column ROI pool takes, for every radar point
k, the contiguous window ``rows[n, :, :, s_k : s_k + win]`` of the
row-pooled feature map of its image, with starts clipped to [0, W] and
zeros past W, and then its bin maxima over that window.

``batch_column_crop`` is the wrapper. On a CUDA tensor it launches the
kernel of ``csrc/column_crop.cu`` (built with nvcc at first use) or raises;
on a CPU tensor, and only there, it runs ``batch_column_crop_plain``.
``batch_column_crop.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .fused_skip import MAX_WINDOW_ELEMS, MAX_WINDOWS, gather_windows

SOURCE = 'column_crop.cu'

_fn = None


def _kernel():
    """The ctypes entry point of the kernel, built and bound at first use."""
    global _fn
    if _fn is None:
        from ._build import load_library
        fn = load_library(SOURCE).rcfd_column_crop
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 +
                       [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def batch_column_crop_plain(rows, starts, win: int):
    """Plain PyTorch version of the kernel: the rows padded with ``win``
    zero columns on the right, and the windows at the starts clipped to
    [0, W]."""
    w = rows.shape[3]
    starts = torch.clamp(starts.long(), 0, w)
    return gather_windows(F.pad(rows, (0, win)), starts, win)


def batch_column_crop(rows, starts, win: int):
    """Crop K contiguous column windows from each image's row-pooled map.

    Arg(s):
        rows : (N, C, ph, W) row-pooled feature map
        starts : (N, K) window starts, clipped to [0, W]; columns past W
            read as zeros
        win : window width
        On CUDA: float32 rows and int32 starts, contiguous, on one device.
    Returns:
        (N * K, C, ph, win) windows, image-major:
        ``out[n * K + k] == rows[n, :, :, s_k : s_k + win]``, zero past W.
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
    for name, t, dtype in (('rows', rows, torch.float32),
                           ('starts', starts, torch.int32)):
        if t.device != device:
            raise ValueError('{} is on {}, rows on {}'.format(
                name, t.device, device))
        if t.dtype != dtype:
            raise NotImplementedError(
                'the column crop kernel takes {} {}, got {} (bf16 is in the '
                'port queue of ROADMAP.md)'.format(dtype, name, t.dtype))
        if not t.is_contiguous():
            raise ValueError('the column crop kernel needs a contiguous '
                             '{}'.format(name))
    nk = n * starts.shape[1]
    if c * ph * win > MAX_WINDOW_ELEMS or not 1 <= nk <= MAX_WINDOWS:
        raise ValueError('batch_column_crop: {} windows of {} elements; the '
                         'kernel takes 1 to {} windows of at most {}'.format(
                             nk, c * ph * win, MAX_WINDOWS,
                             MAX_WINDOW_ELEMS))

    out = torch.empty((nk, c, ph, win), dtype=rows.dtype, device=device)
    fn = _kernel()
    with torch.cuda.device(device):
        err = fn(rows.data_ptr(), starts.data_ptr(), nk, starts.shape[1],
                 c * ph, w, win, out.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError('column crop kernel launch failed: CUDA error '
                           '{}'.format(err))
    batch_column_crop.launches += 1
    return out


batch_column_crop.launches = 0
