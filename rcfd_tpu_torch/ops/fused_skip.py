"""The deferred column ROI pool and the fused skip gather-add: the
hand-written CUDA kernel, its wrapper and its plain PyTorch version
(counterpart of rcfd_tpu/ops/fused_skip.py), NCHW.

In the constant-bin branch of the column ROI pool every pooled window is a
contiguous column slice of one global 2-tap-max map G. A decoder block's
post-conv over ``concat[up, window(G, s)]`` therefore splits into
``conv(up, W_a) + window(conv(G, W_skip), s)``, exact at every column but
the window's first and last, where the window's zero padding meets G's
neighbouring columns; one column of the skip conv's left (right) taps over
``G[:, :, :, s - 1]`` (``G[:, :, :, s + pw]``) corrects each, in float32.
Convolving G once instead of K windows of it, and never writing the pooled
windows, is the point of the fusion.

``fused_skip_gather_add`` is the wrapper of the kernel, in float32 or in
bf16 (``a`` and ``cg`` of one dtype; the corrections stay float32). On a
CUDA tensor it launches the kernel of ``csrc/fused_skip_gather_add.cu``
(built with nvcc at first use) in the tensors' dtype or raises; on a CPU
tensor, and only there, it runs ``fused_skip_gather_add_plain``.
``fused_skip_gather_add.launches`` counts the float32 instance's launches,
``fused_skip_gather_add.launches_bf16`` the bf16 instance's. The
convolutions around it are plain PyTorch (cuDNN on the card).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

SOURCE = 'fused_skip_gather_add.cu'
# the kernels of this module and of crop_cuda.py index a window's elements
# with 32-bit unsigned integers and its windows by the rows of a CUDA grid
MAX_WINDOW_ELEMS = 2 ** 31 - 1
MAX_WINDOWS = 65535

# the C entry point of the kernel's instance for each dtype of a and cg
ENTRIES = {torch.float32: 'rcfd_fused_skip_gather_add',
           torch.bfloat16: 'rcfd_fused_skip_gather_add_bf16'}
ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + \
    (ctypes.c_void_p,) * 2


def _kernel(dtype=torch.float32):
    """The ctypes entry point of the kernel's instance for ``dtype``, built
    and bound at first use."""
    return _build.bind(SOURCE, ENTRIES[dtype], ARGTYPES)


def gather_windows(g, starts, width: int):
    """Windows ``g[n, :, :, s_k : s_k + width]`` of every start: g
    (N, C, H, Wg), starts (N, K) -> (N * K, C, H, width)."""
    n, c, h, _ = g.shape
    k = starts.shape[1]
    cols = starts.long()[:, :, None] + torch.arange(width, device=g.device)
    win = torch.stack([g[i][:, :, cols[i]] for i in range(n)])
    # (N, C, H, K, width) -> (N * K, C, H, width)
    return win.permute(0, 3, 1, 2, 4).reshape(n * k, c, h, width)


class LazyColumnWindows:
    """A deferred constant-bin column ROI pool: the global 2-tap-max map and
    the window starts, which ``materialize()`` turns into the pooled windows
    the eager pool returns.

    g : (N, C, ph, Wg) finite global map, with a right apron of pooled_w
        zeros
    starts : (N, K) int32 window starts in [0, Wg - pooled_w]
    """

    def __init__(self, g, starts, pooled_w: int):
        self.g = g
        self.starts = starts
        self.pooled_w = pooled_w

    @property
    def shape(self):
        n, c, ph, _ = self.g.shape
        return (n * self.starts.shape[1], c, ph, self.pooled_w)

    @property
    def dtype(self):
        return self.g.dtype

    def materialize(self):
        """The pooled windows (N * K, C, ph, pooled_w), equal to the eager
        constant-bin pool's."""
        return gather_windows(self.g, self.starts, self.pooled_w)


def _row_conv_columns(cols, wk):
    """3-tap conv along the rows of column stacks, float32, zero row
    padding: cols (N, K, C, ph), wk (Co, C, 3) -> (N, K, Co, ph)."""
    cols = cols.float()
    wk = wk.float()
    ph = cols.shape[-1]
    colsp = F.pad(cols, (1, 1))
    out = None
    for i in range(3):
        t = torch.einsum('nkch,dc->nkdh', colsp[..., i:i + ph], wk[:, :, i])
        out = t if out is None else out + t
    return out


def _corrections(lazy: LazyColumnWindows, w_skip):
    """The two float32 correction columns of every window, (corr_l, corr_r),
    each (N * K, Co, ph). w_skip: (Co, C, 3, 3) OIHW."""
    g, starts, pw = lazy.g, lazy.starts.long(), lazy.pooled_w
    n, c, ph, wg = g.shape
    k = starts.shape[1]

    def column(idx, valid):
        # column idx[n, k] of g[n], zeroed where not valid: (N, K, C, ph)
        col = gather_windows(g, idx, 1).reshape(n, k, c, ph)
        return col * valid[..., None, None]

    left = column(torch.clamp_min(starts - 1, 0), starts >= 1)
    right = column(torch.clamp_max(starts + pw, wg - 1),
                   starts + pw <= wg - 1)
    corr_l = _row_conv_columns(left, w_skip[..., 0])
    corr_r = _row_conv_columns(right, w_skip[..., 2])
    co = corr_l.shape[2]
    return (corr_l.reshape(n * k, co, ph).contiguous(),
            corr_r.reshape(n * k, co, ph).contiguous())


def fused_skip_gather_add_plain(a, cg, starts, corr_l, corr_r):
    """Plain PyTorch version of the kernel: ``a`` plus the windows of ``cg``
    at ``starts``, then the first column minus ``corr_l`` and the last minus
    ``corr_r``, in float32 and in that order. Starts are clipped to
    [0, Wg - pw] as in the kernel. With bf16 ``a`` and ``cg`` the sum is
    rounded to bf16 and the two edge columns are corrected in float32, then
    rounded to bf16 (the JAX package's order, rcfd_tpu/ops/fused_skip.py)."""
    pw = a.shape[3]
    starts = torch.clamp(starts.long(), 0, cg.shape[3] - pw)
    y = a + gather_windows(cg, starts, pw)
    y[..., 0] = y[..., 0] - corr_l
    y[..., pw - 1] = y[..., pw - 1] - corr_r
    return y


def check_shapes(name, a, cg, starts, corr_l, corr_r):
    """Raise ValueError unless a (N * K, Co, ph, pw), cg (N, Co, ph, Wg),
    starts (N, K) and both corrections (N * K, Co, ph) fit, with
    2 <= pw <= Wg."""
    nk, co, ph, pw = a.shape
    n, wg = cg.shape[0], cg.shape[3]
    if tuple(cg.shape[1:3]) != (co, ph) or starts.dim() != 2 or \
            starts.shape[0] != n or starts.shape[1] * n != nk or \
            tuple(corr_l.shape) != (nk, co, ph) or \
            tuple(corr_r.shape) != (nk, co, ph) or not 2 <= pw <= wg:
        raise ValueError(
            '{}: shapes do not fit: a {}, cg {}, starts {}, corrections {} '
            'and {}'.format(name, tuple(a.shape), tuple(cg.shape),
                            tuple(starts.shape), tuple(corr_l.shape),
                            tuple(corr_r.shape)))


def check_cuda_tensors(kernel, device, named, hint):
    """Raise unless every (name, tensor, dtype) of ``named`` lies on the
    CUDA ``device``, is contiguous and has its dtype (NotImplementedError
    for another dtype, with ``hint``), and the windows fit the kernel's
    grid."""
    if device.type != 'cuda':
        raise ValueError('{} runs on CUDA or CPU tensors, got {}'.format(
            kernel, device))
    for name, t, dtype in named:
        if t.device != device:
            raise ValueError('{} is on {}, a on {}'.format(name, t.device,
                                                           device))
        if t.dtype != dtype:
            raise NotImplementedError('{} takes {} {}, got {} {}'.format(
                kernel, dtype, name, t.dtype, hint))
        if not t.is_contiguous():
            raise ValueError('{} needs a contiguous {}'.format(kernel, name))
    nk, co, ph, pw = named[0][1].shape
    if co * ph * pw > MAX_WINDOW_ELEMS or not 1 <= nk <= MAX_WINDOWS:
        raise ValueError('{}: {} windows of {} elements; it takes 1 to {} '
                         'windows of at most {}'.format(
                             kernel, nk, co * ph * pw, MAX_WINDOWS,
                             MAX_WINDOW_ELEMS))


def fused_skip_gather_add(a, cg, starts, corr_l, corr_r):
    """``a + window(cg, s_k)`` with the two boundary columns corrected.

    Arg(s):
        a : (N * K, Co, ph, pw) the conv of the upsampled features
        cg : (N, Co, ph, Wg) the conv of the global map
        starts : (N, K) window starts in [0, Wg - pw]
        corr_l, corr_r : (N * K, Co, ph) float32 corrections of the first
            and the last column
        On CUDA: float32 or bf16 a and cg of one dtype, float32
        corrections, int32 starts, all contiguous and on one device.
    Returns:
        (N * K, Co, ph, pw), a.dtype
    """
    check_shapes('fused_skip_gather_add', a, cg, starts, corr_l, corr_r)
    device = a.device
    if device.type == 'cpu':
        return fused_skip_gather_add_plain(a, cg, starts, corr_l, corr_r)
    dtype = a.dtype if a.dtype in ENTRIES else torch.float32
    check_cuda_tensors(
        'the fused skip kernel', device,
        (('a', a, dtype), ('cg', cg, dtype),
         ('starts', starts, torch.int32), ('corr_l', corr_l, torch.float32),
         ('corr_r', corr_r, torch.float32)),
        '(a and cg are float32 or bf16, of one dtype)')
    nk, co, ph, pw = a.shape
    n, wg = cg.shape[0], cg.shape[3]
    out = torch.empty_like(a)
    fn = _kernel(dtype)
    with torch.cuda.device(device):
        err = fn(a.data_ptr(), cg.data_ptr(), starts.data_ptr(),
                 corr_l.data_ptr(), corr_r.data_ptr(), nk, nk // n, co * ph,
                 pw, wg, out.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError('fused skip kernel launch failed: CUDA error '
                           '{}'.format(err))
    _build.count_launch(fused_skip_gather_add, dtype)
    return out


fused_skip_gather_add.launches = 0
fused_skip_gather_add.launches_bf16 = 0


def fused_skip_conv_add(y1, w_a, lazy: LazyColumnWindows, w_skip):
    """``conv(y1, w_a) + conv(lazy.materialize(), w_skip)`` without the
    windows: the skip conv runs once on the global map and its windows are
    gathered into the sum, with exact float32 boundary corrections.

    Arg(s):
        y1 : (N * K, Ci, ph, pw) the upsampled per-point features
        w_a : (Co, Ci, 3, 3) OIHW weight of the y1 term (no bias)
        lazy : LazyColumnWindows of the skip
        w_skip : (Co, C, 3, 3) OIHW weight of the skip term (no bias)
    Returns:
        (N * K, Co, ph, pw), y1.dtype. The weights are taken in the dtype of
        what they convolve, as in the JAX package; in bf16 the two
        convolutions and their sum are bf16 and the corrections float32.
    """
    # at pooled_w == 1 the first and the last column coincide and one
    # correction would overwrite the other
    if lazy.pooled_w < 2:
        raise ValueError(
            'fused_skip_conv_add needs pooled_w >= 2, got {}; use '
            'lazy.materialize() and a plain conv instead'.format(
                lazy.pooled_w))
    a = F.conv2d(y1, w_a.to(y1.dtype), padding=1).contiguous()
    cg = F.conv2d(lazy.g, w_skip.to(lazy.g.dtype), padding=1).contiguous()
    corr_l, corr_r = _corrections(lazy, w_skip)
    return fused_skip_gather_add(a, cg, lazy.starts, corr_l, corr_r)
