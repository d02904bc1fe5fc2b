"""Variants of the fused skip gather-add (K3) that split its time on the card
into its parts: the hand-written CUDA kernels, their wrappers and their plain
PyTorch versions (counterpart of the kernel of tools/fusepall_exp.py, which
does the same for the Pallas gather-add on a TPU).

With ``A = 16 // element size`` (4 in float32, 8 in bf16), ``s_k`` the
window start clipped to [0, Wg - pw] and ``s^_k = s_k - s_k % A``:

  full      K3's function, ``a + window(cg, s_k)`` with the two edge columns
            corrected in float32. In float32 it is K3 as shipped
            (``fused_skip.fused_skip_gather_add``); in bf16 a kernel of
            ``csrc/fused_skip_variants.cu`` with K3's structure.
  align16   the same function over 16-byte vectors: ``a`` and ``out`` as
            vectors, cg as vectors from the aligned column s^_k, the window
            picked out on chip.
  noselect  align16's computation at s^_k, no pick-out (wrong on purpose).
  dmaonly   ``window(cg, s^_k)``: no ``a``, no corrections (wrong on
            purpose).
  nodma     ``a * 2``, the streaming floor.

Every wrapper takes fused_skip_gather_add's ``(a, cg, starts, corr_l,
corr_r)``: float32 or bf16 ``a`` and ``cg`` of one dtype, float32
corrections, int32 starts, and refuses other dtypes. On a CUDA
tensor it launches its kernel or raises; on a CPU tensor, and only there,
it runs its ``*_plain`` version. Each counts its launches in ``.launches``.
The vector variants (all but ``full``) take only rows of ``a``, ``cg`` and
``out`` that are 16-byte aligned. The variants lie on no serving path:
``rcfd_tpu_torch.tools.fusepall_exp`` times them.
"""

from __future__ import annotations

import ctypes

import torch

from . import fused_skip as fs

SOURCE = 'fused_skip_variants.cu'
VARIANTS = ('full', 'align16', 'noselect', 'dmaonly', 'nodma')
_MODES = {name: i for i, name in enumerate(VARIANTS)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    """The ctypes entry point of the kernels, built and bound at first
    use."""
    global _fn
    if _fn is None:
        from ._build import load_library
        fn = load_library(SOURCE).rcfd_fused_skip_variant
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 +
                       [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def vector_elems(dtype) -> int:
    """Elements of one 16-byte vector: 4 in float32, 8 in bf16."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def aligned_starts(starts, pw: int, wg: int, elems: int):
    """s^_k: each start clipped to [0, wg - pw], then rounded down to a
    multiple of ``elems``. int32, starts' shape."""
    s = torch.clamp(starts.long(), 0, wg - pw)
    return (s - s % elems).to(torch.int32)


# K3's plain version, in float32 or bf16; align16 computes the same function
full_plain = align16_plain = fs.fused_skip_gather_add_plain


def noselect_plain(a, cg, starts, corr_l, corr_r):
    """K3's function with every window taken at s^_k."""
    pw, wg = a.shape[3], cg.shape[3]
    return fs.fused_skip_gather_add_plain(
        a, cg, aligned_starts(starts, pw, wg, vector_elems(a.dtype)),
        corr_l, corr_r)


def dmaonly_plain(a, cg, starts, corr_l, corr_r):
    """The windows of cg at s^_k, nothing added or corrected."""
    pw, wg = a.shape[3], cg.shape[3]
    return fs.gather_windows(
        cg, aligned_starts(starts, pw, wg, vector_elems(a.dtype)), pw)


def nodma_plain(a, cg, starts, corr_l, corr_r):
    """``a * 2``."""
    return a * 2


PLAIN = {'full': full_plain, 'align16': align16_plain,
         'noselect': noselect_plain, 'dmaonly': dmaonly_plain,
         'nodma': nodma_plain}


def _run(variant, a, cg, starts, corr_l, corr_r):
    """Check the arguments and compute ``variant``: its plain version on the
    CPU, K3 for the float32 ``full``, else this file's kernel. Returns
    (out, whether a kernel was launched)."""
    name = 'fused skip variant {}'.format(variant)
    fs.check_shapes(name, a, cg, starts, corr_l, corr_r)
    if a.dtype not in _DTYPES or cg.dtype != a.dtype or \
            corr_l.dtype != torch.float32 or corr_r.dtype != torch.float32 \
            or starts.dtype != torch.int32:
        raise NotImplementedError(
            '{} takes float32 or bf16 a and cg of one dtype, float32 '
            'corrections and int32 starts, got {}, {}, {}, {} and {}'.format(
                name, a.dtype, cg.dtype, corr_l.dtype, corr_r.dtype,
                starts.dtype))
    if a.device.type == 'cpu':
        return PLAIN[variant](a, cg, starts, corr_l, corr_r), False
    if variant == 'full' and a.dtype == torch.float32:
        return fs.fused_skip_gather_add(a, cg, starts, corr_l, corr_r), True
    fs.check_cuda_tensors(
        'the ' + name + ' kernel', a.device,
        (('a', a, a.dtype), ('cg', cg, a.dtype),
         ('starts', starts, torch.int32), ('corr_l', corr_l, torch.float32),
         ('corr_r', corr_r, torch.float32)), '')
    nk, co, ph, pw = a.shape
    n, wg = cg.shape[0], cg.shape[3]
    out = torch.empty_like(a)
    if variant != 'full':
        row = a.element_size()
        for label, t, width in (('a', a, pw), ('cg', cg, wg),
                                ('out', out, pw)):
            if (width * row) % 16 or t.data_ptr() % 16:
                raise ValueError(
                    '{} reads 16-byte vectors: the rows of {} ({} elements '
                    'of {} bytes at address {:#x}) are not 16-byte aligned'
                    .format(name, label, width, row, t.data_ptr()))
    with torch.cuda.device(a.device):
        err = _kernel()(_MODES[variant], _DTYPES[a.dtype], a.data_ptr(),
                        cg.data_ptr(), starts.data_ptr(), corr_l.data_ptr(),
                        corr_r.data_ptr(), nk, nk // n, co * ph, pw, wg,
                        out.data_ptr(),
                        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError('{} kernel launch failed: CUDA error {}'.format(
            name, err))
    return out, True


def _wrapper(variant):
    def wrapper(a, cg, starts, corr_l, corr_r):
        out, launched = _run(variant, a, cg, starts, corr_l, corr_r)
        wrapper.launches += launched
        return out
    wrapper.__name__ = wrapper.__qualname__ = variant
    wrapper.__doc__ = ('The ``{0}`` variant: its kernel on CUDA tensors, '
                       '``{0}_plain`` on CPU tensors.'.format(variant))
    wrapper.launches = 0
    return wrapper


WRAPPERS = {variant: _wrapper(variant) for variant in VARIANTS}
full, align16, noselect, dmaonly, nodma = WRAPPERS.values()
