"""Where the fused skip gather-add's time goes on the card: K3 and four
variants of it, each timed against its byte bound (counterpart of
tools/fusepall_exp.py, which does the same for the Pallas kernel on a TPU).

    python -m rcfd_tpu_torch.tools.fusepall_exp [--dtype float32]
        [--k 64 --n 1 --ph 450 --pw 144 --c 32 --wf 944]
        [--variants full align16 noselect dmaonly nodma]

The defaults are ``deconv1``'s shapes on the 900x288 patch, in bf16 as the
TPU tool measures. The variants (ops/fused_skip_variants.py) are ``full``
(K3 itself, in either dtype), ``align16`` (the same function over
16-byte vectors, aligned window reads and an on-chip pick-out),
``noselect`` (no pick-out), ``dmaonly`` (the window reads and the writes
alone) and ``nodma`` (``a * 2``). For each the tool prints its device time
(CUDA events, median of 20 launches), the bytes it must move (each input
read once, each output written once), their time at the H100 SXM data
sheet's 3.35 TB/s, and its share of that bound. It checks every variant
against its plain version (bit for bit), prints the largest difference of
``full`` and ``align16`` from K3's plain version, and times a one-call
PyTorch yardstick beside ``nodma`` (``torch.mul(a, 2)``) and ``dmaonly``
(``torch.gather`` of the windows from an index made beforehand). It runs on
the card only and exits non-zero when a variant differs from its plain
version.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import fused_skip as fs
from ..ops import fused_skip_variants as fv

# H100 SXM data sheet: HBM3 rate, bytes/s
HBM_BYTES_PER_S = 3.35e12
N_TIMED = 20
DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def device_ms(fn, n=N_TIMED, warmup=2):
    """Median device milliseconds of ``fn`` over ``n`` runs, each between
    two CUDA events. A sleep kernel holds the stream while the runs are
    queued, so the host's launch overhead does not show in the times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s of clock cycles
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def make_inputs(k=64, n=1, ph=450, pw=144, c=32, wf=944,
                dtype=torch.bfloat16, device='cuda', seed=0):
    """The TPU tool's inputs (tools/fusepall_exp.py:55-60: the same draws
    from a seeded numpy generator, the map's columns past ``wf`` zeroed),
    in NCHW: (a, cg, starts, corr_l, corr_r). cg is the 3x3 conv of the
    global map, computed in float32 and rounded to ``dtype``; the
    corrections are float32 (fused_skip._corrections)."""
    rng = np.random.default_rng(seed)
    wg = wf + pw
    g = rng.random((n, ph, wg, c), np.float32)
    g[:, :, wf:, :] = 0
    starts = rng.integers(0, wf + 1, (n, k)).astype(np.int32)
    w_skip = rng.random((3, 3, c, c), np.float32) * 0.05
    a = rng.random((n * k, ph, pw, c), np.float32)

    def nchw(x):
        return torch.from_numpy(x).to(device).permute(0, 3, 1, 2) \
            .contiguous()

    g = nchw(g)
    w = torch.from_numpy(w_skip).to(device).permute(3, 2, 0, 1).contiguous()
    cg = F.conv2d(g, w, padding=1).to(dtype).contiguous()
    starts = torch.from_numpy(starts).to(device)
    corr_l, corr_r = fs._corrections(
        fs.LazyColumnWindows(g.to(dtype), starts, pw), w.to(dtype))
    return nchw(a).to(dtype), cg, starts, corr_l, corr_r


def variant_bytes(variant, a, cg, starts, corr_l, corr_r):
    """Bytes the variant must move: each input it reads once, its output
    written once."""
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    if variant == 'nodma':
        return 2 * nbytes(a)
    if variant == 'dmaonly':
        return nbytes(cg, starts) + nbytes(a)  # the output is a's size
    return 2 * nbytes(a) + nbytes(cg, starts, corr_l, corr_r)


def _library(variant, args):
    """(name, the one-call PyTorch yardstick of ``variant``) or None."""
    a, cg, starts = args[:3]
    if variant == 'nodma':
        return 'torch.mul(a, 2)', lambda: torch.mul(a, 2)
    if variant == 'dmaonly':
        n, co, ph, wg = cg.shape
        k, pw = starts.shape[1], a.shape[3]
        s = fv.aligned_starts(starts, pw, wg, fv.vector_elems(a.dtype))
        cols = s.long()[:, :, None] + torch.arange(pw, device=a.device)
        index = cols[:, :, None, None, :].expand(n, k, co, ph, pw) \
            .contiguous()
        src = cg[:, None].expand(n, k, co, ph, wg)
        return 'torch.gather', lambda: torch.gather(src, 4, index).reshape(
            a.shape)
    return None


def run_variants(args, variants=fv.VARIANTS, timer=device_ms):
    """Launch, check and time each variant on ``args`` (make_inputs'
    tuple). Returns one dict a variant: its name, ``equal`` (to its plain
    version, bit for bit), ``launched`` (its wrapper's count moved),
    ``max_abs_err`` (against its plain version), ``err_vs_k3`` (full and
    align16: against K3's plain version), ``ms``, ``plain_ms``, ``bytes``,
    ``bound_ms``, ``share`` of the bound, ``library`` and ``library_ms``
    (None where no one call computes the variant)."""
    results = []
    for variant in variants:
        wrapper, plain = fv.WRAPPERS[variant], fv.PLAIN[variant]
        before = wrapper.launches
        out = wrapper(*args)
        ref = plain(*args)
        if args[0].is_cuda:
            torch.cuda.synchronize()
        r = dict(variant=variant, dtype=str(args[0].dtype).split('.')[-1],
                 equal=torch.equal(out, ref),
                 launched=wrapper.launches > before,
                 max_abs_err=float((out.float() - ref.float()).abs().max()))
        if variant in ('full', 'align16'):
            k3 = fs.fused_skip_gather_add_plain(*args)
            r['err_vs_k3'] = float((out.float() - k3.float()).abs().max())
            del k3
        del out, ref
        r['ms'] = timer(lambda: wrapper(*args), N_TIMED)
        r['plain_ms'] = timer(lambda: plain(*args), 5)
        r['bytes'] = variant_bytes(variant, *args)
        r['bound_ms'] = r['bytes'] / HBM_BYTES_PER_S * 1e3
        r['share'] = r['bound_ms'] / r['ms'] if r['ms'] > 0 else None
        library = _library(variant, args)
        r['library'], r['library_ms'] = None, None
        if library is not None:
            r['library'] = library[0]
            lib_out = library[1]()
            r['library_equal'] = torch.equal(lib_out, plain(*args))
            del lib_out
            r['library_ms'] = timer(library[1], N_TIMED)
        results.append(r)
    return results


def describe(r):
    """One line of the tool's output for a result of run_variants."""
    line = ('{variant:9s} {dtype}: {ms:.4f} ms (median of {n}), {bytes} '
            'bytes, bound {bound_ms:.4f} ms at {rate:.3g} B/s'.format(
                n=N_TIMED, rate=HBM_BYTES_PER_S, **r))
    if r['share'] is not None:
        line += ', {:.0%} of the bound'.format(r['share'])
    line += '; plain {:.4f} ms; == plain version: {}'.format(r['plain_ms'],
                                                             r['equal'])
    if 'err_vs_k3' in r:
        line += "; max abs err vs K3's plain version {:.3g}".format(
            r['err_vs_k3'])
    if r['library'] is not None:
        line += '; {} {:.4f} ms (== plain: {})'.format(
            r['library'], r['library_ms'], r['library_equal'])
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--k', type=int, default=64)
    parser.add_argument('--n', type=int, default=1)
    parser.add_argument('--ph', type=int, default=450)
    parser.add_argument('--pw', type=int, default=144)
    parser.add_argument('--c', type=int, default=32)
    parser.add_argument('--wf', type=int, default=944)
    parser.add_argument('--variants', nargs='+', default=list(fv.VARIANTS),
                        choices=fv.VARIANTS)
    parser.add_argument('--dtype', default='bfloat16', choices=DTYPES)
    parser.add_argument('--device', default='cuda',
                        help="'cpu' runs the plain versions and needs a "
                             'stubbed timer (tests only)')
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit('fusepall_exp: no CUDA device; the tool times '
                             'the kernels on the card')
        print('device: {}'.format(torch.cuda.get_device_name(device)),
              flush=True)
    inputs = make_inputs(args.k, args.n, args.ph, args.pw, args.c, args.wf,
                         DTYPES[args.dtype], device)
    print('a {} cg {} {}, K={} windows'.format(
        tuple(inputs[0].shape), tuple(inputs[1].shape), args.dtype,
        args.k * args.n), flush=True)
    results = []
    for variant in args.variants:
        results += run_variants(inputs, [variant], timer=device_ms)
        print(describe(results[-1]), flush=True)
    if not all(r['equal'] and r.get('library_equal', True)
               for r in results):
        raise SystemExit('fusepall_exp: a variant differs from its plain '
                         'version')
    return results


if __name__ == '__main__':
    main()
