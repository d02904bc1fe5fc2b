"""The column crop (K2, csrc/column_crop.cu) and its backward
(csrc/column_crop_backward.cu) on the card against variants of their
designs, each built from the committed source with one constant or one
condition changed.

    python -m rcfd_tpu_torch.tools.crop_exp [--out crop_exp.json]
        [--parent_csrc OTHER_CHECKOUT/rcfd_tpu_torch/csrc]

Forward variants:

  kernel       the committed design: rows staged in shared memory where
               the windows overlap (K * win > w), each window read from
               device memory where they cannot cover a row; tiles of 8 rows
               that grow while a tile's rows move at most kBlockBytes
  staged       rows always staged (the row-tile design as it serves)
  direct       rows never staged
  8-row tiles  tiles that never grow

Backward variants: ``kernel`` (16 bytes of a column a thread: 4 float32
rows, 8 bf16), and 4, 8 and 16 rows a thread in both dtypes.

With ``--parent_csrc``, another checkout's column_crop.cu (and the
row_tiles.cuh it includes) is built as the forward variant ``parent``, and
the backward variant ``index_add_`` is the crop's gradient as that
checkout computed it on the card before it had a kernel: one index_add_
over the images' padded rows (its atomics add overlapping windows in no
fixed order, so it is held to the plain version within ``INDEX_ADD_TOL`` of
the gradient's max-abs, and timed).

Shapes: RadarNet's variable-bin pools (1/8, 1/16, 1/32) of the 900x300
patch over a 900x1900 padded frame, 128 channels; serving (one frame of 64
windows) and a training step (6 frames of 4), float32 and bf16, inputs
drawn from a seed. Each variant's output must equal the plain version's
bit for bit; its device time is the median of 20 launches between CUDA
events, beside the bytes each function must move (the kernels' bounds,
ops/crop_cuda.py ``crop_bytes`` and ``crop_backward_bytes``) at the H100
SXM data sheet's 3.35 TB/s. Prints the card's name and power limit, a line
a shape and one JSON object. Card only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import crop_cuda as cc
from ..ops.roi_pool import variable_bin_window
from . import timing

HBM_BYTES_PER_S = 3.35e12
SCALES = (8, 16, 32)
# (name, frames, windows a frame)
USES = (('serving', 1, 64), ('step', 6, 4))
CHANNELS = 128
N_TIMED = 20
# index_add_'s float32 sums against the k-ordered ones, as a share of the
# gradient's max-abs: a few roundings of sums of at most 4 terms (64 at
# serving); bf16 sums rounded once may round apart by one bf16 step
INDEX_ADD_TOL = {'float32': 1e-6, 'bf16': 2.0 ** -7}

# each variant: its kernel's source, and the (text, replacement) pairs that
# make it from the committed source
STAGE = 'const bool stage = (long long)k_per_image * win > w;'
ROWS = ('constexpr int kRowsPerThread = 16 / static_cast<int>(sizeof(T));')
VARIANTS = {
    'forward': {
        'kernel': (cc.SOURCE, ()),
        'staged': (cc.SOURCE, ((STAGE, 'const bool stage = true;'),)),
        'direct': (cc.SOURCE, ((STAGE, 'const bool stage = false;'),)),
        '8-row tiles': (cc.SOURCE, (
            ('constexpr size_t kBlockBytes = 32768;',
             'constexpr size_t kBlockBytes = 0;'),)),
    },
    'backward': dict(
        [('kernel', (cc.BACKWARD_SOURCE, ()))] +
        [('{} rows'.format(r), (cc.BACKWARD_SOURCE, (
            (ROWS, 'constexpr int kRowsPerThread = {};'.format(r)),)))
         for r in (4, 8, 16)]),
}


def variant_source(source: str, substitutions) -> str:
    """The text of ``csrc/<source>`` with each (text, replacement) made;
    ValueError where a text is not in it exactly once."""
    with open(os.path.join(_build.CSRC_DIR, source)) as f:
        text = f.read()
    for old, new in substitutions:
        if text.count(old) != 1:
            raise ValueError('{!r} is in {} {} times, not once'.format(
                old, source, text.count(old)))
        text = text.replace(old, new)
    return text


def index_add_backward(grad_windows, starts, rows_shape, win: int):
    """The crop's gradient as one index_add_ over the images' padded rows
    laid side by side, in float32 (bf16 sums rounded once): the card's
    route before the backward kernel."""
    n, c, ph, w = rows_shape
    k = starts.shape[1]
    span = w + win
    device = grad_windows.device
    cols = (torch.clamp(starts.long(), 0, w)[:, :, None] +
            torch.arange(win, device=device) +
            span * torch.arange(n, device=device)[:, None, None])
    g = grad_windows.reshape(n, k, c, ph, win).permute(2, 3, 0, 1, 4)
    out = grad_windows.new_zeros((c, ph, n * span), dtype=torch.float32)
    out.index_add_(2, cols.reshape(-1),
                   g.reshape(c, ph, n * k * win).float())
    return out.view(c, ph, n, span).permute(2, 0, 1, 3)[..., :w].to(
        grad_windows.dtype)


def variant_file(kind: str, name: str) -> str:
    """The csrc file name a variant is built from."""
    return 'crop_exp_{}_{}.cu'.format(kind, name.replace(' ', '_'))


PARENT_HEADER = 'crop_exp_parent_row_tiles.cuh'


def parent_sources(parent_csrc: str) -> dict:
    """{file in csrc: text} of another checkout's crop kernel, its include
    of row_tiles.cuh pointed at that checkout's header, copied beside it."""
    with open(os.path.join(parent_csrc, cc.SOURCE)) as f:
        source = f.read()
    with open(os.path.join(parent_csrc, 'row_tiles.cuh')) as f:
        header = f.read()
    if source.count('#include "row_tiles.cuh"') != 1:
        raise ValueError('{} does not include row_tiles.cuh once'.format(
            parent_csrc))
    return {variant_file('forward', 'parent'): source.replace(
                '#include "row_tiles.cuh"',
                '#include "{}"'.format(PARENT_HEADER)),
            PARENT_HEADER: header}


def build_variants(parent_csrc=None):
    """Every variant's library, built together: its source written into
    csrc/ beside the headers it includes, removed once built. Returns
    {(kind, name): file}."""
    files, written = {}, {}
    for kind, variants in VARIANTS.items():
        for name, (source, subs) in variants.items():
            if not subs:
                files[kind, name] = source
                continue
            files[kind, name] = variant_file(kind, name)
            written[files[kind, name]] = variant_source(source, subs)
    if parent_csrc:
        written.update(parent_sources(parent_csrc))
        files['forward', 'parent'] = variant_file('forward', 'parent')
    try:
        for name, text in written.items():
            with open(os.path.join(_build.CSRC_DIR, name), 'w') as f:
                f.write(text)
        _build.load_libraries(sorted(set(files.values())))
    finally:
        for name in written:
            path = os.path.join(_build.CSRC_DIR, name)
            if os.path.exists(path):
                os.remove(path)
    return files


def device_ms(fn, n=N_TIMED, warmup=2):
    """Median device milliseconds of ``fn`` over ``n`` runs, each between
    two CUDA events, queued behind a sleep kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def inputs(rng, device, n, k, scale, dtype):
    """Rows (n, 128, ph, w_f), starts (n, k) with 0 and w_f among them, the
    windows' gradient and win at the 1/scale pool of the 900x300 patch."""
    ph, pw = 900 // scale, 300 // scale
    w_f = -(-1900 // scale)
    _, win = variable_bin_window(300, 1.0 / scale, pw)
    rows = torch.from_numpy(rng.standard_normal(
        (n, CHANNELS, ph, w_f), dtype=np.float32)).to(device, dtype)
    starts = rng.integers(0, w_f + 1, (n, k)).astype(np.int32)
    starts[0, :2] = [0, w_f]
    grad = torch.from_numpy(rng.standard_normal(
        (n * k, CHANNELS, ph, win), dtype=np.float32)).to(device, dtype)
    return rows, torch.from_numpy(starts).to(device), grad, win


def run_variants(kind, files, args, ref, out, dtype):
    """Each variant of ``kind`` on ``args`` (the input, starts, nk, k,
    n_rows, w, win) into ``out``: whether it equals ``ref``, and its ms."""
    entries = cc.ENTRIES if kind == 'forward' else cc.BACKWARD_ENTRIES
    data, starts = args[:2]
    got = {}
    for name in [v for k, v in files if k == kind]:
        fn = _build.bind(files[kind, name], entries[dtype], cc.ARGTYPES)

        def call():
            err = fn(data.data_ptr(), starts.data_ptr(), *args[2:],
                     out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError('{} {}: CUDA error {}'.format(
                    kind, name, err))

        out.zero_()
        call()
        torch.cuda.synchronize()
        got[name] = dict(equal=bool(torch.equal(out, ref)),
                         ms=device_ms(call))
    return got


def index_add_timed(grad, starts, rows_shape, win, label):
    """index_add_backward against the plain version (within INDEX_ADD_TOL
    of its max-abs: ``equal``), and its ms."""
    ref = cc.batch_column_crop_backward_plain(grad, starts, rows_shape, win)
    got = index_add_backward(grad, starts, rows_shape, win)
    scale = max(float(ref.float().abs().max()), 1e-30)
    err = float((got.float() - ref.float()).abs().max()) / scale
    return dict(equal=err <= INDEX_ADD_TOL[label], max_abs_err=err,
                ms=device_ms(lambda: index_add_backward(grad, starts,
                                                        rows_shape, win)))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.crop_exp')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--parent_csrc', default=None,
                        help='another checkout\'s rcfd_tpu_torch/csrc: its '
                             'crop kernel and index_add_ backward beside')
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('crop_exp runs on the card only')
    device = torch.device('cuda')
    card = timing.card_line(device)
    print(card, flush=True)
    files = build_variants(args.parent_csrc)
    rng = np.random.default_rng(args.seed)
    parts, totals = [], {}
    for use, n, k in USES:
        for dtype in (torch.float32, torch.bfloat16):
            label = 'float32' if dtype == torch.float32 else 'bf16'
            for scale in SCALES:
                rows, starts, grad, win = inputs(rng, device, n, k, scale,
                                                 dtype)
                shape = (n * k, k, rows.shape[1] * rows.shape[2],
                         rows.shape[3], win)
                bounds = dict(
                    forward=cc.crop_bytes(rows, starts, win),
                    backward=cc.crop_backward_bytes(rows, starts, win))
                results = dict(
                    forward=run_variants(
                        'forward', files, (rows, starts) + shape,
                        cc.batch_column_crop_plain(rows, starts, win),
                        torch.empty((n * k,) + tuple(rows.shape[1:3]) +
                                    (win,), dtype=dtype, device=device),
                        dtype),
                    backward=run_variants(
                        'backward', files, (grad, starts) + shape,
                        cc.batch_column_crop_backward_plain(
                            grad, starts, rows.shape, win),
                        torch.empty_like(rows), dtype))
                if args.parent_csrc:
                    results['backward']['index_add_'] = index_add_timed(
                        grad, starts, rows.shape, win, label)
                for kind, got in results.items():
                    bound_ms = bounds[kind] / HBM_BYTES_PER_S * 1e3
                    part = dict(use=use, dtype=label, scale=scale,
                                kind=kind, rows=list(rows.shape), win=win,
                                bytes=bounds[kind], bound_ms=bound_ms,
                                variants=got)
                    parts.append(part)
                    print('{} {} 1/{} {}: bound {:.4f} ms; {}'.format(
                        use, label, scale, kind, bound_ms, '; '.join(
                            '{} {:.4f} ms{}'.format(
                                name, r['ms'],
                                '' if r['equal'] else ' DIFFERS'
                                if 'max_abs_err' not in r else
                                ' (max abs err {:.3g} of the max-abs)'
                                .format(r['max_abs_err']))
                            for name, r in got.items())), flush=True)
                    for name, r in got.items():
                        key = '{} {} {} {}'.format(use, label, kind, name)
                        t = totals.setdefault(key, dict(ms=0.0, bound_ms=0.0))
                        t['ms'] += r['ms']
                        t['bound_ms'] += bound_ms
                del rows, starts, grad
    for key, t in totals.items():
        t['share_of_bound'] = t['bound_ms'] / t['ms']
        print('{}: {:.4f} ms over the three pools, bound {:.4f} ms '
              '({:.1f}%)'.format(key, t['ms'], t['bound_ms'],
                                 100 * t['share_of_bound']))
    result = dict(device=card, parts=parts, totals=totals,
                  all_equal=all(r['equal'] for p in parts
                                for r in p['variants'].values()))
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
    return result['all_equal']


if __name__ == '__main__':
    sys.exit(0 if main() else 1)
