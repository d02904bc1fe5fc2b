"""Check and time the pool2 -> deconv1 fusion (``ops/fused_skip.py``) at
the serving shapes on the card (counterpart of tools/fusedskip_bench.py).

At K points over the global 1/2-scale map it computes:

  baseline  the split path: the pooled windows materialized
            (``LazyColumnWindows.materialize``), the skip conv and the add
  fused     ``fused_skip_conv_add``: the skip conv once on the global map,
            then the gather-add with edge corrections through K3
            (``ops/fused_skip.py::fused_skip_gather_add``; its plain version
            on the CPU)
  plain     the same with K3's plain version,
            ``fused_skip_gather_add_plain``, on every device

and prints the max abs error of fused and plain against baseline, and of
K3 against its plain version (0 when they agree bit for bit). On the card
each is timed by ``timing.slope_ms`` (chains of 2 and 10 calls, the global
map perturbed by the carry, a sum of |y| the carry), as the JAX tool times
it on the TPU. The last line is one JSON row (the JAX tool prints none)
with ``backend`` and ``device``.

    python -m rcfd_tpu_torch.tools.fusedskip_bench [--k 64] [--dtype
        bfloat16]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import default_device
from ..nn import functional as NF
from ..ops.fused_skip import (LazyColumnWindows, _corrections,
                              fused_skip_conv_add,
                              fused_skip_gather_add_plain)
from ..pipeline import serving_numerics
from . import timing


def make_inputs(n, k, ph, pw, c, wf, dtype, device, rng):
    """The JAX tool's draws in its order, NCHW: the global map g (N, C,
    PH, WF + PW) with its zero apron, the starts (N, K), the skip and
    the y1 weights (OIHW, drawn HWIO), the upsampled features a (N * K, C,
    PH, PW)."""
    wg = wf + pw
    g = rng.random((n, ph, wg, c), np.float32)
    g[:, :, wf:, :] = 0
    starts = rng.integers(0, wf + 1, (n, k)).astype(np.int32)
    w_skip = rng.random((3, 3, c, c), np.float32) * 0.05
    w_a = rng.random((3, 3, c, c), np.float32) * 0.05
    a = rng.random((n * k, ph, pw, c), np.float32)

    def t(x, perm):
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(x, perm))).to(device, dtype)

    return (t(a, (0, 3, 1, 2)), t(g, (0, 3, 1, 2)),
            torch.from_numpy(starts).to(device), t(w_skip, (3, 2, 0, 1)),
            t(w_a, (3, 2, 0, 1)))


def baseline(a, g, starts, w_skip, w_a):
    """The split path: conv_a(y1) + conv_skip(windows); ``a`` plays y1."""
    win = LazyColumnWindows(g, starts, a.shape[3]).materialize()
    return NF.conv2d(a, w_a) + NF.conv2d(win, w_skip)


def fused(a, g, starts, w_skip, w_a):
    """``fused_skip_conv_add``: K3 on the card."""
    return fused_skip_conv_add(a, w_a, LazyColumnWindows(g, starts,
                                                         a.shape[3]), w_skip)


def fused_plain(a, g, starts, w_skip, w_a):
    """``fused_skip_conv_add`` with K3's plain version."""
    lazy = LazyColumnWindows(g, starts, a.shape[3])
    y = NF.conv2d(a, w_a).contiguous()
    cg = NF.conv2d(g, w_skip).contiguous()
    corr_l, corr_r = _corrections(lazy, w_skip)
    return fused_skip_gather_add_plain(y, cg, starts, corr_l, corr_r)


def max_abs(x, y) -> float:
    return float((x.float() - y.float()).abs().max())


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.fusedskip_bench')
    parser.add_argument('--k', type=int, default=64)
    parser.add_argument('--n', type=int, default=1)
    parser.add_argument('--ph', type=int, default=450)
    parser.add_argument('--pw', type=int, default=144)
    parser.add_argument('--c', type=int, default=32)
    parser.add_argument('--wf', type=int, default=944)
    parser.add_argument('--dtype', type=str, default='bfloat16')
    return parser


def main(argv=None, device=None):
    """Check (and on the card time) the fusion on ``device`` (``cuda``
    unless ``device='cpu'``). Returns the JSON row printed last."""
    args = build_parser().parse_args(argv)
    device = default_device(device)
    dtype = torch.bfloat16 if args.dtype == 'bfloat16' else torch.float32
    inputs = make_inputs(args.n, args.k, args.ph, args.pw, args.c, args.wf,
                         dtype, device, np.random.default_rng(0))
    print('backend:', device.type, 'shapes: N={} K={} PH={} PW={} C={} '
          'WG={} {}'.format(args.n, args.k, args.ph, args.pw, args.c,
                            args.wf + args.pw, args.dtype), flush=True)
    row = {'harness': 'fusedskip_bench', 'n': args.n, 'k': args.k,
           'dtype': args.dtype}
    with serving_numerics(), torch.inference_mode():
        ref = baseline(*inputs)
        out = fused(*inputs)
        out_plain = fused_plain(*inputs)
        row.update(max_abs_err=max_abs(out, ref),
                   max_abs_err_plain=max_abs(out_plain, ref),
                   k3_vs_plain=max_abs(out, out_plain),
                   scale=float(ref.float().abs().max()))
        print('K3 max abs err {:.3e}, plain {:.3e} (scale {:.3e}); K3 vs '
              'its plain version {:.3e}'.format(
                  row['max_abs_err'], row['max_abs_err_plain'],
                  row['scale'], row['k3_vs_plain']), flush=True)
        times = None
        if device.type == 'cuda':
            times = {}
            for name, fn in (('baseline', baseline), ('fused', fused),
                             ('plain', fused_plain)):
                def step(c, fn=fn):
                    a, g, *rest = inputs
                    y = fn(a, timing.perturb(g, c), *rest)
                    return y.float().abs().sum() * 1e-24

                times[name] = timing.slope_ms(
                    step, timing.scalar_carry(device), 2, 10, device)[0]
            print('baseline (gather + conv + add): {:7.3f} ms'.format(
                times['baseline']))
            print('fused K3 (convG + gather-add): {:7.3f} ms'.format(
                times['fused']))
            print('fused plain (unfused gather): {:7.3f} ms'.format(
                times['plain']), flush=True)
    row.update(ms=times, backend=device.type,
               device=timing.card_line(device))
    print(json.dumps(row))
    return row


if __name__ == '__main__':
    main()
