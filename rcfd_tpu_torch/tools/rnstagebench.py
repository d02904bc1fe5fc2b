"""Per-stage timing of the RadarNet half of the fused pipeline at its
serving shapes on the card (counterpart of tools/rnstagebench.py): K =
B * K_points patches over B = 4 frames, bf16 by default.

Stages:
  pool2 ... pool32  the column ROI pools of the five encoder levels
                    (``ops.roi_pool.roi_pool_column``) over a frame's
                    feature map padded by 288 columns (widths 944 ... 59)
  deconv4 ... deconv1  the decoder blocks at patch shapes, batch norm
                    folded, then cast
  tail              the plain ``deconv0`` + ``output0`` (the JAX tool times
                    ``packed_decoder_tail``, a TPU layout rewrite of the
                    same math that the port leaves out)
  scatter           one frame's scatter through K1
                    (``ops.scatter_cuda.scatter_quasi_dense``, its plain
                    version on the CPU) on bf16 crops, as the JAX stage runs
                    the Pallas kernel

Each stage is timed as the JAX tool times it (``timing.slope_ms`` between
chains of ``--n_lo`` and ``--n_hi`` calls): the carry perturbs the first
input and is a full reduction of the output. Prints ms a call and ms a
frame a stage, the RadarNet half's total a frame, then one JSON line (the
JAX tool prints none) with ``backend`` and ``device``.

    python -m rcfd_tpu_torch.tools.rnstagebench [--k 256]
        [--stages pool2 deconv1 scatter]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import default_device
from ..nn.layers import Conv2d, DecoderBlock, init_parameters
from ..nn.optimize import fold_batch_norm
from ..ops.roi_pool import roi_pool_column
from ..ops import scatter_cuda
from ..pipeline import serving_numerics
from . import timing

B = 4  # frames; the pooled feature maps are a frame's
H, W, PATCH = 900, 1600, (900, 288)
# padded image width 1600 + 288 -> feature widths 944/472/236/118/59
POOLS = {
    'pool2': ((B, 32, 450, 944), 0.5, (450, 144)),
    'pool4': ((B, 64, 225, 472), 0.25, (225, 72)),
    'pool8': ((B, 128, 113, 236), 0.125, (112, 36)),
    'pool16': ((B, 128, 57, 118), 0.0625, (56, 18)),
    'pool32': ((B, 128, 29, 59), 1 / 32., (28, 9)),
}


def decoder_blocks(k: int):
    """(cin, skip channels, cout, x shape, skip shape) of each block at k
    patches, NCHW."""
    return {
        'deconv4': (256, 128, 256, (k, 256, 28, 9), (k, 128, 56, 18)),
        'deconv3': (256, 128, 128, (k, 256, 56, 18), (k, 128, 112, 36)),
        'deconv2': (128, 64, 64, (k, 128, 112, 36), (k, 64, 225, 72)),
        'deconv1': (64, 32, 32, (k, 64, 225, 72), (k, 32, 450, 144)),
    }


def folded(module, seed: int, dtype, device):
    """``module`` drawn from ``seed``, batch norm folded, cast, on
    ``device``, in eval mode."""
    init_parameters(module, torch.Generator().manual_seed(seed))
    return fold_batch_norm(module.eval()).to(device, dtype).eval()


def make_stages(k: int, dtype, device, rng, pools=POOLS, blocks=None,
                tail_shape=None, scatter=(H, W, PATCH)):
    """Each stage as (fn, inputs): ``fn(*inputs)`` is its output (the
    scatter's (depth, response)). Inputs come in the JAX tool's order: the
    maps and crops uniform in [0, 1) from a torch Generator on ``device``
    seeded 0 (some 2 G floats at K = 256: numpy would take seconds a
    GB), the positions and depths from ``rng``; modules from the JAX
    tool's seeds (blocks 100 + i, deconv0 7, output0 8)."""
    kpf = k // B
    generator = torch.Generator(device=device).manual_seed(0)

    def arr(shape):
        return torch.rand(shape, generator=generator, device=device).to(
            dtype)

    stages = {}
    for name, (fshape, scale, out_size) in pools.items():
        feat = arr(fshape)
        x1 = torch.from_numpy(rng.integers(0, W, (B, kpf)).astype(
            np.float32)).to(device)
        box_width = scatter[2][1]
        fn = (lambda scale, out_size, bw: lambda feat, x1: roi_pool_column(
            feat, x1, box_width=bw, box_y1=0, box_y2=scatter[0],
            spatial_scale=scale, output_size=out_size))(scale, out_size,
                                                         box_width)
        stages[name] = (fn, (feat, x1))

    blocks = decoder_blocks(k) if blocks is None else blocks
    for i, (name, (cin, cs, cout, xs, ss)) in enumerate(blocks.items()):
        blk = folded(DecoderBlock(cin, cs, cout, use_batch_norm=True,
                                  deconv_type='up'), 100 + i, dtype, device)
        stages[name] = ((lambda blk: lambda x, skip: blk(x, skip=skip))(blk),
                        (arr(xs), arr(ss)))

    deconv0 = folded(DecoderBlock(32, 0, 16, use_batch_norm=True,
                                  deconv_type='up'), 7, dtype, device)
    out_conv = folded(Conv2d(16, 1, 3, 1, 'kaiming_uniform', 'sigmoid',
                             False), 8, dtype, device)
    x_tail = arr(tail_shape or (k, 32, 450, 144))

    def tail(x):
        return out_conv(deconv0(x))

    stages['tail'] = (tail, (x_tail,))

    h, w, patch = scatter
    crops = arr((kpf,) + tuple(patch))
    pad = patch[1] // 2
    xs = torch.from_numpy(rng.integers(pad, w + pad, kpf).astype(
        np.float32)).to(device)
    zs = torch.from_numpy(rng.random(kpf, np.float32) * 70 + 1).to(device)
    vd = torch.ones((kpf,), dtype=torch.bool, device=device)

    def scatter_fn(crops, xs, zs, vd):
        return scatter_cuda.scatter_quasi_dense(crops, xs, zs, vd, h, w,
                                                patch)

    stages['scatter'] = (scatter_fn, (crops, xs, zs, vd))
    return stages


def reduce(out):
    """The full reduction the chained carry takes: 1e-24 of the sum of
    every output element, in float32."""
    if isinstance(out, tuple):
        return sum(o.float().sum() for o in out) * 1e-24
    return out.float().sum() * 1e-24


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.rnstagebench')
    parser.add_argument('--k', type=int, default=256,
                        help='patches per device step (B*K_points)')
    parser.add_argument('--dtype', default='bfloat16')
    parser.add_argument('--stages', nargs='*', default=None)
    parser.add_argument('--n_lo', type=int, default=2)
    parser.add_argument('--n_hi', type=int, default=10)
    return parser


def main(argv=None, device=None):
    """Time the stages on ``device`` (``cuda`` unless ``device='cpu'``).
    Returns the JSON row printed last."""
    args = build_parser().parse_args(argv)
    if args.k < B or args.k % B:
        raise SystemExit('--k must be a positive multiple of {}'.format(B))
    device = default_device(device)
    dtype = torch.bfloat16 if args.dtype == 'bfloat16' else torch.float32
    stages = make_stages(args.k, dtype, device, np.random.default_rng(0))
    names = args.stages or list(stages)
    results, total = {}, 0.0
    with serving_numerics(), torch.inference_mode():
        for name in names:
            fn, inputs = stages[name]

            def step(c, fn=fn, inputs=inputs):
                return reduce(fn(timing.perturb(inputs[0], c), *inputs[1:]))

            t0 = time.perf_counter()
            ms, _ = timing.slope_ms(step, timing.scalar_carry(device),
                                    args.n_lo, args.n_hi, device)
            per_frame = ms if name == 'scatter' else ms / B
            total += per_frame
            results[name] = {'ms': round(ms, 4),
                             'ms_per_frame': round(per_frame, 4)}
            print('{:10s} {:8.2f} ms ({:6.2f} ms/frame)  [{:.0f}s]'.format(
                name, ms, per_frame, time.perf_counter() - t0), flush=True)
    print('{:10s} {:8s} ({:6.2f} ms/frame RadarNet half)'.format(
        'total', '', total))
    row = {'harness': 'rnstagebench', 'k': args.k, 'frames': B,
           'dtype': 'bfloat16' if dtype == torch.bfloat16 else 'float32',
           'stages': results, 'total_ms_per_frame': round(total, 4),
           'backend': device.type, 'device': timing.card_line(device)}
    print(json.dumps(row))
    return row


if __name__ == '__main__':
    main()
