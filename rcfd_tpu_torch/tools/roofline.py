"""Memory and compute roofline of the serving graphs on the card
(counterpart of tools/roofline.py).

Two byte accountings bracket the traffic of one call:

  analytic  every convolution, transposed convolution, pool and resize's
            input and weight read and output write, recorded by
            intercepting ``rcfd_tpu_torch.nn.functional`` (the layers call
            it as ``F.``), with the JAX tool's byte and FLOP formulas read
            in torch's weight layouts (OIHW; IOHW for the transposed
            convolution). Elementwise work rides along free: a lower bound.
  dispatch  every ATen operator's tensor operands and outputs at full
            size, counted under a ``TorchDispatchMode`` over one call (views
            move nothing and are not counted). This is the eager
            counterpart of XLA's cost model, each HLO's operands at full
            size with no reuse across fusions: an upper estimate. Work
            outside ATen (a hand-written kernel launched through ctypes) is
            seen only by the allocation of its outputs.

The JAX tool's third, 128-lane padded accounting is left out: it prices the
TPU's layout of a channel dimension under 128 in 128 lanes, a tax this card
does not levy (NCHW tensors are dense in memory).

Achieved GB/s and TFLOP/s divide by the time of a call, the slope of
chains of ``--n_iters`` and 2 x ``--n_iters`` chained calls
(``timing.slope_ms``; the JAX tool divides one chain of ``--n_iters``),
and their shares are of the H100 SXM5 datasheet peaks (``timing``): HBM3
3.35 TB/s, and 989 TFLOP/s dense bf16 or 67 TFLOP/s FP32 (TF32 off, as
the port serves float32) for the graph's dtype. Each peak is named in the
output beside the card's name and power limit.

Graphs: ``fusionnet_b32`` is bench.py's FusionNet (batch norm folded,
then cast; the integer-transport decode included), ``pipeline_k64`` the
canonical ``TwoStagePipeline(optimize=True, compute_dtype=...)``'s
``forward_batched`` on b frames of K points. ``--dry`` runs the
accounting alone on the ``meta`` device (every op of both graphs has a
meta kernel), with no card and no timing.

    python -m rcfd_tpu_torch.tools.roofline --graph fusionnet_b32
    python -m rcfd_tpu_torch.tools.roofline --graph pipeline_k64 --batch 4
    python -m rcfd_tpu_torch.tools.roofline --graph pipeline_k64 --dry

A markdown table goes to stdout and one JSON line last: the JAX tool's keys
(``xla_*`` as ``dispatch_*``, ``pct_mxu_peak`` as ``pct_compute_peak``,
no ``padded_*``), the peaks' names and ``device``.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import default_device
from ..nn import functional as NF
from ..pipeline import serving_numerics
from . import serving_config, timing

GRAPHS = ('fusionnet_b32', 'pipeline_k64')


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def record_ops(records):
    """Within the block, record each call of nn.functional's compute ops
    as a dict (op, in_shape, out_shape, bytes_in, bytes_w, bytes_out,
    flops)."""
    orig = {}

    def wrap(name, flops_fn=None, has_weight=True):
        fn = getattr(NF, name)
        orig[name] = fn

        def wrapped(x, *args, **kwargs):
            out = fn(x, *args, **kwargs)
            w = args[0] if (has_weight and args) else None
            records.append(dict(
                op=name, in_shape=tuple(x.shape), out_shape=tuple(out.shape),
                bytes_in=_nbytes(x),
                bytes_w=_nbytes(w) if w is not None else 0,
                bytes_out=_nbytes(out),
                flops=int(flops_fn(x, w, out)) if flops_fn else 0))
            return out

        setattr(NF, name, wrapped)

    def conv_flops(x, w, out):
        # out elements x 2 x kh x kw x Cin MACs; w is OIHW
        return 2 * out.numel() * w.shape[2] * w.shape[3] * w.shape[1]

    def deconv_flops(x, w, out):
        # every input element multiplies the whole kernel; w is IOHW
        return 2 * x.numel() * w.shape[2] * w.shape[3] * out.shape[1]

    wrap('conv2d', conv_flops)
    wrap('conv_transpose2d', deconv_flops)
    wrap('max_pool2d', None, has_weight=False)
    wrap('min_pool2d', None, has_weight=False)
    wrap('resize_nearest', None, has_weight=False)
    wrap('resize_bilinear_align_corners', None, has_weight=False)
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(NF, name, fn)


class DispatchBytes(TorchDispatchMode):
    """Counts the bytes of every ATen operator's tensor operands and
    outputs, views left out, and the operators counted."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.n_ops += 1
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += _nbytes(t)
        return out


def build_fusionnet_b32(batch: int, dtype: str, device):
    """bench.py's FusionNet graph. Returns (forward, step, carry,
    n_frames): ``forward()`` one call from the integer inputs (decode
    included), ``step(img)`` one chained call on the decoded image, which
    adds 1e-12 of the output to it (the JAX tool's scan body)."""
    model = serving_config.fusionnet_folded(dtype, device)
    cdtype = serving_config.DTYPES[dtype]
    image, depth, response = serving_config.on(device, *serving_config.inputs(
        batch, np.random.default_rng(0)))

    def decode():
        return (image.permute(0, 3, 1, 2).to(cdtype) * (1.0 / 255.0),
                torch.cat([depth, response], -1).permute(0, 3, 1, 2).to(
                    cdtype) * (1.0 / 256.0))

    def forward():
        img, input_depth = decode()
        return model(img, input_depth).float()

    img, input_depth = decode()

    def step(img):
        return img + model(img, input_depth).to(img.dtype) * 1e-12

    return forward, step, img, batch


def build_pipeline_k64(batch: int, dtype: str, device, k: int = 64):
    """The fused two-stage graph at K points a frame: ``forward()`` one
    ``forward_batched``; ``step(points)`` one, with 1e-12 of each frame's
    dense depth at (0, 0) fed back into its points' depths."""
    pipe = serving_config.pipeline(dtype, device)
    images, points, valid = serving_config.on(
        device, *serving_config.frames_and_points(
            batch, k, np.random.default_rng(0)))

    def forward():
        return pipe.forward_batched(images, points, valid)

    def step(pts):
        dense = pipe.forward_batched(images, pts, valid)[0]
        pts = pts.clone()
        pts[..., 2] += dense[:, 0, 0][:, None] * 1e-12
        return pts

    return forward, step, points, batch


def build(graph: str, batch: int, dtype: str, device, k: int = 64):
    if graph == 'fusionnet_b32':
        return build_fusionnet_b32(batch, dtype, device)
    return build_pipeline_k64(batch, dtype, device, k=k)


def stage_of(rec, idx: int, total: int) -> str:
    """Coarse stage label from the op order and shapes (NCHW), as the JAX
    tool's: resizes are the decoder's upsampling; convolutions past 45% of
    the ops are the decoder's; the rest the encoder's, by output height."""
    h = rec['out_shape'][-2] if len(rec['out_shape']) >= 3 else 0
    name = rec['op']
    if name in ('resize_nearest', 'resize_bilinear_align_corners'):
        return 'decoder/upsample'
    kind = 'decoder' if idx > total * 0.45 and name in (
        'conv2d', 'conv_transpose2d') else 'encoder'
    return '{}/h{}'.format(kind, h)


def account(forward):
    """Run ``forward()`` once under the analytic recorder and the dispatch
    counter, under the serving numerics. Returns (records, dispatch
    bytes)."""
    records = []
    counter = DispatchBytes()
    with serving_numerics(), torch.inference_mode(), record_ops(records), \
            counter:
        forward()
    return records, counter.bytes


def totals(records):
    """(by stage, analytic bytes, analytic FLOPs) of the records."""
    by_stage = {}
    for i, r in enumerate(records):
        agg = by_stage.setdefault(stage_of(r, i, len(records)),
                                  dict(bytes=0, flops=0, n=0))
        agg['bytes'] += r['bytes_in'] + r['bytes_w'] + r['bytes_out']
        agg['flops'] += r['flops']
        agg['n'] += 1
    return (by_stage, sum(v['bytes'] for v in by_stage.values()),
            sum(v['flops'] for v in by_stage.values()))


def graph_records(graph: str, batch: int, dtype: str, device, k: int = 64):
    """The analytic records and dispatch bytes of one call of ``graph`` on
    ``device`` (``meta`` for the shapes alone)."""
    forward = build(graph, batch, dtype, device, k=k)[0]
    return account(forward)


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.roofline')
    parser.add_argument('--graph', choices=GRAPHS, default='fusionnet_b32')
    parser.add_argument('--batch', type=int, default=None)
    parser.add_argument('--dtype', default='bfloat16',
                        choices=['bfloat16', 'float32'])
    parser.add_argument('--n_iters', type=int, default=10)
    parser.add_argument('--k', type=int, default=64)
    parser.add_argument('--dry', action='store_true',
                        help='analytic accounting only, on the meta device '
                             '(no card, no timing)')
    return parser


def main(argv=None, device=None):
    """The roofline on ``device`` (``cuda`` unless ``device='cpu'``);
    ``--dry`` needs no device. Returns the JSON row printed last."""
    args = build_parser().parse_args(argv)
    if args.n_iters < 1:
        raise SystemExit('--n_iters must be >= 1')
    batch = args.batch or (32 if args.graph == 'fusionnet_b32' else 4)
    if args.dry:
        records, dispatch_bytes = graph_records(
            args.graph, batch, args.dtype, 'meta', k=args.k)
        _, analytic_bytes, analytic_flops = totals(records)
        row = {'graph': args.graph, 'batch': batch, 'dry': True,
               'n_ops': len(records), 'analytic_bytes': analytic_bytes,
               'analytic_flops': analytic_flops,
               'dispatch_bytes': dispatch_bytes, 'dtype': args.dtype,
               'device': 'meta'}
        print(json.dumps(row))
        return row

    device = default_device(device)
    forward, step, carry, n_frames = build(args.graph, batch, args.dtype,
                                           device, k=args.k)
    records, dispatch_bytes = account(forward)
    by_stage, analytic_bytes, analytic_flops = totals(records)
    with serving_numerics(), torch.inference_mode():
        ms, carry = timing.slope_ms(step, carry, args.n_iters,
                                    2 * args.n_iters, device)
        if not bool(torch.isfinite(carry).all()):
            raise AssertionError('the chained carry is not finite')
    dt = ms / 1e3
    card = timing.card_line(device)
    hbm = timing.HBM_PEAK_GBPS
    peak = timing.PEAK_TFLOPS[args.dtype]

    def gbps(nbytes):
        return nbytes / dt / 1e9

    print('\n# Roofline — {} batch={} {} ({}: {})\n'.format(
        args.graph, batch, args.dtype, device.type, card))
    print('peaks: {}; {}\n'.format(timing.PEAK_NAMES['hbm'],
                                   timing.PEAK_NAMES[args.dtype]))
    print('measured: {:.2f} ms/call, {:.1f} frames/s\n'.format(
        dt * 1e3, n_frames / dt))
    print('| stage | ops | GB moved (analytic) | share | GFLOP |')
    print('|---|---|---|---|---|')
    for key in sorted(by_stage, key=lambda s: -by_stage[s]['bytes']):
        v = by_stage[key]
        print('| {} | {} | {:.3f} | {:.1%} | {:.1f} |'.format(
            key, v['n'], v['bytes'] / 1e9, v['bytes'] / analytic_bytes,
            v['flops'] / 1e9))
    print()
    print('| accounting | bytes/call | achieved GB/s | % HBM peak '
          '| TFLOP/s | % compute peak |')
    print('|---|---|---|---|---|---|')
    for name, b in (('analytic lower bound', analytic_bytes),
                    ('dispatch upper estimate', dispatch_bytes)):
        tflops = analytic_flops / dt / 1e12
        print('| {} | {:.2f} GB | {:.0f} | {:.1%} | {:.1f} | {:.1%} |'.format(
            name, b / 1e9, gbps(b), gbps(b) / hbm, tflops, tflops / peak))
    print()
    row = {
        'graph': args.graph, 'batch': batch, 'dtype': args.dtype,
        'backend': device.type,
        'ms_per_call': round(dt * 1e3, 3),
        'frames_per_s': round(n_frames / dt, 3),
        'n_ops': len(records),
        'analytic_bytes': analytic_bytes,
        'dispatch_bytes': dispatch_bytes,
        'analytic_gbps': round(gbps(analytic_bytes), 2),
        'dispatch_gbps': round(gbps(dispatch_bytes), 2),
        'pct_hbm_peak_analytic': round(gbps(analytic_bytes) / hbm, 4),
        'pct_hbm_peak_dispatch': round(gbps(dispatch_bytes) / hbm, 4),
        'analytic_flops': analytic_flops,
        'tflops': round(analytic_flops / dt / 1e12, 2),
        'pct_compute_peak': round(analytic_flops / dt / 1e12 / peak, 4),
        'hbm_peak': timing.PEAK_NAMES['hbm'],
        'compute_peak': timing.PEAK_NAMES[args.dtype],
        'device': card,
    }
    print(json.dumps(row))
    return row


if __name__ == '__main__':
    main()
