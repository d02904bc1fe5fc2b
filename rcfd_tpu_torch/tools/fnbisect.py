"""Bisect bench.py's FusionNet serving cost into encoder and decoder shares
on the card (counterpart of tools/fnbisect.py), at the headline batch,
bf16, batch norm folded:

  enc    the twin ResNet encoders + the weight_and_project fusion a scale
  full   + the MultiScaleDecoder and the sigmoid depth mapping
  fullps the JAX tool's ``full`` under PerfConfig.packed_skip; without
         ``--s2d`` that rewrite does not engage in the JAX package either,
         so the port times ``full``'s graph

``--s2d`` other than 0 (the JAX package's space-to-depth stem, a TPU
layout rewrite) is refused. Each cut is timed by ``timing.slope_ms``
between chains of ``--n_scan`` and 2 x ``--n_scan`` calls (the JAX tool
divides one chain of ``--n_scan``), each call's image input perturbed by
1e-30 of the previous call's reduced outputs. Prints ms a frame a cut and
its difference from the previous cut, then one JSON line (the JAX tool
prints none) with ``backend`` and ``device``.

    python -m rcfd_tpu_torch.tools.fnbisect [--batch 32] [--n_scan 2]
        [--cuts enc full]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import default_device
from ..pipeline import serving_numerics
from . import serving_config, timing

CUTS = ('enc', 'full', 'fullps')


def cuts(model, cdtype):
    """Each cut as ``fn(image, input_depth)`` -> a float32 scalar, the sum
    of everything the cut computes: the image in the compute dtype, the
    input depth (uint16 codes or float) cast in the call, as the JAX
    tool's bodies."""
    def cut_enc(img, dep):
        latent, skips = model.encoder(img, dep.to(cdtype))
        acc = latent.float().sum()
        for sk in skips:
            acc = acc + sk.float().sum()
        return acc

    def cut_full(img, dep):
        return model(img, dep.to(cdtype)).float().sum()

    return {'enc': cut_enc, 'full': cut_full, 'fullps': cut_full}


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.fnbisect')
    parser.add_argument('--batch', type=int, default=32)
    parser.add_argument('--n_scan', type=int, default=2)
    parser.add_argument('--cuts', nargs='*', default=['enc', 'full'],
                        choices=CUTS)
    parser.add_argument('--s2d', type=int, default=0,
                        help='space-to-depth pack factor of the inputs: a '
                             'TPU rewrite, refused unless 0')
    return parser


def main(argv=None, device=None):
    """Time the cuts on ``device`` (``cuda`` unless ``device='cpu'``).
    Returns the JSON row printed last."""
    args = build_parser().parse_args(argv)
    if args.s2d:
        timing.refuse_unported('--s2d', args.s2d)
    if args.n_scan < 1:
        raise SystemExit('--n_scan must be >= 1')
    device = default_device(device)
    cdtype = torch.bfloat16
    model = serving_config.fusionnet_folded('bfloat16', device)
    b = args.batch
    image, depth, response = serving_config.inputs(
        b, np.random.default_rng(0))
    image, input_depth = serving_config.on(
        device, image, np.concatenate([depth, response], axis=-1))
    # integer transport: the image is cast once, the depth in each call
    image = image.permute(0, 3, 1, 2).to(cdtype)
    input_depth = input_depth.permute(0, 3, 1, 2).contiguous()
    fns = cuts(model, cdtype)
    print('backend:', device.type, 'batch={}'.format(b), flush=True)
    results, prev = {}, None
    with serving_numerics(), torch.inference_mode():
        for name in args.cuts:
            def step(img, fn=fns[name]):
                return img + (fn(img, input_depth) * 1e-30).to(img.dtype)

            t0 = time.perf_counter()
            ms, _ = timing.slope_ms(step, image, args.n_scan,
                                    2 * args.n_scan, device)
            ms /= b
            delta = '' if prev is None else \
                '  (+{:5.2f} vs prev)'.format(ms - prev)
            prev = ms
            results[name] = round(ms, 4)
            print('{:6s} {:6.2f} ms/frame{}  [{:.0f}s]'.format(
                name, ms, delta, time.perf_counter() - t0), flush=True)
    row = {'harness': 'fnbisect', 'batch': b, 'n_scan': args.n_scan,
           'dtype': 'bfloat16', 'ms_per_frame': results,
           'backend': device.type, 'device': timing.card_line(device)}
    print(json.dumps(row))
    return row


if __name__ == '__main__':
    main()
