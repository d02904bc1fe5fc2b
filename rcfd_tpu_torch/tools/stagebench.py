"""Per-stage timing of bench.py's FusionNet on the card (counterpart of
tools/stagebench.py).

Times each DecoderBlock (``deconv5`` ... ``deconv0``), ``output0`` and the
encoder alone, at their shapes in a 900x1600 frame, batch norm folded,
then cast: a chain of calls whose carry is one element of the previous
output, fed back as an invisible perturbation of the input
(``timing.slope_ms``, the slope between chains of ``--n`` and 6 x
``--n`` calls). Prints ms a call a stage and the decoder's total, then
one JSON line (the JAX tool prints none): the stages' ms, the decoder's
total, ``backend`` and ``device`` (the card's name and power limit).

    python -m rcfd_tpu_torch.tools.stagebench [--dtype bfloat16]
        [--batch 1] [--n 8] [--stages deconv1 output0]
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from .. import default_device
from ..pipeline import serving_numerics
from . import serving_config, timing


def stage_shapes(config: dict, b: int, h: int, w: int):
    """NCHW input shapes of each stage of a FusionNet of ``config`` at an
    h x w frame: each block's input (the level below's output, the latent
    at the bottom) and skip (the encoder's image features at its level),
    deconv0's input and output0's, the encoder's image and depth."""
    enc = config['n_filters_encoder_image']
    dec = config['n_filters_decoder']
    sizes = [(math.ceil(h / 2 ** i), math.ceil(w / 2 ** i))
             for i in range(1, len(enc) + 1)]
    shapes = {}
    for level in range(len(enc) - 1, 0, -1):
        i = len(enc) - 1 - level
        cin = enc[-1] if i == 0 else dec[i - 1]
        shapes['deconv{}'.format(level)] = [
            (b, cin) + sizes[level], (b, enc[level - 1]) + sizes[level - 1]]
    shapes['deconv0'] = [(b, dec[-2]) + sizes[0]]
    shapes['output0'] = [(b, dec[-1], h, w)]
    shapes['encoder'] = [(b, config['input_channels_image'], h, w),
                         (b, config['input_channels_depth'], h, w)]
    return shapes


def make_stages(model, shapes, h: int, w: int, dtype, device, rng):
    """Each stage as (fn, inputs): ``fn(*inputs)`` is the stage's output
    (the encoder's latent); the inputs are uniform [0, 1) draws from
    ``rng`` in the JAX tool's order, in ``dtype`` on ``device``."""
    def arr(shape):
        return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(
            device, dtype)

    decoder = model.decoder
    stages = {}
    for name, shp in shapes.items():
        inputs = tuple(arr(s) for s in shp)
        if name == 'deconv0':
            fn = (lambda blk: lambda x: blk(x, shape=(h, w)))(decoder.deconv0)
        elif name == 'output0':
            fn = decoder.output0
        elif name == 'encoder':
            fn = (lambda enc: lambda image, depth: enc(image, depth)[0])(
                model.encoder)
        else:
            fn = (lambda blk: lambda x, skip: blk(x, skip=skip))(
                getattr(decoder, name))
        stages[name] = (fn, inputs)
    return stages


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.stagebench')
    parser.add_argument('--dtype', default='bfloat16')
    parser.add_argument('--batch', type=int, default=1)
    parser.add_argument('--n', type=int, default=8,
                        help='the shorter chain of the slope (the longer '
                             'is 6 x n)')
    parser.add_argument('--stages', nargs='*', default=None,
                        help='subset of stage names to run')
    return parser


def main(argv=None, device=None):
    """Time the stages on ``device`` (``cuda`` unless ``device='cpu'``).
    Returns the JSON row printed last."""
    args = build_parser().parse_args(argv)
    if args.n < 1:
        raise SystemExit('--n must be >= 1')
    device = default_device(device)
    dtype = 'bfloat16' if args.dtype == 'bfloat16' else 'float32'
    h, w = serving_config.HEIGHT, serving_config.WIDTH
    model = serving_config.fusionnet_folded(dtype, device)
    stages = make_stages(
        model, stage_shapes(serving_config.CONFIG, args.batch, h, w),
        h, w, serving_config.DTYPES[dtype], device,
        np.random.default_rng(0))
    names = args.stages or list(stages)
    results = {}
    n_lo, n_hi = args.n, args.n * 6
    with serving_numerics(), torch.inference_mode():
        for name in names:
            fn, inputs = stages[name]

            def step(c, fn=fn, inputs=inputs):
                y = fn(timing.perturb(inputs[0], c), *inputs[1:])
                return y[0, 0, 0, 0].float()

            t0 = time.perf_counter()
            ms, _ = timing.slope_ms(step, timing.scalar_carry(device), n_lo,
                                    n_hi, device)
            results[name] = ms
            print('{:10s} {:8.3f} ms  ({:.1f}s in all)'.format(
                name, ms, time.perf_counter() - t0), flush=True)
    total = sum(v for k, v in results.items() if k != 'encoder')
    print('{:10s} {:8.3f} ms'.format('dec total', total))
    row = {'harness': 'stagebench', 'dtype': dtype, 'batch': args.batch,
           'n': args.n, 'stages_ms': {k: round(v, 4)
                                      for k, v in results.items()},
           'dec_total_ms': round(total, 4), 'backend': device.type,
           'device': timing.card_line(device)}
    print(json.dumps(row))
    return row


if __name__ == '__main__':
    main()
