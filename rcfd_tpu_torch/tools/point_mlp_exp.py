"""RadarNet's point MLP on the card: whether a point's features depend on
the batch's row count, and what the row tiles of FullyConnectedEncoder
cost.

    python -m rcfd_tpu_torch.tools.point_mlp_exp [--rounds 8]
        [--out point_mlp_exp.json]

At the canonical widths (3 -> 32 -> 64 -> 128 -> 128 -> 128 -> 128 x 28 x
9), weights drawn from a seed, float32 under the serving numerics, three
ways to run the MLP over rows:

  single   one product a layer over all rows (the encoder before its row
           tiles)
  tiles    FullyConnectedEncoder.forward: MLP_TILE_ROWS rows a product,
           one tile after another
  batched  one baddbmm a layer over a (rows / MLP_TILE_ROWS,
           MLP_TILE_ROWS, C) view, the weight broadcast over the tiles
           (cuBLAS's strided-batched product)

For each, 240 points at the head of 256, 512, 1024 and 4096 rows, and at
rows 64 and 128 of 512 (where the bridge's K = 64 and K = 128 put a second
frame's points): the rows whose features differ from the 256-row run's,
bit for bit. Then each way's device time at 64 rows (one serving frame of
K = 64) and 1024 (a batched request of 16), CUDA events, median of 50; and
paired rounds of a float32 slice request (one 900x1600 frame, 64 points)
and a forward_batched request of B = 16, with the encoder's forward as
``single`` and as ``tiles`` in turns, on the same weights and requests.
Prints the card's name and power limit and one JSON object. Card only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..models import FusionNetModel
from ..models.networks import MLP_TILE_ROWS, FullyConnectedEncoder
from ..nn.layers import init_parameters
from ..pipeline import TwoStagePipeline, serving_numerics
from . import bridgebench, serving_config, timing

N_POINTS = 240
ROWS = (256, 512, 1024, 4096)
OFFSETS = (64, 128)


def single(encoder, x):
    """One product a layer over every row."""
    return encoder.mlp(x)


def batched(encoder, x):
    """One strided-batched product a layer over the row tiles."""
    n, t = x.shape[0], MLP_TILE_ROWS
    padded = max(-(-n // t), 1) * t
    y = torch.cat([x, x.new_zeros(padded - n, x.shape[1])]).view(
        padded // t, t, -1)
    for layer in encoder.mlp:
        fc = layer.fully_connected
        y = torch.baddbmm(fc.bias, y, fc.weight.t().expand(
            y.shape[0], -1, -1))
        y = layer.activation(y)
    return y.reshape(padded, -1)[:n]


WAYS = {'single': single, 'tiles': FullyConnectedEncoder.forward,
        'batched': batched}


def row_dependence(encoder, points):
    """Per way, the rows of 240 points whose features differ from the
    256-row run's, at each row count and offset."""
    out = {}
    with torch.inference_mode(), serving_numerics():
        for name, way in WAYS.items():
            def features(rows, offset=0):
                x = torch.zeros(rows, 3, device=points.device)
                x[offset:offset + N_POINTS] = points
                return way(encoder, x)[offset:offset + N_POINTS]

            ref = features(ROWS[0])
            row = {}
            for rows in ROWS[1:]:
                row['rows {}'.format(rows)] = int(
                    (features(rows) != ref).any(1).sum())
            for offset in OFFSETS:
                row['offset {} of 512'.format(offset)] = int(
                    (features(512, offset) != ref).any(1).sum())
            out[name] = row
    return out


def device_ms(fn, n=50, warmup=5):
    """Median device ms of ``fn()`` over ``n`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def mlp_times(encoder, device):
    out = {}
    with torch.inference_mode(), serving_numerics():
        for rows in (64, 1024):
            x = torch.rand(rows, 3, device=device) * 100
            for name, way in WAYS.items():
                out['{} {} rows'.format(name, rows)] = device_ms(
                    lambda: way(encoder, x))
    return out


def paired_requests(device, rounds, seed=0):
    """Paired rounds of a slice request and a B = 16 batched request with
    the encoder's forward as ``single`` and ``tiles`` in turns: the median
    ms of each, and of their per-round difference."""
    rn = bridgebench.build_model((900, 288), torch.float32, device, seed)
    fn = FusionNetModel(**serving_config.FUSIONNET, device='cpu')
    init_parameters(fn, torch.Generator().manual_seed(seed + 1))
    pipe = TwoStagePipeline(rn, fn.to(device), 900, 1600, device=device)
    rng = np.random.default_rng(seed)

    def frame_points(b):
        return np.stack([rng.integers(0, 1600, (b, 64)),
                         rng.integers(0, 900, (b, 64)),
                         rng.random((b, 64)) * 79 + 1], -1).astype(np.float32)

    requests = {
        'slice': lambda: pipe(rng.integers(0, 256, (1, 900, 1600, 3),
                                           dtype=np.uint8),
                              frame_points(1)[0], np.ones(64, bool)),
        'batched B=16': lambda: pipe.forward_batched(
            rng.integers(0, 256, (16, 900, 1600, 3), dtype=np.uint8),
            frame_points(16), np.ones((16, 64), bool))}
    tiled = FullyConnectedEncoder.forward
    out = {}
    try:
        for name, request in requests.items():
            times = {'single': [], 'tiles': []}
            for i in range(rounds + 1):  # the first round warms up
                for way in (('single', 'tiles') if i % 2 else
                            ('tiles', 'single')):
                    FullyConnectedEncoder.forward = WAYS[way]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    request()
                    torch.cuda.synchronize()
                    if i:
                        times[way].append((time.perf_counter() - t0) * 1e3)
            diff = np.subtract(times['tiles'], times['single'])
            out[name] = dict(
                single_ms=float(np.median(times['single'])),
                tiles_ms=float(np.median(times['tiles'])),
                tiles_minus_single_ms=float(np.median(diff)),
                rounds=rounds, single=times['single'], tiles=times['tiles'])
    finally:
        FullyConnectedEncoder.forward = tiled
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.point_mlp_exp')
    parser.add_argument('--rounds', type=int, default=8)
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('point_mlp_exp runs on the card only')
    device = torch.device('cuda')
    card = timing.card_line(device)
    print(card, flush=True)
    encoder = FullyConnectedEncoder(3, [32, 64, 128, 128, 128],
                                    128 * 28 * 9).eval()
    init_parameters(encoder, torch.Generator().manual_seed(0))
    encoder.to(device)
    rng = np.random.default_rng(0)
    points = torch.from_numpy(np.stack([
        rng.uniform(0, 1888, N_POINTS), rng.uniform(0, 900, N_POINTS),
        rng.uniform(1, 80, N_POINTS)], 1).astype(np.float32)).to(device)
    result = dict(device=card, tile_rows=MLP_TILE_ROWS)
    result['differing_rows'] = row_dependence(encoder, points)
    print('differing rows: {}'.format(json.dumps(result['differing_rows'])),
          flush=True)
    result['mlp_ms'] = mlp_times(encoder, device)
    print('mlp ms: {}'.format(json.dumps(result['mlp_ms'])), flush=True)
    result['requests'] = paired_requests(device, args.rounds)
    print('requests: {}'.format(json.dumps(
        {k: {m: v[m] for m in ('single_ms', 'tiles_ms',
                               'tiles_minus_single_ms')}
         for k, v in result['requests'].items()})), flush=True)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == '__main__':
    sys.exit(0 if main() else 1)
