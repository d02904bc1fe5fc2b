"""Bisect the fused two-stage pipeline's batched serving cost on the card
(counterpart of tools/pipebisect.py): cut the real graph of
``TwoStagePipeline.forward_batched`` (optimize=True, bf16) at successive
points and time each cut; successive differences are the in-context stage
costs.

  rn      decode + pad + RadarNet (the pipeline's decode chunks) -> crops
  scatter + the scatter of the B frames (the pipeline's own route: the
          exact max by default, K1 under ``PerfConfig(pallas_scatter=True)``,
          which RCFD_PALLAS_SCATTER=1 gives here as in the JAX tool)
  bridge  + the PNG-codec quantization and FusionNet's input stack
  full    + FusionNet
  fn      FusionNet alone on stand-in bridge inputs made from the image

Each cut is timed by ``timing.slope_ms`` between chains of ``--n_scan`` and
2 x ``--n_scan`` calls (the JAX tool divides one chain of ``--n_scan``), the
float images carried with 1e-30 of the previous call's summed output added.
Prints ms a frame a cut and the difference from the previous, then one
JSON line (the JAX tool prints none) with ``backend`` and ``device``.

    python -m rcfd_tpu_torch.tools.pipebisect [--cuts rn scatter bridge
        full fn] [--b 4] [--k 64]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import default_device
from ..nn.perf import perf_from_env
from ..pipeline import decode_chunk_count, serving_numerics
from . import serving_config, timing

CUTS = ('rn', 'scatter', 'bridge', 'full', 'fn')


def cuts(pipe, valid):
    """Each cut as ``fn(images, points)`` -> its output in float32 (the
    JAX tool's): rn the crops (B, K, ph, pw); scatter depth + response
    (B, H, W); bridge FusionNet's input summed over its two channels;
    full and fn the dense depth (B, H, W)."""
    h, w = pipe.image_height, pipe.image_width
    patch = pipe.radarnet.input_patch_size_image

    def stage_rn(images, points):
        b, k = points.shape[0], points.shape[1]
        return pipe.radarnet_stage_batched(
            images, points, decode_chunk_count(
                b, k, pipe.radarnet.perf.decode_chunks))

    def stage_scatter(crops, xs, zs):
        return pipe._scatter_for(crops.shape[1], True)(
            crops, xs, zs, valid, image_height=h, image_width=w,
            patch_size=patch)

    def cut_rn(images, points):
        return stage_rn(images, points)[1].float()

    def cut_scatter(images, points):
        _, crops, xs, zs = stage_rn(images, points)
        d, r = stage_scatter(crops, xs, zs)
        return (d + r).float()

    def cut_bridge(images, points):
        _, crops, xs, zs = stage_rn(images, points)
        return pipe.bridge(*stage_scatter(crops, xs, zs))[2].float().sum(1)

    def cut_full(images, points):
        image_t, crops, xs, zs = stage_rn(images, points)
        input_depth = pipe.bridge(*stage_scatter(crops, xs, zs))[2]
        return pipe.fusionnet(image_t, input_depth)[:, 0].float()

    def cut_fn(images, points):
        image_t = pipe.transforms.transform(images.float()).permute(
            0, 3, 1, 2).to(pipe.compute_dtype)
        # stand-in bridge inputs derived from the image, so that they are
        # computed in every call
        d = torch.clamp(image_t[:, 0].float() * 0.3, 0, 80)
        r = torch.clamp(image_t[:, 1].float(), 0, 1)
        input_depth = pipe.bridge(d, r)[2]
        return pipe.fusionnet(image_t, input_depth)[:, 0].float()

    return {'rn': cut_rn, 'scatter': cut_scatter, 'bridge': cut_bridge,
            'full': cut_full, 'fn': cut_fn}


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.pipebisect')
    parser.add_argument('--b', type=int, default=4)
    parser.add_argument('--k', type=int, default=64)
    parser.add_argument('--n_scan', type=int, default=8)
    parser.add_argument('--cuts', nargs='*', choices=CUTS,
                        default=['rn', 'scatter', 'bridge', 'full', 'fn'])
    return parser


def main(argv=None, device=None, perf=None):
    """Time the cuts on ``device`` (``cuda`` unless ``device='cpu'``);
    ``perf`` is RadarNet's PerfConfig (default: the RCFD_* gates). Returns
    the JSON row printed last."""
    args = build_parser().parse_args(argv)
    if args.n_scan < 1:
        raise SystemExit('--n_scan must be >= 1')
    device = default_device(device)
    pipe = serving_config.pipeline(
        'bfloat16', device, perf=perf_from_env() if perf is None else perf)
    b, k = args.b, args.k
    images, points, valid = serving_config.on(
        device, *serving_config.frames_and_points(
            b, k, np.random.default_rng(0), float_images=True))
    fns = cuts(pipe, valid)
    route = 'K1' if pipe.pallas_scatter else 'exact max'
    print('backend:', device.type, 'B={} K={} n_scan={} scatter={}'.format(
        b, k, args.n_scan, route), flush=True)
    results, prev = {}, None
    with serving_numerics(), torch.inference_mode():
        for name in args.cuts:
            def step(img, fn=fns[name]):
                return img + fn(img, points).sum() * 1e-30

            t0 = time.perf_counter()
            ms, _ = timing.slope_ms(step, images, args.n_scan,
                                    2 * args.n_scan, device)
            ms /= b
            delta = '' if prev is None else \
                '  (+{:5.1f} vs prev)'.format(ms - prev)
            prev = ms
            results[name] = round(ms, 4)
            print('{:8s} {:6.1f} ms/frame{}  [{:.0f}s]'.format(
                name, ms, delta, time.perf_counter() - t0), flush=True)
    row = {'harness': 'pipebisect', 'b': b, 'k': k, 'n_scan': args.n_scan,
           'scatter': route, 'ms_per_frame': results,
           'backend': device.type, 'device': timing.card_line(device)}
    print(json.dumps(row))
    return row


if __name__ == '__main__':
    main()
