"""Microbenchmarks of the port's custom ops and paths on the card
(counterpart of tools/microbench.py).

  scatter        the quasi-dense scatter of K crops (900x288, float32):
                 the exact float max (``ops/scatter.py``) against K1
                 (``ops/scatter_cuda.py``), which quantizes the response to
                 14 bits first, so the two differ in ties
  roi_pool       the 1/2-scale column ROI pool of K windows
  reproject      one neighbor frame's reprojection and z-buffer merge of
                 stage 0 (``geometry/reproject.py``)
  radarnet       RadarNet's scatter inference on one frame
                 (``radarnet_main.make_forward_fn``: K1 on the card)
  pipeline       the bf16 folded two-stage pipeline, one frame a call, then
                 ``forward_batched`` of B = 4
  pipeline_scan  chained ``forward_batched`` calls at B = 4 and 8
  train          a canonical train step of each model
                 (bash/train_*_nuscenes.sh's batch and shapes) in
                 RCFD_TRAIN_DTYPE's dtype
  io             depth PNG decode of 64 900x1600 frames by the port's codec
                 (``native.batch_read_depth``, 8 threads); the JAX tool's
                 PIL column has no counterpart (the port has no Pillow)

Every time is ``timing.slope_ms``'s: the slope between chains of n and 2n
calls (the JAX tool's train slope keeps its own lengths, 2 and 8). Prints
a line an op, then one JSON line (the JAX tool prints none): the ms of
each measurement, ``backend`` and ``device``.

    python -m rcfd_tpu_torch.tools.microbench [--ops scatter roi_pool
        reproject] [--k 128]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from .. import default_device, fusionnet_main, native, radarnet_main
from ..data import io as data_utils
from ..data.transforms import Transforms
from ..geometry.reproject import merge_neighbor_into_main
from ..models import FusionNetModel, RadarNetModel
from ..ops import scatter as exact_scatter
from ..ops import scatter_cuda
from ..ops.roi_pool import roi_pool_column
from ..pipeline import serving_numerics
from ..training import make_optimizer, training_numerics
from . import serving_config, timing

OPS = ('scatter', 'roi_pool', 'reproject', 'radarnet', 'io', 'pipeline',
       'pipeline_scan', 'train')


def timed(fn, device, n: int = 10):
    """ms a call of ``fn()``: the slope between chains of n and 2n
    calls."""
    return timing.slope_ms(lambda c: fn(), None, n, 2 * n, device)[0]


def scatter_inputs(k: int, device, h=900, w=1600, ph=900, pw=288):
    """The JAX tool's scatter inputs: K float32 crops, padded x, z,
    every point valid."""
    rng = np.random.default_rng(0)
    pad = pw // 2
    crops = rng.random((k, ph, pw), dtype=np.float32)
    x = rng.integers(pad, w + pad, size=(k,)).astype(np.float32)
    z = rng.random(k, dtype=np.float32) * 70 + 1
    return serving_config.on(device, crops, x, z, np.ones((k,), bool))


def bench_scatter(results, device, k=128, h=900, w=1600, ph=900, pw=288):
    args = scatter_inputs(k, device, h, w, ph, pw)
    t_exact = timed(lambda: exact_scatter.scatter_quasi_dense(
        *args, h, w, (ph, pw)), device)
    t_k1 = timed(lambda: scatter_cuda.scatter_quasi_dense(
        *args, h, w, (ph, pw)), device)
    print('scatter K={}: exact {:.3f} ms'.format(k, t_exact))
    print('scatter K={}: K1 {:.3f} ms ({:.2f}x)'.format(k, t_k1,
                                                       t_exact / t_k1))
    results['scatter'] = {'k': k, 'exact_ms': t_exact, 'k1_ms': t_k1}


def bench_roi_pool(results, device, b=1, k=128, patch_h=900, patch_w=288,
                   img_w=1888):
    rng = np.random.default_rng(0)
    # the 1/2-scale skip is the most expensive pooled level
    feat, x1 = serving_config.on(
        device, rng.random((b, 32, patch_h // 2, img_w // 2),
                           dtype=np.float32),
        rng.integers(0, img_w - patch_w, size=(b, k)).astype(np.float32))
    t = timed(lambda: roi_pool_column(
        feat, x1, box_width=patch_w, box_y1=0, box_y2=patch_h,
        spatial_scale=0.5, output_size=(patch_h // 2, patch_w // 2)),
        device, n=5)
    print('roi_pool_column 1/2-scale K={}: {:.3f} ms'.format(k, t))
    results['roi_pool'] = {'k': k, 'ms': t}


def bench_reproject(results, device, h=900, w=1600):
    rng = np.random.default_rng(0)
    main = rng.random((h, w), dtype=np.float32) * 60
    neighbor = rng.random((h, w), dtype=np.float32) * 60
    kmat = np.array([[1266.4, 0, 816.3], [0, 1266.4, 491.5], [0, 0, 1]],
                    np.float32)
    m = np.eye(4, dtype=np.float32)
    main_t, neighbor_t = serving_config.on(device, main, neighbor)
    t = timed(lambda: merge_neighbor_into_main(
        main_t, neighbor_t, kmat, m, kmat, device=device), device, n=5)
    print('reproject+merge {}x{}: {:.3f} ms ({:.2f} Gpix/s) — one neighbor '
          'frame of the multi-frame GT merge'.format(h, w, t,
                                                     h * w / t / 1e6))
    results['reproject'] = {'ms': t}


def bench_radarnet(results, device, k=64, h=900, w=1600):
    """RadarNet's scatter inference (stage 1) on one frame."""
    model = serving_config.build(RadarNetModel, serving_config.RADARNET, 0,
                                 device)
    forward = radarnet_main.make_forward_fn(
        model, Transforms(normalized_image_range=[0, 1]), h, w)
    image, points, valid = serving_config.frames_and_points(
        1, k, np.random.default_rng(0), float_images=True)
    image, points, valid = serving_config.on(device, image, points[0],
                                             valid[0])
    t = timed(lambda: forward(image, points, valid), device, n=3)
    print('radarnet inference K={} full frame: {:.1f} ms ({:.2f} '
          'frames/s)'.format(k, t, 1e3 / t))
    results['radarnet'] = {'k': k, 'ms': t}


def bench_pipeline(results, device, k=64):
    """The fused two-stage pipeline a frame, then batched (B = 4)."""
    pipe = serving_config.pipeline('bfloat16', device)
    image, points, valid = serving_config.frames_and_points(
        1, k, np.random.default_rng(0), float_images=True)
    image, points, valid = serving_config.on(device, image, points[0],
                                             valid[0])
    t = timed(lambda: pipe(image, points, valid), device, n=3)
    print('fused two-stage pipeline K={} full frame: {:.1f} ms ({:.2f} '
          'frames/s)'.format(k, t, 1e3 / t))
    b = 4
    images_b = image.expand(b, *image.shape[1:])
    points_b = points[None].expand(b, *points.shape)
    valid_b = valid[None].expand(b, k)
    tb = timed(lambda: pipe.forward_batched(images_b, points_b, valid_b),
               device, n=3)
    print('fused two-stage pipeline K={} batched B={}: {:.1f} ms/frame '
          '({:.2f} frames/s)'.format(k, b, tb / b, b * 1e3 / tb))
    results['pipeline'] = {'k': k, 'ms': t, 'batched_b': b,
                           'batched_ms_per_frame': tb / b}


def bench_pipeline_scan(results, device, k=64, batches=(4, 8), n_scan=8):
    """Chained batched forwards, the dense output fed back into the
    images."""
    pipe = serving_config.pipeline('bfloat16', device)
    rng = np.random.default_rng(0)
    out = {}
    for b in batches:
        images, points, valid = serving_config.on(
            device, *serving_config.frames_and_points(
                b, k, rng, float_images=True))

        def step(img):
            dense = pipe.forward_batched(img, points, valid)[0]
            return img + dense[..., None] * 1e-12

        with serving_numerics(), torch.inference_mode():
            ms = timing.slope_ms(step, images, n_scan, 2 * n_scan,
                                 device)[0] / b
        print('pipeline scan-mode K={} B={}: {:.1f} ms/frame ({:.2f} '
              'frames/s device-only)'.format(k, b, ms, 1e3 / ms), flush=True)
        out[str(b)] = ms
    results['pipeline_scan'] = {'k': k, 'ms_per_frame': out}


def _train_slope(step, batch, transforms, b, points_shape, device,
                 n_lo=2, n_hi=8):
    generator = torch.Generator(device=device).manual_seed(0)

    def one(c):
        return step(batch, transforms.draws(generator, b, 0.0, points_shape),
                    1e-4)['loss']

    with training_numerics():
        ms = timing.slope_ms(one, None, n_lo, n_hi, device)[0]
    print('  {:.1f} ms/step = {:.1f} samples/s/chip'.format(
        ms, b / ms * 1e3), flush=True)
    return ms


def bench_train(results, device):
    """A canonical train step of each model, slope between chains of 2 and
    8 steps."""
    rng = np.random.default_rng(0)
    transforms = Transforms(normalized_image_range=[0, 1])
    dtype = os.environ.get('RCFD_TRAIN_DTYPE', 'float32') or 'float32'
    # RadarNet: bash/train_radarnet_nuscenes.sh (bs 6, patch 900x288, K=4)
    b, k, ph, pw = 6, 4, 900, 288
    w_pad = 1600 + pw
    model = serving_config.build(RadarNetModel, serving_config.RADARNET, 0,
                                 device, trainable=True)
    step = radarnet_main.TrainStep(
        model, transforms, make_optimizer(model, 1e-4, 0.0), (ph, pw),
        max_distance_correspondence=0.4, set_invalid_to_negative_class=True,
        w_positive_class=2.0)
    x1 = rng.integers(0, w_pad - pw, (b, k)).astype(np.float32)
    batch = serving_config.on(
        device, rng.random((b, ph, w_pad, 3), np.float32) * 255,
        np.stack([x1 + pw // 2, rng.integers(0, ph, (b, k)).astype(
            np.float32), rng.random((b, k), np.float32) * 70 + 1], axis=-1),
        np.stack([x1, np.zeros_like(x1), x1 + pw, np.full_like(x1, ph)],
                 axis=-1),
        rng.random((b, k, ph, pw, 1), np.float32) * 70)
    print('radarnet train step bs={} K={} patch={}x{} dtype={}:'.format(
        b, k, ph, pw, dtype), flush=True)
    rn_ms = _train_slope(step, batch, transforms, b, (b, k, 3), device)

    # FusionNet: bash/train_fusionnet_nuscenes.sh (bs 16, 448x448 crops)
    b, hw = 16, 448
    model = serving_config.build(FusionNetModel, serving_config.FUSIONNET,
                                 0, device, trainable=True)
    step = fusionnet_main.TrainStep(
        model, transforms, make_optimizer(model, 1e-4, 0.0), 'l1', 0.0, 2.0,
        3, 7, 1.5, -1)
    batch = serving_config.on(
        device, rng.random((b, hw, hw, 3), np.float32) * 255,
        rng.random((b, hw, hw, 1), np.float32) * 80,
        rng.random((b, hw, hw, 1), np.float32),
        rng.random((b, hw, hw, 1), np.float32) * 80,
        rng.random((b, hw, hw, 1), np.float32) * 80)
    print('fusionnet train step bs={} {}x{} dtype={}:'.format(
        b, hw, hw, dtype), flush=True)
    fn_ms = _train_slope(step, batch, transforms, b, (), device)
    results['train'] = {'dtype': dtype, 'radarnet_ms_per_step': rn_ms,
                        'fusionnet_ms_per_step': fn_ms}


def bench_io(results, n=64, h=900, w=1600, threads=8):
    """Depth PNG decode throughput of the port's codec."""
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i in range(n):
            p = os.path.join(d, '{}.png'.format(i))
            data_utils.save_depth(rng.random((h, w), dtype=np.float32) * 80,
                                  p)
            paths.append(p)
        t0 = time.perf_counter()
        native.batch_read_depth(paths, h, w, n_threads=threads)
        t = time.perf_counter() - t0
    print('depth decode {}x{}x{}: port codec ({} threads) {:.1f} img/s; '
          'no PIL column (the port has no Pillow)'.format(n, h, w, threads,
                                                         n / t))
    results['io'] = {'n': n, 'images_per_s': n / t}


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.microbench')
    parser.add_argument('--ops', nargs='+', choices=OPS,
                        default=['scatter', 'roi_pool', 'reproject'])
    parser.add_argument('--k', type=int, default=128)
    return parser


def main(argv=None, device=None):
    """Run the chosen microbenchmarks on ``device`` (``cuda`` unless
    ``device='cpu'``). Returns the JSON row printed last."""
    args = build_parser().parse_args(argv)
    device = default_device(device)
    results = {}
    with serving_numerics(), torch.inference_mode():
        if 'scatter' in args.ops:
            bench_scatter(results, device, k=args.k)
        if 'roi_pool' in args.ops:
            bench_roi_pool(results, device, k=args.k)
        if 'reproject' in args.ops:
            bench_reproject(results, device)
        if 'radarnet' in args.ops:
            bench_radarnet(results, device, k=min(args.k, 64))
        if 'io' in args.ops:
            bench_io(results)
        if 'pipeline' in args.ops:
            bench_pipeline(results, device, k=min(args.k, 64))
        if 'pipeline_scan' in args.ops:
            bench_pipeline_scan(results, device, k=min(args.k, 64))
    if 'train' in args.ops:
        bench_train(results, device)
    row = {'harness': 'microbench', 'ops': args.ops, 'results': results,
           'backend': device.type, 'device': timing.card_line(device)}
    print(json.dumps(row))
    return row


if __name__ == '__main__':
    main()
