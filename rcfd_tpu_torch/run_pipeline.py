"""CLI: fused two-stage inference from files (camera frames + radar point
sets -> dense depth), the port's counterpart of run_pipeline.py.

    python -m rcfd_tpu_torch.run_pipeline \\
        --radarnet_restore_path rn.pth --fusionnet_restore_path fn.pth \\
        --image_path image.txt --radar_path radar.txt \\
        [--ground_truth_path gt.txt] --output_dirpath out --save_outputs

It takes the JAX CLI's flags with the same defaults, reads the manifests'
frames and point sets, serves them on the card through
``TwoStagePipeline.from_checkpoints(optimize=True)`` (one frame a request,
or ``--batch_size`` frames through ``forward_batched``; with
``--data_parallel`` each full batch through ``forward_sharded`` over every
visible card, a batch size that the card count does not divide refused
before anything is served, and the tail batch through
``forward_batched``), and writes the same
three 16-bit PNG streams (output_depth_fusion, output_depth_radar,
output_response_radar) and the same MAE/RMSE/iMAE/iRMSE table in
results.txt.

The quasi-dense scatter is the JAX CLI's: the exact float max by default,
the scatter kernel's 14-bit max (K1: the response quantized to 14 bits
before the max, the first point winning inside one 2^-14 step) with
RCFD_PALLAS_SCATTER set true. The run says which in one line.

Of the JAX package's RCFD_* environment gates this module
reads the four the port has, once, with their JAX
meanings: RCFD_PALLAS_SCATTER, RCFD_FUSED_POOL2, RCFD_FUSED_POOL4 and
RCFD_DECODE_CHUNKS.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import default_device
from . import native
from . import parallel
from .data import io as data_utils
from .data.datasets import RadarNetInferenceDataset
from .data.transport import decode_np
from .nn.perf import perf_from_env
from .pipeline import TwoStagePipeline
from .utils import eval_utils
from .utils.log_utils import log

parser = argparse.ArgumentParser(prog='python -m rcfd_tpu_torch.run_pipeline')
parser.add_argument('--radarnet_restore_path', type=str, required=True)
parser.add_argument('--fusionnet_restore_path', type=str, required=True)
parser.add_argument('--image_path', type=str, required=True)
parser.add_argument('--radar_path', type=str, required=True)
parser.add_argument('--ground_truth_path', type=str, default=None)
parser.add_argument('--patch_size', nargs='+', type=int, default=[900, 288])
# Network settings (canonical defaults; override for non-standard nets)
parser.add_argument('--radarnet_encoder_type', nargs='+', type=str,
                    default=['radarnetv1', 'batch_norm'])
parser.add_argument('--radarnet_n_filters_encoder_image', nargs='+', type=int,
                    default=[32, 64, 128, 128, 128])
parser.add_argument('--radarnet_n_neurons_encoder_depth', nargs='+', type=int,
                    default=[32, 64, 128, 128, 128])
parser.add_argument('--radarnet_n_filters_decoder', nargs='+', type=int,
                    default=[256, 128, 64, 32, 16])
parser.add_argument('--fusionnet_encoder_type', nargs='+', type=str,
                    default=['fusionnet18', 'batch_norm'])
parser.add_argument('--fusionnet_n_filters_encoder_image', nargs='+',
                    type=int, default=[32, 64, 128, 256, 256, 256])
parser.add_argument('--fusionnet_n_filters_encoder_depth', nargs='+',
                    type=int, default=[16, 32, 64, 128, 128, 128])
parser.add_argument('--fusion_type', type=str, default='weight_and_project')
parser.add_argument('--fusionnet_n_filters_decoder', nargs='+', type=int,
                    default=[256, 256, 128, 64, 64, 32])
parser.add_argument('--min_predict_depth', type=float, default=1.0)
parser.add_argument('--max_predict_depth', type=float, default=100.0)
parser.add_argument('--bfloat16', action='store_true',
                    help='bf16 serving (models cast once, float32 outputs)')
parser.add_argument('--output_dirpath', type=str, required=True)
parser.add_argument('--save_outputs', action='store_true')
parser.add_argument('--keep_input_filenames', action='store_true')
parser.add_argument('--verbose', action='store_true')
parser.add_argument('--min_evaluate_depth', type=float, default=0.0)
parser.add_argument('--max_evaluate_depth', type=float, default=80.0)
parser.add_argument('--max_points_inference', type=int, default=0,
                    help='static point-axis size; the default (<= 0) '
                         'auto-sizes from the radar manifest so no frame '
                         'is truncated; pass a positive cap to opt in '
                         'to a fixed size')
parser.add_argument('--batch_size', type=int, default=1,
                    help='frames a request (forward_batched when above 1)')
parser.add_argument('--data_parallel', action='store_true',
                    help='shard each full batch over every visible card '
                         '(forward_sharded); --batch_size must divide by '
                         'the card count')

METRICS = ['mae', 'rmse', 'imae', 'irmse']
STREAMS = ['output_depth_fusion', 'output_depth_radar',
           'output_response_radar']


def main(argv=None, device=None, devices=None):
    """Run the CLI on ``argv`` (sys.argv[1:] when None), on ``device``
    (``cuda`` unless ``device='cpu'``); ``devices`` is the device list of
    ``--data_parallel`` (by default ``parallel.get_devices(device=device)``:
    every visible card, or the CPU once). Returns a summary: frames served,
    the mean metrics (None without ground truth) and the seconds spent in
    setup, reading, serving (to the outputs on the host) and writing."""
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    device = default_device(device)
    if args.data_parallel:
        devices = devices or parallel.get_devices(device=device)
        if args.batch_size % len(devices):
            raise SystemExit(
                '--data_parallel needs batch_size ({}) divisible by the '
                'device count ({})'.format(args.batch_size, len(devices)))
    else:
        devices = None
    perf = perf_from_env()

    os.makedirs(args.output_dirpath, exist_ok=True)
    log_path = os.path.join(args.output_dirpath, 'results.txt')

    image_paths = data_utils.read_paths(args.image_path)
    radar_paths = data_utils.read_paths(args.radar_path)
    gt_available = (args.ground_truth_path is not None and
                    os.path.exists(args.ground_truth_path))
    gt_paths = data_utils.read_paths(args.ground_truth_path) \
        if gt_available else None

    dataset = RadarNetInferenceDataset(
        image_paths=image_paths, radar_paths=radar_paths,
        ground_truth_paths=gt_paths,
        max_points=(None if args.max_points_inference <= 0
                    else args.max_points_inference),
        device=device)

    height, width = native.probe(image_paths[0])
    radarnet_kwargs = dict(
        input_patch_size_image=tuple(args.patch_size),
        encoder_type='-'.join(args.radarnet_encoder_type),
        n_filters_encoder_image=args.radarnet_n_filters_encoder_image,
        n_neurons_encoder_depth=args.radarnet_n_neurons_encoder_depth,
        n_filters_decoder=args.radarnet_n_filters_decoder,
        perf=perf)
    fusionnet_kwargs = dict(
        encoder_type='-'.join(args.fusionnet_encoder_type),
        n_filters_encoder_image=args.fusionnet_n_filters_encoder_image,
        n_filters_encoder_depth=args.fusionnet_n_filters_encoder_depth,
        fusion_type=args.fusion_type,
        n_filters_decoder=args.fusionnet_n_filters_decoder,
        min_predict_depth=args.min_predict_depth,
        max_predict_depth=args.max_predict_depth)
    # passes that only write PNGs (no eval) fetch the uint16 codec grid:
    # half the device-to-host bytes, the same files; eval passes keep
    # float32 so the metrics run on unquantized maps
    codec_d2h = bool(args.save_outputs) and not gt_available
    pipeline = TwoStagePipeline.from_checkpoints(
        args.radarnet_restore_path, args.fusionnet_restore_path,
        image_height=height, image_width=width,
        patch_size=args.patch_size,
        radarnet_kwargs=radarnet_kwargs,
        fusionnet_kwargs=fusionnet_kwargs,
        optimize=True,
        compute_dtype=torch.bfloat16 if args.bfloat16 else None,
        codec_encode=codec_d2h,
        device=device)
    if pipeline.pallas_scatter:
        log('Scatter semantics: the 14-bit max of the scatter kernel (first '
            'point wins inside one 2^-14 step), as the JAX CLI with '
            'RCFD_PALLAS_SCATTER=1')
    else:
        log('Scatter semantics: the exact float max, as the JAX CLI by '
            'default')

    if args.save_outputs:
        dirs = {name: os.path.join(args.output_dirpath, name)
                for name in STREAMS}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)

    if devices is not None:
        log('Data-parallel serving over {} device(s)'.format(len(devices)),
            log_path)

    n_sample = len(image_paths)
    metrics = {k: np.zeros(n_sample) for k in METRICS}
    seconds = dict(setup=time.perf_counter() - t_start, read=0.0, serve=0.0,
                   write=0.0)

    bsz = max(1, args.batch_size)
    for start in range(0, n_sample, bsz):
        idxs = list(range(start, min(start + bsz, n_sample)))
        t0 = time.perf_counter()
        samples = [dataset.get(i) for i in idxs]
        t1 = time.perf_counter()
        if len(idxs) > 1:
            batch = [np.stack([s[j] for s in samples]) for j in range(3)]
            if devices is not None and len(idxs) == bsz:
                outs = pipeline.forward_sharded(*batch, devices=devices)
            else:
                outs = pipeline.forward_batched(*batch)
        else:
            image, points, valid = samples[0][:3]
            outs = [o[None] for o in pipeline(image[None], points, valid)]
        dense_b, quasi_b, response_b = (o.cpu().numpy() for o in outs)
        t2 = time.perf_counter()

        for b, idx in enumerate(idxs):
            dense = dense_b[b]
            if args.verbose:
                print('Processed {}/{} samples'.format(idx + 1, n_sample),
                      end='\r')
            if gt_available:
                gt = decode_np(samples[b][3])[..., 0]
                m = eval_utils.compute_all(dense, gt,
                                           args.min_evaluate_depth,
                                           args.max_evaluate_depth)
                for k in metrics:
                    metrics[k][idx] = m[k]
            if args.save_outputs:
                filename = (os.path.splitext(
                    os.path.basename(image_paths[idx]))[0] + '.png') \
                    if args.keep_input_filenames \
                    else '{:010d}.png'.format(idx)
                paths = [os.path.join(dirs[s], filename) for s in STREAMS]
                if codec_d2h:
                    data_utils.save_depth_encoded(dense, paths[0])
                    data_utils.save_depth_encoded(quasi_b[b], paths[1])
                    data_utils.save_response_encoded(response_b[b], paths[2])
                else:
                    data_utils.save_depth(dense, paths[0])
                    data_utils.save_depth(quasi_b[b], paths[1])
                    data_utils.save_response(response_b[b], paths[2])
        t3 = time.perf_counter()
        seconds['read'] += t1 - t0
        seconds['serve'] += t2 - t1
        seconds['write'] += t3 - t2

    means = None
    if gt_available:
        means = {k: float(np.mean(metrics[k])) for k in METRICS}
        log('Two-stage pipeline evaluation:', log_path)
        log('{:>8}  {:>8}  {:>8}  {:>8}'.format('MAE', 'RMSE', 'iMAE',
                                                'iRMSE'), log_path)
        log('{:8.3f}  {:8.3f}  {:8.3f}  {:8.3f}'.format(
            *[means[k] for k in METRICS]), log_path)
    log('Served {} frames on {} in {:.3f} s: per frame, read {:.2f} ms, '
        'serve {:.2f} ms, write {:.2f} ms; setup {:.3f} s'.format(
            n_sample, device, time.perf_counter() - t_start,
            *[1e3 * seconds[k] / n_sample for k in ('read', 'serve',
                                                    'write')],
            seconds['setup']))
    return dict(frames=n_sample, metrics=means, seconds=seconds)


if __name__ == '__main__':
    main()
