"""Stage-1.5 bridge: a trained RadarNet over the train and val manifests,
writing the quasi-dense depth_predicted/ and response_predicted/ PNGs and
the manifests FusionNet trains on (counterpart of
setup/setup_dataset_nuscenes_radarnet.py; reference
setup/setup_dataset_nuscenes_radarnet.py).

    python -m rcfd_tpu_torch.setup.setup_dataset_nuscenes_radarnet \\
        --restore_path model.pth \\
        --train_image_path ... --train_radar_path ... \\
        --val_image_path ... --val_radar_path ... --output_dirpath out

It takes the JAX script's flags with the same defaults and runs on the card
(``main(argv, device='cpu')`` on the CPU). The numerics are the JAX
bridge's: RadarNet restored without folding its batch norm, in float32
(RCFD_COMPUTE_DTYPE is not read), its PerfConfig from the RCFD_* gates
(``nn.perf.perf_from_env``: RCFD_PALLAS_SCATTER, RCFD_FUSED_POOL2/4,
RCFD_DECODE_CHUNKS), served under ``serving_numerics()``. The scatter is
``radarnet_main.scatter_route``'s: the kernel K1 on the card, the exact
float max on the CPU, as the JAX bridge takes its kernel on the TPU.

Output paths follow the reference's string substitution: radar_points (or
radar_points_reprojected) becomes depth_predicted or response_predicted
and the extension .png. An absolute radar path maps in place; a relative
one is rooted under --output_dirpath. Without --run_evaluation the maps
reach the host as their 16-bit PNG codes, made on the device; with it they
reach it in float32 (the same files) and the intersection metrics against
the ground truth are logged.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np

from .. import default_device, native, radarnet_main
from ..data import io as data_utils
from ..data.datasets import RadarNetInferenceDataset
from ..data.transforms import Transforms
from ..nn.perf import perf_from_env
from ..pipeline import serving_numerics
from ..utils.log_utils import log


def derive_output_path(radar_path: str, kind: str) -> str:
    """radar_points/.../0000.npy -> <kind>/.../0000.png"""
    out = radar_path.replace('radar_points_reprojected', kind)
    out = out.replace('radar_points', kind)
    base, _ = os.path.splitext(out)
    return base + '.png'


def output_path(radar_path: str, kind: str, output_dirpath: str) -> str:
    """``derive_output_path``, in place for an absolute radar path, under
    ``output_dirpath`` for a relative one."""
    out = derive_output_path(radar_path, kind)
    return out if os.path.isabs(radar_path) else \
        os.path.join(output_dirpath, out)


def process_split(restore_path, image_path, radar_path, ground_truth_path,
                  output_dirpath, tag, net_kwargs, patch_size,
                  max_points_inference, min_evaluate_depth,
                  max_evaluate_depth, paths_only, verbose,
                  run_evaluation=False, eval_batch_size=8, device=None,
                  seconds: Optional[dict] = None):
    """Bridge one split: RadarNet from ``restore_path`` over the frames of
    the manifests, ``eval_batch_size`` frames a forward, on ``device``
    (``cuda`` unless ``device='cpu'``). Returns (the depth paths, the
    response paths); with ``paths_only`` only the paths, without loading a
    model. ``seconds``, a dict, gains the setup, the host's read wait, the
    serving (to the outputs on the host) and the writes (with the metrics)
    under 'setup', 'read', 'serve' and 'write'."""
    image_paths = data_utils.read_paths(image_path)
    radar_paths = data_utils.read_paths(radar_path)
    n_sample = len(image_paths)
    depth_out_paths = [output_path(p, 'depth_predicted', output_dirpath)
                       for p in radar_paths]
    response_out_paths = [output_path(p, 'response_predicted',
                                      output_dirpath) for p in radar_paths]
    if paths_only:
        return depth_out_paths, response_out_paths

    t_start = time.perf_counter()
    seconds = {} if seconds is None else seconds
    device = default_device(device)
    gt_available = (ground_truth_path is not None and
                    os.path.exists(ground_truth_path))
    gt_paths = data_utils.read_paths(ground_truth_path) \
        if gt_available else None
    if run_evaluation and not gt_available:
        raise ValueError(
            'bridge evaluation requested but no ground truth manifest '
            'for the {} split'.format(tag))
    dataset = RadarNetInferenceDataset(
        image_paths, radar_paths, gt_paths,
        max_points=(None if max_points_inference is None or
                    max_points_inference <= 0 else max_points_inference),
        device=device)
    # the JAX bridge's model: restored, batch norm not folded, float32
    perf = perf_from_env()
    model = radarnet_main.build_model(patch_size=patch_size, **net_kwargs,
                                      device='cpu', perf=perf)
    step = model.restore_checkpoint(restore_path, device=device)
    image_height, image_width = native.probe(image_paths[0])
    # without evaluation the maps reach the host as their 16-bit codes:
    # half the bytes, the same files; evaluation keeps float32 so that the
    # metrics run on the unquantized maps
    codec_d2h = not run_evaluation
    forward_fn = radarnet_main.make_forward_fn_batched(
        model, Transforms(normalized_image_range=[0, 1]), image_height,
        image_width, codec_encode=codec_d2h)
    log('[{}] {}'.format(tag, radarnet_main.gates_line(
        perf, None, radarnet_main.scatter_route(
            perf.pallas_scatter, device, dataset.max_points))))
    metrics = np.full((n_sample, 4), np.nan)
    counts = np.zeros((n_sample, 3))

    t_loop = time.perf_counter()
    seconds['setup'] = seconds.get('setup', 0.0) + t_loop - t_start
    before = seconds.get('read', 0.0) + seconds.get('serve', 0.0)
    with serving_numerics():
        for idx, data, output_depth, response in \
                radarnet_main.iter_scatter_outputs(
                    forward_fn, dataset, eval_batch_size, device, seconds):
            for path in (depth_out_paths[idx], response_out_paths[idx]):
                os.makedirs(os.path.dirname(path), exist_ok=True)
            if codec_d2h:
                data_utils.save_depth_encoded(output_depth,
                                              depth_out_paths[idx])
                data_utils.save_response_encoded(response,
                                                 response_out_paths[idx])
            else:
                data_utils.save_depth(output_depth, depth_out_paths[idx])
                data_utils.save_response(response, response_out_paths[idx])
            if run_evaluation:
                frame = radarnet_main.intersection_metrics(
                    output_depth, data[3][..., 0], min_evaluate_depth,
                    max_evaluate_depth)
                metrics[idx], counts[idx] = frame[:4], frame[4:]
            if verbose:
                print('[{}] {}/{}'.format(tag, idx + 1, n_sample), end='\r')
    seconds['write'] = seconds.get('write', 0.0) + \
        time.perf_counter() - t_loop - (seconds.get('read', 0.0) +
                                        seconds.get('serve', 0.0) - before)

    if run_evaluation:
        n_out, n_gt, n_inter = counts.mean(0)
        radarnet_main.log_evaluation_results(
            'Evaluation results on {} samples from {} set'.format(
                n_sample, tag),
            *[float(v) for v in np.nanmean(metrics, 0)], float(n_out),
            float(n_inter), float(n_gt), step, None)
    return depth_out_paths, response_out_paths


def add_network_arguments(parser):
    """The RadarNet and evaluation flags both bridge scripts share, with
    the reference's canonical defaults."""
    parser.add_argument('--patch_size', nargs='+', type=int,
                        default=[900, 288])
    parser.add_argument('--input_channels_image', type=int, default=3)
    parser.add_argument('--input_channels_depth', type=int, default=3)
    parser.add_argument('--encoder_type', nargs='+', type=str,
                        default=['radarnetv1', 'batch_norm'])
    parser.add_argument('--n_filters_encoder_image', nargs='+', type=int,
                        default=[32, 64, 128, 128, 128])
    parser.add_argument('--n_neurons_encoder_depth', nargs='+', type=int,
                        default=[32, 64, 128, 128, 128])
    parser.add_argument('--decoder_type', nargs='+', type=str,
                        default=['multiscale', 'batch_norm'])
    parser.add_argument('--n_filters_decoder', nargs='+', type=int,
                        default=[256, 128, 64, 32, 16])
    parser.add_argument('--weight_initializer', type=str,
                        default='kaiming_uniform')
    parser.add_argument('--activation_func', type=str, default='leaky_relu')
    parser.add_argument('--min_evaluate_depth', type=float, default=0.0)
    parser.add_argument('--max_evaluate_depth', type=float, default=100.0)


def net_kwargs(args) -> dict:
    return dict(
        input_channels_image=args.input_channels_image,
        input_channels_depth=args.input_channels_depth,
        encoder_type='-'.join(args.encoder_type),
        n_filters_encoder_image=args.n_filters_encoder_image,
        n_neurons_encoder_depth=args.n_neurons_encoder_depth,
        decoder_type='-'.join(args.decoder_type),
        n_filters_decoder=args.n_filters_decoder,
        weight_initializer=args.weight_initializer,
        activation_func=args.activation_func)


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.setup.setup_dataset_nuscenes_radarnet')
    parser.add_argument('--restore_path', type=str, required=True)
    parser.add_argument('--train_image_path', type=str, default=None)
    parser.add_argument('--train_radar_path', type=str, default=None)
    parser.add_argument('--train_ground_truth_path', type=str, default=None)
    parser.add_argument('--val_image_path', type=str, default=None)
    parser.add_argument('--val_radar_path', type=str, default=None)
    parser.add_argument('--val_ground_truth_path', type=str, default=None)
    parser.add_argument('--output_dirpath', type=str, required=True)
    add_network_arguments(parser)
    parser.add_argument('--max_points_inference', type=int, default=0,
                        help='static point-axis size; the default (<= 0) '
                             'sizes it from the radar manifest so that no '
                             'frame is truncated (the reference processes '
                             'every point); pass a positive cap to opt in '
                             'to a fixed size')
    parser.add_argument('--eval_batch_size', type=int, default=8,
                        help='frames a forward (the same per-frame outputs '
                             'at any value)')
    parser.add_argument('--run_evaluation', action='store_true',
                        help='evaluate the predicted quasi-dense maps '
                             'against the ground-truth manifests '
                             '(intersection metrics, reference :352-415)')
    parser.add_argument('--paths_only', action='store_true')
    parser.add_argument('--verbose', action='store_true')
    return parser


def write_manifests(output_dirpath, split_dir, tag, depth_paths,
                    response_paths, subset: bool = False):
    """<split_dir>/nuscenes/nuscenes_<tag>_{depth,response}_predicted.txt
    under ``output_dirpath``, and with ``subset`` their -subset.txt of
    every second frame."""
    manifest_dir = os.path.join(output_dirpath, split_dir, 'nuscenes')
    os.makedirs(manifest_dir, exist_ok=True)
    for kind, paths in (('depth', depth_paths), ('response', response_paths)):
        path = os.path.join(manifest_dir, 'nuscenes_{}_{}_predicted.txt'
                            .format(tag, kind))
        data_utils.write_paths(path, paths)
        if subset:
            data_utils.write_paths(path.replace('.txt', '-subset.txt'),
                                   paths[::2])
    log('[{}] wrote {} outputs'.format(tag, len(depth_paths)))


def summarize(n: int, wall: float, seconds: dict) -> dict:
    """Log frames/s and the read / serve / write ms a frame; return them."""
    if seconds:
        log('Bridged {} frames in {:.3f} s, {:.3f} frames/s: per frame, '
            'read {:.2f} ms, serve {:.2f} ms, write {:.2f} ms; setup {:.3f} '
            's'.format(n, wall, n / wall, *[1e3 * seconds[k] / max(n, 1)
                                            for k in ('read', 'serve',
                                                      'write')],
                       seconds['setup']))
    return dict(frames=n, wall=wall, frames_per_s=n / wall, seconds=seconds)


def main(argv=None, device=None):
    """Run the bridge on ``argv`` (sys.argv[1:] when None), on ``device``
    (``cuda`` unless ``device='cpu'``). Returns a summary: the frames
    bridged, the wall seconds, frames/s and the seconds of setup, reading,
    serving and writing (empty with --paths_only)."""
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    os.makedirs(args.output_dirpath, exist_ok=True)
    seconds, n = {}, 0
    for tag, image_p, radar_p, gt_p in [
            ('train', args.train_image_path, args.train_radar_path,
             args.train_ground_truth_path),
            ('val', args.val_image_path, args.val_radar_path,
             args.val_ground_truth_path)]:
        if image_p is None or radar_p is None:
            continue
        depth_paths, response_paths = process_split(
            args.restore_path, image_p, radar_p, gt_p, args.output_dirpath,
            tag, net_kwargs(args), args.patch_size,
            args.max_points_inference, args.min_evaluate_depth,
            args.max_evaluate_depth, args.paths_only, args.verbose,
            run_evaluation=args.run_evaluation,
            eval_batch_size=args.eval_batch_size, device=device,
            seconds=seconds)
        write_manifests(args.output_dirpath,
                        'training' if tag == 'train' else 'validation', tag,
                        depth_paths, response_paths, subset=tag == 'val')
        n += len(depth_paths)
    return summarize(n, time.perf_counter() - t0, seconds)


if __name__ == '__main__':
    main()
