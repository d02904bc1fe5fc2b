"""Stage-1.5 bridge for the test split (counterpart of
setup/setup_dataset_nuscenes_radarnet_test.py): a trained RadarNet over
the test manifests, writing depth_predicted/ and response_predicted/ PNGs
and the testing manifests.

    python -m rcfd_tpu_torch.setup.setup_dataset_nuscenes_radarnet_test \\
        --restore_path model.pth --test_image_path ... \\
        --test_radar_path ... --output_dirpath out

The JAX script's flags and defaults (a static point axis of 128 unless
--max_points_inference says otherwise; 8 frames a forward), and the
numerics and routes of setup_dataset_nuscenes_radarnet.process_split.
"""

from __future__ import annotations

import argparse
import os
import time

from .setup_dataset_nuscenes_radarnet import (add_network_arguments,
                                              net_kwargs, process_split,
                                              summarize, write_manifests)


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m '
             'rcfd_tpu_torch.setup.setup_dataset_nuscenes_radarnet_test')
    parser.add_argument('--restore_path', type=str, required=True)
    parser.add_argument('--test_image_path', type=str, required=True)
    parser.add_argument('--test_radar_path', type=str, required=True)
    parser.add_argument('--test_ground_truth_path', type=str, default=None)
    parser.add_argument('--output_dirpath', type=str, required=True)
    add_network_arguments(parser)
    parser.add_argument('--max_points_inference', type=int, default=128,
                        help='static point-axis size; <= 0 sizes it from '
                             'the radar manifest (no truncation)')
    parser.add_argument('--run_evaluation', action='store_true')
    parser.add_argument('--paths_only', action='store_true')
    parser.add_argument('--verbose', action='store_true')
    return parser


def main(argv=None, device=None):
    """Run the test-split bridge on ``argv`` (sys.argv[1:] when None), on
    ``device`` (``cuda`` unless ``device='cpu'``). Returns the summary of
    setup_dataset_nuscenes_radarnet.main."""
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    os.makedirs(args.output_dirpath, exist_ok=True)
    seconds = {}
    depth_paths, response_paths = process_split(
        args.restore_path, args.test_image_path, args.test_radar_path,
        args.test_ground_truth_path, args.output_dirpath, 'test',
        net_kwargs(args), args.patch_size, args.max_points_inference,
        args.min_evaluate_depth, args.max_evaluate_depth, args.paths_only,
        args.verbose, run_evaluation=args.run_evaluation, device=device,
        seconds=seconds)
    write_manifests(args.output_dirpath, 'testing', 'test', depth_paths,
                    response_paths)
    return summarize(len(depth_paths), time.perf_counter() - t0, seconds)


if __name__ == '__main__':
    main()
