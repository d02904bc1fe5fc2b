"""Stage-0 preprocessing of the nuScenes v1.0-test split (counterpart of
setup/setup_dataset_nuscenes_test.py): setup_dataset_nuscenes's keyframe
walk over the 150 test scenes (scene 1 alone with --debug), with no
train/val split, writing testing/nuscenes/nuscenes_test_*.txt.

    python -m rcfd_tpu_torch.setup.setup_dataset_nuscenes_test \\
        --nuscenes_data_root_dirpath data/nuscenes \\
        --nuscenes_data_derived_dirpath data/nuscenes_derived

The JAX script's flags and defaults; the device and the pool of
setup_dataset_nuscenes.
"""

from __future__ import annotations

import argparse
import os

from ..data import io as data_utils
from .setup_dataset_nuscenes import (NAME_MAP, job_arguments, process_scene,
                                     run_scenes)

MAX_SCENES = 150


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.setup.setup_dataset_nuscenes_test')
    parser.add_argument('--nuscenes_data_root_dirpath', type=str,
                        required=True)
    parser.add_argument('--nuscenes_data_derived_dirpath', type=str,
                        required=True)
    parser.add_argument('--version', type=str, default='v1.0-test')
    parser.add_argument('--n_forward_frames_to_reproject', type=int,
                        default=9)
    parser.add_argument('--n_backward_frames_to_reproject', type=int,
                        default=9)
    parser.add_argument('--panoptic_seg_dirpath', type=str, default=None)
    parser.add_argument('--paths_only', action='store_true')
    parser.add_argument('--n_thread', type=int, default=40)
    parser.add_argument('--debug', action='store_true')
    return parser


def main(argv=None, device=None):
    """Run stage 0 over the test scenes on ``argv`` (sys.argv[1:] when
    None), on ``device`` (``cuda`` unless ``device='cpu'``). Returns the
    per-scene results."""
    args = build_parser().parse_args(argv)
    scene_ids = [1] if args.debug else list(range(MAX_SCENES))
    results = run_scenes(process_scene, job_arguments(scene_ids, args),
                         args.n_thread, args.debug, device)
    manifests = {}
    for _, paths in results:
        for name, plist in paths.items():
            manifests.setdefault(name, []).extend(plist)
    out_dir = os.path.join(args.nuscenes_data_derived_dirpath, 'testing',
                           'nuscenes')
    os.makedirs(out_dir, exist_ok=True)
    for name, plist in manifests.items():
        data_utils.write_paths(
            os.path.join(out_dir,
                         'nuscenes_test_{}.txt'.format(NAME_MAP[name])),
            plist)
    print('Done: {} test scenes'.format(len(results)))
    return results


if __name__ == '__main__':
    main()
