"""Stage-0 preprocessing: lidar, radar and ground-truth files from the
nuScenes DB (counterpart of setup/setup_dataset_nuscenes.py).

    python -m rcfd_tpu_torch.setup.setup_dataset_nuscenes \\
        --nuscenes_data_root_dirpath data/nuscenes \\
        --nuscenes_data_derived_dirpath data/nuscenes_derived

For every keyframe of every scene:
  - the single-scan lidar depth PNG          -> lidar/
  - the single-frame radar points (N x 3)    -> radar_points/, and the
    +-N-keyframe merge                       -> radar_points_reprojected/
  - the +-N-keyframe merged lidar, movers removed -> ground_truth/
  - its Delaunay interpolation               -> ground_truth_interp/
and the path manifests of the train and val splits (with ::2 val subsets).

The JAX script's flags and defaults. The geometry runs on the card
(``main(argv, device='cpu')`` on the CPU); ``interpolate_depth`` and the
writes run on the host. With ``--n_thread`` > 1 (and no ``--debug``) the
scenes go to a pool of processes started with ``spawn``: a forked child
of a process that has used CUDA cannot use it, so this process does not
touch the card before the pool, and each worker opens its own CUDA context
(about 0.5 GB of the card's memory each). Needs nuscenes-devkit
(``--paths_only`` rewrites the manifests without computing).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import multiprocessing as mp
import os
import pickle
import time
from typing import Optional

import numpy as np

from ..data import io as data_utils
from ..geometry import nuscenes_adapter as adapter

MAX_SCENES = 850
# stream -> the name of its manifest
NAME_MAP = {
    'image': 'image', 'lidar': 'lidar', 'radar_points': 'radar',
    'radar_points_reprojected': 'radar_reprojected',
    'ground_truth': 'ground_truth',
    'ground_truth_interp': 'ground_truth_interp',
}


def get_train_val_split_ids(split_dirpath, debug=False):
    """The official 700/150 scene-id split pickles (scene 1 alone for
    training with ``debug``)."""
    with open(os.path.join(split_dirpath, 'train_ids.pkl'), 'rb') as f:
        train_ids = pickle.load(f)
    with open(os.path.join(split_dirpath, 'val_ids.pkl'), 'rb') as f:
        val_ids = pickle.load(f)
    if debug:
        return [1], val_ids
    return train_ids, val_ids


def _build_nusc(dataroot, version):
    """The DB (separate, so that a test can put a fake DB in its place)."""
    from nuscenes.nuscenes import NuScenes
    return NuScenes(version=version, dataroot=dataroot, verbose=False)


@contextlib.contextmanager
def timed(seconds: Optional[dict], key: str):
    """Add the wall seconds of the block to ``seconds[key]`` (when
    ``seconds`` is a dict)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if seconds is not None:
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0


def save_points(path, xy, z):
    """An (N, 3) .npy of x, y, z rows."""
    np.save(path, np.stack([xy[0], xy[1], z], axis=-1))


def ground_truth_map(xy, z, h: int, w: int) -> np.ndarray:
    """The (h, w) map of merged points, written at their rounded pixels."""
    gt_map = np.zeros((h, w), np.float32)
    gt_map[np.round(xy[1]).astype(int), np.round(xy[0]).astype(int)] = z
    return gt_map


def write_ground_truth(gt_map, gt_path, gt_interp_path,
                       seconds: Optional[dict] = None):
    """The ground-truth PNG and its densification's."""
    with timed(seconds, 'write'):
        data_utils.save_depth(gt_map, gt_path)
    with timed(seconds, 'interpolate'):
        validity = (gt_map > 0).astype(np.float32)
        gt_interp = data_utils.interpolate_depth(gt_map, validity)
    with timed(seconds, 'write'):
        data_utils.save_depth(gt_interp, gt_interp_path)


def process_scene(args, device=None, seconds: Optional[dict] = None):
    """Walk one scene's keyframes and write their files, on ``device``.
    ``args`` is the JAX script's tuple (scene_id, dataroot, version,
    output_dirpath, n_forward, n_backward, paths_only, panoptic_dirpath).
    Returns (scene_id, {stream: paths}). ``seconds``, a dict, gains the
    merges' (the geometry, synchronized by the maps' copies to the host,
    with the point-cloud and mask loads), the interpolation's and the
    writes' wall seconds under 'merge', 'interpolate' and 'write'."""
    (scene_id, dataroot, version, output_dirpath, n_forward, n_backward,
     paths_only, panoptic_dirpath) = args

    nusc = _build_nusc(dataroot, version)
    scene = nusc.scene[scene_id]
    sample_token = scene['first_sample_token']

    tag = 'scene_{}'.format(scene_id)
    dirs = {}
    for name in ['image', 'lidar', 'radar_points', 'radar_points_reprojected',
                 'ground_truth', 'ground_truth_interp']:
        dirs[name] = os.path.join(output_dirpath, name, tag)
        os.makedirs(dirs[name], exist_ok=True)

    paths = {name: [] for name in dirs}

    idx = 0
    while sample_token != '':
        sample = nusc.get('sample', sample_token)
        camera_token = sample['data']['CAM_FRONT']
        lidar_token = sample['data']['LIDAR_TOP']

        camera_sd = nusc.get('sample_data', camera_token)
        image_path = os.path.join(dataroot, camera_sd['filename'])
        filename = '{:08d}'.format(idx)

        lidar_path = os.path.join(dirs['lidar'], filename + '.png')
        radar_path = os.path.join(dirs['radar_points'], filename + '.npy')
        radar_reproj_path = os.path.join(
            dirs['radar_points_reprojected'], filename + '.npy')
        gt_path = os.path.join(dirs['ground_truth'], filename + '.png')
        gt_interp_path = os.path.join(
            dirs['ground_truth_interp'], filename + '.png')

        if not paths_only:
            h, w = adapter.get_image_shape(nusc, camera_token)

            with timed(seconds, 'merge'):
                lidar_depth = adapter.rasterize_sensor_depth(
                    nusc, lidar_token, camera_token, 'lidar', device=device)
                # radar_points/ is the single-frame projection (what
                # RadarNet trains and infers on), radar_points_reprojected/
                # the +-N keyframe accumulation
                radar_single = adapter.merge_point_clouds(
                    nusc, sample_token, n_forward=0, n_backward=0,
                    sensor='radar', device=device)
                radar_merged = adapter.merge_point_clouds(
                    nusc, sample_token, n_forward=n_forward,
                    n_backward=n_backward, sensor='radar', device=device)
                # the multi-frame merged lidar ground truth, movers removed
                gt_xy, gt_z = adapter.merge_point_clouds(
                    nusc, sample_token, n_forward=n_forward,
                    n_backward=n_backward, sensor='lidar',
                    use_mover_boxes=True, panoptic_dirpath=panoptic_dirpath,
                    device=device)
            with timed(seconds, 'write'):
                data_utils.save_depth(lidar_depth, lidar_path)
                save_points(radar_path, *radar_single)
                save_points(radar_reproj_path, *radar_merged)
            write_ground_truth(ground_truth_map(gt_xy, gt_z, h, w), gt_path,
                               gt_interp_path, seconds)

        paths['image'].append(image_path)
        paths['lidar'].append(lidar_path)
        paths['radar_points'].append(radar_path)
        paths['radar_points_reprojected'].append(radar_reproj_path)
        paths['ground_truth'].append(gt_path)
        paths['ground_truth_interp'].append(gt_interp_path)

        sample_token = sample['next']
        idx += 1

    return scene_id, paths


def run_scenes(process, job_args, n_thread: int, debug: bool, device=None):
    """``process`` (a process_scene) over the jobs, on ``device``: in a
    pool of ``n_thread`` spawned processes when n_thread > 1 and not
    ``debug``, else here, one after another."""
    process = functools.partial(process, device=device)
    if n_thread > 1 and not debug:
        with mp.get_context('spawn').Pool(n_thread) as pool:
            return pool.map(process, job_args)
    return [process(a) for a in job_args]


def job_arguments(scene_ids, args):
    return [(scene_id, args.nuscenes_data_root_dirpath, args.version,
             args.nuscenes_data_derived_dirpath,
             args.n_forward_frames_to_reproject,
             args.n_backward_frames_to_reproject, args.paths_only,
             args.panoptic_seg_dirpath) for scene_id in scene_ids]


def write_split_manifests(derived_dirpath, results, train_ids):
    """The training and validation manifests of every stream, and the
    validation ones' ::2 '-subset' files."""
    manifests = {'training': {}, 'validation': {}}
    for scene_id, paths in results:
        split = 'training' if scene_id in train_ids else 'validation'
        for name, plist in paths.items():
            manifests[split].setdefault(name, []).extend(plist)
    for split, prefix in [('training', 'train'), ('validation', 'val')]:
        out_dir = os.path.join(derived_dirpath, split, 'nuscenes')
        os.makedirs(out_dir, exist_ok=True)
        for name, plist in manifests[split].items():
            manifest_path = os.path.join(
                out_dir, 'nuscenes_{}_{}.txt'.format(prefix, NAME_MAP[name]))
            data_utils.write_paths(manifest_path, plist)
            if split == 'validation':
                data_utils.write_paths(
                    manifest_path.replace('.txt', '-subset.txt'), plist[::2])


def build_parser(n_frames: int = 9, panoptic_required: bool = False,
                 prog: str = 'python -m '
                 'rcfd_tpu_torch.setup.setup_dataset_nuscenes'):
    parser = argparse.ArgumentParser(prog=prog)
    parser.add_argument('--nuscenes_data_root_dirpath', type=str,
                        required=True)
    parser.add_argument('--nuscenes_data_derived_dirpath', type=str,
                        required=True)
    parser.add_argument('--version', type=str, default='v1.0-trainval')
    parser.add_argument('--n_forward_frames_to_reproject', type=int,
                        default=n_frames)
    parser.add_argument('--n_backward_frames_to_reproject', type=int,
                        default=n_frames)
    parser.add_argument('--data_split_dirpath', type=str,
                        default='data_split')
    parser.add_argument('--panoptic_seg_dirpath', type=str, default=None,
                        required=panoptic_required)
    parser.add_argument('--paths_only', action='store_true')
    parser.add_argument('--n_thread', type=int, default=40)
    parser.add_argument('--debug', action='store_true')
    return parser


def main(argv=None, device=None):
    """Run stage 0 over the train and val scenes on ``argv``
    (sys.argv[1:] when None), on ``device`` (``cuda`` unless
    ``device='cpu'``). Returns the per-scene results."""
    args = build_parser().parse_args(argv)
    train_ids, val_ids = get_train_val_split_ids(
        args.data_split_dirpath, debug=args.debug)
    scene_ids = sorted(set(list(train_ids) + list(val_ids)))
    results = run_scenes(process_scene, job_arguments(scene_ids, args),
                         args.n_thread, args.debug, device)
    write_split_manifests(args.nuscenes_data_derived_dirpath, results,
                          train_ids)
    print('Done: {} scenes'.format(len(results)))
    return results


if __name__ == '__main__':
    main()
