"""Legacy v0 data generation on the card (counterpart of setup/data_gen.py;
reference setup/data_gen_{train,val,test}.py).

    python -m rcfd_tpu_torch.setup.data_gen --split train \\
        --nuscenes_data_root_dirpath data/nuscenes --output_dirpath out

For every keyframe of every scene of the split:
  - the +-N-keyframe merged radar and lidar (geometry/nuscenes_adapter.py,
    on the device)
  - the ground-truth depth PNG (x256 codec)       -> ground_truth_{split}-...
  - the radar -> lidar registration (a radius query in the (x, z * w)
    plane, one dense distance matrix on the device) and the reorganized
    radar input points (M, 3) .npy                -> radar_points-...
  - one 8-bit grayscale 3-class label PNG a matched radar point (2
    invalid, 0 at lidar pixels, 1 at the point's matched pixels)
                                                  -> pseudo_ground_truth_{split}-...
and a pickled dict of DataStruct records, the v0 manifest.

The JAX script's flags and defaults; the per-split merge defaults are
train +-9, val +-6, test +-2. The geometry and the registration run on
``device`` (``main(argv, device='cpu')`` on the CPU); the labels and the
writes on the host, the label PNGs in threads. With ``--n_thread`` > 1 (and no ``--debug``) the
scenes go to a pool of processes started with ``spawn``, each with its own
CUDA context (setup_dataset_nuscenes.py). Needs nuscenes-devkit.

As in the JAX package, a record's ``ground_truth_label_path`` is the
template ``<label dir>/<stem>-{}.png`` of its points' label files, which
``save_depth_radar`` hands to the trainer as a ground-truth path.
"""

from __future__ import annotations

import argparse
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np

from .. import default_device, native
from ..data import io as data_utils
from ..geometry import nuscenes_adapter as adapter
from ..models.legacy_v0 import register_points_radius, reorganize_points
from .setup_dataset_nuscenes import (get_train_val_split_ids, run_scenes,
                                     timed)

N_FRAMES = {'train': 9, 'val': 6, 'test': 2}
# threads that write a keyframe's label PNGs
LABEL_WRITERS = 8


class DataStruct(NamedTuple):
    scene_id: int
    sample_idx: int
    image_path: str
    radar_points_path: str
    ground_truth_label_path: str
    ground_truth_depth_path: str


def _build_nusc(dataroot, version):
    """The DB (separate, so that a test can put a fake DB in its place)."""
    from nuscenes.nuscenes import NuScenes
    return NuScenes(version=version, dataroot=dataroot, verbose=False)


def label_maps(h: int, w: int, xi, yi, gt_points):
    """The base label map (2 everywhere, 0 at the lidar pixels) and, for
    each radar point, the pixels of its matches rounded (x, y), the ones
    with x > 0 and y > 0 set to 1 in its own copy. Yields (h, w) uint8."""
    base = np.full((h, w), 2, np.uint8)
    base[yi, xi] = 0
    gt_q = np.round(gt_points).astype(int)
    for p in range(gt_points.shape[0]):
        lab = base.copy()
        for x, y in gt_q[p]:
            if x > 0 and y > 0:
                lab[y, x] = 1
        yield lab


def write_label_pngs(paths, maps, n_threads: int = LABEL_WRITERS):
    """Write the label maps (an iterable of (h, w) uint8) as 8-bit
    grayscale PNGs to ``paths``, ``n_threads`` at a time (the deflate and
    the row filters release the GIL), making at most 4 * n_threads maps
    ahead of the writes."""
    maps = iter(maps)
    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        for i in range(0, len(paths), 4 * n_threads):
            chunk = paths[i:i + 4 * n_threads]
            list(pool.map(native.write_u8, chunk,
                          [next(maps) for _ in chunk]))


def process_scene(args, device=None, seconds: Optional[dict] = None):
    """Walk one scene's keyframes and write their files, on ``device``.
    ``args`` is the JAX script's tuple (scene_id, dataroot, version,
    output_dirpath, split, n_frames, num_points, radius, z_weight). Returns
    {(scene_id, sample_id): [DataStruct]} for the keyframes with a matched
    radar point. ``seconds``, a dict, gains the wall seconds of the merges
    ('merge', with the point-cloud and mask loads), the registration and
    reorganization ('register'), the label maps and their PNGs, written in
    LABEL_WRITERS threads ('labels'), and the ground truth's PNG and the
    .npy ('write')."""
    (scene_id, dataroot, version, output_dirpath, split, n_frames,
     num_points, radius, z_weight) = args
    device = default_device(device)
    nusc = _build_nusc(dataroot, version)
    scene = nusc.scene[scene_id]
    sample_token = scene['first_sample_token']

    gt_dir = os.path.join(output_dirpath,
                          'ground_truth_{}-scene-id{}'.format(split, scene_id))
    label_dir = os.path.join(
        output_dirpath,
        'pseudo_ground_truth_{}-scene-id{}'.format(split, scene_id))
    radar_dir = os.path.join(output_dirpath,
                             'radar_points-scene-id{}'.format(scene_id))
    for d in (gt_dir, label_dir, radar_dir):
        os.makedirs(d, exist_ok=True)

    records = {}
    sample_id = 0
    while sample_token != '':
        sample = nusc.get('sample', sample_token)
        camera_token = sample['data']['CAM_FRONT']
        camera_sd = nusc.get('sample_data', camera_token)
        h, w = adapter.get_image_shape(nusc, camera_token)
        stem = os.path.splitext(os.path.basename(camera_sd['filename']))[0]

        with timed(seconds, 'merge'):
            radar_xy, radar_z = adapter.merge_point_clouds(
                nusc, sample_token, n_forward=n_frames, n_backward=n_frames,
                sensor='radar', device=device)
            lidar_xy, lidar_z = adapter.merge_point_clouds(
                nusc, sample_token, n_forward=n_frames, n_backward=n_frames,
                sensor='lidar', device=device)

        # the ground-truth depth PNG
        gt_map = np.zeros((h, w), np.float32)
        xi = np.clip(np.round(lidar_xy[0]).astype(int), 0, w - 1)
        yi = np.clip(np.round(lidar_xy[1]).astype(int), 0, h - 1)
        gt_map[yi, xi] = lidar_z
        gt_path = os.path.join(gt_dir, stem + '.png')
        with timed(seconds, 'write'):
            data_utils.save_depth(gt_map, gt_path)

        with timed(seconds, 'register'):
            idx_arrays = register_points_radius(
                lidar_xy[0], lidar_z, radar_xy[0], radar_z, radius=radius,
                z_scaling_factor=z_weight, device=device)
            radar_stack = np.stack([radar_xy[0], radar_xy[1], radar_z],
                                   axis=0)
            lidar_stack = np.stack([lidar_xy[0], lidar_xy[1]], axis=0)
            input_points, gt_points = reorganize_points(
                radar_stack, lidar_stack, idx_arrays, num_points)
        if input_points.shape[0] == 0:
            sample_token = sample['next']
            sample_id += 1
            continue

        radar_path = os.path.join(radar_dir,
                                  '{}-{}.npy'.format(stem, sample_id))
        with timed(seconds, 'write'):
            np.save(radar_path, input_points)

        # 3-class labels, one PNG a matched radar point (reference
        # data_gen_train.py:1136-1183)
        with timed(seconds, 'labels'):
            write_label_pngs(
                [os.path.join(label_dir, '{}-{}.png'.format(stem, p))
                 for p in range(gt_points.shape[0])],
                label_maps(h, w, xi, yi, gt_points))

        records[(scene_id, sample_id)] = [DataStruct(
            scene_id, sample_id, camera_sd['filename'], radar_path,
            os.path.join(label_dir, stem + '-{}.png'), gt_path)]

        sample_token = sample['next']
        sample_id += 1

    return records


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.setup.data_gen')
    parser.add_argument('--split', choices=['train', 'val', 'test'],
                        required=True)
    parser.add_argument('--nuscenes_data_root_dirpath', type=str,
                        required=True)
    parser.add_argument('--output_dirpath', type=str, required=True)
    parser.add_argument('--version', type=str, default='v1.0-trainval')
    parser.add_argument('--n_frames', type=int, default=None,
                        help='+-N merge frames; default per split: '
                             'train 9, val 6, test 2')
    parser.add_argument('--num_points', type=int, default=4,
                        help='ground-truth matches kept per radar point')
    parser.add_argument('--kdtree_radius', type=float, default=0.4)
    parser.add_argument('--kdtree_depth_weight', type=float, default=0.6)
    parser.add_argument('--data_split_dirpath', type=str,
                        default='data_split')
    parser.add_argument('--pickle_file_name', type=str, default=None)
    parser.add_argument('--n_thread', type=int, default=40)
    parser.add_argument('--debug', action='store_true')
    return parser


def main(argv=None, device=None):
    """Generate the split's files on ``argv`` (sys.argv[1:] when None), on
    ``device`` (``cuda`` unless ``device='cpu'``), and write the pickled
    DataStruct dict. Returns it."""
    args = build_parser().parse_args(argv)
    n_frames = args.n_frames if args.n_frames is not None \
        else N_FRAMES[args.split]
    if args.split == 'test':
        scene_ids = [1] if args.debug else list(range(150))
    else:
        train_ids, val_ids = get_train_val_split_ids(
            args.data_split_dirpath, debug=args.debug)
        scene_ids = sorted(train_ids if args.split == 'train' else val_ids)

    os.makedirs(args.output_dirpath, exist_ok=True)
    job_args = [
        (sid, args.nuscenes_data_root_dirpath, args.version,
         args.output_dirpath, args.split, n_frames, args.num_points,
         args.kdtree_radius, args.kdtree_depth_weight)
        for sid in scene_ids]
    results = run_scenes(process_scene, job_args, args.n_thread, args.debug,
                         device)

    data_dict = {}
    idx = 0
    for rec in results:
        for key in rec:
            data_dict[idx] = rec[key]
            idx += 1
    pickle_path = args.pickle_file_name or os.path.join(
        args.output_dirpath, 'data_dict_{}.pkl'.format(args.split))
    with open(pickle_path, 'wb') as f:
        pickle.dump(data_dict, f)
    print('Wrote {} samples to {}'.format(idx, pickle_path))
    return data_dict


if __name__ == '__main__':
    main()
