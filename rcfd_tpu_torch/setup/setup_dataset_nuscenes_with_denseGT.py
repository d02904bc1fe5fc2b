"""Stage-0 preprocessing, dense-GT variant (counterpart of
setup/setup_dataset_nuscenes_with_denseGT.py), the configuration
bash/setup_dataset_nuscenes.sh runs:

    python -m rcfd_tpu_torch.setup.setup_dataset_nuscenes_with_denseGT \\
        --nuscenes_data_root_dirpath data/nuscenes \\
        --nuscenes_data_derived_dirpath data/nuscenes_derived \\
        --panoptic_seg_dirpath data/nuscenes_derived/panoptic_seg

It differs from setup_dataset_nuscenes in the ground truth: it merges every
intermediate 20 Hz lidar SWEEP (the sample_data chain, not only the 2 Hz
keyframes), pairs each sweep with its nearest-timestamp CAM_FRONT image,
removes movers with the panoptic masks (one boolean H x W .npy per camera
token, from any segmenter that writes them, as setup/gen_panoptic_seg.py
does), and takes n_forward = n_backward = 80 by default. The radar streams
are setup_dataset_nuscenes's. The JAX script's flags and defaults; the
device and the pool of setup_dataset_nuscenes.
"""

from __future__ import annotations

import os
from typing import Optional

from ..data import io as data_utils
from ..geometry import nuscenes_adapter as adapter
from . import setup_dataset_nuscenes as base


def process_scene(args, device=None, seconds: Optional[dict] = None):
    """Walk one scene's keyframes and write their files, on ``device``;
    the arguments, the result and ``seconds`` of
    setup_dataset_nuscenes.process_scene."""
    (scene_id, dataroot, version, output_dirpath, n_forward, n_backward,
     paths_only, panoptic_dirpath) = args

    nusc = base._build_nusc(dataroot, version)
    scene = nusc.scene[scene_id]
    camera_records = None if paths_only else \
        adapter.scene_camera_records(nusc, scene)
    sample_token = scene['first_sample_token']

    tag = 'scene_{}'.format(scene_id)
    dirs = {}
    for name in ['lidar', 'radar_points', 'radar_points_reprojected',
                 'ground_truth', 'ground_truth_interp']:
        dirs[name] = os.path.join(output_dirpath, name, tag)
        os.makedirs(dirs[name], exist_ok=True)
    paths = {name: [] for name in dirs}
    paths['image'] = []

    idx = 0
    while sample_token != '':
        sample = nusc.get('sample', sample_token)
        camera_token = sample['data']['CAM_FRONT']
        lidar_token = sample['data']['LIDAR_TOP']
        camera_sd = nusc.get('sample_data', camera_token)
        image_path = os.path.join(dataroot, camera_sd['filename'])
        filename = '{:08d}'.format(idx)

        out = {name: os.path.join(
            dirs[name], filename + ('.npy' if 'radar' in name else '.png'))
            for name in dirs}

        if not paths_only:
            h, w = adapter.get_image_shape(nusc, camera_token)

            with base.timed(seconds, 'merge'):
                lidar_depth = adapter.rasterize_sensor_depth(
                    nusc, lidar_token, camera_token, 'lidar', device=device)
                # radar_points/ single-frame, radar_points_reprojected/ the
                # +-N keyframe accumulation
                radar_single = adapter.merge_point_clouds(
                    nusc, sample_token, 0, 0, sensor='radar', device=device)
                radar_merged = adapter.merge_point_clouds(
                    nusc, sample_token, n_forward=n_forward,
                    n_backward=n_backward, sensor='radar', device=device)
                gt_xy, gt_z = adapter.merge_lidar_sweeps_dense(
                    nusc, sample_token, n_forward=n_forward,
                    n_backward=n_backward, camera_records=camera_records,
                    panoptic_dirpath=panoptic_dirpath, device=device)
            with base.timed(seconds, 'write'):
                data_utils.save_depth(lidar_depth, out['lidar'])
                base.save_points(out['radar_points'], *radar_single)
                base.save_points(out['radar_points_reprojected'],
                                 *radar_merged)
            base.write_ground_truth(
                base.ground_truth_map(gt_xy, gt_z, h, w),
                out['ground_truth'], out['ground_truth_interp'], seconds)

        paths['image'].append(image_path)
        for name in dirs:
            paths[name].append(out[name])

        sample_token = sample['next']
        idx += 1

    return scene_id, paths


def main(argv=None, device=None):
    """Run the dense-GT stage 0 over the train and val scenes on ``argv``
    (sys.argv[1:] when None), on ``device`` (``cuda`` unless
    ``device='cpu'``). Returns the per-scene results."""
    args = base.build_parser(
        n_frames=80, panoptic_required=True,
        prog='python -m '
             'rcfd_tpu_torch.setup.setup_dataset_nuscenes_with_denseGT'
    ).parse_args(argv)
    train_ids, val_ids = base.get_train_val_split_ids(
        args.data_split_dirpath, debug=args.debug)
    scene_ids = sorted(set(list(train_ids) + list(val_ids)))
    results = base.run_scenes(process_scene,
                              base.job_arguments(scene_ids, args),
                              args.n_thread, args.debug, device)
    base.write_split_manifests(args.nuscenes_data_derived_dirpath, results,
                               train_ids)
    print('Done: {} scenes'.format(len(results)))
    return results


if __name__ == '__main__':
    main()
