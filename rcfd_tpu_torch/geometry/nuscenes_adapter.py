"""nuScenes adapter of stage 0 (counterpart of
rcfd_tpu/geometry/nuscenes_adapter.py): poses, intrinsics and point clouds
from the DB, through the geometry of this package on ``device`` (``cuda``
unless ``device='cpu'``).

The devkit is imported only where a record is read from disk (point clouds,
annotation boxes); the rest takes any object with the devkit's ``get``.
The functions return numpy, as the JAX adapter's do. Inside the multi-frame
merges the main depth map stays on the device for the whole loop and
reaches the host once; the matrices are built on the host and each
neighbor's map and mover mask go to the device once.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import default_device
from . import rasterize, transforms
from .reproject import merge_neighbor_into_main
from .transforms import _on


def _require_nuscenes():
    try:
        from nuscenes.nuscenes import NuScenes  # noqa: F401
        return True
    except ImportError as e:
        raise ImportError(
            'nuscenes-devkit is required for dataset preprocessing. '
            'Install it in the deployment environment; the geometry itself '
            'is devkit-free (rcfd_tpu_torch.geometry).') from e


def get_sensor_poses(nusc, sample_data_token: str):
    """(calibrated_sensor pose, ego pose) dicts of a sample_data record."""
    sd = nusc.get('sample_data', sample_data_token)
    sensor_pose = nusc.get('calibrated_sensor', sd['calibrated_sensor_token'])
    ego_pose = nusc.get('ego_pose', sd['ego_pose_token'])
    return sensor_pose, ego_pose


def get_camera_intrinsics(nusc, camera_token: str) -> np.ndarray:
    sd = nusc.get('sample_data', camera_token)
    cs = nusc.get('calibrated_sensor', sd['calibrated_sensor_token'])
    return np.asarray(cs['camera_intrinsic'], np.float32)


def get_image_shape(nusc, camera_token: str) -> Tuple[int, int]:
    sd = nusc.get('sample_data', camera_token)
    return int(sd['height']), int(sd['width'])


def sensor_to_camera_matrix(nusc, sensor_token: str,
                            camera_token: str) -> np.ndarray:
    """4x4 sensor frame -> camera frame (the reference's 4-step chain)."""
    s_pose, s_ego = get_sensor_poses(nusc, sensor_token)
    c_pose, c_ego = get_sensor_poses(nusc, camera_token)
    return transforms.sensor_to_camera_matrix(
        s_pose, s_ego, c_ego, c_pose).numpy()


def camera_to_camera_matrix(nusc, src_camera_token: str,
                            dst_camera_token: str) -> np.ndarray:
    """4x4 source camera -> destination camera (depth-map reprojection)."""
    src_pose, src_ego = get_sensor_poses(nusc, src_camera_token)
    dst_pose, dst_ego = get_sensor_poses(nusc, dst_camera_token)
    to_global = transforms.compose(
        transforms.pose_matrix(src_ego['rotation'], src_ego['translation']),
        transforms.pose_matrix(src_pose['rotation'], src_pose['translation']))
    to_dst = transforms.compose(
        transforms.pose_matrix(dst_pose['rotation'], dst_pose['translation'],
                               inverse=True),
        transforms.pose_matrix(dst_ego['rotation'], dst_ego['translation'],
                               inverse=True))
    return transforms.compose(to_dst, to_global).numpy()


def load_point_cloud(nusc, sensor_token: str, sensor: str = 'lidar'):
    """(N, 3) float32 points in the sensor frame. Radar keeps every return
    (RadarPointCloud.disable_filters())."""
    _require_nuscenes()
    from nuscenes.utils.data_classes import LidarPointCloud, RadarPointCloud
    sd = nusc.get('sample_data', sensor_token)
    path = os.path.join(nusc.dataroot, sd['filename'])
    if sensor == 'lidar':
        pc = LidarPointCloud.from_file(path)
    else:
        RadarPointCloud.disable_filters()
        pc = RadarPointCloud.from_file(path)
        RadarPointCloud.default_filters()
    return pc.points[:3].T.astype(np.float32)


def _project(nusc, points_sensor, sensor_token, camera_token,
             min_distance_from_camera, device):
    h, w = get_image_shape(nusc, camera_token)
    return transforms.project_points_to_image(
        points_sensor, sensor_to_camera_matrix(nusc, sensor_token,
                                               camera_token),
        get_camera_intrinsics(nusc, camera_token), h, w,
        min_distance_from_camera=min_distance_from_camera, device=device)


def project_sensor_to_camera(nusc, points_sensor, sensor_token: str,
                             camera_token: str,
                             min_distance_from_camera: float = 1.0,
                             device=None):
    """Sensor-frame points into the camera: (xy (N, 2), z (N,), mask (N,))
    as numpy."""
    xy, z, mask = _project(nusc, points_sensor, sensor_token, camera_token,
                           min_distance_from_camera, default_device(device))
    return xy.cpu().numpy(), z.cpu().numpy(), mask.cpu().numpy()


def mover_boxes_image_frame(nusc, camera_token: str) -> np.ndarray:
    """Axis-aligned pixel boxes of the movers (vehicle.*, human.*) visible
    in a camera: (M, 4) [min_x, min_y, max_x, max_y]."""
    _require_nuscenes()
    from nuscenes.utils.geometry_utils import BoxVisibility, view_points
    _, boxes, camera_intrinsic = nusc.get_sample_data(
        camera_token, box_vis_level=BoxVisibility.ANY,
        use_flat_vehicle_coordinates=False)
    out = []
    for box in boxes:
        if box.name[:7] == 'vehicle' or box.name[:5] == 'human':
            corners = view_points(box.corners(), view=camera_intrinsic,
                                  normalize=True)[:2, :]
            out.append([int(np.min(corners.T[:, 0])),
                        int(np.min(corners.T[:, 1])),
                        int(np.max(corners.T[:, 0])),
                        int(np.max(corners.T[:, 1]))])
    return np.asarray(out, np.int64).reshape(-1, 4)


def boxes_to_mask(boxes: np.ndarray, height: int, width: int) -> np.ndarray:
    """A boolean H x W mask of pixel boxes, negative corners clamped to 0."""
    mask = np.zeros((height, width), bool)
    for (min_x, min_y, max_x, max_y) in boxes:
        mask[max(min_y, 0):max(max_y, 0), max(min_x, 0):max(max_x, 0)] = True
    return mask


def load_panoptic_mask(panoptic_dirpath: str, camera_token: str,
                       height: int, width: int) -> Optional[np.ndarray]:
    """The boolean H x W mover mask of a camera record (one .npy per camera
    sample_data token, as setup/gen_panoptic_seg.py writes them), or None
    when there is no file."""
    path = os.path.join(panoptic_dirpath, camera_token + '.npy')
    if not os.path.exists(path):
        return None
    mask = np.load(path)
    if mask.shape != (height, width):
        raise ValueError('panoptic mask {} has shape {}, expected {}'.format(
            path, mask.shape, (height, width)))
    return mask.astype(bool)


def _rasterize(nusc, sensor_token, camera_token, sensor,
               min_distance_from_camera, device) -> torch.Tensor:
    h, w = get_image_shape(nusc, camera_token)
    points = load_point_cloud(nusc, sensor_token, sensor)
    xy, z, mask = _project(nusc, points, sensor_token, camera_token,
                           min_distance_from_camera, device)
    return rasterize.points_to_depth_map(xy, z, mask, h, w, device=device)


def rasterize_sensor_depth(nusc, sensor_token: str, camera_token: str,
                           sensor: str = 'lidar',
                           min_distance_from_camera: float = 1.0,
                           device=None) -> np.ndarray:
    """A sensor's single-frame depth map in the camera, as numpy."""
    return _rasterize(nusc, sensor_token, camera_token, sensor,
                      min_distance_from_camera,
                      default_device(device)).cpu().numpy()


def _iterate_samples(nusc, sample, direction: str, n_steps: int):
    """Yield up to n_steps neighboring keyframe samples."""
    current = sample
    produced = 0
    while current[direction] != '' and produced < n_steps:
        current = nusc.get('sample', current[direction])
        yield current
        produced += 1


def _mover_mask(nusc, camera_token, h, w, panoptic_dirpath, boxes: bool):
    """The panoptic mask of the camera record where there is one, else
    (with ``boxes``) the annotation boxes' mask, else None."""
    mask = None
    if panoptic_dirpath is not None:
        mask = load_panoptic_mask(panoptic_dirpath, camera_token, h, w)
    if mask is None and boxes:
        mask = boxes_to_mask(mover_boxes_image_frame(nusc, camera_token),
                             h, w)
    return mask


def _points(main_depth):
    xs, ys, zs = rasterize.depth_map_to_points(main_depth)
    return np.stack([xs, ys], axis=0).astype(np.float32), zs.astype(np.float32)


def merge_point_clouds(nusc, current_sample_token: str, n_forward: int,
                       n_backward: int, sensor: str = 'lidar',
                       use_mover_boxes: bool = True,
                       panoptic_dirpath: Optional[str] = None, device=None):
    """Multi-frame merge into the keyframe's CAM_FRONT: up to ``n_forward``
    next and ``n_backward`` previous keyframes, each rasterized in its own
    camera, mover-filtered (lidar only: the panoptic mask where there is
    one, else the annotation boxes), reprojected and z-buffer merged.

    Returns (2, N) float32 x, y pixel positions and (N,) depths, the
    nonzero pixels in row-major order."""
    device = default_device(device)
    sensor_key = 'LIDAR_TOP' if sensor == 'lidar' else 'RADAR_FRONT'
    sample = nusc.get('sample', current_sample_token)
    main_sensor_token = sample['data'][sensor_key]
    main_camera_token = sample['data']['CAM_FRONT']

    h, w = get_image_shape(nusc, main_camera_token)
    main_k = get_camera_intrinsics(nusc, main_camera_token)
    main_depth = _rasterize(nusc, main_sensor_token, main_camera_token,
                            sensor, 1.0, device)

    filter_movers = use_mover_boxes and sensor == 'lidar'
    main_mask = _mover_mask(nusc, main_camera_token, h, w, panoptic_dirpath,
                            True) if filter_movers else None
    if main_mask is not None:
        main_mask = _on(main_mask, device)

    for direction, n_steps in [('next', n_forward), ('prev', n_backward)]:
        for neighbor in _iterate_samples(nusc, sample, direction, n_steps):
            n_sensor_token = neighbor['data'][sensor_key]
            n_camera_token = neighbor['data']['CAM_FRONT']
            n_k = get_camera_intrinsics(nusc, n_camera_token)
            neighbor_depth = _rasterize(nusc, n_sensor_token, n_camera_token,
                                        sensor, 1.0, device)
            n_mask = _mover_mask(nusc, n_camera_token, h, w,
                                 panoptic_dirpath, True) \
                if filter_movers else None
            n_to_main = camera_to_camera_matrix(nusc, n_camera_token,
                                                main_camera_token)
            main_depth = merge_neighbor_into_main(
                main_depth, neighbor_depth, n_k, n_to_main, main_k,
                neighbor_mover_mask=n_mask, main_mover_mask=main_mask,
                device=device)
    return _points(main_depth)


# ---------------------------------------------------------------------------
# Dense-GT variant: every intermediate lidar SWEEP (the 20 Hz sample_data
# chain, not only the keyframes), each paired with its nearest-timestamp
# camera image
# ---------------------------------------------------------------------------

def scene_camera_records(nusc, scene, channel: str = 'CAM_FRONT'):
    """Every camera sample_data record of a scene (keyframes and sweeps),
    sorted by timestamp."""
    sample = nusc.get('sample', scene['first_sample_token'])
    sd = nusc.get('sample_data', sample['data'][channel])
    while sd['prev'] != '':
        sd = nusc.get('sample_data', sd['prev'])
    records = []
    while True:
        records.append(sd)
        if sd['next'] == '':
            break
        sd = nusc.get('sample_data', sd['next'])
    records.sort(key=lambda r: r['timestamp'])
    return records


def closest_camera_token(camera_records, timestamp: int) -> str:
    """The nearest-timestamp camera sample_data token (the first of two
    equally near)."""
    timestamps = [r['timestamp'] for r in camera_records]
    idx = int(np.argmin(np.abs(np.asarray(timestamps) - timestamp)))
    return camera_records[idx]['token']


def merge_lidar_sweeps_dense(nusc, current_sample_token: str,
                             n_forward: int, n_backward: int, camera_records,
                             panoptic_dirpath: Optional[str] = None,
                             device=None):
    """Dense-GT merge: up to ``n_forward`` / ``n_backward`` lidar sweeps,
    each paired with its closest camera image, movers removed with the
    panoptic masks (the main frame's falls back to the annotation boxes).

    Returns (2, N) x, y and (N,) z, as merge_point_clouds."""
    device = default_device(device)
    sample = nusc.get('sample', current_sample_token)
    main_lidar_token = sample['data']['LIDAR_TOP']
    main_camera_token = sample['data']['CAM_FRONT']

    h, w = get_image_shape(nusc, main_camera_token)
    main_k = get_camera_intrinsics(nusc, main_camera_token)
    main_depth = _rasterize(nusc, main_lidar_token, main_camera_token,
                            'lidar', 1.0, device)
    main_mask = _on(_mover_mask(nusc, main_camera_token, h, w,
                                panoptic_dirpath, True), device)

    for direction, n_steps in [('next', n_forward), ('prev', n_backward)]:
        sd = nusc.get('sample_data', main_lidar_token)
        produced = 0
        while sd[direction] != '' and produced < n_steps:
            sd = nusc.get('sample_data', sd[direction])
            cam_token = closest_camera_token(camera_records, sd['timestamp'])
            n_k = get_camera_intrinsics(nusc, cam_token)
            sweep_depth = _rasterize(nusc, sd['token'], cam_token, 'lidar',
                                     1.0, device)
            n_mask = _mover_mask(nusc, cam_token, h, w, panoptic_dirpath,
                                 False)
            n_to_main = camera_to_camera_matrix(nusc, cam_token,
                                                main_camera_token)
            main_depth = merge_neighbor_into_main(
                main_depth, sweep_depth, n_k, n_to_main, main_k,
                neighbor_mover_mask=n_mask, main_mover_mask=main_mask,
                device=device)
            produced += 1
    return _points(main_depth)
