"""Rigid transforms and the pinhole projection of stage 0 (counterpart of
rcfd_tpu/geometry/transforms.py).

The pose chain sensor -> ego -> global -> ego' -> camera' is one 4x4
matrix, built in float32 on the host in the JAX package's order; the
points it moves are (N, 3) tensors on ``device`` (``cuda`` unless
``device='cpu'``), projected and masked with static shapes (invalid points
are masked, not dropped).

Every product here is a sum of float32 multiplies and adds in index order,
written out as elementwise operations, never a matrix product: the card
and the CPU give the same bits, and TF32 (on or off, whatever the caller
set) does not enter. A 4x4 or N x 3 by 3 x 3 product is too small for a
matrix unit to matter. (The JAX package's products go to XLA's dot, which
on the CPU fuses some of the multiply-adds, by shape: the two can differ
in the last bit.)
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device


def _host(x) -> torch.Tensor:
    """``x`` as a float32 tensor on the host (matrices, poses)."""
    if torch.is_tensor(x):
        return x.detach().to('cpu', torch.float32)
    return torch.from_numpy(np.array(x, np.float32))


def _on(x, device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``; numpy float64 becomes float32, as
    the JAX package's arrays (64-bit off) take it. A host tensor goes to a
    CUDA device through pinned memory without blocking the host, so that
    the host builds the next matrices while the card runs."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
        if x.dtype == np.float64 or not x.flags.writeable:
            x = x.astype(np.float32 if x.dtype == np.float64 else x.dtype)
        x = torch.from_numpy(x)
    if dtype is not None:
        x = x.to(dtype=dtype)
    if device.type == 'cuda' and x.device.type == 'cpu':
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def matmul(a, b) -> torch.Tensor:
    """a (..., n) @ b (n, m): each entry the sum over n of a[..., k] *
    b[k, :] in order k = 0, 1, ..., a float32 multiply and add a term."""
    out = a[..., 0:1] * b[0]
    for k in range(1, b.shape[0]):
        out = out + a[..., k:k + 1] * b[k]
    return out


def quaternion_to_rotation_matrix(q) -> torch.Tensor:
    """(w, x, y, z) quaternion -> 3x3 rotation matrix (pyquaternion's
    convention, that of nuScenes pose records), float32 on the host."""
    q = _host(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = torch.where(n > 0, 2.0 / n, torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)


def pose_matrix(rotation_q, translation, inverse: bool = False
                ) -> torch.Tensor:
    """4x4 homogeneous transform of a nuScenes pose record, float32 on the
    host. ``inverse=True`` gives the global -> frame direction: R^T and
    -R^T t."""
    r = quaternion_to_rotation_matrix(rotation_q)
    t = _host(translation)
    m = torch.eye(4, dtype=torch.float32)
    if inverse:
        m[:3, :3] = r.T
        m[:3, 3] = matmul(-r.T, t[:, None])[:, 0]
    else:
        m[:3, :3] = r
        m[:3, 3] = t
    return m


def compose(*matrices) -> torch.Tensor:
    """Compose 4x4 transforms; compose(A, B) applies B first, then A."""
    out = torch.eye(4, dtype=torch.float32)
    for m in matrices:
        out = matmul(out, _host(m))
    return out


def transform_points(points, matrix, device=None) -> torch.Tensor:
    """Apply a 4x4 transform to (N, 3) points on ``device``."""
    device = default_device(device)
    points = _on(points, device)
    matrix = _on(matrix, device, points.dtype)
    return matmul(points, matrix[:3, :3].T) + matrix[:3, 3]


def sensor_to_camera_matrix(sensor_pose, sensor_ego_pose, camera_ego_pose,
                            camera_pose) -> torch.Tensor:
    """The chain sensor -> ego -> global -> ego' -> camera'. Each pose is a
    dict with 'rotation' (w, x, y, z) and 'translation' (3,)."""
    return compose(
        pose_matrix(camera_pose['rotation'], camera_pose['translation'],
                    inverse=True),
        pose_matrix(camera_ego_pose['rotation'],
                    camera_ego_pose['translation'], inverse=True),
        pose_matrix(sensor_ego_pose['rotation'],
                    sensor_ego_pose['translation']),
        pose_matrix(sensor_pose['rotation'], sensor_pose['translation']),
    )


def camera_to_sensor_matrix(sensor_pose, sensor_ego_pose, camera_ego_pose,
                            camera_pose) -> torch.Tensor:
    """The inverse chain camera -> ego -> global -> ego' -> sensor."""
    return compose(
        pose_matrix(sensor_pose['rotation'], sensor_pose['translation'],
                    inverse=True),
        pose_matrix(sensor_ego_pose['rotation'],
                    sensor_ego_pose['translation'], inverse=True),
        pose_matrix(camera_ego_pose['rotation'],
                    camera_ego_pose['translation']),
        pose_matrix(camera_pose['rotation'], camera_pose['translation']),
    )


def view_points(points_cam, intrinsics, normalize: bool = True,
                device=None) -> torch.Tensor:
    """Pinhole projection of (N, 3) camera-frame points with a 3x3 K
    (nuScenes view_points): (N, 3) of x, y, 1 (normalized, dividing by z,
    or by 1 where z == 0) or K p."""
    device = default_device(device)
    points_cam = _on(points_cam, device)
    k = _on(intrinsics, device, points_cam.dtype)
    proj = matmul(points_cam, k.T)
    if normalize:
        z = proj[..., 2:3]
        proj = proj / torch.where(z == 0, torch.ones_like(z), z)
    return proj


def project_points_to_image(points_sensor, transform, intrinsics,
                            image_height: int, image_width: int,
                            min_distance_from_camera: float = 1.0,
                            device=None):
    """Rigid transform, pinhole projection and visibility mask: (xy (N,
    2), depth (N,), mask (N,) bool) on ``device``. The mask is strict:
    depth > min_distance_from_camera, 1 < x < W - 1, 1 < y < H - 1."""
    device = default_device(device)
    points_cam = transform_points(points_sensor, transform, device)
    depth = points_cam[..., 2]
    proj = view_points(points_cam, intrinsics, True, device)
    x, y = proj[..., 0], proj[..., 1]
    mask = (depth > min_distance_from_camera) & \
        (x > 1) & (x < image_width - 1) & \
        (y > 1) & (y < image_height - 1)
    return torch.stack([x, y], dim=-1), depth, mask


def backproject_to_camera(xy, depth, intrinsics,
                          device=None) -> torch.Tensor:
    """Lift (N, 2) pixels and (N,) depths into (N, 3) camera-frame points
    on ``device``: (x, y, 1) K^-1^T, times the depth."""
    device = default_device(device)
    xy = _on(xy, device)
    depth = _on(depth, device)
    homo = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    # K^-1, inverted in float32 on the host
    k_inv = _on(torch.linalg.inv(_host(intrinsics)), device, xy.dtype)
    return matmul(homo, k_inv.T) * depth[..., None]
