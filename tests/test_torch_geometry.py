"""The stage-0 geometry of rcfd_tpu_torch (rcfd_tpu_torch/geometry) against
the JAX package's (rcfd_tpu/geometry) on the CPU, with inputs drawn from
seeds with numpy.

Matrices and coordinates agree within 1e-6 of their largest magnitude:
the port sums its products in index order with float32 multiplies and
adds, and XLA's dot on the CPU fuses some of them. Maps built from the
same float inputs are equal; maps built through those products are equal
except at ties (tests/torch_stage0.py), each shown by recomputing the
point on both sides."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from rcfd_tpu import geometry as J  # noqa: E402
from rcfd_tpu.geometry import reproject as JR  # noqa: E402

from rcfd_tpu_torch import geometry as P  # noqa: E402
from rcfd_tpu_torch.geometry import reproject as PR  # noqa: E402

from torch_stage0 import unexplained_pixels  # noqa: E402

CPU = 'cpu'
REL = 1e-6


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel_close(port, ref, rel=REL):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(port.astype(np.float64) - ref).max())
    assert err <= rel * scale, (err, scale)


def _quat(rng):
    q = rng.standard_normal(4)
    return q / np.linalg.norm(q)


def _pose(rng, scale=5.0):
    return {'rotation': _quat(rng), 'translation': rng.standard_normal(3) *
            scale}


def _intrinsics(rng, h, w):
    f = rng.uniform(0.8, 1.6) * w
    return np.array([[f, 0, rng.uniform(0.4, 0.6) * w],
                     [0, f * rng.uniform(0.98, 1.02),
                      rng.uniform(0.4, 0.6) * h],
                     [0, 0, 1]], np.float32)


def test_rotation_and_pose_matrices():
    rng = np.random.default_rng(0)
    quats = [_quat(rng) for _ in range(8)] + [
        np.zeros(4), rng.standard_normal(4) * 3, [1.0, 0, 0, 0]]
    for q in quats:
        _rel_close(P.quaternion_to_rotation_matrix(q),
                   J.quaternion_to_rotation_matrix(np.asarray(q,
                                                              np.float32)))
    # the zero quaternion is the identity (s guarded at n = 0)
    assert torch.equal(P.quaternion_to_rotation_matrix(np.zeros(4)),
                       torch.eye(3))
    for _ in range(8):
        pose = _pose(rng)
        for inverse in (False, True):
            m = P.pose_matrix(pose['rotation'], pose['translation'],
                              inverse=inverse)
            assert m.dtype == torch.float32 and m.device.type == 'cpu'
            _rel_close(m, J.pose_matrix(pose['rotation'],
                                        pose['translation'],
                                        inverse=inverse))
        poses = [_pose(rng) for _ in range(4)]
        _rel_close(P.sensor_to_camera_matrix(*poses),
                   J.sensor_to_camera_matrix(*poses))
        _rel_close(P.camera_to_sensor_matrix(*poses),
                   J.camera_to_sensor_matrix(*poses))
        mats = [np.asarray(J.pose_matrix(p['rotation'], p['translation']))
                for p in poses[:3]]
        _rel_close(P.compose(*mats), J.compose(*mats))
        # compose(A, B) applies B first
        ab = P.compose(mats[0], mats[1]).numpy()
        np.testing.assert_allclose(ab, mats[0] @ mats[1], rtol=1e-5,
                                   atol=1e-5)


def test_points_through_the_chain():
    """N = 2,000 points: transform, view_points, project_points_to_image and
    backproject_to_camera within 1e-6 of JAX's; the masks equal except for
    points within a few float32 steps of an edge."""
    rng = np.random.default_rng(1)
    h, w = 90, 160
    k = _intrinsics(rng, h, w)
    poses = [_pose(rng, 2.0) for _ in range(4)]
    m = np.asarray(J.sensor_to_camera_matrix(*poses))
    points = (rng.standard_normal((2000, 3)) * 20).astype(np.float32)

    _rel_close(P.transform_points(points, m, device=CPU),
               J.transform_points(points, m))
    cam = np.asarray(J.transform_points(points, m))
    _rel_close(P.view_points(cam, k, normalize=False, device=CPU),
               J.view_points(cam, k, normalize=False))
    proj_p = P.view_points(cam, k, device=CPU)
    proj_j = np.asarray(J.view_points(cam, k))
    # relative to each point's own magnitude (z near 0 blows x up)
    np.testing.assert_allclose(_np(proj_p), proj_j, rtol=1e-6, atol=0)

    xy_p, z_p, mask_p = P.project_points_to_image(points, m, k, h, w,
                                                  device=CPU)
    xy_j, z_j, mask_j = (np.asarray(a) for a in J.project_points_to_image(
        points, m, k, h, w))
    _rel_close(z_p, z_j)
    # the port's projection and mask of its own camera-frame points are
    # JAX's of the same points, bit for bit
    cam_p = _np(P.transform_points(points, m, device=CPU))
    xy_jp, z_jp, mask_jp = (np.asarray(a) for a in J.project_points_to_image(
        cam_p, np.eye(4, dtype=np.float32), k, h, w))
    np.testing.assert_array_equal(_np(xy_p), xy_jp)
    np.testing.assert_array_equal(_np(mask_p), mask_jp)
    # end to end, the rounded pixels and the masks differ only at ties
    assert mask_j.sum() > 50
    bad, ties, _, _ = unexplained_pixels(
        np.zeros((h, w)), np.zeros((h, w)),
        (_np(xy_p)[:, 0], _np(xy_p)[:, 1], _np(z_p), _np(mask_p)),
        (xy_j[:, 0], xy_j[:, 1], z_j, mask_j))
    assert not bad, bad
    assert (_np(mask_p) != mask_j).sum() <= 2

    sel = mask_j
    _rel_close(P.backproject_to_camera(xy_j[sel], z_j[sel], k, device=CPU),
               J.backproject_to_camera(xy_j[sel], z_j[sel], k))


def test_view_points_zero_depth():
    """z == 0 divides by 1; the third row of K passes z through exactly."""
    k = np.array([[100.0, 0, 50], [0, 100.0, 40], [0, 0, 1]], np.float32)
    pts = np.array([[1.0, 2.0, 0.0], [-3.0, 0.5, 0.0], [2.0, 1.0, 4.0],
                    [0.0, 0.0, -2.0]], np.float32)
    got = _np(P.view_points(pts, k, device=CPU))
    np.testing.assert_array_equal(got, np.asarray(J.view_points(pts, k)))
    np.testing.assert_array_equal(got[:2], (pts @ k.T)[:2])


def test_strict_mask_edges():
    """depth > min_distance, 1 < x < W - 1, 1 < y < H - 1, each strict. K
    is the identity and z = 2, so every x = X / 2 is exact."""
    h, w = 40, 60
    k = np.eye(3, dtype=np.float32)
    ident = np.eye(4, dtype=np.float32)
    cases = [  # (x, y, z) in pixels and metres, visible?
        (1.0, 10.0, 2.0, False), (1.5, 10.0, 2.0, True),
        (w - 1.0, 10.0, 2.0, False), (w - 1.5, 10.0, 2.0, True),
        (10.0, 1.0, 2.0, False), (10.0, 1.5, 2.0, True),
        (10.0, h - 1.0, 2.0, False), (10.0, h - 1.5, 2.0, True),
        (10.0, 10.0, 1.0, False), (10.0, 10.0, np.nextafter(
            np.float32(1), np.float32(2)), True),
        (10.0, 10.0, -2.0, False)]
    pts = np.array([[x * z, y * z, z] for x, y, z, _ in cases], np.float32)
    xy, z, mask = P.project_points_to_image(pts, ident, k, h, w, device=CPU)
    expect = [c[3] for c in cases]
    assert _np(mask).tolist() == expect
    assert np.asarray(J.project_points_to_image(pts, ident, k, h, w)[2]
                      ).tolist() == expect
    # min_distance_from_camera moves the depth edge
    _, _, mask2 = P.project_points_to_image(pts, ident, k, h, w,
                                            min_distance_from_camera=0.5,
                                            device=CPU)
    assert _np(mask2)[8]


@pytest.mark.parametrize('quantize_round', [True, False])
def test_points_to_depth_map_cases(quantize_round):
    """Duplicates (the nearest wins), masked points, points off the frame
    on every side, coordinates at exactly k + 0.5 (half to even) and
    negative halves, against JAX exactly."""
    rng = np.random.default_rng(2)
    h, w = 24, 32
    n = 400
    xy = np.stack([rng.uniform(-6, w + 6, n), rng.uniform(-6, h + 6, n)],
                  1).astype(np.float32)
    xy[:40] = np.round(xy[:40]) + 0.5           # exact halves
    xy[40:60] = xy[60:80]                       # duplicates
    xy[80:84] = [[-0.5, 3.0], [3.0, -0.5], [w - 0.5, 3.0], [3.0, h - 0.5]]
    xy[84:86] = [[1e12, 3.0], [np.nan, 4.0]]
    z = (rng.random(n) * 70 + 1).astype(np.float32)
    mask = rng.random(n) > 0.2
    mask[80:86] = True
    got = _np(P.points_to_depth_map(xy, z, mask, h, w, quantize_round,
                                    device=CPU))
    ref = np.asarray(J.points_to_depth_map(xy, z, mask, h, w,
                                           quantize_round))
    np.testing.assert_array_equal(got, ref)
    assert (got > 0).sum() > 100
    # the mask None case
    np.testing.assert_array_equal(
        _np(P.points_to_depth_map(xy, z, None, h, w, quantize_round,
                                  device=CPU)),
        np.asarray(J.points_to_depth_map(xy, z, None, h, w,
                                         quantize_round)))


def test_half_to_even_and_min():
    xy = np.array([[2.5, 1.0], [3.5, 1.0], [2.0, 1.0], [4.0, 1.0],
                   [-0.5, 2.0]], np.float32)
    z = np.array([9.0, 8.0, 5.0, 7.0, 3.0], np.float32)
    dm = _np(P.points_to_depth_map(xy, z, np.ones(5, bool), 4, 6,
                                   device=CPU))
    # 2.5 -> 2 (with the 5 m point there: min 5), 3.5 -> 4 (min 7), -0.5 -> 0
    assert dm[1, 2] == 5.0 and dm[1, 4] == 7.0 and dm[2, 0] == 3.0
    assert (dm > 0).sum() == 3


def test_z_buffer_merge():
    rng = np.random.default_rng(3)
    h, w = 12, 16
    main = (rng.random((h, w)) * 50).astype(np.float32)
    main[rng.random((h, w)) < 0.5] = 0.0
    n = 60
    xy = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)],
                  1).astype(np.float32)
    zs = (rng.random(n) * 50 + 1).astype(np.float32)
    mask = rng.random(n) > 0.1
    np.testing.assert_array_equal(
        _np(P.z_buffer_merge(main, xy, zs, mask, device=CPU)),
        np.asarray(J.z_buffer_merge(jnp.asarray(main), xy, zs, mask)))


def _scene_maps(rng, h, w, k_a, k_b, a_to_b):
    """Depth maps of one random point cloud seen from camera A and camera
    B (A's frame moved by ``a_to_b``), both rasterized by the JAX
    package."""
    pts = np.stack([rng.uniform(-12, 12, 4000), rng.uniform(-6, 6, 4000),
                    rng.uniform(3, 45, 4000)], 1).astype(np.float32)
    ident = np.eye(4, dtype=np.float32)
    maps = []
    for k, m in ((k_a, ident), (k_b, a_to_b)):
        xy, z, mask = J.project_points_to_image(pts, m, k, h, w)
        maps.append(np.asarray(J.points_to_depth_map(xy, z, mask, h, w)))
    return maps


def _jax_reprojected_points(src, k_s, m, k_d, h, w, src_mask=None,
                            min_distance=1.0):
    """rcfd_tpu/geometry/reproject.py:62-76, step by step."""
    depth = jnp.asarray(src)
    if src_mask is not None:
        depth = jnp.where(src_mask, 0.0, depth)
    xy = JR.depth_map_pixel_grid(*src.shape, depth.dtype)
    z = depth.ravel()
    pts = J.transform_points(J.backproject_to_camera(xy, z, k_s), m)
    proj = J.view_points(pts, k_d)
    x, y = proj[:, 0], proj[:, 1]
    mask = (z > 0) & (pts[:, 2] > min_distance) & (x > 1) & \
        (x < w - 1) & (y > 1) & (y < h - 1)
    return tuple(np.asarray(a) for a in (x, y, pts[:, 2], mask))


def test_reproject_and_merge_48x64():
    """reproject_depth_map and merge_neighbor_into_main on 48x64 maps with
    both mover masks, non-identity poses and two intrinsics: equal to JAX
    except at ties, each shown by the point's two computations."""
    rng = np.random.default_rng(4)
    h, w = 48, 64
    k_a, k_b = _intrinsics(rng, h, w), _intrinsics(rng, h, w)
    yaw = 0.08
    q = [np.cos(yaw / 2), 0.01, np.sin(yaw / 2), 0.02]
    b_pose = np.asarray(J.pose_matrix(q, [0.6, -0.1, 0.8]))
    a_to_b = np.asarray(J.pose_matrix(q, [0.6, -0.1, 0.8], inverse=True))
    main_a, map_b = _scene_maps(rng, h, w, k_a, k_b, a_to_b)
    assert (map_b > 0).sum() > 300
    src_mask = np.zeros((h, w), bool)
    src_mask[10:20, 30:44] = True
    dst_mask = np.zeros((h, w), bool)
    dst_mask[25:40, 5:15] = True

    ref_pts = _jax_reprojected_points(map_b, k_b, b_pose, k_a, h, w,
                                      src_mask)
    port_pts = tuple(_np(a) for a in PR.reprojected_points(
        map_b, k_b, b_pose, k_a, h, w, src_mask, device=CPU))
    for src, dst in ((None, None), (src_mask, None), (None, dst_mask),
                     (src_mask, dst_mask)):
        got = _np(PR.reproject_depth_map(map_b, k_b, b_pose, k_a, h, w,
                                         src, dst, device=CPU))
        ref = np.asarray(JR.reproject_depth_map(
            jnp.asarray(map_b), k_b, b_pose, k_a, h, w, src, dst))
        assert (ref > 0).sum() > 200
        pts = (ref_pts, port_pts) if src is not None else (
            _jax_reprojected_points(map_b, k_b, b_pose, k_a, h, w),
            tuple(_np(a) for a in PR.reprojected_points(
                map_b, k_b, b_pose, k_a, h, w, device=CPU)))
        bad, ties, n_diff, _ = unexplained_pixels(got, ref, pts[1], pts[0])
        assert not bad, (src is not None, dst is not None, bad, ties)
        assert n_diff <= ties
        merged = _np(PR.merge_neighbor_into_main(
            main_a, map_b, k_b, b_pose, k_a, src, dst, device=CPU))
        merged_ref = np.asarray(JR.merge_neighbor_into_main(
            jnp.asarray(main_a), jnp.asarray(map_b), k_b, b_pose, k_a,
            src, dst))
        assert (merged > 0).sum() > (main_a > 0).sum()
        bad, _, _, _ = unexplained_pixels(merged, merged_ref, pts[1],
                                          pts[0])
        assert not bad, bad
        if dst is not None:
            assert not got[dst].any()


def test_pixel_grid_and_host_helpers():
    grid = _np(PR.depth_map_pixel_grid(3, 5, device=CPU))
    np.testing.assert_array_equal(grid, np.asarray(
        JR.depth_map_pixel_grid(3, 5)))
    rng = np.random.default_rng(5)
    dm = (rng.random((10, 14)) * 30).astype(np.float32)
    dm[rng.random((10, 14)) < 0.6] = 0
    boxes = np.array([[2, 1, 6, 4], [-3, 7, 2, 12], [10, 0, 20, 3]])
    np.testing.assert_array_equal(P.zero_boxes(torch.from_numpy(dm), boxes),
                                  J.zero_boxes(dm, boxes))
    mask = rng.random((10, 14)) < 0.3
    np.testing.assert_array_equal(_np(P.zero_mask(dm, mask, device=CPU)),
                                  np.asarray(J.zero_mask(dm, mask)))
    got = P.depth_map_to_points(torch.from_numpy(dm))
    ref = J.depth_map_to_points(dm)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    # row-major order, the order of the .npy files
    order = got[1] * 14 + got[0]
    assert (np.diff(order) > 0).all()
