"""TwoStagePipeline.from_raw_radar of rcfd_tpu_torch (raw radar returns in
the sensor frame, projected on the device, then served) against the JAX
package's rcfd_tpu.pipeline.TwoStagePipeline.from_raw_radar on the CPU,
with the JAX weights carried across by state_dict_from_jax, and against
the port's own __call__ on the points its projection gives."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from rcfd_tpu import geometry as J  # noqa: E402
from rcfd_tpu import pipeline as jax_pipeline  # noqa: E402
from rcfd_tpu.models.fusionnet import FusionNetModel as JaxFusionNet  # noqa
from rcfd_tpu.models.radarnet import RadarNetModel as JaxRadarNet  # noqa

from rcfd_tpu_torch import pipeline  # noqa: E402
from rcfd_tpu_torch.geometry import project_points_to_image  # noqa: E402
from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel  # noqa: E402
from rcfd_tpu_torch.nn.perf import PerfConfig  # noqa: E402
from rcfd_tpu_torch.ops import scatter_cuda  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

from torch_parity import (FUSIONNET_TINY, H, RADARNET_TINY, W,  # noqa: E402
                          jax_variables)

K_MAT = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]],
                 np.float32)


@pytest.fixture(scope='module')
def models():
    rng = np.random.default_rng(30)
    jr, jf = JaxRadarNet(**RADARNET_TINY), JaxFusionNet(**FUSIONNET_TINY)
    rv = jax_variables(jr, 0, rng)
    fv = jax_variables(jf, 1, rng)
    fn = FusionNetModel(**FUSIONNET_TINY, device='cpu')
    fn.load_state_dict(state_dict_from_jax(*fv), strict=True)
    pipes = {}
    for route, perf in (('exact', None),
                        ('k1', PerfConfig(pallas_scatter=True))):
        rn = RadarNetModel(**RADARNET_TINY, device='cpu', perf=perf)
        rn.load_state_dict(state_dict_from_jax(*rv), strict=True)
        pipes[route] = pipeline.TwoStagePipeline(rn, fn, H, W, device='cpu')
    ref = jax_pipeline.TwoStagePipeline(jr, jf, rv, fv, H, W)
    return pipes, ref


# radar -> camera: a quarter turn (camera z = radar x, camera x = -radar y,
# camera y = -radar z, as a nuScenes RADAR_FRONT against CAM_FRONT), a
# small yaw and a lever arm
Q_CAM = [0.5, -0.5, 0.5, -0.5]
YAW = 0.03
M_RADAR_TO_CAM = np.asarray(J.compose(
    J.pose_matrix(Q_CAM, [0.2, -0.4, 1.1], inverse=True),
    J.pose_matrix([np.cos(YAW / 2), 0.0, 0.0, np.sin(YAW / 2)],
                  [0.0, 0.0, 0.0])))
# returns that never reach the frame: behind the camera, nearer than 1 m,
# beside the frame on both sides (radar frame: x forward, y left, z up)
OFF_FRAME = np.array([[-5.0, 0.3, 0.8], [0.5, 0.0, 1.1], [10.0, 30.0, 0.8],
                      [10.0, -30.0, 0.8]], np.float32)


def _radar_returns(pixels, depths):
    """Radar-frame returns that project near the given (x, y) pixels at the
    given depths (lifted in float64 through the inverse of the rig)."""
    k_inv = np.linalg.inv(K_MAT.astype(np.float64))
    cam = np.stack([np.asarray(pixels, np.float64)[:, 0],
                    np.asarray(pixels, np.float64)[:, 1],
                    np.ones(len(pixels))], 1) @ k_inv.T * \
        np.asarray(depths, np.float64)[:, None]
    m_inv = np.linalg.inv(M_RADAR_TO_CAM.astype(np.float64))
    return (cam @ m_inv[:3, :3].T + m_inv[:3, 3]).astype(np.float32)


def _request(seed, pixels, depths):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8)
    pts = np.concatenate([_radar_returns(pixels, depths), OFF_FRAME,
                          _radar_returns([[40.3, 30.2]], [12.0])])
    valid = np.ones(len(pts), bool)
    valid[-1] = False
    return image, pts, valid, M_RADAR_TO_CAM


@pytest.fixture(scope='module')
def request_separate():
    """Three returns in the frame whose 32-wide windows are disjoint (no
    two compete for a pixel), the four that never reach it, and one marked
    invalid."""
    return _request(31, [[10.4, 33.7], [50.2, 20.6], [85.7, 40.1]],
                    [14.2, 33.9, 7.4])


@pytest.fixture(scope='module')
def request_crowded():
    """Seven returns in the frame, three of them on one pixel, with the
    others of request_separate."""
    rng = np.random.default_rng(32)
    pixels = np.stack([rng.uniform(4, W - 4, 7), rng.uniform(20, 44, 7)], 1)
    pixels[1:3] = pixels[0] + [0.2, -0.1]
    return _request(33, pixels, rng.uniform(6, 50, 7))


def _np(outs):
    return [o.numpy() for o in outs]


def _served(pipes, ref, req):
    image, pts, valid, m = req
    port = _np(pipes['exact'].from_raw_radar(image, pts, valid, m, K_MAT))
    jax_out = [np.asarray(a) for a in ref.from_raw_radar(
        jnp.asarray(image), jnp.asarray(pts), jnp.asarray(valid),
        jnp.asarray(m), jnp.asarray(K_MAT))]
    return port, jax_out


def test_from_raw_radar_matches_jax(models, request_separate):
    """The port's default route (the exact max) against JAX's default (the
    XLA scatter, also the exact max), returns whose windows do not
    compete, at the JAX test's tolerances (tests/test_pipeline.py:141-144):
    quasi and response within 1e-5, dense within 1e-4 m."""
    pipes, ref = models
    (dense, quasi, response), (dense_j, quasi_j, response_j) = _served(
        pipes, ref, request_separate)
    assert dense.shape == quasi.shape == response.shape == (H, W)
    np.testing.assert_allclose(quasi, quasi_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(response, response_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dense, dense_j, rtol=1e-4, atol=1e-4)
    assert len(np.unique(quasi[quasi > 0])) == 3
    assert (response > 0).sum() > 100


def test_from_raw_radar_matches_jax_crowded(models, request_crowded):
    """Returns on one pixel compete for the same pixels with responses that
    differ in the last bits, so the exact max of the port and of JAX may
    pick either: the response within 1e-5, and each pixel whose quasi depth
    differs is such a tie (the port's own crops of the two returns lie
    within 1e-6 there)."""
    pipes, ref = models
    image, pts, valid, m = request_crowded
    (_, quasi, response), (_, quasi_j, response_j) = _served(
        pipes, ref, request_crowded)
    np.testing.assert_allclose(response, response_j, rtol=1e-5, atol=1e-5)
    pipe = pipes['exact']
    xy, z, mask = (a.numpy() for a in project_points_to_image(
        pts, m, K_MAT, H, W, device='cpu'))
    use = valid & mask
    points = np.where(use[:, None], np.stack(
        [np.round(xy[:, 0]), np.round(xy[:, 1]), z], 1), 0.0).astype(
            np.float32)
    with torch.inference_mode():
        crops = pipe.radarnet_stage(image, points)[1].numpy()
    ph, pw = pipe.radarnet.input_patch_size_image
    for r, c in np.argwhere(quasi != quasi_j):
        resp = {}
        for p in np.flatnonzero(use):
            j = c - (int(points[p, 0]) - pw // 2)
            if 0 <= j < pw:
                resp[int(points[p, 2])] = max(resp.get(int(points[p, 2]),
                                                       -1.0),
                                              crops[p, r - (H - ph), j])
        a, b = resp[int(quasi[r, c])], resp[int(quasi_j[r, c])]
        assert abs(a - b) <= 1e-6, (r, c, a, b)
    assert (quasi != quasi_j).sum() <= 0.01 * quasi.size


@pytest.mark.parametrize('route', ['exact', 'k1'])
@pytest.mark.parametrize('case', ['separate', 'crowded'])
def test_from_raw_radar_is_call_on_projected_points(models, route, case,
                                                    request):
    """from_raw_radar equals __call__ bit for bit on the points the port's
    projection gives (rounded x, y, metric z; the ones behind the camera,
    too near or off the frame invalid and zeroed), on both scatter routes
    (the exact max; the kernel K1's plain version here)."""
    pipes, _ = models
    pipe = pipes[route]
    assert pipe.pallas_scatter == (route == 'k1')
    image, pts, valid, m = request.getfixturevalue('request_' + case)
    raw = _np(pipe.from_raw_radar(image, pts, valid, m, K_MAT))
    xy, z, mask = (a.numpy() for a in project_points_to_image(
        pts, m, K_MAT, H, W, device='cpu'))
    n_in = 3 if case == 'separate' else 7
    assert mask[:n_in].all() and not mask[n_in:n_in + 4].any()
    use = valid & mask
    points = np.where(use[:, None], np.stack(
        [np.round(xy[:, 0]), np.round(xy[:, 1]), z], 1), 0.0).astype(
            np.float32)
    pre = _np(pipe(image, points, use))
    for a, b in zip(raw, pre):
        np.testing.assert_array_equal(a, b)
    # min_distance_from_camera reaches the mask: at 60 m every return is
    # too near
    _, quasi, response = _np(pipe.from_raw_radar(
        image, pts, valid, m, K_MAT, min_distance_from_camera=60.0))
    assert not quasi.any() and not response.any()


def test_from_raw_radar_k1_route_runs_the_kernel_wrapper(models,
                                                         request_crowded,
                                                         monkeypatch):
    """Under pallas_scatter=True the request goes through the K1 wrapper
    (scatter_cuda.scatter_quasi_dense; its plain version on the CPU), and
    the exact max above scatter_cuda.MAX_POINTS, as __call__."""
    pipes, _ = models
    image, pts, valid, m = request_crowded
    calls = []
    real = scatter_cuda.scatter_quasi_dense
    monkeypatch.setattr(pipes['k1'], 'scatter',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    pipes['k1'].from_raw_radar(image, pts, valid, m, K_MAT)
    assert calls == [1]
    monkeypatch.setattr(scatter_cuda, 'MAX_POINTS', 4)
    pipes['k1'].from_raw_radar(image, pts, valid, m, K_MAT)
    assert calls == [1]
