"""Stage 0 of rcfd_tpu_torch (the nuScenes adapter, the three set-up
scripts, make_data_split, interpolate_depth) against the JAX package's on
the CPU, over fake DBs with the point-cloud loader and the annotation
boxes patched the same way on both sides (nuscenes-devkit is not
installed): the JAX tests' FakeNusc and FakeNuscWithScene, and a scene
with a 20 Hz sweep chain, cameras at 12 Hz and panoptic masks.

The fake rigs turn by no angle (identity rotations, the ego moving along
the optical axis), so each product of the pose chains has one term that is
not 0 and both packages compute the same float32 values: the maps, the
.npy files and the decoded PNGs are equal, exactly. Rotated rigs, where
the two packages round the pose products otherwise, are held at the
geometry level with the tie rule (tests/test_torch_geometry.py)."""

import os
import pickle
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'setup'))

from test_nuscenes_adapter import (EXTRA_FRAME1, FakeNusc,  # noqa: E402
                                   POINTS_FRAME0, POINTS_FRAME1)
from test_setup_script import FakeNuscWithScene  # noqa: E402

from rcfd_tpu.data import io as jax_io  # noqa: E402
from rcfd_tpu.geometry import nuscenes_adapter as jax_adapter  # noqa: E402

import make_data_split as jax_split  # noqa: E402
import setup_dataset_nuscenes as jax_setup  # noqa: E402
import setup_dataset_nuscenes_test as jax_setup_test  # noqa: E402
import setup_dataset_nuscenes_with_denseGT as jax_dense  # noqa: E402

from rcfd_tpu_torch.data import io as port_io  # noqa: E402
from rcfd_tpu_torch.geometry import nuscenes_adapter as adapter  # noqa
from rcfd_tpu_torch.setup import make_data_split  # noqa: E402
from rcfd_tpu_torch.setup import setup_dataset_nuscenes as setup  # noqa
from rcfd_tpu_torch.setup import setup_dataset_nuscenes_test as setup_test
from rcfd_tpu_torch.setup import \
    setup_dataset_nuscenes_with_denseGT as dense  # noqa: E402

CPU = 'cpu'
STREAMS = ('image', 'lidar', 'radar_points', 'radar_points_reprojected',
           'ground_truth', 'ground_truth_interp')
H, W = 90, 160
K_INTRINSIC = [[100.0, 0.0, 80.0], [0.0, 100.0, 45.0], [0.0, 0.0, 1.0]]
IDENT_Q = [1.0, 0.0, 0.0, 0.0]
# a mover box in every camera, [min_x, min_y, max_x, max_y]
MOVER_BOX = np.array([[-4, 30, 40, 60]], np.int64)


class SweepNusc:
    """A scene of ``n_keyframes`` keyframes, one every ``step`` lidar sweeps
    of a chain that runs ``margin`` sweeps past both ends (20 Hz), with
    CAM_FRONT records at 12 Hz, the keyframes' own RADAR_FRONT records,
    and the ego moving 0.25 m a sweep (5 m/s) along the camera's optical
    axis. Every scene index names this scene."""

    def __init__(self, n_keyframes=3, step=4, margin=3, n_scenes=6):
        self.dataroot = '/nonexistent'
        self.speed = 5.0  # m/s
        n_sweeps = 2 * margin + (n_keyframes - 1) * step + 1
        end = (n_sweeps - 1) * 50000
        cam_times = list(range(0, end + 83334, 83333))
        self._tables = {'sample': {}, 'sample_data': {}, 'ego_pose': {},
                        'calibrated_sensor': {
                            'cs_cam': {'rotation': IDENT_Q,
                                       'translation': [0.0, 0.0, 0.0],
                                       'camera_intrinsic': K_INTRINSIC},
                            'cs_lidar': {'rotation': IDENT_Q,
                                         'translation': [0.0, 0.0, 0.0]}}}

        def chain(prefix, times, extra):
            for i, t in enumerate(times):
                ego = 'ego_{}{}'.format(prefix, i)
                self._tables['ego_pose'][ego] = {
                    'rotation': IDENT_Q,
                    'translation': [0.0, 0.0, self.speed * t * 1e-6]}
                self._tables['sample_data']['{}{}'.format(prefix, i)] = dict(
                    extra, token='{}{}'.format(prefix, i),
                    ego_pose_token=ego, timestamp=t,
                    filename='{}{}.bin'.format(prefix, i),
                    prev='' if i == 0 else '{}{}'.format(prefix, i - 1),
                    next='' if i == len(times) - 1 else '{}{}'.format(
                        prefix, i + 1))

        chain('l', [i * 50000 for i in range(n_sweeps)],
              {'calibrated_sensor_token': 'cs_lidar'})
        chain('c', cam_times, {'calibrated_sensor_token': 'cs_cam',
                               'height': H, 'width': W})
        self.camera_tokens = ['c{}'.format(j) for j in range(len(cam_times))]
        key_times = []
        for k in range(n_keyframes):
            sweep = margin + k * step
            t = sweep * 50000
            key_times.append(t)
            cam = int(np.argmin(np.abs(np.asarray(cam_times) - t)))
            self._tables['sample']['s{}'.format(k)] = {
                'token': 's{}'.format(k),
                'prev': '' if k == 0 else 's{}'.format(k - 1),
                'next': '' if k == n_keyframes - 1 else 's{}'.format(k + 1),
                'data': {'LIDAR_TOP': 'l{}'.format(sweep),
                         'CAM_FRONT': 'c{}'.format(cam),
                         'RADAR_FRONT': 'r{}'.format(k)}}
        chain('r', key_times, {'calibrated_sensor_token': 'cs_lidar'})
        # radar records are no chain of their own here
        for k in range(n_keyframes):
            rec = self._tables['sample_data']['r{}'.format(k)]
            rec['prev'] = rec['next'] = ''
        self.scene = [{'token': 'scene0', 'first_sample_token': 's0',
                       'name': 'scene-0000'}] * n_scenes

    def get(self, table, token):
        return self._tables[table][token]

    def ego_z(self, token):
        sd = self.get('sample_data', token)
        return self.get('ego_pose', sd['ego_pose_token'])['translation'][2]


def world_points(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-9, 9, n), rng.uniform(-3.5, 3.5, n),
                     rng.uniform(5, 40, n)], 1).astype(np.float32)


def sweep_loader(nusc, world, radar_world):
    """load_point_cloud of a SweepNusc: the world points in the sensor frame
    of the record's ego pose (radar: a subset)."""
    def load(nusc_, token, sensor='lidar'):
        pts = radar_world if token.startswith('r') else world
        return pts - np.array([0.0, 0.0, nusc.ego_z(token)], np.float32)
    return load


def write_panoptic(nusc, dirpath):
    """One boolean H x W mask a camera record, a box that moves with the
    camera index; the first record has none (the file is absent)."""
    os.makedirs(dirpath, exist_ok=True)
    for j, token in enumerate(nusc.camera_tokens[1:], 1):
        mask = np.zeros((H, W), bool)
        mask[20 + j % 7:50, 90 + 2 * (j % 5):130] = True
        np.save(os.path.join(dirpath, token + '.npy'), mask)
    return dirpath


def _patch(monkeypatch, load, boxes=MOVER_BOX):
    for mod in (adapter, jax_adapter):
        monkeypatch.setattr(mod, 'load_point_cloud', load)
        monkeypatch.setattr(mod, 'mover_boxes_image_frame',
                            lambda n, c: boxes.copy())


def _fake_devkit(monkeypatch, nusc):
    """A nuscenes.nuscenes module whose NuScenes is ``nusc`` (the JAX
    dense-GT script builds its DB inline), and both packages' _build_nusc
    seam on it."""
    pkg = types.ModuleType('nuscenes')
    mod = types.ModuleType('nuscenes.nuscenes')
    mod.NuScenes = lambda version, dataroot, verbose=False: nusc
    pkg.nuscenes = mod
    monkeypatch.setitem(sys.modules, 'nuscenes', pkg)
    monkeypatch.setitem(sys.modules, 'nuscenes.nuscenes', mod)
    monkeypatch.setattr(jax_setup, '_build_nusc', lambda d, v: nusc)
    monkeypatch.setattr(setup, '_build_nusc', lambda d, v: nusc)


def _fake_nusc_load(nusc_, sensor_token, sensor='lidar'):
    if sensor_token in ('l0', 'r0'):
        return POINTS_FRAME0.copy()
    return np.concatenate([POINTS_FRAME1, EXTRA_FRAME1], axis=0)


def _equal_points(got, ref):
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_adapter_over_fake_nusc(monkeypatch, tmp_path):
    """The JAX tests' two-keyframe FakeNusc (with the radar records of
    FakeNuscWithScene): matrices, projection, the single-frame map and the
    merges equal JAX's, with and without a panoptic mask."""
    _patch(monkeypatch, _fake_nusc_load, np.zeros((0, 4), np.int64))
    nusc = FakeNuscWithScene()
    assert isinstance(nusc, FakeNusc)
    for a, b in (('l0', 'c0'), ('l1', 'c0'), ('l0', 'c1')):
        np.testing.assert_array_equal(
            adapter.sensor_to_camera_matrix(nusc, a, b),
            np.asarray(jax_adapter.sensor_to_camera_matrix(nusc, a, b)))
    for a, b in (('c0', 'c1'), ('c1', 'c0')):
        np.testing.assert_array_equal(
            adapter.camera_to_camera_matrix(nusc, a, b),
            np.asarray(jax_adapter.camera_to_camera_matrix(nusc, a, b)))
    pts = _fake_nusc_load(nusc, 'l1')
    _equal_points(adapter.project_sensor_to_camera(nusc, pts, 'l1', 'c1',
                                                   device=CPU),
                  jax_adapter.project_sensor_to_camera(nusc, pts, 'l1',
                                                       'c1'))
    for token, cam in (('l0', 'c0'), ('l1', 'c1')):
        np.testing.assert_array_equal(
            adapter.rasterize_sensor_depth(nusc, token, cam, device=CPU),
            jax_adapter.rasterize_sensor_depth(nusc, token, cam))
    for sensor, fwd, bwd in (('lidar', 1, 0), ('radar', 1, 0),
                             ('lidar', 0, 0)):
        _equal_points(adapter.merge_point_clouds(nusc, 's0', fwd, bwd,
                                                 sensor, device=CPU),
                      jax_adapter.merge_point_clouds(nusc, 's0', fwd, bwd,
                                                     sensor))
    mask = np.zeros((H, W), bool)
    mask[40:50, 75:86] = True
    mask_dir = tmp_path / 'panoptic'
    mask_dir.mkdir()
    np.save(mask_dir / 'c1.npy', mask)
    _equal_points(
        adapter.merge_point_clouds(nusc, 's1', 0, 1, 'lidar',
                                   panoptic_dirpath=str(mask_dir),
                                   device=CPU),
        jax_adapter.merge_point_clouds(nusc, 's1', 0, 1, 'lidar',
                                       panoptic_dirpath=str(mask_dir)))
    # a missing mask file is None; a mask of another shape is refused
    assert adapter.load_panoptic_mask(str(mask_dir), 'c0', H, W) is None
    with pytest.raises(ValueError):
        adapter.load_panoptic_mask(str(mask_dir), 'c1', H + 1, W)


def test_merges_over_a_sweep_chain(monkeypatch, tmp_path):
    """merge_point_clouds (lidar with the boxes, radar) and
    merge_lidar_sweeps_dense with panoptic masks over a 20 Hz chain, 300
    points a sweep: equal to JAX's."""
    nusc = SweepNusc(n_keyframes=3, step=4, margin=3)
    world = world_points(300, 7)
    _patch(monkeypatch, sweep_loader(nusc, world, world[:40]))
    panoptic = write_panoptic(nusc, str(tmp_path / 'panoptic'))
    for sensor in ('lidar', 'radar'):
        got = adapter.merge_point_clouds(nusc, 's1', 1, 1, sensor,
                                         device=CPU)
        _equal_points(got, jax_adapter.merge_point_clouds(nusc, 's1', 1, 1,
                                                          sensor))
        assert got[1].size > (40 if sensor == 'radar' else 250)
    records = adapter.scene_camera_records(nusc, nusc.scene[0])
    assert [r['token'] for r in records] == [
        r['token'] for r in jax_adapter.scene_camera_records(
            nusc, nusc.scene[0])]
    for t in (0, 41666, 41667, 125000, 10 ** 9):
        assert adapter.closest_camera_token(records, t) == \
            jax_adapter.closest_camera_token(records, t)
    for token, n in (('s0', 3), ('s1', 6), ('s2', 8)):
        got = adapter.merge_lidar_sweeps_dense(nusc, token, n, n, records,
                                               panoptic, device=CPU)
        _equal_points(got, jax_adapter.merge_lidar_sweeps_dense(
            nusc, token, n, n, records, panoptic))
    # the main frame's panoptic mask removes the points under it (c0 has
    # no mask: the main frame of s0 falls back to the boxes)
    xy, _ = adapter.merge_lidar_sweeps_dense(nusc, 's1', 6, 6, records,
                                             panoptic, device=CPU)
    main_cam = nusc.get('sample', 's1')['data']['CAM_FRONT']
    main_mask = np.load(os.path.join(panoptic, main_cam + '.npy'))
    px = np.round(xy).astype(int)
    assert not main_mask[px[1], px[0]].all()


def _read_stream(path):
    if path.endswith('.npy'):
        return np.load(path)
    return port_io.load_depth_raw(path)


def _compare_trees(paths_port, paths_jax, root_port, root_jax, streams):
    for name in streams:
        assert [p.replace(root_port, root_jax) for p in paths_port[name]] == \
            paths_jax[name], name
        if name == 'image':
            continue
        for p, q in zip(paths_port[name], paths_jax[name]):
            a, b = _read_stream(p), _read_stream(q)
            # the JAX package's PNGs through Pillow, the port's codec
            if not p.endswith('.npy'):
                b = np.asarray(jax_io.Image.open(q), np.int64)
            assert a.dtype == b.dtype and a.shape == b.shape, p
            np.testing.assert_array_equal(a, b, err_msg=p)


@pytest.mark.parametrize('script', ['main', 'denseGT'])
def test_process_scene_over_a_sweep_chain(monkeypatch, tmp_path, script):
    """Both scripts' process_scene, port and JAX, over three keyframes of
    a sweep chain with 300 points a sweep, so that the real
    interpolate_depth runs on both sides: every stream's files equal
    (.npy arrays, decoded PNGs)."""
    nusc = SweepNusc(n_keyframes=3, step=4, margin=3)
    world = world_points(300, 8)
    _patch(monkeypatch, sweep_loader(nusc, world, world[:40]))
    _fake_devkit(monkeypatch, nusc)
    panoptic = write_panoptic(nusc, str(tmp_path / 'panoptic'))
    port_mod, jax_mod = (setup, jax_setup) if script == 'main' else \
        (dense, jax_dense)
    roots = [str(tmp_path / side) for side in ('port', 'jax')]
    job = (0, '/nonexistent', 'v1.0-fake', None, 6, 5, False, panoptic)
    seconds = {}
    sid, paths = port_mod.process_scene(
        (job[0], job[1], job[2], roots[0]) + job[4:], device=CPU,
        seconds=seconds)
    sid_j, paths_j = jax_mod.process_scene(
        (job[0], job[1], job[2], roots[1]) + job[4:])
    assert sid == sid_j == 0
    assert sorted(paths) == sorted(paths_j)
    assert len(paths['image']) == 3
    _compare_trees(paths, paths_j, roots[0], roots[1], STREAMS)
    gt = port_io.load_depth(paths['ground_truth'][1])
    interp = port_io.load_depth(paths['ground_truth_interp'][1])
    assert (gt > 0).sum() > 200 and (interp > 0).sum() > 5 * (gt > 0).sum()
    assert set(seconds) == {'merge', 'interpolate', 'write'}


def test_process_scene_over_fake_nusc_with_scene(monkeypatch, tmp_path):
    """The JAX test's FakeNuscWithScene (two keyframes, four points: Qhull
    cannot triangulate them, so interpolate_depth passes the map through
    on both sides, as tests/test_setup_script.py does): every stream equal,
    and --paths_only computes nothing."""
    nusc = FakeNuscWithScene()
    _patch(monkeypatch, _fake_nusc_load, np.zeros((0, 4), np.int64))
    _fake_devkit(monkeypatch, nusc)
    for mod in (port_io, jax_io):
        monkeypatch.setattr(mod, 'interpolate_depth',
                            lambda dm, vm, log_space=False: dm)
    roots = [str(tmp_path / side) for side in ('port', 'jax')]
    _, paths = setup.process_scene(
        (0, '/nonexistent', 'v1.0-fake', roots[0], 1, 1, False, None),
        device=CPU)
    _, paths_j = jax_setup.process_scene(
        (0, '/nonexistent', 'v1.0-fake', roots[1], 1, 1, False, None))
    _compare_trees(paths, paths_j, roots[0], roots[1], STREAMS)
    assert np.load(paths['radar_points_reprojected'][0]).shape == (4, 3)
    _, paths = setup.process_scene(
        (0, '/nonexistent', 'v1.0-fake', str(tmp_path / 'p'), 1, 1, True,
         None), device=CPU)
    assert len(paths['image']) == 2
    assert not os.path.exists(paths['lidar'][0])


def _split_dir(tmp_path):
    d = tmp_path / 'split'
    d.mkdir()
    with open(d / 'train_ids.pkl', 'wb') as f:
        pickle.dump([0, 2, 5], f)
    with open(d / 'val_ids.pkl', 'wb') as f:
        pickle.dump([1, 3, 4], f)
    return str(d)


def _manifests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith('.txt'):
                with open(os.path.join(dirpath, f)) as fh:
                    out[os.path.relpath(os.path.join(dirpath, f), root)] = \
                        fh.read().replace(root, '<root>')
    return out


@pytest.mark.parametrize('script', ['main', 'test', 'denseGT'])
@pytest.mark.parametrize('debug', [True, False])
def test_main_paths_only(monkeypatch, tmp_path, script, debug):
    """main --paths_only (with and without --debug, one process) of each
    script, port and JAX: the same manifests and -subset files."""
    nusc = SweepNusc(n_keyframes=3, step=4, margin=2)
    _fake_devkit(monkeypatch, nusc)
    split = _split_dir(tmp_path)
    port_mod, jax_mod = {'main': (setup, jax_setup),
                         'test': (setup_test, jax_setup_test),
                         'denseGT': (dense, jax_dense)}[script]
    if script == 'test':
        monkeypatch.setattr(jax_setup_test, 'MAX_SCENES', 4)
        monkeypatch.setattr(setup_test, 'MAX_SCENES', 4)
    roots = [str(tmp_path / side) for side in ('port', 'jax')]

    def argv(root):
        args = ['--nuscenes_data_root_dirpath', '/data',
                '--nuscenes_data_derived_dirpath', root, '--paths_only',
                '--n_thread', '1']
        if script != 'test':
            args += ['--data_split_dirpath', split]
        if script == 'denseGT':
            args += ['--panoptic_seg_dirpath', str(tmp_path / 'pan')]
        return args + (['--debug'] if debug else [])

    port_mod.main(argv(roots[0]), device=CPU)
    monkeypatch.setattr(sys, 'argv', ['script'] + argv(roots[1]))
    jax_mod.main()
    got, ref = _manifests(roots[0]), _manifests(roots[1])
    assert got == ref
    assert len(got) == {'main': 18, 'denseGT': 18, 'test': 6}[script]
    if script != 'test':
        assert any(k.endswith('-subset.txt') for k in got)


class _RecordingContext:
    """A multiprocessing context that records the start method it was asked
    for and maps in this process."""

    asked = []

    def __init__(self, method):
        self.asked.append(method)

    def Pool(self, n):
        self.asked.append(n)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, jobs):
        return [fn(j) for j in jobs]


def test_n_thread_pool_is_spawned(monkeypatch, tmp_path):
    """--n_thread 2 (no --debug) asks multiprocessing for a 'spawn' context
    with 2 processes, and the workers get the caller's device."""
    nusc = SweepNusc(n_keyframes=2, step=4, margin=2)
    _fake_devkit(monkeypatch, nusc)
    _RecordingContext.asked = []
    monkeypatch.setattr(setup.mp, 'get_context', _RecordingContext)
    seen = []
    real = setup.process_scene

    def process(args, device=None, seconds=None):
        seen.append(device)
        return real(args, device=device, seconds=seconds)

    monkeypatch.setattr(setup, 'process_scene', process)
    setup.main(['--nuscenes_data_root_dirpath', '/data',
                '--nuscenes_data_derived_dirpath', str(tmp_path / 'out'),
                '--data_split_dirpath', _split_dir(tmp_path), '--paths_only',
                '--n_thread', '2'], device=CPU)
    assert _RecordingContext.asked == ['spawn', 2]
    assert seen == [CPU] * 6


@pytest.mark.parametrize('log_space', [False, True])
def test_interpolate_depth(log_space):
    rng = np.random.default_rng(9)
    dm = np.zeros((30, 40), np.float32)
    idx = rng.choice(dm.size, 90, replace=False)
    dm.reshape(-1)[idx] = rng.uniform(0.05, 60, 90).astype(np.float32)
    v = (dm > 0).astype(np.float32)
    got = port_io.interpolate_depth(dm, v, log_space=log_space)
    ref = jax_io.interpolate_depth(dm, v, log_space=log_space)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    assert (got == 0).any() and (got > 0).sum() > 600


def test_load_depth_with_validity_map(tmp_path):
    dm = np.zeros((12, 20), np.float32)
    dm[3:6, 4:9] = 7.25
    dm[8, 1] = 0.001  # below one 1/256 step: 0 in the file
    path = str(tmp_path / 'd.png')
    port_io.save_depth(dm, path)
    for fmt in ('HW', 'CHW', 'HWC'):
        got = port_io.load_depth_with_validity_map(path, data_format=fmt)
        ref = jax_io.load_depth_with_validity_map(path, data_format=fmt)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_make_data_split(monkeypatch, tmp_path):
    for argv in (['--seed', '3', '--n_scenes', '40', '--n_train', '30'],
                 []):
        roots = [str(tmp_path / side / str(len(argv)))
                 for side in ('port', 'jax')]
        make_data_split.main(argv + ['--output_dirpath', roots[0]])
        monkeypatch.setattr(sys, 'argv', ['make_data_split.py'] + argv +
                            ['--output_dirpath', roots[1]])
        jax_split.main()
        for name in ('train_ids.pkl', 'val_ids.pkl'):
            with open(os.path.join(roots[0], name), 'rb') as f:
                a = f.read()
            with open(os.path.join(roots[1], name), 'rb') as f:
                assert a == f.read()
    # --import_from copies a split
    make_data_split.main(['--import_from', roots[0], '--output_dirpath',
                          str(tmp_path / 'copy')])
    with open(tmp_path / 'copy' / 'val_ids.pkl', 'rb') as f:
        assert len(pickle.load(f)) == 150
