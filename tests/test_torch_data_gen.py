"""The legacy v0 data generation of rcfd_tpu_torch (setup/data_gen.py)
against the JAX package's setup/data_gen.py on the CPU, over fake DBs with
the point-cloud loader and the annotation boxes patched the same way on
both sides (nuscenes-devkit is not installed): the JAX test's
FakeNuscWithScene (tests/test_setup_script.py) and a 20 Hz sweep chain
(tests/test_torch_stage0.py). The fake rigs turn by no angle, so both
packages compute the same float32 points: the ground truth, the radar
.npy files, the label PNGs (by their decoded samples: the JAX package
writes them with Pillow, the port with its own codec) and the records are
equal.

Also the standing fault of the JAX chain data_gen -> save_depth_radar: a
record's ground_truth_label_path is a template, ``<stem>-{}.png``, which
the trainer reads as a ground truth and from whose basename it names the
camera image; neither file exists, and both packages fail alike."""

import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'setup'))
sys.path.insert(0, REPO)

from test_setup_script import FakeNuscWithScene  # noqa: E402
from test_torch_stage0 import (SweepNusc, _fake_nusc_load,  # noqa: E402
                               _patch, sweep_loader, world_points)

from rcfd_tpu.data import legacy_datasets as jax_datasets  # noqa: E402

import data_gen as jax_data_gen  # noqa: E402
import save_depth_radar as jax_save_depth_radar  # noqa: E402

from rcfd_tpu_torch import native, save_depth_radar  # noqa: E402
from rcfd_tpu_torch.data import io as port_io  # noqa: E402
from rcfd_tpu_torch.data import legacy_datasets  # noqa: E402
from rcfd_tpu_torch.setup import data_gen  # noqa: E402

CPU = 'cpu'


def _png_samples(path):
    """A PNG's samples through the port's codec."""
    return native.read_png(path).samples


def _pil_samples(path):
    from PIL import Image
    return np.asarray(Image.open(path))


def _run_both(monkeypatch, tmp_path, nusc, job):
    """process_scene of both packages on ``nusc``; returns the records
    and the two output roots."""
    monkeypatch.setattr(jax_data_gen, '_build_nusc', lambda d, v: nusc)
    monkeypatch.setattr(data_gen, '_build_nusc', lambda d, v: nusc)
    roots = [str(tmp_path / side) for side in ('port', 'jax')]
    seconds = {}
    port = data_gen.process_scene(job[:3] + (roots[0],) + job[4:],
                                  device=CPU, seconds=seconds)
    ref = jax_data_gen.process_scene(job[:3] + (roots[1],) + job[4:])
    return port, ref, roots, seconds


def _compare(port, ref, roots):
    """Records equal (paths under each root), and every file they name:
    the ground truth's and the labels' decoded samples, the radar .npy."""
    assert sorted(port) == sorted(ref) and port
    n_labels = 0
    for key in ref:
        (a,), (b,) = port[key], ref[key]
        assert a._fields == b._fields
        assert tuple(str(v).replace(roots[0], roots[1]) for v in a) == \
            tuple(str(v) for v in b)
        np.testing.assert_array_equal(
            _png_samples(a.ground_truth_depth_path)[..., 0],
            _pil_samples(b.ground_truth_depth_path))
        radar_a, radar_b = (np.load(r.radar_points_path) for r in (a, b))
        assert radar_a.dtype == radar_b.dtype == np.float32
        np.testing.assert_array_equal(radar_a, radar_b)
        for p in range(radar_a.shape[0]):
            la = a.ground_truth_label_path.format(p)
            lb = b.ground_truth_label_path.format(p)
            png = native.read_png(la)
            assert (png.color_type, png.bit_depth) == (0, 8)
            got = png.samples[..., 0]
            np.testing.assert_array_equal(got, _pil_samples(lb))
            assert set(np.unique(got)) <= {0, 1, 2} and (got == 1).any()
            n_labels += 1
        assert not os.path.exists(a.ground_truth_label_path.format(
            radar_a.shape[0]))
    return n_labels


def test_process_scene_over_fake_nusc_with_scene(monkeypatch, tmp_path):
    """The JAX test's two-keyframe FakeNuscWithScene at +-1 (radar and
    lidar share the clouds, so every radar point registers to itself):
    every record and file equal."""
    _patch(monkeypatch, _fake_nusc_load, np.zeros((0, 4), np.int64))
    port, ref, roots, seconds = _run_both(
        monkeypatch, tmp_path, FakeNuscWithScene(),
        (0, '/nonexistent', 'v1.0-fake', None, 'train', 1, 2, 0.4, 0.6))
    assert _compare(port, ref, roots) >= 4
    assert set(seconds) == {'merge', 'register', 'labels', 'write'}


@pytest.mark.parametrize('split,n_frames,num_points,radius',
                         [('train', 9, 4, 0.4), ('val', 2, 1, 1.5)])
def test_process_scene_over_a_sweep_chain(monkeypatch, tmp_path, split,
                                          n_frames, num_points, radius):
    """Three keyframes of a 20 Hz sweep chain, 300 lidar points a sweep,
    the radar a subset of them moved by a few centimetres in depth, a mover
    box: registration at the split's merge and two radii, every record and
    file equal."""
    nusc = SweepNusc(n_keyframes=3, step=4, margin=3)
    world = world_points(300, 9)
    radar = world[:60] + np.array([0.0, 0.0, 0.05], np.float32)
    _patch(monkeypatch, sweep_loader(nusc, world, radar))
    port, ref, roots, _ = _run_both(
        monkeypatch, tmp_path, nusc,
        (0, '/nonexistent', 'v1.0-fake', None, split, n_frames, num_points,
         radius, 0.6))
    assert _compare(port, ref, roots) > 20


def test_main_writes_the_manifest(monkeypatch, tmp_path):
    """main over the debug test split (scene 1) on the CPU: the pickled
    dict of DataStruct records, keyed 0.., equal to JAX's process_scene's
    records of the same scene."""
    nusc = SweepNusc(n_keyframes=2, step=4, margin=3)
    world = world_points(200, 10)
    _patch(monkeypatch, sweep_loader(nusc, world, world[:30]))
    monkeypatch.setattr(jax_data_gen, '_build_nusc', lambda d, v: nusc)
    monkeypatch.setattr(data_gen, '_build_nusc', lambda d, v: nusc)
    out = str(tmp_path / 'port')
    data_dict = data_gen.main(['--split', 'test', '--debug',
                               '--nuscenes_data_root_dirpath', '/nonexistent',
                               '--output_dirpath', out], device=CPU)
    with open(os.path.join(out, 'data_dict_test.pkl'), 'rb') as f:
        assert pickle.load(f) == data_dict
    ref = jax_data_gen.process_scene(
        (1, '/nonexistent', 'v1.0-fake', str(tmp_path / 'jax'), 'test', 2, 4,
         0.4, 0.6))
    assert len(data_dict) == len(ref) == 2
    for i, key in enumerate(sorted(ref)):
        assert tuple(data_dict[i][0]) == tuple(
            str(v).replace(str(tmp_path / 'jax'), out) if isinstance(v, str)
            else v for v in ref[key][0])


def test_data_gen_manifest_does_not_feed_the_trainer(monkeypatch, tmp_path):
    """The JAX chain data_gen -> save_depth_radar: the unpacked ground
    truth is the label template ``<stem>-{}.png``, and the training
    dataset looks for the camera image ``<stem>-{}.png`` (or .jpg) in the
    image directory: a frame that exists under its own name is not found,
    and reading the sample fails, in the JAX package and, mirroring its
    contract, in the port."""
    _patch(monkeypatch, _fake_nusc_load, np.zeros((0, 4), np.int64))
    port, ref, roots, _ = _run_both(
        monkeypatch, tmp_path, FakeNuscWithScene(),
        (0, '/nonexistent', 'v1.0-fake', None, 'train', 1, 2, 0.4, 0.6))
    image_dir = tmp_path / 'CAM_FRONT'
    image_dir.mkdir()
    for records in (port, ref):
        for (rec,) in records.values():
            stem = os.path.splitext(os.path.basename(rec.image_path))[0]
            native.write_rgb(str(image_dir / (stem + '.png')),
                             np.zeros((90, 160, 3), np.uint8))
    for records, unpack, dataset in (
            (port, save_depth_radar.unpack_data_struct_manifest,
             lambda g, r: legacy_datasets.BinaryClassificationDataset(
                 g, r, str(image_dir), device=CPU)),
            (ref, jax_save_depth_radar.unpack_data_struct_manifest,
             lambda g, r: jax_datasets.BinaryClassificationDataset(
                 g, r, str(image_dir)))):
        manifest = str(tmp_path / 'manifest-{}.pkl'.format(id(records)))
        with open(manifest, 'wb') as f:
            pickle.dump(dict(enumerate(records.values())), f)
        gt_paths, radar_paths = unpack(manifest)
        assert all(p.endswith('-{}.png') for p in gt_paths)
        assert not os.path.exists(legacy_datasets._image_path_for(
            gt_paths[0], str(image_dir)))
        with pytest.raises((OSError, FileNotFoundError)):
            dataset(gt_paths, radar_paths).get(0, np.random.default_rng(0))


def test_label_png_is_8_bit_gray(tmp_path):
    """The codec's 8-bit grayscale writer: Pillow reads mode 'L' with the
    same samples, and so does the port's reader."""
    from PIL import Image
    samples = np.random.default_rng(0).integers(0, 256, (37, 53)).astype(
        np.uint8)
    path = str(tmp_path / 'l.png')
    native.write_u8(path, samples)
    img = Image.open(path)
    assert img.mode == 'L'
    np.testing.assert_array_equal(np.asarray(img), samples)
    np.testing.assert_array_equal(port_io.load_depth_raw(path), samples)
    with pytest.raises(TypeError):
        native.write_u8(path, samples.astype(np.uint16))
