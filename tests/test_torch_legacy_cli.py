"""The legacy v0 CLIs of rcfd_tpu_torch on the CPU at a tiny size: python -m
rcfd_tpu_torch.train_legacy_v0, save_depth_radar, save_stage_1_depth and
eval_stage_1_depth, on 64x96 frames with 64x32 (and 64x60) crops. The
training loop feeds the JAX package's loader's batches; the stage-1 files
hold the in-memory forward's maps; the checkpoints restore in the JAX
package; the evaluation equals the JAX package's on the same files."""

import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

from rcfd_tpu import legacy_main as jax_main  # noqa: E402
from rcfd_tpu.data import legacy_datasets as jax_datasets  # noqa: E402
from rcfd_tpu.data.loader import DataLoader as JaxLoader  # noqa: E402

from rcfd_tpu_torch import (eval_stage_1_depth, legacy_main,  # noqa: E402
                            save_depth_radar, save_stage_1_depth,
                            train_legacy_v0)
from rcfd_tpu_torch.data import io, legacy_datasets, transport  # noqa: E402
from rcfd_tpu_torch.data.loader import DataLoader  # noqa: E402
from rcfd_tpu_torch.data.transforms import Transforms  # noqa: E402

from test_torch_legacy import _legacy_files  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PATCH = ['64', '32']


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('legacy'))
    gt, radar, image_dir = _legacy_files(root, np.random.default_rng(3), n=6)
    paths = {}
    for name, plist in (('gt', gt), ('radar', radar), ('gt_val', gt[:2]),
                        ('radar_val', radar[:2])):
        paths[name] = os.path.join(root, name + '.pkl')
        legacy_datasets.save_pickle_paths(paths[name], plist)
    return dict(paths, image_dir=image_dir, root=root, gt_list=gt,
                radar_list=radar)


def _train_argv(files, out, *extra):
    return ['--path_to_pickle_file_gt_train_paths', files['gt'],
            '--path_to_pickle_file_radar_train_numpys', files['radar'],
            '--path_to_pickle_file_gt_val_paths', files['gt_val'],
            '--path_to_pickle_file_radar_val_numpys', files['radar_val'],
            '--image_path', files['image_dir'], '--patch_size', *PATCH,
            '--batch_size', '3', '--learning_schedule', '2',
            '--num_step_per_checkpoint', '2', '--num_step_per_summary', '1',
            '--start_step_validation', '2', '--max_points_inference', '8',
            '--num_workers', '2', '--w_smoothness', '1e-3',
            '--augmentation_random_brightness', '0.8', '1.2',
            '--augmentation_random_flip_type', 'horizontal',
            '--checkpoint_dirpath', out, '--device', 'cpu', *extra]


@pytest.fixture(scope='module')
def trained(files, tmp_path_factory):
    out = str(tmp_path_factory.mktemp('ckpt'))
    timings, seconds = [], {}
    best = train_legacy_v0.main(_train_argv(files, out), timings=timings,
                                seconds=seconds)
    return dict(out=out, best=best, timings=timings, seconds=seconds)


def test_train_cli_runs_the_schedule(trained):
    """2 epochs of 2 steps of batch 3: checkpoints at steps 2 and 4 with
    the v0 keys, validations at 2, 4 and the end (2 frames each), finite
    losses and per-step timings, the best results' keys."""
    assert {'model-2.pth', 'model-4.pth'} <= set(os.listdir(trained['out']))
    assert [t['step'] for t in trained['timings']] == [1, 2, 3, 4]
    assert all(np.isfinite(t['loss']) for t in trained['timings'])
    assert trained['seconds']['frames'] == 6
    raw = torch.load(os.path.join(trained['out'], 'model-4.pth'),
                     weights_only=True)
    assert raw['train_step'] == 4 and raw['optimizer_state_dict'] == {}
    assert set(trained['best']) >= set(legacy_main.METRICS) | {
        'step', 'n_valid_points_intersection'}
    with open(os.path.join(trained['out'], 'results.txt')) as f:
        assert f.read().count('Legacy validation step') == 3


def test_train_feeds_the_jax_loaders_batches(files):
    """The port's loader over the v0 training dataset yields JAX's batches
    (its DataLoader over its dataset, the same seed and epoch): the same
    frames, the same drawn point, the same ground truth."""
    port = DataLoader(legacy_datasets.BinaryClassificationDataset(
        files['gt_list'], files['radar_list'], files['image_dir'],
        device='cpu'), batch_size=3, shuffle=True, num_workers=2, seed=4,
        drop_last=True)
    ref = JaxLoader(jax_datasets.BinaryClassificationDataset(
        files['gt_list'], files['radar_list'], files['image_dir']),
        batch_size=3, shuffle=True, num_workers=2, seed=4, drop_last=True)
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        batches = list(zip(port, ref))
        assert len(batches) == 2
        for got, want in batches:
            for a, b in zip(transport.decode_np(got), want):
                np.testing.assert_array_equal(a, np.asarray(b))


def test_train_resumes_and_restores_in_jax(files, trained, tmp_path):
    """--restore_path: a run restored at step 4 with a 3-epoch schedule
    takes the 2 steps of epoch 3 only; its checkpoint restores in the JAX
    package's restore_model."""
    out = str(tmp_path / 'resumed')
    timings = []
    argv = _train_argv(files, out, '--restore_path',
                       os.path.join(trained['out'], 'model-4.pth'))
    argv[argv.index('--learning_schedule') + 1] = '3'
    train_legacy_v0.main(argv, timings=timings)
    assert [t['step'] for t in timings] == [5, 6]
    net = jax_main.build_model((64, 32))
    template = jax.eval_shape(net.init, jax.random.PRNGKey(0))
    _, _, step = jax_main.restore_model(
        net, os.path.join(out, 'model-6.pth'), *template)
    assert step == 6


def test_stage_1_and_eval_clis(files, trained, tmp_path):
    """save_stage_1_depth from the trained checkpoint: one depth and one
    response PNG a frame, named by the ground truth, holding the in-memory
    forward's maps (the depth exactly, the response to its 14-bit code),
    and the pickled path lists; eval_stage_1_depth on them equals the JAX
    package's eval_stage_1 and a numpy recount of the first frame."""
    ckpt = os.path.join(trained['out'], 'model-4.pth')
    out_dir = str(tmp_path / 'stage1')
    manifests = [str(tmp_path / n) for n in ('out.pkl', 'resp.pkl')]
    seconds = {}
    depth_paths, response_paths = save_stage_1_depth.main(
        ['--restore_path', ckpt,
         '--path_to_pickle_file_gt_paths', files['gt'],
         '--path_to_pickle_file_radar_numpy_paths', files['radar'],
         '--image_dirpath', files['image_dir'], '--output_dirpath', out_dir,
         '--patch_size', *PATCH, '--max_points_inference', '8',
         '--file_to_save_radar_output_paths', manifests[0],
         '--file_to_save_radar_response_paths', manifests[1],
         '--device', 'cpu'], seconds=seconds)
    assert set(seconds) == {'read', 'serve', 'write'}
    assert [os.path.basename(p) for p in depth_paths] == [
        os.path.basename(p) for p in files['gt_list']]
    assert legacy_datasets.load_pickle_paths(manifests[0]) == depth_paths
    assert legacy_datasets.load_pickle_paths(manifests[1]) == response_paths

    model = legacy_main.build_model((64, 32))
    legacy_main.restore_model(model, ckpt, device='cpu')
    forward = legacy_main.make_forward_fn(
        model, Transforms(normalized_image_range=[0, 1]), 64, 96, (64, 32))
    dataset = legacy_datasets.BinaryClassificationDatasetVal(
        files['gt_list'], files['radar_list'], files['image_dir'],
        max_points=8, device='cpu')
    for i in (0, 5):
        image, points, valid, _ = dataset.get(i)
        depth, response = forward(torch.from_numpy(image[None]),
                                  torch.from_numpy(points),
                                  torch.from_numpy(valid))
        np.testing.assert_array_equal(
            io.load_depth_raw(depth_paths[i]),
            np.clip(np.uint32(depth.numpy() * 256).astype(np.int32), 0,
                    65535))
        np.testing.assert_array_equal(
            io.load_depth_raw(response_paths[i]),
            np.uint32(response.numpy() * 2 ** 14))
    got = eval_stage_1_depth.main(
        ['--path_to_pickle_file_output_paths', manifests[0],
         '--path_to_pickle_file_gt_paths', files['gt'],
         '--max_evaluate_depth', '50'])
    assert got == jax_main.eval_stage_1(manifests[0], files['gt'],
                                        max_evaluate_depth=50.0)
    out = io.load_depth(depth_paths[0])
    gt = io.load_depth(files['gt_list'][0])
    mask = (out > 0) & (gt > 0) & (gt < 50)
    if mask.any():
        assert np.isfinite(got['mae'])


def test_save_depth_radar_cli(files, tmp_path):
    """save_depth_radar with Data_Struct manifests whose label paths name
    real depth files (train records with radar paths, val records with
    radar arrays, one-element lists): 2 steps of batch 3 at a 64x60 crop,
    validation and a checkpoint every step."""
    gt, radar = files['gt_list'], files['radar_list']
    train = {(0, i): [(0, i, 'img.jpg', radar[i], gt[i], gt[i])]
             for i in range(6)}
    val = {(0, i): [(0, i, 'img.jpg', np.zeros((4, 2)), np.load(radar[i]),
                     gt[i], gt[i])] for i in range(2)}
    pickles = []
    for name, manifest in (('train', train), ('val', val)):
        pickles.append(str(tmp_path / (name + '.pkl')))
        with open(pickles[-1], 'wb') as f:
            pickle.dump(manifest, f)
    out = str(tmp_path / 'ckpt')
    timings = []
    save_depth_radar.main(
        ['--path_to_pickle_file_train', pickles[0],
         '--path_to_pickle_file_val', pickles[1],
         '--image_path', files['image_dir'], '--batch_size', '3',
         '--patch_size', '64', '60', '--learning_rates', '1e-4',
         '--learning_schedule', '1', '--num_step_per_checkpoint', '1',
         '--num_step_per_summary', '1', '--start_step_validation', '1',
         '--max_points_inference', '8', '--num_workers', '2',
         '--checkpoint_dirpath', out, '--device', 'cpu'], timings=timings)
    assert [t['step'] for t in timings] == [1, 2]
    assert {'model-1.pth', 'model-2.pth'} <= set(os.listdir(out))
    with open(os.path.join(out, 'results.txt')) as f:
        assert f.read().count('Legacy validation step') == 3


@pytest.mark.parametrize('device', [None, 'cuda'])
def test_clis_need_a_card_unless_asked_for_cpu(files, tmp_path, monkeypatch,
                                               device):
    """Without a card the default device and an explicit cuda raise before
    anything is written; there is no CPU fallback."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    out = str(tmp_path / 'o')
    argv = _train_argv(files, out)[:-2]
    if device:
        argv += ['--device', device]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_legacy_v0.main(argv)
    assert not os.path.exists(out)
