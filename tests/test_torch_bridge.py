"""The port's stage-1.5 bridge (python -m
rcfd_tpu_torch.setup.setup_dataset_nuscenes_radarnet and its _test form)
against the JAX package's setup/setup_dataset_nuscenes_radarnet.py on the
CPU: the same tiny frames (radar paths under radar_points/, so that the
outputs land in depth_predicted/ and response_predicted/ beside them), the
same checkpoint, the same flags. Absolute radar paths map in place, so each
run writes into its own copy of the input tree. Each JAX run is made once
for the module: the codec route (no evaluation) and --run_evaluation. Both
packages scatter by the exact float max here (the JAX package's off the
TPU, the port's on the CPU). Each test states its tolerance."""

import os
import runpy
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from PIL import Image  # noqa: E402

import rcfd_tpu.radarnet_main as jax_radarnet_main  # noqa: E402
from rcfd_tpu.models import RadarNetModel as JaxRadarNet  # noqa: E402

from rcfd_tpu_torch import radarnet_main, train_fusionnet  # noqa: E402
from rcfd_tpu_torch.data import io as port_io  # noqa: E402
from rcfd_tpu_torch.data.transforms import Transforms  # noqa: E402
from rcfd_tpu_torch.ops import scatter_cuda  # noqa: E402
from rcfd_tpu_torch.setup import setup_dataset_nuscenes_radarnet as bridge
from rcfd_tpu_torch.setup import \
    setup_dataset_nuscenes_radarnet_test as bridge_test  # noqa: E402

from fixtures import make_radarnet_fixture  # noqa: E402
from torch_parity import randomize_batch_norm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join('setup', 'setup_dataset_nuscenes_radarnet.py')
TEST_SCRIPT = os.path.join('setup', 'setup_dataset_nuscenes_radarnet_test.py')
H, W = 64, 96
SPLITS = {'train': [0, 1], 'val': [2, 3, 4, 5]}
RADARNET = dict(
    input_channels_image=3, input_channels_depth=3,
    input_patch_size_image=(64, 32), encoder_type='radarnetv1_batch_norm',
    n_filters_encoder_image=[8, 12, 16, 16, 16],
    n_neurons_encoder_depth=[8, 12, 16, 16, 16],
    decoder_type='multiscale_batch_norm', n_filters_decoder=[16, 12, 8, 8, 8])
RN_NET = ['--patch_size', '64', '32',
          '--n_filters_encoder_image', '8', '12', '16', '16', '16',
          '--n_neurons_encoder_depth', '8', '12', '16', '16', '16',
          '--n_filters_decoder', '16', '12', '8', '8', '8']
GATES = ('RCFD_PALLAS_SCATTER', 'RCFD_FUSED_POOL2', 'RCFD_FUSED_POOL4',
         'RCFD_DECODE_CHUNKS', 'RCFD_COMPUTE_DTYPE')


def _manifest(tag, kind, suffix=''):
    return os.path.join('training' if tag == 'train' else 'validation',
                        'nuscenes', 'nuscenes_{}_{}_predicted{}.txt'.format(
                            tag, kind, suffix))


# the train, val and val -subset manifests of the depth and the response
MANIFESTS = [_manifest(tag, kind, suffix)
             for tag, suffixes in (('train', ['']), ('val', ['', '-subset']))
             for suffix in suffixes for kind in ('depth', 'response')]


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The port's tiny forwards on one thread, as the other CLI tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _copy_tree(src, dst):
    """A copy of the input tree and its manifests ({(split, stream):
    path}), every path absolute inside the copy."""
    shutil.copytree(src, dst)
    manifests = {}
    for split, frames in SPLITS.items():
        for stream, name in (('image', 'image/{:04d}.png'),
                             ('radar', 'radar_points/scene_0/{:04d}.npy'),
                             ('ground_truth', 'ground_truth/{:04d}.png')):
            manifests[split, stream] = os.path.join(
                dst, '{}_{}.txt'.format(split, stream))
            port_io.write_paths(manifests[split, stream], [
                os.path.join(dst, name.format(i)) for i in frames])
    return manifests


def _argv(manifests, out, ckpt, gt=True, splits=('train', 'val')):
    argv = ['--restore_path', ckpt, '--output_dirpath', out] + RN_NET
    for split in splits:
        for stream in ('image', 'radar') + (('ground_truth',) if gt else ()):
            argv += ['--{}_{}_path'.format(split, stream),
                     manifests[split, stream]]
    return argv


def _run_jax(script, argv, monkeypatch):
    """The JAX package's script as a user runs it, in this process."""
    monkeypatch.setattr(sys, 'argv', [script] + argv)
    runpy.run_path(os.path.join(REPO, script), run_name='__main__')


def _recorder(store, module, monkeypatch):
    """Record the arguments of ``module.log_evaluation_results``."""
    fn = module.log_evaluation_results
    monkeypatch.setattr(module, 'log_evaluation_results',
                        lambda *a: store.append(a) or fn(*a))


def _jax_trees(seed):
    """The JAX package's (params, state) trees of RADARNET, from weights
    drawn by the port's init_parameters (JAX's init compiles a random draw
    for each shape, about 40 s on the CPU) through the JAX package's
    state_dict reader, batch norm drawn from ``seed``."""
    from rcfd_tpu.utils.checkpoint import torch_state_dict_to_tree
    from rcfd_tpu_torch.models.radarnet import RadarNetModel
    from rcfd_tpu_torch.nn import init_parameters

    model = RadarNetModel(**RADARNET, device='cpu')
    init_parameters(model, torch.Generator().manual_seed(seed))
    trees = [torch_state_dict_to_tree(getattr(model, part).state_dict())
             for part in ('encoder', 'decoder')]
    return randomize_batch_norm(
        {'encoder': trees[0][0], 'decoder': trees[1][0]},
        {'encoder': trees[0][1], 'decoder': trees[1][1]},
        np.random.default_rng(seed))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The JAX bridge and the port's on one input tree, each in its own
    copy: the codec route, and --run_evaluation with ground truth."""
    root = str(tmp_path_factory.mktemp('bridge'))
    src = os.path.join(root, 'src')
    files = make_radarnet_fixture(src, n_samples=6, height=H, width=W)
    os.makedirs(os.path.join(src, 'radar_points', 'scene_0'))
    for path in port_io.read_paths(files['radar']):
        shutil.move(path, os.path.join(src, 'radar_points', 'scene_0',
                                       os.path.basename(path)))
    ckpt = os.path.join(root, 'radarnet-7.pth')
    params, state = _jax_trees(0)
    JaxRadarNet(**RADARNET).save_checkpoint(ckpt, params, state, step=7)
    out = dict(root=root, src=src, ckpt=ckpt, trees={}, metrics={})
    for package, route in (('jax', 'codec'), ('jax', 'eval'),
                           ('port', 'codec'), ('port', 'eval')):
        with pytest.MonkeyPatch.context() as mp:
            for name in GATES:
                mp.delenv(name, raising=False)
            name = package + '_' + route
            tree = os.path.join(root, name)
            manifests = _copy_tree(src, tree)
            argv = _argv(manifests, os.path.join(tree, 'derived'), ckpt,
                         gt=route == 'eval')
            if route == 'eval':
                argv.append('--run_evaluation')
            metrics = out['metrics'][name] = []
            if package == 'jax':
                _recorder(metrics, jax_radarnet_main, mp)
                _run_jax(SCRIPT, argv, mp)
            else:
                _recorder(metrics, radarnet_main, mp)
                out[name] = bridge.main(argv, device='cpu')
            out['trees'][name] = (tree, manifests)
    out['crops'] = _port_crops(ckpt, out['trees']['port_codec'][1])
    return out


def _port_crops(ckpt, manifests):
    """{frame index: (response crops (K, ph, pw), padded x (K,), valid
    (K,))} of the port's RadarNet, restored as the bridge restores it, on
    the frames of both splits."""
    from rcfd_tpu_torch.data.datasets import RadarNetInferenceDataset
    from rcfd_tpu_torch.pipeline import radarnet_crops

    model = radarnet_main.build_model(
        patch_size=(64, 32), **bridge.net_kwargs(bridge.build_parser()
                                                 .parse_args(
            ['--restore_path', ckpt, '--output_dirpath', '.'] + RN_NET)),
        device='cpu')
    model.restore_checkpoint(ckpt, device='cpu')
    out = {}
    for split, frames in SPLITS.items():
        dataset = RadarNetInferenceDataset(
            *[port_io.read_paths(manifests[split, k]) for k in ('image',
                                                                 'radar')],
            max_points=None, device='cpu')
        for i, frame in enumerate(frames):
            image, points, valid = (torch.from_numpy(a[None])
                                    for a in dataset.get(i))
            with torch.no_grad(), radarnet_main.eval_mode(model):
                _, crops, xs, _ = radarnet_crops(
                    model, Transforms(normalized_image_range=[0, 1]), image,
                    points, H)
            out[frame] = crops[0].numpy(), xs[0].numpy(), valid[0].numpy()
    return out


# two crops whose responses lie this close (16 float32 steps at 0.5) are a
# tie that rounding may break either way: the two packages' crops differ by
# about one step (6e-8)
TIE_TOL = 2.0 ** -20


def _ties(crops, xs, valid, pixels):
    """For each pixel (row, col): whether its top two responses among the
    valid points covering it lie within TIE_TOL of each other, or the top
    one within TIE_TOL of the 0.5 threshold."""
    k, ph, pw = crops.shape
    x_start = xs.astype(np.int64) - 2 * (pw // 2)
    out = []
    for row, col in pixels:
        j = col - x_start
        hit = valid & (j >= 0) & (j < pw)
        vals = np.sort(crops[np.flatnonzero(hit), row - (H - ph),
                             j[hit]].astype(np.float64))[::-1]
        out.append(len(vals) > 0 and (abs(vals[0] - 0.5) <= TIE_TOL or (
            len(vals) > 1 and vals[0] - vals[1] <= TIE_TOL)))
    return out


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _codes(path):
    return np.asarray(Image.open(path), np.int64)


def _outputs(tree):
    """The PNG paths of a run's manifests, relative to its tree."""
    paths = []
    for manifest in MANIFESTS[:4]:
        path = os.path.join(tree, 'derived', manifest)
        if os.path.exists(path):
            paths += [os.path.relpath(p, tree) for p in _lines(path)]
    return paths


def _same_files(tree_a, tree_b):
    """Every PNG of tree_a's manifests equals tree_b's byte for byte."""
    paths = _outputs(tree_a)
    assert paths == _outputs(tree_b)
    for rel in paths:
        with open(os.path.join(tree_a, rel), 'rb') as f, \
                open(os.path.join(tree_b, rel), 'rb') as g:
            assert f.read() == g.read(), rel
    return paths


@pytest.mark.parametrize('route', ['codec', 'eval'])
def test_manifests_match_the_jax_bridge(runs, route):
    """The train, val and val -subset manifests equal the JAX bridge's line
    for line once the two trees' roots are swapped; the outputs are under
    depth_predicted/ and response_predicted/ beside radar_points/."""
    jax_tree = runs['trees']['jax_' + route][0]
    port_tree = runs['trees']['port_' + route][0]
    for manifest in MANIFESTS:
        port = _lines(os.path.join(port_tree, 'derived', manifest))
        ref = [p.replace(jax_tree, port_tree) for p in
               _lines(os.path.join(jax_tree, 'derived', manifest))]
        assert port == ref, manifest
    val = _lines(os.path.join(port_tree, 'derived', _manifest('val',
                                                              'depth')))
    assert val == [os.path.join(port_tree, 'depth_predicted', 'scene_0',
                                '{:04d}.png'.format(i))
                   for i in SPLITS['val']]
    assert _lines(os.path.join(port_tree, 'derived', _manifest(
        'val', 'depth', '-subset'))) == val[::2]


@pytest.mark.parametrize('route', ['codec', 'eval'])
def test_files_match_the_jax_bridge(runs, route):
    """Every PNG at the same relative path as the JAX bridge's: the
    response codes within 1 (a response that differs in its last float32
    bits may floor to the next 2^-14 step); the depth codes equal but where
    the exact max may pick another point: pixels whose top two responses
    are a tie within TIE_TOL, or whose top one lies within TIE_TOL of the
    0.5 threshold. Such pixels are found with the port's own crops, and
    are few: the untrained model's responses all lie within 0.005 of 0.5,
    where points that cover the same pixels may lie a float32 step apart
    (0 to 4 of a frame's 6144 pixels, measured)."""
    jax_tree = runs['trees']['jax_' + route][0]
    port_tree = runs['trees']['port_' + route][0]
    paths = _outputs(port_tree)
    assert len(paths) == 2 * sum(len(f) for f in SPLITS.values())
    covered = differ = 0
    for rel in paths:
        port = _codes(os.path.join(port_tree, rel))
        ref = _codes(os.path.join(jax_tree, rel))
        assert port.shape == ref.shape == (H, W)
        diff = np.abs(port - ref)
        if rel.startswith('depth_predicted'):
            pixels = np.argwhere(diff > 0)
            crops = runs['crops'][int(os.path.basename(rel)[:4])]
            assert all(_ties(*crops, pixels)), rel
            covered += int((port > 0).sum())
            differ += len(pixels)
        else:
            assert diff.max() <= 1, (rel, diff.max())
    assert covered > 100 and differ <= 0.01 * covered


def test_metrics_match_the_jax_bridge(runs):
    """--run_evaluation: per split, the logged intersection metrics and
    pixel counts within rtol 1e-3 of the JAX bridge's, the same title and
    checkpoint step; the codec route logs none."""
    port, ref = runs['metrics']['port_eval'], runs['metrics']['jax_eval']
    assert [r[0] for r in port] == [r[0] for r in ref] == [
        'Evaluation results on {} samples from {} set'.format(len(f), tag)
        for tag, f in SPLITS.items()]
    for p, r in zip(port, ref):
        assert np.all(np.isfinite(p[1:8])) and p[1] > 0
        np.testing.assert_allclose(p[1:8], r[1:8], rtol=1e-3, atol=0)
        assert p[8] == r[8] == 7
    assert runs['metrics']['port_codec'] == runs['metrics']['jax_codec'] == []


def test_codec_route_writes_the_float_route_files(runs):
    """Within the port, the codes made on the device (no evaluation) give
    the float route's files byte for byte."""
    _same_files(runs['trees']['port_codec'][0], runs['trees']['port_eval'][0])


def test_summary_counts_frames_and_seconds(runs):
    summary = runs['port_codec']
    assert summary['frames'] == sum(len(f) for f in SPLITS.values())
    assert sorted(summary['seconds']) == ['read', 'serve', 'setup', 'write']
    assert all(v >= 0 for v in summary['seconds'].values())
    assert summary['frames_per_s'] > 0


@pytest.mark.parametrize('batch', [1, 3])
def test_eval_batch_size_gives_the_same_files(runs, tmp_path, batch):
    """--eval_batch_size 1 (a forward a frame) and 3 (a padded tail) write
    the default run's files byte for byte."""
    tree = str(tmp_path / 'tree')
    manifests = _copy_tree(runs['src'], tree)
    bridge.main(_argv(manifests, os.path.join(tree, 'derived'), runs['ckpt'],
                      gt=False) + ['--eval_batch_size', str(batch)],
                device='cpu')
    _same_files(tree, runs['trees']['port_codec'][0])


@pytest.mark.parametrize('script,port', [(SCRIPT, bridge),
                                         (TEST_SCRIPT, bridge_test)],
                         ids=['train_val', 'test'])
def test_paths_only_gives_the_jax_manifests(runs, tmp_path, monkeypatch,
                                            script, port):
    """--paths_only writes the JAX script's manifests without loading a
    model (the checkpoint does not exist): relative radar paths rooted
    under --output_dirpath, absolute ones in place."""
    cwd = tmp_path / 'cwd'
    (cwd / 'radar_points_reprojected').mkdir(parents=True)
    monkeypatch.chdir(cwd)
    radar = ['radar_points_reprojected/a/0001.npy',
             str(tmp_path / 'radar_points' / 'b' / '0002.npy')]
    port_io.write_paths('radar.txt', radar)
    port_io.write_paths('image.txt', ['image/0001.png', 'image/0002.png'])
    flags = ['--restore_path', 'missing.pth', '--paths_only']
    if port is bridge:
        flags += ['--train_image_path', 'image.txt', '--train_radar_path',
                  'radar.txt', '--val_image_path', 'image.txt',
                  '--val_radar_path', 'radar.txt']
        manifests = MANIFESTS
    else:
        flags += ['--test_image_path', 'image.txt', '--test_radar_path',
                  'radar.txt']
        manifests = [os.path.join('testing', 'nuscenes',
                                  'nuscenes_test_{}_predicted.txt'.format(k))
                     for k in ('depth', 'response')]
    _run_jax(script, flags + ['--output_dirpath', 'jax'], monkeypatch)
    summary = port.main(flags + ['--output_dirpath', 'port'])
    assert summary['frames'] == (4 if port is bridge else 2)
    assert summary['seconds'] == {}
    for manifest in manifests:
        got = _lines(os.path.join('port', manifest))
        assert got == [p.replace('jax/', 'port/', 1) for p in
                       _lines(os.path.join('jax', manifest))], manifest
    got = _lines(os.path.join('port', manifests[0]))
    assert got[0] == os.path.join('port', 'depth_predicted', 'a', '0001.png')
    assert got[1] == str(tmp_path / 'depth_predicted' / 'b' / '0002.png')
    assert sorted(os.listdir('port')) == sorted(os.listdir('jax'))


def test_test_script_writes_the_main_script_files(runs, tmp_path):
    """The _test script on the val frames (its own K = 128 static point
    axis, no ground truth) writes the main script's val files byte for
    byte, and the testing manifests."""
    tree = str(tmp_path / 'tree')
    manifests = _copy_tree(runs['src'], tree)
    out = os.path.join(tree, 'derived')
    summary = bridge_test.main([
        '--restore_path', runs['ckpt'], '--output_dirpath', out,
        '--test_image_path', manifests['val', 'image'],
        '--test_radar_path', manifests['val', 'radar']] + RN_NET,
        device='cpu')
    assert summary['frames'] == len(SPLITS['val'])
    ref_tree = runs['trees']['port_codec'][0]
    for kind in ('depth', 'response'):
        manifest = _manifest('val', kind)
        got = _lines(os.path.join(out, 'testing', 'nuscenes',
                                  'nuscenes_test_{}_predicted.txt'.format(
                                      kind)))
        ref = _lines(os.path.join(ref_tree, 'derived', manifest))
        assert [os.path.relpath(p, tree) for p in got] == \
            [os.path.relpath(p, ref_tree) for p in ref]
        for a, b in zip(got, ref):
            with open(a, 'rb') as f, open(b, 'rb') as g:
                assert f.read() == g.read(), a
    assert not os.path.exists(os.path.join(out, 'testing', 'nuscenes',
                                           'nuscenes_test_depth_predicted'
                                           '-subset.txt'))


def test_evaluation_without_ground_truth_raises(runs, tmp_path):
    manifests = runs['trees']['port_codec'][1]
    with pytest.raises(ValueError, match='no ground truth manifest'):
        bridge.main(_argv(manifests, str(tmp_path), runs['ckpt'], gt=False,
                          splits=('val',)) + ['--run_evaluation'],
                    device='cpu')


def test_main_needs_a_card_unless_asked_for_cpu(runs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    manifests = runs['trees']['port_codec'][1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.main(_argv(manifests, str(tmp_path), runs['ckpt']))


@pytest.mark.parametrize('env,plain,calls', [
    ({'RCFD_PALLAS_SCATTER': '1'},
     ('scatter_cuda', 'scatter_quasi_dense_batched_plain'), 1),
    ({'RCFD_FUSED_POOL2': '1', 'RCFD_FUSED_POOL4': '1'},
     ('fused_skip', 'fused_skip_gather_add_plain'), 2),
    ({}, ('crop_cuda', 'batch_column_crop_plain'), 2),
], ids=['k1', 'k3', 'k2'])
def test_bridge_takes_the_kernels_routes(runs, tmp_path, monkeypatch, env,
                                         plain, calls):
    """The gates reach the bridge's model: RCFD_PALLAS_SCATTER=1 takes K1's
    route (its plain version on the CPU), the fused pools K3's (the 1/2 and
    1/4 pools), a 64x40 patch K2's (the 1/16 and 1/32 pools), each once a
    forward of the val split's 4 frames; the response files stay within
    one codec step of the default run's where the model is unchanged (K1,
    K3)."""
    import importlib
    module = importlib.import_module('rcfd_tpu_torch.ops.' + plain[0])
    seen = []
    fn = getattr(module, plain[1])
    monkeypatch.setattr(module, plain[1],
                        lambda *a, **k: seen.append(1) or fn(*a, **k))
    for name in GATES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    tree = str(tmp_path / 'tree')
    manifests = _copy_tree(runs['src'], tree)
    argv = _argv(manifests, os.path.join(tree, 'derived'), runs['ckpt'],
                 gt=False, splits=('val',))
    if not env:
        argv += ['--patch_size', '64', '40']
    bridge.main(argv, device='cpu')
    assert len(seen) == calls
    if env:
        ref_tree = runs['trees']['port_codec'][0]
        for rel in _outputs(tree):
            if rel.startswith('response_predicted'):
                assert np.abs(_codes(os.path.join(tree, rel)) - _codes(
                    os.path.join(ref_tree, rel))).max() <= 1, rel


def test_bridge_takes_k1_on_the_card_by_default(runs, tmp_path, monkeypatch,
                                               capsys):
    """The bridge's scatter is scatter_route's at the gates' PerfConfig:
    K1 on a CUDA device, the exact max on the CPU, as its gates line says;
    its forward decodes in one chunk a batch unless RCFD_DECODE_CHUNKS
    says otherwise."""
    routes = []
    route = radarnet_main.scatter_route
    monkeypatch.setattr(radarnet_main, 'scatter_route',
                        lambda *a: routes.append(a) or route(*a))
    for name in GATES:
        monkeypatch.delenv(name, raising=False)
    manifests = runs['trees']['port_codec'][1]
    bridge.main(_argv(manifests, str(tmp_path), runs['ckpt'], gt=False,
                      splits=('val',)) + ['--paths_only'], device='cpu')
    assert routes == []
    tree = str(tmp_path / 'tree')
    manifests = _copy_tree(runs['src'], tree)
    bridge.main(_argv(manifests, os.path.join(tree, 'derived'), runs['ckpt'],
                      gt=False, splits=('val',)), device='cpu')
    pallas_scatter, device, k = routes[0]
    assert pallas_scatter is None and torch.device(device).type == 'cpu'
    assert route(pallas_scatter, torch.device('cuda'), k) is scatter_cuda
    lines = [s for s in capsys.readouterr().out.splitlines()
             if 'Gates:' in s]
    assert lines[0] == (
        '[val] Gates: scatter the exact float max (RCFD_PALLAS_SCATTER '
        'unset), RCFD_FUSED_POOL2 0, RCFD_FUSED_POOL4 0, RCFD_DECODE_CHUNKS '
        'auto, RCFD_COMPUTE_DTYPE float32')


@pytest.mark.parametrize('batched,chunks', [(False, 1), (True, 4)])
def test_single_frame_forward_decodes_at_once(monkeypatch, batched, chunks):
    """Under RCFD_DECODE_CHUNKS=4 (PerfConfig(decode_chunks=4)) the
    batched forward decodes in 4 chunks; the single-frame make_forward_fn
    in one, as JAX's does."""
    from rcfd_tpu_torch.models.radarnet import RadarNetModel
    from rcfd_tpu_torch.nn.perf import perf_from_env

    monkeypatch.setenv('RCFD_DECODE_CHUNKS', '4')
    model = RadarNetModel(**RADARNET, device='cpu', perf=perf_from_env())
    seen = []
    forward_chunked = model.forward_chunked
    monkeypatch.setattr(model, 'forward_chunked',
                        lambda *a, **k: seen.append(a[3]) or
                        forward_chunked(*a, **k))
    rng = np.random.default_rng(1)
    image = torch.from_numpy(rng.integers(0, 256, (1, H, W, 3),
                                          dtype=np.uint8))
    points = torch.from_numpy(np.stack([
        rng.integers(0, W, 8), rng.integers(0, H, 8),
        rng.random(8) * 50 + 1], -1).astype(np.float32))
    valid = torch.ones(8, dtype=torch.bool)
    transforms = Transforms(normalized_image_range=[0, 1])
    if batched:
        out = radarnet_main.make_forward_fn_batched(
            model, transforms, H, W)(image, points[None], valid[None])[0][0]
    else:
        out = radarnet_main.make_forward_fn(model, transforms, H, W)(
            image, points, valid)[0]
    assert seen == [chunks]
    assert out.shape == (H, W)


def test_bridge_output_trains_fusionnet(runs, tmp_path):
    """The chain: the port's bridge output (the *_predicted manifests of
    its codec run) feeds one step of the port's FusionNet training on the
    CPU, with the frames' ground truth as ground truth and lidar map."""
    tree, manifests = runs['trees']['port_codec']
    derived = os.path.join(tree, 'derived')
    flags = []
    for split, prefix in (('train', 'training'), ('val', 'validation')):
        flags += ['--{}_image_path'.format(split), manifests[split, 'image'],
                  '--{}_ground_truth_path'.format(split),
                  manifests[split, 'ground_truth']]
        for kind in ('depth', 'response'):
            flags += ['--{}_{}_path'.format(split, kind), os.path.join(
                derived, prefix, 'nuscenes', 'nuscenes_{}_{}_predicted.txt'
                .format(split, kind))]
    flags += ['--train_lidar_map_path', manifests['train', 'ground_truth']]
    timings = []
    ckpt = str(tmp_path / 'ckpt')
    best = train_fusionnet.main(flags + [
        '--batch_size', '2', '--n_height', '32', '--n_width', '32',
        '--learning_schedule', '1', '--n_thread', '2',
        '--n_filters_encoder_image', '8', '12', '16', '16', '16',
        '--n_filters_encoder_depth', '4', '6', '8', '8', '8',
        '--fusion_type', 'weight_and_project',
        '--n_filters_decoder', '16', '12', '8', '8', '8',
        '--min_predict_depth', '1', '--augmentation_random_crop_type',
        'horizontal', '--checkpoint_dirpath', ckpt, '--device', 'cpu'],
        timings=timings)
    assert [t['step'] for t in timings] == [1]
    assert np.isfinite(timings[0]['loss'])
    assert os.path.exists(os.path.join(ckpt, 'model-1.pth'))
    assert np.isfinite(best['mae'])
