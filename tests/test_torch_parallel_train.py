"""Both trainings of the port on two ranks (rcfd_tpu_torch.fusionnet_main
and radarnet_main with n_data_parallel=2: gloo ranks on the CPU) against
the JAX package's trainings over a 2-device mesh (tests/conftest.py's
virtual CPU devices), the CLIs' --n_data_parallel, and the multi-host
contract (RCFD_COORDINATOR, RCFD_NUM_PROCESSES, RCFD_PROCESS_ID) against
one process. Each test states its tolerance."""

import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from rcfd_tpu import fusionnet_main as jax_fn_main  # noqa: E402
from rcfd_tpu import radarnet_main as jax_rn_main  # noqa: E402
from rcfd_tpu.models import FusionNetModel as JaxFusionNet  # noqa: E402
from rcfd_tpu.models import RadarNetModel as JaxRadarNet  # noqa: E402

from rcfd_tpu_torch import parallel, train_fusionnet  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

import test_torch_train as fn_tests  # noqa: E402
import test_torch_train_radarnet as rn_tests  # noqa: E402
import torch_parallel  # noqa: E402
from fixtures import make_fusionnet_fixture, make_radarnet_fixture  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Tiny steps on one thread (tests/test_torch_train.py); the spawned
    ranks take the caller's thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the trainings on two ranks -----------------------------------------------


# augmentation on at probability 0: the draws are taken, no gate opens
FN_TRAIN = dict(fn_tests.TRAIN, batch_size=4, learning_schedule=[2],
                augmentation_random_brightness=[0.8, 1.2],
                augmentation_random_flip_type=['horizontal'])
RN_TRAIN = dict(rn_tests.TRAIN, augmentation_probabilities=[0.0])


def _jax_losses(results_path):
    """The losses a training logged at its checkpoints (5 decimals)."""
    with open(results_path) as f:
        text = f.read()
    return [float(v) for v in re.findall(r'Loss=\s*(\S+)', text)]


def _checkpoints(dirpath):
    return sorted(f for f in os.listdir(dirpath) if f.endswith('.pth'))


def _same_checkpoints(a, b):
    """Two directories' .pth files hold equal tensors, bit for bit."""
    assert _checkpoints(a) == _checkpoints(b) != []
    for name in _checkpoints(a):
        x, y = (torch.load(os.path.join(d, name), weights_only=True)
                for d in (a, b))
        assert sorted(x) == sorted(y)
        for key in x:
            if isinstance(x[key], dict) and key.endswith('state_dict') \
                    and 'optimizer' not in key:
                for k in x[key]:
                    assert torch.equal(x[key][k], y[key][k]), (name, key, k)


def _fusionnet_flags(data, **train):
    """train_fusionnet's flags for tests/test_torch_train.py's network."""
    flags = []
    for k, v in dict(data, **fn_tests.NET, **train).items():
        if k == 'n_resolutions_decoder':
            continue
        if k in ('encoder_type', 'decoder_type'):
            v = v.split('_', 1)
        flags.append('--' + k)
        flags += [str(x) for x in v] if isinstance(v, (list, tuple)) \
            else [str(v)]
    return flags


@pytest.fixture(scope='module')
def trainings(tmp_path_factory):
    """Each model trained on 2 gloo ranks from one JAX-saved step-0 .pth,
    augmentation off, and by the JAX package's train with n_data_parallel=2
    (a 2-device mesh) on the same files and start. The ranks run
    torch_parallel.recorded_train: FusionNet's train() with
    n_data_parallel=2, RadarNet's CLI with --device cpu --n_data_parallel
    2; FusionNet also through its CLI from this process, which starts the
    two ranks itself. FusionNet: 4 frames, global batch 4, 2 epochs;
    RadarNet: 4 frames, global batch 2, 1 epoch, validation at step 2 and
    at the end."""
    tmp = tmp_path_factory.mktemp('dp_train')
    out = {}
    m = make_fusionnet_fixture(str(tmp / 'fn'), n_samples=4,
                               height=fn_tests.FRAME[0],
                               width=fn_tests.FRAME[1])
    fn_data = dict(train_image_path=m['image'], train_depth_path=m['depth'],
                   train_response_path=m['response'],
                   train_ground_truth_path=m['ground_truth'],
                   train_lidar_map_path=m['lidar'],
                   val_image_path=m['image'], val_depth_path=m['depth'],
                   val_response_path=m['response'],
                   val_ground_truth_path=m['ground_truth'])
    m = make_radarnet_fixture(str(tmp / 'rn'), n_samples=4,
                              height=rn_tests.FRAME[0],
                              width=rn_tests.FRAME[1], n_points=6)
    rn_data = dict(train_image_path=m['image'], train_radar_path=m['radar'],
                   train_ground_truth_path=m['ground_truth'],
                   val_image_path=m['image'], val_radar_path=m['radar'],
                   val_ground_truth_path=m['ground_truth'])
    rng = np.random.default_rng(42)
    for kind in ('fusionnet', 'radarnet'):
        dirs = {k: str(tmp / kind / k) for k in ('jax', 'ranks', 'cli')}
        os.makedirs(str(tmp / kind))
        start = str(tmp / kind / 'model-0.pth')
        common = ['--restore_path', start, '--device', 'cpu',
                  '--n_data_parallel', '2']
        with pytest.MonkeyPatch.context() as mp:
            if kind == 'fusionnet':
                JaxFusionNet(**fn_tests.CONFIG).save_checkpoint(
                    start, *fn_tests._jax_variables(0, rng), step=0)
                kwargs = dict(restore_path=start, n_data_parallel=2,
                              **fn_data, **fn_tests.NET, **FN_TRAIN)
                # JAX's train draws weights it then replaces by the
                # restored ones: its jitted init for CONFIG, compiled
                # once, in place of half a minute of eager init
                mp.setattr(JaxFusionNet, 'init',
                           lambda self, key: fn_tests._jax_init_fn()(key))
                jax_fn_main.train(checkpoint_dirpath=dirs['jax'], **kwargs)
                call = dict(kwargs, checkpoint_dirpath=dirs['ranks'])
            else:
                JaxRadarNet(**rn_tests.config(rn_tests.WIDE)).save_checkpoint(
                    start, *rn_tests._jax_variables(rn_tests.WIDE, 0, rng),
                    step=0)
                kwargs = dict(restore_path=start, n_data_parallel=2,
                              **rn_data, **rn_tests.NET, **RN_TRAIN)
                jax_rn_main.train(checkpoint_dirpath=dirs['jax'], **kwargs)
                call = rn_tests._cli_flags(rn_data) + common + [
                    '--augmentation_probabilities', '0.0',
                    '--checkpoint_dirpath', dirs['ranks']]
        ranks = parallel.run_ranks(torch_parallel.recorded_train,
                                   (kind, call), 2, 'cpu')
        out[kind] = dict(dirs=dirs, ranks=ranks, kwargs=kwargs, start=start)
    timings = []
    train_fusionnet.main(_fusionnet_flags(fn_data, **FN_TRAIN) + [
        '--restore_path', out['fusionnet']['start'], '--device', 'cpu',
        '--n_data_parallel', '2', '--checkpoint_dirpath',
        out['fusionnet']['dirs']['cli']], timings=timings)
    out['fusionnet']['cli_timings'] = timings
    return out


@pytest.mark.parametrize('kind', ['fusionnet', 'radarnet'])
def test_ranks_draw_alike_for_their_slices(trainings, kind):
    """Every rank draws its augmentation for its own slice (the local
    batch) from the step's seed, so the two ranks' draws are equal at every
    step, as every JAX shard draws from the replicated key."""
    (_, drawn_a, _, _), (_, drawn_b, _, _) = trainings[kind]['ranks']
    local = trainings[kind]['kwargs']['batch_size'] // 2
    assert len(drawn_a) == len(drawn_b) == 2
    for (n_a, a), (n_b, b) in zip(drawn_a, drawn_b):
        assert n_a == n_b == local
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
            assert a[k].shape[0] == local
    assert not all(torch.equal(drawn_a[0][1][k], drawn_a[1][1][k])
                   for k in drawn_a[0][1])


@pytest.mark.parametrize('kind', ['fusionnet', 'radarnet'])
def test_rank_0_alone_writes(trainings, kind):
    """Rank 0 alone writes checkpoints, validates and writes the results
    file; both ranks return rank 0's best results; each step's loss is the
    group's mean, equal on both ranks."""
    run = trainings[kind]
    (best_a, _, saved_a, t_a), (best_b, _, saved_b, t_b) = run['ranks']
    assert saved_a == ['model-1.pth', 'model-2.pth', 'model-2.pth']
    assert saved_b == []
    # RadarNet's untrained crops stay under the threshold: no output pixel,
    # no best step, as in the JAX package
    assert best_a == best_b and best_a['step'] == (
        2 if kind == 'fusionnet' else -1)
    assert [t['loss'] for t in t_a] == [t['loss'] for t in t_b]
    assert [t['step'] for t in t_a] == [t['step'] for t in t_b] == [1, 2]
    with open(os.path.join(run['dirs']['ranks'], 'results.txt')) as f:
        text = f.read()
    assert text.count('Begin training...') == 1
    assert text.count('Validation results:') == (
        1 if kind == 'fusionnet' else 2)
    assert 'n_devices=2' in text


@pytest.mark.parametrize('kind', ['fusionnet', 'radarnet'])
def test_two_rank_training_matches_jax_two_devices(trainings, kind):
    """The 2-rank run's logged losses (each step's mean over the ranks)
    against the JAX package's train over a 2-device mesh on the same
    files and start: step 1 rtol 1e-4 (tests/test_torch_train.py's bound
    for the one-device loops); its checkpoints have the JAX run's names,
    and each restores in the JAX package at its step."""
    run = trainings[kind]
    losses = {k: _jax_losses(os.path.join(run['dirs'][k], 'results.txt'))
              for k in ('jax', 'ranks')}
    assert len(losses['ranks']) == len(losses['jax']) == 2
    np.testing.assert_allclose(losses['ranks'][0], losses['jax'][0],
                               rtol=1e-4)
    assert _checkpoints(run['dirs']['ranks']) == \
        _checkpoints(run['dirs']['jax'])
    jax_model = JaxFusionNet(**fn_tests.CONFIG) if kind == 'fusionnet' \
        else JaxRadarNet(**rn_tests.config(rn_tests.WIDE))
    model_cls = torch_parallel.MODELS[kind][0]
    for name in _checkpoints(run['dirs']['ranks']):
        path = os.path.join(run['dirs']['ranks'], name)
        params, state, step, _ = jax_model.restore_checkpoint(path)
        assert step == int(name[6])
        port = model_cls(**(fn_tests.CONFIG if kind == 'fusionnet' else
                            rn_tests.config(rn_tests.WIDE)), device='cpu')
        port.restore_checkpoint(path, device='cpu')
        ref = state_dict_from_jax(params, state)
        for k, v in port.state_dict().items():
            assert torch.equal(v.reshape(ref[k].shape).to(ref[k].dtype),
                               ref[k]), k


def test_cli_starts_the_ranks(trainings):
    """train_fusionnet.main(['--device', 'cpu', '--n_data_parallel', '2',
    ...]) from this process starts two ranks (train() launching them):
    each rank's step entries come back with its rank, and the checkpoints
    equal those of the ranks' own run at the same arguments, bit for bit.
    (RadarNet's CLI with those flags ran as the ranks' part above.)"""
    run = trainings['fusionnet']
    assert sorted(t['rank'] for t in run['cli_timings']) == [0, 0, 1, 1]
    _same_checkpoints(run['dirs']['cli'], run['dirs']['ranks'])


def test_two_hosts_equal_one_two_rank_process(trainings, tmp_path):
    """maybe_initialize_distributed's contract: two host processes, each
    with RCFD_COORDINATOR / RCFD_NUM_PROCESSES=2 / RCFD_PROCESS_ID set and
    one CPU rank (n_data_parallel left at None: a rank a host), train
    FusionNet as the one process with 2 ranks did: process 0's checkpoints
    equal the ranks' bit for bit, process 1 writes none."""
    run = trainings['fusionnet']
    dirs = [str(tmp_path / 'host{}'.format(i)) for i in range(2)]
    args = str(tmp_path / 'kwargs.pkl')
    with open(args, 'wb') as f:
        pickle.dump(dict(run['kwargs'], n_data_parallel=None), f)
    code = ('import pickle, sys, torch\n'
            'sys.path.insert(0, "tests")\n'
            'import torch_parallel\n'
            'torch_parallel.without_tensorflow()\n'
            'from rcfd_tpu_torch import fusionnet_main\n'
            'torch.set_num_threads(1)\n'
            'kw = pickle.load(open(sys.argv[1], "rb"))\n'
            'fusionnet_main.train(checkpoint_dirpath=sys.argv[2], '
            'device="cpu", **kw)\n')
    port = parallel.free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-c', code, args, dirs[i]], cwd=REPO,
        env=dict(os.environ, RCFD_COORDINATOR='127.0.0.1:{}'.format(port),
                 RCFD_NUM_PROCESSES='2', RCFD_PROCESS_ID=str(i),
                 OMP_NUM_THREADS='1'),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    _same_checkpoints(dirs[0], run['dirs']['ranks'])
    assert _checkpoints(dirs[1]) == []
