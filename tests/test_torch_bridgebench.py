"""The port's bridge harness (python -m rcfd_tpu_torch.tools.bridgebench)
on the CPU: --check_only at the JAX harness test's flags, its files against
the JAX harness's run_bridge on the same fixture and weights, its three
modes against each other in bf16, and its refusal to run without a card
unless asked for the CPU. Each test states its tolerance."""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import rcfd_tpu.radarnet_main as jax_radarnet_main  # noqa: E402
from rcfd_tpu.data import io as jax_io  # noqa: E402
from rcfd_tpu.data.datasets import \
    RadarNetInferenceDataset as JaxDataset  # noqa: E402
from rcfd_tpu.data.transforms import Transforms as JaxTransforms  # noqa
from rcfd_tpu.utils.checkpoint import torch_state_dict_to_tree  # noqa: E402

from rcfd_tpu_torch import radarnet_main  # noqa: E402
from rcfd_tpu_torch.data import io as port_io  # noqa: E402
from rcfd_tpu_torch.data.datasets import RadarNetInferenceDataset  # noqa
from rcfd_tpu_torch.data.transforms import Transforms  # noqa: E402
from rcfd_tpu_torch.models import RadarNetModel  # noqa: E402
from rcfd_tpu_torch.nn import init_parameters  # noqa: E402
from rcfd_tpu_torch.pipeline import radarnet_crops  # noqa: E402
from rcfd_tpu_torch.tools import bridgebench  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa

from fixtures import make_radarnet_fixture  # noqa: E402
from torch_parity import randomize_batch_norm, unexplained_depth  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_bridgebench.py's flags
CHECK_ARGV = ['--height', '64', '--width', '96', '--patch', '64', '32',
              '--n_frames', '6', '--n_points', '8', '--eval_batch_size', '4',
              '--dtype', 'float32', '--check_only']
H, W, PATCH = 64, 96, (64, 32)
N_FRAMES, N_POINTS, BATCH = 6, 8, 4
RADARNET = dict(
    input_channels_image=3, input_channels_depth=3,
    input_patch_size_image=PATCH, encoder_type='radarnetv1_batch_norm',
    n_filters_encoder_image=[8, 12, 16, 16, 16],
    n_neurons_encoder_depth=[8, 12, 16, 16, 16],
    decoder_type='multiscale_batch_norm', n_filters_decoder=[16, 12, 8, 8, 8])
# two responses this close (16 float32 steps at 0.5) are a tie that either
# package's rounding may break either way (tests/test_torch_bridge.py)
TIE_TOL = 2.0 ** -20
JAX_ROW_KEYS = {'harness', 'n_frames', 'shape', 'patch', 'n_points',
                'eval_batch_size', 'dtype', 'backend', 'check_only',
                'results'}


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def jax_tool():
    """tools/bridgebench.py as a module; the environment it sets on import
    (its compile cache) is restored after the module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ('RCFD_COMPILE_CACHE', 'RCFD_COMPILE_CACHE_MIN_SECS'):
            mp.delenv(name, raising=False)
        spec = importlib.util.spec_from_file_location(
            'jax_bridgebench', os.path.join(REPO, 'tools', 'bridgebench.py'))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        yield module


def test_check_only_row_on_cpu(capsys):
    """--check_only at the JAX test's flags: the three modes run and agree
    (asserted inside the harness), and the last line is the JAX row with
    ``device`` added, every mode's frames/s > 0."""
    row = bridgebench.main(CHECK_ARGV, device='cpu')
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == row
    assert set(row) == JAX_ROW_KEYS | {'device'}
    assert row['harness'] == 'bridgebench' and row['check_only']
    assert row['backend'] == 'cpu' and row['device'] == 'cpu'
    for mode in ('prefetch', 'sync', 'codec'):
        assert row['results'][mode]['frames_per_s'] > 0


def test_bf16_modes_agree(capsys):
    """In bf16 the three modes write the same depth (prefetch, sync) and the
    same files (codec, prefetch), exact: --check_only asserts it."""
    row = bridgebench.main(CHECK_ARGV[:-3] + ['--dtype', 'bfloat16',
                                              '--check_only'], device='cpu')
    assert row['dtype'] == 'bfloat16'
    assert set(row['results']) == {'prefetch', 'sync', 'codec'}


@pytest.mark.parametrize('argv', [['--n_frames', '0'], ['--n_points', '0']])
def test_rejects_bad_args(argv):
    with pytest.raises(SystemExit):
        bridgebench.main(argv, device='cpu')


def test_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridgebench.main(CHECK_ARGV)


def _weights(seed):
    """JAX (params, state) trees of RADARNET drawn by the port's
    init_parameters (through the JAX package's state_dict reader), batch
    norm drawn from ``seed``; and the port's model with the same weights,
    carried by state_dict_from_jax."""
    model = RadarNetModel(**RADARNET, device='cpu')
    init_parameters(model, torch.Generator().manual_seed(seed))
    trees = [torch_state_dict_to_tree(getattr(model, part).state_dict())
             for part in ('encoder', 'decoder')]
    params, state = randomize_batch_norm(
        {'encoder': trees[0][0], 'decoder': trees[1][0]},
        {'encoder': trees[0][1], 'decoder': trees[1][1]},
        np.random.default_rng(seed))
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return params, state, model


@pytest.fixture(scope='module')
def runs(tmp_path_factory, jax_tool):
    """The JAX harness's run_bridge and the port's, prefetch mode, float32,
    on one JAX-made fixture with the same weights."""
    root = str(tmp_path_factory.mktemp('bridgebench'))
    manifests = make_radarnet_fixture(os.path.join(root, 'data'),
                                      n_samples=N_FRAMES, height=H, width=W,
                                      n_points=N_POINTS)
    images = port_io.read_paths(manifests['image'])
    radar = port_io.read_paths(manifests['radar'])
    params, state, model = _weights(3)
    jax_model = jax_radarnet_main._build_model(
        input_channels_image=3, input_channels_depth=3, patch_size=PATCH,
        encoder_type=RADARNET['encoder_type'],
        n_filters_encoder_image=RADARNET['n_filters_encoder_image'],
        n_neurons_encoder_depth=RADARNET['n_neurons_encoder_depth'],
        decoder_type=RADARNET['decoder_type'],
        n_filters_decoder=RADARNET['n_filters_decoder'],
        weight_initializer='kaiming_uniform', activation_func='leaky_relu')
    jax_fwd = jax_radarnet_main.make_forward_fn_batched(
        jax_model, JaxTransforms(normalized_image_range=[0, 1]), H, W)
    _, n, jax_paths = jax_tool.run_bridge(
        'prefetch', jax_fwd, params, state,
        JaxDataset(image_paths=images, radar_paths=radar,
                   max_points=N_POINTS),
        os.path.join(root, 'jax'), BATCH)
    assert n == N_FRAMES
    dataset = RadarNetInferenceDataset(images, radar, max_points=N_POINTS,
                                       device='cpu')
    fwd = radarnet_main.make_forward_fn_batched(
        model, Transforms(normalized_image_range=[0, 1]), H, W)
    _, n, port_paths = bridgebench.run_bridge(
        'prefetch', fwd, dataset, os.path.join(root, 'port'), BATCH, 'cpu')
    assert n == N_FRAMES
    crops = []
    for i in range(N_FRAMES):
        image, points, valid = dataset.get(i)
        with torch.no_grad(), radarnet_main.eval_mode(model):
            _, c, _, _ = radarnet_crops(
                model, Transforms(normalized_image_range=[0, 1]),
                torch.from_numpy(image[None]), torch.from_numpy(points[None]),
                H)
        crops.append((c[0].numpy(), points, valid))
    return dict(jax=jax_paths, port=port_paths, crops=crops)


def test_files_match_the_jax_harness(runs):
    """The port's files against the JAX harness's, frame for frame, at the
    same names: response codes within 1 (a response a float32 step apart
    may floor to the next 2^-14 code); depth codes equal but at ties
    (the top two responses of the points covering the pixel within
    TIE_TOL of each other, or one within TIE_TOL of the 0.5 threshold,
    found from the port's own crops), at most 1% of the covered pixels."""
    covered = differ = 0
    for f, (pj, pp) in enumerate(zip(runs['jax'], runs['port'])):
        assert os.path.basename(pj) == os.path.basename(pp)
        for kind in ('depth_', 'resp_'):
            a = np.asarray(jax_io.load_depth(pj.replace('depth_', kind),
                                             multiplier=1.0), np.int64)
            b = port_io.load_depth_raw(pp.replace('depth_', kind))
            assert a.shape == b.shape == (H, W)
            if kind == 'resp_':
                assert np.abs(a - b).max() <= 1, (pp, np.abs(a - b).max())
                continue
            crops, points, valid = runs['crops'][f]
            assert not unexplained_depth(b, a, crops, points, valid, PATCH,
                                         TIE_TOL), pp
            covered += int((b > 0).sum())
            differ += int((a != b).sum())
    assert covered > 100 and differ <= 0.01 * covered, (covered, differ)
