"""The port's loader-fed training harness (python -m
rcfd_tpu_torch.tools.trainbench) on the CPU: its JSON row for both
families at the tiny widths on one rank and on two gloo ranks, its
refusals, its first batch against the JAX tool's loader on the same
fixture and seed, and its first step's loss against the JAX tool's step
from the same (converted) weights. Each test states its tolerance."""

import argparse
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from rcfd_tpu.utils.checkpoint import torch_state_dict_to_tree  # noqa: E402

from rcfd_tpu_torch.data.loader import device_prefetch  # noqa: E402
from rcfd_tpu_torch.tools import trainbench  # noqa: E402
from rcfd_tpu_torch.training import make_optimizer  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

from torch_parity import randomize_batch_norm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROW_KEYS = {'harness', 'family', 'model', 'backend', 'n_devices',
                'batch_size', 'shape', 'train_dtype', 'step_ms',
                'step_only_ms', 'step_only_samples_per_s', 'samples_per_s',
                'samples_per_s_per_chip', 'loader_only_samples_per_s',
                'loss'}
NUMBERS = ('step_ms', 'step_only_ms', 'step_only_samples_per_s',
           'samples_per_s', 'samples_per_s_per_chip',
           'loader_only_samples_per_s', 'loss')
FAMILIES = ('fusionnet', 'radarnet')
# tests/test_torch_train.py's tolerance of a float32 step-1 loss against
# JAX's through the training loop
LOSS_RTOL = 1e-4


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def data_dirs(tmp_path_factory):
    """A fixture directory a family, made by the port's first run."""
    return {f: str(tmp_path_factory.mktemp(f)) for f in FAMILIES}


def _argv(family, data_dir, *extra):
    return ['--family', family, '--n_samples', '8', '--batch_size', '2',
            '--n_steps', '2', '--n_warmup', '1', '--n_thread', '2',
            '--data_dir', data_dir] + list(extra)


def _check_row(row, family, n_devices):
    assert JAX_ROW_KEYS | {'device'} == set(row)
    assert row['family'] == family and row['model'] == 'tiny'
    assert row['n_devices'] == n_devices and row['batch_size'] == 2
    assert row['backend'] == 'cpu' and row['device'] == 'cpu'
    assert row['train_dtype'] == 'float32'
    for key in NUMBERS:
        assert np.isfinite(row[key]), key
        assert key == 'loss' or row[key] > 0, key


@pytest.mark.parametrize('family', FAMILIES)
def test_row_on_one_cpu_rank(family, data_dirs):
    """The row has the JAX row's keys and ``device``; every number is
    finite, the rates positive."""
    row = trainbench.main(_argv(family, data_dirs[family]), device='cpu')
    _check_row(row, family, 1)


@pytest.mark.parametrize('family', FAMILIES)
def test_row_on_two_gloo_ranks(family, data_dirs):
    """--n_devices 2 on the CPU: two spawned gloo ranks, a sample each;
    rank 0's row, with n_devices 2."""
    row = trainbench.main(_argv(family, data_dirs[family], '--n_devices',
                                '2'), device='cpu')
    _check_row(row, family, 2)


@pytest.mark.parametrize('argv', [['--n_steps', '0'], ['--n_warmup', '-1']])
def test_rejects_bad_counts(argv):
    with pytest.raises(SystemExit):
        trainbench.main(argv, device='cpu')


def test_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainbench.main(['--n_steps', '1'])


@pytest.fixture(scope='module')
def jax_tool():
    with pytest.MonkeyPatch.context() as mp:
        for name in ('RCFD_COMPILE_CACHE', 'RCFD_COMPILE_CACHE_MIN_SECS'):
            mp.delenv(name, raising=False)
        spec = importlib.util.spec_from_file_location(
            'jax_trainbench', os.path.join(REPO, 'tools', 'trainbench.py'))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        yield module


def _args(family, data_dir):
    args = trainbench.build_parser().parse_args(_argv(family, data_dir))
    args.patch_width = max(32, (args.width // 3) // 32 * 32)
    return args


@pytest.mark.parametrize('family', FAMILIES)
def test_first_batch_and_step_equal_the_jax_tools(family, data_dirs,
                                                  jax_tool):
    """On the same fixture (the port's writers, tools/fixtures.py) and
    seed, the harness's first batch equals the JAX tool's loader's exactly
    (values and dtypes). From the port's weights converted to JAX trees
    (batch norm drawn from a seed and loaded back into the port), the first
    step without augmentation gives the JAX tool's step's loss
    within rtol 1e-4."""
    import jax
    from rcfd_tpu.data.loader import DataLoader as JaxLoader
    from rcfd_tpu.parallel.optim import init_adam

    args = _args(family, data_dirs[family])
    build = trainbench.build_radarnet if family == 'radarnet' else \
        trainbench.build_fusionnet
    dataset, model, make_step, transforms = build(args, 'cpu')
    loader = trainbench.make_loader(args, dataset, 2)
    loader.set_epoch(0)
    batch = next(iter(loader))

    jax_build = jax_tool.build_radarnet if family == 'radarnet' else \
        jax_tool.build_fusionnet
    jax_dataset, jax_model, jax_make_step = jax_build(
        argparse.Namespace(**vars(args)), jax)
    jax_loader = JaxLoader(jax_dataset, batch_size=2, shuffle=True,
                           num_workers=2, seed=0, drop_last=True)
    jax_loader.set_epoch(0)
    ref = next(iter(jax_loader))
    assert len(batch) == len(ref)
    for a, r in zip(batch, ref):
        assert a.dtype == r.dtype and np.array_equal(a, r)

    trees = [torch_state_dict_to_tree(getattr(model, part).state_dict())
             for part in ('encoder', 'decoder')]
    params, state = randomize_batch_norm(
        {'encoder': trees[0][0], 'decoder': trees[1][0]},
        {'encoder': trees[0][1], 'decoder': trees[1][1]},
        np.random.default_rng(5))
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    step = jax.jit(jax_make_step(None))
    _, _, _, info = step(params, state, init_adam(params), ref,
                         jax.random.PRNGKey(1), np.float32(1e-4),
                         np.float32(0.0))

    port_step = make_step(model, make_optimizer(model, 1e-4, 0.0))
    points_shape = (2, args.total_points_sampled, 3) \
        if family == 'radarnet' else ()
    draws = transforms.draws(torch.Generator().manual_seed(0), 2, 0.0,
                             points_shape)
    tensors = next(device_prefetch([batch], 'cpu', buffer_size=1))
    loss = float(port_step.backward(tensors, draws)['loss'])
    np.testing.assert_allclose(loss, float(info['loss']), rtol=LOSS_RTOL)
