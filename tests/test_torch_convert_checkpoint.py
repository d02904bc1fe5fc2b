"""The port's checkpoint converter (python -m
rcfd_tpu_torch.tools.convert_checkpoint) against the JAX package's
tools/convert_checkpoint.py on the CPU: for both model families and both
directions, on the same JAX-written input at tiny widths given by flags,
the port's output file equals the JAX tool's key for key (the same dtypes,
shapes and values, exact; the train step and, in a .pth, the optimizer
state included), the printed line is the same, and the JAX package
restores the port's output."""

import os
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from rcfd_tpu.models import FusionNetModel as JaxFusionNet  # noqa: E402
from rcfd_tpu.models import RadarNetModel as JaxRadarNet  # noqa: E402
from rcfd_tpu.utils import checkpoint as jax_ckpt  # noqa: E402

from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel  # noqa: E402
from rcfd_tpu_torch.nn import init_parameters  # noqa: E402
from rcfd_tpu_torch.tools import convert_checkpoint  # noqa: E402

from torch_parity import (FUSIONNET_TINY, RADARNET_TINY,  # noqa: E402
                          randomize_batch_norm)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, 'tools', 'convert_checkpoint.py')
STEP = 4321
FLAGS = {
    'fusionnet': ['--n_filters_encoder_image', '4', '8', '8', '8', '8', '8',
                  '--n_filters_encoder_depth', '4', '4', '8', '8', '8', '8',
                  '--n_filters_decoder', '8', '8', '8', '8', '8', '8'],
    'radarnet': ['--patch_size', '32', '32',
                 '--n_filters_encoder_image_radarnet', '4', '8', '8', '8', '8',
                 '--n_neurons_encoder_depth', '4', '8', '8', '8', '8',
                 '--n_filters_decoder_radarnet', '8', '8', '8', '8', '8'],
}
MODELS = {'fusionnet': (JaxFusionNet, FusionNetModel, FUSIONNET_TINY),
          'radarnet': (JaxRadarNet, RadarNetModel, RADARNET_TINY)}


def _trees(name, seed):
    """The JAX package's (params, state) numpy trees of a tiny model, from
    weights drawn by the port's init_parameters (JAX's eager init takes
    seconds a shape on the CPU), batch norm drawn from ``seed``."""
    _, cls, config = MODELS[name]
    model = cls(**config, device='cpu')
    init_parameters(model, torch.Generator().manual_seed(seed))
    parts = [jax_ckpt.torch_state_dict_to_tree(getattr(model, p).state_dict())
             for p in ('encoder', 'decoder')]
    return randomize_batch_norm(
        {'encoder': parts[0][0], 'decoder': parts[1][0]},
        {'encoder': parts[0][1], 'decoder': parts[1][1]},
        np.random.default_rng(seed))


def _adam(params, rng, count=3):
    """A JAX Adam state of random moments at step ``count``, as the JAX
    package's training exports it into a .pth."""
    import jax
    opt = {'count': np.int32(count),
           'mu': jax.tree_util.tree_map(
               lambda x: rng.normal(size=x.shape).astype(x.dtype), params),
           'nu': jax.tree_util.tree_map(
               lambda x: rng.random(x.shape).astype(x.dtype), params)}
    return jax_ckpt.optax_adam_to_torch_state(params, opt, 1e-3, 0.0)


def _jax_input(tmp_path, name, fmt, adam, seed):
    jax_cls, _, config = MODELS[name]
    params, state = _trees(name, seed)
    path = str(tmp_path / 'input-{}.{}'.format(name, fmt))
    jax_cls(**config).save_checkpoint(
        path, params, state, step=STEP,
        optimizer_state_dict=_adam(params, np.random.default_rng(seed))
        if adam else None)
    return path, params, state


def _run_jax(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, 'argv', [TOOL] + argv)
    runpy.run_path(TOOL, run_name='__main__')
    return capsys.readouterr().out


def _run_port(argv, capsys):
    step = convert_checkpoint.main(argv, device='cpu')
    return step, capsys.readouterr().out


def _assert_same(got, want, where=''):
    """Two loaded checkpoints equal key for key: dicts with the same keys
    (in any order: the JAX tool writes a .npz's state_dicts in the file's
    sorted order), tensors and arrays of the same dtype, shape and
    values, other values equal and of the same type."""
    if isinstance(want, dict):
        assert isinstance(got, dict), where
        assert sorted(got, key=str) == sorted(want, key=str), where
        for k in want:
            _assert_same(got[k], want[k], '{}/{}'.format(where, k))
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, '{}[{}]'.format(where, i))
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), where
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (where, got.dtype, want.dtype, got.shape, want.shape)
        assert torch.equal(got, want), where
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _load(path):
    if path.endswith('.pth'):
        return torch.load(path, map_location='cpu', weights_only=True)
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _assert_same_npz(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, (k, got[k].dtype, want[k].dtype)
        assert np.array_equal(got[k], want[k]), k


CASES = [('fusionnet', 'pth', 'npz', False),
         ('fusionnet', 'npz', 'pth', False),
         ('radarnet', 'pth', 'npz', False), ('radarnet', 'npz', 'pth', False),
         # a non-empty Adam state: carried into a .pth, dropped from a .npz
         ('fusionnet', 'pth', 'pth', True), ('fusionnet', 'pth', 'npz', True)]


@pytest.mark.parametrize('name,src,dst,adam', CASES,
                         ids=['{}-{}-{}{}'.format(n, s, d, '-adam' * a)
                              for n, s, d, a in CASES])
def test_output_equals_the_jax_tools(tmp_path, monkeypatch, capsys, name,
                                     src, dst, adam):
    """Tolerance: none, every key, dtype, shape and value exact."""
    path, params, state = _jax_input(tmp_path, name, src, adam,
                                     seed=len(name) + adam)
    outs = {}
    lines = {}
    for side in ('jax', 'port'):
        out = str(tmp_path / side / 'output.{}'.format(dst))
        os.makedirs(os.path.dirname(out))
        argv = ['--model', name, '--input', path, '--output', out] + \
            FLAGS[name]
        if side == 'jax':
            lines[side] = _run_jax(argv, monkeypatch, capsys)
        else:
            step, lines[side] = _run_port(argv, capsys)
            assert step == STEP
        outs[side] = out
    assert lines['port'] == lines['jax'].replace(outs['jax'], outs['port'])
    assert lines['port'] == 'converted {} -> {} (step {})\n'.format(
        path, outs['port'], STEP)
    got, want = _load(outs['port']), _load(outs['jax'])
    if dst == 'pth':
        _assert_same(got, want)
        key = 'optimizer_state_dict' if name == 'fusionnet' else \
            'radarnet_optimizer_state_dict'
        assert bool(got[key]) == (adam and src == 'pth')
    else:
        _assert_same_npz(got, want)
    # the JAX package restores the port's output to the input's trees
    jax_cls, _, config = MODELS[name]
    p, s, step, opt = jax_cls(**config).restore_checkpoint(outs['port'])
    assert step == STEP
    for tree, ref in ((p, params), (s, state)):
        flat, flat_ref = (jax_ckpt.tree_to_torch_state_dict(t)
                          for t in (tree, ref))
        for k in flat_ref:
            assert np.array_equal(np.asarray(flat[k]).reshape(-1),
                                  np.asarray(flat_ref[k]).reshape(-1)), k


def test_bad_model_is_refused(tmp_path, capsys):
    """--model takes fusionnet or radarnet, as the JAX tool's."""
    with pytest.raises(SystemExit) as err:
        convert_checkpoint.main(['--model', 'voiced', '--input', 'a.pth',
                                 '--output', 'b.npz'], device='cpu')
    assert err.value.code == 2
    assert "invalid choice: 'voiced'" in capsys.readouterr().err


def test_needs_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    path, _, _ = _jax_input(tmp_path, 'radarnet', 'pth', False, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert_checkpoint.main(['--model', 'radarnet', '--input', path,
                                 '--output', str(tmp_path / 'out.npz')] +
                                FLAGS['radarnet'])
