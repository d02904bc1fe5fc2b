"""The port's parity tool (python -m rcfd_tpu_torch.tools.parity_protocol)
against the JAX package's tools/parity_protocol.py on the CPU. On the same
JAX-made fixture and JAX-made .pth checkpoints, the JAX tool runs in this
process with --skip_reference and the port's on the CPU; the JAX tool's
metrics go in as the reference column of the port's format_table, which
must say PARITY PASS under the tool's own tolerances: 10 mm / 0.05 1/km
plus 1e-3 of the reference's value, and 5e-3 of it on the stage-1
intersection metrics. The port's --synthetic runs write the JAX tool's
report without a reference."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from rcfd_tpu.models import FusionNetModel as JaxFusionNet  # noqa: E402
from rcfd_tpu.models import RadarNetModel as JaxRadarNet  # noqa: E402
from rcfd_tpu.utils.checkpoint import torch_state_dict_to_tree  # noqa: E402

from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel  # noqa: E402
from rcfd_tpu_torch.nn import init_parameters  # noqa: E402
from rcfd_tpu_torch.tools import parity_protocol  # noqa: E402

from fixtures import (make_fusionnet_fixture,  # noqa: E402
                      make_radarnet_fixture)
from torch_parity import randomize_batch_norm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSIONNET = dict(
    input_channels_image=3, input_channels_depth=2,
    encoder_type='fusionnet18_batch_norm',
    n_filters_encoder_image=[8, 12, 16, 16, 16],
    n_filters_encoder_depth=[4, 6, 8, 8, 8],
    fusion_type='weight_and_project', decoder_type='multiscale_batch_norm',
    n_resolution_decoder=1, n_filters_decoder=[16, 12, 8, 8, 8],
    min_predict_depth=1.0, max_predict_depth=100.0)
FUSIONNET_FLAGS = ['--n_filters_encoder_image', '8', '12', '16', '16', '16',
                   '--n_filters_encoder_depth', '4', '6', '8', '8', '8',
                   '--n_filters_decoder', '16', '12', '8', '8', '8']
RADARNET = dict(
    input_channels_image=3, input_channels_depth=3,
    input_patch_size_image=(32, 32), encoder_type='radarnetv1_batch_norm',
    n_filters_encoder_image=[4, 8, 8, 8, 8],
    n_neurons_encoder_depth=[4, 8, 8, 8, 8],
    decoder_type='multiscale_batch_norm', n_filters_decoder=[8, 8, 8, 8, 8])
RADARNET_FLAGS = ['--patch_size', '32', '32',
                  '--radarnet_n_filters_encoder_image', '4', '8', '8', '8',
                  '8', '--radarnet_n_neurons_encoder_depth', '4', '8', '8',
                  '8', '8', '--radarnet_n_filters_decoder', '8', '8', '8',
                  '8', '8']
TOL_MM, TOL_INV, TOL_REL, TOL_REL_STAGE1 = 10.0, 0.05, 1e-3, 5e-3


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        'jax_parity_protocol',
        os.path.join(REPO, 'tools', 'parity_protocol.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_checkpoint(path, jax_cls, cls, config, seed, scale_output0=None):
    """A JAX-written .pth of ``config``: weights drawn by the port's
    init_parameters (JAX's eager init takes seconds a shape), through the
    JAX package's state_dict reader, batch norm drawn from ``seed``;
    ``scale_output0`` scales the decoder's output0 weight (the JAX tool's
    synthetic two-stage RadarNet takes 50)."""
    model = cls(**config, device='cpu')
    init_parameters(model, torch.Generator().manual_seed(seed))
    parts = [torch_state_dict_to_tree(getattr(model, p).state_dict())
             for p in ('encoder', 'decoder')]
    params, state = randomize_batch_norm(
        {'encoder': parts[0][0], 'decoder': parts[1][0]},
        {'encoder': parts[0][1], 'decoder': parts[1][1]},
        np.random.default_rng(seed))
    if scale_output0:
        out0 = params['decoder']['output0']['conv']
        out0['weight'] = out0['weight'] * np.float32(scale_output0)
    jax_cls(**config).save_checkpoint(path, params, state, step=7)
    return path


def _assert_pass(ref, ours, tol_rel, name):
    table, verdict = parity_protocol.format_table(ref, ours, TOL_MM,
                                                  TOL_INV, tol_rel)
    assert verdict == 'PARITY PASS', (name, table)
    assert '| rcfd_tpu_torch | delta |' in table
    return table


def test_single_stage_passes_against_the_jax_tool(tmp_path, jax_tool,
                                                   capsys):
    manifests = make_fusionnet_fixture(str(tmp_path / 'data'), n_samples=3,
                                       height=32, width=48)
    ckpt = _jax_checkpoint(str(tmp_path / 'fusionnet-7.pth'), JaxFusionNet,
                           FusionNetModel, FUSIONNET, seed=5)
    argv = ['--fusionnet_checkpoint', ckpt,
            '--image_path', manifests['image'],
            '--depth_path', manifests['depth'],
            '--response_path', manifests['response'],
            '--ground_truth_path', manifests['ground_truth'],
            '--eval_batch_size', '2'] + FUSIONNET_FLAGS
    ref, jax_ours, jax_verdict = jax_tool.main(
        argv + ['--skip_reference', '--output_dirpath', str(tmp_path / 'jax')])
    assert ref is None
    ref, ours, verdict = parity_protocol.main(
        argv + ['--output_dirpath', str(tmp_path / 'port')], device='cpu')
    out = capsys.readouterr().out
    assert ref is None and verdict == jax_verdict == \
        'REFERENCE UNAVAILABLE (our metrics only)'
    assert parity_protocol.REFERENCE_UNAVAILABLE in out
    assert all(np.isfinite(ours[k]) for k in parity_protocol.METRICS)
    _assert_pass(jax_ours, ours, TOL_REL, 'single stage')
    report = (tmp_path / 'port' / 'parity_report.md').read_text()
    assert report.startswith('# Parity protocol report\n')
    assert '| MAE (mm) | n/a |' in report


def test_two_stage_passes_against_the_jax_tool(tmp_path, jax_tool):
    manifests = make_radarnet_fixture(str(tmp_path / 'data'), n_samples=3,
                                      height=64, width=96, n_points=5)
    rn = _jax_checkpoint(str(tmp_path / 'radarnet-7.pth'), JaxRadarNet,
                         RadarNetModel, RADARNET, seed=6, scale_output0=50.0)
    fn = _jax_checkpoint(str(tmp_path / 'fusionnet-7.pth'), JaxFusionNet,
                         FusionNetModel, FUSIONNET, seed=7)
    argv = ['--two_stage', '--radarnet_checkpoint', rn,
            '--fusionnet_checkpoint', fn,
            '--image_path', manifests['image'],
            '--radar_path', manifests['radar'],
            '--ground_truth_path', manifests['ground_truth'],
            '--eval_batch_size', '2', '--skip_reference'] + \
        FUSIONNET_FLAGS + RADARNET_FLAGS
    _, jax_ours, _ = jax_tool.main(
        argv + ['--output_dirpath', str(tmp_path / 'jax')])
    ref, ours, overall = parity_protocol.main(
        argv + ['--output_dirpath', str(tmp_path / 'port')], device='cpu')
    assert ref is None and overall == \
        'REFERENCE UNAVAILABLE (our metrics only)'
    assert sorted(ours) == sorted(jax_ours) == ['fused', 'stage1', 'stage2']
    _assert_pass(jax_ours['stage1'], ours['stage1'], TOL_REL_STAGE1,
                 'stage 1')
    for section in ('stage2', 'fused'):
        _assert_pass(jax_ours[section], ours[section], TOL_REL, section)
    # the bridge the chain wrote: one depth and one response PNG a frame
    bridge = tmp_path / 'port' / 'ours_bridge'
    for kind in ('depth', 'response'):
        with open(bridge / '{}_predicted.txt'.format(kind)) as f:
            assert len([p for p in f.read().splitlines()
                        if os.path.exists(p)]) == 3


@pytest.mark.parametrize('two_stage', [False, True])
def test_synthetic_writes_the_jax_tools_report(tmp_path, capsys, two_stage):
    """--synthetic [--two_stage]: the report's sections are the JAX tool's,
    with the port's numbers finite and no reference."""
    out = str(tmp_path / 'out')
    argv = ['--synthetic', '--output_dirpath', out, '--eval_batch_size', '2']
    ref, ours, verdict = parity_protocol.main(
        argv + (['--two_stage'] if two_stage else []), device='cpu')
    assert ref is None
    assert verdict == 'REFERENCE UNAVAILABLE (our metrics only)'
    printed = capsys.readouterr().out
    assert parity_protocol.REFERENCE_UNAVAILABLE in printed
    report = open(os.path.join(out, 'parity_report.md')).read()
    assert 'wrote {}'.format(os.path.join(out, 'parity_report.md')) in printed
    if two_stage:
        assert report.startswith('# Two-stage parity protocol report\n')
        for heading in ('## Stage 1 — RadarNet intersection metrics',
                        '## Stage 2 — FusionNet on the PNG bridge',
                        '## Fused pipeline'):
            assert heading in report
        assert '**OVERALL: REFERENCE UNAVAILABLE (our metrics only)**' in \
            report
        metrics = [ours[s] for s in ('stage1', 'stage2', 'fused')]
    else:
        assert report.startswith('# Parity protocol report\n')
        assert '**REFERENCE UNAVAILABLE (our metrics only)**' in report
        metrics = [ours]
    for m in metrics:
        assert all(np.isfinite(m[k]) and m[k] > 0
                   for k in parity_protocol.METRICS)


def test_missing_inputs_are_refused(tmp_path):
    with pytest.raises(SystemExit):
        parity_protocol.main(['--output_dirpath', str(tmp_path)],
                             device='cpu')


def test_needs_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parity_protocol.main(['--synthetic', '--output_dirpath',
                              str(tmp_path)])
