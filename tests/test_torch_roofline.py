"""The port's roofline (python -m rcfd_tpu_torch.tools.roofline) on the
CPU: its --dry accounting against the JAX tool's (tools/roofline.py's
record_ops over jax.eval_shape), op for op and in its totals, exactly; its
timed run at a tiny frame; and its refusal to time without a card unless
asked for the CPU. The JAX package takes its packed decoder tail (a TPU
layout rewrite the port leaves out) off through its own gate,
RCFD_PACKED_TAIL=0."""

import importlib.util
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from rcfd_tpu_torch.tools import roofline, serving_config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the graphs at the sizes the CPU can trace: one frame, K = 4 points
CASES = {'fusionnet_b32': ['--batch', '1'],
         'pipeline_k64': ['--batch', '1', '--k', '4']}
JAX_DRY_KEYS = {'graph', 'batch', 'dry', 'n_ops', 'analytic_bytes',
                'analytic_flops'}
JAX_ROW_KEYS = {'graph', 'batch', 'dtype', 'backend', 'ms_per_call',
                'frames_per_s', 'analytic_bytes', 'analytic_gbps',
                'pct_hbm_peak_analytic', 'analytic_flops', 'tflops'}


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def jax_records():
    """The JAX tool's records of each case's graph, from its own
    build_* and record_ops over jax.eval_shape, with its packed tail off;
    the environment it sets on import is restored."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ('RCFD_COMPILE_CACHE', 'RCFD_COMPILE_CACHE_MIN_SECS'):
            mp.delenv(name, raising=False)
        mp.setenv('RCFD_PACKED_TAIL', '0')
        spec = importlib.util.spec_from_file_location(
            'jax_roofline', os.path.join(REPO, 'tools', 'roofline.py'))
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        import jax
        out = {}
        for graph in CASES:
            if graph == 'fusionnet_b32':
                forward, _, fargs, _ = tool.build_fusionnet_b32(
                    1, 'bfloat16')
            else:
                forward, _, fargs, _ = tool.build_pipeline_k64(
                    1, 'bfloat16', k=4)
            records = []
            with tool.record_ops(records):
                jax.eval_shape(forward, *fargs)
            out[graph] = records
        yield out


def _port_dry(graph):
    return roofline.main(['--graph', graph, '--dry'] + CASES[graph])


@pytest.mark.parametrize('graph', list(CASES))
def test_dry_records_equal_the_jax_tools_op_for_op(graph, jax_records):
    """The port's records on the meta device and the JAX tool's, in
    order: the same op, input and output element counts, input, weight and
    output bytes, and FLOPs (the port reads torch's OIHW / IOHW weights,
    the JAX tool HWIO)."""
    batch = int(CASES[graph][1])
    k = int(CASES[graph][3]) if graph == 'pipeline_k64' else 64
    port, _ = roofline.graph_records(graph, batch, 'bfloat16', 'meta', k=k)
    ref = jax_records[graph]
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p['op'] == r['op'], i
        assert math.prod(p['in_shape']) == math.prod(r['in_shape']), i
        assert math.prod(p['out_shape']) == math.prod(r['out_shape']), i
        for key in ('bytes_in', 'bytes_w', 'bytes_out', 'flops'):
            assert p[key] == r[key], (i, key)


@pytest.mark.parametrize('graph', list(CASES))
def test_dry_totals_equal_the_jax_tools(graph, jax_records, capsys):
    """python -m rcfd_tpu_torch.tools.roofline --dry: n_ops,
    analytic_bytes and analytic_flops exactly the JAX tool's; the JAX dry
    row's keys (padded_bytes, the TPU's lane padding, left out) and the
    dispatch upper estimate at least the analytic lower bound."""
    row = _port_dry(graph)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        row
    ref = jax_records[graph]
    assert row['n_ops'] == len(ref)
    assert row['analytic_bytes'] == sum(
        r['bytes_in'] + r['bytes_w'] + r['bytes_out'] for r in ref)
    assert row['analytic_flops'] == sum(r['flops'] for r in ref)
    assert JAX_DRY_KEYS <= set(row) and row['dry'] is True
    assert row['dispatch_bytes'] >= row['analytic_bytes']
    assert row['device'] == 'meta'


def test_dry_needs_no_card():
    """--dry runs on the meta device whatever the device argument."""
    row = roofline.main(['--graph', 'fusionnet_b32', '--dry', '--batch',
                         '1', '--dtype', 'float32'])
    assert row['n_ops'] > 0 and row['analytic_flops'] > 0


@pytest.mark.parametrize('graph', list(CASES))
def test_timed_run_on_cpu_at_a_tiny_frame(graph, monkeypatch):
    """A timed float32 run on the CPU at a 64 x 96 frame (RadarNet's patch
    64 x 32): the row holds the JAX row's keys, the dispatch and device
    keys and the named peaks; every number is finite, the time and the
    frame rate positive; its analytic totals equal the meta device's at
    the same shapes."""
    monkeypatch.setattr(serving_config, 'HEIGHT', 64)
    monkeypatch.setattr(serving_config, 'WIDTH', 96)
    monkeypatch.setattr(serving_config, 'RADARNET', dict(
        serving_config.RADARNET, input_patch_size_image=(64, 32)))
    argv = ['--graph', graph, '--dtype', 'float32', '--n_iters', '1'] + \
        CASES[graph]
    row = roofline.main(argv, device='cpu')
    assert JAX_ROW_KEYS <= set(row)
    assert row['device'] == 'cpu' and row['backend'] == 'cpu'
    assert 'FP32' in row['compute_peak'] and '3.35' in row['hbm_peak']
    assert row['ms_per_call'] > 0 and row['frames_per_s'] > 0
    # rounded as the JAX row rounds them: a CPU's rates may round to 0
    for key in ('analytic_gbps', 'dispatch_gbps', 'tflops',
                'pct_hbm_peak_analytic', 'pct_compute_peak'):
        assert np.isfinite(row[key]) and row[key] >= 0, key
    dry = roofline.main(['--graph', graph, '--dry', '--dtype',
                         'float32'] + CASES[graph])
    for key in ('n_ops', 'analytic_bytes', 'analytic_flops',
                'dispatch_bytes'):
        assert row[key] == dry[key], key


def test_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        roofline.main(['--batch', '1'])
