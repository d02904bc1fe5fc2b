"""rcfd_tpu_torch stands alone: it imports neither JAX nor anything of
rcfd_tpu, Pillow or torchvision (the GPU machine has none of them), its
kernels are built by hand with nvcc, and chip_smoke.py refuses to run
without a card or without the package beside it."""

import os
import re
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip('torch')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, 'rcfd_tpu_torch')
FORBIDDEN_IMPORT = re.compile(
    r'^\s*(?:import|from)\s+(jax\b|rcfd_tpu(?:\.|\s|$)|PIL\b|torchvision\b)',
    re.M)


def test_port_sources_include_the_measurement_tool():
    """The K4 tool and its kernels' module are port sources, held to the
    import rule below."""
    paths = [os.path.relpath(p, REPO) for p in _port_sources()]
    for path in ('rcfd_tpu_torch/tools/fusepall_exp.py',
                 'rcfd_tpu_torch/ops/fused_skip_variants.py',
                 'rcfd_tpu_torch/nn/optimize.py'):
        assert path in paths


def _port_sources():
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(root, f)
    yield os.path.join(REPO, 'chip_smoke.py')


@pytest.mark.parametrize('path', sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_forbidden(path):
    with open(path) as f:
        text = f.read()
    assert not FORBIDDEN_IMPORT.findall(text), path
    assert 'rcfd_tpu.' not in text.replace('rcfd_tpu_torch', ''), path
    # kernels are built by hand with nvcc, not by torch.utils.cpp_extension
    assert not re.search(r'^\s*(?:import|from)\s+torch\.utils\.cpp_extension',
                         text, re.M), path


def test_import_and_build_pipeline_without_jax():
    """A fresh interpreter imports every module of the port and builds the
    pipeline on the CPU; no JAX, rcfd_tpu, Pillow or torchvision module is
    loaded."""
    code = r'''
import importlib, pkgutil, sys
import rcfd_tpu_torch
for m in pkgutil.walk_packages(rcfd_tpu_torch.__path__, 'rcfd_tpu_torch.'):
    importlib.import_module(m.name)
from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel
from rcfd_tpu_torch.pipeline import TwoStagePipeline
rn = RadarNetModel(3, 3, (32, 32), 'radarnetv1-batch_norm', [4, 8, 8, 8, 8],
                   [4, 8, 8, 8, 8], 'multiscale-batch_norm', [8, 8, 8, 8, 8],
                   device='cpu')
fn = FusionNetModel(3, 2, 'fusionnet18_batch_norm', [4, 8, 8, 8, 8, 8],
                    [4, 4, 8, 8, 8, 8], 'weight_and_project',
                    'multiscale_batch_norm', 1, [8, 8, 8, 8, 8, 8],
                    device='cpu')
TwoStagePipeline(rn, fn, 64, 96, device='cpu')
TwoStagePipeline(rn, fn, 64, 96, optimize=True, device='cpu')
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'rcfd_tpu', 'PIL',
                                    'torchvision'))
assert not bad, bad
print('ok')
'''
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith('ok')


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    return subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_source_names_what_it_replaces():
    with open(os.path.join(PACKAGE, 'csrc', 'scatter_quasi_dense.cu')) as f:
        text = f.read()
    assert 'rcfd_tpu/ops/scatter_pallas.py::_kernel' in text
    assert 'extern "C"' in text and 'cudaGetLastError' in text


@pytest.mark.parametrize('source,replaces', [
    ('fused_skip_gather_add.cu', 'rcfd_tpu/ops/fused_skip.py::_fused_pallas'),
    ('column_crop.cu', 'rcfd_tpu/ops/crop_pallas.py::_kernel'),
    ('fused_skip_variants.cu', 'tools/fusepall_exp.py::variant_kernel')])
def test_kernel_sources_name_the_tpu_kernels_they_replace(source, replaces):
    with open(os.path.join(PACKAGE, 'csrc', source)) as f:
        text = f.read()
    assert replaces in text
    assert 'extern "C"' in text and 'cudaGetLastError' in text
