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
                 'rcfd_tpu_torch/nn/optimize.py',
                 'rcfd_tpu_torch/native/__init__.py',
                 'rcfd_tpu_torch/data/io.py',
                 'rcfd_tpu_torch/data/datasets.py',
                 'rcfd_tpu_torch/utils/eval_utils.py',
                 'rcfd_tpu_torch/utils/log_utils.py',
                 'rcfd_tpu_torch/run_pipeline.py',
                 'rcfd_tpu_torch/fusionnet_main.py',
                 'rcfd_tpu_torch/train_fusionnet.py',
                 'rcfd_tpu_torch/data/loader.py',
                 'rcfd_tpu_torch/models/losses.py',
                 'rcfd_tpu_torch/utils/summary.py',
                 'rcfd_tpu_torch/utils/profiling.py',
                 'rcfd_tpu_torch/geometry/__init__.py',
                 'rcfd_tpu_torch/geometry/transforms.py',
                 'rcfd_tpu_torch/geometry/rasterize.py',
                 'rcfd_tpu_torch/geometry/reproject.py',
                 'rcfd_tpu_torch/geometry/nuscenes_adapter.py',
                 'rcfd_tpu_torch/setup/setup_dataset_nuscenes.py',
                 'rcfd_tpu_torch/setup/setup_dataset_nuscenes_test.py',
                 'rcfd_tpu_torch/setup/setup_dataset_nuscenes_with_denseGT.py',
                 'rcfd_tpu_torch/setup/make_data_split.py',
                 'rcfd_tpu_torch/setup/data_gen.py',
                 'rcfd_tpu_torch/models/legacy_v0.py',
                 'rcfd_tpu_torch/legacy_main.py',
                 'rcfd_tpu_torch/data/legacy_datasets.py',
                 'rcfd_tpu_torch/train_legacy_v0.py',
                 'rcfd_tpu_torch/save_depth_radar.py',
                 'rcfd_tpu_torch/save_stage_1_depth.py',
                 'rcfd_tpu_torch/eval_stage_1_depth.py',
                 'rcfd_tpu_torch/ops/roi_pool.py',
                 'rcfd_tpu_torch/parallel/__init__.py',
                 'rcfd_tpu_torch/parallel/mesh.py',
                 'rcfd_tpu_torch/tools/fixtures.py',
                 'rcfd_tpu_torch/tools/convert_checkpoint.py',
                 'rcfd_tpu_torch/tools/bridgebench.py',
                 'rcfd_tpu_torch/tools/parity_protocol.py',
                 'rcfd_tpu_torch/tools/tools_exp.py',
                 'rcfd_tpu_torch/tools/timing.py',
                 'rcfd_tpu_torch/tools/serving_config.py',
                 'rcfd_tpu_torch/tools/roofline.py',
                 'rcfd_tpu_torch/tools/trainbench.py',
                 'rcfd_tpu_torch/tools/stagebench.py',
                 'rcfd_tpu_torch/tools/rnstagebench.py',
                 'rcfd_tpu_torch/tools/fnbisect.py',
                 'rcfd_tpu_torch/tools/pipebisect.py',
                 'rcfd_tpu_torch/tools/microbench.py',
                 'rcfd_tpu_torch/tools/fusedskip_bench.py',
                 'rcfd_tpu_torch/tools/fusepool_experiment.py',
                 'rcfd_tpu_torch/tools/bench_tools_exp.py'):
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


# the root bench.py and the tests' helpers: the port keeps its own copies
# (tools/serving_config.py, tools/fixtures.py)
ROOT_BENCH_OR_TESTS_IMPORT = re.compile(
    r'^\s*(?:import|from)\s+(?:bench\b|tests\b|fixtures\b|torch_parity\b|'
    r'conftest\b)', re.M)


@pytest.mark.parametrize('path', sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_bench_or_tests_module(path):
    """No port source imports the root bench.py or a module of tests/
    (the JAX tools import both)."""
    with open(path) as f:
        text = f.read()
    assert not ROOT_BENCH_OR_TESTS_IMPORT.findall(text), path


TOOL_MAINS = ('convert_checkpoint', 'bridgebench', 'parity_protocol',
              'roofline', 'trainbench', 'stagebench', 'rnstagebench',
              'fnbisect', 'pipebisect', 'microbench', 'fusedskip_bench',
              'fusepool_experiment')


@pytest.mark.parametrize('name', TOOL_MAINS)
def test_tool_main_runs_on_the_card_by_default(name):
    """Each counterpart of a JAX tool has ``main(argv=None,
    device=None)``, and None is the card: without one it raises and asks
    for device='cpu' rather than run on the CPU."""
    import importlib
    import inspect
    tool = importlib.import_module('rcfd_tpu_torch.tools.' + name)
    params = inspect.signature(tool.main).parameters
    assert list(params)[:2] == ['argv', 'device']
    assert params['argv'].default is None and params['device'].default is None
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    from rcfd_tpu_torch import default_device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device(params['device'].default)


ROOT_SETUP_IMPORT = re.compile(
    r'^\s*(?:import|from)\s+(?:setup\b|setup_dataset_nuscenes|data_gen\b|'
    r'make_data_split\b|gen_panoptic_seg\b)', re.M)


@pytest.mark.parametrize('path', sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_root_setup_script(path):
    """The port's stage-0 and bridge scripts keep their own copies of what
    they take from the root setup/ scripts: no port source imports one of
    them, nor puts setup/ on the module path."""
    with open(path) as f:
        text = f.read()
    assert not ROOT_SETUP_IMPORT.findall(text), path
    assert 'sys.path.insert' not in text or path.endswith('chip_smoke.py'), \
        path


def test_import_and_build_pipeline_without_jax():
    """A fresh interpreter imports every module of the port, builds the
    pipeline on the CPU, serves a batch and a bf16 request, restores a
    pipeline from .pth files and writes and reads PNGs; no JAX, rcfd_tpu,
    Pillow or torchvision module is loaded."""
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
# the batched path, bf16 serving and the checkpoint restore load nothing
# forbidden either
import os, tempfile, numpy as np, torch
pipe = TwoStagePipeline(rn, fn, 64, 96, device='cpu')
points = np.zeros((2, 4, 3), np.float32)
points[..., 0], points[..., 2] = 40, 9
pipe.forward_batched(np.zeros((2, 64, 96, 3), np.uint8), points,
                     np.ones((2, 4), bool))
dense, _, _ = TwoStagePipeline(rn, fn, 64, 96, compute_dtype=torch.bfloat16,
                               device='cpu')(
    np.zeros((1, 64, 96, 3), np.uint8), points[0], np.ones(4, bool))
assert dense.dtype == torch.float32 and dense.shape == (64, 96)
paths = []
for model, keys in ((rn, ('radarnet_encoder_state_dict',
                          'radarnet_decoder_state_dict')),
                    (fn, ('encoder_state_dict', 'decoder_state_dict'))):
    paths.append(os.path.join(tempfile.mkdtemp(), 'model.pth'))
    torch.save({key: getattr(model, part).state_dict() for key, part in
                zip(keys, ('encoder', 'decoder'))}, paths[-1])
TwoStagePipeline.from_checkpoints(
    *paths, image_height=64, image_width=96, patch_size=(32, 32),
    radarnet_kwargs=dict(n_filters_encoder_image=[4, 8, 8, 8, 8],
                         n_neurons_encoder_depth=[4, 8, 8, 8, 8],
                         n_filters_decoder=[8, 8, 8, 8, 8]),
    fusionnet_kwargs=dict(n_filters_encoder_image=[4, 8, 8, 8, 8, 8],
                          n_filters_encoder_depth=[4, 4, 8, 8, 8, 8],
                          n_filters_decoder=[8, 8, 8, 8, 8, 8]),
    device='cpu')
# the codec writes and reads PNGs without Pillow
from rcfd_tpu_torch.data import io
d = tempfile.mkdtemp()
io.save_depth(np.full((4, 6), 7.5, np.float32), os.path.join(d, 'd.png'))
assert (io.load_depth(os.path.join(d, 'd.png')) == 7.5).all()
io.save_image(np.ones((4, 6, 3)), os.path.join(d, 'i.png'))
assert (io.load_image_u8(os.path.join(d, 'i.png')) == 255).all()
# stage 0's geometry, its densification and serving from raw radar
from rcfd_tpu_torch import geometry
from rcfd_tpu_torch.geometry import reproject
k = np.array([[50.0, 0, 48], [0, 50.0, 32], [0, 0, 1]], np.float32)
m = geometry.pose_matrix([1.0, 0, 0, 0], [0.1, 0, 0.5]).numpy()
dm = np.zeros((64, 96), np.float32)
dm[20:40:3, 30:70:4] = 12.0
merged = reproject.merge_neighbor_into_main(dm, dm, k, m, k, device='cpu')
assert (merged > 0).sum() > (dm > 0).sum()
assert (io.interpolate_depth(dm, (dm > 0).astype(np.float32)) > 0).sum() > 500
raw = np.array([[0.5, 0.2, 9.0], [-0.4, 0.1, 20.0]], np.float32)
dense, _, _ = pipe.from_raw_radar(np.zeros((1, 64, 96, 3), np.uint8), raw,
                                  np.ones(2, bool), np.eye(4), k)
assert dense.shape == (64, 96)
# the legacy v0 forward, its registration and an 8-bit label PNG, and the
# general ROI pool
from rcfd_tpu_torch import legacy_main
from rcfd_tpu_torch.data.transforms import Transforms
from rcfd_tpu_torch.models import legacy_v0
from rcfd_tpu_torch.ops import roi_pool
v0 = legacy_main.build_model((64, 32))
fwd = legacy_main.make_forward_fn(v0, Transforms(normalized_image_range=[0, 1]),
                                  64, 96, (64, 32))
depth, _ = fwd(torch.zeros((1, 64, 96, 3), dtype=torch.uint8),
               torch.tensor([[40.0, 10, 9]]), torch.ones(1, dtype=torch.bool))
assert depth.shape == (64, 96)
assert len(legacy_v0.register_points_radius([1.0, 2.0], [5.0, 6.0], [1.1],
                                            [5.0])[0]) == 1
from rcfd_tpu_torch import native
native.write_u8(os.path.join(d, 'l.png'), np.full((4, 6), 2, np.uint8))
assert roi_pool.roi_pool(torch.ones(1, 2, 8, 8), torch.tensor(
    [[[0.0, 0, 7, 7]]]), 1.0, (2, 2)).shape == (1, 2, 2, 2)
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
