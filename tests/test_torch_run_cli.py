"""The port's standalone run drivers (python -m rcfd_tpu_torch.run_radarnet
and run_fusionnet) against the JAX package's run_radarnet.py and
run_fusionnet.py on the CPU: the same tiny files, checkpoints and flags.
Each JAX CLI runs in process, once in float32 and once under
RCFD_COMPUTE_DTYPE=bfloat16, for the whole module. Both scatter by the
exact float max here (the JAX package's off the TPU, the port's on the
CPU). Each test states its tolerance."""

import os
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
from PIL import Image  # noqa: E402

from rcfd_tpu.models import FusionNetModel as JaxFusionNet  # noqa: E402
from rcfd_tpu.models import RadarNetModel as JaxRadarNet  # noqa: E402
from rcfd_tpu.nn.core import cast_tree  # noqa: E402
from rcfd_tpu.nn.optimize import fold_batch_norm as jax_fold  # noqa: E402

from rcfd_tpu_torch import fusionnet_main, radarnet_main  # noqa: E402
from rcfd_tpu_torch import run_fusionnet, run_radarnet  # noqa: E402
from rcfd_tpu_torch.data import io as port_io  # noqa: E402
from rcfd_tpu_torch.data.transforms import Transforms  # noqa: E402
from rcfd_tpu_torch.nn.perf import compute_dtype_from_env  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa

from fixtures import make_fusionnet_fixture  # noqa: E402
from fixtures import make_radarnet_fixture  # noqa: E402
from torch_parity import randomize_batch_norm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N_FRAMES = 64, 96, 3
RADARNET = dict(
    input_channels_image=3, input_channels_depth=3,
    input_patch_size_image=(64, 32), encoder_type='radarnetv1_batch_norm',
    n_filters_encoder_image=[8, 12, 16, 16, 16],
    n_neurons_encoder_depth=[8, 12, 16, 16, 16],
    decoder_type='multiscale_batch_norm', n_filters_decoder=[16, 12, 8, 8, 8])
FUSIONNET = dict(
    input_channels_image=3, input_channels_depth=2,
    encoder_type='fusionnet18_batch_norm',
    n_filters_encoder_image=[8, 12, 16, 16, 16],
    n_filters_encoder_depth=[4, 6, 8, 8, 8],
    fusion_type='weight_and_project', decoder_type='multiscale_batch_norm',
    n_resolution_decoder=1, n_filters_decoder=[16, 12, 8, 8, 8],
    min_predict_depth=1.0, max_predict_depth=100.0)
RN_NET = ['--patch_size', '64', '32',
          '--n_filters_encoder_image', '8', '12', '16', '16', '16',
          '--n_neurons_encoder_depth', '8', '12', '16', '16', '16',
          '--n_filters_decoder', '16', '12', '8', '8', '8']
FN_NET = ['--n_filters_encoder_image', '8', '12', '16', '16', '16',
          '--n_filters_encoder_depth', '4', '6', '8', '8', '8',
          '--fusion_type', 'weight_and_project',
          '--n_filters_decoder', '16', '12', '8', '8', '8',
          '--min_predict_depth', '1', '--max_predict_depth', '100']
GATES = ('RCFD_PALLAS_SCATTER', 'RCFD_FUSED_POOL2', 'RCFD_FUSED_POOL4',
         'RCFD_DECODE_CHUNKS', 'RCFD_COMPUTE_DTYPE')
# bf16 runs of the two packages: the metrics' relative distance. bf16 moves
# a crop value by up to 2^-8 of itself, so a pixel near the 0.5 threshold
# or a tie of two crops may change its quasi depth between the packages,
# and FusionNet's output by a few bf16 steps (measured on this fixture:
# 2.2e-2 RadarNet's iMAE, 7.8e-4 FusionNet's)
BF16_METRICS_RTOL = 2 ** -5


def _save_checkpoint(model, seed, path):
    params, state = model.init(jax.random.PRNGKey(seed))
    params, state = randomize_batch_norm(
        *jax.device_get((params, state)), np.random.default_rng(seed))
    model.save_checkpoint(path, params, state, step=7)
    return params, state


def _run_jax_cli(script, argv, monkeypatch, env=None):
    """The JAX package's CLI script as a user runs it, in this process."""
    for name in GATES:
        monkeypatch.delenv(name, raising=False)
    for name, value in (env or {}).items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(sys, 'argv', [script] + argv)
    runpy.run_path(os.path.join(REPO, script), run_name='__main__')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Each package's two CLIs on one fixture: with ground truth in float32
    (with --save_outputs: the float writers) and in bf16; the port's also
    without ground truth (the codec writers, --keep_input_filenames) and
    with --eval_batch_size 2 in float32 (3 frames: a padded tail)."""
    root = tmp_path_factory.mktemp('run')
    rn_files = make_radarnet_fixture(str(root / 'rn'), n_samples=N_FRAMES,
                                     height=H, width=W)
    fn_files = make_fusionnet_fixture(str(root / 'fn'), n_samples=N_FRAMES,
                                      height=H, width=W)
    rn_ckpt, fn_ckpt = str(root / 'radarnet-7.pth'), str(root /
                                                         'fusionnet-7.pth')
    variables = dict(
        radarnet=_save_checkpoint(JaxRadarNet(**RADARNET), 0, rn_ckpt),
        fusionnet=_save_checkpoint(JaxFusionNet(**FUSIONNET), 1, fn_ckpt))
    rn_common = ['--restore_path', rn_ckpt, '--image_path',
                 rn_files['image'], '--radar_path', rn_files['radar'],
                 *RN_NET]
    fn_common = ['--restore_path', fn_ckpt, '--image_path',
                 fn_files['image'], '--depth_path', fn_files['depth'],
                 '--response_path', fn_files['response'], *FN_NET]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for model, script, common, files, port_cli in (
                ('radarnet', 'run_radarnet.py', rn_common, rn_files,
                 run_radarnet),
                ('fusionnet', 'run_fusionnet.py', fn_common, fn_files,
                 run_fusionnet)):
            gt = ['--ground_truth_path', files['ground_truth']]
            d = {k: str(root / model / k) for k in (
                'jax', 'jax_bf16', 'port', 'port_bf16', 'codec')}
            _run_jax_cli(script, common + gt + [
                '--output_dirpath', d['jax'], '--save_outputs'], mp)
            _run_jax_cli(script, common + gt + [
                '--output_dirpath', d['jax_bf16']], mp,
                {'RCFD_COMPUTE_DTYPE': 'bfloat16'})
            for name in GATES:
                mp.delenv(name, raising=False)
            summary = port_cli.main(common + gt + [
                '--output_dirpath', d['port'], '--save_outputs',
                '--eval_batch_size', '2'], device='cpu')
            codec = port_cli.main(common + [
                '--output_dirpath', d['codec'], '--save_outputs',
                '--keep_input_filenames'], device='cpu')
            mp.setenv('RCFD_COMPUTE_DTYPE', 'bfloat16')
            bf16 = port_cli.main(common + gt + [
                '--output_dirpath', d['port_bf16']], device='cpu')
            mp.delenv('RCFD_COMPUTE_DTYPE')
            out[model] = dict(dirs=d, files=files, common=common,
                              summary=summary, codec=codec, bf16=bf16,
                              checkpoint=rn_ckpt if model == 'radarnet'
                              else fn_ckpt, variables=variables[model])
    return out


def _results(path):
    """The lines of results.txt and the numbers of its last one."""
    with open(os.path.join(path, 'results.txt')) as f:
        lines = f.read().splitlines()
    return lines, np.array([float(v) for v in lines[-1].split()])


def _codes(path):
    return np.asarray(Image.open(path), np.int64)


@pytest.mark.parametrize('model', ['radarnet', 'fusionnet'])
def test_results_match_the_jax_cli(runs, model):
    """With ground truth, float32: results.txt has the JAX CLI's lines (the
    step, the header, the input paths for FusionNet) and its metrics
    within rtol 1e-3; the summary returns the same metrics."""
    r = runs[model]
    port_lines, port = _results(r['dirs']['port'])
    ref_lines, ref = _results(r['dirs']['jax'])
    assert port_lines[:-1] == ref_lines[:-1]
    assert np.all(np.isfinite(port)) and port[1] > 0
    np.testing.assert_allclose(port, ref, rtol=1e-3, atol=0)
    metrics = r['summary']['metrics']
    assert r['summary']['frames'] == N_FRAMES
    np.testing.assert_allclose(list(metrics.values()), port[1:5], atol=5e-4)


@pytest.mark.parametrize('model', ['radarnet', 'fusionnet'])
def test_bf16_results_match_the_jax_cli_in_bf16(runs, model):
    """Under RCFD_COMPUTE_DTYPE=bfloat16 (both packages fold the batch norm
    in float32, then cast the model): the metrics within
    BF16_METRICS_RTOL of the JAX CLI's bf16 run's."""
    r = runs[model]
    port_lines, port = _results(r['dirs']['port_bf16'])
    ref_lines, ref = _results(r['dirs']['jax_bf16'])
    assert port_lines[:-1] == ref_lines[:-1]
    assert np.all(np.isfinite(port))
    assert port[0] == ref[0]  # the checkpoint's step
    rel = np.abs(port[1:5] - ref[1:5]) / np.abs(ref[1:5])
    print('{} bf16 metrics: relative distance from the JAX CLI\'s {}'.format(
        model, rel))
    assert rel.max() <= BF16_METRICS_RTOL, (port, ref)


STREAMS = {'radarnet': ('output_depth_radar', 'output_response_radar'),
           'fusionnet': ('output_depth_fusion', 'output_depth_radar',
                         'output_response_radar')}


@pytest.mark.parametrize('model', ['radarnet', 'fusionnet'])
def test_codec_route_writes_the_float_route_files(runs, model):
    """Without ground truth the outputs come to the host as their 16-bit
    codes (codec_encode); the files equal the float writers' of the run
    with ground truth byte for byte, named after the input frames
    (--keep_input_filenames); results.txt holds no metrics."""
    r = runs[model]
    images = port_io.read_paths(r['files']['image'])
    for i, image in enumerate(images):
        name = os.path.splitext(os.path.basename(image))[0] + '.png'
        for stream in STREAMS[model] + ('image',):
            with open(os.path.join(r['dirs']['codec'], stream, name),
                      'rb') as f, open(os.path.join(
                          r['dirs']['port'], stream, '{:010d}.png'.format(i)),
                          'rb') as g:
                assert f.read() == g.read(), (stream, name)
    assert r['codec']['metrics'] is None
    results = os.path.join(r['dirs']['codec'], 'results.txt')
    if os.path.exists(results):  # FusionNet's input paths, as the JAX CLI's
        with open(results) as f:
            assert 'Evaluation results:' not in f.read()


@pytest.mark.parametrize('model', ['radarnet', 'fusionnet'])
def test_files_match_the_jax_cli(runs, model):
    """The float route's files against the JAX CLI's, frame by frame: the
    same names in every directory; the images and ground truths equal; the
    responses and FusionNet's output within one codec step; the quasi
    depth equal on all but a few pixels (the exact max may pick another
    point where two crops lie within float32 rounding of each other or of
    the threshold: at most 2 of a frame's 6144 pixels, none measured)."""
    r = runs[model]
    names = ['{:010d}.png'.format(i) for i in range(N_FRAMES)]
    for stream in ('image', 'ground_truth') + STREAMS[model]:
        assert sorted(os.listdir(os.path.join(r['dirs']['jax'],
                                              stream))) == names
        assert sorted(os.listdir(os.path.join(r['dirs']['port'],
                                              stream))) == names
    covered = 0
    for name in names:
        for stream in ('image', 'ground_truth') + STREAMS[model]:
            port = _codes(os.path.join(r['dirs']['port'], stream, name))
            ref = _codes(os.path.join(r['dirs']['jax'], stream, name))
            diff = np.abs(port - ref)
            if stream == 'output_depth_radar' and model == 'radarnet':
                assert int((diff > 0).sum()) <= 2, (name, stream)
                covered += int((port > 0).sum())
            elif stream in ('image', 'ground_truth') or \
                    model == 'fusionnet' and stream != 'output_depth_fusion':
                assert diff.max() == 0, (name, stream)
            else:
                assert diff.max() <= 1, (name, stream, diff.max())
    if model == 'radarnet':
        assert covered > 100


def test_bf16_model_is_the_jax_fold_then_cast():
    """RCFD_COMPUTE_DTYPE=bfloat16: the port's run model (load_model) is the
    JAX package's fold_batch_norm then cast_tree to bf16, every tensor
    bit for bit."""
    params, state = JaxRadarNet(**RADARNET).init(jax.random.PRNGKey(3))
    params, state = randomize_batch_norm(*jax.device_get((params, state)),
                                         np.random.default_rng(3))
    # state_dict_from_jax takes float32 trees: bf16 values are exactly
    # float32 ones
    ref = state_dict_from_jax(*jax.device_get(cast_tree(cast_tree(
        jax_fold(params, state), jax.numpy.bfloat16), jax.numpy.float32)))
    ref = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
           for k, v in ref.items()}
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'rn.pth')
        JaxRadarNet(**RADARNET).save_checkpoint(path, params, state, step=1)
        kw = {k: v for k, v in RADARNET.items()
              if k != 'input_patch_size_image'}
        model, step = radarnet_main.load_model(
            path, (64, 32), weight_initializer='kaiming_uniform',
            activation_func='leaky_relu', device='cpu',
            compute_dtype=torch.bfloat16, **kw)
    assert step == 1
    got = model.state_dict()
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        assert v.dtype == ref[k].dtype and torch.equal(v, ref[k]), k


def test_codec_forward_returns_the_float_forward_codes(runs):
    """make_forward_fn_batched(codec_encode=True) and
    fusionnet_main.make_forward_fn(codec_encode=True) return uint16
    floor(x * 256) / floor(x * 2^14) of the float forwards' maps."""
    r = runs['radarnet']
    kw = {k: v for k, v in RADARNET.items() if k != 'input_patch_size_image'}
    rn, _ = radarnet_main.load_model(
        r['checkpoint'], (64, 32), weight_initializer='kaiming_uniform',
        activation_func='leaky_relu', device='cpu', **kw)
    ds = radarnet_main.RadarNetInferenceDataset(
        port_io.read_paths(r['files']['image']),
        port_io.read_paths(r['files']['radar']), max_points=None,
        device='cpu')
    batch = [torch.from_numpy(a[None]) for a in ds.get(0)[:3]]
    outs = [radarnet_main.make_forward_fn_batched(
        rn, Transforms([0, 1]), H, W, codec_encode=c)(*batch)
        for c in (False, True)]
    depth, response = outs[0]
    codes = outs[1]
    assert all(c.dtype == torch.uint16 for c in codes)
    assert torch.equal(codes[0], (depth * 256.0).to(torch.uint16))
    assert torch.equal(codes[1], (response * 2.0 ** 14).to(torch.uint16))
    assert int((codes[0].int() > 0).sum()) > 10

    f = runs['fusionnet']
    kw = {k: v for k, v in FUSIONNET.items() if k != 'n_resolution_decoder'}
    fn, _ = fusionnet_main.load_model(
        f['checkpoint'], n_resolutions_decoder=1,
        weight_initializer='kaiming_uniform', activation_func='leaky_relu',
        device='cpu', **kw)
    ds = fusionnet_main.FusionNetInferenceDataset(
        *[port_io.read_paths(f['files'][k]) for k in ('image', 'depth',
                                                       'response')],
        device='cpu')
    batch = [torch.from_numpy(a[None]) for a in ds.get(0)]
    dense, code = (fusionnet_main.make_forward_fn(
        fn, Transforms([0, 1]), codec_encode=c)(*batch) for c in (False,
                                                                  True))
    assert code.dtype == torch.uint16
    assert torch.equal(code, (dense * 256.0).to(torch.uint16))


def test_run_radarnet_says_which_gates_it_took(runs, tmp_path, monkeypatch,
                                               capsys):
    """One line names the scatter's route and every gate's value; on the
    CPU the scatter is the exact max unless RCFD_PALLAS_SCATTER=1."""
    r = runs['radarnet']
    for name in GATES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv('RCFD_DECODE_CHUNKS', '2')
    run_radarnet.main(r['common'] + ['--output_dirpath', str(tmp_path / 'a')],
                      device='cpu')
    line = [s for s in capsys.readouterr().out.splitlines()
            if s.startswith('Gates:')]
    assert line == ['Gates: scatter the exact float max (RCFD_PALLAS_SCATTER '
                    'unset), RCFD_FUSED_POOL2 0, RCFD_FUSED_POOL4 0, '
                    'RCFD_DECODE_CHUNKS 2, RCFD_COMPUTE_DTYPE float32']


@pytest.mark.parametrize('env,plain,calls', [
    ({'RCFD_PALLAS_SCATTER': '1'},
     ('scatter_cuda', 'scatter_quasi_dense_batched_plain'), 1),
    ({'RCFD_FUSED_POOL2': '1', 'RCFD_FUSED_POOL4': '1'},
     ('fused_skip', 'fused_skip_gather_add_plain'), 2),
    ({}, ('crop_cuda', 'batch_column_crop_plain'), 2),
], ids=['k1', 'k3', 'k2'])
def test_run_radarnet_takes_the_kernels_routes(runs, tmp_path, monkeypatch,
                                               env, plain, calls):
    """The gates reach the model: RCFD_PALLAS_SCATTER=1 takes K1's route
    (its plain version on the CPU), the fused pools K3's (the 1/2 and 1/4
    pools), a 64x40 patch K2's (the 1/16 and 1/32 pools), each once a
    forward, and the 3 frames are one forward (--eval_batch_size 8). The
    files stay within one codec step of the
    default run's where the model is unchanged (K1, K3)."""
    import importlib
    module = importlib.import_module('rcfd_tpu_torch.ops.' + plain[0])
    seen = []
    fn = getattr(module, plain[1])
    monkeypatch.setattr(module, plain[1],
                        lambda *a, **k: seen.append(1) or fn(*a, **k))
    r = runs['radarnet']
    for name in GATES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    argv = r['common'] + ['--output_dirpath', str(tmp_path),
                          '--save_outputs']
    if not env:
        argv += ['--patch_size', '64', '40']
    summary = run_radarnet.main(argv, device='cpu')
    assert len(seen) == calls
    assert len(summary['response_paths']) == N_FRAMES
    if env:
        for path in summary['response_paths']:
            ref = os.path.join(r['dirs']['codec'], 'output_response_radar',
                               '{:04d}.png'.format(
                                   int(os.path.basename(path)[:-4])))
            assert np.abs(_codes(path) - _codes(ref)).max() <= 1


@pytest.mark.parametrize('cli', [run_radarnet, run_fusionnet])
def test_main_needs_a_card_unless_asked_for_cpu(runs, tmp_path, monkeypatch,
                                                cli):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    model = 'radarnet' if cli is run_radarnet else 'fusionnet'
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(runs[model]['common'] + ['--output_dirpath',
                                          str(tmp_path)])


@pytest.mark.parametrize('value,dtype', [
    (None, None), ('', None), ('float32', None),
    ('bfloat16', torch.bfloat16)])
def test_compute_dtype_from_env(value, dtype):
    environ = {} if value is None else {'RCFD_COMPUTE_DTYPE': value}
    assert compute_dtype_from_env(environ) == dtype


def test_compute_dtype_from_env_refuses():
    with pytest.raises(ValueError, match='RCFD_COMPUTE_DTYPE'):
        compute_dtype_from_env({'RCFD_COMPUTE_DTYPE': 'float16'})
