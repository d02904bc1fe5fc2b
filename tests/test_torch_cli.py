"""The port's serving CLI (python -m rcfd_tpu_torch.run_pipeline) against
the JAX package's run_pipeline.py on the CPU: the same fixture, weights and
flags, the same file names, the same 16-bit values within one codec count,
the same metrics.

Both CLIs run at their defaults, with no RCFD_* variable set: the exact
float max scatter. The JAX CLI runs once, in process.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
from PIL import Image  # noqa: E402

from rcfd_tpu.models import FusionNetModel as JaxFusionNet  # noqa: E402
from rcfd_tpu.models import RadarNetModel as JaxRadarNet  # noqa: E402

from rcfd_tpu_torch import run_pipeline as port_cli  # noqa: E402
from rcfd_tpu_torch.data import io as port_io  # noqa: E402
from rcfd_tpu_torch.nn.perf import PerfConfig  # noqa: E402
from rcfd_tpu_torch.pipeline import TwoStagePipeline  # noqa: E402

from fixtures import make_radarnet_fixture  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N_FRAMES = 64, 96, 3
Q = 2.0 ** 14
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
NET_ARGS = [
    '--patch_size', '64', '32',
    '--radarnet_encoder_type', 'radarnetv1', 'batch_norm',
    '--radarnet_n_filters_encoder_image', '8', '12', '16', '16', '16',
    '--radarnet_n_neurons_encoder_depth', '8', '12', '16', '16', '16',
    '--radarnet_n_filters_decoder', '16', '12', '8', '8', '8',
    '--fusionnet_encoder_type', 'fusionnet18', 'batch_norm',
    '--fusionnet_n_filters_encoder_image', '8', '12', '16', '16', '16',
    '--fusionnet_n_filters_encoder_depth', '4', '6', '8', '8', '8',
    '--fusion_type', 'weight_and_project',
    '--fusionnet_n_filters_decoder', '16', '12', '8', '8', '8']
# RadarNet crops of the port against the JAX package's (folded, float32):
# what a differing quasi pixel may be explained by
CROP_TOL = 1e-4


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The JAX CLI and the port's CLI on one fixture: with ground truth
    (float writers, the eval table), and without (the codec_encode
    writers) under --keep_input_filenames; --batch_size 2 over 3 frames,
    so forward_batched and __call__ both serve."""
    root = tmp_path_factory.mktemp('cli')
    manifests = make_radarnet_fixture(str(root / 'data'), n_samples=N_FRAMES,
                                      height=H, width=W)
    rn = JaxRadarNet(**RADARNET)
    rn_ckpt = str(root / 'radarnet-1.npz')
    rn.save_checkpoint(rn_ckpt, *rn.init(jax.random.PRNGKey(0)), step=1)
    fn = JaxFusionNet(**FUSIONNET)
    fn_ckpt = str(root / 'fusionnet-1.npz')
    fn.save_checkpoint(fn_ckpt, *fn.init(jax.random.PRNGKey(1)), step=1)
    common = ['--radarnet_restore_path', rn_ckpt,
              '--fusionnet_restore_path', fn_ckpt,
              '--image_path', manifests['image'],
              '--radar_path', manifests['radar'], *NET_ARGS,
              '--save_outputs', '--batch_size', '2']
    gt = ['--ground_truth_path', manifests['ground_truth']]
    out = {name: str(root / name) for name in ('jax', 'port', 'codec')}

    sys.path.insert(0, REPO)
    import run_pipeline as jax_cli
    with pytest.MonkeyPatch.context() as mp:
        for name in ('RCFD_PALLAS_SCATTER', 'RCFD_FUSED_POOL2',
                     'RCFD_FUSED_POOL4', 'RCFD_DECODE_CHUNKS'):
            mp.delenv(name, raising=False)
        mp.setattr(sys, 'argv', ['run_pipeline.py', *common, *gt,
                                 '--output_dirpath', out['jax']])
        jax_cli.main()
        summary = port_cli.main(
            common + gt + ['--output_dirpath', out['port']], device='cpu')
        codec = port_cli.main(common + ['--output_dirpath', out['codec'],
                                        '--keep_input_filenames'],
                              device='cpu')
    return dict(out=out, manifests=manifests, common=common,
                checkpoints=(rn_ckpt, fn_ckpt), summary=summary,
                codec=codec)


def _codes(run_dir, stream, name):
    return np.asarray(Image.open(os.path.join(run_dir, stream, name)),
                      np.int64)


def _port_crops(checkpoints, image, points):
    """RadarNet crops and padded x of one frame, from the port's pipeline
    built as the CLI builds it."""
    pipe = TwoStagePipeline.from_checkpoints(
        *checkpoints, image_height=H, image_width=W, patch_size=(64, 32),
        radarnet_kwargs={k: RADARNET[k] for k in (
            'n_filters_encoder_image', 'n_neurons_encoder_depth',
            'n_filters_decoder')},
        fusionnet_kwargs={k: FUSIONNET[k] for k in (
            'n_filters_encoder_image', 'n_filters_encoder_depth',
            'n_filters_decoder')},
        optimize=True, device='cpu')
    with torch.inference_mode():
        _, crops, xs, _ = pipe.radarnet_stage(image[None], points)
    return crops.numpy().astype(np.float64), xs.numpy()


def _unexplained(crops, xs, valid, pixels):
    """Pixels (row, col) whose quasi depth a change of the crops by
    CROP_TOL cannot change: the top response there is farther than
    CROP_TOL from the 0.5 threshold and the top two are farther apart than
    2 CROP_TOL (so the exact max keeps its winner)."""
    k, ph, pw = crops.shape
    # crop column j of point p lands on column x_p - 2 (pw // 2) + j, x_p
    # its padded x (rcfd_tpu/ops/scatter_pallas.py)
    x_start = xs.astype(np.int64) - 2 * (pw // 2)
    out = []
    for r, c in pixels:
        j = c - x_start
        hit = np.flatnonzero(valid & (j >= 0) & (j < pw))
        vals = np.sort(crops[hit, r - (H - ph), j[hit]])[::-1]
        near = len(vals) and abs(vals[0] - 0.5) <= CROP_TOL
        tie = len(vals) > 1 and vals[0] - vals[1] <= 2 * CROP_TOL
        if not (near or tie):
            out.append((int(r), int(c)))
    return out


# dense codes of the port's CLI against the JAX CLI's on a frame whose quasi
# depth differs at a crop tie (measured on this fixture: 4 at frame 0, where
# two quasi pixels differ at a 6e-8 tie)
DENSE_TIE_CODES = 4


def _jax_fusionnet_codes(checkpoints, image_path, quasi_codes,
                         response_codes):
    """Dense codes of the JAX package's FusionNet, built and folded as the
    JAX CLI builds it, on one frame and the given quasi depth and response
    codes (the bridge's maps are exactly these codes over 256 and 2^14)."""
    import jax.numpy as jnp
    from rcfd_tpu import pipeline as jax_pipeline
    from rcfd_tpu.data import transport

    pipe = jax_pipeline.TwoStagePipeline.from_checkpoints(
        *checkpoints, image_height=H, image_width=W, patch_size=(64, 32),
        radarnet_kwargs={k: RADARNET[k] for k in (
            'n_filters_encoder_image', 'n_neurons_encoder_depth',
            'n_filters_decoder')},
        fusionnet_kwargs={k: FUSIONNET[k] for k in (
            'n_filters_encoder_image', 'n_filters_encoder_depth',
            'n_filters_decoder')},
        optimize=True)
    image = np.asarray(port_io.load_image_u8(image_path, device='cpu'))
    (image_t,) = pipe.transforms.transform(
        jax.random.PRNGKey(0), [transport.decode(jnp.asarray(image)[None])],
        random_transform_probability=0.0)
    input_depth = jnp.stack(
        [jnp.asarray(quasi_codes / 256.0, jnp.float32),
         jnp.asarray(response_codes / Q, jnp.float32) *
         jax_pipeline.RESPONSE_DECODE_SCALE], -1)[None]
    dense, _ = pipe.fusionnet.apply(pipe.fusionnet_params,
                                    pipe.fusionnet_state, image_t,
                                    input_depth, training=False)
    return np.uint32(np.asarray(dense[0, :, :, 0]) * 256.0).astype(np.int64)


def test_port_cli_writes_the_jax_cli_files(runs):
    """Both CLIs at their defaults (the exact float max): same names in the
    three streams; response within one codec count everywhere (a crop
    within CROP_TOL of a 2^-14 step edge); quasi depth equal except at
    pixels where the top two crops lie within 2 CROP_TOL or the top one
    within CROP_TOL of the threshold, so that the two packages' float32
    crops may pick another winner. Dense is bounded on every frame: within
    one codec count of the JAX CLI's where the quasi depth is equal; where
    it is not, within one count of the JAX FusionNet served the port's own
    quasi depth and response (FusionNet is held to the same input), and
    within DENSE_TIE_CODES of the JAX CLI's (FusionNet spreads a changed
    quasi pixel over its whole receptive field, which covers this frame)."""
    jax_dir, port_dir = runs['out']['jax'], runs['out']['port']
    names = ['{:010d}.png'.format(i) for i in range(N_FRAMES)]
    for stream in port_cli.STREAMS:
        assert sorted(os.listdir(os.path.join(jax_dir, stream))) == names
        assert sorted(os.listdir(os.path.join(port_dir, stream))) == names
    images = port_io.read_paths(runs['manifests']['image'])
    radars = port_io.read_paths(runs['manifests']['radar'])
    covered = 0
    for i, name in enumerate(names):
        dense, quasi, response = (
            np.abs(_codes(port_dir, s, name) - _codes(jax_dir, s, name))
            for s in port_cli.STREAMS)
        assert response.max() <= 1, (name, response.max())
        covered += int((_codes(port_dir, 'output_response_radar', name)
                        > 0).sum())
        differ = np.argwhere(quasi > 0)
        if len(differ):
            points = np.load(radars[i]).astype(np.float32)
            k = len(points)
            crops, xs = _port_crops(
                runs['checkpoints'],
                port_io.load_image_u8(images[i], device='cpu'), points)
            assert not _unexplained(crops, xs, np.ones(k, bool), differ)
            assert dense.max() <= DENSE_TIE_CODES, (name, dense.max())
            held = np.abs(_codes(port_dir, 'output_depth_fusion', name) -
                          _jax_fusionnet_codes(
                              runs['checkpoints'], images[i],
                              _codes(port_dir, 'output_depth_radar', name),
                              _codes(port_dir, 'output_response_radar',
                                     name)))
            assert held.max() <= 1, (name, held.max())
        else:
            assert dense.max() <= 1, (name, dense.max())
        print('{}: codes that differ from the JAX CLI\'s: dense {} (at most '
              '{}), quasi {}, response {}'.format(
                  name, int((dense > 0).sum()), int(dense.max()),
                  len(differ), int((response > 0).sum())))
    print('covered response pixels: {}'.format(covered))
    assert covered > 100


def _results(path):
    with open(os.path.join(path, 'results.txt')) as f:
        lines = f.read().splitlines()
    assert lines[:2] == ['Two-stage pipeline evaluation:',
                         '{:>8}  {:>8}  {:>8}  {:>8}'.format(
                             'MAE', 'RMSE', 'iMAE', 'iRMSE')]
    return np.array([float(v) for v in lines[2].split()])


def test_port_cli_metrics_match_the_jax_cli(runs):
    port = _results(runs['out']['port'])
    ref = _results(runs['out']['jax'])
    assert np.all(np.isfinite(port)) and port[0] > 0
    np.testing.assert_allclose(port, ref, rtol=1e-3, atol=0)
    summary = runs['summary']
    assert summary['frames'] == N_FRAMES
    np.testing.assert_allclose(
        [summary['metrics'][k] for k in port_cli.METRICS], port, atol=5e-4)


def test_codec_writers_give_the_float_writers_files(runs):
    """Without ground truth the CLI serves codec_encode=True and writes the
    uint16 codes; the files equal the float writers' bit for bit, and
    --keep_input_filenames names them after the input frames."""
    images = port_io.read_paths(runs['manifests']['image'])
    for i, image in enumerate(images):
        name = os.path.splitext(os.path.basename(image))[0] + '.png'
        for stream in port_cli.STREAMS:
            with open(os.path.join(runs['out']['codec'], stream, name),
                      'rb') as f:
                codec = f.read()
            with open(os.path.join(runs['out']['port'], stream,
                                   '{:010d}.png'.format(i)), 'rb') as f:
                assert f.read() == codec, (stream, name)
    assert runs['codec']['metrics'] is None
    assert not os.path.exists(os.path.join(runs['out']['codec'],
                                           'results.txt'))


def test_data_parallel_is_refused(runs, tmp_path):
    """--data_parallel with a batch size (2) that the device count (3) does
    not divide exits, as the JAX CLI does, before anything is written."""
    with pytest.raises(SystemExit, match='divisible by the device count'):
        port_cli.main(runs['common'] + ['--output_dirpath', str(tmp_path),
                                        '--data_parallel'], device='cpu',
                      devices=['cpu'] * 3)
    assert not os.listdir(tmp_path)


def test_main_needs_a_card_unless_asked_for_cpu(runs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(runs['common'] + ['--output_dirpath', str(tmp_path)])


@pytest.mark.parametrize('environ,perf', [
    ({}, PerfConfig()),
    ({'RCFD_FUSED_POOL2': '1', 'RCFD_FUSED_POOL4': 'on',
      'RCFD_DECODE_CHUNKS': '2'},
     PerfConfig(fused_pool2=True, fused_pool4=True, decode_chunks=2)),
    ({'RCFD_FUSED_POOL2': 'no', 'RCFD_FUSED_POOL4': '',
      'RCFD_PALLAS_SCATTER': 'yes'}, PerfConfig(pallas_scatter=True)),
    # the exact route, as the JAX CLI serves it
    ({'RCFD_PALLAS_SCATTER': '0'}, PerfConfig(pallas_scatter=False)),
])
def test_perf_from_env_reads_the_jax_gates(environ, perf):
    assert port_cli.perf_from_env(environ) == perf


@pytest.mark.parametrize('environ,error', [
    ({'RCFD_FUSED_POOL2': 'maybe'}, ValueError),
    ({'RCFD_PALLAS_SCATTER': '2'}, ValueError),
])
def test_perf_from_env_refuses(environ, error):
    with pytest.raises(error):
        port_cli.perf_from_env(environ)


@pytest.mark.parametrize('value,k1', [('0', False), ('1', True)])
def test_cli_serves_the_scatter_route_of_pallas_scatter(runs, tmp_path,
                                                        monkeypatch, value,
                                                        k1):
    """RCFD_PALLAS_SCATTER=0 serves the exact max (the default's files, byte
    for byte); =1 serves the scatter kernel's route, whose plain version
    runs once a request on the CPU."""
    from rcfd_tpu_torch.ops import scatter_cuda

    calls = []
    plain = scatter_cuda.scatter_quasi_dense_batched_plain
    monkeypatch.setattr(scatter_cuda, 'scatter_quasi_dense_batched_plain',
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    monkeypatch.setenv('RCFD_PALLAS_SCATTER', value)
    port_cli.main(runs['common'] + ['--output_dirpath', str(tmp_path),
                                    '--keep_input_filenames'], device='cpu')
    assert len(calls) == (2 if k1 else 0)  # 3 frames, 2 a request
    if not k1:
        for stream in port_cli.STREAMS:
            for name in os.listdir(os.path.join(runs['out']['codec'],
                                                stream)):
                with open(os.path.join(str(tmp_path), stream, name),
                          'rb') as f, open(os.path.join(
                              runs['out']['codec'], stream, name), 'rb') as g:
                    assert f.read() == g.read(), (stream, name)


def test_cli_serves_the_fused_gates(runs, tmp_path, monkeypatch):
    """RCFD_FUSED_POOL2/4 reach RadarNet: the deferred pools change the
    float order of the skip sums only, so the files stay within one codec
    count of the run without them, and the gather-add's plain version ran
    twice a frame."""
    from rcfd_tpu_torch.ops import fused_skip

    calls = []
    plain = fused_skip.fused_skip_gather_add_plain
    monkeypatch.setattr(fused_skip, 'fused_skip_gather_add_plain',
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    monkeypatch.setenv('RCFD_FUSED_POOL2', '1')
    monkeypatch.setenv('RCFD_FUSED_POOL4', '1')
    port_cli.main(runs['common'] + ['--output_dirpath', str(tmp_path),
                                    '--batch_size', '1'], device='cpu')
    assert len(calls) == 2 * N_FRAMES
    name = '{:010d}.png'.format(0)
    resp = np.abs(_codes(str(tmp_path), 'output_response_radar', name) -
                  _codes(runs['out']['codec'], 'output_response_radar',
                         '0000.png'))
    assert resp.max() <= 1
