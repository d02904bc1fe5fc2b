"""The port's stage and cut tools on the CPU against the JAX modules they
time: each stage of stagebench (FusionNet's decoder blocks, output0, the
encoder) and of rnstagebench (the column ROI pools, RadarNet's decoder
blocks, the tail against JAX's packed_decoder_tail, the scatter against
JAX's Pallas kernel in interpret mode), each cut of fnbisect and
pipebisect, fusedskip_bench's paths against JAX's split and fused paths
(the plain routes), fusepool_experiment's identity; at reduced sizes with
converted weights. The JAX tools' bodies are closures inside their
main(), so the JAX side calls the JAX modules directly. The tools' mains
run on the CPU at a 64 x 96 frame, and refuse to run without a card
unless asked for the CPU. Each test states its tolerance."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rcfd_tpu.models import FusionNetModel as JaxFusionNet  # noqa: E402
from rcfd_tpu.models import RadarNetModel as JaxRadarNet  # noqa: E402
from rcfd_tpu.nn import layers as jax_layers  # noqa: E402
from rcfd_tpu.nn.optimize import fold_batch_norm as jax_fold  # noqa: E402
from rcfd_tpu.ops.roi_pool import \
    roi_pool_column as jax_roi_pool_column  # noqa: E402
from rcfd_tpu.utils.checkpoint import torch_state_dict_to_tree  # noqa: E402

from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel  # noqa
from rcfd_tpu_torch.nn.layers import (Conv2d, DecoderBlock,  # noqa: E402
                                      init_parameters)
from rcfd_tpu_torch.nn.optimize import fold_batch_norm  # noqa: E402
from rcfd_tpu_torch.pipeline import TwoStagePipeline  # noqa: E402
from rcfd_tpu_torch.tools import (fnbisect, fusedskip_bench,  # noqa: E402
                                  fusepool_experiment, microbench,
                                  pipebisect, rnstagebench, serving_config,
                                  stagebench)
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

from torch_parity import (FUSIONNET_TINY, RADARNET_TINY, nchw,  # noqa: E402
                          nhwc, randomize_batch_norm)

H, W = 64, 96
# float32 on both sides, reassociated sums: relative to each output's
# largest magnitude
RTOL = 1e-5


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_close(got, ref, rtol=RTOL, what=''):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= rtol * scale, what


def _trees(model, seed):
    """The port model's weights as JAX (params, state) trees, batch norm
    drawn from ``seed``, loaded back into the port model."""
    parts = [torch_state_dict_to_tree(getattr(model, p).state_dict())
             for p in ('encoder', 'decoder')]
    params, state = randomize_batch_norm(
        {'encoder': parts[0][0], 'decoder': parts[1][0]},
        {'encoder': parts[0][1], 'decoder': parts[1][1]},
        np.random.default_rng(seed))
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return params, state


def _port(cls, config, seed, **kwargs):
    model = cls(**config, device='cpu', **kwargs)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model


def _block_trees(module):
    """A standalone port block's weights as JAX trees (every submodule's
    state present, as JAX's init makes it)."""
    params, state = torch_state_dict_to_tree(module.state_dict())

    def fill(p, s):
        s = dict(s)
        for k, v in p.items():
            if isinstance(v, dict):
                s[k] = fill(v, s.get(k, {}))
        return s
    return params, fill(params, state)


# ---- stagebench --------------------------------------------------------

def test_stagebench_stages_equal_jax_modules():
    """Each stage at a 64 x 96 frame of a narrow FusionNet, batch norm
    drawn and folded on both sides (each package's fold), float32: the
    port stage's output against the JAX module on the same inputs, within
    1e-5 of the output's largest magnitude."""
    model = _port(FusionNetModel, FUSIONNET_TINY, 0)
    params, state = _trees(model, 1)
    folded = fold_batch_norm(model).eval()
    jp, js = jax_fold(params, state)
    jax_model = JaxFusionNet(**FUSIONNET_TINY)
    shapes = stagebench.stage_shapes(FUSIONNET_TINY, 1, H, W)
    assert list(shapes) == ['deconv5', 'deconv4', 'deconv3', 'deconv2',
                            'deconv1', 'deconv0', 'output0', 'encoder']
    stages = stagebench.make_stages(folded, shapes, H, W, torch.float32,
                                    'cpu', np.random.default_rng(0))
    dec = jax_model.decoder.children
    dp, ds = jp['decoder'], js['decoder']
    with torch.inference_mode():
        for name, (fn, inputs) in stages.items():
            got = fn(*inputs)
            x = [jnp.asarray(nhwc(t)) for t in inputs]
            if name == 'encoder':
                ref = jax_model.encoder(jp['encoder'], js['encoder'], *x)[0]
            elif name == 'output0':
                ref = dec[name](dp[name], ds[name], x[0])[0]
            elif name == 'deconv0':
                ref = dec[name](dp[name], ds[name], x[0], shape=(H, W))[0]
            else:
                ref = dec[name](dp[name], ds[name], x[0], skip=x[1])[0]
            assert_close(nhwc(got), ref, what=name)


def test_stagebench_main_on_cpu(monkeypatch, capsys):
    """The tool's main at a 64 x 96 frame (bench.py's widths), float32,
    two stages: a line a stage, the decoder's total, and the JSON row with
    finite times."""
    monkeypatch.setattr(serving_config, 'HEIGHT', H)
    monkeypatch.setattr(serving_config, 'WIDTH', W)
    row = stagebench.main(['--dtype', 'float32', '--n', '1', '--stages',
                           'deconv1', 'output0'], device='cpu')
    out = capsys.readouterr().out
    assert 'dec total' in out
    assert set(row['stages_ms']) == {'deconv1', 'output0'}
    assert all(np.isfinite(v) for v in row['stages_ms'].values())
    assert row['device'] == 'cpu'


# ---- rnstagebench ------------------------------------------------------

RN_K, RN_PATCH = 8, (64, 32)
# a 64 x 96 frame padded by 32 columns, at the five levels
RN_POOLS = {
    'pool2': ((4, 4, 32, 64), 0.5, (32, 16)),
    'pool4': ((4, 8, 16, 32), 0.25, (16, 8)),
    'pool8': ((4, 8, 8, 16), 0.125, (8, 4)),
    'pool16': ((4, 8, 4, 8), 0.0625, (4, 2)),
    'pool32': ((4, 8, 2, 4), 1 / 32., (2, 1)),
}
RN_BLOCKS = {
    'deconv2': (8, 4, 8, (RN_K, 8, 8, 4), (RN_K, 4, 16, 8)),
    'deconv1': (8, 4, 4, (RN_K, 8, 16, 8), (RN_K, 4, 32, 16)),
}


def test_rnstagebench_stages_equal_jax_modules():
    """At K = 8 patches of 64 x 32 (4 frames): the pools against JAX's
    roi_pool_column on the same maps (equal: a max of the same values);
    the folded decoder blocks and the plain tail (deconv0 + output0)
    against JAX's DecoderBlock and packed_decoder_tail from the same
    unfolded weights, within 1e-5 of the largest magnitude; the scatter
    (K1's plain version) against JAX's Pallas kernel in interpret mode,
    bit for bit; float32."""
    stages = rnstagebench.make_stages(
        RN_K, torch.float32, 'cpu', np.random.default_rng(0),
        pools=RN_POOLS, blocks=RN_BLOCKS, tail_shape=(RN_K, 32, 32, 16),
        scatter=(H, W, RN_PATCH))
    assert list(stages) == list(RN_POOLS) + list(RN_BLOCKS) + ['tail',
                                                               'scatter']
    with torch.inference_mode():
        for name, (_, scale, out_size) in RN_POOLS.items():
            fn, (feat, x1) = stages[name]
            ref = jax_roi_pool_column(jnp.asarray(nhwc(feat)),
                                  jnp.asarray(x1.numpy()), box_width=32,
                                  box_y1=0, box_y2=H, spatial_scale=scale,
                                  output_size=out_size)
            np.testing.assert_array_equal(nhwc(fn(feat, x1)),
                                          np.asarray(ref), err_msg=name)
        for i, (name, (cin, cs, cout, _, _)) in enumerate(
                RN_BLOCKS.items()):
            fn, (x, skip) = stages[name]
            unfolded = DecoderBlock(cin, cs, cout, use_batch_norm=True,
                                    deconv_type='up')
            init_parameters(unfolded,
                            torch.Generator().manual_seed(100 + i))
            p, s = _block_trees(unfolded)
            blk = jax_layers.DecoderBlock(cin, cs, cout, use_batch_norm=True,
                                          deconv_type='up')
            ref = blk(p, s, jnp.asarray(nhwc(x)),
                      skip=jnp.asarray(nhwc(skip)))[0]
            assert_close(nhwc(fn(x, skip)), ref, what=name)

        from rcfd_tpu.ops.packed_tail import packed_decoder_tail
        fn, (x,) = stages['tail']
        d0 = DecoderBlock(32, 0, 16, use_batch_norm=True, deconv_type='up')
        init_parameters(d0, torch.Generator().manual_seed(7))
        oc = Conv2d(16, 1, 3, 1, 'kaiming_uniform', 'sigmoid', False)
        init_parameters(oc, torch.Generator().manual_seed(8))
        (p0, s0), (po, so) = _block_trees(d0), _block_trees(oc)
        ref = packed_decoder_tail(
            jnp.asarray(nhwc(x)),
            jax_layers.DecoderBlock(32, 0, 16, use_batch_norm=True,
                                    deconv_type='up'),
            jax_layers.Conv2d(16, 1, 3, 1, 'kaiming_uniform', 'sigmoid',
                              False),
            {'deconv0': p0, 'output0': po}, {'deconv0': s0, 'output0': so})
        assert_close(nhwc(fn(x)), ref, what='tail')

        from rcfd_tpu.ops.scatter_pallas import scatter_quasi_dense_pallas
        fn, inputs = stages['scatter']
        got = fn(*inputs)
        ref = scatter_quasi_dense_pallas(
            *(jnp.asarray(t.numpy()) for t in inputs), H, W, RN_PATCH,
            interpret=True)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---- fnbisect ------------------------------------------------------------

def test_fnbisect_cuts_equal_jax_modules():
    """The enc and full cuts' sums (fullps is full's graph) at a 64 x 96
    frame of a narrow FusionNet, folded, float32, on integer-transport
    inputs (uint8 image values, uint16 depth codes, as the tool feeds
    them): within 1e-5 relative of JAX's encoder and apply."""
    model = _port(FusionNetModel, FUSIONNET_TINY, 2)
    params, state = _trees(model, 3)
    folded = fold_batch_norm(model).eval()
    jp, js = jax_fold(params, state)
    jax_model = JaxFusionNet(**FUSIONNET_TINY)
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (1, H, W, 3)).astype(np.float32)
    dep = rng.integers(0, 256, (1, H, W, 2)).astype(np.float32)
    cuts = fnbisect.cuts(folded, torch.float32)
    assert set(cuts) == set(fnbisect.CUTS)
    with torch.inference_mode():
        enc = float(cuts['enc'](nchw(image), nchw(dep)))
        full = float(cuts['full'](nchw(image), nchw(dep)))
        assert float(cuts['fullps'](nchw(image), nchw(dep))) == full
    latent, skips, _ = jax_model.encoder(jp['encoder'], js['encoder'],
                                         jnp.asarray(image), jnp.asarray(dep))
    ref_enc = float(jnp.sum(latent) + sum(jnp.sum(s) for s in skips))
    out, _ = jax_model.apply(jp, js, jnp.asarray(image), jnp.asarray(dep))
    np.testing.assert_allclose(enc, ref_enc, rtol=RTOL)
    np.testing.assert_allclose(full, float(jnp.sum(out)), rtol=RTOL)


def test_fnbisect_refuses_s2d():
    """--s2d selects the JAX package's space-to-depth stem, a TPU layout
    rewrite: refused with the port's message."""
    with pytest.raises(ValueError, match='TPU layout rewrite'):
        fnbisect.main(['--s2d', '2'], device='cpu')


def test_fnbisect_main_on_cpu(monkeypatch):
    monkeypatch.setattr(serving_config, 'HEIGHT', H)
    monkeypatch.setattr(serving_config, 'WIDTH', W)
    row = fnbisect.main(['--batch', '1', '--n_scan', '1', '--cuts', 'enc',
                         'full', 'fullps'], device='cpu')
    assert set(row['ms_per_frame']) == {'enc', 'full', 'fullps'}
    assert all(np.isfinite(v) for v in row['ms_per_frame'].values())


# ---- pipebisect ----------------------------------------------------------

def _tiny_pipelines():
    """The port's and the JAX package's TwoStagePipeline(optimize=True) of
    the narrow models at 64 x 96, from the same weights (batch norm
    drawn)."""
    rn = _port(RadarNetModel, RADARNET_TINY, 4)
    fn = _port(FusionNetModel, FUSIONNET_TINY, 5)
    rn_vars, fn_vars = _trees(rn, 6), _trees(fn, 7)
    port = TwoStagePipeline(rn, fn, H, W, optimize=True, device='cpu')
    from rcfd_tpu.pipeline import TwoStagePipeline as JaxPipeline
    ref = JaxPipeline(JaxRadarNet(**RADARNET_TINY),
                      JaxFusionNet(**FUSIONNET_TINY), rn_vars, fn_vars, H, W,
                      optimize=True)
    return port, ref


def _jax_cuts(pipe, images, points, valid, crops_in):
    """pipebisect's cuts of the JAX serving graph (tools/pipebisect.py's
    stage functions) on the JAX pipeline's folded variables; the stages
    after RadarNet take ``crops_in`` (the port's), so that a response
    that rounds to the other side of 0.5, or of another point's, in one
    package cannot move a winner."""
    from rcfd_tpu.ops.scatter import scatter_quasi_dense
    from rcfd_tpu.pipeline import RESPONSE_DECODE_SCALE
    b, k = points.shape[:2]
    patch = pipe.radarnet.input_patch_size_image
    pad = patch[1] // 2
    rn_p, rn_s = pipe.radarnet_params, pipe.radarnet_state
    (images_t,) = pipe.transforms.transform(
        jax.random.PRNGKey(0), [images], random_transform_probability=0.0)
    images_pad = jnp.pad(images_t, ((0, 0), (0, 0), (pad, pad), (0, 0)),
                         mode='edge')
    x_shifted = points[..., 0] + pad
    responses, _ = pipe.radarnet.apply(
        rn_p, rn_s, images_pad,
        points.at[..., 0].set(x_shifted).reshape(b * k, 3),
        x_shifted - pad, box_height=H, training=False, return_logits=False)
    crops = responses[..., 0].reshape(b, k, *responses.shape[1:3])
    d, r = jax.lax.map(lambda a: scatter_quasi_dense(
        *a, image_height=H, image_width=W, patch_size=patch),
        (crops_in, x_shifted, points[..., 2], valid))

    def bridge(d, r):
        d = jnp.floor(d * 256.0) / 256.0
        r = jnp.floor(r * 2.0 ** 14) / 2.0 ** 14
        return jnp.stack([d, r * RESPONSE_DECODE_SCALE], axis=-1)

    def fusion(input_depth):
        out, _ = pipe.fusionnet.apply(pipe.fusionnet_params,
                                      pipe.fusionnet_state, images_t,
                                      input_depth, training=False)
        return out[..., 0]

    stand_in = bridge(jnp.clip(images_t[..., 0] * 0.3, 0, 80),
                      jnp.clip(images_t[..., 1], 0, 1))
    return {'rn': crops, 'scatter': d + r,
            'bridge': jnp.sum(bridge(d, r), axis=-1),
            'full': fusion(bridge(d, r)), 'fn': fusion(stand_in)}


def test_pipebisect_cuts_equal_the_jax_graphs_cuts():
    """Each cut of the tiny pipeline (2 frames, K = 4, float32, the exact
    max) against the same cut of the JAX serving graph, the JAX stages
    after RadarNet on the port's crops: each within 1e-5 of its largest
    magnitude."""
    port, ref_pipe = _tiny_pipelines()
    rng = np.random.default_rng(1)
    images = rng.random((2, H, W, 3), dtype=np.float32) * 255
    points = np.stack([rng.integers(0, W, (2, 4)).astype(np.float32),
                       rng.integers(0, H, (2, 4)).astype(np.float32),
                       rng.random((2, 4), dtype=np.float32) * 70 + 1], -1)
    valid = np.ones((2, 4), bool)
    cuts = pipebisect.cuts(port, torch.from_numpy(valid))
    with torch.inference_mode():
        crops = cuts['rn'](torch.from_numpy(images), torch.from_numpy(points))
    ref = _jax_cuts(ref_pipe, jnp.asarray(images), jnp.asarray(points),
                    jnp.asarray(valid), jnp.asarray(crops.numpy()))
    with torch.inference_mode():
        for name, fn in cuts.items():
            got = fn(torch.from_numpy(images), torch.from_numpy(points))
            assert_close(got.numpy(), ref[name], what=name)


def test_pipebisect_main_on_cpu(monkeypatch):
    """The tool's main on the CPU at a 64 x 96 frame (RadarNet's patch 64
    x 32), both scatter routes: the exact max by default, K1's plain
    version under PerfConfig(pallas_scatter=True)."""
    from rcfd_tpu_torch.nn.perf import PerfConfig
    monkeypatch.setattr(serving_config, 'HEIGHT', H)
    monkeypatch.setattr(serving_config, 'WIDTH', W)
    monkeypatch.setattr(serving_config, 'RADARNET', dict(
        serving_config.RADARNET, input_patch_size_image=(64, 32)))
    argv = ['--b', '1', '--k', '4', '--n_scan', '1', '--cuts', 'scatter',
            'full']
    row = pipebisect.main(argv, device='cpu')
    assert row['scatter'] == 'exact max'
    row = pipebisect.main(argv, device='cpu',
                          perf=PerfConfig(pallas_scatter=True))
    assert row['scatter'] == 'K1'
    assert all(np.isfinite(v) for v in row['ms_per_frame'].values())


# ---- fusedskip_bench, fusepool_experiment, microbench --------------------

def test_fusedskip_bench_paths_equal_jax_paths():
    """At 2 frames of K = 3 windows (16 x 8, 4 channels, a 40-wide map),
    float32: the split path against JAX's (windows, two convs, add), the
    fused path (K3's plain version on the CPU) and the plain one against
    JAX's fused_skip_conv_add(use_pallas=False), within 1e-5 of the
    largest magnitude; the fused and plain paths equal bit for bit."""
    from rcfd_tpu.nn import functional as JF
    from rcfd_tpu.ops.fused_skip import LazyColumnWindows as JaxLazy
    from rcfd_tpu.ops.fused_skip import fused_skip_conv_add
    inputs = fusedskip_bench.make_inputs(2, 3, 16, 8, 4, 40, torch.float32,
                                         'cpu', np.random.default_rng(0))
    a, g, starts, w_skip, w_a = inputs
    ja, jg = jnp.asarray(nhwc(a)), jnp.asarray(nhwc(g))
    jw_skip = jnp.asarray(w_skip.permute(2, 3, 1, 0).numpy())
    jw_a = jnp.asarray(w_a.permute(2, 3, 1, 0).numpy())
    lazy = JaxLazy(jg, jnp.asarray(starts.numpy()), 8)
    ref_split = JF.conv2d(ja, jw_a) + JF.conv2d(lazy.materialize(), jw_skip)
    ref_fused = fused_skip_conv_add(ja, jw_a, lazy, jw_skip,
                                    use_pallas=False)
    with torch.inference_mode():
        assert_close(nhwc(fusedskip_bench.baseline(*inputs)), ref_split,
                     what='baseline')
        fused = fusedskip_bench.fused(*inputs)
        plain = fusedskip_bench.fused_plain(*inputs)
    assert_close(nhwc(fused), ref_fused, what='fused')
    assert torch.equal(fused, plain)
    row = fusedskip_bench.main(['--n', '2', '--k', '3', '--ph', '16',
                                '--pw', '8', '--c', '4', '--wf', '40',
                                '--dtype', 'float32'], device='cpu')
    assert row['k3_vs_plain'] == 0.0 and row['ms'] is None
    assert row['max_abs_err'] <= RTOL * row['scale']


def test_fusepool_identity_and_jax_conv():
    """conv(window(G)) == window(conv(G)) + corrections at 16 x 60, 4
    channels, 5 windows of 8, float32, within 1e-5 of the largest
    magnitude; the windows' conv against JAX's lax.conv_general_dilated
    (the JAX tool's conv) on the same windows, within 1e-5 too."""
    g, w, starts = fusepool_experiment.make_inputs(
        16, 60, 4, 8, 5, torch.float32, 'cpu', np.random.default_rng(0))
    ref = fusepool_experiment.windows_then_conv(g, w, starts, 8)
    out = fusepool_experiment.conv_then_windows(g, w, starts, 8)
    assert_close(out.numpy(), ref.numpy(), what='identity')
    wins = fusepool_experiment.windows(g, starts, 8)
    jref = jax.lax.conv_general_dilated(
        jnp.asarray(nhwc(wins)), jnp.asarray(w.permute(2, 3, 1, 0).numpy()),
        (1, 1), ((1, 1), (1, 1)), dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
    assert_close(nhwc(ref), jref, what='jax conv')


def test_microbench_ops_on_cpu():
    """The scatter (the exact max and K1's plain version), ROI pool and
    reproject measurements at small shapes on the CPU: finite times."""
    results = {}
    with torch.inference_mode():
        microbench.bench_scatter(results, 'cpu', k=4, h=H, w=W, ph=64,
                                 pw=32)
        microbench.bench_roi_pool(results, 'cpu', k=4, patch_h=64,
                                  patch_w=32, img_w=128)
        microbench.bench_reproject(results, 'cpu', h=H, w=W)
    for v in (results['scatter']['exact_ms'], results['scatter']['k1_ms'],
              results['roi_pool']['ms'], results['reproject']['ms']):
        assert np.isfinite(v)


@pytest.mark.parametrize('tool', [stagebench, rnstagebench, fnbisect,
                                  pipebisect, microbench, fusedskip_bench,
                                  fusepool_experiment])
def test_needs_a_card_unless_asked_for_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])
