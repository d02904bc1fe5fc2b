#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rcfd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printed as it starts and ends:

  build      compile the hand-written CUDA kernels with nvcc, one process
             per source, all started together
  kernel     hold each kernel against its plain PyTorch version on the card
             at the shapes of the serving paths, bit for bit, and time the
             kernel, the plain version and the nearest one-call PyTorch
             operator
  variants   the fused skip gather-add's variants (K3 and four that split
             its time: rcfd_tpu_torch.tools.fusepall_exp) at deconv1's and
             deconv2's shapes, in float32 and bf16, each against its plain
             version bit for bit, timed against its byte bound
  reference  small configurations on the card against the same port on
             the CPU, stage by stage (the canonical one, one with RadarNet's
             deferred skip pools, one at a patch width that is not a
             multiple of 32)
  slice      the two-stage serving path at full width (RadarNet at its
             900x288 patch, FusionNet at the benchmark config, 900x1600
             frames, 64 radar points) with seeded random weights, serving a
             few requests; kernel: the quasi-dense scatter. Also one
             request with codec_encode=True, whose uint16 outputs must
             equal floor(x * 256) / floor(x * 2^14) of the float ones
  fused      the same path with RadarNet's 1/2- and 1/4-scale pools
             deferred into its decoder (PerfConfig(fused_pool2=True,
             fused_pool4=True)); kernels: the fused skip gather-add and the
             scatter
  wide       the same path with RadarNet at a 900x300 patch, whose 1/8,
             1/16 and 1/32 pools take the variable-bin branch; kernels: the
             column crop and the scatter
  optimize   the slice and fused paths with every batch norm folded into
             its convolution (TwoStagePipeline(optimize=True)): launches,
             the deviation from the unfolded paths, and ms/frame of
             interleaved, paired requests against the slice

Each path phase sets every kernel's launch count to 0 before its counted
requests, reads them after, and fails unless each kernel of its path was
launched as often as its requests need and every other kernel not at
all.

Then a line with the card's name and power limit, a line
{"kernels": [...]} and, last, {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero and prints no result; so does a
machine without a CUDA device, or a directory that lacks the package.
It imports torch, numpy and rcfd_tpu_torch only.

The models run under the pipeline's own numerics
(rcfd_tpu_torch.pipeline.serving_numerics: float32 with TF32 off, cuDNN
algorithms autotuned among deterministic ones), as a caller gets them;
the script sets no backend flag of its own. With --profile each path
phase also traces one request with torch.profiler and prints the device
time by kernel.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# the serving path's shapes (run_pipeline.py / bench.py defaults)
H, W = 900, 1600
PATCH = (900, 288)
WIDE_PATCH = (900, 300)
# scales of RadarNet's column pools: the four skips, then the latent
SCALES = [1 / 2., 1 / 4., 1 / 8., 1 / 16., 1 / 32.]
K = 64
N_INVALID = 4
RADARNET = dict(
    input_channels_image=3, input_channels_depth=3,
    input_patch_size_image=PATCH, encoder_type='radarnetv1_batch_norm',
    n_filters_encoder_image=[32, 64, 128, 128, 128],
    n_neurons_encoder_depth=[32, 64, 128, 128, 128],
    decoder_type='multiscale_batch_norm',
    n_filters_decoder=[256, 128, 64, 32, 16])
FUSIONNET = dict(
    input_channels_image=3, input_channels_depth=2,
    encoder_type='fusionnet18_batch_norm',
    n_filters_encoder_image=[32, 64, 128, 256, 256, 256],
    n_filters_encoder_depth=[16, 32, 64, 128, 128, 128],
    fusion_type='weight_and_project', decoder_type='multiscale_batch_norm',
    n_resolution_decoder=1, n_filters_decoder=[256, 256, 128, 64, 64, 32],
    deconv_type='up', activation_func='leaky_relu',
    weight_initializer='kaiming_uniform', min_predict_depth=1.0,
    max_predict_depth=100.0)
N_REQUESTS = 3
SEED = 0
# --profile: also trace one request of each path with torch.profiler
PROFILE = '--profile' in sys.argv[1:]
# H100 SXM data sheet: HBM3 rate, bytes/s
HBM_BYTES_PER_S = 3.35e12


def log(msg):
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log('[phase {}] start'.format(self.name))
        return self

    def __exit__(self, exc_type, exc, tb):
        state = 'end' if exc_type is None else 'FAILED'
        log('[phase {}] {} after {:.2f} s'.format(
            self.name, state, time.perf_counter() - self.t0))
        return False


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def device_ms(fn, n, warmup=2):
    """Median device milliseconds of ``fn`` over ``n`` runs, each between
    two CUDA events. A sleep kernel holds the stream while the runs are
    queued, so the host's launch overhead does not show in the times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s of clock cycles
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def import_port():
    sys.path.insert(0, HERE)
    import rcfd_tpu_torch
    pkg_dir = os.path.dirname(os.path.abspath(rcfd_tpu_torch.__file__))
    check(pkg_dir == os.path.join(HERE, 'rcfd_tpu_torch'),
          'rcfd_tpu_torch was imported from {}, not from this checkout'
          .format(pkg_dir))
    return rcfd_tpu_torch


def scatter_inputs(rng, device, patch=PATCH):
    """Scatter inputs with the hard cases: ties inside one 2^-14 step,
    values of exactly 0.5, invalid points, points at x = 0 and x = W - 1,
    and integer depths equal to other points' indices (the legacy rewrite
    cascade)."""
    ph, pw = patch
    pad = pw // 2
    crops = rng.random((K, ph, pw), dtype=np.float32)
    x = rng.integers(0, W, K).astype(np.float32)
    x[0], x[1], x[2] = 700.0, 700.0, 703.0
    crops[1] = np.nextafter(crops[0], np.float32(1.0))  # same 2^-14 step
    crops[2, :300] = 0.5
    x[3], x[4] = 0.0, W - 1.0
    z = (rng.random(K, dtype=np.float32) * 79 + 1).astype(np.float32)
    z[5], z[7], z[9] = 7.0, 9.25, 2.5
    valid = np.ones(K, bool)
    valid[-N_INVALID:] = False
    t = lambda a: torch.from_numpy(a).to(device)
    return t(crops), t(x + pad), t(z), t(valid)


def scatter_bound_bytes(x_start, valid, ph, pw, w):
    """Bytes the scatter must move for these inputs: the crop elements that
    land in the frame for the valid points (read once), the three (K,)
    int32 tables, and the two (ph, w) float32 maps (written once)."""
    lo = np.maximum(x_start - pw, 0)
    hi = np.minimum(x_start, w)
    cols = np.where(valid > 0, np.maximum(hi - lo, 0), 0)
    return 4 * ph * int(cols.sum()) + 3 * 4 * len(x_start) + 2 * 4 * ph * w


def scatter_kernel_check(device, patch):
    """The scatter kernel against its plain version at ``patch``, bit for
    bit: (args, max abs err)."""
    from rcfd_tpu_torch.ops import scatter_cuda as sc

    crops, xs, zs, valid = scatter_inputs(np.random.default_rng(SEED),
                                          device, patch)
    args = (crops, xs, zs, valid, H, W, patch)
    d_k, r_k = sc.scatter_quasi_dense(*args)
    d_p, r_p = sc.scatter_quasi_dense_plain(*args)
    torch.cuda.synchronize()
    err = max(float((d_k - d_p).abs().max()), float((r_k - r_p).abs().max()))
    check(torch.equal(d_k, d_p) and torch.equal(r_k, r_p),
          'scatter kernel differs from its plain version at patch {}: max '
          'abs err {}'.format(patch, err))
    check(int((r_k > 0).sum()) > 0, 'scatter produced an empty map')
    log('scatter kernel == plain version at patch {}x{}, bit for bit '
        '(tolerance 0); {} covered pixels'.format(patch[0], patch[1],
                                                  int((r_k > 0).sum())))
    return args, err


def phase_kernel_scatter(device, record):
    from rcfd_tpu_torch.ops import scatter_cuda as sc

    ph, pw = PATCH
    args, err = scatter_kernel_check(device, PATCH)
    crops, xs, zs, valid = args[:4]
    ms = device_ms(lambda: sc.scatter_quasi_dense(*args), 20)
    plain_ms = device_ms(lambda: sc.scatter_quasi_dense_plain(*args), 5, 1)
    # yardstick: the one PyTorch call that computes the max, on keys
    # computed beforehand
    x_start, valid_i, _ = sc.point_tables(xs, zs, valid, pw, W)
    keys = sc.packed_keys(crops, valid_i).permute(1, 0, 2).reshape(ph, -1)
    cols = sc.window_columns(x_start, pw).reshape(1, -1).expand(ph, -1)
    cols = cols.contiguous()
    packed = torch.zeros((ph, W + 2 * pw), dtype=torch.int32, device=device)
    library_ms = device_ms(
        lambda: packed.scatter_reduce_(1, cols, keys, 'amax'), 20)
    nbytes = scatter_bound_bytes(x_start.cpu().numpy(), valid_i.cpu().numpy(),
                                 ph, pw, W)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log('scatter at K={} crops {}x{} w={}, device time: kernel {:.4f} ms '
        '(median of 20), plain {:.4f} ms, scatter_reduce_ {:.4f} ms, bound '
        '{:.4f} ms '
        '({} bytes at {:.3g} B/s)'.format(K, ph, pw, W, ms, plain_ms,
                                          library_ms, bound_ms, nbytes,
                                          HBM_BYTES_PER_S))
    # the variable-bin path serves 300-wide crops
    scatter_kernel_check(device, WIDE_PATCH)
    record['scatter_quasi_dense'] = dict(
        name='scatter_quasi_dense', route='cuda',
        source='rcfd_tpu_torch/csrc/scatter_quasi_dense.cu',
        replaces='rcfd_tpu/ops/scatter_pallas.py:42',
        launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by='bytes', library_ms=library_ms)


def encoder_maps(rn, patch, device):
    """Shapes of the feature maps RadarNet's column pools read for a
    900x1600 frame padded by patch_w // 2 on each side: [1/2, 1/4, 1/8,
    1/16 skips, 1/32 latent], from a run of its image encoder on the card."""
    with torch.inference_mode():
        latent, skips = rn.encoder.encode_image(
            torch.zeros((1, 3, H, W + 2 * (patch[1] // 2)), device=device))
    return [tuple(t.shape) for t in list(skips) + [latent]]


def kernel_entry(name, source, replaces, parts, library):
    """One kernel's line of the kernels JSON: the sums over the shapes one
    request runs (its parts, also listed), the largest error."""
    total = lambda key: float(sum(p[key] for p in parts))
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                launches=None, max_abs_err=max(p['max_abs_err']
                                               for p in parts),
                ms=total('ms'), plain_ms=total('plain_ms'),
                bound_ms=total('bound_ms'), bound_by='bytes',
                library_ms=total('library_ms') if library else None,
                per_request=True, parts=parts)


def fused_skip_shapes(rn, device):
    """(block, channels, ph, pw, map width) of the fused skip gather-add
    at deconv1 (the 1/2-scale skip) and deconv2 (the 1/4) of the 900x288
    patch."""
    maps = encoder_maps(rn, PATCH, device)
    out = []
    for i in (0, 1):
        block = 'deconv{}'.format(i + 1)
        co = getattr(rn.decoder, block).conv.conv.weight.shape[0]
        ph, pw = int(PATCH[0] * SCALES[i]), int(PATCH[1] * SCALES[i])
        out.append((block, co, ph, pw, maps[i][3] + pw))
    return out


def phase_kernel_fused_skip(device, record, rn):
    """The fused skip gather-add at deconv1's and deconv2's shapes of the
    900x288 patch (64 windows of one frame), against its plain version."""
    from rcfd_tpu_torch.ops import fused_skip as fs

    rng = np.random.default_rng(SEED + 2)
    t = lambda a: torch.from_numpy(a).to(device)
    parts = []
    for block, co, ph, pw, wg in fused_skip_shapes(rn, device):
        a = t(rng.standard_normal((K, co, ph, pw), dtype=np.float32))
        cg = t(rng.standard_normal((1, co, ph, wg), dtype=np.float32))
        starts = rng.integers(0, wg - pw + 1, (1, K)).astype(np.int32)
        starts[0, :2] = [0, wg - pw]
        corr_l = t(rng.standard_normal((K, co, ph), dtype=np.float32))
        corr_r = t(rng.standard_normal((K, co, ph), dtype=np.float32))
        args = (a, cg, t(starts), corr_l, corr_r)
        out = fs.fused_skip_gather_add(*args)
        ref = fs.fused_skip_gather_add_plain(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(torch.equal(out, ref), 'fused skip kernel differs from its '
              'plain version at {}: max abs err {}'.format(block, err))
        del out, ref
        ms = device_ms(lambda: fs.fused_skip_gather_add(*args), 20)
        plain_ms = device_ms(lambda: fs.fused_skip_gather_add_plain(*args),
                             5, 1)
        nbytes = 4 * (2 * a.numel() + cg.numel() + 2 * corr_l.numel() + K)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log('fused skip at {}: a {} cg {}, kernel == plain version, bit for '
            'bit (tolerance 0); device time: kernel {:.4f} ms (median of '
            '20), plain {:.4f} ms, bound {:.4f} ms ({} bytes at {:.3g} B/s); '
            'one-call PyTorch yardstick: none (no one call adds windows of '
            'one tensor with the boundary corrections)'.format(
                block, tuple(a.shape), tuple(cg.shape), ms, plain_ms,
                bound_ms, nbytes, HBM_BYTES_PER_S))
        parts.append(dict(shape=block, a=list(a.shape), cg=list(cg.shape),
                          max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bytes=nbytes))
        del args, a, cg, corr_l, corr_r
    record['fused_skip_gather_add'] = kernel_entry(
        'fused_skip_gather_add', 'rcfd_tpu_torch/csrc/fused_skip_gather_add.cu',
        'rcfd_tpu/ops/fused_skip.py:174', parts, library=False)


def phase_kernel_column_crop(device, record, rn):
    """The column crop at the 1/8, 1/16 and 1/32 pools of the 900x300 patch
    (the variable-bin ones; 64 windows of one frame), against its plain
    version, with torch.gather on the padded rows as the yardstick."""
    from rcfd_tpu_torch.ops import crop_cuda as cc
    from rcfd_tpu_torch.ops.roi_pool import variable_bin_window

    maps = encoder_maps(rn, WIDE_PATCH, device)
    rng = np.random.default_rng(SEED + 3)
    parts = []
    for i in (2, 3, 4):
        c, w_f = maps[i][1], maps[i][3]
        ph, pw = int(H * SCALES[i]), int(WIDE_PATCH[1] * SCALES[i])
        _, win = variable_bin_window(WIDE_PATCH[1], SCALES[i], pw)
        rows = torch.from_numpy(rng.standard_normal(
            (1, c, ph, w_f), dtype=np.float32)).to(device)
        starts = rng.integers(0, w_f + 1, (1, K)).astype(np.int32)
        starts[0, :2] = [0, w_f]  # the first column, and wholly past W
        starts = torch.from_numpy(starts).to(device)
        out = cc.batch_column_crop(rows, starts, win)
        ref = cc.batch_column_crop_plain(rows, starts, win)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(torch.equal(out, ref), 'column crop kernel differs from its '
              'plain version at 1/{}: max abs err {}'.format(
                  int(1 / SCALES[i]), err))
        ms = device_ms(lambda: cc.batch_column_crop(rows, starts, win), 20)
        plain_ms = device_ms(
            lambda: cc.batch_column_crop_plain(rows, starts, win), 5, 1)
        # yardstick: one torch.gather from the zero-padded rows with the
        # index computed beforehand
        rows_p = torch.nn.functional.pad(rows, (0, win)).expand(K, -1, -1,
                                                               -1)
        cols = starts[0].long()[:, None] + torch.arange(win, device=device)
        index = cols[:, None, None, :].expand(K, c, ph, win).contiguous()
        check(torch.equal(torch.gather(rows_p, 3, index), out),
              'the torch.gather yardstick differs from the kernel')
        library_ms = device_ms(lambda: torch.gather(rows_p, 3, index), 20)
        nbytes = 4 * (out.numel() + rows.numel() + K)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log('column crop at 1/{}: rows {} -> {} windows of {}, kernel == '
            'plain version, bit for bit (tolerance 0); device time: kernel '
            '{:.4f} ms (median of 20), plain {:.4f} ms, torch.gather {:.4f} '
            'ms, bound {:.4f} ms ({} bytes at {:.3g} B/s)'.format(
                int(1 / SCALES[i]), tuple(rows.shape), K, win, ms, plain_ms,
                library_ms, bound_ms, nbytes, HBM_BYTES_PER_S))
        parts.append(dict(shape='1/{}'.format(int(1 / SCALES[i])),
                          rows=list(rows.shape), win=win, max_abs_err=err,
                          ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          library_ms=library_ms, bytes=nbytes))
        del out, ref, rows_p, index
    record['column_crop'] = kernel_entry(
        'column_crop', 'rcfd_tpu_torch/csrc/column_crop.cu',
        'rcfd_tpu/ops/crop_pallas.py:29', parts, library=True)


def phase_variants(device, record, rn):
    """K3 and its four variants (rcfd_tpu_torch.tools.fusepall_exp) at
    deconv1's and deconv2's shapes, in float32 and bf16, on the tool's
    inputs: each against its plain version bit for bit, full and align16
    also against K3's plain version; timed against the byte bound, with
    torch.mul and torch.gather as the yardsticks of nodma and dmaonly."""
    from rcfd_tpu_torch.ops import fused_skip_variants as fv
    from rcfd_tpu_torch.tools import fusepall_exp as tool

    before = {v: fv.WRAPPERS[v].launches for v in fv.VARIANTS}
    parts = []
    for block, co, ph, pw, wg in fused_skip_shapes(rn, device):
        for dtype in (torch.float32, torch.bfloat16):
            args = tool.make_inputs(K, 1, ph, pw, co, wg - pw, dtype,
                                    device, seed=SEED)
            for r in tool.run_variants(args, timer=device_ms):
                label = '{} {} {}'.format(block, r['variant'], r['dtype'])
                check(r['equal'], '{}: the kernel differs from its plain '
                      'version: max abs err {}'.format(label,
                                                       r['max_abs_err']))
                check(r.get('err_vs_k3', 0.0) == 0.0, "{}: differs from "
                      "K3's plain version by {}".format(
                          label, r.get('err_vs_k3')))
                check(r.get('library_equal', True), '{}: the {} yardstick '
                      'differs from the plain version'.format(
                          label, r['library']))
                check(r['launched'], '{}: the wrapper did not count a '
                      'launch'.format(label))
                log('variants, {}: {}'.format(block, tool.describe(r)))
                parts.append(dict(r, shape=block, a=list(args[0].shape),
                                  cg=list(args[1].shape)))
            del args
    launches = sum(fv.WRAPPERS[v].launches - before[v] for v in fv.VARIANTS)
    check(launches == len(parts) * (1 + 2 + tool.N_TIMED),
          'variants: {} launches for {} parts'.format(launches, len(parts)))
    total = lambda key: float(sum(p[key] for p in parts))
    record['fused_skip_variants'] = dict(
        name='fused_skip_variants', route='cuda',
        source='rcfd_tpu_torch/csrc/fused_skip_variants.cu',
        replaces='tools/fusepall_exp.py:63',
        launches=launches,
        launches_note='launches of the variants phase: K4 is a measurement '
                      'tool on no serving path (0 launches on every path)',
        max_abs_err=max(p['max_abs_err'] for p in parts),
        ms=total('ms'), plain_ms=total('plain_ms'),
        bound_ms=total('bound_ms'), bound_by='bytes', library_ms=None,
        sums_over_parts=True, parts=parts)


def build_models(radarnet_kw, fusionnet_kw, device, seed):
    from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel
    from rcfd_tpu_torch.nn import init_parameters

    gen = torch.Generator().manual_seed(seed)
    rn = RadarNetModel(**radarnet_kw, device='cpu')
    fn = FusionNetModel(**fusionnet_kw, device='cpu')
    init_parameters(rn, gen)
    init_parameters(fn, gen)
    return rn.to(device), fn.to(device)


def radarnet_like(rn, device, **kw):
    """A RadarNet of another patch or perf with ``rn``'s weights (no
    configuration of the smoke changes a parameter's shape)."""
    from rcfd_tpu_torch.models import RadarNetModel

    other = RadarNetModel(**dict(RADARNET, **kw), device='cpu')
    other.load_state_dict(rn.state_dict(), strict=True)
    return other.to(device)


def requests(rng, n, h, w, k, n_invalid):
    out = []
    for _ in range(n):
        image = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
        points = np.stack([rng.integers(0, w, k), rng.integers(0, h, k),
                           rng.random(k) * 79 + 1], 1).astype(np.float32)
        valid = np.ones(k, bool)
        valid[k - n_invalid:] = False
        out.append((image, points, valid))
    return out


def launch_counters():
    from rcfd_tpu_torch.ops import crop_cuda as cc
    from rcfd_tpu_torch.ops import fused_skip as fs
    from rcfd_tpu_torch.ops import fused_skip_variants as fv
    from rcfd_tpu_torch.ops import scatter_cuda as sc
    counters = {'scatter_quasi_dense': sc.scatter_quasi_dense,
                'fused_skip_gather_add': fs.fused_skip_gather_add,
                'column_crop': cc.batch_column_crop}
    for variant, wrapper in fv.WRAPPERS.items():
        counters['fused_skip_variants.' + variant] = wrapper
    return counters


def reset_launches():
    for wrapper in launch_counters().values():
        wrapper.launches = 0


def read_launches():
    return {name: wrapper.launches
            for name, wrapper in launch_counters().items()}


def phase_reference(device):
    """Small configurations on the card against the port on the CPU, stage
    by stage, on the same weights and inputs: the canonical one in full;
    with the deferred skip pools and at a patch width that is not a
    multiple of 32, RadarNet's crops, whose card stage must launch the
    fused skip and the column crop kernels."""
    from rcfd_tpu_torch.models import RadarNetModel
    from rcfd_tpu_torch.nn.perf import PerfConfig
    from rcfd_tpu_torch.ops import scatter_cuda as sc
    from rcfd_tpu_torch.pipeline import TwoStagePipeline, serving_numerics

    h, w, patch = 96, 160, (96, 64)
    rn_kw = dict(RADARNET, input_patch_size_image=patch,
                 n_filters_encoder_image=[8, 16, 16, 16, 16],
                 n_neurons_encoder_depth=[8, 16, 16, 16, 16],
                 n_filters_decoder=[16, 16, 16, 8, 8])
    fn_kw = dict(FUSIONNET, n_filters_encoder_image=[8, 16, 16, 16, 16, 16],
                 n_filters_encoder_depth=[8, 8, 16, 16, 16, 16],
                 n_filters_decoder=[16, 16, 16, 8, 8, 8])
    rn, fn = build_models(rn_kw, fn_kw, 'cpu', SEED + 1)
    cpu = TwoStagePipeline(rn, fn, h, w, device='cpu')
    gpu = TwoStagePipeline(copy.deepcopy(rn), copy.deepcopy(fn), h, w,
                           device=device)
    image, points, valid = requests(np.random.default_rng(SEED + 1), 1, h, w,
                                    16, 2)[0]
    with torch.inference_mode(), serving_numerics():
        image_c, crops_c, xs, zs = cpu.radarnet_stage(image, points)
        image_g, crops_g, _, _ = gpu.radarnet_stage(image, points)
        err = float((crops_g.cpu() - crops_c).abs().max())
        check(err <= 1e-4, 'RadarNet crops: card vs CPU max abs err {} > '
              '1e-4'.format(err))
        log('reference: RadarNet crops card vs CPU max abs err {:.3g} '
            '(tolerance 1e-4)'.format(err))
        v = torch.from_numpy(valid)
        maps_c = sc.scatter_quasi_dense(crops_c, xs, zs, v, h, w, patch)
        maps_g = sc.scatter_quasi_dense(crops_c.to(device), xs.to(device),
                                        zs.to(device), v.to(device), h, w,
                                        patch)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(maps_g, maps_c)),
              'scatter kernel on the card differs from the CPU path')
        log('reference: scatter on the card == CPU path, bit for bit')
        _, _, input_depth = cpu.bridge(*maps_c)
        dense_c = cpu.fusionnet(image_c, input_depth)
        dense_g = gpu.fusionnet(image_g, input_depth.to(device))
        err = float((dense_g.cpu() - dense_c).abs().max())
        check(err <= 1e-3, 'FusionNet depth: card vs CPU max abs err {} > '
              '1e-3 m'.format(err))
        log('reference: FusionNet depth card vs CPU max abs err {:.3g} m '
            '(tolerance 1e-3 m)'.format(err))

    # RadarNet with the deferred skip pools, and at a patch width that is
    # not a multiple of 32 (its 1/8, 1/16 and 1/32 pools are variable-bin)
    for label, kw, kernel, n in (
            ('deferred pools', dict(perf=PerfConfig(fused_pool2=True,
                                                    fused_pool4=True)),
             'fused_skip_gather_add', 2),
            ('patch 96x76', dict(input_patch_size_image=(96, 76)),
             'column_crop', 3)):
        rn_c = RadarNetModel(**dict(rn_kw, **kw), device='cpu')
        rn_c.load_state_dict(rn.state_dict(), strict=True)
        cpu = TwoStagePipeline(rn_c, fn, h, w, device='cpu')
        gpu = TwoStagePipeline(copy.deepcopy(rn_c), copy.deepcopy(fn), h, w,
                               device=device)
        with torch.inference_mode(), serving_numerics():
            crops_c = cpu.radarnet_stage(image, points)[1]
            reset_launches()
            crops_g = gpu.radarnet_stage(image, points)[1]
            launches = read_launches()[kernel]
        check(launches == n, 'reference, {}: {} launched {} times, expected '
              '{}'.format(label, kernel, launches, n))
        err = float((crops_g.cpu() - crops_c).abs().max())
        check(err <= 1e-4, 'reference, {}: RadarNet crops card vs CPU max '
              'abs err {} > 1e-4'.format(label, err))
        log('reference, {}: RadarNet crops card vs CPU max abs err {:.3g} '
            '(tolerance 1e-4); {} launched {} times'.format(
                label, err, kernel, launches))


def serve_path(name, pipe, reqs, device, expect):
    """Serve the warm-up request, then the counted ones with every launch
    count set to 0 just before and read just after. ``expect`` maps each
    kernel of the path to the launches it must make; every other kernel
    must make none. Checks the outputs;
    returns (outs, ms per request, peak memory bytes, launches)."""
    pipe(*reqs[0])  # warm-up request: cuDNN chooses its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device)
    reset_launches()
    outs, times = [], []
    for req in reqs[1:]:
        t0 = time.perf_counter()
        out = pipe(*req)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(device)
    for kernel in launches:
        n = expect.get(kernel, 0)
        check(launches[kernel] == n, '{}: {} launched {} times for {} '
              'requests, expected {}'.format(name, kernel, launches[kernel],
                                             len(reqs) - 1, n))
    h, w = pipe.image_height, pipe.image_width
    for dense, quasi, response in outs:
        for label, t in (('dense', dense), ('quasi', quasi),
                         ('response', response)):
            check(tuple(t.shape) == (h, w), '{}: {} has shape {}'.format(
                name, label, tuple(t.shape)))
            check(bool(torch.isfinite(t).all()), '{}: {} is not finite'
                  .format(name, label))
        check(float(dense.min()) >= 1.0 and float(dense.max()) <= 100.0,
              '{}: dense depth outside [1, 100] m'.format(name))
        check(float(response.min()) >= 0.0 and float(response.max()) <= 1.0,
              '{}: response outside [0, 1]'.format(name))
        check(int((response > 0).sum()) > 0,
              '{}: empty quasi-dense map'.format(name))
    log('{}: {} requests at {}x{}, K={} ({} padding): ms/frame {} (median '
        '{:.2f}); peak memory {} bytes ({} above the {} resident before '
        'the requests); launches {}'.format(
            name, len(outs), h, w, K, N_INVALID,
            ', '.join('{:.2f}'.format(t) for t in times),
            float(np.median(times)), peak, peak - resident, resident,
            launches))
    log('{}: covered quasi-dense pixels per request: {}'.format(
        name, [int((o[2] > 0).sum()) for o in outs]))
    return outs, times, peak, launches


def check_plain_route(name, pipe, req, out, module, attr, plain):
    """The same request through the same pipeline with one kernel's
    wrapper replaced by its plain version, where the path looks it up: the
    quasi and response maps must be equal bit for bit."""
    kernel = getattr(module, attr)
    setattr(module, attr, plain)
    try:
        dense_p, quasi_p, response_p = pipe(*req)
    finally:
        setattr(module, attr, kernel)
    dense, quasi, response = out
    check(torch.equal(quasi, quasi_p) and torch.equal(response, response_p),
          '{}: the path with the kernel differs from the path with {}: {} '
          'quasi and {} response pixels'.format(
              name, plain.__name__, int((quasi != quasi_p).sum()),
              int((response != response_p).sum())))
    log('{}: quasi and response maps == the same path with {}, bit for bit; '
        'dense max abs diff {:.3g} m'.format(
            name, plain.__name__, float((dense - dense_p).abs().max())))


def stage_times(name, pipe, req, device):
    """Where a request's time goes, stage by stage (host clock around each
    stage, synchronized; one more request after the counted ones)."""
    from rcfd_tpu_torch.pipeline import serving_numerics

    image, points, valid = req
    with torch.inference_mode(), serving_numerics():
        t0 = time.perf_counter()
        image_t, crops, xs, zs = pipe.radarnet_stage(image, points)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        maps = pipe.scatter(crops, xs, zs,
                            torch.from_numpy(valid).to(device), H, W,
                            pipe.radarnet.input_patch_size_image)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _, _, input_depth = pipe.bridge(*maps)
        pipe.fusionnet(image_t, input_depth)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    stage_ms = dict(radarnet=(t1 - t0) * 1e3, scatter=(t2 - t1) * 1e3,
                    bridge_fusionnet=(t3 - t2) * 1e3)
    log('{}: stage ms (host clock, synchronized): {}'.format(
        name, ', '.join('{} {:.2f}'.format(k, v)
                        for k, v in stage_ms.items())))
    if PROFILE:
        profile_request(name, pipe, req)


def crops_of(pipe, req):
    from rcfd_tpu_torch.pipeline import serving_numerics

    with torch.inference_mode(), serving_numerics():
        return pipe.radarnet_stage(*req[:2])[1]


def phase_slice(device, record, rn, fn, reqs):
    from rcfd_tpu_torch.ops import scatter_cuda as sc
    from rcfd_tpu_torch.pipeline import TwoStagePipeline, serving_numerics

    with serving_numerics():
        b, m = torch.backends.cudnn, torch.backends.cuda.matmul
        log('slice: the pipeline serves with TF32 {} for convolutions and '
            '{} for matmuls; cuDNN benchmark mode {}, deterministic {}'
            .format('on' if b.allow_tf32 else 'off',
                    'on' if m.allow_tf32 else 'off', b.benchmark,
                    b.deterministic))
    pipe = TwoStagePipeline(rn, fn, H, W, device=device)
    outs, _, _, launches = serve_path(
        'slice', pipe, reqs, device,
        {'scatter_quasi_dense': N_REQUESTS, 'fused_skip_gather_add': 0,
         'column_crop': 0})
    record['scatter_quasi_dense']['launches'] = \
        launches['scatter_quasi_dense']
    check_plain_route('slice', pipe, reqs[1], outs[0], pipe, 'scatter',
                      sc.scatter_quasi_dense_plain)
    check_codec_encode(rn, fn, reqs[1], outs[0], device)
    stage_times('slice', pipe, reqs[1], device)
    return pipe


def check_codec_encode(rn, fn, req, out, device):
    """One request of the slice built with codec_encode=True: its three
    uint16 outputs on the card must equal floor(x * 256), floor(x * 256)
    and floor(x * 2^14) of the float outputs ``out`` of the same
    request."""
    from rcfd_tpu_torch.pipeline import TwoStagePipeline

    codes = TwoStagePipeline(rn, fn, H, W, codec_encode=True,
                             device=device)(*req)
    for label, c, f, m in zip(('dense', 'quasi', 'response'), codes, out,
                              (256.0, 256.0, 2.0 ** 14)):
        check(c.dtype == torch.uint16 and c.device == f.device,
              'codec_encode: {} is {} on {}'.format(label, c.dtype,
                                                    c.device))
        got = c.cpu().numpy().astype(np.int64)
        want = np.floor(f.cpu().numpy().astype(np.float64) * m).astype(
            np.int64)
        check(np.array_equal(got, want), 'codec_encode: {} codes differ '
              'from floor(x * {:g}) at {} pixels'.format(
                  label, m, int((got != want).sum())))
    log('slice, codec_encode=True: uint16 dense, quasi and response on the '
        'card == floor(x * 256), floor(x * 256), floor(x * 2^14) of the '
        'float outputs, bit for bit')


def phase_fused(device, record, slice_pipe, reqs):
    """Path A: RadarNet's 1/2- and 1/4-scale pools deferred into deconv1
    and deconv2, which run the fused skip gather-add."""
    from rcfd_tpu_torch.nn.perf import PerfConfig
    from rcfd_tpu_torch.ops import fused_skip as fs
    from rcfd_tpu_torch.pipeline import TwoStagePipeline

    rn = radarnet_like(slice_pipe.radarnet, device, perf=PerfConfig(
        fused_pool2=True, fused_pool4=True))
    pipe = TwoStagePipeline(rn, slice_pipe.fusionnet, H, W, device=device)
    outs, _, _, launches = serve_path(
        'fused', pipe, reqs, device,
        {'scatter_quasi_dense': N_REQUESTS,
         'fused_skip_gather_add': 2 * N_REQUESTS, 'column_crop': 0})
    record['fused_skip_gather_add']['launches'] = \
        launches['fused_skip_gather_add']
    check_plain_route('fused', pipe, reqs[1], outs[0], fs,
                      'fused_skip_gather_add',
                      fs.fused_skip_gather_add_plain)
    # the JAX package's own tolerance for this fusion
    # (tests/test_fused_skip.py): float32 sums in another order
    err = float((crops_of(pipe, reqs[1]) -
                 crops_of(slice_pipe, reqs[1])).abs().max())
    check(err <= 5e-4, 'fused: RadarNet crops differ from the slice\'s by '
          '{} > 5e-4'.format(err))
    log('fused: RadarNet crops vs the slice\'s (pools not deferred): max abs '
        'err {:.3g} (tolerance 5e-4)'.format(err))
    stage_times('fused', pipe, reqs[1], device)


def phase_wide(device, record, slice_pipe, reqs):
    """Path B: RadarNet at a 900x300 patch, whose 1/8, 1/16 and 1/32 pools
    take the variable-bin branch through the column crop kernel."""
    from rcfd_tpu_torch.ops import crop_cuda as cc
    from rcfd_tpu_torch.ops import roi_pool
    from rcfd_tpu_torch.pipeline import TwoStagePipeline

    rn = radarnet_like(slice_pipe.radarnet, device,
                       input_patch_size_image=WIDE_PATCH)
    pipe = TwoStagePipeline(rn, slice_pipe.fusionnet, H, W, device=device)
    outs, _, _, launches = serve_path(
        'wide', pipe, reqs, device,
        {'scatter_quasi_dense': N_REQUESTS, 'fused_skip_gather_add': 0,
         'column_crop': 3 * N_REQUESTS})
    record['column_crop']['launches'] = launches['column_crop']
    check_plain_route('wide', pipe, reqs[1], outs[0], roi_pool,
                      'batch_column_crop', cc.batch_column_crop_plain)
    stage_times('wide', pipe, reqs[1], device)


# the JAX package's tolerance for the fold (tests/test_optimize.py): float32
# products of the folded weights round differently from batch norm after
# the conv
FOLD_TOL = 1e-4
PAIRED_ROUNDS = 10


def radarnet_outputs(pipe, req):
    """RadarNet's crops (K, ph, pw) and the padded x of each point."""
    from rcfd_tpu_torch.pipeline import serving_numerics

    with torch.inference_mode(), serving_numerics():
        _, crops, xs, _ = pipe.radarnet_stage(*req[:2])
    return crops, xs


def unexplained_quasi(crops, xs, valid, pixels, tol):
    """The pixels (row, col) of ``pixels`` whose quasi depth a perturbation
    of the crops by at most ``tol`` cannot change: the top response there
    is farther than ``tol`` from the 0.5 threshold, and the top two are
    farther apart than one 2^-14 step plus 2 * tol (so K1's 14-bit max
    keeps its winner)."""
    from rcfd_tpu_torch.ops import scatter_cuda as sc

    k, ph, pw = crops.shape
    x_start = sc.point_tables(torch.as_tensor(xs), torch.zeros(k),
                              torch.as_tensor(valid), pw, W)[0].numpy()
    out = []
    for r, c in pixels:
        j = c + pw - x_start
        hit = np.flatnonzero(valid & (j >= 0) & (j < pw))
        vals = np.sort(crops[hit, r - (H - ph), j[hit]].astype(
            np.float64))[::-1]
        near_threshold = len(vals) and abs(vals[0] - 0.5) <= tol
        tie = len(vals) > 1 and vals[0] - vals[1] <= 2.0 ** -14 + 2 * tol
        if not (near_threshold or tie):
            out.append((int(r), int(c)))
    return out


def fold_deviation(name, pipe, ref_pipe, req):
    """The folded path against the unfolded one on the same request: crops
    within FOLD_TOL; the share of quasi pixels that differ, each explained
    by a top response within FOLD_TOL of the threshold or a 14-bit tie;
    dense max and median abs difference."""
    crops, xs = radarnet_outputs(pipe, req)
    crops_ref, _ = radarnet_outputs(ref_pipe, req)
    err = float((crops - crops_ref).abs().max())
    check(err <= FOLD_TOL, '{}: RadarNet crops differ from the unfolded '
          'path\'s by {} > {}'.format(name, err, FOLD_TOL))
    dense, quasi, _ = pipe(*req)
    dense_ref, quasi_ref, _ = ref_pipe(*req)
    pixels = torch.nonzero(quasi != quasi_ref).cpu().numpy()
    bad = unexplained_quasi(crops_ref.cpu().numpy(), xs.cpu().numpy(),
                            req[2], pixels, FOLD_TOL)
    check(not bad, '{}: quasi depth differs from the unfolded path at {} '
          'pixels no tie or threshold explains: {}'.format(
              name, len(bad), bad[:10]))
    diff = (dense - dense_ref).abs()
    log('{}: deviation from the unfolded path: crops max abs {:.3g} '
        '(tolerance {:g}); quasi pixels that differ {} of {} ({:.3g}%), '
        'each at a 14-bit tie or within {:g} of the 0.5 threshold; dense '
        'max abs {:.3g} m, median abs {:.3g} m'.format(
            name, err, FOLD_TOL, len(pixels), quasi.numel(),
            100.0 * len(pixels) / quasi.numel(), FOLD_TOL,
            float(diff.max()), float(diff.median())))


def paired_times(pipes, reqs, rounds):
    """Serve every pipeline of ``pipes`` the same request in each round, in
    an order that rotates from round to round; print each one's median
    ms/frame and the median of its per-round difference from the first,
    and its largest peak of device memory above what was allocated before
    the request."""
    names = list(pipes)
    times = {name: [] for name in names}
    peaks = {name: 0 for name in names}
    for i in range(rounds):
        req = reqs[i % len(reqs)]
        for name in names[i % len(names):] + names[:i % len(names)]:
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            pipes[name](*req)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            peaks[name] = max(peaks[name],
                              torch.cuda.max_memory_allocated() - resident)
    base = names[0]
    for name in names:
        line = ('paired: {} ms/frame median {:.2f} over {} rounds ({}); '
                'request peak {} bytes above resident').format(
            name, float(np.median(times[name])), rounds,
            ', '.join('{:.2f}'.format(t) for t in times[name]),
            peaks[name])
        if name != base:
            d = np.subtract(times[name], times[base])
            line += '; minus {}: median {:+.2f} ms, {} of {} rounds ' \
                'lower'.format(base, float(np.median(d)), int((d < 0).sum()),
                               rounds)
        log(line)


def with_batch_norm_statistics(model, seed):
    """A copy of ``model`` whose batch norms have statistics drawn from
    ``seed`` near the identity (weight and running variance in [0.9, 1.1],
    bias and running mean N(0, 0.02)), so that folding them changes the
    weights; init_parameters leaves every batch norm the identity."""
    from rcfd_tpu_torch.nn import BatchNorm2d

    model = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, BatchNorm2d):
                n = bn.weight.numel()
                for t, draw in ((bn.weight, torch.rand),
                                (bn.bias, torch.randn),
                                (bn.running_mean, torch.randn),
                                (bn.running_var, torch.rand)):
                    x = draw(n, generator=gen)
                    x = 0.9 + 0.2 * x if draw is torch.rand else 0.02 * x
                    t.copy_(x.to(t.device))
    return model


def phase_optimize(device, slice_pipe, reqs):
    """The slice and fused paths with batch norm folded
    (TwoStagePipeline(optimize=True)), from the slice's weights with batch
    norm statistics drawn near the identity: launches, outputs and the
    plain-route check as in the other paths, the deviation from the
    unfolded paths on the same weights, then interleaved, paired requests
    of slice, optimize, fused and optimize+fused (all four on those
    weights)."""
    from rcfd_tpu_torch.nn import Conv2d
    from rcfd_tpu_torch.nn.perf import PerfConfig
    from rcfd_tpu_torch.ops import fused_skip as fs
    from rcfd_tpu_torch.ops import scatter_cuda as sc
    from rcfd_tpu_torch.pipeline import TwoStagePipeline

    rn, fn = (with_batch_norm_statistics(m, SEED + 4 + i)
              for i, m in enumerate((slice_pipe.radarnet,
                                     slice_pipe.fusionnet)))
    rn_fused = radarnet_like(rn, device, perf=PerfConfig(fused_pool2=True,
                                                         fused_pool4=True))
    base = TwoStagePipeline(rn, fn, H, W, device=device)
    fused = TwoStagePipeline(rn_fused, fn, H, W, device=device)
    opt = TwoStagePipeline(rn, fn, H, W, optimize=True, device=device)
    opt_fused = TwoStagePipeline(rn_fused, fn, H, W, optimize=True,
                                 device=device)

    def batch_norms(*models):
        return sum(m.batch_norm is not None for model in models
                   for m in model.modules() if isinstance(m, Conv2d))
    n_bn = batch_norms(rn, fn)
    check(n_bn > 0 and batch_norms(opt.radarnet, opt.fusionnet,
                                   opt_fused.radarnet) == 0,
          'optimize: batch norms left after the fold')
    check(batch_norms(rn, fn) == n_bn, 'optimize: the fold changed the '
          "caller's models")
    log('optimize: {} batch norms folded into their convolutions; the '
        "caller's models keep theirs".format(n_bn))
    outs, _, _, _ = serve_path('optimize', opt, reqs, device,
                               {'scatter_quasi_dense': N_REQUESTS})
    check_plain_route('optimize', opt, reqs[1], outs[0], opt, 'scatter',
                      sc.scatter_quasi_dense_plain)
    stage_times('optimize', opt, reqs[1], device)
    outs, _, _, _ = serve_path(
        'optimize+fused', opt_fused, reqs, device,
        {'scatter_quasi_dense': N_REQUESTS,
         'fused_skip_gather_add': 2 * N_REQUESTS})
    check_plain_route('optimize+fused', opt_fused, reqs[1], outs[0], fs,
                      'fused_skip_gather_add',
                      fs.fused_skip_gather_add_plain)
    stage_times('optimize+fused', opt_fused, reqs[1], device)
    for pipe in (base, fused):
        pipe(*reqs[0])  # warm-up requests of the unfolded paths
    fold_deviation('optimize', opt, base, reqs[1])
    fold_deviation('optimize+fused', opt_fused, fused, reqs[1])
    paired_times({'slice': base, 'optimize': opt, 'fused': fused,
                  'optimize+fused': opt_fused}, reqs[1:], PAIRED_ROUNDS)


def profile_request(name, pipe, req):
    """torch.profiler over one request: device time by kernel name, and the
    device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(*req)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    # device kernels only (CUPTI's own buffer records are not work)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in
            ('Buffer Flush', 'Activity Buffer Request')]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total_us = sum(e.self_device_time_total for e in rows)
    log('{} profile: wall {:.2f} ms, device kernels {:.2f} ms ({:.1f}% busy)'
        .format(name, wall_ms, total_us / 1e3,
                100.0 * total_us / 1e3 / wall_ms))
    for e in rows[:25]:
        log('{} profile: {:9.3f} ms {:6d} calls  {}'.format(
            name, e.self_device_time_total / 1e3, e.count, e.key[:110]))


def gpu_name_and_power():
    proc = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, 'nvidia-smi failed: {}'.format(proc.stderr))
    return proc.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; this script runs on '
                         'the card only')
    import_port()
    device = torch.device('cuda:0')
    log('torch {} cuda {} python {}; device {}'.format(
        torch.__version__, torch.version.cuda, sys.version.split()[0],
        torch.cuda.get_device_name(0)))
    record = {}

    with Phase('build'):
        from rcfd_tpu_torch.ops import _build
        from rcfd_tpu_torch.ops import crop_cuda as cc
        from rcfd_tpu_torch.ops import fused_skip as fs
        from rcfd_tpu_torch.ops import fused_skip_variants as fv
        from rcfd_tpu_torch.ops import scatter_cuda as sc
        sources = [m.SOURCE for m in (sc, fs, cc, fv)]
        t0 = time.perf_counter()
        _build.load_libraries(sources)
        for m in (sc, fs, cc, fv):
            m._kernel()
        log('built {} in {:.2f} s, one nvcc each, started together'.format(
            ', '.join(sources), time.perf_counter() - t0))
        for source in sources:
            log('  {}: {:.2f} s from its start until collected'.format(
                source, _build.BUILD_SECONDS.get(source, float('nan'))))
            for line in _build.BUILD_LOGS.get(source, '').splitlines():
                log('  nvcc: ' + line)
    # one set of weights for every full-width phase (no configuration of
    # the smoke changes a parameter's shape), and one set of requests
    rn, fn = build_models(RADARNET, FUSIONNET, device, SEED)
    reqs = requests(np.random.default_rng(SEED), N_REQUESTS + 1, H, W, K,
                    N_INVALID)
    with Phase('kernel'):
        phase_kernel_scatter(device, record)
        phase_kernel_fused_skip(device, record, rn)
        phase_kernel_column_crop(device, record, rn)
        torch.cuda.empty_cache()
    with Phase('variants'):
        phase_variants(device, record, rn)
        torch.cuda.empty_cache()
    with Phase('reference'):
        phase_reference(device)
    with Phase('slice'):
        slice_pipe = phase_slice(device, record, rn, fn, reqs)
    with Phase('fused'):
        phase_fused(device, record, slice_pipe, reqs)
    with Phase('wide'):
        phase_wide(device, record, slice_pipe, reqs)
    with Phase('optimize'):
        phase_optimize(device, slice_pipe, reqs)

    kernels = list(record.values())
    check(all(k['launches'] for k in kernels),
          'a kernel of a path was not launched: {}'.format(kernels))
    log(gpu_name_and_power())
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
