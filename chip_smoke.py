#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rcfd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printed as it starts and ends:

  build      compile the hand-written CUDA kernels with nvcc, one process
             per source, all started together
  kernel     hold each kernel against its plain PyTorch version on the card
             at the shapes of the serving paths, bit for bit, and time the
             kernel, the plain version and the nearest one-call PyTorch
             operator; the scatter also over a batch of 16 frames in one
             launch, beside 16 single-frame launches; then the same for the
             bf16 instances of the three serving kernels (bf16 serving)
  variants   the fused skip gather-add's variants (K3 and four that split
             its time: rcfd_tpu_torch.tools.fusepall_exp) at deconv1's and
             deconv2's shapes, in float32 and bf16, each against its plain
             version bit for bit, timed against its byte bound
  reference  small configurations on the card against the same port on
             the CPU, stage by stage (the canonical one, one with RadarNet's
             deferred skip pools, one at a patch width that is not a
             multiple of 32), in float32 and in bf16
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
  batched    TwoStagePipeline.forward_batched on the slice's weights: B = 8
             (one decode chunk) and 16 (two), B = 16 with optimize=True, and
             B = 2 in two decode chunks with the deferred pools (fused) and
             at the 900x300 patch (wide); each frame against __call__ of
             the same frame; ms per request, frames/s and peak memory;
             paired rounds of one B = 8 request against 8 single-frame
             requests; then FusionNet alone at the benchmark config with
             batch norm folded, float32, at b = 1, 8 and 32, from integer
             transport inputs
  bf16       TwoStagePipeline(compute_dtype=torch.bfloat16) on the same
             weights: the slice, fused and wide paths (only the kernels'
             bf16 instances launched), each held to the kernels' plain
             versions and its deviation from the float32 path of the same
             requests printed; forward_batched at B = 8 and, folded, at
             B = 16, each frame against __call__; paired rounds of bf16
             against float32 slice requests; B = 2 in two decode chunks
             with the deferred pools and at the 900x300 patch, as in
             batched; FusionNet alone in bf16

Each path phase (and each configuration of the batched phase) sets every
kernel's launch count to 0 before its counted requests, reads them after,
and fails unless each kernel of its path was launched as often as its
requests need and every other kernel not at all. A kernel's entry of the
kernels line sums the counts read after each path that launched it
(``launches_by_path``); the scatter has one count for its two entries,
one frame a launch (slice) and a batch a launch (batched).

Then a line with the card's name and power limit, a line
{"kernels": [...]} and, last, {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero and prints no result; so does a
machine without a CUDA device, or a directory that lacks the package.
It imports torch, numpy and rcfd_tpu_torch only.

The models run under the pipeline's own numerics
(rcfd_tpu_torch.pipeline.serving_numerics: float32 with TF32 off, cuDNN
algorithms autotuned among deterministic ones; bf16 where the bf16 phase
asks for it with compute_dtype), as a caller gets them;
the script sets no backend flag of its own. With --profile each path
phase also traces one request with torch.profiler and prints the device
time by kernel.
"""

import copy
import json
import math
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


def scatter_bound_bytes(x_start, valid, ph, pw, w, crop_bytes=4):
    """Bytes the scatter must move for these inputs: the crop elements that
    land in the frame for the valid points (read once, ``crop_bytes``
    each), the three (K,) int32 tables, and the two (ph, w) float32 maps
    (written once)."""
    lo = np.maximum(x_start - pw, 0)
    hi = np.minimum(x_start, w)
    cols = np.where(valid > 0, np.maximum(hi - lo, 0), 0)
    return crop_bytes * ph * int(cols.sum()) + 3 * 4 * len(x_start) + \
        2 * 4 * ph * w


def dtype_label(dtype):
    """'' for float32, ' bf16' for bf16: the suffix of a kernel instance's
    name in the kernels line."""
    return ' bf16' if dtype == torch.bfloat16 else ''


def scatter_kernel_check(device, patch, dtype=torch.float32):
    """The scatter kernel's instance for crops of ``dtype`` against its
    plain version at ``patch``, bit for bit: (args, max abs err)."""
    from rcfd_tpu_torch.ops import scatter_cuda as sc

    crops, xs, zs, valid = scatter_inputs(np.random.default_rng(SEED),
                                          device, patch)
    args = (crops.to(dtype), xs, zs, valid, H, W, patch)
    d_k, r_k = sc.scatter_quasi_dense(*args)
    d_p, r_p = sc.scatter_quasi_dense_plain(*args)
    torch.cuda.synchronize()
    err = max(float((d_k - d_p).abs().max()), float((r_k - r_p).abs().max()))
    label = 'scatter{}'.format(dtype_label(dtype))
    check(torch.equal(d_k, d_p) and torch.equal(r_k, r_p),
          '{} kernel differs from its plain version at patch {}: max abs '
          'err {}'.format(label, patch, err))
    check(int((r_k > 0).sum()) > 0, 'scatter produced an empty map')
    log('{} kernel == plain version at patch {}x{}, bit for bit (tolerance '
        '0); {} covered pixels'.format(label, patch[0], patch[1],
                                       int((r_k > 0).sum())))
    return args, err


def scatter_times(device, patch, dtype=torch.float32):
    """The scatter kernel's instance for ``dtype`` crops at ``patch``,
    checked against its plain version, then timed: (max abs err, kernel ms
    (median of 20), plain ms (of 5), scatter_reduce_ ms (of 20), bound ms,
    bytes)."""
    from rcfd_tpu_torch.ops import scatter_cuda as sc

    ph, pw = patch
    args, err = scatter_kernel_check(device, patch, dtype)
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
                                 ph, pw, W, crops.element_size())
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log('scatter{} at K={} crops {}x{} w={}, device time: kernel {:.4f} ms '
        '(median of 20), plain {:.4f} ms, scatter_reduce_ {:.4f} ms, bound '
        '{:.4f} ms ({} bytes at {:.3g} B/s), {:.1f}% of the bound'.format(
            dtype_label(dtype), K, ph, pw, W, ms, plain_ms, library_ms,
            bound_ms, nbytes, HBM_BYTES_PER_S, 100 * bound_ms / ms))
    return err, ms, plain_ms, library_ms, bound_ms, nbytes


def phase_kernel_scatter(device, record, dtype=torch.float32):
    err, ms, plain_ms, library_ms, bound_ms, nbytes = scatter_times(
        device, PATCH, dtype)
    # the variable-bin path serves 300-wide crops
    wide = scatter_times(device, WIDE_PATCH, dtype)
    name = 'scatter_quasi_dense' + dtype_label(dtype)
    record[name] = dict(
        name=name, route='cuda',
        source='rcfd_tpu_torch/csrc/scatter_quasi_dense.cu',
        replaces='rcfd_tpu/ops/scatter_pallas.py:42',
        launches=None, max_abs_err=max(err, wide[0]), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by='bytes',
        library_ms=library_ms,
        wide=dict(zip(('max_abs_err', 'ms', 'plain_ms', 'library_ms',
                       'bound_ms', 'bytes'), wide)),
        batched=scatter_batched_times(device, nbytes, dtype))


BATCH_K1 = 16


def scatter_batched_times(device, single_bytes, dtype=torch.float32):
    """The scatter over BATCH_K1 frames at PATCH in one launch, crops of
    ``dtype``: frame 0 the single-frame timing's inputs, frames 1 .. B-2
    scatter_inputs' hard cases from other seeds, the last frame the hard
    cases with every point invalid. Held against its batched plain version
    and against the single-frame kernel frame by frame, bit for bit, then
    timed (median of 20) beside B single-frame launches, the batched plain
    version, one batched scatter_reduce_ on precomputed keys and the bound
    of this data's bytes."""
    from rcfd_tpu_torch.ops import scatter_cuda as sc

    ph, pw = PATCH
    frames = [scatter_inputs(np.random.default_rng(
        SEED if f == 0 else SEED + 10 + f), device) for f in range(BATCH_K1)]
    frames[-1] = frames[-1][:3] + (torch.zeros_like(frames[-1][3]),)
    crops, xs, zs, valid = [torch.stack([f[i] for f in frames])
                            for i in range(4)]
    crops = crops.to(dtype)
    del frames
    args = (crops, xs, zs, valid, H, W, PATCH)
    d_k, r_k = sc.scatter_quasi_dense_batched(*args)
    d_p, r_p = sc.scatter_quasi_dense_batched_plain(*args)
    torch.cuda.synchronize()
    err = max(float((d_k - d_p).abs().max()), float((r_k - r_p).abs().max()))
    label = 'batched scatter{}'.format(dtype_label(dtype))
    check(torch.equal(d_k, d_p) and torch.equal(r_k, r_p),
          '{} kernel differs from its plain version: max abs err {}'.format(
              label, err))
    del d_p, r_p
    singles = [(crops[f], xs[f], zs[f], valid[f], H, W, PATCH)
               for f in range(BATCH_K1)]
    for f, single in enumerate(singles):
        d_f, r_f = sc.scatter_quasi_dense(*single)
        check(torch.equal(d_k[f], d_f) and torch.equal(r_k[f], r_f),
              '{} frame {} differs from the single-frame kernel'.format(
                  label, f))
    check(int((r_k[-1] > 0).sum()) == 0 and int((r_k[0] > 0).sum()) > 0,
          '{}: the all-invalid frame is not empty, or frame 0 is'.format(
              label))
    log('{} at B={} K={} crops {}x{} w={}: kernel == batched plain version, '
        'bit for bit (tolerance 0), and == the single-frame kernel in every '
        'frame; frame {} has no valid point'.format(
            label, BATCH_K1, K, ph, pw, W, BATCH_K1 - 1))
    del d_k, r_k
    ms = device_ms(lambda: sc.scatter_quasi_dense_batched(*args), 20)
    singles_ms = device_ms(
        lambda: [sc.scatter_quasi_dense(*single) for single in singles], 20)
    plain_ms = device_ms(
        lambda: sc.scatter_quasi_dense_batched_plain(*args), 5, 1)
    x_start, valid_i, _ = sc.point_tables(xs, zs, valid, pw, W)
    keys = sc.packed_keys(crops, valid_i).permute(0, 2, 1, 3).reshape(
        BATCH_K1, ph, -1)
    cols = sc.window_columns(x_start, pw).reshape(BATCH_K1, 1, -1).expand(
        -1, ph, -1).contiguous()
    packed = torch.zeros((BATCH_K1, ph, W + 2 * pw), dtype=torch.int32,
                         device=device)
    library_ms = device_ms(
        lambda: packed.scatter_reduce_(2, cols, keys, 'amax'), 20)
    del keys, cols, packed
    x_start, valid_i = x_start.cpu().numpy(), valid_i.cpu().numpy()
    nbytes = sum(scatter_bound_bytes(x_start[f], valid_i[f], ph, pw, W,
                                     crops.element_size())
                 for f in range(BATCH_K1))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    all_valid_ms = BATCH_K1 * single_bytes / HBM_BYTES_PER_S * 1e3
    log('{} at B={} K={} crops {}x{} w={}, device time: one launch {:.4f} '
        'ms (median of 20), {} single-frame launches {:.4f} ms, batched '
        'plain {:.4f} ms, batched scatter_reduce_ {:.4f} ms; bound {:.4f} '
        'ms ({} bytes of this data at {:.3g} B/s; {:.4f} ms for {} frames '
        'of the single-frame bytes), {:.1f}% of the bound'.format(
            label, BATCH_K1, K, ph, pw, W, ms, BATCH_K1, singles_ms,
            plain_ms, library_ms, bound_ms, nbytes, HBM_BYTES_PER_S,
            all_valid_ms, BATCH_K1, 100 * bound_ms / ms))
    return dict(frames=BATCH_K1, max_abs_err=err, ms=ms,
                single_frame_launches_ms=singles_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bytes=nbytes)


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


def row_tile_geometry(dtype, rows, stride, n_images):
    """The launch geometry of a bf16 row-tile kernel (rows a block stages,
    its shared-memory bytes, blocks: ops/fused_skip.py::row_tile); {} for
    float32, whose kernels stage nothing."""
    from rcfd_tpu_torch.ops.fused_skip import row_tile

    if dtype != torch.bfloat16:
        return {}
    tile_rows, smem_bytes, blocks = row_tile(rows, stride, n_images)
    return dict(tile_rows=tile_rows, smem_bytes=smem_bytes, blocks=blocks)


def describe_tiles(tiles):
    if not tiles:
        return ''
    return ', {tile_rows}-row tiles of {smem_bytes} bytes of shared ' \
        'memory, {blocks} blocks of 256 threads'.format(**tiles)


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


def phase_kernel_fused_skip(device, record, rn, dtype=torch.float32):
    """The fused skip gather-add's instance for ``dtype`` (a and cg; the
    corrections are float32) at deconv1's and deconv2's shapes of the
    900x288 patch (64 windows of one frame), against its plain version."""
    from rcfd_tpu_torch.ops import fused_skip as fs

    rng = np.random.default_rng(SEED + 2)
    t = lambda a, d=dtype: torch.from_numpy(a).to(device, d)  # noqa: E731
    label = 'fused skip{}'.format(dtype_label(dtype))
    parts = []
    for block, co, ph, pw, wg in fused_skip_shapes(rn, device):
        a = t(rng.standard_normal((K, co, ph, pw), dtype=np.float32))
        cg = t(rng.standard_normal((1, co, ph, wg), dtype=np.float32))
        starts = rng.integers(0, wg - pw + 1, (1, K)).astype(np.int32)
        starts[0, :2] = [0, wg - pw]
        corr_l = t(rng.standard_normal((K, co, ph), dtype=np.float32),
                   torch.float32)
        corr_r = t(rng.standard_normal((K, co, ph), dtype=np.float32),
                   torch.float32)
        args = (a, cg, t(starts, torch.int32), corr_l, corr_r)
        out = fs.fused_skip_gather_add(*args)
        ref = fs.fused_skip_gather_add_plain(*args)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        check(torch.equal(out, ref), '{} kernel differs from its plain '
              'version at {}: max abs err {}'.format(label, block, err))
        del out, ref
        ms = device_ms(lambda: fs.fused_skip_gather_add(*args), 20)
        plain_ms = device_ms(lambda: fs.fused_skip_gather_add_plain(*args),
                             5, 1)
        nbytes = a.element_size() * (2 * a.numel() + cg.numel()) + \
            4 * (2 * corr_l.numel() + K)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        tiles = row_tile_geometry(dtype, co * ph, wg, 1)
        log('{} at {}: a {} cg {}, kernel == plain version, bit for bit '
            '(tolerance 0); device time: kernel {:.4f} ms (median of 20), '
            'plain {:.4f} ms, bound {:.4f} ms ({} bytes at {:.3g} B/s), '
            'kernel at {:.1f} GB/s{}; one-call PyTorch yardstick: none (no '
            'one call adds windows of one tensor with the boundary '
            'corrections)'.format(
                label, block, tuple(a.shape), tuple(cg.shape), ms,
                plain_ms, bound_ms, nbytes, HBM_BYTES_PER_S,
                nbytes / ms * 1e-6, describe_tiles(tiles)))
        parts.append(dict(shape=block, a=list(a.shape), cg=list(cg.shape),
                          max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bytes=nbytes,
                          gb_per_s=nbytes / ms * 1e-6, **tiles))
        del args, a, cg, corr_l, corr_r
    name = 'fused_skip_gather_add' + dtype_label(dtype)
    record[name] = kernel_entry(
        name, 'rcfd_tpu_torch/csrc/fused_skip_gather_add.cu',
        'rcfd_tpu/ops/fused_skip.py:174', parts, library=False)


def phase_kernel_column_crop(device, record, rn, dtype=torch.float32):
    """The column crop's instance for ``dtype`` rows at the 1/8, 1/16 and
    1/32 pools of the 900x300 patch (the variable-bin ones; 64 windows of
    one frame), against its plain version, with torch.gather on the padded
    rows as the yardstick."""
    from rcfd_tpu_torch.ops import crop_cuda as cc
    from rcfd_tpu_torch.ops.roi_pool import variable_bin_window

    maps = encoder_maps(rn, WIDE_PATCH, device)
    rng = np.random.default_rng(SEED + 3)
    label = 'column crop{}'.format(dtype_label(dtype))
    parts = []
    for i in (2, 3, 4):
        c, w_f = maps[i][1], maps[i][3]
        ph, pw = int(H * SCALES[i]), int(WIDE_PATCH[1] * SCALES[i])
        _, win = variable_bin_window(WIDE_PATCH[1], SCALES[i], pw)
        rows = torch.from_numpy(rng.standard_normal(
            (1, c, ph, w_f), dtype=np.float32)).to(device, dtype)
        starts = rng.integers(0, w_f + 1, (1, K)).astype(np.int32)
        starts[0, :2] = [0, w_f]  # the first column, and wholly past W
        starts = torch.from_numpy(starts).to(device)
        out = cc.batch_column_crop(rows, starts, win)
        ref = cc.batch_column_crop_plain(rows, starts, win)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        check(torch.equal(out, ref), '{} kernel differs from its plain '
              'version at 1/{}: max abs err {}'.format(
                  label, int(1 / SCALES[i]), err))
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
        # the write-only floor: PyTorch filling a tensor of the output's
        # bytes, the most of the kernel's work (the rows are 3-9% of it)
        fill = torch.empty_like(out)
        write_ms = device_ms(fill.zero_, 20)
        nbytes = rows.element_size() * (out.numel() + rows.numel()) + 4 * K
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        tiles = row_tile_geometry(dtype, c * ph, w_f + win, 1)
        log('{} at 1/{}: rows {} -> {} windows of {}, kernel == plain '
            'version, bit for bit (tolerance 0); device time: kernel {:.4f} '
            'ms (median of 20), plain {:.4f} ms, torch.gather {:.4f} ms, '
            'bound {:.4f} ms ({} bytes at {:.3g} B/s), kernel at {:.1f} '
            'GB/s; write-only floor (zero_ of the output\'s {} bytes) {:.4f} '
            'ms{}'.format(
                label, int(1 / SCALES[i]), tuple(rows.shape), K, win, ms,
                plain_ms, library_ms, bound_ms, nbytes, HBM_BYTES_PER_S,
                nbytes / ms * 1e-6, out.numel() * out.element_size(),
                write_ms, describe_tiles(tiles)))
        parts.append(dict(shape='1/{}'.format(int(1 / SCALES[i])),
                          rows=list(rows.shape), win=win, max_abs_err=err,
                          ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          library_ms=library_ms, bytes=nbytes,
                          gb_per_s=nbytes / ms * 1e-6, write_floor_ms=write_ms,
                          **tiles))
        del out, ref, rows_p, index, fill
    name = 'column_crop' + dtype_label(dtype)
    record[name] = kernel_entry(
        name, 'rcfd_tpu_torch/csrc/column_crop.cu',
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


# bf16 RadarNet crops of one request served two ways (on the card against
# the CPU in phase reference; a frame of a batched request against __call__
# in phase bf16): within two bf16 steps in [0.5, 1), since cuDNN rounds
# bf16 convolutions at other places than the CPU, and may choose other
# algorithms at another batch size (2^-9 measured on an H100)
BF16_CROP_TOL = 2.0 ** -7
# bf16 FusionNet on the card against the CPU from the same input (phase
# reference): MAE in m (1.2e-4 m measured; the JAX package's bf16 bound,
# tests/test_bf16_serving.py, is 0.25 m)
BF16_DENSE_MAE = 0.01


def launch_counters():
    """Every launch count: name -> (wrapper, attribute). The serving
    kernels count their float32 and bf16 instances apart."""
    from rcfd_tpu_torch.ops import crop_cuda as cc
    from rcfd_tpu_torch.ops import fused_skip as fs
    from rcfd_tpu_torch.ops import fused_skip_variants as fv
    from rcfd_tpu_torch.ops import scatter_cuda as sc
    counters = {}
    for name, wrapper in (('scatter_quasi_dense', sc.scatter_quasi_dense),
                          ('fused_skip_gather_add', fs.fused_skip_gather_add),
                          ('column_crop', cc.batch_column_crop)):
        counters[name] = (wrapper, 'launches')
        counters[name + ' bf16'] = (wrapper, 'launches_bf16')
    for variant, wrapper in fv.WRAPPERS.items():
        counters['fused_skip_variants.' + variant] = (wrapper, 'launches')
    return counters


def reset_launches():
    for wrapper, attr in launch_counters().values():
        setattr(wrapper, attr, 0)


def read_launches():
    return {name: getattr(wrapper, attr)
            for name, (wrapper, attr) in launch_counters().items()}


def count_launches(record, path, launches, kernels):
    """Record the launches of ``kernels`` that ``path``'s run read, and sum
    each kernel's over the paths that launched it."""
    for kernel in kernels:
        entry = record[kernel]
        entry.setdefault('launches_by_path', {})[path] = launches[kernel]
        entry['launches'] = sum(entry['launches_by_path'].values())


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

    # the same three configurations in bf16 (compute_dtype), card against
    # CPU: crops, the bf16 scatter of the CPU's crops, FusionNet's depth
    # from the same input; only the bf16 instances launched
    for label, kw, expect in (
            ('bf16', {}, {'scatter_quasi_dense bf16': 1}),
            ('bf16 deferred pools', dict(perf=PerfConfig(fused_pool2=True,
                                                         fused_pool4=True)),
             {'scatter_quasi_dense bf16': 1, 'fused_skip_gather_add bf16': 2}),
            ('bf16 patch 96x76', dict(input_patch_size_image=(96, 76)),
             {'scatter_quasi_dense bf16': 1, 'column_crop bf16': 3})):
        rn_c = RadarNetModel(**dict(rn_kw, **kw), device='cpu')
        rn_c.load_state_dict(rn.state_dict(), strict=True)
        pipes = [TwoStagePipeline(rn_c, fn, h, w, device=d,
                                  compute_dtype=torch.bfloat16)
                 for d in ('cpu', device)]
        p = pipes[0].radarnet.input_patch_size_image
        with torch.inference_mode(), serving_numerics():
            image_c, crops_c, xs, zs = pipes[0].radarnet_stage(image, points)
            reset_launches()
            crops_g = pipes[1].radarnet_stage(image, points)[1]
            v = torch.from_numpy(valid)
            maps_c = sc.scatter_quasi_dense(crops_c, xs, zs, v, h, w, p)
            maps_g = sc.scatter_quasi_dense(crops_c.to(device),
                                            xs.to(device), zs.to(device),
                                            v.to(device), h, w, p)
            launches = read_launches()
            _, _, input_depth = pipes[0].bridge(*maps_c)
            dense_c = pipes[0].fusionnet(image_c, input_depth).float()
            dense_g = pipes[1].fusionnet(image_c.to(device),
                                         input_depth.to(device)).float()
        for kernel, n in launches.items():
            check(n == expect.get(kernel, 0), 'reference, {}: {} launched {} '
                  'times, expected {}'.format(label, kernel, n,
                                              expect.get(kernel, 0)))
        check(crops_g.dtype == torch.bfloat16 and all(
            torch.equal(a.cpu(), b) for a, b in zip(maps_g, maps_c)),
              'reference, {}: the bf16 scatter on the card differs from the '
              'CPU path'.format(label))
        crop_err = float((crops_g.cpu().float() - crops_c.float()).abs()
                         .max())
        check(crop_err <= BF16_CROP_TOL, 'reference, {}: RadarNet crops '
              'card vs CPU max abs err {} > {}'.format(label, crop_err,
                                                       BF16_CROP_TOL))
        mae = float((dense_g.cpu() - dense_c).abs().mean())
        check(mae <= BF16_DENSE_MAE, 'reference, {}: FusionNet depth card vs '
              'CPU MAE {} m > {} m'.format(label, mae, BF16_DENSE_MAE))
        log('reference, {}: RadarNet crops card vs CPU max abs err {:.3g} '
            '(tolerance {:g}); bf16 scatter on the card == CPU path, bit for '
            'bit; FusionNet depth from the same input card vs CPU MAE {:.3g} '
            'm, max abs {:.3g} m (tolerance MAE {:g} m); launches {}'.format(
                label, crop_err, BF16_CROP_TOL, mae,
                float((dense_g.cpu() - dense_c).abs().max()), BF16_DENSE_MAE,
                {k: n for k, n in launches.items() if n}))


def serve_path(name, pipe, reqs, device, expect, batched=False):
    """Serve the warm-up request, then the counted ones with every launch
    count set to 0 just before and read just after, through ``__call__``
    or, with ``batched``, ``forward_batched``. ``expect`` maps each kernel
    of the path to the launches it must make; every other kernel must make
    none. Checks the outputs; returns (outs, ms per request, peak memory
    bytes, launches)."""
    serve = pipe.forward_batched if batched else pipe
    serve(*reqs[0])  # warm-up request: cuDNN chooses its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device)
    reset_launches()
    outs, times = [], []
    for req in reqs[1:]:
        t0 = time.perf_counter()
        out = serve(*req)
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
    b = reqs[0][0].shape[0]
    shape = (b, h, w) if batched else (h, w)
    for dense, quasi, response in outs:
        for label, t in (('dense', dense), ('quasi', quasi),
                         ('response', response)):
            check(tuple(t.shape) == shape, '{}: {} has shape {}'.format(
                name, label, tuple(t.shape)))
            check(bool(torch.isfinite(t).all()), '{}: {} is not finite'
                  .format(name, label))
        check(float(dense.min()) >= 1.0 and float(dense.max()) <= 100.0,
              '{}: dense depth outside [1, 100] m'.format(name))
        check(float(response.min()) >= 0.0 and float(response.max()) <= 1.0,
              '{}: response outside [0, 1]'.format(name))
        check(bool((response.reshape(b, -1) > 0).any(1).all()),
              '{}: a frame with an empty quasi-dense map'.format(name))
    ms = float(np.median(times))
    log('{}: {} requests of {} frame{} at {}x{}, K={} ({} padding): ms per '
        'request {} (median {:.2f}; {:.2f} ms/frame, {:.2f} frames/s); '
        'peak memory {} bytes ({} above the {} resident before the '
        'requests); launches {}'.format(
            name, len(outs), b, 's' if b > 1 else '', h, w, K, N_INVALID,
            ', '.join('{:.2f}'.format(t) for t in times), ms, ms / b,
            b * 1e3 / ms, peak, peak - resident, resident, launches))
    log('{}: covered quasi-dense pixels per request: {}'.format(
        name, [int((o[2] > 0).sum()) for o in outs]))
    return outs, times, peak, launches


def check_plain_route(name, serve, req, out, module, attr, plain):
    """The same request through the same serving callable (a pipeline's
    ``__call__`` or ``forward_batched``) with one kernel's wrapper replaced
    by its plain version, where the path looks it up: the quasi and
    response maps must be equal bit for bit."""
    kernel = getattr(module, attr)
    setattr(module, attr, plain)
    try:
        dense_p, quasi_p, response_p = serve(*req)
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
    count_launches(record, 'slice', launches, ['scatter_quasi_dense'])
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
    count_launches(record, 'fused', launches,
                   ['scatter_quasi_dense', 'fused_skip_gather_add'])
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
    return pipe


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
    count_launches(record, 'wide', launches,
                   ['scatter_quasi_dense', 'column_crop'])
    check_plain_route('wide', pipe, reqs[1], outs[0], roi_pool,
                      'batch_column_crop', cc.batch_column_crop_plain)
    stage_times('wide', pipe, reqs[1], device)
    return pipe


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


def top_responses(crops, xs, valid, pixels):
    """For each pixel (row, col) of ``pixels``: (row, col, the crop values
    of the valid points whose windows cover it, largest first)."""
    from rcfd_tpu_torch.ops import scatter_cuda as sc

    k, ph, pw = crops.shape
    x_start = sc.point_tables(torch.as_tensor(xs), torch.zeros(k),
                              torch.as_tensor(valid), pw, W)[0].numpy()
    for r, c in pixels:
        j = c + pw - x_start
        hit = np.flatnonzero(valid & (j >= 0) & (j < pw))
        yield r, c, np.sort(crops[hit, r - (H - ph), j[hit]].astype(
            np.float64))[::-1]


def off_threshold(crops, xs, valid, pixels, tol):
    """The pixels (row, col) of ``pixels`` whose top response is farther
    than ``tol`` from the 0.5 threshold: a perturbation of the crops by at
    most ``tol`` cannot switch their response between 0 and 0.5 or
    more."""
    return [(int(r), int(c))
            for r, c, vals in top_responses(crops, xs, valid, pixels)
            if not (len(vals) and abs(vals[0] - 0.5) <= tol)]


def unexplained_quasi(crops, xs, valid, pixels, tol):
    """The pixels (row, col) of ``pixels`` whose quasi depth a perturbation
    of the crops by at most ``tol`` cannot change: the top response there
    is farther than ``tol`` from the 0.5 threshold, and the top two are
    farther apart than one 2^-14 step plus 2 * tol (so K1's 14-bit max
    keeps its winner)."""
    out = []
    for r, c, vals in top_responses(crops, xs, valid, pixels):
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


def paired_times(pipes, reqs, rounds, frames=1):
    """Serve every callable of ``pipes`` the same request in each round, in
    an order that rotates from round to round; print each one's median
    ms per request of ``frames`` frames (and frames/s when there are more
    than one) and the median of its per-round difference from the first,
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
        ms = float(np.median(times[name]))
        if frames == 1:
            line = 'paired: {} ms/frame median {:.2f}'.format(name, ms)
        else:
            line = ('paired: {} ms per request of {} frames median {:.2f} '
                    '({:.2f} frames/s)').format(name, frames, ms,
                                                frames * 1e3 / ms)
        line += (' over {} rounds ({}); request peak {} bytes above '
                 'resident').format(
            rounds, ', '.join('{:.2f}'.format(t) for t in times[name]),
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


def phase_optimize(device, record, slice_pipe, reqs):
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
    outs, _, _, launches = serve_path('optimize', opt, reqs, device,
                                      {'scatter_quasi_dense': N_REQUESTS})
    count_launches(record, 'optimize', launches, ['scatter_quasi_dense'])
    check_plain_route('optimize', opt, reqs[1], outs[0], opt, 'scatter',
                      sc.scatter_quasi_dense_plain)
    stage_times('optimize', opt, reqs[1], device)
    outs, _, _, launches = serve_path(
        'optimize+fused', opt_fused, reqs, device,
        {'scatter_quasi_dense': N_REQUESTS,
         'fused_skip_gather_add': 2 * N_REQUESTS})
    count_launches(record, 'optimize+fused', launches,
                   ['scatter_quasi_dense', 'fused_skip_gather_add'])
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
    return opt


# batched requests: counted requests of each configuration (after one
# warm-up request), and paired rounds of one B = 8 request against 8
# single-frame requests
N_BATCHED = 2
BATCHED_PAIRED_ROUNDS = 5
# FusionNet alone (bench.py): batch sizes, and the window timed at each,
# at least this many seconds: chunks of as many requests as one timed
# request says fill it (at least 3), until it is filled
FUSIONNET_BATCHES = (1, 8, 32)
FUSIONNET_WINDOW_S = 1.0
# per-frame agreement of the batched path with __call__: dense depth, m
BATCHED_DENSE_TOL = 1e-3


def batched_requests(rng, n, b):
    """n requests of b frames each: (images (b, H, W, 3) uint8, points
    (b, K, 3), valid (b, K))."""
    out = []
    for _ in range(n):
        images, points, valid = zip(*requests(rng, b, H, W, K, N_INVALID))
        out.append((np.concatenate(images), np.stack(points),
                    np.stack(valid)))
    return out


def check_frames(name, pipe, batch, out, frames, crop_tol=FOLD_TOL,
                 dense_atol=BATCHED_DENSE_TOL, dense_rtol=0.0):
    """Frames ``frames`` of a batched request against __call__ of the same
    frame on the same pipeline. cuDNN may choose other algorithms at
    another batch size, so RadarNet's crops of each frame in the batched
    path must lie within ``crop_tol`` (FOLD_TOL) of __call__'s; then every
    pixel whose quasi depth differs must be explained by a 14-bit tie or a
    top response within ``crop_tol`` of the threshold, and the response
    must lie within crop_tol + 2^-14 (what a perturbation of the crops by
    crop_tol can do to the 14-bit max) except at pixels whose top response
    is within crop_tol of the threshold. Dense depth within ``dense_atol``
    m plus ``dense_rtol`` of the depth (BATCHED_DENSE_TOL m) of FusionNet
    run on the frame alone with the batched path's own maps of that frame
    (so that a FusionNet batch of B is held to its batch of one), and
    within the same of __call__'s wherever the frame's maps equal
    __call__'s."""
    from rcfd_tpu_torch.pipeline import decode_chunk_count, serving_numerics

    def dense_err(dense, ref):
        """(max |dense - ref| in m, its max as a share of ref, whether
        every pixel lies within dense_atol + dense_rtol * ref)"""
        diff = (dense - ref).abs()
        return (float(diff.max()), float((diff / ref).max()),
                bool((diff <= dense_atol + dense_rtol * ref).all()))

    bound = '{:g} m + {:g} of the depth'.format(dense_atol, dense_rtol)

    images, points, valid = batch
    n_chunks = decode_chunk_count(points.shape[0], points.shape[1],
                                  pipe.radarnet.perf.decode_chunks)
    with torch.inference_mode(), serving_numerics():
        crops_b = pipe.radarnet_stage_batched(images, points, n_chunks)[1]
    n_quasi, n_response, crops_err, call_err = 0, 0, 0.0, []
    dense_max = (0.0, 0.0)
    for f in frames:
        req = (images[f:f + 1], points[f], valid[f])
        crops_r, xs = radarnet_outputs(pipe, req)
        err = float((crops_b[f].float() - crops_r.float()).abs().max())
        check(err <= crop_tol, '{}: frame {}: RadarNet crops differ from '
              '__call__\'s by {} > {}'.format(name, f, err, crop_tol))
        crops_err = max(crops_err, err)
        dense_r, quasi_r, resp_r = pipe(*req)
        dense, quasi, resp = (o[f] for o in out)
        quasi_px = torch.nonzero(quasi != quasi_r).cpu().numpy()
        step = (resp - resp_r).abs()
        resp_px = torch.nonzero(step > crop_tol + 2.0 ** -14).cpu().numpy()
        if len(quasi_px) or len(resp_px):
            crops, xs_np = crops_r.float().cpu().numpy(), xs.cpu().numpy()
            bad = unexplained_quasi(crops, xs_np, valid[f], quasi_px,
                                    crop_tol)
            check(not bad, '{}: frame {}: quasi depth differs from __call__ '
                  'at {} pixels that no tie or threshold explains: {}'
                  .format(name, f, len(bad), bad[:10]))
            bad = off_threshold(crops, xs_np, valid[f], resp_px, crop_tol)
            check(not bad, '{}: frame {}: response differs from __call__ by '
                  'more than {:g} at {} pixels away from the threshold: {}'
                  .format(name, f, crop_tol + 2.0 ** -14, len(bad),
                          bad[:10]))
        n_quasi += len(quasi_px)
        n_response += int((step > 0).sum())
        with torch.inference_mode(), serving_numerics():
            image_t = pipe.radarnet_stage(*req[:2])[0]
            dense_1 = pipe.fusionnet(image_t, pipe.bridge(quasi, resp)[2])
        *err, ok = dense_err(dense, dense_1[0, 0].float())
        check(ok, '{}: frame {}: dense differs from FusionNet on the frame '
              'alone by {} m, {} of the depth, beyond {}'.format(
                  name, f, *err, bound))
        dense_max = tuple(map(max, dense_max, err))
        *err, ok = dense_err(dense, dense_r)
        if not (int((step > 0).sum()) or len(quasi_px)):
            check(ok, '{}: frame {}: dense differs from __call__ by {} m, {} '
                  'of the depth, beyond {} with the same maps'.format(
                      name, f, *err, bound))
        call_err.append(err)
    log('{}: frames {} against __call__ of the same frame: RadarNet crops '
        'max abs diff {:.3g} (tolerance {:g}); {} quasi pixels differ, each '
        'at a 14-bit tie or within {:g} of the 0.5 threshold; {} response '
        'pixels differ, by at most {:g} or at the threshold; dense against '
        'FusionNet on each frame alone: max diff {:.3g} m, {:.3g} of the '
        'depth (tolerance {}); dense against __call__: max diff per frame '
        '{} (m, share of the depth; tolerance {} where the maps are '
        'equal)'.format(
            name, list(frames), crops_err, crop_tol, n_quasi, crop_tol,
            n_response, crop_tol + 2.0 ** -14, *dense_max, bound,
            ', '.join('{:.3g}/{:.3g}'.format(*e) for e in call_err),
            bound))


def phase_batched(device, record, slice_pipe, opt_pipe):
    """forward_batched at full width on the slice's weights (and, with
    optimize=True, on the optimize phase's): B = 8 and 16, B = 16 folded,
    and B = 2 in two decode chunks with the deferred pools and at the
    900x300 patch; each with its kernels held to their plain versions on
    the same request; then paired rounds at B = 8."""
    from rcfd_tpu_torch.nn.perf import PerfConfig
    from rcfd_tpu_torch.ops import crop_cuda as cc
    from rcfd_tpu_torch.ops import fused_skip as fs
    from rcfd_tpu_torch.ops import roi_pool
    from rcfd_tpu_torch.ops import scatter_cuda as sc
    from rcfd_tpu_torch.pipeline import TwoStagePipeline, decode_chunk_count

    rng = np.random.default_rng(SEED + 5)
    batches = {b: batched_requests(rng, N_BATCHED + 1, b) for b in (8, 16)}
    for b in (8, 16):
        chunks = decode_chunk_count(b, K, None)
        check(chunks == b // 8, 'batched: {} decode chunks at B={}'.format(
            chunks, b))
        name = 'batched B={} ({} decode chunk{})'.format(
            b, chunks, 's' if chunks > 1 else '')
        outs, _, _, launches = serve_path(
            name, slice_pipe, batches[b], device,
            {'scatter_quasi_dense': N_BATCHED}, batched=True)
        count_launches(record, 'batched B={}'.format(b), launches,
                       ['scatter_quasi_dense'])
        check_plain_route(name, slice_pipe.forward_batched, batches[b][1],
                          outs[0], slice_pipe, 'scatter_batched',
                          sc.scatter_quasi_dense_batched_plain)
        check_frames(name, slice_pipe, batches[b][1], outs[0], range(b))
        del outs
        torch.cuda.empty_cache()
    outs, _, _, launches = serve_path(
        'batched+optimize B=16', opt_pipe, batches[16], device,
        {'scatter_quasi_dense': N_BATCHED}, batched=True)
    count_launches(record, 'batched+optimize B=16', launches,
                   ['scatter_quasi_dense'])
    check_frames('batched+optimize B=16', opt_pipe, batches[16][1], outs[0],
                 (0, 15))
    del outs
    torch.cuda.empty_cache()
    small = batched_requests(rng, N_BATCHED + 1, 2)
    for name, kw, kernel, per_chunk, module, attr, plain in (
            ('batched fused B=2', dict(perf=PerfConfig(
                fused_pool2=True, fused_pool4=True, decode_chunks=2)),
             'fused_skip_gather_add', 2, fs, 'fused_skip_gather_add',
             fs.fused_skip_gather_add_plain),
            ('batched wide B=2', dict(input_patch_size_image=WIDE_PATCH,
                                      perf=PerfConfig(decode_chunks=2)),
             'column_crop', 3, roi_pool, 'batch_column_crop',
             cc.batch_column_crop_plain)):
        rn = radarnet_like(slice_pipe.radarnet, device, **kw)
        pipe = TwoStagePipeline(rn, slice_pipe.fusionnet, H, W,
                                device=device)
        outs, _, _, launches = serve_path(
            name, pipe, small, device,
            {'scatter_quasi_dense': N_BATCHED,
             kernel: 2 * per_chunk * N_BATCHED}, batched=True)
        count_launches(record, name, launches,
                       ['scatter_quasi_dense', kernel])
        check_plain_route(name, pipe.forward_batched, small[1], outs[0],
                          module, attr, plain)
        check_frames(name, pipe, small[1], outs[0], (0, 1))
        del outs, pipe, rn
    torch.cuda.empty_cache()
    images, points, valid = batches[8][1]

    def one_frame_a_request(*batch):
        for f in range(images.shape[0]):
            slice_pipe(images[f:f + 1], points[f], valid[f])

    paired_times({'forward_batched': slice_pipe.forward_batched,
                  '__call__ per frame': one_frame_a_request},
                 [batches[8][1]], BATCHED_PAIRED_ROUNDS, frames=8)


def phase_fusionnet_alone(device, fn, dtype=torch.float32):
    """FusionNet alone at the benchmark config (bench.py), batch norm folded
    (as bench.py folds it), in ``dtype`` (float32, or bf16 as bench.py
    serves by default) under serving_numerics, from integer transport
    inputs on the card (uint8 frames, uint16 x256-codec depth and
    response, bench.py's _inputs) decoded in float32 in each request and
    cast to ``dtype``, as the pipeline casts them: frames/s and peak memory
    at each batch size of FUSIONNET_BATCHES, over a window of at least
    FUSIONNET_WINDOW_S seconds."""
    from rcfd_tpu_torch.data import transport
    from rcfd_tpu_torch.nn.optimize import fold_batch_norm
    from rcfd_tpu_torch.pipeline import serving_numerics

    model = fold_batch_norm(fn).to(device, dtype).eval()
    label = 'float32' if dtype == torch.float32 else 'bf16'
    rng = np.random.default_rng(SEED + 6)
    for b in FUSIONNET_BATCHES:
        image = torch.from_numpy(rng.integers(
            0, 256, (b, H, W, 3), dtype=np.uint8)).to(device)
        depth = torch.from_numpy(rng.integers(
            0, 80 * 256, (b, H, W, 1), dtype=np.uint16)).to(device)
        response = torch.from_numpy(rng.integers(
            0, 256, (b, H, W, 1), dtype=np.uint16)).to(device)

        def forward():
            img = transport.decode(image) / 255.0
            inp = torch.cat([transport.decode(depth),
                             transport.decode(response)], -1)
            return model(img.permute(0, 3, 1, 2).to(dtype),
                         inp.permute(0, 3, 1, 2).to(dtype))

        with torch.inference_mode(), serving_numerics():
            out = forward()  # warm-up: cuDNN chooses its algorithms
            torch.cuda.synchronize()
            check(tuple(out.shape) == (b, 1, H, W) and
                  bool(torch.isfinite(out).all()) and
                  float(out.min()) >= 1.0 and float(out.max()) <= 100.0,
                  'FusionNet alone at b={}: output {} not finite in '
                  '[1, 100] m'.format(b, tuple(out.shape)))
            del out
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            chunk = max(3, math.ceil(FUSIONNET_WINDOW_S /
                                     (time.perf_counter() - t0)))
            torch.cuda.reset_peak_memory_stats(device)
            resident = torch.cuda.memory_allocated(device)
            n, dt, t0 = 0, 0.0, time.perf_counter()
            while dt < FUSIONNET_WINDOW_S:
                for _ in range(chunk):
                    out = forward()
                torch.cuda.synchronize()
                n, dt = n + chunk, time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        log('FusionNet alone (bench.py CONFIG, batch norm folded, {}, '
            'integer transport) at b={}: {} requests in {:.3f} s, {:.2f} '
            'frames/s, {:.2f} ms/frame; peak memory {} bytes ({} above the '
            '{} resident)'.format(label, b, n, dt, b * n / dt,
                                  dt * 1e3 / (b * n), peak, peak - resident,
                                  resident))
        del image, depth, response, out
        torch.cuda.empty_cache()


# bf16 serving (phase bf16), each frame of a batched request against
# __call__: dense depth within two bf16 steps, as a share of the depth
BF16_DENSE_RTOL = 2.0 ** -6


def bf16_deviation(name, pipe, ref_pipe, reqs):
    """The bf16 path against the float32 path of the same weights on the
    same requests, printed and not gated (the weights are seeded random,
    so no accuracy target exists): dense MAE and 99th-percentile relative
    error, the share of quasi pixels that differ, the largest difference
    of RadarNet's crops."""
    maes, p99s, n_quasi, crop_err = [], [], 0, 0.0
    for req in reqs:
        crops = radarnet_outputs(pipe, req)[0].float()
        crop_err = max(crop_err, float(
            (crops - radarnet_outputs(ref_pipe, req)[0]).abs().max()))
        dense, quasi, _ = pipe(*req)
        dense_ref, quasi_ref, _ = ref_pipe(*req)
        diff = (dense - dense_ref).abs().cpu().numpy()
        maes.append(float(diff.mean()))
        p99s.append(float(np.percentile(
            diff / np.maximum(dense_ref.cpu().numpy(), 1.0), 99)))
        n_quasi += int((quasi != quasi_ref).sum())
    n_px = len(reqs) * H * W
    log('{}: deviation from the float32 path on the same {} requests '
        '(printed, not gated): dense MAE {} m, 99th-percentile relative '
        'error {}; quasi pixels that differ {} of {} ({:.3g}%); RadarNet '
        'crops max abs diff {:.3g}'.format(
            name, len(reqs), ', '.join('{:.4g}'.format(m) for m in maes),
            ', '.join('{:.4g}'.format(p) for p in p99s), n_quasi, n_px,
            100.0 * n_quasi / n_px, crop_err))


def phase_bf16(device, record, pipes, opt_pipe, reqs):
    """TwoStagePipeline(compute_dtype=torch.bfloat16) on the weights of the
    float32 paths ``pipes`` (slice, fused, wide) and of ``opt_pipe``: each
    path's requests launch only the bf16 instances, held to their plain
    versions and compared with the float32 path; forward_batched at B = 8
    and, folded, at B = 16, each frame against __call__; paired rounds
    against float32; B = 2 in two decode chunks with the deferred pools
    and at the 900x300 patch, as in phase batched; FusionNet alone in
    bf16."""
    from rcfd_tpu_torch.nn.perf import PerfConfig
    from rcfd_tpu_torch.ops import crop_cuda as cc
    from rcfd_tpu_torch.ops import fused_skip as fs
    from rcfd_tpu_torch.ops import roi_pool
    from rcfd_tpu_torch.ops import scatter_cuda as sc
    from rcfd_tpu_torch.pipeline import TwoStagePipeline

    bf16 = torch.bfloat16
    k1 = {'scatter_quasi_dense bf16': N_REQUESTS}
    served = {}
    for path, expect, route in (
            ('slice', k1, (None, 'scatter', sc.scatter_quasi_dense_plain)),
            ('fused', dict(k1, **{'fused_skip_gather_add bf16':
                                  2 * N_REQUESTS}),
             (fs, 'fused_skip_gather_add', fs.fused_skip_gather_add_plain)),
            ('wide', dict(k1, **{'column_crop bf16': 3 * N_REQUESTS}),
             (roi_pool, 'batch_column_crop', cc.batch_column_crop_plain))):
        name = path + ' bf16'
        ref = pipes[path]
        pipe = TwoStagePipeline(ref.radarnet, ref.fusionnet, H, W,
                                compute_dtype=bf16, device=device)
        outs, _, _, launches = serve_path(name, pipe, reqs, device, expect)
        count_launches(record, name, launches, list(expect))
        module, attr, plain = route
        check_plain_route(name, pipe, reqs[1], outs[0], module or pipe, attr,
                          plain)
        bf16_deviation(name, pipe, ref, reqs[1:])
        stage_times(name, pipe, reqs[1], device)
        served[path] = pipe
        del outs
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 5)  # phase batched's requests
    batches = {b: batched_requests(rng, N_BATCHED + 1, b) for b in (8, 16)}
    opt16 = TwoStagePipeline(opt_pipe.radarnet, opt_pipe.fusionnet, H, W,
                             optimize=True, compute_dtype=bf16,
                             device=device)
    for b, pipe, name, frames in (
            (8, served['slice'], 'batched bf16 B=8', range(8)),
            (16, opt16, 'batched+optimize bf16 B=16', (0, 15))):
        outs, _, _, launches = serve_path(
            name, pipe, batches[b], device,
            {'scatter_quasi_dense bf16': N_BATCHED}, batched=True)
        count_launches(record, name, launches, ['scatter_quasi_dense bf16'])
        check_plain_route(name, pipe.forward_batched, batches[b][1], outs[0],
                          pipe, 'scatter_batched',
                          sc.scatter_quasi_dense_batched_plain)
        check_frames(name, pipe, batches[b][1], outs[0], frames,
                     crop_tol=BF16_CROP_TOL, dense_atol=0.0,
                     dense_rtol=BF16_DENSE_RTOL)
        del outs
        torch.cuda.empty_cache()
    del batches
    # phase batched's B = 2 requests, in two decode chunks: the row-tile
    # kernels over the 2 images of each chunk's windows
    small = batched_requests(rng, N_BATCHED + 1, 2)
    for name, kw, kernel, per_chunk, module, attr, plain in (
            ('batched fused bf16 B=2', dict(perf=PerfConfig(
                fused_pool2=True, fused_pool4=True, decode_chunks=2)),
             'fused_skip_gather_add bf16', 2, fs, 'fused_skip_gather_add',
             fs.fused_skip_gather_add_plain),
            ('batched wide bf16 B=2', dict(input_patch_size_image=WIDE_PATCH,
                                           perf=PerfConfig(decode_chunks=2)),
             'column_crop bf16', 3, roi_pool, 'batch_column_crop',
             cc.batch_column_crop_plain)):
        rn = radarnet_like(pipes['slice'].radarnet, device, **kw)
        pipe = TwoStagePipeline(rn, pipes['slice'].fusionnet, H, W,
                                compute_dtype=bf16, device=device)
        outs, _, _, launches = serve_path(
            name, pipe, small, device,
            {'scatter_quasi_dense bf16': N_BATCHED,
             kernel: 2 * per_chunk * N_BATCHED}, batched=True)
        count_launches(record, name, launches,
                       ['scatter_quasi_dense bf16', kernel])
        check_plain_route(name, pipe.forward_batched, small[1], outs[0],
                          module, attr, plain)
        check_frames(name, pipe, small[1], outs[0], (0, 1),
                     crop_tol=BF16_CROP_TOL, dense_atol=0.0,
                     dense_rtol=BF16_DENSE_RTOL)
        del outs, pipe, rn
    torch.cuda.empty_cache()
    paired_times({'slice': pipes['slice'], 'slice bf16': served['slice']},
                 reqs[1:], PAIRED_ROUNDS)
    phase_fusionnet_alone(device, pipes['slice'].fusionnet, bf16)


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
        for dtype in (torch.float32, torch.bfloat16):
            phase_kernel_scatter(device, record, dtype)
            phase_kernel_fused_skip(device, record, rn, dtype)
            phase_kernel_column_crop(device, record, rn, dtype)
            torch.cuda.empty_cache()
    with Phase('variants'):
        phase_variants(device, record, rn)
        torch.cuda.empty_cache()
    with Phase('reference'):
        phase_reference(device)
    with Phase('slice'):
        slice_pipe = phase_slice(device, record, rn, fn, reqs)
    with Phase('fused'):
        fused_pipe = phase_fused(device, record, slice_pipe, reqs)
    with Phase('wide'):
        wide_pipe = phase_wide(device, record, slice_pipe, reqs)
    with Phase('optimize'):
        opt_pipe = phase_optimize(device, record, slice_pipe, reqs)
    torch.cuda.empty_cache()
    with Phase('batched'):
        phase_batched(device, record, slice_pipe, opt_pipe)
        phase_fusionnet_alone(device, slice_pipe.fusionnet)
    torch.cuda.empty_cache()
    with Phase('bf16'):
        phase_bf16(device, record, {'slice': slice_pipe, 'fused': fused_pipe,
                                    'wide': wide_pipe}, opt_pipe, reqs)

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
