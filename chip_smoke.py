#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rcfd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printed as it starts and ends:

  build      compile the hand-written CUDA kernels with nvcc (first use)
  kernel     hold each kernel against its plain PyTorch version on the card
             at the shapes of the serving path, bit for bit, and time the
             kernel, the plain version and the nearest one-call PyTorch
             operator
  reference  a small configuration on the card against the same port on
             the CPU, stage by stage
  slice      the two-stage serving path at full width (RadarNet at its
             900x288 patch, FusionNet at the benchmark config, 900x1600
             frames, 64 radar points) with seeded random weights, serving a
             few requests

Then a line with the card's name and power limit, a line
{"kernels": [...]} and, last, {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero and prints no result; so does a
machine without a CUDA device, or a directory that lacks the package.
It imports torch, numpy and rcfd_tpu_torch only.

The models run under the pipeline's own numerics
(rcfd_tpu_torch.pipeline.serving_numerics: float32 with TF32 off, cuDNN
algorithms autotuned among deterministic ones), as a caller gets them;
the script sets no backend flag of its own. With --profile the slice
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
# --profile: also trace one request with torch.profiler
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


def scatter_inputs(rng, device):
    """Canonical scatter inputs with the hard cases: ties inside one 2^-14
    step, values of exactly 0.5, invalid points, points at x = 0 and
    x = W - 1, and integer depths equal to other points' indices (the
    legacy rewrite cascade)."""
    ph, pw = PATCH
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


def phase_kernel(device, record):
    from rcfd_tpu_torch.ops import scatter_cuda as sc

    ph, pw = PATCH
    rng = np.random.default_rng(SEED)
    crops, xs, zs, valid = scatter_inputs(rng, device)
    args = (crops, xs, zs, valid, H, W, PATCH)

    d_k, r_k = sc.scatter_quasi_dense(*args)
    d_p, r_p = sc.scatter_quasi_dense_plain(*args)
    torch.cuda.synchronize()
    err = max(float((d_k - d_p).abs().max()), float((r_k - r_p).abs().max()))
    check(torch.equal(d_k, d_p) and torch.equal(r_k, r_p),
          'scatter kernel differs from its plain version: max abs err '
          '{}'.format(err))
    check(int((r_k > 0).sum()) > 0, 'scatter produced an empty map')
    log('scatter kernel == plain version, bit for bit (tolerance 0); '
        '{} covered pixels'.format(int((r_k > 0).sum())))

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
    record['scatter_quasi_dense'] = dict(
        name='scatter_quasi_dense', route='cuda',
        source='rcfd_tpu_torch/csrc/scatter_quasi_dense.cu',
        replaces='rcfd_tpu/ops/scatter_pallas.py:42',
        launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by='bytes', library_ms=library_ms)


def build_models(radarnet_kw, fusionnet_kw, device, seed):
    from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel
    from rcfd_tpu_torch.nn import init_parameters

    gen = torch.Generator().manual_seed(seed)
    rn = RadarNetModel(**radarnet_kw, device='cpu')
    fn = FusionNetModel(**fusionnet_kw, device='cpu')
    init_parameters(rn, gen)
    init_parameters(fn, gen)
    return rn.to(device), fn.to(device)


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


def phase_reference(device):
    """A small configuration on the card against the port on the CPU,
    stage by stage, on the same weights and inputs."""
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


def phase_slice(device, record):
    from rcfd_tpu_torch.ops import scatter_cuda as sc
    from rcfd_tpu_torch.pipeline import TwoStagePipeline, serving_numerics

    rn, fn = build_models(RADARNET, FUSIONNET, device, SEED)
    with serving_numerics():
        b, m = torch.backends.cudnn, torch.backends.cuda.matmul
        log('slice: the pipeline serves with TF32 {} for convolutions and '
            '{} for matmuls; cuDNN benchmark mode {}, deterministic {}'
            .format('on' if b.allow_tf32 else 'off',
                    'on' if m.allow_tf32 else 'off', b.benchmark,
                    b.deterministic))
    pipe = TwoStagePipeline(rn, fn, H, W, device=device)
    reqs = requests(np.random.default_rng(SEED), N_REQUESTS + 1, H, W, K,
                    N_INVALID)
    pipe(*reqs[0])  # warm-up request
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(device)
    sc.scatter_quasi_dense.launches = 0
    outs, times = [], []
    for req in reqs[1:]:
        t0 = time.perf_counter()
        out = pipe(*req)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = sc.scatter_quasi_dense.launches
    peak = torch.cuda.max_memory_allocated(device)
    check(launches == N_REQUESTS,
          'scatter kernel launched {} times for {} requests'.format(
              launches, N_REQUESTS))
    record['scatter_quasi_dense']['launches'] = launches

    for dense, quasi, response in outs:
        for name, t in (('dense', dense), ('quasi', quasi),
                        ('response', response)):
            check(tuple(t.shape) == (H, W), '{} has shape {}'.format(
                name, tuple(t.shape)))
            check(bool(torch.isfinite(t).all()), '{} is not finite'.format(
                name))
        check(float(dense.min()) >= 1.0 and float(dense.max()) <= 100.0,
              'dense depth outside [1, 100] m')
        check(float(response.min()) >= 0.0 and float(response.max()) <= 1.0,
              'response outside [0, 1]')
        check(int((response > 0).sum()) > 0, 'empty quasi-dense map')

    ref = copy.copy(pipe)
    ref.scatter = sc.scatter_quasi_dense_plain
    dense_p, quasi_p, response_p = ref(*reqs[1])
    dense, quasi, response = outs[0]
    check(torch.equal(quasi, quasi_p) and torch.equal(response, response_p),
          'slice with the kernel differs from the slice with the plain '
          'scatter: {} quasi and {} response pixels'.format(
              int((quasi != quasi_p).sum()),
              int((response != response_p).sum())))
    log('slice: quasi and response maps == the plain-scatter slice, bit for '
        'bit; dense max abs diff {:.3g} m'.format(
            float((dense - dense_p).abs().max())))
    log('slice: {} requests at {}x{}, K={} ({} padding): ms/frame {} '
        '(median {:.2f}); peak memory {} bytes; scatter launches {}'.format(
            N_REQUESTS, H, W, K, N_INVALID,
            ', '.join('{:.2f}'.format(t) for t in times),
            float(np.median(times)), peak, launches))
    log('slice: covered quasi-dense pixels per request: {}'.format(
        [int((o[2] > 0).sum()) for o in outs]))

    # where a request's time goes, stage by stage (host clock around each
    # stage, synchronized; one more request after the counted ones)
    image, points, valid = reqs[1]
    with torch.inference_mode(), serving_numerics():
        t0 = time.perf_counter()
        image_t, crops, xs, zs = pipe.radarnet_stage(image, points)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        maps = pipe.scatter(crops, xs, zs,
                            torch.from_numpy(valid).to(device), H, W, PATCH)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _, _, input_depth = pipe.bridge(*maps)
        pipe.fusionnet(image_t, input_depth)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    stage_ms = dict(radarnet=(t1 - t0) * 1e3, scatter=(t2 - t1) * 1e3,
                    bridge_fusionnet=(t3 - t2) * 1e3)
    log('slice: stage ms (host clock, synchronized): {}'.format(
        ', '.join('{} {:.2f}'.format(k, v) for k, v in stage_ms.items())))
    if PROFILE:
        profile_request(pipe, reqs[1])


def profile_request(pipe, req):
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
    log('profile: wall {:.2f} ms, device kernels {:.2f} ms ({:.1f}% busy)'
        .format(wall_ms, total_us / 1e3, 100.0 * total_us / 1e3 / wall_ms))
    for e in rows[:25]:
        log('profile: {:9.3f} ms {:6d} calls  {}'.format(
            e.self_device_time_total / 1e3, e.count, e.key[:110]))


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
        from rcfd_tpu_torch.ops import scatter_cuda as sc
        t0 = time.perf_counter()
        sc._kernel()
        log('built {} in {:.2f} s'.format(sc.SOURCE, time.perf_counter() - t0))
        for line in _build.BUILD_LOGS.get(sc.SOURCE, '').splitlines():
            log('  nvcc: ' + line)
    with Phase('kernel'):
        phase_kernel(device, record)
    with Phase('reference'):
        phase_reference(device)
    with Phase('slice'):
        phase_slice(device, record)

    kernels = list(record.values())
    check(all(k['launches'] for k in kernels),
          'a kernel of the path was not launched: {}'.format(kernels))
    log(gpu_name_and_power())
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
