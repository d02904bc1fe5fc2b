#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rcfd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printed as it starts and ends:

  build      compile the hand-written CUDA kernels with nvcc, one process
             per source, all started together
  codec      build the port's image codec (g++; nvJPEG for JPEG on the
             card) after one line of what the machine offers it (g++, the
             headers and libraries of libpng, libjpeg, zlib and nvJPEG);
             900x1600 depth, response and RGB frames through the writers
             and readers, exact; the repository's JPEG frame decoded on the
             card against PIL's decode; host ms per frame to read a camera
             frame and a ground truth and to write the three outputs
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
             few requests; kernel: the quasi-dense scatter (the path phases
             build RadarNet with PerfConfig(pallas_scatter=True)). Also one
             request with codec_encode=True, whose uint16 outputs must
             equal floor(x * 256) / floor(x * 2^14) of the float ones
  fused      the same path with RadarNet's 1/2- and 1/4-scale pools
             deferred into its decoder (PerfConfig(fused_pool2=True,
             fused_pool4=True)); kernels: the fused skip gather-add and the
             scatter
  wide       the same path with RadarNet at a 900x300 patch, whose 1/8,
             1/16 and 1/32 pools take the variable-bin branch; kernels: the
             column crop and the scatter
  exact      the slice at the serving default (the exact float max,
             ops/scatter.py, no kernel): no launch; its maps against the
             exact scatter of the same crops on the card and on the CPU,
             bit for bit, and against K1's; both scatters timed
  stage0     stage 0 over fake nuScenes scenes the smoke builds at the real
             sizes (StageZeroDB: CAM_FRONT 900x1600 with a nuScenes
             calibration, LIDAR_TOP sweeps of 34,720 points at 20 Hz,
             RADAR_FRONT 125 returns, cameras at 12 Hz, keyframes at 2 Hz,
             the ego at 10 m/s, a street of boxes, movers among them):
             (a) setup_dataset_nuscenes.process_scene over 3 keyframes at
             +-9, again on the CPU, file for file; (b) merge_point_clouds
             of keyframe 9 of 19 at +-9 (lidar with boxes, radar), the
             lidar merge again with TF32 on; (c)
             setup_dataset_nuscenes_with_denseGT.process_scene at +-80
             over 2 keyframes inside a chain of 171 sweeps with panoptic
             masks, the first keyframe's merge at +-8 again on the CPU;
             (d) TwoStagePipeline.from_raw_radar on (b)'s radar returns
             and rig, with K1 (counted) and with the exact max, each
             against __call__ on the card's projected points and K1
             against its plain version on the path's crops, bit for bit.
             Card against CPU: equal except at ties, each shown by the
             merge's points recomputed on both. Prints ms a keyframe
             (device merge, host loads and masks, interpolate_depth,
             writes), device ms a 900x1600 merge, ms a frame of (d), peak
             memory
  optimize   the slice and fused paths with every batch norm folded into
             its convolution (TwoStagePipeline(optimize=True)): launches,
             the deviation from the unfolded paths, and ms/frame of
             interleaved, paired requests against the slice
  batched    TwoStagePipeline.forward_batched on the slice's weights: B = 8
             (one decode chunk) and 16 (two), B = 16 with optimize=True,
             and B = 2 in two decode chunks with the deferred pools (fused)
             and at the 900x300 patch (wide); frames at both ends of each
             decode chunk against __call__ of the same frame; ms per
             request, frames/s and peak memory; paired rounds of one B = 8
             request against 8 single-frame requests; then FusionNet
             alone at the benchmark config with batch norm folded,
             float32, at b = 1, 8 and 32, from integer transport inputs
  bf16       TwoStagePipeline(compute_dtype=torch.bfloat16) on the same
             weights: the slice, fused and wide paths (only the kernels'
             bf16 instances launched), each held to the kernels' plain
             versions and its deviation from the float32 path of the same
             requests printed; forward_batched at B = 8 and, folded, at
             B = 16, frames at both ends of the batch and of each decode
             chunk against __call__; paired rounds of bf16
             against float32 slice requests; B = 2 in two decode chunks
             with the deferred pools and at the 900x300 patch, as in
             batched; FusionNet alone in bf16
  cli        the serving CLI (rcfd_tpu_torch.run_pipeline.main, in
             process) on 8 full-size frames the port's writers put in a
             temporary directory, with the two models as .pth files: a
             float32, one frame a request, with ground truth, at the
             default (the exact max); with RCFD_PALLAS_SCATTER=1 (K1): b
             float32, 4 a request, without (the codec_encode writers); c as
             b in bf16; d at the 900x300 patch; e with RCFD_FUSED_POOL2/4
             set; each run once (no warm-up run since the parallel phase
             came: a new shape's cuDNN autotuning is in its run's time):
             launches, every file against the same frame served in memory,
             run a's files against run b's, frames/s and the
             read/serve/write split
  train      FusionNet training: rcfd_tpu_torch.train_fusionnet.main, in
             process, with bash/train_fusionnet_nuscenes.sh's flags on 16
             full-size quintuples and 4 validation frames the port's
             writers made (10 steps of batch 16, checkpoints and
             validation at steps 5 and 10), then resumed from the newest
             checkpoint to step 15; then the first run again with
             --raw_cache_dirpath (the decode-once raw cache: its first
             epoch's wait and the median of the later ones beside the
             uncached run's, and the loader's batches of two epochs with
             and without the cache, byte for byte); model-10.pth served
             beside the smoke's RadarNet; one step of a narrow FusionNet
             card vs CPU; 30 steps of the canonical model on one fixed
             batch. Prints ms a step, the host's wait for data, samples/s
             and peak memory
  train_radarnet  RadarNet training: (a) rcfd_tpu_torch.train_radarnet.main,
             in process, with bash/train_radarnet_nuscenes.sh's flags on
             30 full-size frames and 4 validation frames the port's
             writers made (10 steps of batch 6, K = 4, in 2 epochs of 5
             steps; checkpoints and a
             validation through K1 at steps 5 and 10), resumed from the
             newest checkpoint to step 15; K1 held against its plain
             version on the trained model's crops; model-15.pth served
             beside the smoke's FusionNet; ms a step, host wait,
             samples/s, peak memory. (b) one step at the 900x300 patch
             through K2 (3 launches, with its gradient) and the same step
             through the plain crop: loss, every gradient, and a nonzero
             gradient in each used parameter of the image encoder; K2's
             forward and its plain backward timed at the step's shapes.
             (c) one step and one validation under RCFD_FUSED_POOL2/4: K3
             in the validation only. (d) one step of a narrow RadarNet
             card vs CPU at three seeds, in float32 and in float64
  train_bf16 both training CLIs under RCFD_TRAIN_DTYPE=bfloat16 on the
             files of train and train_radarnet, with their flags and
             schedules (10 steps, checkpoints and validation at 5 and 10):
             ms a step, host wait, samples/s and peak memory beside the
             float32 phases'; float32 checkpoints; validation in float32
             (K1's float32 instance); one 900x300 RadarNet step through K2's
             bf16 instance (3 launches, its bf16 gradient) against the plain
             crop, and K2 bf16's forward and backward timed at the step's
             shapes; one bf16 step of a narrow model of each kind card vs
             CPU at three seeds, against the CPU's float64 step
  run        the standalone run drivers (rcfd_tpu_torch.run_radarnet.main
             and run_fusionnet.main, in process) with
             bash/run_{radarnet,fusionnet}_nuscenes.sh's flags on 8
             full-size frames, FusionNet on RadarNet's outputs: a with
             ground truth and metrics, b without (codes made on the card;
             its files equal a's byte for byte), c under
             RCFD_COMPUTE_DTYPE=bfloat16, and for RadarNet d at the 900x300
             patch (K2) and e under the fused gates (K3); each run once, as
             in cli: launches, frames/s and the read / serve / write
             split; RadarNet's a against stage 1 of TwoStagePipeline
  bridge     the stage-1.5 bridge (rcfd_tpu_torch.setup.
             setup_dataset_nuscenes_radarnet.main and its _test form, in
             process) with bash/setup_dataset_nuscenes_radarnet.sh's flags
             on the run phase's 8 frames (4 train, 4 val) and RadarNet:
             a the defaults (codes made on the card, K1), b
             --run_evaluation (the float route: a's files byte for byte,
             the metrics), c the 900x300 patch (K2), d the fused gates
             (K3), e the _test script on the val frames at K = 128, f
             RCFD_DECODE_CHUNKS=2 (e and f against a's files); each run
             once, as in cli: launches, frames/s, the read / serve / write
             split and peak memory; then 1 frame on the card and on the
             CPU under RCFD_PALLAS_SCATTER=0
  tools      the JAX package's tools as the port runs them
             (rcfd_tpu_torch.tools): (a) convert_checkpoint.main on the
             card, .pth -> .npz -> .pth of the run phase's RadarNet and of
             the train phase's FusionNet (model-15.pth, with its Adam
             state), each result restored on the card and its state_dict
             equal to the original's bit for bit, and FusionNet's .pth ->
             .pth, its Adam state equal to the file's; (b)
             bridgebench.run_bridge on the run phase's 8 frames and
             RadarNet, one batch of 8, after one warm-up pass: prefetch,
             sync and codec, their files byte for byte equal, K1 once a
             pass (counted), frames/s
  configs    FusionNet in the configurations the port took last, at
             bash/train_fusionnet_nuscenes.sh's widths on the train
             phase's files, 5 steps each: a --n_resolutions_decoder 3, b
             --encoder_type resnet18 batch_norm (image only), c
             fusionnet34 (all three through train_fusionnet.main; a and b
             then serve 2 of the run phase's frames with
             run_fusionnet.main from their checkpoints), d
             deconv_type='transpose' (fusionnet_main.TrainStep on a model
             built directly: the JAX CLI has no flag for it); ms a step,
             samples/s, peak memory; each case at narrow widths card vs
             CPU, one train step and one return_multiscale forward

  legacy     the legacy v0 pipeline (rcfd_tpu_torch.setup.data_gen,
             train_legacy_v0, save_depth_radar, save_stage_1_depth,
             eval_stage_1_depth, in process) on the run phase's 8 frames:
             (a) data_gen.process_scene over 2 keyframes of a StageZeroDB
             scene at the train split's +-9, then on the CPU, file for file
             (ground truth, .npy, label samples, records); (b)
             train_legacy_v0 at its defaults (batch 6, 900x288 crops) for
             10 steps, a checkpoint and a validation (2 frames, K = 128)
             every 5, resumed for one epoch; (c) save_depth_radar with
             bash/train_nuscenes.sh's flags (batch 64, 900x60, validation
             and checkpoint every step), 2 steps; (d) save_stage_1_depth
             from (b)'s checkpoint over 4 frames at K = 128, then
             eval_stage_1_depth against a numpy recount; (e) narrow train
             steps at 64x32 and 64x60 card vs CPU against a float64 step,
             one full-size make_forward_fn frame at K = 128 card vs CPU (each
             differing depth pixel a tie or at the threshold), and no K1, K2
             or K3 launch on (b)-(e); (f) ops/roi_pool.roi_pool, the general
             box pool, card vs CPU bit for bit at a 1/8-scale map of a
             900x1600 frame, 64 boxes at 7x7
  parallel   data parallelism on the one card, two shards or two gloo
             ranks sharing cuda:0 (rcfd_tpu_torch.parallel; a check of
             the sharded code, not of how it scales): (a)
             TwoStagePipeline.forward_sharded over [cuda:0, cuda:0] at B
             = 8 on the canonical models with K1 (2 launches a request),
             the exact max (none) and at the 900x300 patch (K2 3 a shard),
             each shard equal to forward_batched of the shard on the
             shard's thread bit for bit, K1 and K2 held to their plain
             versions, frames held to __call__ by the batched phase's rule
             (check_frames); then a pipeline built on the CPU sharded
             over [cuda:0, cuda:0]: one replica on cuda:0, kept, each
             shard equal to the replica's forward_batched bit for bit; (b)
             run_pipeline.main --data_parallel --batch_size 4 on the run
             phase's 8 frames, its files equal to the run without the
             flag but at ties (the shard threads choose their cuDNN
             algorithms apart); (c) one float64 step of a
             narrow FusionNet and a narrow RadarNet on 2 ranks on the card
             against 2 ranks on the CPU,
             within 1e-9; (d) in (c)'s card ranks, train_radarnet.main at
             900x300 (global batch 6, 3 a rank: K2 and its backward on
             both ranks), 3 steps, and train_fusionnet.main with
             bash/train_fusionnet_nuscenes.sh's flags (global batch 16, 8 a
             rank, 448x448), 4 steps, each with --n_data_parallel 2: ms a
             step, each rank's wait and peak memory, checkpoints from rank
             0 only, restored; (e) a one-rank NCCL
             group on cuda:0, the wrapped step equal to the unwrapped step
             bit for bit

The resumed runs of phases train (FusionNet, float32), train_radarnet
(RadarNet, float32, resumed at the 900x300 patch so that K2 and its
backward run) and train_bf16 (both, resumed under
RCFD_TRAIN_DTYPE=bfloat16) trace steps 13 and 14 with the port's trace
window (RCFD_PROFILE_DIR, RCFD_PROFILE_STEPS=12-14), outside the timed
steps 3-10 of the first runs. From each Chrome trace the smoke prints the
card's busy share of the window, its ten largest kernels, the backward's
kernels by autograd node, and for RadarNet K2's forward and backward, for
FusionNet the batch norms' kernels; a window that wrote no trace, or one
without a CUDA kernel event, fails the phase.

Each path phase (and each configuration of the batched phase) sets every
kernel's launch count to 0 before its counted requests, reads them after,
and fails unless each kernel of its path was launched as often as its
requests need and every other kernel not at all. A kernel's entry of the
kernels line sums the counts read after each path that launched it
(``launches_by_path``); the scatter has one count for its two entries,
one frame a launch (slice) and a batch a launch (batched). The ranks of
phase parallel count their launches in their own processes and return
them; each rank's are added as a path of its own.

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

import contextlib
import copy
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time
import zlib

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


@contextlib.contextmanager
def environ(values):
    """os.environ with ``values`` set, as they were again on exit."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def crop_bytes(rows, starts, win):
    """The bytes the column crop must move: each column of the rows that a
    window covers, read once (the windows' columns past W are zeros, read
    from nowhere), the windows written once, and the starts."""
    n, c, ph, w = rows.shape
    k = starts.shape[1]
    cols = torch.clamp(starts.long().cpu(), 0, w)[:, :, None] + \
        torch.arange(win)
    covered = torch.zeros((n, w + win), dtype=torch.bool)
    covered.scatter_(1, cols.reshape(n, k * win), True)
    read = int(covered[:, :w].sum())
    return rows.element_size() * c * ph * (read + n * k * win) + 4 * n * k


def padded_gather(rows, starts, win):
    """The yardstick of the crop: torch.gather from the zero-padded rows,
    each image's map repeated for its K windows (a view), with the index
    computed beforehand. Returns the call and its index's owner."""
    n, c, ph, w = rows.shape
    k = starts.shape[1]
    rows_p = torch.nn.functional.pad(rows, (0, win))[:, None].expand(
        n, k, c, ph, w + win)
    cols = starts.long()[:, :, None] + torch.arange(win, device=rows.device)
    index = cols[:, :, None, None, :].expand(n, k, c, ph, win).contiguous()
    return lambda: torch.gather(rows_p, 4, index).view(n * k, c, ph, win)


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
        gather = padded_gather(rows, starts, win)
        check(torch.equal(gather(), out),
              'the torch.gather yardstick differs from the kernel')
        library_ms = device_ms(gather, 20)
        # the write-only floor: PyTorch filling a tensor of the output's
        # bytes, the most of the kernel's work (the rows are 3-9% of it)
        fill = torch.empty_like(out)
        write_ms = device_ms(fill.zero_, 20)
        nbytes = crop_bytes(rows, starts, win)
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
        del out, ref, gather, fill
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
    """The two models with weights drawn from ``seed``; RadarNet with
    PerfConfig(pallas_scatter=True), so that the path phases serve through
    the scatter kernel K1 and its launches and times stay comparable with
    earlier runs (phase exact serves the default, the exact max)."""
    from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel
    from rcfd_tpu_torch.nn import init_parameters
    from rcfd_tpu_torch.nn.perf import PerfConfig

    gen = torch.Generator().manual_seed(seed)
    rn = RadarNetModel(**radarnet_kw, device='cpu',
                       perf=PerfConfig(pallas_scatter=True))
    fn = FusionNetModel(**fusionnet_kw, device='cpu')
    init_parameters(rn, gen)
    init_parameters(fn, gen)
    return rn.to(device), fn.to(device)


def radarnet_like(rn, device, **kw):
    """A RadarNet of another patch or perf with ``rn``'s weights (no
    configuration of the smoke changes a parameter's shape) and ``rn``'s
    scatter route (``perf.pallas_scatter``), unless ``pallas_scatter`` is
    given."""
    from dataclasses import replace

    from rcfd_tpu_torch.models import RadarNetModel

    pallas = kw.pop('pallas_scatter', rn.perf.pallas_scatter)
    kw['perf'] = replace(kw.get('perf', rn.perf), pallas_scatter=pallas)
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


def serve_path(name, pipe, reqs, device, expect, batched=False,
               serve=None):
    """Serve the warm-up request, then the counted ones with every launch
    count set to 0 just before and read just after, through ``__call__``
    or, with ``batched``, ``forward_batched`` (or ``serve``, a batched
    entry of ``pipe``). ``expect`` maps each kernel of the path to the
    launches it must make; every other kernel must make none. Checks the
    outputs; returns (outs, ms per request, peak memory bytes,
    launches)."""
    serve = serve or (pipe.forward_batched if batched else pipe)
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


def phase_exact(device, slice_pipe, reqs):
    """The slice at the serving default: RadarNet without pallas_scatter,
    so the exact float max serves (ops/scatter.py, scatter_reduce_ on the
    card, as the JAX package's XLA scatter). No kernel is launched; the
    quasi and response maps equal the exact scatter's of the request's own
    crops, which equal the same function's on the CPU, bit for bit; against
    the K1 slice on the same weights, the quasi pixels that differ are
    14-bit ties and the responses are equal; then the exact scatter and K1
    on the same crops, timed."""
    from rcfd_tpu_torch.ops import scatter as exact
    from rcfd_tpu_torch.ops import scatter_cuda as sc
    from rcfd_tpu_torch.pipeline import TwoStagePipeline, quantize_bridge

    rn = radarnet_like(slice_pipe.radarnet, device, pallas_scatter=None)
    pipe = TwoStagePipeline(rn, slice_pipe.fusionnet, H, W, device=device)
    check(not pipe.pallas_scatter and
          pipe.scatter is exact.scatter_quasi_dense,
          'exact: the default pipeline does not serve the exact scatter')
    outs, _, _, _ = serve_path('exact', pipe, reqs, device, {})
    req = reqs[1]
    _, quasi, response = outs[0]
    crops, xs = radarnet_outputs(pipe, req)
    zs = torch.from_numpy(req[1][:, 2].copy()).to(device)
    valid = torch.from_numpy(req[2]).to(device)
    args = (crops, xs, zs, valid, H, W, PATCH)
    with torch.inference_mode():
        maps = exact.scatter_quasi_dense(*args)
        maps_cpu = exact.scatter_quasi_dense(*[
            a.cpu() if torch.is_tensor(a) else a for a in args])
        check(all(torch.equal(a.cpu(), b) for a, b in zip(maps, maps_cpu)),
              'exact: the exact scatter on the card differs from the CPU')
        q, r = quantize_bridge(*maps)
        check(torch.equal(q, quasi) and torch.equal(r, response),
              'exact: the served maps differ from the exact scatter of the '
              'same crops')
        _, quasi_k1, response_k1 = slice_pipe(*req)
        pixels = torch.nonzero(quasi != quasi_k1).cpu().numpy()
        bad = unexplained_quasi(crops.cpu().numpy(), xs.cpu().numpy(),
                                req[2], pixels, 0.0)
        check(not bad, 'exact: quasi depth differs from K1\'s at {} pixels '
              'that are no 14-bit tie: {}'.format(len(bad), bad[:10]))
        check(torch.equal(response, response_k1),
              'exact: the response differs from K1\'s')
        ms = device_ms(lambda: exact.scatter_quasi_dense(*args), 20)
        ms_k1 = device_ms(lambda: sc.scatter_quasi_dense(*args), 20)
    log('exact: quasi and response == the exact scatter of the same crops, '
        'on the card == on the CPU, bit for bit; against the K1 slice on '
        'the same weights: {} of {} quasi pixels differ, each a 14-bit tie; '
        'responses equal; the scatter alone on these crops: exact {:.3f} '
        'ms, K1 {:.3f} ms (device, median of 20)'.format(
            len(pixels), quasi.numel(), ms, ms_k1))
    stage_times('exact', pipe, req, device)


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


def top_responses(crops, xs, valid, pixels, chunk=1 << 18):
    """For the pixels (row, col) of ``pixels``, an (n, 2) array: the two
    largest crop values of the valid points whose windows cover each pixel
    (-inf where fewer cover it), and how many cover it; float64, over
    chunks of ``chunk`` pixels."""
    from rcfd_tpu_torch.ops import scatter_cuda as sc

    k, ph, pw = crops.shape
    x_start = sc.point_tables(torch.as_tensor(xs), torch.zeros(k),
                              torch.as_tensor(valid), pw, W)[0].numpy()
    pixels = np.asarray(pixels, np.int64).reshape(-1, 2)
    top = np.full((len(pixels), 2), -np.inf)
    count = np.zeros(len(pixels), np.int64)
    for lo in range(0, len(pixels), chunk):
        r, c = pixels[lo:lo + chunk, 0], pixels[lo:lo + chunk, 1]
        j = c[:, None] + pw - x_start[None, :]                  # (n, K)
        hit = np.asarray(valid, bool)[None, :] & (j >= 0) & (j < pw)
        vals = np.where(hit, crops[np.arange(k)[None, :], (r - (H - ph))[
            :, None], np.clip(j, 0, pw - 1)].astype(np.float64), -np.inf)
        vals.partition(k - 2, axis=1)
        top[lo:lo + chunk] = np.sort(vals[:, -2:], axis=1)[:, ::-1]
        count[lo:lo + chunk] = hit.sum(1)
    return top, count


def off_threshold(crops, xs, valid, pixels, tol):
    """The pixels (row, col) of ``pixels`` whose top response is farther
    than ``tol`` from the 0.5 threshold: a perturbation of the crops by at
    most ``tol`` cannot switch their response between 0 and 0.5 or
    more."""
    top, count = top_responses(crops, xs, valid, pixels)
    near = (count > 0) & (np.abs(top[:, 0] - 0.5) <= tol)
    return [tuple(int(v) for v in p) for p in np.asarray(
        pixels).reshape(-1, 2)[~near]]


def excused(crops, xs, valid, pixels, tol, step=2.0 ** -14):
    """For the pixels (row, col) of ``pixels``, whether a perturbation of
    the crops by at most ``tol`` can change their quasi depth: the top
    response there lies within ``tol`` of the 0.5 threshold, or the top two
    lie within ``step`` plus 2 * tol of each other (``step`` 2^-14 for
    K1's 14-bit max, 0 for the exact max)."""
    top, count = top_responses(crops, xs, valid, pixels)
    near = (count > 0) & (np.abs(top[:, 0] - 0.5) <= tol)
    with np.errstate(invalid='ignore'):  # -inf - -inf where none covers
        tie = (count > 1) & (top[:, 0] - top[:, 1] <= step + 2 * tol)
    return near | tie


def unexplained_quasi(crops, xs, valid, pixels, tol, step=2.0 ** -14):
    """The pixels (row, col) of ``pixels`` whose quasi depth a perturbation
    of the crops by at most ``tol`` cannot change (``excused``)."""
    return [tuple(int(v) for v in p) for p in np.asarray(pixels).reshape(
        -1, 2)[~excused(crops, xs, valid, pixels, tol, step)]]


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
BATCHED_PAIRED_ROUNDS = 3
# FusionNet alone (bench.py): batch sizes, and the window timed at each,
# at least this many seconds: chunks of as many requests as one timed
# request says fill it (at least 3), until it is filled
FUSIONNET_BATCHES = (1, 8, 32)
FUSIONNET_WINDOW_S = 0.5
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
    # each decode chunk's first and last frame against __call__
    for b, frames in ((8, (0, 3, 4, 7)), (16, (0, 7, 8, 15))):
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
        check_frames(name, slice_pipe, batches[b][1], outs[0], frames)
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
    and, folded, at B = 16, frames at both ends of the batch and of each
    decode chunk against __call__; paired rounds
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
            (8, served['slice'], 'batched bf16 B=8', (0, 3, 4, 7)),
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


# -- file I/O and the serving CLI ---------------------------------------------

# the CLI phase: frames written to files, and the five configurations of
# rcfd_tpu_torch.run_pipeline it serves them in (name, flags, environment,
# with ground truth, the kernels and launches per frame or per request)
CLI_FRAMES = 8
CLI_BATCH = 4
K1_ENV = {'RCFD_PALLAS_SCATTER': '1'}
CLI_RUNS = (
    ('cli a', ['--batch_size', '1'], {}, True),
    ('cli b', ['--batch_size', str(CLI_BATCH)], K1_ENV, False),
    ('cli c', ['--bfloat16', '--batch_size', str(CLI_BATCH)], K1_ENV, False),
    ('cli d', ['--patch_size', str(WIDE_PATCH[0]), str(WIDE_PATCH[1]),
               '--batch_size', '1'], K1_ENV, False),
    ('cli e', ['--batch_size', '1'],
     dict(K1_ENV, RCFD_FUSED_POOL2='1', RCFD_FUSED_POOL4='1'), True),
)
# a JPEG frame of the repository and PIL's decode of it, and the decoders'
# agreement the JAX package asks of its own codec
# (tests/test_native_io.py::test_image_decode_jpeg)
JPEG_FIXTURE = os.path.join('tests', 'data', 'torch_io', 'frame_q95.jpg')
JPEG_PIL_DECODE = os.path.join('tests', 'data', 'torch_io',
                               'frame_q95_pil.png')
JPEG_MEAN_ABS, JPEG_MAX_ABS = 1.0, 16.0
CODEC_REPEATS = 5


def toolchain_line():
    """What the codec's routes need on this machine, on one line: g++, the
    headers and libraries of libpng, libjpeg, zlib and nvJPEG."""
    proc = subprocess.run(['g++', '--version'], capture_output=True,
                          text=True)
    gxx = proc.stdout.splitlines()[0] if proc.returncode == 0 else 'missing'
    headers = {h: os.path.exists(h) for h in (
        '/usr/include/png.h', '/usr/include/jpeglib.h', '/usr/include/zlib.h',
        '/usr/local/cuda/include/nvjpeg.h')}
    proc = subprocess.run(['ldconfig', '-p'], capture_output=True, text=True)
    libs = sorted({line.split()[0] for line in proc.stdout.splitlines()
                   if any(s in line for s in ('libpng', 'libjpeg', 'libz.so',
                                              'libnvjpeg'))})
    return 'codec: toolchain: g++ {}; headers {}; libraries {}'.format(
        gxx, ', '.join('{} {}'.format(h, 'present' if ok else 'missing')
                       for h, ok in headers.items()),
        ', '.join(libs) or 'none')


def camera_frame(rng):
    """A uint8 frame that compresses like a camera's: smooth gradients and
    a few flat patches, plus noise of a few levels."""
    h, w = H, W
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    frame = np.stack([x * 255 / w, y * 255 / h,
                      128 + 90 * np.sin(x / 37.0) * np.cos(y / 23.0)], -1)
    for _ in range(6):
        r, c = rng.integers(0, h - h // 9), rng.integers(0, w - w // 8)
        frame[r:r + h // 9, c:c + w // 8] = rng.integers(0, 256, 3)
    frame += rng.normal(0, 4, frame.shape)
    return np.clip(frame, 0, 255).astype(np.uint8)


def ground_truth(rng):
    """A lidar-like ground-truth map: 5% of the pixels, 1 to 80 m."""
    h, w = H, W
    z = (rng.random((h, w), dtype=np.float32) * 79 + 1).astype(np.float32)
    z[rng.random((h, w)) > 0.05] = 0.0
    return z


def host_ms(fn, n=CODEC_REPEATS):
    """Median host milliseconds of ``fn`` over ``n`` runs, after one."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_codec(device, tmp):
    """Build the codec (g++; nvJPEG for JPEG on the card), then at 900x1600:
    a depth map and a response map through save_*/load_* and through
    save_*_encoded, exact; an RGB frame through save_image/load_image_u8,
    exact; the repository's JPEG frame decoded on the card against PIL's
    decode; ms per frame to read a camera frame and a ground truth, and to
    write the three output PNGs."""
    from rcfd_tpu_torch import native
    from rcfd_tpu_torch.data import io

    log(toolchain_line())
    t0 = time.perf_counter()
    native.codec_lib()
    t1 = time.perf_counter()
    native.nvjpeg_lib()
    t2 = time.perf_counter()
    log('codec: built codec.cpp in {:.2f} s and jpeg_nvjpeg.cpp in {:.2f} s '
        '(g++); PNG: zlib {} of the standard library, level {}'.format(
            t1 - t0, t2 - t1, zlib.ZLIB_RUNTIME_VERSION,
            native.ZLIB_LEVEL))
    try:
        native.jpeg_host_lib()
        log('codec: libjpeg also builds here (the CPU route of JPEG)')
    except RuntimeError as e:
        log('codec: the CPU route of JPEG does not build here, as expected '
            'without libjpeg: {}'.format(str(e).splitlines()[0]))

    rng = np.random.default_rng(SEED + 11)
    dense = (rng.random((H, W), dtype=np.float32) * 99 + 1).astype(np.float32)
    dense[0, :3] = [1.0, 65535 / 256.0, 99.99609375]
    quasi = np.zeros((H, W), np.float32)
    quasi[H - PATCH[0]:, ::17] = rng.integers(0, 80, (PATCH[0], -(-W // 17)))
    response = np.zeros((H, W), np.float32)
    response[H - PATCH[0]:, ::3] = rng.random((PATCH[0], -(-W // 3)),
                                              dtype=np.float32)
    response[H - 1, :3] = [2.0 ** -14, 1.0 - 2.0 ** -14, 1.0]
    paths = {n: os.path.join(tmp, n + '.png') for n in (
        'dense', 'quasi', 'response', 'dense_c', 'quasi_c', 'response_c',
        'frame')}

    def write_floats():
        io.save_depth(dense, paths['dense'])
        io.save_depth(quasi, paths['quasi'])
        io.save_response(response, paths['response'])

    codes = (native.depth_codes(dense, 256.0), native.depth_codes(quasi, 256.0),
             native.depth_codes(response, 2.0 ** 14))

    def write_codes():
        io.save_depth_encoded(codes[0], paths['dense_c'])
        io.save_depth_encoded(codes[1], paths['quasi_c'])
        io.save_response_encoded(codes[2], paths['response_c'])

    write_floats()
    write_codes()
    for name, code, scale, loader in (
            ('dense', codes[0], 256.0, io.load_depth),
            ('quasi', codes[1], 256.0, io.load_depth),
            ('response', codes[2], 2.0 ** 14, io.load_response)):
        want = code.astype(np.float32) / np.float32(scale)
        for path in (paths[name], paths[name + '_c']):
            check(np.array_equal(loader(path), want),
                  'codec: {} read back from {} differs from its codes'.format(
                      name, os.path.basename(path)))
            check(np.array_equal(io.load_depth_u16(path), code),
                  'codec: {} codes read back differ'.format(name))
        with open(paths[name], 'rb') as f, open(paths[name + '_c'], 'rb') as g:
            check(f.read() == g.read(), 'codec: the {} file of save_*_encoded '
                  'differs from save_*\'s'.format(name))
    frame = camera_frame(rng)
    io.save_image(frame / 255.0, paths['frame'])
    check(np.array_equal(io.load_image_u8(paths['frame'], device=device),
                         frame), 'codec: the RGB frame read back differs')
    log('codec: 900x1600 round trips exact: dense, quasi and response through '
        'save_*/load_* and save_*_encoded (codes 0, 1, 65535 included; the '
        'two writers\' files equal byte for byte), the RGB frame through '
        'save_image/load_image_u8')

    jpeg = io.load_image_u8(os.path.join(HERE, JPEG_FIXTURE), device=device)
    pil = io.load_image_u8(os.path.join(HERE, JPEG_PIL_DECODE), device=device)
    diff = np.abs(jpeg.astype(np.float64) - pil)
    check(jpeg.shape == pil.shape and diff.mean() < JPEG_MEAN_ABS and
          diff.max() <= JPEG_MAX_ABS, 'codec: nvJPEG\'s decode of {} is {} '
          'from PIL\'s: mean |diff| {}, max {} (tolerance < {}, <= {})'.format(
              JPEG_FIXTURE, jpeg.shape, diff.mean(), diff.max(),
              JPEG_MEAN_ABS, JPEG_MAX_ABS))
    log('codec: {} {} decoded on the card with nvJPEG against PIL\'s decode: '
        'mean |diff| {:.4f}, max {:.0f} (tolerance < {:g}, <= {:g})'.format(
            JPEG_FIXTURE, 'x'.join(map(str, jpeg.shape[:2])), diff.mean(),
            diff.max(), JPEG_MEAN_ABS, JPEG_MAX_ABS))

    gt_path = os.path.join(tmp, 'gt.png')
    io.save_depth(ground_truth(rng), gt_path)
    times = dict(
        read_frame=host_ms(lambda: io.load_image_u8(paths['frame'],
                                                    device=device)),
        read_ground_truth=host_ms(lambda: io.load_depth_u16(gt_path)),
        write_three_float=host_ms(write_floats),
        write_three_encoded=host_ms(write_codes))
    sizes = {n: os.path.getsize(paths[n]) for n in ('frame', 'dense', 'quasi',
                                                    'response')}
    log('codec: host ms per 900x1600 frame, median of {}: {}; file bytes: '
        '{}; {}'.format(CODEC_REPEATS, ', '.join(
            '{} {:.2f}'.format(k, v) for k, v in times.items()),
            sizes, gpu_name_and_power()))


def write_cli_inputs(rn, fn, tmp, rng):
    """CLI_FRAMES full-size frames with the port's own writers (RGB PNGs,
    .npy point sets of 40 to 64 points, 16-bit ground truth), the
    manifests, and the two models as reference-layout .pth checkpoints."""
    from rcfd_tpu_torch import native
    from rcfd_tpu_torch.data import io
    from rcfd_tpu_torch.models import fusionnet, radarnet

    paths = {n: [] for n in ('image', 'radar', 'ground_truth')}
    for i in range(CLI_FRAMES):
        for n in paths:
            paths[n].append(os.path.join(tmp, '{}_{:02d}.{}'.format(
                n, i, 'npy' if n == 'radar' else 'png')))
        native.write_rgb(paths['image'][i], camera_frame(rng))
        k = int(rng.integers(40, K + 1))
        np.save(paths['radar'][i], np.stack(
            [rng.integers(0, W, k), rng.integers(0, H, k),
             rng.random(k) * 79 + 1], 1).astype(np.float32))
        io.save_depth(ground_truth(rng), paths['ground_truth'][i])
    manifests = {}
    for n, p in paths.items():
        manifests[n] = os.path.join(tmp, n + '.txt')
        io.write_paths(manifests[n], p)
    checkpoints = []
    for model, keys, name in ((rn, radarnet.PTH_KEYS, 'radarnet'),
                              (fn, fusionnet.PTH_KEYS, 'fusionnet')):
        checkpoints.append(os.path.join(tmp, name + '.pth'))
        torch.save(dict({keys[part]: {k: v.cpu() for k, v in getattr(
            model, part).state_dict().items()} for part in keys},
            train_step=0), checkpoints[-1])
    return paths, manifests, checkpoints


def cli_patch(flags):
    return [int(v) for v in flags[flags.index('--patch_size') + 1:][:2]] \
        if '--patch_size' in flags else list(PATCH)


def cli_expect(flags, env):
    """The launches a CLI run of CLI_FRAMES frames must make: with
    RCFD_PALLAS_SCATTER=1 the scatter kernel once a request (at the
    default, the exact max, none); at a patch width that is not a multiple
    of 32 (the 900x300 patch) the column crop 3 times a frame; with the
    fused gates the gather-add twice a frame."""
    batch = int(flags[flags.index('--batch_size') + 1])
    k1 = 'scatter_quasi_dense' + (' bf16' if '--bfloat16' in flags else '')
    expect = {}
    if env.get('RCFD_PALLAS_SCATTER'):
        expect[k1] = -(-CLI_FRAMES // batch)
    if cli_patch(flags)[1] % 32:
        expect['column_crop'] = 3 * CLI_FRAMES
    if env.get('RCFD_FUSED_POOL2'):
        expect['fused_skip_gather_add'] = 2 * CLI_FRAMES
    return expect


def cli_pipeline(checkpoints, flags, env, device):
    """A pipeline built as the CLI builds it for ``flags`` and ``env``."""
    from rcfd_tpu_torch.pipeline import TwoStagePipeline
    from rcfd_tpu_torch.run_pipeline import perf_from_env

    return TwoStagePipeline.from_checkpoints(
        *checkpoints, image_height=H, image_width=W,
        patch_size=cli_patch(flags),
        radarnet_kwargs=dict(perf=perf_from_env(env)), optimize=True,
        compute_dtype=torch.bfloat16 if '--bfloat16' in flags else None,
        device=device)


def cli_reference(pipe, flags, samples):
    """The frames ``samples`` served in memory by ``pipe`` in the CLI's
    requests: per frame (dense, quasi, response), float32 numpy."""
    batch = int(flags[flags.index('--batch_size') + 1])
    out = []
    for start in range(0, len(samples), batch):
        s = samples[start:start + batch]
        if len(s) > 1:
            maps = pipe.forward_batched(np.stack([x[0] for x in s]),
                                        np.stack([x[1] for x in s]),
                                        np.stack([x[2] for x in s]))
        else:
            maps = [m[None] for m in pipe(s[0][0][None], s[0][1], s[0][2])]
        maps = [m.float().cpu().numpy() for m in maps]
        out += [tuple(m[b] for m in maps) for b in range(len(s))]
    return out


def write_breakdown(name, maps, repeats=3):
    """Where the float writers' time goes on one frame's (dense, quasi,
    response) maps: the 16-bit codes, the row filters, deflate at the
    writer's level (and at zlib's default 6, for comparison), the file
    write; host ms, median of ``repeats``, and the deflated bytes."""
    from rcfd_tpu_torch import native

    lib = native.codec_lib()
    times = {k: [] for k in ('codes', 'filter', 'deflate', 'deflate_level_6',
                             'file_write')}
    sizes = []
    for _ in range(repeats):
        sums = dict.fromkeys(times, 0.0)
        sizes = []
        for m, scale in zip(maps, (256.0, 256.0, 2.0 ** 14)):
            t0 = time.perf_counter()
            rows = native.depth_codes(m, scale).astype('>u2').view(
                np.uint8).reshape(m.shape[0], -1)
            t1 = time.perf_counter()
            filtered = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
            scratch = np.empty(2 * rows.shape[1], np.uint8)
            lib.rcfd_png_filter(rows.ctypes.data, filtered.ctypes.data,
                                rows.shape[0], rows.shape[1], 2,
                                scratch.ctypes.data)
            t2 = time.perf_counter()
            data = zlib.compress(filtered, native.ZLIB_LEVEL)
            t3 = time.perf_counter()
            zlib.compress(filtered, 6)
            t4 = time.perf_counter()
            with tempfile.TemporaryFile() as f:
                f.write(data)
            t5 = time.perf_counter()
            for k, a, b in (('codes', t0, t1), ('filter', t1, t2),
                            ('deflate', t2, t3), ('deflate_level_6', t3, t4),
                            ('file_write', t4, t5)):
                sums[k] += (b - a) * 1e3
            sizes.append(len(data))
        for k in times:
            times[k].append(sums[k])
    log('{}: the float writers on frame 0\'s three maps, host ms, median of '
        '{}: {}; deflated bytes (dense, quasi, response) {}'.format(
            name, repeats, ', '.join('{} {:.2f}'.format(
                k, float(np.median(v))) for k, v in times.items()), sizes))


def cli_files(out_dir, names):
    from rcfd_tpu_torch.data import io
    from rcfd_tpu_torch.run_pipeline import STREAMS

    return [tuple(io.load_depth_u16(os.path.join(out_dir, s, n)).astype(
        np.int64) for s in STREAMS) for n in names]


def compare_codes(name, files, ref, crops_of_frame, samples, crop_tol,
                  dense_tol):
    """Files (dense, quasi, response codes) against other codes of the same
    frames: response within one count, and farther only where the top
    response is within crop_tol of the threshold; quasi equal except at
    pixels a 14-bit tie or the threshold explains (crops_of_frame(f) are
    the crops and padded x of frame f); dense within dense_tol counts where
    the frame's quasi and response codes are equal. Returns the numbers of
    differing codes (dense, quasi, response)."""
    counts = np.zeros(3, np.int64)
    for f, (got, want) in enumerate(zip(files, ref)):
        diff = [np.abs(g - w) for g, w in zip(got, want)]
        counts += [int((d > 0).sum()) for d in diff]
        quasi_px = np.argwhere(diff[1] > 0)
        resp_px = np.argwhere(diff[2] > 1 + math.ceil(crop_tol * 2 ** 14))
        if len(quasi_px) or len(resp_px):
            crops, xs = crops_of_frame(f)
            valid = samples[f][2]
            bad = unexplained_quasi(crops, xs, valid, quasi_px, crop_tol)
            check(not bad, '{}: frame {}: quasi codes differ at {} pixels no '
                  'tie or threshold explains: {}'.format(
                      name, f, len(bad), bad[:10]))
            bad = off_threshold(crops, xs, valid, resp_px, crop_tol)
            check(not bad, '{}: frame {}: response codes differ by more than '
                  'a step at {} pixels away from the threshold: {}'.format(
                      name, f, len(bad), bad[:10]))
        elif not (diff[1].any() or diff[2].any()):
            check(diff[0].max() <= dense_tol, '{}: frame {}: dense codes '
                  'differ by {} > {} with equal maps'.format(
                      name, f, diff[0].max(), dense_tol))
    return counts


def phase_cli(device, record, rn, fn, tmp):
    """rcfd_tpu_torch.run_pipeline.main in process on files the port wrote,
    in the five configurations of CLI_RUNS, each run once (its time holds
    cuDNN's autotuning of shapes no earlier phase served), with every
    launch count set to 0 just before the run and read just after; each
    run's files against the same frames served in memory by a pipeline
    built the same way; run a's (float
    writers, one frame a request) against run b's (codec writers, batched)."""
    from rcfd_tpu_torch import run_pipeline
    from rcfd_tpu_torch.data.datasets import RadarNetInferenceDataset

    rng = np.random.default_rng(SEED + 12)
    paths, manifests, checkpoints = write_cli_inputs(rn, fn, tmp, rng)
    base = ['--radarnet_restore_path', checkpoints[0],
            '--fusionnet_restore_path', checkpoints[1],
            '--image_path', manifests['image'],
            '--radar_path', manifests['radar'], '--save_outputs']
    dataset = RadarNetInferenceDataset(paths['image'], paths['radar'],
                                       max_points=None, device=device)
    samples = [dataset.get(i) for i in range(CLI_FRAMES)]
    names = ['{:010d}.png'.format(i) for i in range(CLI_FRAMES)]
    power = gpu_name_and_power()
    files = {}
    for name, flags, env, with_gt in CLI_RUNS:
        argv = base + flags + (['--ground_truth_path',
                                manifests['ground_truth']] if with_gt else [])
        out_dir = os.path.join(tmp, name.replace(' ', '_'))
        with environ(env):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            summary = run_pipeline.main(
                argv + ['--output_dirpath', out_dir], device=device)
            wall = time.perf_counter() - t0
            launches = read_launches()
        expect = cli_expect(flags, env)
        for kernel, n in launches.items():
            check(n == expect.get(kernel, 0), '{}: {} launched {} times for '
                  '{} frames, expected {}'.format(name, kernel, n, CLI_FRAMES,
                                                  expect.get(kernel, 0)))
        count_launches(record, name, launches, list(expect))
        if with_gt:
            check(summary['metrics'] is not None and all(
                math.isfinite(v) for v in summary['metrics'].values()),
                '{}: metrics {}'.format(name, summary['metrics']))
        files[name] = cli_files(out_dir, names)
        pipe = cli_pipeline(checkpoints, flags, env, device)
        ref = cli_reference(pipe, flags, samples)
        ref_codes = [tuple(c.astype(np.int64) for c in native_codes(m))
                     for m in ref]
        bf16 = '--bfloat16' in flags
        counts = compare_codes(
            name, files[name], ref_codes,
            lambda f: tuple(t.float().cpu().numpy() for t in radarnet_outputs(
                pipe, (samples[f][0][None], samples[f][1], samples[f][2]))),
            samples, BF16_CROP_TOL if bf16 else FOLD_TOL, 1)
        del pipe
        torch.cuda.empty_cache()
        if name == CLI_RUNS[0][0]:
            write_breakdown(name, ref[0])
        sec = summary['seconds']
        log('{}: flags {} env {}: {} frames in {:.3f} s of main, {:.3f} '
            'frames/s end to end; per frame: host read {:.2f} ms, device '
            '(serve to the outputs on the host) {:.2f} ms, host write {:.2f} '
            'ms; setup {:.3f} s; launches {}; metrics {}; files against the '
            'same frames served in memory: codes that differ (dense, quasi, '
            'response) {}; {}'.format(
                name, ' '.join(flags), env or '{}', CLI_FRAMES, wall,
                CLI_FRAMES / wall, *[1e3 * sec[k] / CLI_FRAMES for k in (
                    'read', 'serve', 'write')], sec['setup'],
                {k: v for k, v in launches.items() if v}, summary['metrics'],
                counts.tolist(), power))
    # run a (the exact max, float writers, one frame a request) against run
    # b (K1, codec writers, forward_batched): the same frames, served two
    # ways
    ref_pipe = cli_pipeline(checkpoints, CLI_RUNS[0][1], {}, device)
    counts = compare_codes(
        'cli a vs b', files['cli b'][:CLI_FRAMES // 4],
        files['cli a'][:CLI_FRAMES // 4],
        lambda f: tuple(t.float().cpu().numpy() for t in radarnet_outputs(
            ref_pipe, (samples[f][0][None], samples[f][1], samples[f][2]))),
        samples, FOLD_TOL, 1)
    log('cli a vs b: the first {} frames, one a request with the exact max '
        'and the float writers and {} a request with K1 and the codec '
        'writers: codes that differ (dense, quasi, response) {}, each quasi '
        'and response difference at a 14-bit tie or the threshold'.format(
            CLI_FRAMES // 4, CLI_BATCH, counts.tolist()))


# -- FusionNet training ------------------------------------------------------

# phase train: full-size frames the port's writers put in a temporary
# directory, and bash/train_fusionnet_nuscenes.sh's flags with 10 steps of
# batch 16 (schedule 10 over 16 frames), a checkpoint and a validation
# every 5 steps; then a resumed run to step 15
TRAIN_SCRIPT = os.path.join('bash', 'train_fusionnet_nuscenes.sh')
TRAIN_FRAMES = 16
VAL_FRAMES = 4
TRAIN_STREAMS = ('image', 'depth', 'response', 'ground_truth', 'lidar')
VAL_STREAMS = ('image', 'depth', 'response', 'ground_truth')
# steps whose times make the median ms a step (the first two choose cuDNN's
# algorithms)
TIMED_STEPS = range(3, 11)
OVERFIT_STEPS = 30
# card against CPU, one train step of a narrow FusionNet: loss relative,
# gradients as a share of each one's max-abs (cuDNN's backward sums in
# another order), running statistics relative
CARD_LOSS_RTOL, CARD_GRAD_TOL, CARD_STATS_RTOL = 1e-5, 1e-3, 1e-5


def script_flags(path):
    """The flags of a training script's python command: {'--flag':
    [values]}."""
    with open(os.path.join(HERE, path)) as f:
        tokens = f.read().replace('\\\n', ' ').split()
    tokens = tokens[tokens.index('python') + 2:]
    flags, key = {}, None
    for t in tokens:
        if t.startswith('--'):
            key = t
            flags[key] = []
        elif key is not None:
            flags[key].append(t)
    return flags


def training_frame(rng, split):
    """One quintuple (training) or quadruple (validation) of maps like
    nuScenes': a camera frame; quasi-dense radar depth (integer meters on
    about 3% of the lower half) and its response; for training an
    interpolated ground truth (dense below the horizon) and a lidar map (5%
    of the pixels); for validation the lidar map as the ground truth."""
    depth = np.zeros((H, W), np.float32)
    hit = rng.random((H, W)) < 0.03
    hit[:H // 2] = False
    depth[hit] = np.floor(rng.random(int(hit.sum())) * 79 + 1)
    response = np.where(hit, 0.5 + 0.5 * rng.random((H, W)), 0.0).astype(
        np.float32)
    lidar = ground_truth(rng)
    maps = {'image': camera_frame(rng), 'depth': depth, 'response': response}
    if split == 'val':
        maps['ground_truth'] = lidar
        return maps
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    interp = 5 + 70 * (1 - y / H) + 3 * np.sin(x / 50.0)
    interp[: int(0.4 * H)] = 0.0
    maps.update(ground_truth=interp.astype(np.float32), lidar=lidar)
    return maps


def write_training_inputs(tmp, rng):
    """TRAIN_FRAMES training quintuples and VAL_FRAMES validation frames
    at 900x1600 with the port's writers (RGB PNGs, x256 depth PNGs, x2^14
    response PNGs), written by 8 threads, and their manifests."""
    from concurrent.futures import ThreadPoolExecutor

    from rcfd_tpu_torch import native
    from rcfd_tpu_torch.data import io

    # each writer takes (path, map)
    writers = {'image': native.write_rgb,
               'response': lambda path, r: io.save_response(r, path)}
    jobs, manifests = [], {}
    for split, n, streams in (('train', TRAIN_FRAMES, TRAIN_STREAMS),
                              ('val', VAL_FRAMES, VAL_STREAMS)):
        paths = {k: [] for k in streams}
        for i in range(n):
            maps = training_frame(rng, split)
            for k in streams:
                paths[k].append(os.path.join(tmp, '{}_{}_{:02d}.png'.format(
                    split, k, i)))
                jobs.append((writers.get(k, lambda path, z: io.save_depth(
                    z, path)), paths[k][-1], maps[k]))
        for k in streams:
            manifests[split, k] = os.path.join(tmp, '{}_{}.txt'.format(
                split, k))
            io.write_paths(manifests[split, k], paths[k])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda job: job[0](job[1], job[2]), jobs))
    log('train: wrote {} PNGs of {}x{} in {:.2f} s'.format(
        len(jobs), H, W, time.perf_counter() - t0))
    return manifests


def train_argv(manifests, checkpoint_dirpath, schedule, restore=None):
    """bash/train_fusionnet_nuscenes.sh's flags, with this run's
    manifests, schedule, checkpoint directory and restore path, a
    checkpoint and a validation every 5 steps."""
    flags = script_flags(TRAIN_SCRIPT)
    for split, streams in (('train', TRAIN_STREAMS), ('val', VAL_STREAMS)):
        for k in streams:
            name = 'lidar_map' if k == 'lidar' else k
            flags['--{}_{}_path'.format(split, name)] = [
                manifests[split, k]]
    flags.update({'--learning_schedule': [str(schedule)],
                  '--n_step_per_checkpoint': ['5'],
                  '--start_step_validation': ['5'],
                  '--checkpoint_dirpath': [checkpoint_dirpath]})
    if restore:
        flags['--restore_path'] = [restore]
    return [t for k, v in flags.items() for t in [k] + v]


def validation_lines(results_path):
    """The rows under 'Validation results' in a results.txt: (step, MAE,
    RMSE, iMAE, iRMSE) of FusionNet's, and the three pixel counts after
    them in RadarNet's."""
    with open(results_path) as f:
        lines = f.read().splitlines()
    return [[float(v) for v in lines[i + 2].split()]
            for i, line in enumerate(lines)
            if line == 'Validation results:']


def check_checkpoint(path, step):
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    check(sorted(ckpt) == ['decoder_state_dict', 'encoder_state_dict',
                           'optimizer_state_dict', 'train_step'],
          'train: {} has keys {}'.format(path, sorted(ckpt)))
    state = ckpt['optimizer_state_dict']['state']
    check(ckpt['train_step'] == step and state and
          all(int(e['step']) == step for e in state.values()),
          'train: {} is not at step {} (Adam steps {})'.format(
              path, step, sorted({int(e['step']) for e in state.values()})))


def narrow_step_card_vs_cpu(device, kw, shape, seed, float64=False):
    """One train step of a narrow FusionNet (``kw``) on the card and on the
    CPU from the same weights (drawn from ``seed``) and batch of 2 frames
    of ``shape``, augmentation off: the loss's relative error, the
    gradients' largest error as a share of each one's max-abs, the new
    running statistics' relative error; and the two models after the
    step's backward. With ``float64`` also the same step in float64 on
    the CPU, and each device's largest gradient error from it as a share
    of its largest gradient (``card_err``, ``cpu_err``)."""
    from rcfd_tpu_torch import fusionnet_main as fm
    from rcfd_tpu_torch.data import transport
    from rcfd_tpu_torch.data.transforms import Transforms
    from rcfd_tpu_torch.models import FusionNetModel
    from rcfd_tpu_torch.nn import init_parameters

    cpu = FusionNetModel(**kw, device='cpu', trainable=True)
    init_parameters(cpu, torch.Generator().manual_seed(seed))
    card = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(seed)
    batch = tuple(torch.from_numpy(a) for a in (
        rng.integers(0, 256, (2, *shape, 3), dtype=np.uint8),
        *[(rng.random((2, *shape, 1)) * 60 * 256).astype(np.uint16)
          for _ in range(4)]))
    transforms = Transforms(normalized_image_range=[0, 1])
    runs = [('cpu', cpu, batch), ('card', card,
                                  tuple(t.to(device) for t in batch))]
    if float64:
        runs.append(('cpu float64', copy.deepcopy(cpu).double(),
                     tuple(t.double() for t in transport.decode(batch))))
    out = {}
    for name, model, inputs in runs:
        step = fm.TrainStep(model, transforms,
                            fm.make_optimizer(model, 1e-3, 0.0), 'l1', 0.0,
                            2.0, -1, 7, 1.5, -1)
        with fm.training_numerics():
            info = step.backward(inputs, {})
        out[name] = (float(info['loss']),
                     {n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None},
                     {n: b.cpu().double() for n, b in model.named_buffers()})
    (loss_c, grads_c, bufs_c), (loss_g, grads_g, bufs_g) = out['cpu'], \
        out['card']
    check(sorted(grads_g) == sorted(grads_c), 'card vs CPU: the card and the '
          'CPU gave gradients to different parameters')
    r = dict(
        loss_err=abs(loss_g - loss_c) / abs(loss_c),
        grad_err=max(float((grads_g[n] - g).abs().max() / g.abs().max())
                     for n, g in grads_c.items() if g.abs().max() > 0),
        stats_err=max(float((bufs_g[n] - b).abs().max() /
                            max(float(b.abs().max()), 1.0))
                      for n, b in bufs_c.items()),
        n_grads=len(grads_c), cpu=cpu, card=card)
    if float64:
        truth = out['cpu float64'][1]
        largest = max(float(g.abs().max()) for g in truth.values())
        for key, grads in (('card_err', grads_g), ('cpu_err', grads_c)):
            r[key] = max(float((grads[n].double() - g).abs().max())
                         for n, g in truth.items()) / largest
    return r


def train_card_vs_cpu(device):
    """One train step of a narrow FusionNet on the card and on the CPU from
    the same weights and batch, augmentation off: loss, gradients and the
    new running statistics."""
    kw = dict(FUSIONNET, n_filters_encoder_image=[8, 16, 16, 16, 16, 16],
              n_filters_encoder_depth=[8, 8, 16, 16, 16, 16],
              n_filters_decoder=[16, 16, 16, 8, 8, 8])
    r = narrow_step_card_vs_cpu(device, kw, (64, 96), SEED + 20)
    check(r['loss_err'] <= CARD_LOSS_RTOL and
          r['grad_err'] <= CARD_GRAD_TOL and
          r['stats_err'] <= CARD_STATS_RTOL, 'train: card vs CPU: loss rel '
          'err {}, gradient err {} of max-abs, running statistics rel err {}'
          .format(r['loss_err'], r['grad_err'], r['stats_err']))
    log('train: one step of a narrow FusionNet, card vs CPU from the same '
        'weights and batch: loss rel err {:.3g} (tolerance {:g}), gradients '
        'max err {:.3g} of their max-abs over {} tensors (tolerance {:g}), '
        'running statistics rel err {:.3g} (tolerance {:g})'.format(
            r['loss_err'], CARD_LOSS_RTOL, r['grad_err'], r['n_grads'],
            CARD_GRAD_TOL, r['stats_err'], CARD_STATS_RTOL))


def train_overfit(device):
    """tests/test_learning_sanity.py's protocol at full width: the canonical
    FusionNet, one fixed batch of 16 crops of 448x448 with a constant 20 m
    target, OVERFIT_STEPS steps of Adam at 1e-3; the last loss must be
    below the first."""
    from rcfd_tpu_torch import fusionnet_main as fm
    from rcfd_tpu_torch.data.transforms import Transforms
    from rcfd_tpu_torch.models import FusionNetModel
    from rcfd_tpu_torch.nn import init_parameters

    model = FusionNetModel(**FUSIONNET, device='cpu', trainable=True)
    init_parameters(model, torch.Generator().manual_seed(SEED + 21))
    model.to(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    shape = (16, 448, 448)
    batch = ((torch.rand(*shape, 3, generator=gen, device=device) * 255),
             torch.rand(*shape, 1, generator=gen, device=device) * 60,
             torch.rand(*shape, 1, generator=gen, device=device),
             torch.full((*shape, 1), 20.0, device=device),
             torch.zeros((*shape, 1), device=device))
    transforms = Transforms(normalized_image_range=[0, 1])
    step = fm.TrainStep(model, transforms, fm.make_optimizer(model, 1e-3,
                                                             0.0),
                        'l1', 0.0, 0.0, -1, -1, -1, -1)
    with fm.training_numerics():
        losses = [float(step(batch, {}, 1e-3)['loss'])
                  for _ in range(OVERFIT_STEPS)]
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          'train: overfit at full width: losses {}'.format(losses))
    log('train: overfit at full width (16 x 448x448, constant 20 m target, '
        '{} steps): loss {:.4f} -> {:.4f}, last/first {:.4f}; every 5th: '
        '{}'.format(OVERFIT_STEPS, losses[0], losses[-1],
                    losses[-1] / losses[0],
                    ', '.join('{:.3f}'.format(v) for v in losses[::5])))


def train_raw_cache(device, manifests, tmp, uncached_wait_ms):
    """The training CLI once more on the same files and flags with
    --raw_cache_dirpath: every step is an epoch (16 frames, batch 16), so
    step 1 decodes every file and writes the cache, steps 2-10 map it.
    Prints the host's wait for step 1 and the median of steps 2-10 beside
    the uncached run's median (steps 3-10); then the loader's batches of
    two epochs, without the cache and with a fresh one (a cold epoch, a
    warm one), must be equal byte for byte."""
    from rcfd_tpu_torch import train_fusionnet
    from rcfd_tpu_torch.data import io, raw_cache
    from rcfd_tpu_torch.data.datasets import FusionNetTrainingDataset
    from rcfd_tpu_torch.data.loader import DataLoader

    cache = os.path.join(tmp, 'raw_cache')
    timings = []
    t0 = time.perf_counter()
    train_fusionnet.main(train_argv(manifests, os.path.join(
        tmp, 'checkpoints_cached'), 10) + ['--raw_cache_dirpath', cache],
        timings=timings)
    wall = time.perf_counter() - t0
    check([t['step'] for t in timings] == list(range(1, 11)) and
          all(math.isfinite(t['loss']) for t in timings),
          'train cached: steps {} losses {}'.format(
              [t['step'] for t in timings], [t['loss'] for t in timings]))
    check(raw_cache.cache_dir() is None, 'train cached: the cache stayed '
          'on after the run')
    entries = os.listdir(cache)
    n_files = TRAIN_FRAMES * len(TRAIN_STREAMS) + \
        VAL_FRAMES * len(VAL_STREAMS)
    check(len(entries) == n_files, 'train cached: {} cache entries for {} '
          'training and validation files'.format(len(entries), n_files))
    warm = [t['wait_ms'] for t in timings[1:]]
    log('train cached (--raw_cache_dirpath, {} entries, {} bytes): {:.2f} s '
        'of main; host wait for step 1 (an epoch that decodes every file and '
        'writes the cache) {:.2f} ms; median wait of steps 2-10 (epochs that '
        'map it) {:.2f} ms (min {:.2f}, max {:.2f}) against {:.2f} ms '
        'uncached (median of steps 3-10); median ms a step {:.2f}; {}'.format(
            len(entries), sum(os.path.getsize(os.path.join(cache, e))
                              for e in entries), wall,
            timings[0]['wait_ms'], float(np.median(warm)), min(warm),
            max(warm), uncached_wait_ms,
            float(np.median([t['step_ms'] for t in timings
                             if t['step'] in TIMED_STEPS])),
            gpu_name_and_power()))

    flags = script_flags(TRAIN_SCRIPT)
    dataset = FusionNetTrainingDataset(
        *[io.read_paths(manifests['train', k]) for k in TRAIN_STREAMS],
        shape=(int(flags['--n_height'][0]), int(flags['--n_width'][0])),
        random_crop_type=flags['--augmentation_random_crop_type'],
        device=device)

    def two_epochs():
        loader = DataLoader(dataset, batch_size=int(flags['--batch_size'][0]),
                            shuffle=True, num_workers=8, seed=0,
                            drop_last=True)
        out = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            out.append([tuple(np.array(a) for a in b) for b in loader])
        return out

    ref = two_epochs()
    with raw_cache.raw_cache_for(os.path.join(tmp, 'raw_cache_check')):
        got = two_epochs()
    same = [x.dtype == y.dtype and x.shape == y.shape and
            x.tobytes() == y.tobytes()
            for e, f in zip(got, ref) for b, c in zip(e, f)
            for x, y in zip(b, c)]
    check(len(got) == len(ref) == 2 and same and all(same),
          'train cached: the loader\'s batches with the cache differ from '
          'those without it ({} of {} arrays equal)'.format(sum(same),
                                                             len(same)))
    log('train cached: the loader\'s batches of epochs 1 (cold cache) and 2 '
        '(warm) equal those without the cache byte for byte: {} arrays of '
        'shapes {}'.format(len(same), [a.shape for a in ref[0][0]]))


# -- traced train steps ----------------------------------------------------------

# the trace window of each training phase's resumed run (steps 11-15): the
# port's TraceWindow starts after step 12 and stops after step 14, so steps
# 13 and 14 are traced, outside the timed steps 3-10 of the first run
TRACE_STEPS = '12-14'
TRACED = (13, 14)
# host ranges, and the card's work, in a Chrome trace of torch.profiler
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
TOP_KERNELS = 10


@contextlib.contextmanager
def trace_window(tmp, name, batch_norm_ranges=False):
    """RCFD_PROFILE_DIR (a fresh directory, yielded) and
    RCFD_PROFILE_STEPS=TRACE_STEPS around a training run. With
    ``batch_norm_ranges`` the port's BatchNorm2d.forward runs inside a
    torch.profiler.record_function range 'BatchNorm2d' (for this run only),
    so that ``trace_report`` can tell the batch norms' kernels."""
    from unittest import mock

    from rcfd_tpu_torch.nn import layers

    directory = os.path.join(tmp, 'trace_' + name.replace(' ', '_'))
    ranges = contextlib.nullcontext()
    if batch_norm_ranges:
        forward = layers.BatchNorm2d.forward

        def annotated(self, x):
            with torch.profiler.record_function('BatchNorm2d'):
                return forward(self, x)
        ranges = mock.patch.object(layers.BatchNorm2d, 'forward', annotated)
    with environ({'RCFD_PROFILE_DIR': directory,
                  'RCFD_PROFILE_STEPS': TRACE_STEPS}), ranges:
        yield directory


def union_us(events):
    """Microseconds covered by the union of the events' intervals."""
    total, end = 0.0, -math.inf
    for e in sorted(events, key=lambda e: e['ts']):
        t0, t1 = e['ts'], e['ts'] + e['dur']
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def host_stacks(events):
    """id(event) -> the host ranges (ops, record_function ranges) open
    around each host event on its thread, outermost first: ranges on one
    thread nest, so one sweep in time order with a stack finds them."""
    threads = {}
    for e in events:
        if e.get('cat') in HOST_CATS:
            threads.setdefault((e.get('pid'), e.get('tid')), []).append(e)
    stacks = {}
    for items in threads.values():
        items.sort(key=lambda e: (e['ts'], -e['dur']))
        stack = []
        for e in items:
            while stack and stack[-1]['ts'] + stack[-1]['dur'] <= e['ts']:
                stack.pop()
            stacks[id(e)] = list(stack)
            if e['cat'] in ('cpu_op', 'user_annotation'):
                stack.append(e)
    return stacks


def kernel_sum(kernels):
    return sum(e['dur'] for e in kernels) / 1e3, len(kernels)


def trace_report(directory, name, timings, crop=False, batch_norm=False):
    """What the trace window of a run wrote: exactly one Chrome trace, of
    steps TRACED, holding CUDA kernel events. Prints the card's busy share
    of the window (kernels, copies and fills over the window's span, and
    over the span less the host's waits for steps TRACED from
    ``timings``), the TOP_KERNELS kernels by time with their calls, the
    backward's kernels by the autograd node that launched them, with
    ``crop`` K2's forward (its kernel by name) and its backward (the
    kernels of ColumnCrop's backward node), with ``batch_norm`` the kernels
    of the batch norms (those launched inside a 'BatchNorm2d' range,
    forward, and by the autograd nodes the ops in those ranges made,
    backward). Returns the numbers."""
    want = 'trace-steps-{}-{}.json'.format(*TRACED)
    files = sorted(os.listdir(directory)) if os.path.isdir(directory) else []
    check(files == [want], '{}: the trace window wrote {} ({} expected)'
          .format(name, files, want))
    with open(os.path.join(directory, want)) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X' and 'dur' in e]
    # the profiler's own span, from its start to its stop
    windows = [e for e in events if e.get('cat') == 'Trace']
    events = [e for e in events if e.get('cat') != 'Trace']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    check(kernels and len(windows) == 1, '{}: the trace {} holds {} CUDA '
          'kernel events and {} profiler spans'.format(
              name, want, len(kernels), len(windows)))
    span = windows[0]['dur']
    busy = union_us([e for e in events if e.get('cat') in DEVICE_CATS])
    wait = 1e3 * sum(t['wait_ms'] for t in timings if t['step'] in TRACED)
    kernel_ms, n_kernels = kernel_sum(kernels)
    out = dict(span_ms=span / 1e3, busy_ms=busy / 1e3,
               busy_share=busy / span,
               busy_share_less_wait=busy / max(span - wait, 1.0),
               kernel_ms=kernel_ms, kernels=n_kernels)
    log('{} trace ({}, steps {}-{}): window {:.2f} ms, card busy {:.2f} ms '
        '({:.1f}% of the window; {:.1f}% of it less the host\'s waits for '
        'a batch, {:.2f} ms); {} kernels {:.2f} ms; {}'.format(
            name, want, *TRACED, out['span_ms'], out['busy_ms'],
            100 * out['busy_share'], 100 * out['busy_share_less_wait'],
            wait / 1e3, n_kernels, kernel_ms, gpu_name_and_power()))
    by_name = {}
    for e in kernels:
        entry = by_name.setdefault(e['name'], [0.0, 0])
        entry[0] += e['dur'] / 1e3
        entry[1] += 1
    for kname, (ms, calls) in sorted(by_name.items(),
                                     key=lambda kv: -kv[1][0])[:TOP_KERNELS]:
        log('{} trace: {:9.3f} ms {:5d} calls ({:.1f}% of kernel time)  {}'
            .format(name, ms, calls, 100 * ms / kernel_ms, kname[:100]))
    stacks = host_stacks(events)
    launch = {e['args']['correlation']: e for e in events
              if e.get('cat') in ('cuda_runtime', 'cuda_driver') and
              'correlation' in e.get('args', {})}

    def ranges_of(kernel):
        call = launch.get(kernel.get('args', {}).get('correlation'))
        return [] if call is None else stacks[id(call)]

    # the backward's kernels by the autograd node that launched them
    node_prefix = 'autograd::engine::evaluate_function: '
    by_node = {}
    for e in kernels:
        nodes = [r['name'][len(node_prefix):] for r in ranges_of(e)
                 if r['name'].startswith(node_prefix)]
        if nodes:
            entry = by_node.setdefault(nodes[-1], [0.0, 0])
            entry[0] += e['dur'] / 1e3
            entry[1] += 1
    backward_ms = sum(v[0] for v in by_node.values())
    log('{} trace: the backward\'s kernels {:.2f} ms ({:.1f}% of kernel '
        'time); by autograd node: {}'.format(
            name, backward_ms, 100 * backward_ms / kernel_ms, '; '.join(
                '{} {:.3f} ms in {} kernels'.format(k, ms, n)
                for k, (ms, n) in sorted(by_node.items(),
                                         key=lambda kv: -kv[1][0])[:8])))
    if crop:
        forward = [e for e in kernels if 'column_crop' in e['name']]
        backward = [e for e in kernels if any(
            r['name'] == node_prefix + 'ColumnCropBackward'
            for r in ranges_of(e))]
        check(forward and backward, '{}: no K2 forward ({}) or backward '
              '({}) kernel in the trace'.format(name, len(forward),
                                                len(backward)))
        out['crop_forward_ms'], out['crop_forward'] = kernel_sum(forward)
        out['crop_backward_ms'], out['crop_backward'] = kernel_sum(backward)
        log('{} trace: K2 forward ({}) {:.3f} ms in {} launches; K2 '
            'backward (ColumnCropBackward: zeros and one index_add_, {}) '
            '{:.3f} ms in {} kernels: {:.2f}% and {:.2f}% of the kernel time '
            'of steps {}-{}'.format(
                name, forward[0]['name'][:60], out['crop_forward_ms'],
                out['crop_forward'], ', '.join(sorted({
                    e['name'][:40] for e in backward})),
                out['crop_backward_ms'], out['crop_backward'],
                100 * out['crop_forward_ms'] / kernel_ms,
                100 * out['crop_backward_ms'] / kernel_ms, *TRACED))
    if batch_norm:
        def in_batch_norm(e):
            return any(r['name'] == 'BatchNorm2d' and
                       r['cat'] == 'user_annotation' for r in stacks[id(e)])
        made = {e['args'].get('Sequence number') for e in events
                if e.get('cat') == 'cpu_op' and in_batch_norm(e)}
        made.discard(None)
        nodes = {id(e) for e in events if e.get('cat') == 'cpu_op' and
                 e['name'].startswith('autograd::engine::evaluate_function')
                 and e['args'].get('Sequence number') in made}
        forward = [e for e in kernels if any(
            r['name'] == 'BatchNorm2d' and r['cat'] == 'user_annotation'
            for r in ranges_of(e))]
        backward = [e for e in kernels if any(
            id(r) in nodes for r in ranges_of(e))]
        check(forward and backward, '{}: no batch-norm kernel in the trace '
              '(forward {}, backward {})'.format(name, len(forward),
                                                 len(backward)))
        out['bn_forward_ms'], out['bn_forward'] = kernel_sum(forward)
        out['bn_backward_ms'], out['bn_backward'] = kernel_sum(backward)
        bn_names = {}
        for e in forward + backward:
            bn_names[e['name']] = bn_names.get(e['name'], 0.0) + \
                e['dur'] / 1e3
        log('{} trace: batch norms: forward {:.3f} ms in {} kernels, '
            'backward {:.3f} ms in {} kernels: {:.1f}% of the kernel time of '
            'steps {}-{}; their largest kernels {}'.format(
                name, out['bn_forward_ms'], out['bn_forward'],
                out['bn_backward_ms'], out['bn_backward'],
                100 * (out['bn_forward_ms'] + out['bn_backward_ms']) /
                kernel_ms, *TRACED, ', '.join(
                    '{} {:.2f} ms'.format(k[:50], v) for k, v in sorted(
                        bn_names.items(), key=lambda kv: -kv[1])[:4])))
    return out


def traced_fusionnet_resume(name, manifests, ckpt, tmp,
                            dtype=torch.float32):
    """The training CLI resumed from model-10.pth of ``ckpt`` to step 15
    (``RCFD_TRAIN_DTYPE`` as ``dtype``), its steps 13 and 14 traced with
    the batch norms' ranges: no kernel launched, a float32 model-15.pth
    with an Adam step of 15. Prints the trace's report."""
    from rcfd_tpu_torch import train_fusionnet

    resumed = []
    reset_launches()
    with trace_window(tmp, name, batch_norm_ranges=True) as traces, environ(
            {'RCFD_TRAIN_DTYPE': 'bfloat16' if dtype == torch.bfloat16
             else 'float32'}):
        train_fusionnet.main(train_argv(manifests, ckpt, 15, 'latest'),
                             timings=resumed)
    launches = read_launches()
    check([t['step'] for t in resumed] == list(range(11, 16)) and
          all(math.isfinite(t['loss']) for t in resumed) and
          not any(launches.values()),
          '{}: the resumed run took steps {}, launches {}'.format(
              name, [t['step'] for t in resumed], launches))
    check_checkpoint(os.path.join(ckpt, 'model-15.pth'), 15)
    check_float32_checkpoint(os.path.join(ckpt, 'model-15.pth'))
    log('{}: resumed from model-10.pth (--restore_path latest), took steps '
        '11-15 with RCFD_PROFILE_STEPS={} (steps {}-{} traced), saved '
        'model-15.pth with an Adam step of 15; losses {}; per step (ms, '
        'wait ms): {}'.format(
            name, TRACE_STEPS, *TRACED,
            ', '.join('{:.4f}'.format(t['loss']) for t in resumed),
            ', '.join('{:.1f}/{:.1f}'.format(t['step_ms'], t['wait_ms'])
                      for t in resumed)))
    trace_report(traces, name, resumed, batch_norm=True)


def phase_train(device, rn, tmp):
    """FusionNet training on the card: python -m
    rcfd_tpu_torch.train_fusionnet's main, in process, with
    bash/train_fusionnet_nuscenes.sh's flags on full-size files (10 steps
    of batch 16, checkpoints and validation at steps 5 and 10), resumed
    from the newest checkpoint to step 15; model-10.pth served by
    TwoStagePipeline.from_checkpoints beside the smoke's RadarNet; one step
    card against CPU; overfitting a fixed batch at full width. Prints ms a
    step, the host's wait for data, samples/s and peak memory, and returns
    them with the manifests of the files it wrote."""
    from rcfd_tpu_torch import fusionnet_main as fm
    from rcfd_tpu_torch import train_fusionnet
    from rcfd_tpu_torch.models import radarnet
    from rcfd_tpu_torch.pipeline import TwoStagePipeline

    with fm.training_numerics():
        log('train: ' + fm.numerics_line())
    manifests = write_training_inputs(tmp, np.random.default_rng(SEED + 22))
    ckpt = os.path.join(tmp, 'checkpoints')
    timings = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    train_fusionnet.main(train_argv(manifests, ckpt, 10), timings=timings)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    losses = [t['loss'] for t in timings]
    check([t['step'] for t in timings] == list(range(1, 11)) and
          all(math.isfinite(v) for v in losses),
          'train: steps {} losses {}'.format(
              [t['step'] for t in timings], losses))
    for step in (5, 10):
        check_checkpoint(os.path.join(ckpt, 'model-{}.pth'.format(step)),
                         step)
    rows = validation_lines(os.path.join(ckpt, 'results.txt'))
    check(len(rows) >= 2 and all(len(r) == 5 and all(map(math.isfinite, r))
                                 for r in rows),
          'train: validation rows {}'.format(rows))
    timed = [t for t in timings if t['step'] in TIMED_STEPS]
    step_ms = float(np.median([t['step_ms'] for t in timed]))
    wait_ms = float(np.median([t['wait_ms'] for t in timed]))
    per_step = float(np.median([t['step_ms'] + t['wait_ms'] for t in timed]))
    log('train: 10 steps of batch 16 at 448x448 from {} full-size frames (one '
        'batch an epoch: every step waits for a loader started afresh) in '
        '{:.2f} s of main (validation of {} frames at steps 5 and 10 and at '
        'the end included): ms a step, median of steps 3-10 (synchronized) '
        '{:.2f}; host wait for data a step, median {:.2f} ms; samples/s '
        '{:.2f} (16 over the median step plus wait); peak memory {} bytes; '
        'losses {}; validation (step, MAE, RMSE, iMAE, iRMSE) {}; per step '
        '(ms, wait ms): {}; {}'.format(
            TRAIN_FRAMES, wall, VAL_FRAMES, step_ms, wait_ms,
            16e3 / per_step, peak,
            ', '.join('{:.4f}'.format(v) for v in losses), rows,
            ', '.join('{:.1f}/{:.1f}'.format(t['step_ms'], t['wait_ms'])
                      for t in timings), gpu_name_and_power()))

    traced_fusionnet_resume('train', manifests, ckpt, tmp)
    train_raw_cache(device, manifests, tmp, wait_ms)

    rn_path = os.path.join(tmp, 'radarnet.pth')
    torch.save(dict({radarnet.PTH_KEYS[part]: {
        k: v.cpu() for k, v in getattr(rn, part).state_dict().items()}
        for part in radarnet.PTH_KEYS}, train_step=0), rn_path)
    pipe = TwoStagePipeline.from_checkpoints(
        rn_path, os.path.join(ckpt, 'model-10.pth'), image_height=H,
        image_width=W, device=device)
    req = requests(np.random.default_rng(SEED + 23), 1, H, W, K,
                   N_INVALID)[0]
    dense = pipe(*req)[0]
    # FusionNet's range, min_d / (sigmoid(x) + min_d / max_d): (0.990, 100]
    # m at min_d 1 and max_d 100, below 1 m where the sigmoid nears 1
    lo = 1.0 / (1.0 + 1.0 / 100.0)
    check(bool(torch.isfinite(dense).all()) and float(dense.min()) >= lo and
          float(dense.max()) <= 100.0, 'train: model-10.pth serves dense '
          'depth in [{}, {}]'.format(float(dense.min()), float(dense.max())))
    log('train: model-10.pth served by TwoStagePipeline.from_checkpoints '
        'beside the smoke\'s RadarNet: dense depth finite, in [{:.4f}, '
        '{:.4f}] m (FusionNet\'s range [{:.4f}, 100])'.format(
            float(dense.min()), float(dense.max()), lo))
    del pipe
    torch.cuda.empty_cache()
    train_card_vs_cpu(device)
    train_overfit(device)
    torch.cuda.empty_cache()
    return dict(manifests=manifests, step_ms=step_ms, wait_ms=wait_ms,
                samples_per_s=16e3 / per_step, peak=peak,
                checkpoint=os.path.join(ckpt, 'model-15.pth'))


# phase train_radarnet: bash/train_radarnet_nuscenes.sh's flags on
# RN_TRAIN_FRAMES full-size frames (batch 6: 5 batches an epoch, so that
# the loader runs ahead of the step within an epoch), schedule 2 (10
# steps), a checkpoint and a validation of RN_VAL_FRAMES frames every 5
# steps; then a resumed run to schedule 3 (step 15)
RN_TRAIN_SCRIPT = os.path.join('bash', 'train_radarnet_nuscenes.sh')
RN_TRAIN_FRAMES = 30
RN_STEPS_PER_EPOCH = RN_TRAIN_FRAMES // 6
RN_VAL_FRAMES = 4
RN_STREAMS = ('image', 'radar', 'ground_truth')
RN_KEYS = ['radarnet_decoder_state_dict', 'radarnet_encoder_state_dict',
           'radarnet_optimizer_state_dict', 'train_step']
# (b): the step through K2 against the same step through the plain crop,
# every parameter's gradient as a share of its max-abs (the backward's
# index_add_ adds overlapping windows with atomics, in another order than
# autograd of the plain crop, and the order changes from run to run:
# 6.2e-6 to 7.5e-6 measured in five runs on an H100); and the crop's
# backward alone against autograd of the plain crop (1.2e-7 measured)
RN_CROP_GRAD_TOL = 2e-5
# (d): a narrow RadarNet at a 128x100 patch (the variable-bin pools: K2 on
# the card, its plain version on the CPU), at each of RN_SEEDS. The card's
# float64 step (the plain crop: K2 has no float64 instance) equals the
# CPU's, gradients, loss and statistics, within RN_FLOAT64_TOL. Each
# device's float32 gradients are held to the CPU's float64 step's within
# RN_GRAD_TOL of the largest gradient of the model: each tensor's own
# max-abs is no scale for them, since some (the batch-norm biases before a
# leaky ReLU and another batch norm) are small sums of large terms that
# cancel, and float32 misses them by 1.5e-2 of their max-abs on the card
# (an H100, 700 W; seed 37) and 1.4e-3 on the CPU
RN_GRAD_TOL = 1e-3
RN_FLOAT64_TOL = 1e-10
RN_SEEDS = tuple(SEED + 35 + i for i in range(3))
RN_NARROW = dict(RADARNET, input_patch_size_image=(128, 100),
                 n_filters_encoder_image=[8, 16, 16, 16, 16],
                 n_neurons_encoder_depth=[8, 16, 16, 16, 16],
                 n_filters_decoder=[16, 16, 8, 8, 8])


def radarnet_training_frame(rng):
    """A camera-like frame, 40 to 64 radar points in its lower half with
    depths near the ground truth's, and a dense interpolated ground truth
    below the horizon."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    gt = (5 + 70 * (1 - y / H) + 3 * np.sin(x / 50.0)).astype(np.float32)
    gt[: int(0.4 * H)] = 0.0
    k = int(rng.integers(40, K + 1))
    xs, ys = rng.integers(0, W, k), rng.integers(int(0.45 * H), H, k)
    zs = np.maximum(gt[ys, xs] + rng.normal(0, 0.3, k), 1.0)
    points = np.stack([xs, ys, zs], 1).astype(np.float32)
    return camera_frame(rng), points, gt


def write_radarnet_inputs(tmp, rng):
    """RN_TRAIN_FRAMES training and RN_VAL_FRAMES validation frames at
    900x1600 with the port's writers (RGB PNGs, .npy point sets, x256 depth
    PNGs), written by 8 threads, and their manifests."""
    from concurrent.futures import ThreadPoolExecutor

    from rcfd_tpu_torch import native
    from rcfd_tpu_torch.data import io

    writers = {'image': native.write_rgb, 'radar': np.save,
               'ground_truth': lambda path, z: io.save_depth(z, path)}
    jobs, manifests = [], {}
    for split, n in (('train', RN_TRAIN_FRAMES), ('val', RN_VAL_FRAMES)):
        paths = {k: [] for k in RN_STREAMS}
        for i in range(n):
            for k, value in zip(RN_STREAMS, radarnet_training_frame(rng)):
                paths[k].append(os.path.join(tmp, 'rn_{}_{}_{:02d}.{}'.format(
                    split, k, i, 'npy' if k == 'radar' else 'png')))
                jobs.append((writers[k], paths[k][-1], value))
        for k in RN_STREAMS:
            manifests[split, k] = os.path.join(tmp, 'rn_{}_{}.txt'.format(
                split, k))
            io.write_paths(manifests[split, k], paths[k])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda job: job[0](job[1], job[2]), jobs))
    log('train_radarnet: wrote {} files of {}x{} frames in {:.2f} s'.format(
        len(jobs), H, W, time.perf_counter() - t0))
    return manifests


def radarnet_train_argv(manifests, checkpoint_dirpath, schedule,
                        restore=None):
    """bash/train_radarnet_nuscenes.sh's flags, with this run's manifests,
    schedule, checkpoint directory and restore path, a checkpoint and a
    validation every 5 steps."""
    flags = script_flags(RN_TRAIN_SCRIPT)
    for split in ('train', 'val'):
        for k in RN_STREAMS:
            flags['--{}_{}_path'.format(split, k)] = [manifests[split, k]]
    flags.update({'--learning_schedule': [str(schedule)],
                  '--n_step_per_checkpoint': ['5'],
                  '--start_step_validation': ['5'],
                  '--checkpoint_dirpath': [checkpoint_dirpath]})
    if restore:
        flags['--restore_path'] = [restore]
    return [t for k, v in flags.items() for t in [k] + v]


def check_radarnet_checkpoint(path, step):
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    check(sorted(ckpt) == RN_KEYS and ckpt['train_step'] == step and
          ckpt['radarnet_optimizer_state_dict'] == {},
          'train_radarnet: {} has keys {} at step {}'.format(
              path, sorted(ckpt), ckpt.get('train_step')))


def radarnet_batch(manifests, patch, device, n=6, k=4):
    """A training batch of the first n training frames at ``patch`` (K = 4,
    lidar probability 0.10), on the card in the integer transport."""
    from rcfd_tpu_torch.data import io
    from rcfd_tpu_torch.data.datasets import RadarNetTrainingDataset

    ds = RadarNetTrainingDataset(
        *[io.read_paths(manifests['train', s]) for s in RN_STREAMS],
        patch_size=patch, total_points_sampled=k,
        sample_probability_of_lidar=0.10, device=device)
    samples = [ds.get(i, np.random.default_rng((SEED, i))) for i in range(n)]
    return tuple(torch.from_numpy(np.stack(f)).to(device)
                 for f in zip(*samples))


def canonical_radarnet(patch, device, seed, perf=None):
    """The canonical RadarNet for training at ``patch``, weights from
    ``seed``."""
    from rcfd_tpu_torch import radarnet_main as rm
    from rcfd_tpu_torch.nn import init_parameters

    kw = {k: v for k, v in RADARNET.items()
          if k != 'input_patch_size_image'}
    model = rm.build_model(patch_size=patch, device='cpu', perf=perf,
                           weight_initializer='kaiming_uniform',
                           activation_func='leaky_relu', **kw)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def unused_parameters(model):
    """The parameters the forward never uses: the projections of ResNet
    blocks that keep their input's shape."""
    return {'{}.projection.{}'.format(name, n)
            for name, block in model.named_modules()
            if getattr(block, 'use_projection', True) is False
            for n, _ in block.projection.named_parameters()}


def radarnet_train_augmentation():
    """The script's augmentation: brightness, contrast and saturation
    0.8-1.2 and horizontal flips."""
    from rcfd_tpu_torch.data.transforms import Transforms

    return Transforms(normalized_image_range=[0, 1],
                      random_brightness=[0.8, 1.2],
                      random_contrast=[0.8, 1.2],
                      random_saturation=[0.8, 1.2],
                      random_flip_type=['horizontal'])


def train_radarnet_canonical(device, record, fn, manifests, tmp):
    """(a): the training CLI with the script's flags, 10 steps (2 epochs)
    and validations at 5 and 10, then resumed to 15; K1 counted and held
    against its plain version on one validation frame's crops of the
    trained model; model-15.pth served. Returns the medians of the first
    run's steps."""
    from rcfd_tpu_torch import train_radarnet
    from rcfd_tpu_torch.data import io, transforms
    from rcfd_tpu_torch.data.datasets import RadarNetInferenceDataset
    from rcfd_tpu_torch.models import RadarNetModel
    from rcfd_tpu_torch.ops import scatter_cuda as sc
    from rcfd_tpu_torch.pipeline import TwoStagePipeline, radarnet_crops

    ckpt = os.path.join(tmp, 'rn_checkpoints')
    timings = []
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    train_radarnet.main(radarnet_train_argv(manifests, ckpt, 2),
                        timings=timings)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    launches = read_launches()
    losses = [t['loss'] for t in timings]
    check([t['step'] for t in timings] == list(range(1, 11)) and
          all(math.isfinite(v) for v in losses),
          'train_radarnet: steps {} losses {}'.format(
              [t['step'] for t in timings], losses))
    for step in (5, 10):
        check_radarnet_checkpoint(os.path.join(
            ckpt, 'model-{}.pth'.format(step)), step)
    rows = validation_lines(os.path.join(ckpt, 'results.txt'))
    # an error is the mean over the frames' intersections with the ground
    # truth, NaN (as in the JAX package) where no frame has one
    check([r[0] for r in rows] == [5, 10, 10] and all(
        len(r) == 8 and all(map(math.isfinite, r[5:])) and
        (all(map(math.isfinite, r[1:5])) or r[6] == 0) for r in rows),
          'train_radarnet: validation rows {}'.format(rows))
    # three validations of RN_VAL_FRAMES frames, one K1 launch a frame
    want = 3 * RN_VAL_FRAMES
    check(launches['scatter_quasi_dense'] == want and
          sum(launches.values()) == want,
          'train_radarnet: launches {} (K1 {} expected, nothing else)'.format(
              launches, want))
    count_launches(record, 'train_radarnet', launches,
                   ['scatter_quasi_dense'])
    # steps 3-10 but the first of an epoch (6), which waits for a loader
    # started afresh
    first = [t for t in timings if (t['step'] - 1) % RN_STEPS_PER_EPOCH == 0]
    timed = [t for t in timings
             if t['step'] in TIMED_STEPS and t not in first]
    step_ms = float(np.median([t['step_ms'] for t in timed]))
    wait_ms = float(np.median([t['wait_ms'] for t in timed]))
    per_step = float(np.median([t['step_ms'] + t['wait_ms'] for t in timed]))
    log('train_radarnet: 10 steps of batch 6 (K = 4, 24 patches of 900x288) '
        'in 2 epochs of {} full-size frames in {:.2f} s of main (validation '
        'of {} frames at steps 5 and 10 and at the end included): over steps '
        '{} (3-10 but the first of an epoch), medians: ms a step '
        '(synchronized) {:.2f}; host wait for data a step {:.2f} ms; '
        'samples/s {:.2f} (6 over the median step plus wait); the first step '
        'of each epoch (steps {}) waits {} ms for a loader started afresh; '
        'peak memory {} bytes; K1 launches {}; losses {}; validation (step, '
        'MAE, RMSE, iMAE, iRMSE, n_output, n_isect, n_gt) {}; per step (ms, '
        'wait ms): {}; {}'.format(
            RN_TRAIN_FRAMES, wall, RN_VAL_FRAMES,
            [t['step'] for t in timed], step_ms, wait_ms, 6e3 / per_step,
            [t['step'] for t in first],
            ', '.join('{:.1f}'.format(t['wait_ms']) for t in first), peak,
            launches['scatter_quasi_dense'],
            ', '.join('{:.4f}'.format(v) for v in losses), rows,
            ', '.join('{:.1f}/{:.1f}'.format(t['step_ms'], t['wait_ms'])
                      for t in timings), gpu_name_and_power()))

    resumed = traced_radarnet_resume(device, record, 'train_radarnet',
                                     manifests, ckpt, tmp)
    with open(os.path.join(ckpt, 'results.txt')) as f:
        check('Auto-resume from: {}'.format(os.path.join(
            ckpt, 'model-10.pth')) in f.read(),
              'train_radarnet: the resumed run did not restore model-10.pth')
    log('train_radarnet: resumed from model-10.pth (--restore_path latest), '
        'took steps 11-15 with Adam afresh (the checkpoints hold an empty '
        'optimizer state, as the JAX package\'s), saved model-15.pth; '
        'losses {}'.format(', '.join('{:.4f}'.format(t['loss'])
                                     for t in resumed)))
    numbers = dict(step_ms=step_ms, wait_ms=wait_ms,
                   samples_per_s=6e3 / per_step, peak=peak)

    # K1 against its plain version on the trained model's crops of one
    # validation frame
    model = RadarNetModel(**RADARNET, device=device)
    model.restore_checkpoint(os.path.join(ckpt, 'model-15.pth'),
                             device=device)
    val = RadarNetInferenceDataset(
        *[io.read_paths(manifests['val', s]) for s in RN_STREAMS],
        max_points=None, device=device)
    image, points, valid = (torch.from_numpy(a[None]).to(device)
                            for a in val.get(0)[:3])
    with torch.inference_mode():
        _, crops, xs, zs = radarnet_crops(
            model, transforms.Transforms([0, 1]), image, points, H)
        args = (crops, xs, zs, valid, H, W, PATCH)
        out = sc.scatter_quasi_dense_batched(*args)
        ref = sc.scatter_quasi_dense_batched_plain(*args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    check(all(torch.equal(a, b) for a, b in zip(out, ref)),
          'train_radarnet: K1 differs from its plain version on the trained '
          'model\'s crops: max abs err {}'.format(err))
    log('train_radarnet: K1 == scatter_quasi_dense_batched_plain on the '
        'trained model-15.pth\'s crops of validation frame 0 ({} points), '
        'bit for bit (tolerance 0); {} covered pixels'.format(
            int(valid.sum()), int((out[1] > 0).sum())))

    fn_path = os.path.join(tmp, 'fusionnet.pth')
    fn.save_checkpoint(fn_path, 0)
    pipe = TwoStagePipeline.from_checkpoints(
        os.path.join(ckpt, 'model-15.pth'), fn_path, image_height=H,
        image_width=W, device=device)
    req = requests(np.random.default_rng(SEED + 31), 1, H, W, K,
                   N_INVALID)[0]
    dense, quasi, _ = pipe(*req)
    lo = 1.0 / (1.0 + 1.0 / 100.0)
    check(bool(torch.isfinite(dense).all()) and float(dense.min()) >= lo and
          float(dense.max()) <= 100.0, 'train_radarnet: model-15.pth serves '
          'dense depth in [{}, {}]'.format(float(dense.min()),
                                           float(dense.max())))
    log('train_radarnet: model-15.pth served by '
        'TwoStagePipeline.from_checkpoints beside the smoke\'s FusionNet: '
        'dense depth finite, in [{:.4f}, {:.4f}] m; {} quasi-dense pixels'
        .format(float(dense.min()), float(dense.max()),
                int((quasi > 0).sum())))
    del pipe, model
    return numbers


def traced_radarnet_resume(device, record, name, manifests, ckpt, tmp,
                           dtype=torch.float32):
    """The training CLI resumed from the newest checkpoint of ``ckpt`` to
    step 15 at the 900x300 patch (``RCFD_TRAIN_DTYPE`` as ``dtype``), its
    steps 13 and 14 traced: K2 3 times a step (the instance of ``dtype``,
    with its plain backward), and in the two validations at step 15 (from
    the float32 masters) K1 once and K2 float32 3 times a frame. Prints
    the trace's report and returns the run's timings."""
    from rcfd_tpu_torch import train_radarnet

    resumed = []
    crop = 'column_crop' + dtype_label(dtype)
    reset_launches()
    with trace_window(tmp, name) as traces, environ(
            {'RCFD_TRAIN_DTYPE': 'bfloat16' if dtype == torch.bfloat16
             else 'float32'}):
        train_radarnet.main(radarnet_train_argv(manifests, ckpt, 3, 'latest')
                            + ['--patch_size', str(WIDE_PATCH[0]),
                               str(WIDE_PATCH[1])], timings=resumed)
    launches = read_launches()
    check([t['step'] for t in resumed] == list(range(11, 16)) and
          all(math.isfinite(t['loss']) for t in resumed),
          '{}: the resumed run took steps {}'.format(
              name, [t['step'] for t in resumed]))
    check_radarnet_checkpoint(os.path.join(ckpt, 'model-15.pth'), 15)
    check_float32_checkpoint(os.path.join(ckpt, 'model-15.pth'))
    frames = 2 * RN_VAL_FRAMES
    want = {'scatter_quasi_dense': frames}
    want['column_crop'] = want.get('column_crop', 0) + 3 * frames
    want[crop] = want.get(crop, 0) + 3 * len(resumed)
    check(all(n == want.get(k, 0) for k, n in launches.items()),
          '{}: launches of the resumed run {} (expected {})'.format(
              name, launches, want))
    count_launches(record, name + ' traced', launches, list(want))
    log('{}: resumed to step 15 at {}x{} under RCFD_TRAIN_DTYPE={} with '
        'RCFD_PROFILE_STEPS={} (steps {}-{} traced): launches {}; losses {}; '
        'per step (ms, wait ms): {}'.format(
            name, *WIDE_PATCH, 'bfloat16' if dtype == torch.bfloat16 else
            'float32', TRACE_STEPS, *TRACED,
            {k: v for k, v in launches.items() if v},
            ', '.join('{:.4f}'.format(t['loss']) for t in resumed),
            ', '.join('{:.1f}/{:.1f}'.format(t['step_ms'], t['wait_ms'])
                      for t in resumed)))
    trace_report(traces, name, resumed, crop=True)
    return resumed


def crop_training_times(device, record, model, batch, dtype=torch.float32):
    """K2 at the training step's shapes (6 frames, 4 windows each, at the
    1/8, 1/16 and 1/32 pools of the 900x300 patch), its instance for
    ``dtype`` rows: the kernel, its plain version and torch.gather forward,
    beside the bytes the windows need; the backward's plain PyTorch version
    (one index_add_, in float32 for bf16 gradients, rounded once) and one
    scatter_add_ on a precomputed index, beside the bytes of the windows'
    gradient read and the whole rows' gradient written. The backward is
    held to autograd of the plain crop (float32) or to the float32 sum of
    the same bf16 gradients rounded once (bf16)."""
    from rcfd_tpu_torch.ops import crop_cuda as cc
    from rcfd_tpu_torch.ops.roi_pool import variable_bin_window

    label = 'K2' + dtype_label(dtype)

    n, k = batch[1].shape[0], batch[1].shape[1]
    with torch.inference_mode():
        image = torch.zeros((n, 3, WIDE_PATCH[0], batch[0].shape[2]),
                            device=device)
        latent, skips = model.encoder.encode_image(image)
        maps = [tuple(t.shape) for t in list(skips) + [latent]]
    rng = np.random.default_rng(SEED + 32)
    parts = []
    for i in (2, 3, 4):
        c, w_f = maps[i][1], maps[i][3]
        ph, pw = int(WIDE_PATCH[0] * SCALES[i]), int(WIDE_PATCH[1] *
                                                     SCALES[i])
        _, win = variable_bin_window(WIDE_PATCH[1], SCALES[i], pw)
        rows = torch.from_numpy(rng.standard_normal(
            (n, c, ph, w_f), dtype=np.float32)).to(device, dtype)
        starts = torch.from_numpy(rng.integers(0, w_f + 1, (n, k)).astype(
            np.int32)).to(device)
        grad = torch.from_numpy(rng.standard_normal(
            (n * k, c, ph, win), dtype=np.float32)).to(device, dtype)
        fwd_ms = device_ms(lambda: cc.batch_column_crop(rows, starts, win),
                           20)
        fwd_plain_ms = device_ms(
            lambda: cc.batch_column_crop_plain(rows, starts, win), 5, 1)
        gather = padded_gather(rows, starts, win)
        check(torch.equal(gather(), cc.batch_column_crop(rows, starts, win)),
              'train_radarnet: the torch.gather yardstick differs from K2')
        fwd_library_ms = device_ms(gather, 20)
        back = cc.batch_column_crop_backward_plain(grad, starts, rows.shape,
                                                   win)
        if dtype == torch.float32:
            rows_g = rows.clone().requires_grad_(True)
            ref, = torch.autograd.grad(cc.batch_column_crop_plain(
                rows_g, starts, win), rows_g, grad)
            tol = RN_CROP_GRAD_TOL
        else:
            ref = cc.batch_column_crop_backward_plain(
                grad.float(), starts, rows.shape, win).to(dtype)
            tol = BF16_EPS
        err = float((back.float() - ref.float()).abs().max() /
                    ref.float().abs().max())
        check(err <= tol, 'train_radarnet: {}\'s backward differs from its '
              'reference by {} of its max-abs (tolerance {})'.format(
                  label, err, tol))
        back_ms = device_ms(lambda: cc.batch_column_crop_backward_plain(
            grad, starts, rows.shape, win), 20)
        # yardstick: one scatter_add_ of the windows' gradients, laid out
        # per frame, on a precomputed index of their columns
        cols = starts.long()[:, :, None] + torch.arange(win, device=device)
        g = grad.reshape(n, k, c, ph, win).permute(0, 2, 3, 1, 4).reshape(
            n, c, ph, k * win).contiguous()
        index = cols.reshape(n, 1, 1, k * win).expand(n, c, ph,
                                                      k * win).contiguous()
        acc = torch.zeros((n, c, ph, w_f + win), device=device, dtype=dtype)
        library_ms = device_ms(lambda: acc.zero_().scatter_add_(3, index, g),
                               20)
        fwd_bytes = crop_bytes(rows, starts, win)
        back_bytes = rows.element_size() * (grad.numel() + rows.numel()) + \
            4 * n * k
        parts.append(dict(
            shape='1/{}'.format(int(1 / SCALES[i])), rows=list(rows.shape),
            win=win, ms=fwd_ms, plain_ms=fwd_plain_ms,
            library_ms=fwd_library_ms, bytes=fwd_bytes,
            bound_ms=fwd_bytes / HBM_BYTES_PER_S * 1e3,
            backward_plain_ms=back_ms, backward_library_ms=library_ms,
            backward_bytes=back_bytes,
            backward_bound_ms=back_bytes / HBM_BYTES_PER_S * 1e3,
            backward_err=err))
        log('train_radarnet: {} at the step\'s 1/{} pool: rows {} -> {} '
            'windows of {}; forward kernel {:.4f} ms, plain {:.4f} ms, '
            'torch.gather {:.4f} ms, bound {:.4f} ms ({} bytes: the covered '
            'columns read, the windows written); backward (plain PyTorch, '
            'one index_add_) {:.4f} ms, scatter_add_ on a precomputed index '
            '{:.4f} ms, bound {:.4f} ms ({} bytes: the windows\' gradient '
            'read, the rows\' written); backward vs its reference {:.3g} of '
            'its max-abs'.format(
                label, int(1 / SCALES[i]), tuple(rows.shape), n * k, win,
                fwd_ms,
                fwd_plain_ms, fwd_library_ms, fwd_bytes / HBM_BYTES_PER_S *
                1e3, fwd_bytes, back_ms, library_ms,
                back_bytes / HBM_BYTES_PER_S * 1e3, back_bytes, err))
        del rows, grad, back, ref, acc, index, g, gather
    total = lambda key: float(sum(p[key] for p in parts))
    record['column_crop' + dtype_label(dtype)]['training'] = dict(
        parts=parts, ms=total('ms'), plain_ms=total('plain_ms'),
        library_ms=total('library_ms'), bound_ms=total('bound_ms'),
        bytes=int(total('bytes')),
        backward_plain_ms=total('backward_plain_ms'),
        backward_library_ms=total('backward_library_ms'),
        backward_bound_ms=total('backward_bound_ms'),
        backward_bytes=int(total('backward_bytes')))


def train_radarnet_wide(device, record, manifests, dtype=torch.float32):
    """(b): one step at the 900x300 patch through K2 and the same step
    (same weights, batch and draws) through the plain crop, cuDNN's
    convolutions deterministic for both; in bf16 training (``dtype``
    bf16, RCFD_TRAIN_DTYPE=bfloat16) through K2's bf16 instance. K2
    launched 3 times in the forward, the losses, every gradient, and a
    nonzero gradient in every parameter of the image encoder that the
    forward uses. float32 gradients are held to the plain step's within
    RN_CROP_GRAD_TOL of each one's max-abs; bf16 ones within
    BF16_CROP_STEP_TOL of the plain step's largest gradient (the two
    backwards of the crop round the windows' sums to bf16 apart, and bf16
    carries that through the rest of the backward)."""
    from unittest import mock

    from rcfd_tpu_torch import radarnet_main as rm
    from rcfd_tpu_torch.ops import crop_cuda as cc
    from rcfd_tpu_torch.ops import roi_pool

    bf16 = dtype == torch.bfloat16
    path = 'train_bf16 wide' if bf16 else 'train_radarnet wide'
    kernel = 'column_crop' + dtype_label(dtype)
    batch = radarnet_batch(manifests, WIDE_PATCH, device)
    transforms = radarnet_train_augmentation()
    gen = torch.Generator(device=device).manual_seed(SEED + 33)
    draws = transforms.draws(gen, 6, 1.0, (6, 4, 3))
    model_k = canonical_radarnet(WIDE_PATCH, device, SEED + 33)
    model_p = copy.deepcopy(model_k)
    out = {}
    cudnn = torch.backends.cudnn
    with rm.training_numerics(), environ(
            {'RCFD_TRAIN_DTYPE': 'bfloat16' if bf16 else 'float32'}):
        cudnn.benchmark, cudnn.deterministic = False, True
        for name, model in (('kernel', model_k), ('plain', model_p)):
            step = rm.TrainStep(model, transforms,
                                rm.make_optimizer(model, 2e-4, 0.0),
                                WIDE_PATCH, 0.4, True, 2.0)
            reset_launches()
            if name == 'plain':
                with mock.patch.object(roi_pool, 'batch_column_crop',
                                       cc.batch_column_crop_plain):
                    info = step.backward(batch, draws)
            else:
                info = step.backward(batch, draws)
            torch.cuda.synchronize()
            out[name] = (float(info['loss']), read_launches(),
                         {n: p.grad for n, p in model.named_parameters()})
    (loss_k, launches, grads_k), (loss_p, plain_launches, grads_p) = \
        out['kernel'], out['plain']
    check(launches[kernel] == 3 and sum(launches.values()) == 3 and
          sum(plain_launches.values()) == 0,
          '{}: launches {} ({} 3 expected), plain step {}'.format(
              path, launches, kernel, plain_launches))
    count_launches(record, path, launches, [kernel])
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(sorted(n for n, g in grads_k.items() if g is not None) ==
          sorted(n for n, g in grads_p.items() if g is not None) and
          all(g.dtype == torch.float32 for g in grads_k.values()
              if g is not None), '{}: the two steps gave gradients to '
          'different parameters, or not in float32'.format(path))
    if bf16:
        largest = max(float(g.abs().max()) for g in grads_p.values()
                      if g is not None)
        grad_err = max(float((grads_k[n] - g).abs().max())
                       for n, g in grads_p.items()
                       if g is not None) / largest
        tol, of = BF16_CROP_STEP_TOL, 'the plain step\'s largest gradient'
    else:
        grad_err = max(float((grads_k[n] - g).abs().max() / g.abs().max())
                       for n, g in grads_p.items()
                       if g is not None and g.abs().max() > 0)
        tol, of = RN_CROP_GRAD_TOL, 'their max-abs'
    unused = unused_parameters(model_k.encoder.encoder_image)
    dead = [n for n, p in model_k.encoder.encoder_image.named_parameters()
            if n not in unused and (p.grad is None or
                                    float(p.grad.abs().max()) == 0.0)]
    check(loss_err <= 1e-6 and grad_err <= tol and not dead,
          '{}: loss rel err {}, gradient err {} of {}, image-encoder '
          'parameters without a gradient {}'.format(
              path, loss_err, grad_err, of, dead))
    log('{}: one step at 900x300 (batch 6, K = 4) through {} against the '
        'plain crop, same weights, batch and draws, deterministic '
        'convolutions: {} launches {} (forward; the backward is plain '
        'PyTorch); loss {:.6f} vs {:.6f} (rel err {:.3g}, tolerance 1e-6); '
        'gradients max err {:.3g} of {} over {} tensors (tolerance {:g}); '
        'every one of the image encoder\'s {} used parameters has a nonzero '
        'gradient ({} unused projections)'.format(
            path, kernel, kernel, launches[kernel], loss_k, loss_p, loss_err,
            grad_err, of, len(grads_p), tol,
            sum(1 for n, _ in model_k.encoder.encoder_image.named_parameters()
                if n not in unused), len(unused)))
    crop_training_times(device, record, model_k, batch, dtype)
    del model_k, model_p, out


def train_radarnet_fused(device, record, manifests):
    """(c): RadarNet under RCFD_FUSED_POOL2=1 RCFD_FUSED_POOL4=1 (the CLI's
    perf_from_env): one train step (K3 off in training, as in the JAX
    package) and one validation of RN_VAL_FRAMES frames (K3 twice a frame,
    K1 once)."""
    from rcfd_tpu_torch import radarnet_main as rm
    from rcfd_tpu_torch.data import io
    from rcfd_tpu_torch.data.datasets import RadarNetInferenceDataset
    from rcfd_tpu_torch.data.transforms import Transforms
    from rcfd_tpu_torch.nn.perf import perf_from_env

    perf = perf_from_env({'RCFD_FUSED_POOL2': '1', 'RCFD_FUSED_POOL4': '1'})
    model = canonical_radarnet(PATCH, device, SEED + 34, perf=perf)
    transforms = radarnet_train_augmentation()
    gen = torch.Generator(device=device).manual_seed(SEED + 34)
    draws = transforms.draws(gen, 6, 1.0, (6, 4, 3))
    step = rm.TrainStep(model, transforms, rm.make_optimizer(model, 2e-4,
                                                             0.0),
                        PATCH, 0.4, True, 2.0)
    batch = radarnet_batch(manifests, PATCH, device)
    with rm.training_numerics():
        reset_launches()
        info = step(batch, draws, 2e-4)
        torch.cuda.synchronize()
        step_launches = read_launches()
        val = RadarNetInferenceDataset(
            *[io.read_paths(manifests['val', s]) for s in RN_STREAMS],
            max_points=None, device=device)
        forward_fn = rm.make_forward_fn_batched(model, Transforms([0, 1]), H,
                                                W)
        reset_launches()
        best = rm.validate(
            forward_fn, val, 1, dict({k: np.inf for k in rm.METRICS},
                                     step=-1, n_valid_points_output=0,
                                     n_valid_points_ground_truth=0,
                                     n_valid_points_intersection=0),
            0.0, 100.0, device=device)
        torch.cuda.synchronize()
        launches = read_launches()
    check(sum(step_launches.values()) == 0 and math.isfinite(
        float(info['loss'])), 'train_radarnet fused: the step launched {}'
          .format(step_launches))
    check(launches['fused_skip_gather_add'] == 2 * RN_VAL_FRAMES and
          launches['scatter_quasi_dense'] == RN_VAL_FRAMES and
          sum(launches.values()) == 3 * RN_VAL_FRAMES and
          all(math.isfinite(best[k]) for k in rm.METRICS),
          'train_radarnet fused: validation launched {}, results {}'.format(
              launches, best))
    count_launches(record, 'train_radarnet fused', launches,
                   ['fused_skip_gather_add', 'scatter_quasi_dense'])
    log('train_radarnet fused: RCFD_FUSED_POOL2=1 RCFD_FUSED_POOL4=1: one '
        'step (loss {:.4f}) launched no kernel (K3 serves only, as in the '
        'JAX package); one validation of {} frames launched K3 {} times and '
        'K1 {}; MAE {:.3f}'.format(
            float(info['loss']), RN_VAL_FRAMES,
            launches['fused_skip_gather_add'],
            launches['scatter_quasi_dense'], best['mae_intersection']))
    del model, step


def train_radarnet_card_vs_cpu(device, seed):
    """(d): one train step of a narrow RadarNet (RN_NARROW, 128x100: K2 on
    the card, its plain version on the CPU) on the card and on the CPU
    from the same weights and batch (from ``seed``), augmentation off, and
    the same step in float64 on both (the plain crop on the card): loss and
    running statistics card vs CPU within CARD_LOSS_RTOL and
    CARD_STATS_RTOL; each float32 step's gradients within RN_GRAD_TOL of
    the largest of the CPU's float64 step's; the card's float64 step equal
    to the CPU's within RN_FLOAT64_TOL. Returns the readings."""
    from unittest import mock

    from rcfd_tpu_torch import radarnet_main as rm
    from rcfd_tpu_torch.data import transport
    from rcfd_tpu_torch.ops import crop_cuda as cc
    from rcfd_tpu_torch.ops import roi_pool

    cpu, batch, make_step = narrow_case('radarnet', seed)
    batch = tuple(torch.from_numpy(a) for a in batch)
    decoded = tuple(t.double() for t in transport.decode(batch))
    runs = (('cpu', copy.deepcopy(cpu), batch),
            ('card', copy.deepcopy(cpu).to(device),
             tuple(t.to(device) for t in batch)),
            ('cpu float64', copy.deepcopy(cpu).double(), decoded),
            ('card float64', copy.deepcopy(cpu).double().to(device),
             tuple(t.to(device) for t in decoded)))
    out = {}
    for name, model, inputs in runs:
        step = make_step(model)
        reset_launches()
        with rm.training_numerics(), mock.patch.object(
                roi_pool, 'batch_column_crop', cc.batch_column_crop_plain
                if name == 'card float64' else cc.batch_column_crop):
            info = step.backward(inputs, {})
        out[name] = (float(info['loss']),
                     {n: p.grad.cpu().double()
                      for n, p in model.named_parameters()
                      if p.grad is not None},
                     {n: t.cpu().double() for n, t in model.named_buffers()},
                     read_launches()['column_crop'])
    (loss_c, grads_c, bufs_c, _), (loss_g, grads_g, bufs_g, crops) = \
        out['cpu'], out['card']
    loss_x, grads_x, bufs_x, _ = out['cpu float64']
    loss_gx, grads_gx, bufs_gx, crops_x = out['card float64']

    def stats_err(bufs, ref):
        return max(float((bufs[n] - t).abs().max() /
                         max(float(t.abs().max()), 1.0))
                   for n, t in ref.items())

    def grad_err(grads, ref):
        """The largest distance of a tensor's gradient from ref's, over
        ref's max-abs, and that tensor."""
        return max((float((grads[n] - g).abs().max() / g.abs().max()), n)
                   for n, g in ref.items() if g.abs().max() > 0)

    scale = max(float(g.abs().max()) for g in grads_x.values())

    def model_err(grads, ref):
        """The largest distance of a gradient from ref's, over the largest
        of ref's."""
        return max(float((grads[n] - g).abs().max())
                   for n, g in ref.items()) / scale

    check(sorted(grads_g) == sorted(grads_c) == sorted(grads_x) ==
          sorted(grads_gx) and crops == 3 and crops_x == 0,
          'train_radarnet: card vs CPU: gradients of different parameters, '
          'or K2 launched {} times (3 expected), {} in float64 (0)'.format(
              crops, crops_x))
    r = dict(seed=seed, loss_err=abs(loss_g - loss_c) / abs(loss_c),
             stats_err=stats_err(bufs_g, bufs_c),
             card_err=model_err(grads_g, grads_x),
             cpu_err=model_err(grads_c, grads_x),
             card_tensor_err=grad_err(grads_g, grads_x),
             cpu_tensor_err=grad_err(grads_c, grads_x),
             apart=grad_err(grads_g, grads_c),
             float64_err=max(grad_err(grads_gx, grads_x)[0],
                             abs(loss_gx - loss_x) / abs(loss_x),
                             stats_err(bufs_gx, bufs_x)))
    check(r['loss_err'] <= CARD_LOSS_RTOL and
          r['stats_err'] <= CARD_STATS_RTOL and
          r['card_err'] <= RN_GRAD_TOL and r['cpu_err'] <= RN_GRAD_TOL and
          r['float64_err'] <= RN_FLOAT64_TOL,
          'train_radarnet: card vs CPU: {}'.format(r))
    log('train_radarnet: one step of a narrow RadarNet at 128x100 (K2 3 '
        'launches on the card), seed {}, card vs CPU from the same weights '
        'and batch: loss rel err {:.3g} (tolerance {:g}), running statistics '
        'rel err {:.3g} (tolerance {:g}); gradients over {} tensors from the '
        'CPU\'s float64 step\'s, of the largest of its gradients: card '
        '{:.3g}, CPU {:.3g} (tolerance {:g}); of each tensor\'s own max-abs '
        '(not held): card at most {:.3g} ({}), CPU {:.3g} ({}), card vs CPU '
        '{:.3g} ({}); the card\'s float64 step (the plain crop) vs the '
        'CPU\'s: gradients, loss and statistics at most {:.3g} (tolerance '
        '{:g})'.format(
            seed, r['loss_err'], CARD_LOSS_RTOL, r['stats_err'],
            CARD_STATS_RTOL, len(grads_x), r['card_err'], r['cpu_err'],
            RN_GRAD_TOL, r['card_tensor_err'][0], r['card_tensor_err'][1],
            r['cpu_tensor_err'][0], r['cpu_tensor_err'][1], r['apart'][0],
            r['apart'][1], r['float64_err'], RN_FLOAT64_TOL))
    return r


def phase_train_radarnet(device, record, fn, tmp):
    """RadarNet training on the card: (a) python -m
    rcfd_tpu_torch.train_radarnet's main, in process, with
    bash/train_radarnet_nuscenes.sh's flags on full-size files (10 steps of
    batch 6 in 2 epochs, checkpoints and validation with K1 at steps 5 and
    10),
    resumed from the newest checkpoint to step 15, K1 held against its
    plain version on the trained model's crops, model-15.pth served; (b)
    one step at 900x300 through K2 against the plain crop, and K2's
    training times; (c) one step and one validation under the fused-pool
    gates; (d) one step card against CPU at each of RN_SEEDS. Returns (a)'s
    numbers with the manifests of the files it wrote."""
    from rcfd_tpu_torch import radarnet_main as rm

    with rm.training_numerics():
        log('train_radarnet: ' + rm.numerics_line())
    manifests = write_radarnet_inputs(tmp, np.random.default_rng(SEED + 30))
    numbers = train_radarnet_canonical(device, record, fn, manifests, tmp)
    torch.cuda.empty_cache()
    train_radarnet_wide(device, record, manifests)
    torch.cuda.empty_cache()
    train_radarnet_fused(device, record, manifests)
    torch.cuda.empty_cache()
    readings = [train_radarnet_card_vs_cpu(device, seed) for seed in RN_SEEDS]
    span = lambda values: '{:.3g}-{:.3g}'.format(min(values), max(values))
    log('train_radarnet: card vs CPU over seeds {}: float32 gradients from '
        'float64, of the model\'s largest: card {}, CPU {} (tolerance {:g}); '
        'of each tensor\'s own max-abs: card {}, CPU {}; card float64 vs '
        'CPU float64 at most {:.3g} (tolerance {:g})'.format(
            list(RN_SEEDS), span([r['card_err'] for r in readings]),
            span([r['cpu_err'] for r in readings]), RN_GRAD_TOL,
            span([r['card_tensor_err'][0] for r in readings]),
            span([r['cpu_tensor_err'][0] for r in readings]),
            max(r['float64_err'] for r in readings), RN_FLOAT64_TOL))
    torch.cuda.empty_cache()
    return dict(numbers, manifests=manifests)


# -- bf16 training -------------------------------------------------------------

# phase train_bf16: both training CLIs under RCFD_TRAIN_DTYPE=bfloat16 on the
# files of phases train and train_radarnet, with their flags and schedules
# (10 steps, a checkpoint and a validation every 5 steps); a 900x300
# RadarNet step through K2's bf16 instance against the plain crop; a narrow
# step of each model card vs CPU at BF16_SEEDS
BF16_EPS = 2.0 ** -8  # one bf16 rounding, relative
# the 900x300 bf16 step through K2 against the plain crop: every gradient
# within this share of the plain step's largest gradient
BF16_CROP_STEP_TOL = 5e-2
# narrow bf16 steps, card and CPU: the loss card vs CPU within
# BF16_LOSS_RTOL; the running statistics card vs CPU within BF16_STATS_TOL
# of their largest (at least 1); each device's bf16 gradients within
# BF16_TRUTH_TOL of the largest gradient of the CPU's float64 step. An
# untrained FusionNet's L1 gradients all have one sign, so its batch norms'
# backward cancels almost everything and bf16 keeps little of the rest: the
# CPU's bf16 step is 0.006-0.40 of the largest gradient from float64 on
# these batches (tests/test_torch_train_bf16.py holds the CPU's to the JAX
# package's bf16 step, which is farther from float64)
BF16_LOSS_RTOL, BF16_STATS_TOL, BF16_TRUTH_TOL = 2.0 ** -7, 2e-2, 0.5
BF16_SEEDS = tuple(SEED + 40 + i for i in range(3))
# a narrow FusionNet at 192x256 (its 1/64 batch norms normalize 24 values:
# bf16 over a handful of values is all cancellation)
FN_NARROW = dict(FUSIONNET, n_filters_encoder_image=[8, 16, 16, 16, 16, 16],
                 n_filters_encoder_depth=[8, 8, 16, 16, 16, 16],
                 n_filters_decoder=[16, 16, 16, 8, 8, 8])


def check_float32_checkpoint(path):
    """Every tensor of a .pth, the optimizer state's included, is float32
    (or an integer count)."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)

    def tensors(tree):
        if torch.is_tensor(tree):
            yield tree
        elif isinstance(tree, dict):
            for v in tree.values():
                yield from tensors(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from tensors(v)
    dtypes = {t.dtype for t in tensors(ckpt)}
    check(dtypes <= {torch.float32, torch.int64},
          'train_bf16: {} holds tensors of {}'.format(path, dtypes))


def train_bf16_cli(device, record, name, run, argv, batch, first_of_epoch,
                   float32):
    """A training CLI's main in process under RCFD_TRAIN_DTYPE=bfloat16, 10
    steps: finite losses, float32 checkpoints at 5 and 10, validation rows
    (in float32, from the master weights: RadarNet's through K1's float32
    instance). Prints ms a step, the host wait, samples/s and peak memory
    beside ``float32``, the float32 phase's, and returns them."""
    timings = []
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with environ({'RCFD_TRAIN_DTYPE': 'bfloat16'}):
        run(argv, timings=timings)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    launches = read_launches()
    losses = [t['loss'] for t in timings]
    check([t['step'] for t in timings] == list(range(1, 11)) and
          all(math.isfinite(v) for v in losses),
          'train_bf16 {}: steps {} losses {}'.format(
              name, [t['step'] for t in timings], losses))
    ckpt = argv[argv.index('--checkpoint_dirpath') + 1]
    for step in (5, 10):
        path = os.path.join(ckpt, 'model-{}.pth'.format(step))
        (check_radarnet_checkpoint if name == 'radarnet' else
         check_checkpoint)(path, step)
        check_float32_checkpoint(path)
    rows = validation_lines(os.path.join(ckpt, 'results.txt'))
    check([r[0] for r in rows] == [5, 10, 10] and all(
        all(map(math.isfinite, r[5:])) and
        (all(map(math.isfinite, r[1:5])) or r[6] == 0) for r in rows),
          'train_bf16 {}: validation rows {}'.format(name, rows))
    want = {'scatter_quasi_dense': 3 * RN_VAL_FRAMES} \
        if name == 'radarnet' else {}
    check(all(n == want.get(k, 0) for k, n in launches.items()),
          'train_bf16 {}: launches {} (expected {})'.format(
              name, launches, want))
    count_launches(record, 'train_bf16 ' + name, launches, list(want))
    timed = [t for t in timings if t['step'] in TIMED_STEPS and
             not (first_of_epoch and (t['step'] - 1) % RN_STEPS_PER_EPOCH
                  == 0)]
    out = dict(step_ms=float(np.median([t['step_ms'] for t in timed])),
               wait_ms=float(np.median([t['wait_ms'] for t in timed])),
               peak=peak)
    out['samples_per_s'] = batch * 1e3 / float(np.median(
        [t['step_ms'] + t['wait_ms'] for t in timed]))
    log('train_bf16 {}: 10 steps of batch {} under RCFD_TRAIN_DTYPE=bfloat16 '
        'in {:.2f} s of main (validation at steps 5 and 10 and at the end '
        'included); over steps {}, medians: ms a step (synchronized) {:.2f} '
        '(float32 {:.2f}), host wait {:.2f} ms (float32 {:.2f}), samples/s '
        '{:.2f} (float32 {:.2f}); peak memory {} bytes (float32 {}); '
        'launches {}; losses {}; validation {}; {}'.format(
            name, batch, wall, [t['step'] for t in timed], out['step_ms'],
            float32['step_ms'], out['wait_ms'], float32['wait_ms'],
            out['samples_per_s'], float32['samples_per_s'], peak,
            float32['peak'], {k: v for k, v in launches.items() if v},
            ', '.join('{:.4f}'.format(v) for v in losses), rows,
            gpu_name_and_power()))
    return out


def narrow_case(name, seed):
    """A narrow model (RN_NARROW at 128x100, FN_NARROW) with weights from
    ``seed``, a training batch of 2 frames in the integer transport, and a
    function of (model, device) that builds its train step."""
    from rcfd_tpu_torch import fusionnet_main as fm
    from rcfd_tpu_torch import radarnet_main as rm
    from rcfd_tpu_torch.data.transforms import Transforms
    from rcfd_tpu_torch.models import FusionNetModel
    from rcfd_tpu_torch.nn import init_parameters

    rng = np.random.default_rng(seed)
    if name == 'radarnet':
        ph, pw = RN_NARROW['input_patch_size_image']
        kw = {k: v for k, v in RN_NARROW.items()
              if k != 'input_patch_size_image'}
        model = rm.build_model(patch_size=(ph, pw), device='cpu',
                               weight_initializer='kaiming_uniform',
                               activation_func='leaky_relu', **kw)
        b, k, w = 2, 4, 256
        x = rng.integers(0, w, (b, k)).astype(np.float32)
        points = np.stack([x + pw // 2, rng.random((b, k)) * ph,
                           rng.random((b, k)) * 60 + 5], -1).astype(
                               np.float32)
        boxes = np.stack([x, np.zeros_like(x), x + 2 * (pw // 2),
                          np.full_like(x, ph)], -1).astype(np.float32)
        gt = points[..., 2, None, None, None] + rng.uniform(
            -0.8, 0.8, (b, k, ph, pw, 1))
        gt[rng.random(gt.shape) < 0.4] = 0.0
        batch = (rng.integers(0, 256, (b, ph, w + pw, 3), dtype=np.uint8),
                 points, boxes, (gt * 256).astype(np.uint16))

        def step(m):
            return rm.TrainStep(m, Transforms([0, 1]),
                                rm.make_optimizer(m, 1e-3, 0.0), (ph, pw),
                                0.4, False, 2.0)
    else:
        model = FusionNetModel(**FN_NARROW, device='cpu', trainable=True)
        shape = (2, 192, 256)
        batch = (rng.integers(0, 256, shape + (3,), dtype=np.uint8),
                 *[(rng.random(shape + (1,)) * 60 * 256).astype(np.uint16)
                   for _ in range(4)])

        def step(m):
            return fm.TrainStep(m, Transforms([0, 1]),
                                fm.make_optimizer(m, 1e-3, 0.0), 'l1', 0.0,
                                2.0, -1, 7, 1.5, -1)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model, batch, step


def train_bf16_card_vs_cpu(device, name, seed):
    """One bf16 train step of a narrow model on the card and on the CPU from
    the same weights and batch, augmentation off, and the same step in
    float64 on the CPU: loss and running statistics card vs CPU; each
    device's bf16 gradients against the float64 step's. Returns the
    readings."""
    from rcfd_tpu_torch.data import transport
    from rcfd_tpu_torch.training import training_numerics

    cpu, batch, make_step = narrow_case(name, seed)
    batch = tuple(torch.from_numpy(a) for a in batch)
    runs = (('cpu', 'bfloat16', copy.deepcopy(cpu), batch),
            ('card', 'bfloat16', copy.deepcopy(cpu).to(device),
             tuple(t.to(device) for t in batch)),
            ('cpu float64', 'float32', copy.deepcopy(cpu).double(),
             tuple(t.double() for t in transport.decode(batch))))
    out = {}
    for label, dtype, model, inputs in runs:
        with environ({'RCFD_TRAIN_DTYPE': dtype}):
            step = make_step(model)
        reset_launches()
        with training_numerics():
            info = step.backward(inputs, {})
        out[label] = (float(info['loss']),
                      {n: p.grad.cpu().double()
                       for n, p in model.named_parameters()
                       if p.grad is not None},
                      {n: t.cpu().double() for n, t in model.named_buffers()},
                      read_launches())
    (loss_c, grads_c, bufs_c, _), (loss_g, grads_g, bufs_g, launches) = \
        out['cpu'], out['card']
    _, truth, _, _ = out['cpu float64']
    scale = max(float(g.abs().max()) for g in truth.values())

    def err(grads):
        return max(float((grads[n] - g).abs().max())
                   for n, g in truth.items()) / scale
    want = {'column_crop bf16': 3} if name == 'radarnet' else {}
    check(sorted(grads_g) == sorted(grads_c) == sorted(truth) and
          all(launches[k] == want.get(k, 0) for k in launches),
          'train_bf16 {}: card vs CPU: gradients of different parameters, '
          'or launches {} (expected {})'.format(name, launches, want))
    r = dict(seed=seed, loss_err=abs(loss_g - loss_c) / abs(loss_c),
             stats_err=max(float((bufs_g[n] - t).abs().max() /
                                 max(float(t.abs().max()), 1.0))
                           for n, t in bufs_c.items()),
             card_err=err(grads_g), cpu_err=err(grads_c),
             apart=max(float((grads_g[n] - g).abs().max())
                       for n, g in grads_c.items()) / scale)
    check(r['loss_err'] <= BF16_LOSS_RTOL and
          r['stats_err'] <= BF16_STATS_TOL and
          r['card_err'] <= BF16_TRUTH_TOL and
          r['cpu_err'] <= BF16_TRUTH_TOL,
          'train_bf16 {}: card vs CPU: {}'.format(name, r))
    return r


def phase_train_bf16(device, record, trained):
    """bf16 training on the card: both training CLIs under
    RCFD_TRAIN_DTYPE=bfloat16 on the files of phases train and
    train_radarnet (``trained`` holds their manifests and float32
    numbers); a 900x300 RadarNet step through K2's bf16 instance against
    the plain crop, with K2 bf16's forward and backward timed at the step's
    shapes; a narrow bf16 step of each model card vs CPU at BF16_SEEDS."""
    from rcfd_tpu_torch import train_fusionnet, train_radarnet
    from rcfd_tpu_torch.training import numerics_line, training_numerics

    with training_numerics():
        log('train_bf16: ' + numerics_line(torch.bfloat16))
    tmp = trained['tmp']
    fn_ckpt = os.path.join(tmp, 'bf16_checkpoints')
    train_bf16_cli(device, record, 'fusionnet', train_fusionnet.main,
                   train_argv(trained['fusionnet']['manifests'], fn_ckpt, 10),
                   16, False, trained['fusionnet'])
    traced_fusionnet_resume('train_bf16 fusionnet',
                            trained['fusionnet']['manifests'], fn_ckpt, tmp,
                            torch.bfloat16)
    torch.cuda.empty_cache()
    rn_ckpt = os.path.join(tmp, 'bf16_rn')
    train_bf16_cli(device, record, 'radarnet', train_radarnet.main,
                   radarnet_train_argv(trained['radarnet']['manifests'],
                                       rn_ckpt, 2), 6,
                   True, trained['radarnet'])
    traced_radarnet_resume(device, record, 'train_bf16 radarnet',
                           trained['radarnet']['manifests'], rn_ckpt, tmp,
                           torch.bfloat16)
    torch.cuda.empty_cache()
    train_radarnet_wide(device, record, trained['radarnet']['manifests'],
                        torch.bfloat16)
    torch.cuda.empty_cache()
    for name in ('radarnet', 'fusionnet'):
        readings = [train_bf16_card_vs_cpu(device, name, seed)
                    for seed in BF16_SEEDS]
        span = lambda key: '{:.3g}-{:.3g}'.format(  # noqa: E731
            min(r[key] for r in readings), max(r[key] for r in readings))
        log('train_bf16 {}: one bf16 step of a narrow model card vs CPU at '
            'seeds {}: loss rel err {} (tolerance {:g}), running statistics '
            '{} of their largest (tolerance {:g}); gradients from the CPU\'s '
            'float64 step, of its largest gradient: card {}, CPU {} '
            '(tolerance {:g}); card vs CPU {}'.format(
                name, list(BF16_SEEDS), span('loss_err'), BF16_LOSS_RTOL,
                span('stats_err'), BF16_STATS_TOL, span('card_err'),
                span('cpu_err'), BF16_TRUTH_TOL, span('apart')))
    torch.cuda.empty_cache()


# -- the standalone run drivers -----------------------------------------------

# phase run: run_radarnet.main and run_fusionnet.main in process with
# bash/run_{radarnet,fusionnet}_nuscenes.sh's flags on CLI_FRAMES full-size
# frames (--eval_batch_size 8: one forward), FusionNet on RadarNet's
# outputs of run a, as the two stages run from files
RUN_SCRIPTS = {'radarnet': os.path.join('bash', 'run_radarnet_nuscenes.sh'),
               'fusionnet': os.path.join('bash', 'run_fusionnet_nuscenes.sh')}
BF16_ENV = {'RCFD_COMPUTE_DTYPE': 'bfloat16'}
FUSED_ENV = {'RCFD_FUSED_POOL2': '1', 'RCFD_FUSED_POOL4': '1'}
# (case, ground truth, extra flags, environment, RadarNet's launches)
RUN_CASES = (
    ('a', True, [], {}, {'scatter_quasi_dense': 1}),
    ('b', False, [], {}, {'scatter_quasi_dense': 1}),
    ('c', True, [], BF16_ENV, {'scatter_quasi_dense bf16': 1}),
    ('d', True, ['--patch_size', str(WIDE_PATCH[0]), str(WIDE_PATCH[1])], {},
     {'scatter_quasi_dense': 1, 'column_crop': 3}),
    ('e', True, [], FUSED_ENV,
     {'scatter_quasi_dense': 1, 'fused_skip_gather_add': 2}),
)
RUN_STREAMS = {'radarnet': ('output_depth_radar', 'output_response_radar'),
               'fusionnet': ('output_depth_fusion',)}


def run_argv(model, inputs, out_dir, with_gt, flags):
    """The run script's flags with this run's inputs, output directory and
    ground truth (none when ``with_gt`` is false); --save_outputs on,
    --verbose off."""
    values = script_flags(RUN_SCRIPTS[model])
    values.pop('--verbose', None)
    values.update(inputs)
    if not with_gt:
        values.pop('--ground_truth_path')
    values.update({'--output_dirpath': [out_dir], '--save_outputs': []})
    argv = [t for k, v in values.items() for t in [k] + v]
    return argv + flags


def run_files(out_dir, model, names):
    """The 16-bit codes of a run's output streams."""
    from rcfd_tpu_torch.data import io

    return {s: [io.load_depth_u16(os.path.join(out_dir, s, n)).astype(
        np.int64) for n in names] for s in RUN_STREAMS[model]}


def phase_run(device, record, rn, fn, tmp):
    """run_radarnet.main and run_fusionnet.main in process on CLI_FRAMES
    full-size frames the port's writers made, with the smoke's weights as
    .pth files, in the cases of RUN_CASES, each run once, every launch
    count set to 0 just before the run and read just after: (a) with
    ground truth and metrics, (b) --save_outputs without ground truth (the
    codes made on the card), whose files must equal (a)'s byte for byte, (c) RCFD_COMPUTE_DTYPE=bfloat16, and for
    RadarNet (d) the 900x300 patch (K2) and (e) the fused gates (K3).
    RadarNet's (a) quasi depth and response must equal stage 1 of
    TwoStagePipeline (folded, K1) on the same frames. Prints frames/s and
    the read / serve / write split."""
    from rcfd_tpu_torch import run_fusionnet, run_radarnet
    from rcfd_tpu_torch.data import io
    from rcfd_tpu_torch.data.datasets import RadarNetInferenceDataset
    from rcfd_tpu_torch.nn.perf import PerfConfig
    from rcfd_tpu_torch.pipeline import TwoStagePipeline, codec_encode

    paths, manifests, checkpoints = write_cli_inputs(
        rn, fn, tmp, np.random.default_rng(SEED + 50))
    names = [os.path.splitext(os.path.basename(p))[0] + '.png'
             for p in paths['image']]
    power = gpu_name_and_power()
    inputs = {'radarnet': {'--restore_path': [checkpoints[0]],
                           '--image_path': [manifests['image']],
                           '--radar_path': [manifests['radar']],
                           '--ground_truth_path': [manifests['ground_truth']]}}
    files, metrics = {}, {}
    for model, cli in (('radarnet', run_radarnet), ('fusionnet',
                                                     run_fusionnet)):
        for case, with_gt, flags, env, want in RUN_CASES:
            if model == 'fusionnet':
                if case in ('d', 'e'):
                    continue
                want = {}
            name = 'run {} {}'.format(model, case)
            out_dir = os.path.join(tmp, name.replace(' ', '_'))
            argv = run_argv(model, inputs[model], out_dir, with_gt, flags)
            with environ(env):
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                summary = cli.main(argv, device=device)
                wall = time.perf_counter() - t0
                launches = read_launches()
            check(all(n == want.get(k, 0) for k, n in launches.items()),
                  '{}: launches {} (expected {})'.format(name, launches,
                                                         want))
            count_launches(record, name, launches, list(want))
            check((summary['metrics'] is not None) == with_gt and (
                not with_gt or all(math.isfinite(v) for v in
                                   summary['metrics'].values())),
                  '{}: metrics {}'.format(name, summary['metrics']))
            files[name] = run_files(out_dir, model, names)
            metrics[name] = summary['metrics']
            sec = summary['seconds']
            log('{}: flags {} env {}: {} frames in {:.3f} s of main, {:.3f} '
                'frames/s end to end; per frame: host read {:.2f} ms, serve '
                '(to the outputs on the host) {:.2f} ms, host write and '
                'metrics {:.2f} ms; setup {:.3f} s; launches {}; metrics {}; '
                '{}'.format(name, ' '.join(flags) or '-', env or '{}',
                            CLI_FRAMES, wall, CLI_FRAMES / wall,
                            *[1e3 * sec[k] / CLI_FRAMES for k in (
                                'read', 'serve', 'write')], sec['setup'],
                            {k: v for k, v in launches.items() if v},
                            summary['metrics'], power))
            if model == 'radarnet' and case == 'a':
                # FusionNet reads RadarNet's outputs of run a, as the
                # stages run from files
                for s in RUN_STREAMS['radarnet']:
                    io.write_paths(os.path.join(tmp, s + '.txt'), [
                        os.path.join(out_dir, s, n) for n in names])
                inputs['fusionnet'] = {
                    '--restore_path': [checkpoints[1]],
                    '--image_path': [manifests['image']],
                    '--depth_path': [os.path.join(
                        tmp, 'output_depth_radar.txt')],
                    '--response_path': [os.path.join(
                        tmp, 'output_response_radar.txt')],
                    '--ground_truth_path': [manifests['ground_truth']]}
        a, b = files['run {} a'.format(model)], files['run {} b'.format(model)]
        for s in RUN_STREAMS[model]:
            for n, x, y in zip(names, a[s], b[s]):
                check(np.array_equal(x, y), 'run {}: {}/{}: the codes made on '
                      'the card differ from the float writers\' at {} '
                      'pixels'.format(model, s, n, int((x != y).sum())))
        c = 'run {} c'.format(model)
        log('run {}: (b)\'s files (codes made on the card, no ground truth) '
            'equal (a)\'s (float writers) byte for byte in {}; bf16 (c) '
            'metrics {} against float32 (a) {}'.format(
                model, ', '.join(RUN_STREAMS[model]), metrics[c],
                metrics['run {} a'.format(model)]))

    # RadarNet's run a against stage 1 of the serving pipeline, folded with
    # K1, on the same 8 frames in one request
    dataset = RadarNetInferenceDataset(paths['image'], paths['radar'],
                                       max_points=None, device=device)
    samples = [dataset.get(i) for i in range(CLI_FRAMES)]
    widths = ('n_filters_encoder_image', 'n_neurons_encoder_depth',
              'n_filters_decoder')
    pipe = TwoStagePipeline.from_checkpoints(
        *checkpoints, image_height=H, image_width=W, patch_size=PATCH,
        radarnet_kwargs=dict({k: RADARNET[k] for k in widths},
                             perf=PerfConfig(pallas_scatter=True)),
        fusionnet_kwargs={k: FUSIONNET[k] for k in (
            'n_filters_encoder_image', 'n_filters_encoder_depth',
            'n_filters_decoder')},
        optimize=True, device=device)
    _, quasi, response = codec_encode(*pipe.forward_batched(
        *(np.stack([x[i] for x in samples]) for i in range(3))))
    got = files['run radarnet a']
    differ = [int((got[s][f] != ref[f].cpu().numpy().astype(np.int64))
                  .sum()) for f in range(CLI_FRAMES)
              for s, ref in (('output_depth_radar', quasi),
                             ('output_response_radar', response))]
    check(not any(differ), 'run radarnet a: quasi depth and response differ '
          'from the pipeline\'s stage 1 at {} pixels'.format(differ))
    log('run radarnet a: quasi depth and response of all {} frames equal '
        'stage 1 of TwoStagePipeline (folded, K1, one request of {}) code '
        'for code; {} covered pixels'.format(
            CLI_FRAMES, CLI_FRAMES,
            sum(int((x > 0).sum()) for x in got['output_depth_radar'])))
    del pipe
    return paths, checkpoints[0], inputs['fusionnet']


# phase bridge: the stage-1.5 bridge's scripts with
# bash/setup_dataset_nuscenes_radarnet.sh's flags on the run phase's frames,
# CLI_FRAMES // 2 a split
BRIDGE_SCRIPT = os.path.join('bash', 'setup_dataset_nuscenes_radarnet.sh')
BRIDGE_SPLITS = {'train': range(CLI_FRAMES // 2),
                 'val': range(CLI_FRAMES // 2, CLI_FRAMES)}
# (case, extra flags, environment, launches a forward, the case whose
# files this one's must equal)
BRIDGE_CASES = (
    ('a', [], {}, {'scatter_quasi_dense': 1}, None),
    ('b', ['--run_evaluation'], {}, {'scatter_quasi_dense': 1}, 'a'),
    ('c', ['--patch_size', str(WIDE_PATCH[0]), str(WIDE_PATCH[1])], {},
     {'scatter_quasi_dense': 1, 'column_crop': 3}, None),
    ('d', [], FUSED_ENV,
     {'scatter_quasi_dense': 1, 'fused_skip_gather_add': 2}, None),
    ('e', [], {}, {'scatter_quasi_dense': 1}, 'a'),
    ('f', [], {'RCFD_DECODE_CHUNKS': '2'}, {'scatter_quasi_dense': 1}, 'a'),
)
# the kernels of each case held to their plain versions on one bridge
# batch, at the case's own shapes
BRIDGE_PLAIN = {'a': ('scatter',), 'c': ('scatter', 'crop'),
                'd': ('scatter', 'fused'), 'e': ('scatter',)}
BRIDGE_CARD_CPU_FRAMES = 1
# card vs CPU: the crops the exact scatter takes agree within this (1.19e-7
# measured on an H100 80GB HBM3 at 700 W); a depth code may differ only
# where the top two responses lie within twice the measured difference of
# each other, or the top one within it of the threshold
BRIDGE_CARD_CPU_CROP_TOL = 1e-6
BRIDGE_KINDS = ('depth_predicted', 'response_predicted')


def bridge_inputs(paths, case_dir, splits):
    """The bridge's inputs for a case: a copy of the radar files under
    <case_dir>/radar_points/ (absolute radar paths map in place, so each
    case writes beside its own copy) and the manifests of ``splits``
    ({tag: frames}) with the shared frames and ground truths."""
    import shutil

    from rcfd_tpu_torch.data import io

    os.makedirs(os.path.join(case_dir, 'radar_points'))
    manifests = {}
    for tag, frames in splits.items():
        radar = []
        for i in frames:
            radar.append(os.path.join(case_dir, 'radar_points',
                                      os.path.basename(paths['radar'][i])))
            shutil.copyfile(paths['radar'][i], radar[-1])
        for stream, files in (('image', [paths['image'][i] for i in frames]),
                              ('radar', radar),
                              ('ground_truth', [paths['ground_truth'][i]
                                                for i in frames])):
            manifests[tag, stream] = os.path.join(
                case_dir, '{}_{}.txt'.format(tag, stream))
            io.write_paths(manifests[tag, stream], files)
    return manifests


def bridge_argv(manifests, out_dir, checkpoint, splits, with_gt, flags):
    """bash/setup_dataset_nuscenes_radarnet.sh's flags with this case's
    checkpoint, manifests of ``splits`` (ground truth only when
    ``with_gt``) and output directory; --verbose off."""
    values = script_flags(BRIDGE_SCRIPT)
    for key in [k for k in values if k.startswith(('--train_', '--val_'))]:
        del values[key]
    values.pop('--verbose', None)
    values.update({'--restore_path': [checkpoint],
                   '--output_dirpath': [out_dir]})
    for tag in splits:
        for stream in ('image', 'radar') + (('ground_truth',) if with_gt
                                            else ()):
            values['--{}_{}_path'.format(tag, stream)] = [
                manifests[tag, stream]]
    return [t for k, v in values.items() for t in [k] + v] + flags


def bridge_outputs(case_dir, tag, n):
    """The (depth, response) PNG paths of split ``tag`` of a case, from
    the manifests the bridge wrote."""
    from rcfd_tpu_torch.data import io

    split_dir = {'train': 'training', 'val': 'validation',
                 'test': 'testing'}[tag]
    out = [io.read_paths(os.path.join(
        case_dir, 'out', split_dir, 'nuscenes', 'nuscenes_{}_{}_predicted.txt'
        .format(tag, kind))) for kind in ('depth', 'response')]
    check(all(len(p) == n for p in out) and all(
        os.path.exists(f) for p in out for f in p),
        'bridge: {}: {} manifests list {} files, expected {} existing '
        'ones'.format(case_dir, tag, [len(p) for p in out], n))
    return out


def bridge_codes(files):
    from rcfd_tpu_torch.data import io

    return [io.load_depth_u16(f).astype(np.int64) for f in files]


def bridge_model(checkpoint, device, patch=PATCH, perf=None):
    """RadarNet as the bridge builds it (unfolded, float32; ``perf`` as
    the bridge reads it from the environment)."""
    from rcfd_tpu_torch import radarnet_main

    model = radarnet_main.build_model(
        input_channels_image=3, input_channels_depth=3, patch_size=patch,
        encoder_type='radarnetv1-batch_norm',
        n_filters_encoder_image=RADARNET['n_filters_encoder_image'],
        n_neurons_encoder_depth=RADARNET['n_neurons_encoder_depth'],
        decoder_type='multiscale-batch_norm',
        n_filters_decoder=RADARNET['n_filters_decoder'],
        weight_initializer='kaiming_uniform', activation_func='leaky_relu',
        device='cpu', perf=perf)
    model.restore_checkpoint(checkpoint, device=device)
    return model


def bridge_plain_route(name, device, paths, checkpoint, frames, patch,
                       max_points, kernels, per_forward):
    """One bridge batch of ``frames`` (the case's own shapes: its patch,
    its point count ``max_points``, None for the manifest's) through
    make_forward_fn_batched on the model the bridge builds, once on the
    kernels' routes and once with each of ``kernels`` replaced by its plain
    version where the path looks it up: depth and response must be equal
    bit for bit. Runs under the case's environment."""
    from rcfd_tpu_torch import radarnet_main
    from rcfd_tpu_torch.data.datasets import RadarNetInferenceDataset
    from rcfd_tpu_torch.data.transforms import Transforms
    from rcfd_tpu_torch.nn.perf import perf_from_env
    from rcfd_tpu_torch.ops import crop_cuda as cc
    from rcfd_tpu_torch.ops import fused_skip as fs
    from rcfd_tpu_torch.ops import roi_pool
    from rcfd_tpu_torch.ops import scatter_cuda as sc
    from rcfd_tpu_torch.pipeline import serving_numerics

    swaps = {'scatter': (sc, 'scatter_quasi_dense_batched',
                         sc.scatter_quasi_dense_batched_plain),
             'crop': (roi_pool, 'batch_column_crop',
                      cc.batch_column_crop_plain),
             'fused': (fs, 'fused_skip_gather_add',
                       fs.fused_skip_gather_add_plain)}
    dataset = RadarNetInferenceDataset(
        [paths['image'][i] for i in frames],
        [paths['radar'][i] for i in frames], max_points=max_points,
        device=device)
    samples = [dataset.get(i) for i in range(len(frames))]
    batch = tuple(torch.from_numpy(np.stack([x[j] for x in samples])).to(
        device) for j in range(3))
    model = bridge_model(checkpoint, device, patch, perf_from_env())
    forward = radarnet_main.make_forward_fn_batched(
        model, Transforms(normalized_image_range=[0, 1]), H, W)
    with serving_numerics():
        reset_launches()
        depth, response = forward(*batch)
        torch.cuda.synchronize()
        launches = read_launches()
        kept = [getattr(m, a) for m, a, _ in (swaps[k] for k in kernels)]
        for m, a, plain in (swaps[k] for k in kernels):
            setattr(m, a, plain)
        try:
            reset_launches()
            depth_p, response_p = forward(*batch)
            torch.cuda.synchronize()
            plain_launches = read_launches()
        finally:
            for (m, a, _), kernel in zip((swaps[k] for k in kernels), kept):
                setattr(m, a, kernel)
    check(all(n == per_forward.get(k, 0) for k, n in launches.items()) and
          not any(plain_launches.values()),
          '{}: plain-route check: launches {} on the kernels\' route '
          '(expected {}), {} on the plain one (expected none)'.format(
              name, launches, per_forward, plain_launches))
    check(torch.equal(depth, depth_p) and torch.equal(response, response_p),
          '{}: the kernels\' route differs from the plain one at {} depth '
          'and {} response pixels'.format(
              name, int((depth != depth_p).sum()),
              int((response != response_p).sum())))
    log('{}: one bridge batch of {} frames, K = {}, patch {}x{}: depth and '
        'response == the same forward with {}, bit for bit; {} covered '
        'pixels'.format(name, len(frames), dataset.max_points, *patch,
                        ', '.join(swaps[k][2].__name__ for k in kernels),
                        int((depth > 0).sum())))


def bridge_crops(model, paths, frame, device):
    """RadarNet's crops (K, ph, pw), padded x and validity of one frame,
    on the card, as the bridge's forward makes them."""
    from rcfd_tpu_torch import radarnet_main
    from rcfd_tpu_torch.data.datasets import RadarNetInferenceDataset
    from rcfd_tpu_torch.data.transforms import Transforms
    from rcfd_tpu_torch.pipeline import radarnet_crops, serving_numerics

    image, points, valid = RadarNetInferenceDataset(
        [paths['image'][frame]], [paths['radar'][frame]], max_points=None,
        device=device).get(0)
    with torch.inference_mode(), serving_numerics(), \
            radarnet_main.eval_mode(model):
        _, crops, xs, _ = radarnet_crops(
            model, Transforms(normalized_image_range=[0, 1]),
            torch.from_numpy(image[None]).to(device),
            torch.from_numpy(points[None]).to(device), H)
    return crops[0].float().cpu().numpy(), xs[0].cpu().numpy(), valid


def same_bytes(a, b):
    with open(a, 'rb') as f, open(b, 'rb') as g:
        return f.read() == g.read()


def compare_bridge(name, got, ref, frames, explain, step, tol=FOLD_TOL):
    """Codes of two runs' files, frame by frame: (frames whose files are
    equal byte for byte, pixels whose depth differs). Where they differ,
    each depth pixel must be explained by a tie (within ``step`` plus
    2 * ``tol``) or a top response within ``tol`` of the threshold
    (``explain(frame)`` gives the crops), and the response codes must lie
    within one step, or at such a pixel."""
    equal, n_depth = 0, 0
    for f, gd, gr, rd, rr in zip(frames, *got, *ref):
        if same_bytes(gd, rd) and same_bytes(gr, rr):
            equal += 1
            continue
        (dg, rg), (dr, rr_) = bridge_codes((gd, gr)), bridge_codes((rd, rr))
        quasi_px = np.argwhere(dg != dr)
        resp_px = np.argwhere(np.abs(rg - rr_) > 1)
        crops, xs, valid = explain(f)
        bad = unexplained_quasi(crops, xs, valid, quasi_px, tol, step)
        check(not bad, '{}: frame {}: depth differs at {} pixels that no '
              'tie or threshold explains: {}'.format(name, f, len(bad),
                                                     bad[:10]))
        bad = off_threshold(crops, xs, valid, resp_px, tol)
        check(not bad, '{}: frame {}: response differs by more than one '
              'code at {} pixels away from the threshold: {}'.format(
                  name, f, len(bad), bad[:10]))
        n_depth += len(quasi_px)
    return equal, n_depth


def phase_bridge(device, record, paths, checkpoint, tmp):
    """The stage-1.5 bridge (rcfd_tpu_torch.setup.setup_dataset_nuscenes_
    radarnet.main and its _test form, in process) with
    bash/setup_dataset_nuscenes_radarnet.sh's flags on the run phase's
    CLI_FRAMES full-size frames and RadarNet .pth, 4 train and 4 val, in
    the cases of BRIDGE_CASES, each run once, every launch count set to 0
    just before the run and read just after: (a) the defaults (codes made
    on the card, K1), (b) --run_evaluation with ground truth (the float
    route; (a)'s files), (c) the 900x300 patch (K2), (d) the fused gates (K3), (e) the _test script
    on the val frames at its K = 128 ((a)'s val files), (f) (a) under
    RCFD_DECODE_CHUNKS=2 ((a)'s files). Then BRIDGE_CARD_CPU_FRAMES frames
    on the card and on the CPU under RCFD_PALLAS_SCATTER=0. Prints
    frames/s, the read / serve / write split and peak memory."""
    from rcfd_tpu_torch.setup import setup_dataset_nuscenes_radarnet as bridge
    from rcfd_tpu_torch.setup import \
        setup_dataset_nuscenes_radarnet_test as bridge_test

    power = gpu_name_and_power()
    model = bridge_model(checkpoint, device)
    crops = {}

    def explain(frame):
        if frame not in crops:
            crops[frame] = bridge_crops(model, paths, frame, device)
        return crops[frame]

    outputs, summaries = {}, {}
    for case, flags, env, per_forward, same_as in BRIDGE_CASES:
        splits = {'val': BRIDGE_SPLITS['val']} if case == 'e' else \
            BRIDGE_SPLITS
        name = 'bridge ' + case

        def run(case_dir):
            manifests = bridge_inputs(paths, case_dir, splits)
            out_dir = os.path.join(case_dir, 'out')
            if case == 'e':
                return bridge_test.main([
                    '--restore_path', checkpoint, '--output_dirpath',
                    out_dir, '--test_image_path', manifests['val', 'image'],
                    '--test_radar_path', manifests['val', 'radar']],
                    device=device)
            return bridge.main(bridge_argv(
                manifests, out_dir, checkpoint, splits, case == 'b', flags),
                device=device)

        with environ(env):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            reset_launches()
            summary = run(os.path.join(tmp, 'bridge_' + case))
            launches = read_launches()
        peak = torch.cuda.max_memory_allocated(device)
        want = {k: v * len(splits) for k, v in per_forward.items()}
        check(all(n == want.get(k, 0) for k, n in launches.items()),
              '{}: launches {} (expected {})'.format(name, launches, want))
        count_launches(record, name, launches, list(want))
        case_dir = os.path.join(tmp, 'bridge_' + case)
        outputs[case] = {tag: bridge_outputs(
            case_dir, 'test' if case == 'e' else tag, len(frames))
            for tag, frames in splits.items()}
        summaries[case] = summary
        sec = summary['seconds']
        log('{}: flags {} env {}: {} frames in {:.3f} s of main, {:.3f} '
            'frames/s; per frame: host read {:.2f} ms, serve (to the outputs '
            'on the host) {:.2f} ms, host write{} {:.2f} ms; setup {:.3f} s; '
            'peak memory {} bytes; launches {}; {}'.format(
                name, ' '.join(flags) or '-', env or '{}',
                summary['frames'], summary['wall'], summary['frames_per_s'],
                *[1e3 * sec[k] / summary['frames'] for k in ('read',
                                                             'serve')],
                ' and metrics' if case == 'b' else '',
                1e3 * sec['write'] / summary['frames'], sec['setup'], peak,
                {k: v for k, v in launches.items() if v}, power))
        covered = [int((c > 0).sum()) for tag in splits
                   for c in bridge_codes(outputs[case][tag][0])]
        check(min(covered) > 0, '{}: a frame without quasi depth: covered '
              'pixels {}'.format(name, covered))
        if case in BRIDGE_PLAIN:
            first = next(iter(splits.values()))
            with environ(env):
                bridge_plain_route(
                    name, device, paths, checkpoint, first,
                    WIDE_PATCH if case == 'c' else PATCH,
                    128 if case == 'e' else None, BRIDGE_PLAIN[case],
                    per_forward)
        if same_as is None:
            continue
        n_frames = sum(len(f) for f in splits.values())
        if case in ('b', 'f'):
            # the float route's writers and the chunked decode change
            # nothing: the same files
            same = [same_bytes(g, r) for tag in splits
                    for kind in range(2) for g, r in zip(
                        outputs[case][tag][kind], outputs[same_as][tag][kind])]
            check(all(same), '{}: {} of {} files differ from ({})\'s'.format(
                name, same.count(False), len(same), same_as))
            log('{}: all {} files of {} frames equal ({})\'s byte for '
                'byte'.format(name, len(same), n_frames, same_as))
            continue
        # (e): K = 128 decodes 4 * 128 patches a forward where (a) decodes
        # 4 * 64: the convolutions may round otherwise at the other batch,
        # and K1 keeps the first point within one 2^-14 step
        equal, n_depth = 0, 0
        for tag, frames in splits.items():
            e, n = compare_bridge(name, outputs[case][tag],
                                  outputs[same_as][tag], frames, explain,
                                  2.0 ** -14)
            equal, n_depth = equal + e, n_depth + n
        log('{}: files against ({})\'s: {} of {} frames byte for byte; {} '
            'depth pixels differ elsewhere, each where the top two responses '
            'lie within 2^-14 + {:g} of each other (a 14-bit tie) or the top '
            'one within {:g} of the threshold; responses within one code '
            'elsewhere'.format(name, same_as, equal, n_frames, n_depth,
                                2 * FOLD_TOL, FOLD_TOL))
    log('bridge f (RCFD_DECODE_CHUNKS=2) against a (one decode chunk a '
        'forward): {:.3f} against {:.3f} frames/s; peak memory printed '
        'above'.format(summaries['f']['frames_per_s'],
                       summaries['a']['frames_per_s']))
    bridge_card_vs_cpu(device, paths, checkpoint, tmp)


def with_drawn_batch_norm(model, seed):
    """``model`` with every batch norm's weight and running variance drawn
    from U(0.5, 1.5), bias and running mean from N(0, 0.1) (the ranges of
    the tests' randomize_batch_norm)."""
    from rcfd_tpu_torch.nn import BatchNorm2d

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, BatchNorm2d):
                n = bn.weight.numel()
                for t, uniform in ((bn.weight, True), (bn.bias, False),
                                   (bn.running_mean, False),
                                   (bn.running_var, True)):
                    x = 0.5 + torch.rand(n, generator=gen) if uniform else \
                        0.1 * torch.randn(n, generator=gen)
                    t.copy_(x.to(t.device))
    return model


def bridge_card_vs_cpu(device, paths, checkpoint, tmp):
    """The bridge on BRIDGE_CARD_CPU_FRAMES frames on the card and on the
    CPU, the exact max on both (RCFD_PALLAS_SCATTER=0), a frame a forward,
    from the run phase's RadarNet with its batch norms drawn
    (``with_drawn_batch_norm``, so that its responses do not saturate):
    each frame's crops card vs CPU (those the exact scatter took, caught
    on their way in) within BRIDGE_CARD_CPU_CROP_TOL; depth codes equal
    but where the top two responses lie within twice the largest measured
    difference of each other or the top one within it of the threshold,
    responses within one code. Prints the share of the covered pixels that
    this rule could excuse."""
    from rcfd_tpu_torch.ops import scatter as exact
    from rcfd_tpu_torch.setup import setup_dataset_nuscenes_radarnet as bridge

    model = with_drawn_batch_norm(bridge_model(checkpoint, 'cpu'), SEED + 50)
    checkpoint = os.path.join(tmp, 'radarnet_drawn_batch_norm.pth')
    model.save_checkpoint(checkpoint, 0)
    del model
    frames = range(BRIDGE_CARD_CPU_FRAMES)
    outputs, wall, seen = {}, {}, {}
    scatter = exact.scatter_quasi_dense_batched

    def caught(side):
        def scatter_and_keep(crops, xs, zs, valid, **kw):
            seen.setdefault(side, []).append(
                (crops[0].float().cpu().numpy(), xs[0].cpu().numpy(),
                 valid[0].cpu().numpy()))
            return scatter(crops, xs, zs, valid, **kw)
        return scatter_and_keep

    with environ({'RCFD_PALLAS_SCATTER': '0'}):
        for side, dev in (('card', device), ('cpu', 'cpu')):
            case_dir = os.path.join(tmp, 'bridge_' + side)
            manifests = bridge_inputs(paths, case_dir, {'val': frames})
            reset_launches()
            exact.scatter_quasi_dense_batched = caught(side)
            try:
                t0 = time.perf_counter()
                bridge.main(bridge_argv(
                    manifests, os.path.join(case_dir, 'out'), checkpoint,
                    ['val'], False, ['--eval_batch_size', '1']), device=dev)
                wall[side] = time.perf_counter() - t0
            finally:
                exact.scatter_quasi_dense_batched = scatter
            launches = read_launches()
            check(not any(launches.values()), 'bridge {}: launches {} under '
                  'RCFD_PALLAS_SCATTER=0'.format(side, launches))
            outputs[side] = bridge_outputs(case_dir, 'val', len(frames))
    check(len(seen['card']) == len(seen['cpu']) == len(frames),
          'bridge card vs CPU: {} and {} scatters for {} frames'.format(
              len(seen['card']), len(seen['cpu']), len(frames)))
    tol = BRIDGE_CARD_CPU_CROP_TOL
    crop_err = [float(np.abs(a[0] - b[0]).max())
                for a, b in zip(seen['card'], seen['cpu'])]
    check(max(crop_err) <= tol and all(
        np.array_equal(a[i], b[i]) for a, b in zip(seen['card'], seen['cpu'])
        for i in (1, 2)), 'bridge card vs CPU: crops differ by {} (tolerance '
        '{:g}), or the points differ'.format(crop_err, tol))
    err = max(crop_err)

    def explain(frame):
        return seen['card'][frame]

    equal, n_depth = compare_bridge('bridge card vs CPU', outputs['card'],
                                    outputs['cpu'], frames, explain, 0.0,
                                    err)
    covered, n_excused, n_saturated = 0, 0, 0
    for f, codes in zip(frames, bridge_codes(outputs['card'][0])):
        px = np.argwhere(codes > 0)
        c, xs, valid = explain(f)
        n_excused += int(excused(c, xs, valid, px, err, 0.0).sum())
        top, _ = top_responses(c, xs, valid, px)
        covered, n_saturated = covered + len(px), n_saturated + int(
            (top[:, 0] >= 1.0 - FOLD_TOL).sum())
    log('bridge card vs CPU (exact max, RadarNet with drawn batch-norm '
        'statistics, {} frames, {:.2f} s on the card, {:.2f} s on the CPU): '
        '{} of {} frames byte for byte; {} of {} covered depth pixels '
        'differ ({:.2f} a frame), each where the top two responses lie '
        'within {:g} of each other or the top one within {:g} of the '
        'threshold, a rule that could excuse {} of the covered pixels '
        '({:.3%}); {} covered pixels ({:.3%}) have a top response within '
        '{:g} of 1; responses within one code elsewhere; the crops the '
        'scatter took card vs CPU max abs diff {} (tolerance {:g})'.format(
            len(frames), wall['card'], wall['cpu'], equal, len(frames),
            n_depth, covered, n_depth / len(frames), 2 * err, err,
            n_excused, n_excused / covered, n_saturated,
            n_saturated / covered, FOLD_TOL,
            ', '.join('{:.3g}'.format(e) for e in crop_err), tol))


# -- the JAX package's tools as the port runs them -----------------------------

def same_tree(a, b):
    """Two loaded checkpoint trees equal: the same keys, tensors of the
    same dtype, shape and values, other values equal."""
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a, key=str) == sorted(
            b, key=str) and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and \
            a.shape == b.shape and torch.equal(a, b)
    return type(a) is type(b) and a == b


def tools_convert(device, checkpoints, tmp):
    """convert_checkpoint.main on the card (the canonical widths are its
    defaults): each .pth -> .npz -> .pth, restored on the card, its
    state_dict equal to the original file's bit for bit and the step
    carried (the .npz drops the optimizer state); a .pth with an Adam
    state -> .pth carries it unchanged."""
    import contextlib
    import io as stdio

    from rcfd_tpu_torch.models import fusionnet, radarnet
    from rcfd_tpu_torch.tools import convert_checkpoint
    from rcfd_tpu_torch.utils.checkpoint import load_checkpoint_file

    models = {'radarnet': (radarnet.PTH_KEYS, radarnet.OPTIMIZER_KEY,
                           RADARNET, radarnet.RadarNetModel),
              'fusionnet': (fusionnet.PTH_KEYS, 'optimizer_state_dict',
                            FUSIONNET, fusionnet.FusionNetModel)}
    for name, path in checkpoints.items():
        keys, opt_key, config, cls = models[name]
        want, step, opt = load_checkpoint_file(path, keys, opt_key)
        chain = [path] + [os.path.join(tmp, 'tools_{}.{}'.format(name, ext))
                          for ext in ('npz', 'pth')]
        if opt:
            chain += [os.path.join(tmp, 'tools_{}_adam.pth'.format(name))]
        seconds = []
        for src, dst in zip(chain, chain[1:]):
            if dst.endswith('_adam.pth'):
                src = path
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(stdio.StringIO()) as out:
                got_step = convert_checkpoint.main(
                    ['--model', name, '--input', src, '--output', dst],
                    device=device)
            seconds.append(time.perf_counter() - t0)
            check(got_step == step and out.getvalue() ==
                  'converted {} -> {} (step {})\n'.format(src, dst, step),
                  'tools {}: {} -> {}: step {}, printed {!r}'.format(
                      name, src, dst, got_step, out.getvalue()))
        model = cls(**config, device='cpu')
        check(model.restore_checkpoint(chain[2], device=device) == step,
              'tools {}: the round trip lost the step'.format(name))
        got = model.state_dict()
        check(sorted(got) == sorted(want) and all(
            got[k].dtype == want[k].dtype and torch.equal(got[k].cpu(),
                                                          want[k])
            for k in want), 'tools {}: .pth -> .npz -> .pth restores other '
            'weights than the original\'s'.format(name))
        final = torch.load(chain[2], map_location='cpu', weights_only=True)
        check(not final[opt_key], 'tools {}: the .npz carried an optimizer '
              'state'.format(name))
        carried = ''
        if opt:
            a, b = (torch.load(p, map_location='cpu', weights_only=True)
                    for p in (path, chain[3]))
            check(same_tree(a[opt_key], b[opt_key]), 'tools {}: .pth -> '
                  '.pth changed the Adam state'.format(name))
            carried = ('; .pth -> .pth carries the Adam state ({} entries) '
                       'unchanged in {:.3f} s'.format(
                           len(a[opt_key]['state']), seconds[-1]))
        log('tools convert {}: {} -> .npz {:.3f} s -> .pth {:.3f} s on the '
            'card, restored: {} tensors equal the original\'s bit for bit, '
            'step {}{}'.format(name, os.path.basename(path), seconds[0],
                               seconds[1], len(want), step, carried))


def tools_bridgebench(device, record, paths, checkpoint, tmp):
    """bridgebench.run_bridge on the run phase's CLI_FRAMES frames and
    RadarNet (the bridge's: unfolded, float32), one batch of CLI_FRAMES,
    after a warm-up pass: prefetch, sync and codec, every launch count set
    to 0 before the three passes and read after (K1 once a pass), the
    files of the three modes byte for byte equal. Prints frames/s."""
    from rcfd_tpu_torch import radarnet_main
    from rcfd_tpu_torch.data.datasets import RadarNetInferenceDataset
    from rcfd_tpu_torch.data.transforms import Transforms
    from rcfd_tpu_torch.tools import bridgebench

    dataset = RadarNetInferenceDataset(paths['image'], paths['radar'],
                                       max_points=None, device=device)
    model = bridge_model(checkpoint, device)
    forwards = {codec: radarnet_main.make_forward_fn_batched(
        model, Transforms(normalized_image_range=[0, 1]), H, W,
        codec_encode=codec) for codec in (False, True)}
    warm, _, _ = bridgebench.run_bridge(
        'prefetch', forwards[False], dataset, os.path.join(
            tmp, 'tools_warm'), CLI_FRAMES, device)
    outs, rates = {}, {}
    reset_launches()
    for mode in bridgebench.MODES:
        dt, n, outs[mode] = bridgebench.run_bridge(
            mode, forwards[mode == 'codec'], dataset,
            os.path.join(tmp, 'tools_' + mode), CLI_FRAMES, device)
        rates[mode] = n / dt
    launches = read_launches()
    want = {'scatter_quasi_dense': len(bridgebench.MODES)}
    check(all(n == want.get(k, 0) for k, n in launches.items()),
          'tools bridgebench: launches {} (expected {})'.format(launches,
                                                                want))
    count_launches(record, 'tools bridgebench', launches, list(want))
    same = [same_bytes(a.replace('depth_', kind), b.replace('depth_', kind))
            for mode in ('sync', 'codec')
            for a, b in zip(outs['prefetch'], outs[mode])
            for kind in ('depth_', 'resp_')]
    check(all(same), 'tools bridgebench: {} of {} files of sync and codec '
          'differ from prefetch\'s'.format(same.count(False), len(same)))
    log('tools bridgebench: {} frames of 900x1600, K = {}, one batch, after '
        'a warm-up pass of {:.3f} s: frames/s {}; sync\'s and codec\'s {} '
        'files equal prefetch\'s byte for byte; launches {}; {}'.format(
            CLI_FRAMES, dataset.max_points, warm,
            ', '.join('{} {:.3f}'.format(m, r) for m, r in rates.items()),
            len(same), {k: v for k, v in launches.items() if v},
            gpu_name_and_power()))


def phase_tools(device, record, paths, rn_checkpoint, fn_checkpoint, tmp):
    """The JAX package's tools as the port runs them: the converter's
    round trips (tools_convert), then the bridge harness
    (tools_bridgebench)."""
    tools_convert(device, {'radarnet': rn_checkpoint,
                           'fusionnet': fn_checkpoint}, tmp)
    tools_bridgebench(device, record, paths, rn_checkpoint, tmp)


# -- the model configurations the port took last --------------------------------

# phase configs: the training CLI with bash/train_fusionnet_nuscenes.sh's
# flags on the train phase's files, CONFIG_STEPS steps of batch 16 (one an
# epoch; a checkpoint and a validation at the last), in the configurations
# of CONFIG_CASES; ms a step is the median of CONFIG_TIMED (steps 1-2
# choose cuDNN's algorithms). (a) and (b) also serve CONFIG_SERVED frames
# of the run phase with run_fusionnet.main from their checkpoint. (d) has
# no flag in the JAX CLI: fusionnet_main.TrainStep on a model built with
# deconv_type='transpose', on the loader's batches
CONFIG_STEPS = 5
CONFIG_TIMED = range(3, CONFIG_STEPS + 1)
CONFIG_SERVED = 2
CONFIG_CASES = (
    ('a', ['--n_resolutions_decoder', '3'], True),
    ('b', ['--encoder_type', 'resnet18', 'batch_norm'], True),
    ('c', ['--encoder_type', 'fusionnet34', 'batch_norm'], False),
)
# card vs CPU: a narrow FusionNet of each case at 64 x 128 (every side
# halves evenly down its 6 levels, which the transposed route needs)
CONFIG_NARROW = dict(FUSIONNET,
                     n_filters_encoder_image=[8, 16, 16, 16, 16, 16],
                     n_filters_encoder_depth=[8, 8, 16, 16, 16, 16],
                     n_filters_decoder=[16, 16, 16, 8, 8, 8])
CONFIG_MODELS = {'a': dict(n_resolution_decoder=3),
                 'b': dict(encoder_type='resnet18_batch_norm'),
                 'c': dict(encoder_type='fusionnet34_batch_norm'),
                 'd': dict(deconv_type='transpose')}


def config_step_numbers(name, timings, wall, peak):
    """Check a case's CONFIG_STEPS steps and print its ms a step, host wait,
    samples/s and peak memory."""
    losses = [t['loss'] for t in timings]
    check([t['step'] for t in timings] ==
          list(range(1, CONFIG_STEPS + 1)) and
          all(math.isfinite(v) for v in losses),
          '{}: steps {} losses {}'.format(
              name, [t['step'] for t in timings], losses))
    timed = [t for t in timings if t['step'] in CONFIG_TIMED]
    out = dict(step_ms=float(np.median([t['step_ms'] for t in timed])),
               wait_ms=float(np.median([t['wait_ms'] for t in timed])),
               peak=peak)
    out['samples_per_s'] = 16e3 / float(np.median(
        [t['step_ms'] + t['wait_ms'] for t in timed]))
    log('{}: {} steps of batch 16 at 448x448 in {:.2f} s; over steps {}, '
        'medians: ms a step (synchronized) {:.2f}, host wait {:.2f} ms, '
        'samples/s {:.2f}; peak memory {} bytes; losses {}; per step (ms, '
        'wait ms): {}; {}'.format(
            name, CONFIG_STEPS, wall, [t['step'] for t in timed],
            out['step_ms'], out['wait_ms'], out['samples_per_s'], peak,
            ', '.join('{:.4f}'.format(v) for v in losses),
            ', '.join('{:.1f}/{:.1f}'.format(t['step_ms'], t['wait_ms'])
                      for t in timings), gpu_name_and_power()))
    return out


def config_cli(device, case, flags, serve, manifests, served, tmp):
    """Case a, b or c: the training CLI with ``flags``; with ``serve``
    run_fusionnet.main on ``served`` (the run phase's FusionNet inputs,
    CONFIG_SERVED frames) from the case's checkpoint."""
    from rcfd_tpu_torch import run_fusionnet, train_fusionnet

    name = 'configs {}'.format(case)
    ckpt = os.path.join(tmp, 'config_' + case)
    timings = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    train_fusionnet.main(train_argv(manifests, ckpt, CONFIG_STEPS) + flags,
                         timings=timings)
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(not any(launches.values()), '{}: launches {} (none expected)'
          .format(name, launches))
    path = os.path.join(ckpt, 'model-{}.pth'.format(CONFIG_STEPS))
    check_checkpoint(path, CONFIG_STEPS)
    rows = validation_lines(os.path.join(ckpt, 'results.txt'))
    check(len(rows) == 2 and all(len(r) == 5 and all(map(math.isfinite, r))
                                 for r in rows),
          '{}: validation rows {}'.format(name, rows))
    log('{}: flags {}; validation (step, MAE, RMSE, iMAE, iRMSE) {}'.format(
        name, ' '.join(flags), rows))
    numbers = config_step_numbers(name, timings, wall,
                                  torch.cuda.max_memory_allocated(device))
    if not serve:
        return numbers
    out_dir = os.path.join(tmp, 'config_{}_run'.format(case))
    argv = run_argv('fusionnet', dict(served, **{'--restore_path': [path]}),
                    out_dir, True, flags)
    t0 = time.perf_counter()
    summary = run_fusionnet.main(argv, device=device)
    wall = time.perf_counter() - t0
    written = sorted(os.listdir(os.path.join(out_dir, 'output_depth_fusion')))
    check(summary['frames'] == CONFIG_SERVED and
          len(written) == CONFIG_SERVED and
          all(math.isfinite(v) for v in summary['metrics'].values()),
          '{}: run_fusionnet served {} frames, wrote {}, metrics {}'.format(
              name, summary['frames'], written, summary['metrics']))
    log('{}: run_fusionnet.main from model-{}.pth served {} full-size frames '
        'in {:.3f} s (setup {:.3f} s, serve {:.2f} ms a frame); metrics {}'
        .format(name, CONFIG_STEPS, CONFIG_SERVED, wall,
                summary['seconds']['setup'],
                1e3 * summary['seconds']['serve'] / CONFIG_SERVED,
                summary['metrics']))
    return numbers


def config_transpose(device, manifests):
    """Case d: fusionnet_main.TrainStep on FusionNet at the script's widths
    with deconv_type='transpose', CONFIG_STEPS steps on the loader's
    batches (one an epoch, as the CLI's), the script's augmentation."""
    from rcfd_tpu_torch import fusionnet_main as fm
    from rcfd_tpu_torch.data import io
    from rcfd_tpu_torch.data.datasets import FusionNetTrainingDataset
    from rcfd_tpu_torch.data.loader import DataLoader, device_prefetch
    from rcfd_tpu_torch.data.transforms import Transforms
    from rcfd_tpu_torch.models import FusionNetModel
    from rcfd_tpu_torch.nn import init_parameters
    from rcfd_tpu_torch.training import step_seed, step_timing, timed

    flags = script_flags(TRAIN_SCRIPT)
    floats = lambda k: [float(v) for v in flags[k]]  # noqa: E731
    model = FusionNetModel(**dict(FUSIONNET, deconv_type='transpose'),
                           device='cpu', trainable=True)
    init_parameters(model, torch.Generator().manual_seed(SEED + 60))
    model.to(device)
    dataset = FusionNetTrainingDataset(
        *[io.read_paths(manifests['train', k]) for k in TRAIN_STREAMS],
        shape=(int(flags['--n_height'][0]), int(flags['--n_width'][0])),
        random_crop_type=flags['--augmentation_random_crop_type'],
        device=device)
    loader = DataLoader(dataset, batch_size=16, shuffle=True, num_workers=8,
                        seed=SEED + 60, drop_last=True)
    transforms = Transforms(
        normalized_image_range=floats('--normalized_image_range'),
        random_brightness=floats('--augmentation_random_brightness'),
        random_contrast=floats('--augmentation_random_contrast'),
        random_saturation=floats('--augmentation_random_saturation'),
        random_flip_type=flags['--augmentation_random_flip_type'])
    step = fm.TrainStep(model, transforms, fm.make_optimizer(model, 1e-3,
                                                             0.0),
                        'l1', 0.0, 2.0, -1, 7, 1.5, -1)
    generator = torch.Generator(device=device)
    timings = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t_start = time.perf_counter()
    with fm.training_numerics():
        for n in range(1, CONFIG_STEPS + 1):
            loader.set_epoch(n)
            for batch, wait_ms, t0 in timed(device_prefetch(loader, device)):
                generator.manual_seed(step_seed(SEED + 60, n))
                info = step(batch, transforms.draws(generator, 16, 1.0),
                            1e-3)
                timings.append(step_timing(device, n, t0, wait_ms,
                                           info['loss']))
    return config_step_numbers(
        'configs d (deconv_type transpose, TrainStep)', timings,
        time.perf_counter() - t_start,
        torch.cuda.max_memory_allocated(device))


def config_card_vs_cpu(device, case):
    """A narrow FusionNet of ``case``: one train step card vs CPU (phase
    train's tolerances: the loss within CARD_LOSS_RTOL, the running
    statistics within CARD_STATS_RTOL; each device's gradients within
    CARD_GRAD_TOL of the largest gradient of the CPU's float64 step, as
    phase train_radarnet holds its narrow steps, since the per-tensor
    measure of phase train's check puts the CPU's own float32 gradients
    of (a) and (d) 6.0e-3 and 7.2e-3 from float64 on a batch-norm weight
    and a projection) and then, from the two models, one
    return_multiscale forward in eval mode: each output within
    CARD_LOSS_RTOL of the CPU's largest value."""
    kw = dict(CONFIG_NARROW, **CONFIG_MODELS[case])
    r = narrow_step_card_vs_cpu(device, kw, (64, 128), SEED + 61,
                                float64=True)
    rng = np.random.default_rng(SEED + 62)
    image = torch.from_numpy(rng.random((2, 3, 64, 128), dtype=np.float32))
    depth = torch.from_numpy(rng.random((2, 2, 64, 128), dtype=np.float32))
    with torch.no_grad():
        outs = [model.eval()(image.to(dev), depth.to(dev),
                             return_multiscale=True)
                for model, dev in ((r['cpu'], 'cpu'), (r['card'], device))]
    check(len(outs[0]) == len(outs[1]) == max(
        kw['n_resolution_decoder'], 1), 'configs {}: {} and {} outputs'
        .format(case, len(outs[0]), len(outs[1])))
    out_err = max(float((b.cpu() - a).abs().max() / a.abs().max())
                  for a, b in zip(*outs))
    check(r['loss_err'] <= CARD_LOSS_RTOL and
          r['card_err'] <= CARD_GRAD_TOL and r['cpu_err'] <= CARD_GRAD_TOL
          and r['stats_err'] <= CARD_STATS_RTOL and
          out_err <= CARD_LOSS_RTOL,
          'configs {}: card vs CPU: loss rel err {}, gradients from float64 '
          'card {} CPU {} of the largest, running statistics rel err {}, '
          'outputs {}'.format(case, r['loss_err'], r['card_err'],
                              r['cpu_err'], r['stats_err'], out_err))
    log('configs {}: a narrow model ({}) card vs CPU from the same weights '
        'and batch: one step: loss rel err {:.3g} (tolerance {:g}), '
        'gradients from the CPU\'s float64 step, of its largest gradient: '
        'card {:.3g}, CPU {:.3g} (tolerance {:g}), card vs CPU {:.3g} of '
        'each tensor\'s max-abs over {} tensors; running statistics rel '
        'err {:.3g} (tolerance {:g}); return_multiscale forward, {} outputs, '
        'max err {:.3g} of their max-abs (tolerance {:g})'.format(
            case, CONFIG_MODELS[case], r['loss_err'], CARD_LOSS_RTOL,
            r['card_err'], r['cpu_err'], CARD_GRAD_TOL, r['grad_err'],
            r['n_grads'], r['stats_err'], CARD_STATS_RTOL, len(outs[0]),
            out_err, CARD_LOSS_RTOL))


def phase_configs(device, trained, served, tmp):
    """FusionNet in the configurations of CONFIG_CASES and (d) on the train
    phase's files (``trained`` holds their manifests), and each case card
    vs CPU at narrow widths. Prints the fusionnet18 step of phase train
    beside them."""
    from rcfd_tpu_torch.data import io

    # CONFIG_SERVED frames of the run phase's FusionNet inputs
    two = {}
    for flag, (path,) in served.items():
        if flag == '--restore_path':
            continue
        two[flag] = [os.path.join(tmp, 'configs_' + os.path.basename(path))]
        io.write_paths(two[flag][0], io.read_paths(path)[:CONFIG_SERVED])
    numbers = {}
    for case, flags, serve in CONFIG_CASES:
        numbers[case] = config_cli(device, case, flags, serve,
                                   trained['manifests'], two, tmp)
        torch.cuda.empty_cache()
    numbers['d'] = config_transpose(device, trained['manifests'])
    torch.cuda.empty_cache()
    for case in sorted(CONFIG_MODELS):
        config_card_vs_cpu(device, case)
    log('configs: ms a step (a) n_resolutions_decoder 3 {:.2f}, (b) '
        'resnet18 image only {:.2f}, (c) fusionnet34 {:.2f}, (d) transpose '
        '{:.2f}, against fusionnet18 {:.2f} (phase train, steps 3-10); peak '
        'memory {}; {}'.format(
            *[numbers[c]['step_ms'] for c in 'abcd'], trained['step_ms'],
            [numbers[c]['peak'] for c in 'abcd'], gpu_name_and_power()))


# ---------------------------------------------------------------------------
# phase stage0: the stage-0 scripts over a fake nuScenes DB at the real sizes
# ---------------------------------------------------------------------------

# nuScenes calibrations of CAM_FRONT, LIDAR_TOP and RADAR_FRONT in the ego
# frame (x forward, y left, z up), as a v1.0 scene's calibrated_sensor
# records give them
S0_CAMERA = dict(
    rotation=[0.4998015430569128, -0.5030316162024876, 0.4997798114386805,
              -0.49737083824542755],
    translation=[1.70079118954, 0.0159456324149, 1.51095763913],
    camera_intrinsic=[[1266.417203046554, 0.0, 816.2670197447984],
                      [0.0, 1266.417203046554, 491.50706579294757],
                      [0.0, 0.0, 1.0]])
S0_LIDAR = dict(rotation=[0.7077955119163518, -0.006492242056004365,
                          0.010646214713995808, -0.7063073142877817],
                translation=[0.943713, 0.0, 1.84023])
S0_RADAR = dict(rotation=[0.9999984769132877, 0.0, 0.0,
                          0.0017453283658983088],
                translation=[3.412, 0.0, 0.5])
# LIDAR_TOP: 32 beams (HDL-32E, -30.67 to +10.67 degrees) x 1,085 azimuth
# steps = 34,720 points a sweep at 20 Hz; RADAR_FRONT 125 returns,
# unfiltered; CAM_FRONT at 12 Hz; keyframes at 2 Hz; the ego at 10 m/s
S0_BEAMS, S0_AZIMUTHS = 32, 1085
S0_RADAR_RETURNS = 125
S0_LIDAR_US, S0_CAMERA_US = 50000, 83333
S0_KEYFRAME_SWEEPS = 10
S0_SPEED = 10.0
S0_MAX_RANGE = 80.0
# the three scenes: (a) 3 keyframes, (b) 19 keyframes (the middle one's
# merges at +-9), (c) 2 keyframes inside a chain of 171 sweeps (+-80)
S0_SCENES = {'a': (range(0, 21, 10), 21), 'b': (range(0, 181, 10), 181),
             'c': ((80, 90), 171)}
S0_FRAMES = 9
S0_DENSE_FRAMES = 80
S0_CPU_DENSE_FRAMES = 8
S0_RAW_REQUESTS = 3
S0_STREAMS = ('lidar', 'radar_points', 'radar_points_reprojected',
              'ground_truth', 'ground_truth_interp')


def s0_rotation(q):
    """pyquaternion's (w, x, y, z) -> 3x3, float64."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


class StageZeroWorld:
    """A seeded street in the global frame: the ground plane z = 0, walls
    of buildings on both sides, parked cars, and movers (two cars and a
    pedestrian) whose boxes move with time. Rays that hit nothing within
    S0_MAX_RANGE return at that range. Point clouds are cast once per
    token and kept."""

    def __init__(self, rng):
        boxes = [((100.0, side * 14.0, 6.0), (140.0, 2.0, 6.0), (0, 0, 0),
                  '') for side in (-1, 1)]
        for x in np.arange(6.0, 240.0, 9.0):
            for side in (-1, 1):
                if rng.random() < 0.5:
                    boxes.append(((x + rng.uniform(-2, 2),
                                   side * rng.uniform(5.5, 7.5), 0.8),
                                  (2.3, 0.95, 0.8), (0, 0, 0), ''))
        boxes += [((25.0, -1.7, 0.8), (2.3, 0.95, 0.8), (7.0, 0, 0),
                   'vehicle.car'),
                  ((160.0, 1.8, 0.85), (2.4, 1.0, 0.85), (-9.0, 0, 0),
                   'vehicle.car'),
                  ((45.0, 4.0, 0.9), (0.3, 0.3, 0.9), (0, -0.8, 0),
                   'human.pedestrian.adult')]
        self.boxes = [(np.array(c), np.array(h), np.array(v), name)
                      for c, h, v, name in boxes]
        self.cache = {}
        self.radar_dirs = self._radar_dirs(rng)

    @staticmethod
    def _radar_dirs(rng):
        az = np.sort(rng.uniform(-np.pi / 3, np.pi / 3, S0_RADAR_RETURNS))
        el = rng.uniform(-0.03, 0.06, S0_RADAR_RETURNS)
        return np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                         np.sin(el)], 1)

    def boxes_at(self, t_s, movers_only=False):
        return [(c + v * t_s, h, name) for c, h, v, name in self.boxes
                if name or not movers_only]

    def cast(self, origin, dirs, t_s):
        """Distance along each unit ray to the first hit. Only rays within
        70 degrees of the ego's heading (the cameras' side of the sweep)
        are tested against the boxes ahead; the others see the ground or
        the range limit."""
        dist = np.full(len(dirs), S0_MAX_RANGE)
        down = dirs[:, 2] < -1e-9
        dist[down] = np.minimum(dist[down], -origin[2] / dirs[down, 2])
        front = np.nonzero(dirs[:, 0] > np.cos(np.deg2rad(70.0)) *
                           np.linalg.norm(dirs[:, :2], axis=1))[0]
        d = dirs[front]
        inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
        best = dist[front]
        for c, h, _ in self.boxes_at(t_s):
            if c[0] + h[0] < origin[0] or \
                    c[0] - h[0] > origin[0] + S0_MAX_RANGE:
                continue
            lo = (c - h - origin) * inv
            hi = (c + h - origin) * inv
            t_near = np.minimum(lo, hi).max(1)
            t_far = np.maximum(lo, hi).min(1)
            hit = (t_far >= t_near) & (t_near > 0) & (t_near < best)
            best[hit] = t_near[hit]
        dist[front] = best
        return dist

    def sensor_points(self, ego_x, t_s, sensor):
        """The sweep of ``sensor`` ('lidar' or 'radar') at ego position
        ``ego_x`` and time ``t_s``: (N, 3) float32 in the sensor frame."""
        calib = S0_LIDAR if sensor == 'lidar' else S0_RADAR
        rot = s0_rotation(calib['rotation'])
        mount = np.asarray(calib['translation'])
        if sensor == 'lidar':
            el = np.deg2rad(np.linspace(-30.67, 10.67, S0_BEAMS))
            az = np.linspace(-np.pi, np.pi, S0_AZIMUTHS, endpoint=False)
            el, az = np.meshgrid(el, az, indexing='ij')
            dirs = np.stack([np.cos(el) * np.cos(az),
                             np.cos(el) * np.sin(az), np.sin(el)],
                            -1).reshape(-1, 3)
        else:
            dirs = self.radar_dirs @ rot.T
        origin = mount + np.array([ego_x, 0.0, 0.0])
        hits = origin + dirs * self.cast(origin, dirs, t_s)[:, None]
        return ((hits - origin) @ rot).astype(np.float32)


class StageZeroDB:
    """A fake nuScenes DB (the devkit's ``get`` and ``scene``) of one scene
    in a StageZeroWorld: lidar sweeps 0 .. n_sweeps - 1 at 20 Hz,
    keyframes at ``sample_sweeps`` with their RADAR_FRONT records and the
    closest CAM_FRONT record, camera records at 12 Hz over the chain. The
    ego drives along the global x axis at S0_SPEED; every sensor record's
    ego pose is the ego at its timestamp."""

    def __init__(self, world, sample_sweeps, n_sweeps):
        self.world = world
        self.dataroot = '/nonexistent'
        ident = [1.0, 0.0, 0.0, 0.0]
        self.tables = {'sample': {}, 'sample_data': {}, 'ego_pose': {},
                       'calibrated_sensor': {'cam': S0_CAMERA,
                                             'lidar': S0_LIDAR,
                                             'radar': S0_RADAR}}
        end = (n_sweeps - 1) * S0_LIDAR_US

        def record(token, kind, t_us, prev, nxt, **extra):
            self.tables['ego_pose']['ego_' + token] = dict(
                rotation=ident, translation=[S0_SPEED * t_us * 1e-6, 0.0,
                                             0.0])
            self.tables['sample_data'][token] = dict(
                token=token, calibrated_sensor_token=kind,
                ego_pose_token='ego_' + token, timestamp=t_us, prev=prev,
                next=nxt, filename=token, **extra)

        for i in range(n_sweeps):
            record('lidar{}'.format(i), 'lidar', i * S0_LIDAR_US,
                   'lidar{}'.format(i - 1) if i else '',
                   'lidar{}'.format(i + 1) if i < n_sweeps - 1 else '')
        n_cams = end // S0_CAMERA_US + 1
        self.camera_tokens = ['cam{}'.format(j) for j in range(n_cams)]
        for j in range(n_cams):
            record('cam{}'.format(j), 'cam', j * S0_CAMERA_US,
                   'cam{}'.format(j - 1) if j else '',
                   'cam{}'.format(j + 1) if j < n_cams - 1 else '',
                   height=H, width=W)
        sweeps = list(sample_sweeps)
        for k, s in enumerate(sweeps):
            record('radar{}'.format(s), 'radar', s * S0_LIDAR_US, '', '')
            cam = int(round(s * S0_LIDAR_US / S0_CAMERA_US))
            self.tables['sample']['s{}'.format(k)] = dict(
                token='s{}'.format(k),
                prev='s{}'.format(k - 1) if k else '',
                next='s{}'.format(k + 1) if k < len(sweeps) - 1 else '',
                data={'LIDAR_TOP': 'lidar{}'.format(s),
                      'CAM_FRONT': 'cam{}'.format(cam),
                      'RADAR_FRONT': 'radar{}'.format(s)})
        self.scene = [{'token': 'scene0', 'first_sample_token': 's0',
                       'name': 'scene-0000'}]

    def get(self, table, token):
        return self.tables[table][token]

    def ego_x(self, token):
        sd = self.get('sample_data', token)
        return self.get('ego_pose', sd['ego_pose_token'])['translation'][0]

    def load_point_cloud(self, nusc, token, sensor='lidar'):
        """The devkit loader's contract, from the world's cache (a copy)."""
        if token not in self.world.cache:
            t_s = self.get('sample_data', token)['timestamp'] * 1e-6
            self.world.cache[token] = self.world.sensor_points(
                self.ego_x(token), t_s,
                'radar' if token.startswith('radar') else 'lidar')
        return self.world.cache[token].copy()

    def camera_frame(self, token):
        """(global -> camera rotation, camera origin) of a camera record."""
        rot = s0_rotation(S0_CAMERA['rotation'])
        origin = np.asarray(S0_CAMERA['translation']) + \
            np.array([self.ego_x(token), 0.0, 0.0])
        return rot, origin

    def mover_boxes_image_frame(self, nusc, camera_token):
        """Pixel boxes [min_x, min_y, max_x, max_y] of the movers in front
        of the camera with a corner in the frame (int() of the projected
        corners' extremes, as the devkit's view_points gives them)."""
        rot, origin = self.camera_frame(camera_token)
        k = np.asarray(S0_CAMERA['camera_intrinsic'])
        t_s = self.get('sample_data', camera_token)['timestamp'] * 1e-6
        out = []
        signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                          for sz in (-1, 1)], np.float64)
        for c, h, _ in self.world.boxes_at(t_s, movers_only=True):
            cam = (c + signs * h - origin) @ rot
            if (cam[:, 2] <= 0.1).any():
                continue
            px = cam @ k.T
            px = px[:, :2] / px[:, 2:3]
            inside = (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0) & \
                (px[:, 1] < H)
            if inside.any():
                out.append([int(px[:, 0].min()), int(px[:, 1].min()),
                            int(px[:, 0].max()), int(px[:, 1].max())])
        return np.asarray(out, np.int64).reshape(-1, 4)


def s0_write_panoptic(db, dirpath):
    """One boolean 900x1600 .npy a camera record: the movers' boxes."""
    from rcfd_tpu_torch.geometry import nuscenes_adapter as adapter

    os.makedirs(dirpath, exist_ok=True)
    for token in db.camera_tokens:
        np.save(os.path.join(dirpath, token + '.npy'), adapter.boxes_to_mask(
            db.mover_boxes_image_frame(None, token), H, W))
    return dirpath


@contextlib.contextmanager
def patched(module, values):
    """``module``'s attributes set to ``values``, as they were on exit."""
    saved = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def s0_fake(db, seconds=None):
    """The adapter's devkit readers and the scripts' DB seam on ``db``;
    with ``seconds``, the host's loads and masks add their wall time to
    seconds['host']."""
    from rcfd_tpu_torch.geometry import nuscenes_adapter as adapter
    from rcfd_tpu_torch.setup import setup_dataset_nuscenes as setup

    def timed(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if seconds is not None:
                    seconds['host'] = seconds.get('host', 0.0) + \
                        time.perf_counter() - t0
        return run

    stack = contextlib.ExitStack()
    stack.enter_context(patched(adapter, dict(
        load_point_cloud=timed(db.load_point_cloud),
        mover_boxes_image_frame=timed(db.mover_boxes_image_frame),
        boxes_to_mask=timed(adapter.boxes_to_mask),
        load_panoptic_mask=timed(adapter.load_panoptic_mask))))
    stack.enter_context(patched(setup, dict(_build_nusc=lambda d, v: db)))
    return stack


def s0_neighbors(db, sample_token, n_forward, n_backward, sensor,
                 camera_records=None):
    """The chain of a merge: (sensor token, camera token) of each neighbor
    in merge order; the keyframes (merge_point_clouds), or with
    ``camera_records`` the sweeps and their closest cameras
    (merge_lidar_sweeps_dense)."""
    from rcfd_tpu_torch.geometry import nuscenes_adapter as adapter

    sample = db.get('sample', sample_token)
    key = 'LIDAR_TOP' if sensor == 'lidar' else 'RADAR_FRONT'
    out = []
    for direction, n in (('next', n_forward), ('prev', n_backward)):
        if camera_records is None:
            out += [(nb['data'][key], nb['data']['CAM_FRONT']) for nb in
                    adapter._iterate_samples(db, sample, direction, n)]
            continue
        sd = db.get('sample_data', sample['data'][key])
        for _ in range(n):
            if sd[direction] == '':
                break
            sd = db.get('sample_data', sd[direction])
            out.append((sd['token'], adapter.closest_camera_token(
                camera_records, sd['timestamp'])))
    return out


def s0_chain_points(db, sample_token, neighbors, sensor, panoptic, boxes,
                    device):
    """Every point a merge computes on ``device``, as host (x, y, z, mask)
    arrays: the main frame's projection, then for each neighbor its own
    projection and its reprojection into the main camera. ``boxes``: the
    neighbors' movers fall back to the annotation boxes."""
    from rcfd_tpu_torch.geometry import nuscenes_adapter as adapter
    from rcfd_tpu_torch.geometry import reproject

    sample = db.get('sample', sample_token)
    key = 'LIDAR_TOP' if sensor == 'lidar' else 'RADAR_FRONT'
    main_cam = sample['data']['CAM_FRONT']
    main_k = adapter.get_camera_intrinsics(db, main_cam)

    def projected(token, cam):
        pts = adapter.load_point_cloud(db, token, sensor)
        xy, z, mask = adapter._project(db, pts, token, cam, 1.0, device)
        return xy[:, 0], xy[:, 1], z, mask

    steps = [('main', projected(sample['data'][key], main_cam))]
    for token, cam in neighbors:
        steps.append(('neighbor', projected(token, cam)))
        depth = adapter._rasterize(db, token, cam, sensor, 1.0, device)
        mask = adapter._mover_mask(db, cam, H, W, panoptic, boxes) \
            if sensor == 'lidar' else None
        steps.append(('reprojected', reproject.reprojected_points(
            depth, adapter.get_camera_intrinsics(db, cam),
            adapter.camera_to_camera_matrix(db, cam, main_cam), main_k, H,
            W, mask, 1.0, device)))
    return [(kind, tuple(t.cpu().numpy() for t in p)) for kind, p in steps]


# two computations of one coordinate that lie this close (relative to its
# magnitude, at least 1) are the same float32 products rounded otherwise
S0_TIE_REL = 1e-5


def s0_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) <= S0_TIE_REL * np.maximum(
        np.maximum(np.abs(a), np.abs(b)), 1.0)


def s0_pixels(x, y):
    def idx(c):
        c = np.nan_to_num(np.asarray(c, np.float64), nan=-1.0)
        return np.round(np.clip(c, -2.0 ** 30, 2.0 ** 30)).astype(np.int64)
    return idx(y) * W + idx(x)


def s0_unexplained(map_card, map_cpu, chains):
    """The pixels where the card's and the CPU's merged maps differ and no
    tie of the merge's points explains it. A point of a step is a tie when
    its two computations differ (pixel, mask or depth) and lie within
    S0_TIE_REL of each other; a reprojected point whose source pixel was
    set on one device only is explained when a tie of that neighbor's own
    projection lands on that source pixel. Returns (unexplained pixels,
    tie points, differing pixels)."""
    card = np.asarray(map_card).reshape(-1)
    cpu = np.asarray(map_cpu).reshape(-1)
    diff = np.nonzero(card != cpu)[0]
    covered, n_ties, bad = set(), 0, []
    source_ties = set()
    for (kind, a), (_, b) in zip(*chains):
        xa, ya, za, ma = a
        xb, yb, zb, mb = b
        pa, pb = s0_pixels(xa, ya), s0_pixels(xb, yb)
        differs = (ma != mb) | ((ma | mb) & ((pa != pb) | (za != zb)))
        close = s0_close(xa, xb) & s0_close(ya, yb) & s0_close(za, zb)
        if kind == 'reprojected':
            close |= np.isin(np.arange(len(xa)), list(source_ties))
        tie = differs & close
        n_ties += int(tie.sum())
        bad += [int(p) for p in pa[differs & ~close]]
        pixels = set(pa[tie & ma].tolist()) | set(pb[tie & mb].tolist())
        if kind == 'neighbor':
            source_ties = pixels
        else:
            covered |= pixels
    bad += [int(p) for p in diff if p not in covered]
    return bad, n_ties, len(diff)


def s0_map(xy, z):
    from rcfd_tpu_torch.setup.setup_dataset_nuscenes import ground_truth_map

    return ground_truth_map(xy, z, H, W)


def s0_read(path):
    from rcfd_tpu_torch.data import io as data_io

    return np.load(path) if path.endswith('.npy') else \
        data_io.load_depth_raw(path)


def s0_points_map(path):
    """A stream's file as an (H, W) float map (.npy rows at their
    pixels)."""
    if path.endswith('.npy'):
        rows = np.load(path)
        return s0_map(rows[:, :2].T, rows[:, 2])
    return s0_read(path).astype(np.float64)


def s0_card_vs_cpu_scene(db, paths_card, paths_cpu, root_card, root_cpu,
                         device):
    """Scene (a)'s files on the card against the CPU's: equal, or each
    differing pixel a tie of the merge that made it (recomputed on both
    devices). Returns the tie pixels."""
    tie_pixels = 0
    for k, sample_token in enumerate(sorted(
            db.tables['sample'], key=lambda s: int(s[1:]))):
        files = {name: (paths_card[name][k], paths_cpu[name][k])
                 for name in S0_STREAMS}
        for name, (p_card, p_cpu) in files.items():
            check(p_card.replace(root_card, root_cpu) == p_cpu,
                  'stage0 (a): paths differ: {} {}'.format(p_card, p_cpu))
            a, b = s0_read(p_card), s0_read(p_cpu)
            if a.shape == b.shape and np.array_equal(a, b):
                continue
            if name == 'ground_truth_interp':
                check(not np.array_equal(s0_read(files['ground_truth'][0]),
                                         s0_read(files['ground_truth'][1])),
                      'stage0 (a): the interpolated ground truth of keyframe '
                      '{} differs on the card and the CPU from the same '
                      'ground truth'.format(k))
                continue
            sensor = 'radar' if 'radar' in name else 'lidar'
            n = 0 if name in ('lidar', 'radar_points') else S0_FRAMES
            neighbors = s0_neighbors(db, sample_token, n, n, sensor)
            chains = [s0_chain_points(db, sample_token, neighbors, sensor,
                                      None, True, d)
                      for d in (device, 'cpu')]
            bad, ties, n_diff = s0_unexplained(
                s0_points_map(p_card), s0_points_map(p_cpu), chains)
            check(not bad, 'stage0 (a): keyframe {} {}: {} pixels differ on '
                  'the card and the CPU without a tie: {}'.format(
                      k, name, len(bad), bad[:10]))
            tie_pixels += n_diff
            log('stage0 (a): keyframe {} {}: {} pixels differ, each a tie '
                '({} tie points)'.format(k, name, n_diff, ties))
    return tie_pixels


def s0_process(script, db, root, n, panoptic, device, seconds):
    """``script``.process_scene over ``db``'s scene into ``root``: its
    paths, with the host's loads and masks timed apart."""
    with s0_fake(db, seconds):
        return script.process_scene(
            (0, '/data/nuscenes', 'v1.0-trainval', root, n, n, False,
             panoptic), device=device, seconds=seconds)[1]


def s0_keyframe_line(label, seconds, n_keyframes, wall):
    """ms a keyframe: the merges less the host's loads and masks (the
    device's merge and its launches), the host's loads and masks,
    interpolate_depth, the PNG and .npy writes."""
    per = lambda s: 1e3 * s / n_keyframes
    merge = seconds.get('merge', 0.0) - seconds.get('host', 0.0)
    log('stage0 {}: ms a keyframe: merge on the device {:.2f}, host loads '
        'and masks {:.2f}, interpolate_depth {:.2f}, PNG and .npy writes '
        '{:.2f}; wall {:.2f} ({} keyframes); {}'.format(
            label, per(merge), per(seconds.get('host', 0.0)),
            per(seconds.get('interpolate', 0.0)),
            per(seconds.get('write', 0.0)), per(wall), n_keyframes,
            gpu_name_and_power()))
    return dict(merge_ms=per(merge), host_ms=per(seconds.get('host', 0.0)),
                interpolate_ms=per(seconds.get('interpolate', 0.0)),
                write_ms=per(seconds.get('write', 0.0)), wall_ms=per(wall))


def s0_merge_device_ms(db, device):
    """Device ms of one 900x1600 merge_neighbor_into_main (median of 20),
    on keyframe 9 of scene (b) and its next keyframe, with both mover
    masks on the device."""
    from rcfd_tpu_torch.geometry import nuscenes_adapter as adapter
    from rcfd_tpu_torch.geometry.reproject import merge_neighbor_into_main

    sample = db.get('sample', 's9')
    nb = db.get('sample', sample['next'])
    cams = sample['data']['CAM_FRONT'], nb['data']['CAM_FRONT']
    with s0_fake(db):
        main = adapter._rasterize(db, sample['data']['LIDAR_TOP'], cams[0],
                                  'lidar', 1.0, device)
        neighbor = adapter._rasterize(db, nb['data']['LIDAR_TOP'], cams[1],
                                      'lidar', 1.0, device)
        masks = [torch.from_numpy(adapter.boxes_to_mask(
            db.mover_boxes_image_frame(db, c), H, W)).to(device)
            for c in cams]
        k = adapter.get_camera_intrinsics(db, cams[0])
        m = adapter.camera_to_camera_matrix(db, cams[1], cams[0])
    return device_ms(lambda: merge_neighbor_into_main(
        main, neighbor, k, m, k, masks[1], masks[0], device=device), 20)


def s0_raw_requests(db, device, rng):
    """From_raw_radar requests from keyframe 9 of scene (b): a seeded
    900x1600 frame, its 125 RADAR_FRONT returns in the radar frame (all
    valid), the radar -> camera matrix and CAM_FRONT's K."""
    from rcfd_tpu_torch.geometry import nuscenes_adapter as adapter

    sample = db.get('sample', 's9')
    radar, cam = sample['data']['RADAR_FRONT'], sample['data']['CAM_FRONT']
    pts = db.load_point_cloud(db, radar, 'radar')
    m = adapter.sensor_to_camera_matrix(db, radar, cam)
    k = adapter.get_camera_intrinsics(db, cam)
    return [(rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8), pts,
             np.ones(len(pts), bool), m, k)
            for _ in range(S0_RAW_REQUESTS + 1)]


def s0_from_raw_radar(device, record, name, pipe, reqs):
    """(d) on one scatter route: a warm-up request, then the counted ones
    with every launch count set to 0 just before and read just after;
    each equals __call__ on the points the card's projection gives, bit
    for bit, and K1 equals its plain version on that path's crops. Returns
    (ms a frame, launches)."""
    from rcfd_tpu_torch.geometry import project_points_to_image
    from rcfd_tpu_torch.ops import scatter_cuda as sc
    from rcfd_tpu_torch.pipeline import serving_numerics

    pipe.from_raw_radar(*reqs[0])
    torch.cuda.synchronize()
    reset_launches()
    outs, times = [], []
    for req in reqs[1:]:
        t0 = time.perf_counter()
        outs.append(pipe.from_raw_radar(*req))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    expect = {'scatter_quasi_dense': len(outs)} if pipe.pallas_scatter \
        else {}
    for kernel, n in launches.items():
        check(n == expect.get(kernel, 0), 'stage0 (d) {}: {} launched {} '
              'times for {} requests, expected {}'.format(
                  name, kernel, n, len(outs), expect.get(kernel, 0)))
    image, pts, valid, m, k = reqs[1]
    xy, z, mask = project_points_to_image(pts, m, k, H, W, device=device)
    use = torch.from_numpy(valid).to(device) & mask
    points = torch.where(use[:, None], torch.stack(
        [torch.round(xy[:, 0]), torch.round(xy[:, 1]), z], -1),
        torch.zeros((), device=device))
    check(int(use.sum()) >= len(pts) // 4, 'stage0 (d): only {} of the {} '
          'returns land in the frame'.format(int(use.sum()), len(pts)))
    pre = pipe(image, points, use)
    check(all(torch.equal(a, b) for a, b in zip(outs[0], pre)),
          'stage0 (d) {}: from_raw_radar differs from __call__ on the '
          'points the card projects'.format(name))
    with torch.inference_mode(), serving_numerics():
        _, crops, xs, zs = pipe.radarnet_stage(image, points)
        args = (crops, xs, zs, use, H, W,
                pipe.radarnet.input_patch_size_image)
        got = sc.scatter_quasi_dense(*args)
        plain = sc.scatter_quasi_dense_plain(*args)
    err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    check(all(torch.equal(a, b) for a, b in zip(got, plain)),
          'stage0 (d) {}: K1 differs from its plain version on the path\'s '
          'crops: max abs err {}'.format(name, err))
    entry = record['scatter_quasi_dense']
    entry['max_abs_err'] = max(entry['max_abs_err'], err)
    dense, quasi, response = outs[0]
    check(bool(torch.isfinite(dense).all()) and
          float(dense.min()) >= 1.0 and float(dense.max()) <= 100.0 and
          int((response > 0).sum()) > 0,
          'stage0 (d) {}: outputs out of range or an empty map'.format(name))
    ms = float(np.median(times))
    log('stage0 (d) {}: from_raw_radar at {}x{}, {} returns ({} in the '
        'frame): ms a frame {} (median {:.2f}); == __call__ on the card\'s '
        'projected points, bit for bit; K1 == its plain version on the '
        'crops, bit for bit (tolerance 0); launches {}; {}'.format(
            name, H, W, len(pts), int(use.sum()),
            ', '.join('{:.2f}'.format(t) for t in times), ms,
            {k_: n for k_, n in launches.items() if n},
            gpu_name_and_power()))
    return ms, launches


def phase_stage0(device, record, slice_pipe, tmp):
    """Stage 0 on the card over fake nuScenes scenes at the real sizes
    (StageZeroDB): (a) setup_dataset_nuscenes.process_scene over 3
    keyframes at +-9, then again on the CPU, file for file; (b)
    merge_point_clouds of the middle keyframe of 19 at +-9 (lidar with
    boxes, radar), and again with TF32 on; (c)
    setup_dataset_nuscenes_with_denseGT.process_scene at +-80 over 2
    keyframes inside a chain of 171 sweeps with panoptic masks, and the
    first keyframe's merge at +-8 on the card and the CPU; (d)
    TwoStagePipeline.from_raw_radar on (b)'s radar returns and rig with
    K1 (the slice's RadarNet) and with the exact max."""
    from rcfd_tpu_torch.geometry import nuscenes_adapter as adapter
    from rcfd_tpu_torch.setup import setup_dataset_nuscenes as setup
    from rcfd_tpu_torch.setup import setup_dataset_nuscenes_with_denseGT \
        as dense

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    world = StageZeroWorld(np.random.default_rng(SEED + 70))
    dbs = {name: StageZeroDB(world, *S0_SCENES[name])
           for name in S0_SCENES}
    for name, db in dbs.items():
        for token in db.tables['sample_data']:
            if token.startswith(('lidar', 'radar')):
                db.load_point_cloud(db, token)
    panoptic = s0_write_panoptic(dbs['c'], os.path.join(tmp, 'panoptic'))
    sizes = {len(world.cache[t]) for t in world.cache
             if t.startswith('lidar')}
    check(sizes == {S0_BEAMS * S0_AZIMUTHS}, 'stage0: sweeps of {} points'
          .format(sizes))
    log('stage0: the fake scenes: {} lidar sweeps of {} points, {} radar '
        'records of {} returns, {} camera records with panoptic masks, cast '
        'and written in {:.2f} s (host, before any timing)'.format(
            sum(t.startswith('lidar') for t in world.cache),
            S0_BEAMS * S0_AZIMUTHS,
            sum(t.startswith('radar') for t in world.cache),
            S0_RADAR_RETURNS, len(dbs['c'].camera_tokens),
            time.perf_counter() - t0))
    numbers = {}

    # (a) the main script's scene walk at its defaults, then on the CPU
    db = dbs['a']
    roots = [os.path.join(tmp, 'a_' + d) for d in ('card', 'cpu')]
    seconds = {}
    t1 = time.perf_counter()
    paths = s0_process(setup, db, roots[0], S0_FRAMES, None, device,
                       seconds)
    numbers['a'] = s0_keyframe_line('(a) setup_dataset_nuscenes +-9',
                                    seconds, 3, time.perf_counter() - t1)
    gt = s0_read(paths['ground_truth'][1])
    check(len(paths['image']) == 3 and (gt > 0).sum() > 10000,
          'stage0 (a): {} keyframes, {} ground-truth pixels'.format(
              len(paths['image']), int((gt > 0).sum())))
    t1 = time.perf_counter()
    paths_cpu = s0_process(setup, db, roots[1], S0_FRAMES, None, 'cpu', {})
    cpu_s = time.perf_counter() - t1
    with s0_fake(db):
        ties_a = s0_card_vs_cpu_scene(db, paths, paths_cpu, roots[0],
                                      roots[1], device)
    log('stage0 (a): card == CPU in every file of the 3 keyframes ({} '
        'streams) except {} tie pixels; the CPU run took {:.2f} s'.format(
            len(S0_STREAMS), ties_a, cpu_s))

    # (b) the merges of the middle keyframe of 19 at +-9
    db = dbs['b']
    with s0_fake(db):
        merged = {}
        for sensor in ('lidar', 'radar'):
            t1 = time.perf_counter()
            merged[sensor] = adapter.merge_point_clouds(
                db, 's9', S0_FRAMES, S0_FRAMES, sensor, device=device)
            numbers['b_' + sensor + '_ms'] = \
                (time.perf_counter() - t1) * 1e3
        b, m = torch.backends.cudnn, torch.backends.cuda.matmul
        saved = (b.allow_tf32, m.allow_tf32)
        b.allow_tf32 = m.allow_tf32 = True
        try:
            tf32 = adapter.merge_point_clouds(db, 's9', S0_FRAMES,
                                              S0_FRAMES, 'lidar',
                                              device=device)
        finally:
            b.allow_tf32, m.allow_tf32 = saved
    check(all(np.array_equal(x, y) for x, y in zip(tf32, merged['lidar'])),
          'stage0 (b): the lidar merge moves under TF32')
    check(merged['lidar'][1].size > 3 * merged['radar'][1].size > 0,
          'stage0 (b): {} lidar and {} radar points merged'.format(
              merged['lidar'][1].size, merged['radar'][1].size))
    numbers['merge_device_ms'] = s0_merge_device_ms(db, device)
    log('stage0 (b): merge_point_clouds of keyframe 9 of 19 at +-9: lidar '
        '(boxes) {} points in {:.2f} ms, radar {} points in {:.2f} ms (host '
        'clock, to the points on the host); the same lidar merge with TF32 '
        'on: equal, bit for bit; one 900x1600 merge_neighbor_into_main: '
        '{:.4f} device ms (median of 20); {}'.format(
            merged['lidar'][1].size, numbers['b_lidar_ms'],
            merged['radar'][1].size, numbers['b_radar_ms'],
            numbers['merge_device_ms'], gpu_name_and_power()))

    # (c) the dense-GT script at bash/setup_dataset_nuscenes.sh's +-80
    db = dbs['c']
    seconds = {}
    t1 = time.perf_counter()
    paths = s0_process(dense, db, os.path.join(tmp, 'c_card'),
                       S0_DENSE_FRAMES, panoptic, device, seconds)
    numbers['c'] = s0_keyframe_line(
        '(c) setup_dataset_nuscenes_with_denseGT +-80', seconds, 2,
        time.perf_counter() - t1)
    gt_c = s0_read(paths['ground_truth'][0])
    check((gt_c > 0).sum() > 3 * (gt > 0).sum(),
          'stage0 (c): the dense ground truth ({} pixels) is not denser than '
          '(a)\'s ({})'.format(int((gt_c > 0).sum()), int((gt > 0).sum())))
    records = adapter.scene_camera_records(db, db.scene[0])
    with s0_fake(db):
        got = [adapter.merge_lidar_sweeps_dense(
            db, 's0', S0_CPU_DENSE_FRAMES, S0_CPU_DENSE_FRAMES, records,
            panoptic, device=d) for d in (device, 'cpu')]
        ties_c = 0
        if not all(np.array_equal(x, y) for x, y in zip(*got)):
            neighbors = s0_neighbors(db, 's0', S0_CPU_DENSE_FRAMES,
                                     S0_CPU_DENSE_FRAMES, 'lidar', records)
            chains = [s0_chain_points(db, 's0', neighbors, 'lidar',
                                      panoptic, False, d)
                      for d in (device, 'cpu')]
            bad, _, ties_c = s0_unexplained(s0_map(*got[0]),
                                            s0_map(*got[1]), chains)
            check(not bad, 'stage0 (c): the +-8 merge differs on the card '
                  'and the CPU without a tie at {} pixels'.format(len(bad)))
    log('stage0 (c): keyframe 0 at +-{} sweeps, card == CPU except {} tie '
        'pixels; dense ground truth {} pixels against (a)\'s {}'.format(
            S0_CPU_DENSE_FRAMES, ties_c, int((gt_c > 0).sum()),
            int((gt > 0).sum())))

    # (d) from_raw_radar on both scatter routes
    from rcfd_tpu_torch.pipeline import TwoStagePipeline

    reqs = s0_raw_requests(dbs['b'], device, np.random.default_rng(SEED + 71))
    exact_pipe = TwoStagePipeline(
        radarnet_like(slice_pipe.radarnet, device, pallas_scatter=None),
        slice_pipe.fusionnet, H, W, device=device)
    ms_k1, launches = s0_from_raw_radar(device, record, 'K1', slice_pipe,
                                        reqs)
    count_launches(record, 'stage0 from_raw_radar', launches,
                   ['scatter_quasi_dense'])
    ms_exact, _ = s0_from_raw_radar(device, record, 'exact', exact_pipe,
                                    reqs)
    peak = torch.cuda.max_memory_allocated(device)
    log('stage0: (a) {:.2f} and (c) {:.2f} ms a keyframe (wall), one '
        '900x1600 merge {:.4f} device ms, from_raw_radar {:.2f} (K1) and '
        '{:.2f} (exact) ms a frame, tie pixels card vs CPU {} (a) and {} '
        '(c); peak memory {} bytes; {}'.format(
            numbers['a']['wall_ms'], numbers['c']['wall_ms'],
            numbers['merge_device_ms'], ms_k1, ms_exact, ties_a, ties_c,
            peak, gpu_name_and_power()))


# the legacy v0 pipeline (phase legacy): (a) data_gen over 2 keyframes of
# a StageZeroDB scene at the train split's +-9 (the walk starts at keyframe
# 9 of 11, so keyframe 9 merges 9 back and 1 ahead, keyframe 10 9 back);
# (b) train_legacy_v0 at its defaults on 30 records of the run phase's 8
# frames; (c) save_depth_radar with bash/train_nuscenes.sh's flags, 2
# steps; (d) save_stage_1_depth and eval_stage_1_depth; (e) card vs CPU;
# (f) the general ROI pool
LEGACY_SCRIPT = os.path.join('bash', 'train_nuscenes.sh')
LEGACY_KEYFRAMES = (range(0, 101, 10), 101)
LEGACY_WALK_FROM = 's9'
LEGACY_FRAMES = 9
LEGACY_TRAIN_RECORDS = 30
LEGACY_VAL_FRAMES = 2
LEGACY_STAGE1_FRAMES = 4
LEGACY_K = 128
LEGACY_DRS_TRAIN = 64
LEGACY_DRS_SCHEDULE = (['--learning_rates', '5e-5', '1e-4'],
                       ['--learning_schedule', '1', '2'])
LEGACY_NARROW = ((64, 32), (64, 60))
LEGACY_NARROW_FRAME = (64, 96)
# a narrow step's gradients card vs CPU: each device's largest error from
# the CPU's float64 step as a share of its largest gradient, a limit a
# patch. 64x60 at the other trainings' 1e-3. 64x32 at 2e-2: there the
# CPU's float32 step is itself 1.9e-3 off (at 64x60 3.4e-5), as the
# deepest stage's batch norms normalize 8 values a channel and the radar
# branch's BatchNorm1d 4 a feature (the JAX formula, E[x^2] - mean^2), so
# float32 rounding is amplified some 10^4-fold whatever the device. The
# card's float64 step is held to the CPU's at LEGACY_FLOAT64_TOL at both
# patches, so a fault of the card's arithmetic shows at 64x32 all the same;
# the card's float32 step under deterministic cuDNN algorithms is printed
LEGACY_GRAD_TOL = {(64, 32): 2e-2, (64, 60): 1e-3}
LEGACY_FLOAT64_TOL = 1e-9
LEGACY_ROI = dict(channels=64, boxes=64, output_size=(7, 7), scale=1 / 8.)


def legacy_inputs(paths, tmp):
    """The v0 inputs over the run phase's frames: an image directory of
    links named by each frame's ground truth (the v0 datasets find the
    image by the ground truth's basename), the pickled path lists of
    training (30 records over the 8 frames), validation (the last 2),
    stage 1 (the first 4) and stage 1's warm-up (the first), and the
    Data_Struct manifests of save_depth_radar (64 train records with radar
    paths, 2 val records with radar arrays, each label path a real
    ground-truth file)."""
    from rcfd_tpu_torch.data.legacy_datasets import save_pickle_paths

    image_dir = os.path.join(tmp, 'legacy_images')
    os.makedirs(image_dir, exist_ok=True)
    for image, gt in zip(paths['image'], paths['ground_truth']):
        os.symlink(image, os.path.join(image_dir, os.path.basename(gt)))
    gt, radar = paths['ground_truth'], paths['radar']
    n = len(gt)
    lists = {
        'gt_train': [gt[i % n] for i in range(LEGACY_TRAIN_RECORDS)],
        'radar_train': [radar[i % n] for i in range(LEGACY_TRAIN_RECORDS)],
        'gt_val': gt[-LEGACY_VAL_FRAMES:],
        'radar_val': radar[-LEGACY_VAL_FRAMES:],
        'gt_stage1': gt[:LEGACY_STAGE1_FRAMES],
        'radar_stage1': radar[:LEGACY_STAGE1_FRAMES],
        'gt_warm': gt[:1], 'radar_warm': radar[:1]}
    out = dict(image_dir=image_dir)
    for name, plist in lists.items():
        out[name] = os.path.join(tmp, 'legacy_{}.pkl'.format(name))
        save_pickle_paths(out[name], plist)
    train = {(0, i): [(0, i, paths['image'][i % n], radar[i % n], gt[i % n],
                       gt[i % n])] for i in range(LEGACY_DRS_TRAIN)}
    val = {(0, i): [(0, i, paths['image'][i], np.zeros((4, 2)),
                     np.load(radar[i]), gt[i], gt[i])]
           for i in range(n - LEGACY_VAL_FRAMES, n)}
    for name, manifest in (('drs_train', train), ('drs_val', val)):
        out[name] = os.path.join(tmp, 'legacy_{}.pkl'.format(name))
        with open(out[name], 'wb') as f:
            pickle.dump(manifest, f)
    return out


def legacy_data_gen(device, tmp):
    """(a) data_gen.process_scene over the last 2 keyframes of an 11-keyframe
    StageZeroDB scene at the train split's +-9, on the card, then on the
    CPU: the records and every file equal (the ground truth's and labels'
    samples, the .npy). Returns the ms-a-keyframe numbers."""
    from rcfd_tpu_torch import native
    from rcfd_tpu_torch.setup import data_gen

    world = StageZeroWorld(np.random.default_rng(SEED + 80))
    db = StageZeroDB(world, *LEGACY_KEYFRAMES)
    db.scene = [dict(db.scene[0], first_sample_token=LEGACY_WALK_FROM)]
    for token in db.tables['sample_data']:
        if token.startswith(('lidar', 'radar')) and \
                int(token.lstrip('lidarar')) % S0_KEYFRAME_SWEEPS == 0:
            db.load_point_cloud(db, token)
    runs = {}
    for side, dev in (('card', device), ('cpu', 'cpu')):
        seconds = {}
        root = os.path.join(tmp, 'data_gen_' + side)
        t0 = time.perf_counter()
        with s0_fake(db, seconds), patched(data_gen, dict(
                _build_nusc=lambda d, v: db)):
            records = data_gen.process_scene(
                (0, '/data/nuscenes', 'v1.0-trainval', root, 'train',
                 LEGACY_FRAMES, 4, 0.4, 0.6), device=dev, seconds=seconds)
        if dev != 'cpu':
            torch.cuda.synchronize(device)
        runs[side] = (records, root, seconds, time.perf_counter() - t0)
    (records, root, seconds, wall), (records_c, root_c, _, wall_c) = \
        runs['card'], runs['cpu']
    check(sorted(records) == sorted(records_c) and len(records) == 2,
          'legacy (a): records {} on the card, {} on the CPU'.format(
              sorted(records), sorted(records_c)))
    n_labels = 0
    for key in records:
        (a,), (b,) = records[key], records_c[key]
        check(tuple(str(v).replace(root, root_c) for v in a) ==
              tuple(str(v) for v in b), 'legacy (a): records differ: {} {}'
              .format(a, b))
        radar, radar_c = np.load(a.radar_points_path), np.load(
            b.radar_points_path)
        check(np.array_equal(radar, radar_c), 'legacy (a): {} differs'.format(
            a.radar_points_path))
        check(np.array_equal(
            native.read_png(a.ground_truth_depth_path).samples,
            native.read_png(b.ground_truth_depth_path).samples),
            'legacy (a): the ground truth {} differs'.format(
                a.ground_truth_depth_path))
        for p in range(radar.shape[0]):
            la = native.read_png(a.ground_truth_label_path.format(p))
            lb = native.read_png(b.ground_truth_label_path.format(p))
            check((la.color_type, la.bit_depth) == (0, 8) and
                  np.array_equal(la.samples, lb.samples) and
                  (la.samples == 1).any(),
                  'legacy (a): label {} of {} differs'.format(p, key))
            n_labels += 1
    per = {k: 1e3 * seconds.get(k, 0.0) / 2 for k in
           ('merge', 'host', 'register', 'labels', 'write')}
    per['merge'] -= per['host']
    per['wall'] = 1e3 * wall / 2
    log('legacy (a): data_gen.process_scene, 2 keyframes at +-{} (9 back): '
        '{} matched radar points, one label PNG each; ms a keyframe: merges '
        'on the device {:.2f}, host loads and masks {:.2f}, registration '
        '{:.2f}, labels {:.2f}, writes {:.2f}; wall {:.2f} (the CPU run '
        '{:.2f}); card == CPU in every file; {}'.format(
            LEGACY_FRAMES, n_labels, per['merge'], per['host'],
            per['register'], per['labels'], per['write'], per['wall'],
            1e3 * wall_c / 2, gpu_name_and_power()))
    check(n_labels > 0, 'legacy (a): no radar point was matched')
    return per


def legacy_train_numbers(name, timings, batch, peak, seconds):
    """ms a step (median of steps 3-10), samples/s, the loader's wait and
    validation ms a frame of a training run."""
    steps = [t for t in timings if t['step'] in TIMED_STEPS]
    step_ms = float(np.median([t['step_ms'] for t in steps]))
    wait_ms = float(np.median([t['wait_ms'] for t in steps]))
    n_val = len(seconds['validations'])
    val_ms = 1e3 * seconds['serve'] / max(seconds.get('frames', 0), 1)
    later_ms = 1e3 * sum(seconds['validations'][1:]) / max(
        seconds['frames'] * (n_val - 1) / n_val, 1)
    check(all(np.isfinite(t['loss']) for t in timings),
          '{}: a loss is not finite'.format(name))
    log('{}: {:.2f} ms a step (median of steps {}-{}), {:.2f} samples/s '
        '(batch {} over step + wait), loader wait {:.2f} ms, validation '
        '{:.2f} ms a frame over {} validations of {} frames (K = {}; the '
        'first with cuDNN\'s autotuning, the later ones {:.2f}), peak memory '
        '{} bytes; {}'.format(
            name, step_ms, steps[0]['step'], steps[-1]['step'],
            1e3 * batch / (step_ms + wait_ms), batch, wait_ms, val_ms, n_val,
            seconds['frames'] // n_val, LEGACY_K, later_ms, peak,
            gpu_name_and_power()))
    return dict(step_ms=step_ms, wait_ms=wait_ms, val_ms=val_ms,
                later_val_ms=later_ms, peak=peak,
                samples_per_s=1e3 * batch / (step_ms + wait_ms))


def legacy_check_checkpoint(path, step):
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    check(sorted(ckpt) == ['model_state_dict', 'optimizer_state_dict',
                           'train_step'] and ckpt['train_step'] == step and
          ckpt['optimizer_state_dict'] == {},
          'legacy: {} is no v0 checkpoint at step {}'.format(path, step))


def legacy_train(device, inputs, tmp):
    """(b) python -m rcfd_tpu_torch.train_legacy_v0 at its defaults (batch
    6, 900x288 crops) for 10 steps in 2 epochs, a checkpoint and a
    validation (2 frames, K = 128) every 5 steps, then resumed from
    model-10.pth for one epoch."""
    from rcfd_tpu_torch import train_legacy_v0

    out = os.path.join(tmp, 'legacy_train')
    argv = ['--path_to_pickle_file_gt_train_paths', inputs['gt_train'],
            '--path_to_pickle_file_radar_train_numpys',
            inputs['radar_train'],
            '--path_to_pickle_file_gt_val_paths', inputs['gt_val'],
            '--path_to_pickle_file_radar_val_numpys', inputs['radar_val'],
            '--image_path', inputs['image_dir'], '--checkpoint_dirpath', out,
            '--learning_schedule', '2', '--num_step_per_checkpoint', '5',
            '--num_step_per_summary', '5', '--start_step_validation', '5',
            '--max_points_inference', str(LEGACY_K)]
    torch.cuda.reset_peak_memory_stats(device)
    timings, seconds = [], {}
    train_legacy_v0.main(argv, timings=timings, seconds=seconds)
    numbers = legacy_train_numbers(
        'legacy (b) train_legacy_v0 defaults', timings, 6,
        torch.cuda.max_memory_allocated(device), seconds)
    check([t['step'] for t in timings] == list(range(1, 11)),
          'legacy (b): steps {}'.format([t['step'] for t in timings]))
    for step in (5, 10):
        legacy_check_checkpoint(os.path.join(out, 'model-{}.pth'.format(
            step)), step)
    with open(os.path.join(out, 'results.txt')) as f:
        check(f.read().count('Legacy validation step') == 3,
              'legacy (b): not 3 validations')
    resumed = []
    argv[argv.index('--learning_schedule') + 1] = '3'
    train_legacy_v0.main(argv + ['--restore_path', os.path.join(
        out, 'model-10.pth')], timings=resumed)
    check([t['step'] for t in resumed] == list(range(11, 16)),
          'legacy (b): the resumed run took steps {}'.format(
              [t['step'] for t in resumed]))
    legacy_check_checkpoint(os.path.join(out, 'model-15.pth'), 15)
    log('legacy (b): resumed from model-10.pth: steps 11-15, median {:.2f} '
        'ms a step'.format(float(np.median([t['step_ms'] for t in
                                            resumed[2:]]))))
    return os.path.join(out, 'model-10.pth'), numbers


def legacy_save_depth_radar(device, inputs, tmp):
    """(c) python -m rcfd_tpu_torch.save_depth_radar with
    bash/train_nuscenes.sh's flags (batch 64, 900x60 crops, smoothness
    1e-7 at 11x3, a checkpoint and a validation every step), its schedule
    cut to its first 2 epochs (1 step each: 64 records)."""
    from rcfd_tpu_torch import save_depth_radar

    flags = script_flags(LEGACY_SCRIPT)
    flags['--path_to_pickle_file_train'] = [inputs['drs_train']]
    flags['--path_to_pickle_file_val'] = [inputs['drs_val']]
    flags['--image_path'] = [inputs['image_dir']]
    flags['--checkpoint_dirpath'] = [os.path.join(tmp, 'legacy_drs')]
    for flag in LEGACY_DRS_SCHEDULE:
        flags[flag[0]] = flag[1:]
    argv = [t for k, v in flags.items() for t in [k] + v]
    torch.cuda.reset_peak_memory_stats(device)
    timings, seconds = [], {}
    save_depth_radar.main(argv, timings=timings, seconds=seconds)
    peak = torch.cuda.max_memory_allocated(device)
    check([t['step'] for t in timings] == [1, 2] and
          all(np.isfinite(t['loss']) for t in timings),
          'legacy (c): steps {}'.format(timings))
    for step in (1, 2):
        legacy_check_checkpoint(os.path.join(
            flags['--checkpoint_dirpath'][0], 'model-{}.pth'.format(step)),
            step)
    val_ms = 1e3 * seconds['serve'] / seconds['frames']
    log('legacy (c) save_depth_radar with {}\'s flags (batch {}, 900x60, '
        '{} workers): steps {:.2f} and {:.2f} ms (the first with cuDNN\'s '
        'autotuning), loader wait {:.2f} and {:.2f} ms, {:.2f} samples/s '
        'at step 2, validation {:.2f} ms a frame ({} frames, K = {}), peak '
        'memory {} bytes; {}'.format(
            LEGACY_SCRIPT, flags['--batch_size'][0],
            flags['--num_workers'][0], timings[0]['step_ms'],
            timings[1]['step_ms'], timings[0]['wait_ms'],
            timings[1]['wait_ms'], 1e3 * LEGACY_DRS_TRAIN /
            (timings[1]['step_ms'] + timings[1]['wait_ms']), val_ms,
            seconds['frames'], LEGACY_K, peak, gpu_name_and_power()))
    return dict(step_ms=timings[1]['step_ms'], wait_ms=timings[1]['wait_ms'],
                val_ms=val_ms, peak=peak)


def legacy_stage_1(device, inputs, checkpoint, tmp):
    """(d) python -m rcfd_tpu_torch.save_stage_1_depth from (b)'s
    checkpoint over 4 frames at K = 128, after a warm-up run over the first
    of them, then eval_stage_1_depth on its outputs, held to a numpy
    recount of the metrics."""
    from rcfd_tpu_torch import eval_stage_1_depth, save_stage_1_depth
    from rcfd_tpu_torch.data import io
    from rcfd_tpu_torch.data.legacy_datasets import load_pickle_paths

    out = os.path.join(tmp, 'legacy_stage1')
    manifests = [os.path.join(tmp, n) for n in ('legacy_out.pkl',
                                                'legacy_resp.pkl')]

    def argv(frames, out):
        return ['--restore_path', checkpoint,
                '--path_to_pickle_file_gt_paths', inputs['gt_' + frames],
                '--path_to_pickle_file_radar_numpy_paths',
                inputs['radar_' + frames], '--image_dirpath',
                inputs['image_dir'], '--output_dirpath', out,
                '--max_points_inference', str(LEGACY_K),
                '--file_to_save_radar_output_paths', manifests[0],
                '--file_to_save_radar_response_paths', manifests[1]]

    save_stage_1_depth.main(argv('warm', out + '_warm'))  # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    seconds = {}
    t0 = time.perf_counter()
    depth_paths, _ = save_stage_1_depth.main(argv('stage1', out),
                                             seconds=seconds)
    wall = time.perf_counter() - t0
    n = len(depth_paths)
    check(n == LEGACY_STAGE1_FRAMES and
          load_pickle_paths(manifests[0]) == depth_paths,
          'legacy (d): {} outputs'.format(n))
    got = eval_stage_1_depth.main(
        ['--path_to_pickle_file_output_paths', manifests[0],
         '--path_to_pickle_file_gt_paths', inputs['gt_stage1']])
    errors = []
    for dp, gp in zip(depth_paths, load_pickle_paths(inputs['gt_stage1'])):
        o, g = io.load_depth(dp), io.load_depth(gp)
        m = (o > 0) & (g > 0.0) & (g < 100.0)
        o, g = 1000.0 * o[m], 1000.0 * g[m]
        errors.append([np.mean(np.abs(g - o)), np.sqrt(np.mean((g - o) ** 2)),
                       np.mean(np.abs(1e6 / g - 1e6 / o)),
                       np.sqrt(np.mean((1e6 / g - 1e6 / o) ** 2))])
    ref = np.nanmean(np.asarray(errors), 0)
    check(all(np.isfinite(v) for v in got.values()) and np.allclose(
        [got[k] for k in ('mae', 'rmse', 'imae', 'irmse')], ref,
        rtol=1e-5), 'legacy (d): eval_stage_1_depth {} against numpy {}'
        .format(got, ref))
    per = {k: 1e3 * v / n for k, v in seconds.items()}
    log('legacy (d) save_stage_1_depth: ms a frame (K = {}): read {:.2f}, '
        'serve {:.2f}, write {:.2f}; wall {:.2f}; peak memory {} bytes; '
        'eval_stage_1_depth {} == numpy; {}'.format(
            LEGACY_K, per['read'], per['serve'], per['write'],
            1e3 * wall / n, torch.cuda.max_memory_allocated(device), got,
            gpu_name_and_power()))
    return dict(per, wall=1e3 * wall / n)


def legacy_narrow_step(device, patch, seed):
    """One train step of the v0 FusionNet at a narrow patch from the same
    weights and batch (4 frames of 64x96, augmentation off): on the card,
    on the card under deterministic cuDNN algorithms (benchmark off), on
    the CPU, and in float64 on the card and on the CPU. Returns the
    losses' relative error card vs CPU, and each run's largest gradient
    error from the CPU's float64 step as a share of its largest gradient
    (and the parameter it is on)."""
    from rcfd_tpu_torch import legacy_main
    from rcfd_tpu_torch.data import transport
    from rcfd_tpu_torch.data.transforms import Transforms

    cpu = legacy_main.build_model(patch, 'cpu', seed)
    rng = np.random.default_rng(seed)
    h, w = LEGACY_NARROW_FRAME
    point = np.stack([[0.0, w - 1.0, 40.5, 70.0], rng.random(4) * h,
                      rng.random(4) * 40 + 10], 1).astype(np.float32)
    gt = point[:, 2, None, None, None] + rng.uniform(-0.8, 0.8,
                                                     (4, h, w, 1))
    gt[rng.random(gt.shape) < 0.4] = 0.0
    batch = (torch.from_numpy(rng.integers(0, 256, (4, h, w, 3),
                                           dtype=np.uint8)),
             torch.from_numpy(point),
             torch.from_numpy(np.floor(gt * 256).astype(np.uint16)))
    double = tuple(t.double() for t in transport.decode(batch))
    runs = [('cpu', 'cpu', False, False), ('card', device, False, False),
            ('card deterministic', device, False, True),
            ('float64', 'cpu', True, False),
            ('card float64', device, True, False)]
    out = {}
    for name, dev, in_float64, deterministic in runs:
        model = copy.deepcopy(cpu).to(dev)
        inputs = tuple(t.to(dev) for t in (double if in_float64 else batch))
        if in_float64:
            model = model.double()
        step = legacy_main.TrainStep(
            model, Transforms(normalized_image_range=[0, 1]),
            legacy_main.make_optimizer(model, 1e-3, 0.0), patch, 0.4, False,
            1.0, 1e-2, 2.0, (11, 3))
        with legacy_main.training_numerics():
            if deterministic:
                torch.backends.cudnn.deterministic = True
                torch.backends.cudnn.benchmark = False
            info = step.backward(inputs, {})
        out[name] = (float(info['loss']), {
            n: p.grad.cpu().double() for n, p in model.named_parameters()
            if p.grad is not None})
    truth = out['float64'][1]
    largest = max(float(g.abs().max()) for g in truth.values())
    err, worst = {}, {}
    for k in ('card', 'card deterministic', 'cpu', 'card float64'):
        by_name = {n: float((out[k][1][n] - g).abs().max()) / largest
                   for n, g in truth.items()}
        worst[k] = max(by_name, key=by_name.get)
        err[k] = by_name[worst[k]]
    loss_err = abs(out['card'][0] - out['cpu'][0]) / abs(out['cpu'][0])
    return loss_err, err, worst


def legacy_full_frame(device, paths, checkpoint):
    """A full-size make_forward_fn frame (900x1600, K = 128) from (b)'s
    checkpoint on the card, and on the CPU over the frame's valid points
    alone (in eval mode no crop depends on another, and the padding's
    reach no map; half the CPU's time at this frame's 61 points), the
    crops each scatter took caught on their way in: the valid points'
    crops card vs CPU within BRIDGE_CARD_CPU_CROP_TOL, and with d their
    largest difference, the
    responses within d where both maps have one, and where only one has,
    it within d of the 0.5 threshold; every differing depth pixel one
    that a perturbation of the crops by d can change (``excused`` with the
    exact max's step of 0: the top response within d of 0.5, or the top
    two within 2d of each other)."""
    from rcfd_tpu_torch import legacy_main
    from rcfd_tpu_torch.data import io
    from rcfd_tpu_torch.data.datasets import pad_points
    from rcfd_tpu_torch.data.transforms import Transforms
    from rcfd_tpu_torch.ops import scatter as exact

    image = torch.from_numpy(io.load_image_u8(paths['image'][0],
                                              device='cpu')[None])
    points, valid = pad_points(np.load(paths['radar'][0]), LEGACY_K)
    points, valid = torch.from_numpy(points), torch.from_numpy(valid)
    n = int(valid.sum())
    inputs = {'card': (points, valid), 'cpu': (points[:n], valid[:n])}
    outs, ms, seen = {}, {}, []
    scatter = exact.scatter_quasi_dense

    def scatter_and_keep(crops, *args, **kw):
        seen.append(crops.cpu())
        return scatter(crops, *args, **kw)

    for side, dev in (('card', device), ('cpu', 'cpu')):
        model = legacy_main.build_model()
        legacy_main.restore_model(model, checkpoint, dev)
        fwd = legacy_main.make_forward_fn(
            model, Transforms(normalized_image_range=[0, 1]), H, W)
        with legacy_main.training_numerics(), patched(
                exact, dict(scatter_quasi_dense=scatter_and_keep)):
            torch.backends.cudnn.benchmark = False
            t0 = time.perf_counter()
            outs[side] = [t.cpu() for t in fwd(image.to(dev), *(
                t.to(dev) for t in inputs[side]))]
            ms[side] = (time.perf_counter() - t0) * 1e3
    check(len(seen) == 2, 'legacy (e): {} scatters for 2 frames'.format(
        len(seen)))
    (depth, response), (depth_c, response_c) = outs['card'], outs['cpu']
    crops, crops_c = seen[0][:n], seen[1]
    tol = float((crops - crops_c).abs().max())
    check(tol <= BRIDGE_CARD_CPU_CROP_TOL, 'legacy (e): the full frame\'s '
          'crops differ card vs CPU by {} > {:g}'.format(
              tol, BRIDGE_CARD_CPU_CROP_TOL))
    pw = crops.shape[2]
    differ = torch.nonzero(depth != depth_c).numpy()
    bad = unexplained_quasi(crops_c.numpy(), (points[:n, 0] + pw // 2).numpy(),
                            valid[:n].numpy(), differ, tol, step=0.0)
    both = (response > 0) & (response_c > 0)
    resp_err = float((response - response_c)[both].abs().max())
    one_side = float(torch.maximum(response, response_c)[~both].max())
    check(not bad and resp_err <= tol + 2.0 ** -24 and
          one_side <= 0.5 + tol, 'legacy (e): the full frame differs card '
          'vs CPU at {} unexplained depth pixels {}, responses by {} where '
          'both have one, up to {} where one side has none (crops within '
          '{})'.format(len(bad), bad[:10], resp_err, one_side, tol))
    log('legacy (e): make_forward_fn of one 900x1600 frame: card {:.2f} ms '
        'at K = {}, CPU {:.2f} ms at the {} valid points on {} threads '
        '(host clock, first call); crops differ by at most {:.3g} '
        '(tolerance {:g}), responses by {:.3g} where both maps have one; {} '
        'of {} covered depth pixels differ, each at the threshold or a tie'
        .format(ms['card'], LEGACY_K, ms['cpu'], n, torch.get_num_threads(),
                tol, BRIDGE_CARD_CPU_CROP_TOL, resp_err, len(differ),
                int((depth_c > 0).sum())))
    return ms


def legacy_roi_pool(device):
    """(f) ops/roi_pool.roi_pool on the card against the CPU, bit for bit:
    a 1/8-scale map of a 900x1600 frame, 64 boxes of the frame (one across
    its right edge, one right of it) pooled to 7x7; the card's time."""
    from rcfd_tpu_torch.ops import roi_pool

    rng = np.random.default_rng(SEED + 81)
    cfg = LEGACY_ROI
    feat = torch.from_numpy(rng.standard_normal(
        (1, cfg['channels'], int(np.ceil(H * cfg['scale'])),
         int(np.ceil(W * cfg['scale'])))).astype(np.float32))
    x = np.sort(rng.uniform(0, W, (cfg['boxes'], 2)), 1)
    y = np.sort(rng.uniform(0, H, (cfg['boxes'], 2)), 1)
    boxes = np.stack([x[:, 0], y[:, 0], x[:, 1], y[:, 1]], 1)
    boxes[0] = [W - 40, 100, W + 60, 400]
    boxes[1] = [W + 20, 0, W + 90, 50]
    boxes = torch.from_numpy(boxes[None].astype(np.float32))
    args = (cfg['scale'], cfg['output_size'])
    got = roi_pool.roi_pool(feat.to(device), boxes.to(device), *args)
    ref = roi_pool.roi_pool(feat, boxes, *args)
    check(torch.equal(got.cpu(), ref) and (ref == 0).any(),
          'legacy (f): roi_pool differs card vs CPU')
    fd, bd = feat.to(device), boxes.to(device)
    ms = device_ms(lambda: roi_pool.roi_pool(fd, bd, *args), 10)
    log('legacy (f): roi_pool of {} boxes at {} over a {}x{}x{} map: card '
        '== CPU bit for bit; {:.4f} device ms (median of 10); {}'.format(
            cfg['boxes'], cfg['output_size'], *feat.shape[1:], ms,
            gpu_name_and_power()))
    return ms


def phase_legacy(device, paths, tmp):
    """The legacy v0 pipeline on the card: (a) data_gen, (b) the default
    trainer with a resume, (c) save_depth_radar at bash/train_nuscenes.sh's
    flags, (d) save_stage_1_depth and eval_stage_1_depth, (e) narrow train
    steps and a full-size frame card vs CPU, (f) the general ROI pool. No
    kernel launches on the legacy path: its scatter is the exact float max
    (ops/scatter.py), as the JAX package's legacy path reaches no Pallas
    kernel."""
    t0 = time.perf_counter()
    numbers = {'a': legacy_data_gen(device, tmp)}
    log('legacy (a) took {:.2f} s'.format(time.perf_counter() - t0))
    inputs = legacy_inputs(paths, tmp)
    reset_launches()
    checkpoint, numbers['b'] = legacy_train(device, inputs, tmp)
    numbers['c'] = legacy_save_depth_radar(device, inputs, tmp)
    numbers['d'] = legacy_stage_1(device, inputs, checkpoint, tmp)
    ms = legacy_full_frame(device, paths, checkpoint)
    launches = read_launches()
    check(not any(launches.values()), 'legacy: a kernel launched on the '
          'legacy path: {}'.format({k: v for k, v in launches.items() if v}))
    for patch in LEGACY_NARROW:
        loss_err, err, worst = legacy_narrow_step(device, patch, SEED + 82)
        tol = LEGACY_GRAD_TOL[patch]
        check(loss_err <= 1e-4 and max(err['card'], err['cpu']) <= tol and
              err['card float64'] <= LEGACY_FLOAT64_TOL,
              'legacy (e): the {} step card vs CPU: loss {:.3g}, gradients '
              'from float64 {} at {}'.format(patch, loss_err, err, worst))
        log('legacy (e): a {}x{} train step card vs CPU: loss rel {:.3g}; '
            'largest gradient error from the CPU\'s float64 step, as a '
            'share of the largest gradient: card {:.3g} ({}), CPU {:.3g} '
            '({}) (limit {:g}); the card under deterministic cuDNN '
            'algorithms {:.3g} ({}), printed; the card in float64 {:.3g} '
            '(limit {:g})'.format(
                *patch, loss_err, err['card'], worst['card'], err['cpu'],
                worst['cpu'], tol, err['card deterministic'],
                worst['card deterministic'], err['card float64'],
                LEGACY_FLOAT64_TOL))
    numbers['f_ms'] = legacy_roi_pool(device)
    log('legacy: K1, K2 and K3 launched 0 times on the legacy path (b)-(e); '
        'ms a keyframe (a) {:.2f}; (b) {:.2f} ms a step, {:.2f} samples/s; '
        '(c) {:.2f} ms a step; (d) {:.2f} ms a frame; (e) one full frame '
        'card {:.2f} / CPU {:.2f} ms; {}'.format(
            numbers['a']['wall'], numbers['b']['step_ms'],
            numbers['b']['samples_per_s'], numbers['c']['step_ms'],
            numbers['d']['wall'], ms['card'], ms['cpu'],
            gpu_name_and_power()))


# -- data parallelism ---------------------------------------------------------

# phase parallel: the sharded paths on the one card. Two shards or two ranks
# share cuda:0 (two ranks over gloo, since NCCL refuses two ranks on one
# GPU): a check of the sharded code, not of how it scales
PAR_DEVICES = (torch.device('cuda', 0),) * 2
PAR_FRAMES = 8
# (c): a float64 step of narrow models on 2 ranks, card against CPU: every
# gradient, parameter and loss within this share of its max-abs, the
# running statistics within it relative
PAR_FLOAT64_TOL = 1e-9
# (c): RadarNet at a patch width that is a multiple of 32 (K2 has no
# float64 instance)
PAR_RN_NARROW = dict(RN_NARROW, input_patch_size_image=(128, 96))
# (d): steps of each training; RadarNet at 900x300 (global batch 6, 3 a
# rank: K2 and its backward on both ranks)
PAR_FN_STEPS, PAR_RN_STEPS = 4, 3


def parallel_sharded(device, record, slice_pipe):
    """(a): forward_sharded over PAR_DEVICES at B = PAR_FRAMES on the
    canonical models, under pallas_scatter=True (K1 once a shard a
    request), the exact max (no kernel) and, with K1, at the 900x300 patch
    (K2 3 times a shard): launches counted; each shard's frames equal to
    forward_batched of that shard on the shard's own thread (whose cuDNN
    plans the sharded path uses), bit for bit; K1 and K2 held to their
    plain versions on the sharded path; the frames at both ends of each
    shard (K1) or of the batch (exact, wide) held to __call__ by the
    batched phase's rule (check_frames). Returns ms per request of each
    path."""
    from rcfd_tpu_torch import parallel
    from rcfd_tpu_torch.ops import crop_cuda as cc
    from rcfd_tpu_torch.ops import roi_pool
    from rcfd_tpu_torch.ops import scatter_cuda as sc
    from rcfd_tpu_torch.pipeline import TwoStagePipeline

    # a warm-up request (cuDNN autotunes on the shard threads) and a
    # counted one
    reqs = batched_requests(np.random.default_rng(SEED + 90), 2, PAR_FRAMES)
    shard = PAR_FRAMES // len(PAR_DEVICES)
    k1 = {'scatter_quasi_dense': len(PAR_DEVICES)}
    ends = (0, PAR_FRAMES - 1)
    paths = (
        ('parallel (a) sharded', slice_pipe, k1,
         (slice_pipe, 'scatter_batched',
          sc.scatter_quasi_dense_batched_plain),
         (0, shard - 1, shard, PAR_FRAMES - 1)),
        ('parallel (a) sharded exact', TwoStagePipeline(
            radarnet_like(slice_pipe.radarnet, device, pallas_scatter=False),
            slice_pipe.fusionnet, H, W, device=device), {}, None, ends),
        ('parallel (a) sharded wide', TwoStagePipeline(
            radarnet_like(slice_pipe.radarnet, device,
                          input_patch_size_image=WIDE_PATCH),
            slice_pipe.fusionnet, H, W, device=device),
         dict(k1, column_crop=3 * len(PAR_DEVICES)),
         (roi_pool, 'batch_column_crop', cc.batch_column_crop_plain), ends))
    threads = parallel.shard_threads(len(PAR_DEVICES))
    ms = {}
    for name, pipe, expect, plain, frames in paths:
        def sharded(*req, pipe=pipe):
            return pipe.forward_sharded(*req, devices=list(PAR_DEVICES))

        outs, times, _, launches = serve_path(name, pipe, reqs, device,
                                              expect, batched=True,
                                              serve=sharded)
        count_launches(record, name, launches, list(expect))
        check(len(pipe._sharded) == len(PAR_DEVICES) and
              all(r is pipe for r in pipe._sharded),
              '{}: a device that repeats got a replica of its own'.format(
                  name))
        # one shard at a time: forward_batched sets the global cuDNN flags
        # for its call and restores them after it
        refs = [threads.submit(i, pipe.forward_batched, *part).result()
                for i, part in enumerate(parallel.shard_batch(
                    reqs[1], len(PAR_DEVICES)))]
        for i, ref in enumerate(refs):
            part = slice(i * shard, (i + 1) * shard)
            for label, got, want in zip(('dense', 'quasi', 'response'),
                                        outs[0], ref):
                check(torch.equal(got[part], want), '{}: shard {}: {} '
                      'differs from forward_batched of the shard'.format(
                          name, i, label))
        if plain is not None:
            check_plain_route(name, sharded, reqs[1], outs[0], *plain)
        check_frames(name, pipe, reqs[1], outs[0], frames)
        ms[name] = float(np.median(times))
        log('{}: each of the {} shards of {} frames equals forward_batched '
            'of the shard on its thread, bit for bit'.format(
                name, len(PAR_DEVICES), shard))
        del outs
        torch.cuda.empty_cache()
    parallel_replica(device, record, slice_pipe, reqs[1])
    return ms


def parallel_replica(device, record, slice_pipe, req):
    """(a) from a pipeline built on the CPU with the canonical weights (K1):
    forward_sharded over PAR_DEVICES copies its models to cuda:0 once, a
    replica that both shards use and the next request finds cached, its
    weights equal to the card's; K1 once a shard; each shard's frames equal
    to the replica's forward_batched of the shard on the shard's thread, bit
    for bit, and gathered on cuda:0."""
    from rcfd_tpu_torch import parallel
    from rcfd_tpu_torch.pipeline import TwoStagePipeline

    name = 'parallel (a) replica'
    pipe = TwoStagePipeline(
        radarnet_like(slice_pipe.radarnet, 'cpu'),
        copy.deepcopy(slice_pipe.fusionnet).cpu(), H, W, device='cpu')
    devices = list(PAR_DEVICES)
    expect = {'scatter_quasi_dense': len(devices)}
    torch.cuda.synchronize()
    reset_launches()
    outs = pipe.forward_sharded(*req, devices=devices)
    torch.cuda.synchronize()
    launches = read_launches()
    check(all(n == expect.get(k, 0) for k, n in launches.items()),
          '{}: launches {} (expected {})'.format(name, launches, expect))
    count_launches(record, name, launches, list(expect))
    replica = pipe._sharded[0]
    check(replica is not pipe and all(r is replica for r in pipe._sharded)
          and replica.device == device and
          all(t.device == device for m in (replica.radarnet,
                                           replica.fusionnet)
              for t in list(m.parameters()) + list(m.buffers())),
          '{}: not one replica on {} for the repeated device'.format(
              name, device))
    for label, model, card in (('RadarNet', replica.radarnet,
                                slice_pipe.radarnet),
                               ('FusionNet', replica.fusionnet,
                                slice_pipe.fusionnet)):
        want = card.state_dict()
        check(all(torch.equal(t, want[k])
                  for k, t in model.state_dict().items()),
              '{}: the replica\'s {} differs from the card\'s weights'.format(
                  name, label))
    check(all(o.device == device for o in outs),
          '{}: outputs not gathered on {}'.format(name, device))
    threads = parallel.shard_threads(len(devices))
    shard = PAR_FRAMES // len(devices)
    for i, part in enumerate(parallel.shard_batch(req, len(devices))):
        ref = threads.submit(i, replica.forward_batched, *part).result()
        check(all(torch.equal(o[i * shard:(i + 1) * shard], r)
                  for o, r in zip(outs, ref)),
              '{}: shard {} differs from the replica\'s forward_batched of '
              'the shard'.format(name, i))
    pipe.forward_sharded(*req, devices=devices)
    check(pipe._sharded[0] is replica,
          '{}: the replica was not kept for the next request'.format(name))
    log('{}: a pipeline built on the CPU, sharded over {}: one replica on '
        '{} (weights equal to the card\'s), kept for the next request; '
        'launches {}; each of the {} shards equals the replica\'s '
        'forward_batched of the shard on its thread, bit for bit'.format(
            name, [str(d) for d in devices], device,
            {k: n for k, n in launches.items() if n}, len(devices)))
    del outs, pipe, replica
    torch.cuda.empty_cache()


def parallel_cli(device, record, rn_checkpoint):
    """(b): run_pipeline.main with --data_parallel --batch_size 4 over
    PAR_DEVICES (K1, RCFD_PALLAS_SCATTER=1) on the run phase's frames: two
    sharded requests of two shards; its files equal those of the run
    without the flag (--batch_size 4) except where a 14-bit tie or the
    threshold explains a code (compare_codes): the shard threads choose
    their cuDNN algorithms apart from this thread. Returns the sharded
    run's seconds."""
    from rcfd_tpu_torch import run_pipeline
    from rcfd_tpu_torch.data import io
    from rcfd_tpu_torch.data.datasets import RadarNetInferenceDataset

    root = os.path.dirname(rn_checkpoint)
    checkpoints = (rn_checkpoint, os.path.join(root, 'fusionnet.pth'))
    base = ['--radarnet_restore_path', checkpoints[0],
            '--fusionnet_restore_path', checkpoints[1],
            '--image_path', os.path.join(root, 'image.txt'),
            '--radar_path', os.path.join(root, 'radar.txt'), '--save_outputs']
    env = {'RCFD_PALLAS_SCATTER': '1'}
    names = ['{:010d}.png'.format(i) for i in range(CLI_FRAMES)]
    files, seconds = {}, None
    for run, flags, devices, expect in (
            ('sharded', ['--data_parallel', '--batch_size', '4'],
             list(PAR_DEVICES), 2 * len(PAR_DEVICES)),
            ('batch 4', ['--batch_size', '4'], None, CLI_FRAMES // 4)):
        out_dir = os.path.join(root, 'parallel_' + run.replace(' ', '_'))
        with environ(env):
            reset_launches()
            t0 = time.perf_counter()
            summary = run_pipeline.main(base + flags + [
                '--output_dirpath', out_dir], device=device, devices=devices)
            wall = time.perf_counter() - t0
            launches = read_launches()
        check(launches['scatter_quasi_dense'] == expect and
              sum(launches.values()) == expect,
              'parallel (b) {}: launches {}, K1 expected {}'.format(
                  run, {k: v for k, v in launches.items() if v}, expect))
        files[run] = cli_files(out_dir, names)
        if run == 'sharded':
            count_launches(record, 'parallel (b) run_pipeline --data_parallel',
                           launches, ['scatter_quasi_dense'])
            seconds = dict(summary['seconds'], wall=wall)
            with open(os.path.join(out_dir, 'results.txt')) as f:
                check('Data-parallel serving over 2 device(s)' in f.read(),
                      'parallel (b): no data-parallel line in results.txt')
    # the shard threads choose their cuDNN algorithms apart from this
    # thread's, so the runs without the flag may differ in the last bits:
    # the batched phase's rule for the codes
    dataset = RadarNetInferenceDataset(
        *[io.read_paths(os.path.join(root, n + '.txt'))
          for n in ('image', 'radar')], max_points=None, device=device)
    samples = [dataset.get(i) for i in range(CLI_FRAMES)]
    with environ(env):
        pipe = cli_pipeline(checkpoints, ['--batch_size', '4'], env, device)
    counts = compare_codes(
        'parallel (b) vs batch 4', files['sharded'], files['batch 4'],
        lambda f: tuple(t.float().cpu().numpy() for t in radarnet_outputs(
            pipe, (samples[f][0][None], samples[f][1], samples[f][2]))),
        samples, FOLD_TOL, 1)
    del pipe
    log('parallel (b): run_pipeline --data_parallel --batch_size 4 over {} '
        'shards on cuda:0, {} frames: codes that differ (dense, quasi, '
        'response) from the run without the flag {}, each quasi and '
        'response difference at a 14-bit tie or the threshold; {:.2f} s of '
        'main, read / serve / write {:.2f} / {:.2f} / {:.2f} ms a '
        'frame'.format(
            len(PAR_DEVICES), CLI_FRAMES, counts.tolist(), seconds['wall'],
            *[1e3 * seconds[k] / CLI_FRAMES
              for k in ('read', 'serve', 'write')]))
    return seconds


def parallel_cases():
    """(c)'s steps: a narrow FusionNet (FN_NARROW) on 4 frames of 192x256
    and a narrow RadarNet (PAR_RN_NARROW) on 2 frames of 4 points, weights
    and batches from SEED, decoded to float64."""
    from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel
    from rcfd_tpu_torch.nn import init_parameters

    rng = np.random.default_rng(SEED + 91)
    gen = torch.Generator().manual_seed(SEED + 91)
    fn = FusionNetModel(**FN_NARROW, device='cpu', trainable=True)
    rn = RadarNetModel(**PAR_RN_NARROW, device='cpu', trainable=True)
    init_parameters(fn, gen)
    init_parameters(rn, gen)
    shape = (4, 192, 256)
    fn_batch = (rng.integers(0, 256, shape + (3,)).astype(np.float64),
                *[rng.random(shape + (1,)) * 60 for _ in range(4)])
    ph, pw = PAR_RN_NARROW['input_patch_size_image']
    b, k, w = 2, 4, 256
    x = rng.integers(0, w, (b, k)).astype(np.float64)
    points = np.stack([x + pw // 2, rng.random((b, k)) * ph,
                       rng.random((b, k)) * 60 + 5], -1)
    boxes = np.stack([x, np.zeros_like(x), x + 2 * (pw // 2),
                      np.full_like(x, ph)], -1)
    gt = points[..., 2, None, None, None] + rng.uniform(
        -0.8, 0.8, (b, k, ph, pw, 1))
    gt[rng.random(gt.shape) < 0.4] = 0.0
    rn_batch = (rng.integers(0, 256, (b, ph, w + pw, 3)).astype(np.float64),
                points, boxes, gt)
    return [('fusionnet', FN_NARROW, fn.state_dict(), fn_batch),
            ('radarnet', PAR_RN_NARROW, rn.state_dict(), rn_batch)]


def parallel_steps(device, cases):
    """(c) on one rank: each case's data-parallel step in float64 on this
    rank's slice of its batch (Adam at 1e-3, augmentation off): the
    averaged loss_info and gradients, the parameters after Adam and the
    buffers, on the host."""
    from rcfd_tpu_torch import fusionnet_main as fm
    from rcfd_tpu_torch import parallel
    from rcfd_tpu_torch import radarnet_main as rm
    from rcfd_tpu_torch.data.transforms import Transforms
    from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel

    out = []
    for kind, config, state_dict, batch in cases:
        if kind == 'fusionnet':
            model = FusionNetModel(**config, device='cpu', trainable=True)
        else:
            model = RadarNetModel(**config, device='cpu', trainable=True)
        model.load_state_dict(state_dict, strict=True)
        model = model.to(device, torch.float64)
        optimizer = fm.make_optimizer(model, 1e-3, 0.0)
        if kind == 'fusionnet':
            step = fm.TrainStep(model, Transforms([0, 1]), optimizer, 'l1',
                                0.0, 2.0, -1, 7, 1.5, -1)
        else:
            step = rm.TrainStep(model, Transforms([0, 1]), optimizer,
                                config['input_patch_size_image'], 0.4,
                                False, 2.0)
        local = parallel.shard_batch(batch, parallel.world_size())[
            parallel.rank()]
        with fm.training_numerics():
            info = parallel.data_parallel_step(step)(
                tuple(torch.from_numpy(a).to(device) for a in local), {},
                1e-3)
        out.append(dict(
            info={k: float(v) for k, v in info.items()},
            grads={n: p.grad.cpu().numpy()
                   for n, p in model.named_parameters()
                   if p.grad is not None},
            params={n: p.detach().cpu().numpy()
                    for n, p in model.named_parameters()},
            buffers={n: b.cpu().numpy() for n, b in model.named_buffers()}))
    return out


def parallel_rank(device, cases, trainings):
    """One rank of (c) and, with ``trainings`` ({'radarnet': argv,
    'fusionnet': argv}), (d): its steps of ``cases``
    (``parallel_steps``), then each training CLI's main on its argv as the
    rank's part of the group; of each, the checkpoints it writes, its step
    entries, its launches and its peak memory."""
    import importlib

    from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel

    out = {'steps': parallel_steps(device, cases)}
    for kind, argv in (trainings or {}).items():
        model_cls = RadarNetModel if kind == 'radarnet' else FusionNetModel
        saved = []
        save = model_cls.save_checkpoint

        def recording(self, path, *args, **kw):
            saved.append(os.path.basename(path))
            return save(self, path, *args, **kw)

        model_cls.save_checkpoint = recording
        timings = []
        reset_launches()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        try:
            importlib.import_module('rcfd_tpu_torch.train_' + kind).main(
                argv, device=device, timings=timings)
        finally:
            model_cls.save_checkpoint = save
        out[kind] = dict(saved=saved, timings=timings,
                         launches=read_launches(),
                         peak=torch.cuda.max_memory_allocated(device),
                         wall=time.perf_counter() - t0)
    return out


def parallel_float64(card, cpu):
    """(c): the card ranks' float64 steps against the CPU ranks': both
    ranks' parameters equal on each device; loss_info, every averaged
    gradient and parameter within PAR_FLOAT64_TOL of its max-abs, the
    running statistics within it relative. Returns the largest error."""
    worst = 0.0
    for case, (g0, g1, c0, c1) in enumerate(zip(card[0]['steps'],
                                                card[1]['steps'],
                                                cpu[0]['steps'],
                                                cpu[1]['steps'])):
        for key in ('grads', 'params', 'buffers'):
            check(sorted(g0[key]) == sorted(c0[key]),
                  'parallel (c) case {}: {} differ in names'.format(case, key))
            for n, v in c0[key].items():
                check(np.array_equal(g0[key][n], g1[key][n]) and
                      np.array_equal(v, c1[key][n]),
                      'parallel (c) case {}: {} {} differs between the '
                      'ranks'.format(case, key, n))
                if not np.issubdtype(v.dtype, np.floating):
                    check(np.array_equal(g0[key][n], v),
                          'parallel (c): {} {}'.format(key, n))
                    continue
                err = float(np.abs(g0[key][n] - v).max() /
                            max(float(np.abs(v).max()), 1e-300))
                check(err <= PAR_FLOAT64_TOL, 'parallel (c) case {}: {} {} '
                      'card vs CPU {:.3g} > {:g}'.format(
                          case, key, n, err, PAR_FLOAT64_TOL))
                worst = max(worst, err)
        for n, v in c0['info'].items():
            err = abs(g0['info'][n] - v) / max(abs(v), 1e-300)
            check(err <= PAR_FLOAT64_TOL, 'parallel (c) case {}: {} card vs '
                  'CPU {:.3g}'.format(case, n, err))
            worst = max(worst, err)
    return worst


def parallel_training(device, record, manifests, tmp, cases, cpu_ranks):
    """(c) and (d) in one pair of ranks that share the card: ``cases``'
    float64 steps, against ``cpu_ranks`` (a future of the same on two CPU
    ranks); then train_radarnet.main at 900x300 (PAR_RN_STEPS steps of
    global batch 6, a checkpoint at the last step and again at the end, a
    validation at the end) and train_fusionnet.main with
    bash/train_fusionnet_nuscenes.sh's flags (PAR_FN_STEPS steps of global
    batch 16, a checkpoint every 2 steps, a validation at the end), each
    with --n_data_parallel 2, as the ranks' part of the group. Rank 0
    alone writes; the checkpoints restore. Prints ms a step, each rank's
    wait for its batches and peak memory."""
    from rcfd_tpu_torch import parallel
    from rcfd_tpu_torch.data import io
    from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel

    # one epoch of PAR_RN_STEPS batches of 6: the first frames of the
    # train_radarnet phase's
    rn_manifests = dict(manifests['radarnet'])
    for k in RN_STREAMS:
        rn_manifests['train', k] = os.path.join(
            tmp, 'parallel_rn_train_{}.txt'.format(k))
        io.write_paths(rn_manifests['train', k], io.read_paths(
            manifests['radarnet']['train', k])[:6 * PAR_RN_STEPS])
    ckpt = {k: os.path.join(tmp, 'parallel_' + k)
            for k in ('radarnet', 'fusionnet')}
    trainings = {
        'radarnet': radarnet_train_argv(rn_manifests, ckpt['radarnet'], 1) +
        ['--patch_size', str(WIDE_PATCH[0]), str(WIDE_PATCH[1]),
         '--n_data_parallel', '2', '--n_step_per_checkpoint',
         str(PAR_RN_STEPS), '--start_step_validation',
         str(PAR_RN_STEPS + 1)],
        'fusionnet': train_argv(manifests['fusionnet'], ckpt['fusionnet'],
                                PAR_FN_STEPS) +
        ['--n_data_parallel', '2', '--n_step_per_checkpoint', '2',
         '--start_step_validation', str(PAR_FN_STEPS + 1)]}
    t0 = time.perf_counter()
    card = parallel.run_ranks(parallel_rank, (cases, trainings), 2, device,
                              shared_device=True)
    card_s = time.perf_counter() - t0
    worst = parallel_float64(card, cpu_ranks.result())
    log('parallel (c): a float64 step of a narrow FusionNet (4 frames of '
        '192x256) and a narrow RadarNet (2 frames of 4 points at {}) on 2 '
        'gloo ranks sharing the card against the same 2 ranks on the CPU: '
        'parameters equal on both ranks of each; loss, gradients, '
        'parameters and running statistics at most {:.3g} of their max-abs '
        'apart (tolerance {:g})'.format(
            PAR_RN_NARROW['input_patch_size_image'], worst, PAR_FLOAT64_TOL))

    # (d): 3 K2 launches a RadarNet step; rank 0 also validates at the end,
    # K1 once and K2 3 times a frame; FusionNet launches none
    wants = {r: {'column_crop': 3 * PAR_RN_STEPS +
                 (3 * RN_VAL_FRAMES if r == 0 else 0),
                 'scatter_quasi_dense': RN_VAL_FRAMES if r == 0 else 0}
             for r in (0, 1)}
    for kind, steps, last, restore in (
            ('radarnet', PAR_RN_STEPS, [PAR_RN_STEPS],
             lambda path: (check_radarnet_checkpoint(path, PAR_RN_STEPS),
                           RadarNetModel(**dict(
                               RADARNET, input_patch_size_image=WIDE_PATCH),
                               device='cpu').restore_checkpoint(
                                   path, device='cpu'))),
            ('fusionnet', PAR_FN_STEPS, [2, PAR_FN_STEPS],
             lambda path: (check_checkpoint(path, int(os.path.basename(
                 path)[6:-4])), FusionNetModel(
                     **FUSIONNET, device='cpu').restore_checkpoint(
                         path, device='cpu')))):
        names = ['model-{}.pth'.format(n) for n in last] + \
            ['model-{}.pth'.format(last[-1])]
        check(card[0][kind]['saved'] == names and
              card[1][kind]['saved'] == [],
              'parallel (d) {}: checkpoints written: rank 0 {}, rank 1 {}'
              .format(kind, card[0][kind]['saved'], card[1][kind]['saved']))
        for n in last:
            restore(os.path.join(ckpt[kind], 'model-{}.pth'.format(n)))
        with open(os.path.join(ckpt[kind], 'results.txt')) as f:
            text = f.read()
        check(text.count('Begin training...') == 1 and
              'n_devices=2' in text and
              len(validation_lines(os.path.join(ckpt[kind],
                                                'results.txt'))) == 1,
              'parallel (d) {}: results.txt is not rank 0\'s alone, or '
              'not one validation'.format(kind))
        for r in (0, 1):
            t = card[r][kind]['timings']
            check([e['step'] for e in t] == list(range(1, steps + 1)) and
                  all(math.isfinite(e['loss']) for e in t),
                  'parallel (d) {} rank {}: steps {}'.format(kind, r, t))
        check([e['loss'] for e in card[0][kind]['timings']] ==
              [e['loss'] for e in card[1][kind]['timings']],
              'parallel (d) {}: the ranks\' averaged losses differ'.format(
                  kind))
    for r in (0, 1):
        launches = card[r]['radarnet']['launches']
        check(all(launches[k] == wants[r].get(k, 0) for k in launches) and
              not any(card[r]['fusionnet']['launches'].values()),
              'parallel (d) rank {}: launches {} and {}, expected {} and '
              'none'.format(r, {k: v for k, v in launches.items() if v},
                            {k: v for k, v in card[r]['fusionnet'][
                                'launches'].items() if v}, wants[r]))
        count_launches(record, 'parallel (d) radarnet rank {}'.format(r),
                       launches, list(wants[r]))

    def numbers(kind, r):
        """median ms a step and wait of the steps after the first (which
        chooses cuDNN's algorithms), peak memory, wall seconds"""
        run = card[r][kind]
        later = run['timings'][1:]
        return (float(np.median([e['step_ms'] for e in later])),
                float(np.median([e['wait_ms'] for e in later])),
                run['peak'], run['wall'])

    got = {kind: [numbers(kind, r) for r in (0, 1)]
           for kind in ('fusionnet', 'radarnet')}
    log('parallel (d): two ranks sharing one card (not a scaling result), '
        'in {:.2f} s of both ranks\' work with (c). FusionNet at '
        'bash/train_fusionnet_nuscenes.sh\'s flags (global batch 16, 8 a '
        'rank, 448x448), {} steps and a validation of {} frames at the end: '
        'rank 0 / 1 ms a step, median of steps 2-{} {:.2f} / {:.2f}, host '
        'wait {:.2f} / {:.2f} ms, peak memory {} / {} bytes, wall {:.2f} / '
        '{:.2f} s; RadarNet at 900x300 (global batch 6, 3 a rank, K2 with '
        'its gradient on both ranks), {} steps: rank 0 / 1 ms a step, '
        'median of steps 2-{} {:.2f} / {:.2f}, host wait {:.2f} / {:.2f} '
        'ms, peak memory {} / {} bytes, wall {:.2f} / {:.2f} s; checkpoints '
        'from rank 0 only, restored; {}'.format(
            card_s, PAR_FN_STEPS, VAL_FRAMES, PAR_FN_STEPS,
            *[got['fusionnet'][r][i] for i in range(4) for r in (0, 1)],
            PAR_RN_STEPS, PAR_RN_STEPS,
            *[got['radarnet'][r][i] for i in range(4) for r in (0, 1)],
            gpu_name_and_power()))
    return dict(fusionnet=got['fusionnet'], radarnet=got['radarnet'],
                float64=worst)


def parallel_nccl(device):
    """(e): a train step of a narrow FusionNet wrapped by
    data_parallel_step inside a one-rank NCCL group on cuda:0, against the
    unwrapped step on the same weights and batch: loss_info, gradients,
    parameters and buffers equal bit for bit. Both run under the training
    numerics with cuDNN's deterministic algorithms (benchmark off), so that
    two runs of one step are equal at all."""
    from rcfd_tpu_torch import fusionnet_main as fm
    from rcfd_tpu_torch import parallel

    model, batch, make_step = narrow_case('fusionnet', SEED + 92)
    batch = tuple(torch.from_numpy(a).to(device) for a in batch)
    outs = []
    for wrap in (False, True):
        m = copy.deepcopy(model).to(device)
        step = make_step(m)
        with fm.training_numerics(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=False):
            if wrap:
                address = 'tcp://127.0.0.1:{}'.format(parallel.free_port())
                with parallel.process_group('nccl', address, 1, 0, device):
                    check(torch.distributed.get_backend() == 'nccl',
                          'parallel (e): the group is not NCCL\'s')
                    info = parallel.data_parallel_step(step)(batch, {}, 1e-3)
            else:
                info = step(batch, {}, 1e-3)
        torch.cuda.synchronize()
        outs.append((info, {n: t.detach().clone() for n, t in
                            list(m.named_parameters()) +
                            list(m.named_buffers())},
                     {n: p.grad.clone() for n, p in m.named_parameters()
                      if p.grad is not None}))
    (info_a, state_a, grads_a), (info_b, state_b, grads_b) = outs
    check(sorted(info_a) == sorted(info_b) and
          all(torch.equal(info_a[k].to(device), info_b[k].to(device))
              for k in info_a) and
          all(torch.equal(state_a[k], state_b[k]) for k in state_a) and
          sorted(grads_a) == sorted(grads_b) and
          all(torch.equal(grads_a[k], grads_b[k]) for k in grads_a),
          'parallel (e): the step in a one-rank NCCL group differs from the '
          'unwrapped step')
    log('parallel (e): a narrow FusionNet step wrapped by '
        'data_parallel_step in a one-rank NCCL group on cuda:0 equals the '
        'unwrapped step bit for bit ({} parameters and buffers, {} '
        'gradients, loss {:.6f})'.format(len(state_a), len(grads_a),
                                        float(info_a['loss'])))


def phase_parallel(device, record, slice_pipe, rn_checkpoint, manifests,
                   tmp):
    """Data parallelism on the one card: (a) sharded serving, (b) the
    serving CLI's --data_parallel, (c) float64 steps on two ranks card vs
    CPU (the CPU's ranks run while (a) and (b) use the card), (d) both
    trainings on two ranks, (e) a one-rank NCCL group. Two shards or ranks
    share cuda:0: the sharded code is checked, its scaling is not
    measured."""
    from concurrent.futures import ThreadPoolExecutor

    from rcfd_tpu_torch import parallel

    seconds = {}
    t0 = time.perf_counter()
    cases = parallel_cases()
    with ThreadPoolExecutor(1) as pool:
        cpu_ranks = pool.submit(parallel.run_ranks, parallel_rank,
                                (cases, None), 2, 'cpu')
        ms = parallel_sharded(device, record, slice_pipe)
        seconds['a'] = time.perf_counter() - t0
        parallel_cli(device, record, rn_checkpoint)
        torch.cuda.empty_cache()
        seconds['b'] = time.perf_counter() - t0 - sum(seconds.values())
        numbers = parallel_training(device, record, manifests, tmp, cases,
                                    cpu_ranks)
        seconds['c, d'] = time.perf_counter() - t0 - sum(seconds.values())
    parallel_nccl(device)
    seconds['e'] = time.perf_counter() - t0 - sum(seconds.values())
    log('parallel: ms per request of 8 frames sharded over two shards of '
        'cuda:0: {}; (c) float64 card vs CPU at most {:.3g}; seconds of '
        'the phase by part: {}; {}'.format(
            ', '.join('{} {:.2f}'.format(k, v) for k, v in ms.items()),
            numbers['float64'], ', '.join('({}) {:.2f}'.format(k, v)
                                          for k, v in seconds.items()),
            gpu_name_and_power()))


def native_codes(maps):
    """The 16-bit codes the float writers make of (dense, quasi,
    response)."""
    from rcfd_tpu_torch import native

    dense, quasi, response = maps
    return (native.depth_codes(dense, 256.0), native.depth_codes(quasi, 256.0),
            native.depth_codes(response, 2.0 ** 14))


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
    with Phase('codec'), tempfile.TemporaryDirectory() as tmp:
        phase_codec(device, tmp)
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
    with Phase('exact'):
        phase_exact(device, slice_pipe, reqs)
    with Phase('stage0'), tempfile.TemporaryDirectory() as tmp:
        phase_stage0(device, record, slice_pipe, tmp)
    torch.cuda.empty_cache()
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
    del fused_pipe, wide_pipe, opt_pipe
    torch.cuda.empty_cache()
    with Phase('cli'), tempfile.TemporaryDirectory() as tmp:
        phase_cli(device, record, rn, fn, tmp)
    torch.cuda.empty_cache()
    # the three training phases share their files, and the configs phase
    # trains on them too
    with tempfile.TemporaryDirectory() as train_tmp:
        with Phase('train'):
            fusionnet_f32 = phase_train(device, rn, train_tmp)
        torch.cuda.empty_cache()
        with Phase('train_radarnet'):
            radarnet_f32 = phase_train_radarnet(device, record, fn,
                                                train_tmp)
        torch.cuda.empty_cache()
        with Phase('train_bf16'):
            phase_train_bf16(device, record, dict(
                tmp=train_tmp, fusionnet=fusionnet_f32,
                radarnet=radarnet_f32))
        torch.cuda.empty_cache()
        # the bridge reuses the run phase's frames and RadarNet checkpoint,
        # the configs phase serves FusionNet's inputs of the run phase
        with tempfile.TemporaryDirectory() as tmp:
            with Phase('run'):
                paths, rn_checkpoint, fn_inputs = phase_run(
                    device, record, rn, fn, tmp)
            torch.cuda.empty_cache()
            with Phase('bridge'):
                phase_bridge(device, record, paths, rn_checkpoint, tmp)
            torch.cuda.empty_cache()
            with Phase('tools'):
                phase_tools(device, record, paths, rn_checkpoint,
                            fusionnet_f32['checkpoint'], tmp)
            torch.cuda.empty_cache()
            with Phase('configs'):
                phase_configs(device, fusionnet_f32, fn_inputs, tmp)
            torch.cuda.empty_cache()
            with Phase('legacy'):
                phase_legacy(device, paths, tmp)
            torch.cuda.empty_cache()
            with Phase('parallel'):
                phase_parallel(device, record, slice_pipe, rn_checkpoint,
                               {'fusionnet': fusionnet_f32['manifests'],
                                'radarnet': radarnet_f32['manifests']}, tmp)

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
