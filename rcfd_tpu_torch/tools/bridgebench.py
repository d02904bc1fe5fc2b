"""Stage-1.5 bridge throughput harness (counterpart of tools/bridgebench.py).

Times the bridge's real inner loop: RadarNetInferenceDataset (PNG decode,
integer transport) -> ``radarnet_main.iter_scatter_outputs`` (the next
batch read and copied to the card while the card serves this one, the
scatter over a batch of frames) -> 16-bit PNG writes, on a synthetic
full-size fixture, in frames/s with the host's I/O included. It is the
loop of ``python -m rcfd_tpu_torch.setup.setup_dataset_nuscenes_radarnet``.

Modes: ``prefetch`` is that loop; ``codec`` the same with the outputs
encoded to their 16-bit PNG codes on the card (half the bytes to the host,
the same files); ``sync`` the serialized loop (read, stack, copy, serve,
write, one after another), so that the prefetch's gain is measured. One
forward of a batch warms each forward up (cuDNN's algorithm choice) before
the timed passes, and every pass ends with its outputs on the host.

    python -m rcfd_tpu_torch.tools.bridgebench               # the card
    python -m rcfd_tpu_torch.tools.bridgebench --mode all --dtype float32

RadarNet has the canonical widths and weights drawn from a seed; in
bfloat16 it computes in bf16 (the scatter kernel's bf16 instance on the
card). The scatter is ``radarnet_main.scatter_route``'s: the kernel K1 on
the card, the exact max on the CPU. As the bridge, it reads the RCFD_*
gates of RadarNet's PerfConfig (``nn.perf.perf_from_env``): at the
defaults a batch decodes 8 x 96 = 768 patches in one chunk, more than the
card's 80 GB hold in float32, so a float32 run there takes
RCFD_DECODE_CHUNKS=2. ``main(argv, device='cpu')`` runs on
the CPU, at tiny shapes:

    main(['--height', '64', '--width', '96', '--patch', '64', '32',
          '--n_frames', '6', '--n_points', '8', '--eval_batch_size', '4',
          '--dtype', 'float32', '--check_only'], device='cpu')

``--check_only`` runs the three modes and asserts that prefetch and sync
write the same depth and codec the same files, byte for byte. The last
line printed is one JSON row: the JAX tool's keys, ``backend`` the device
type, and ``device`` the card's name and power limit as nvidia-smi gives
them (or ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from .. import default_device, radarnet_main
from ..data import io as data_utils
from ..data import transport
from ..data.datasets import RadarNetInferenceDataset
from ..data.transforms import Transforms
from ..nn.layers import init_parameters
from ..nn.perf import perf_from_env
from ..pipeline import serving_numerics
from . import timing
from .fixtures import make_radarnet_fixture

MODES = ('prefetch', 'sync', 'codec')
SEED = 0


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def run_bridge(mode, forward_fn_b, dataset, out_dir, eval_batch_size,
               device, numerics=serving_numerics):
    """One full pass in ``mode``: inference and the PNG writes of every
    frame, under ``numerics()`` (the serving numerics by default). Returns
    (seconds, frames, the depth paths), the written files letting the
    caller compare modes."""
    os.makedirs(out_dir, exist_ok=True)
    depth_paths = []
    _sync(device)
    t0 = time.perf_counter()
    with numerics():
        if mode in ('prefetch', 'codec'):
            for idx, _data, output_depth, response in \
                    radarnet_main.iter_scatter_outputs(
                        forward_fn_b, dataset, eval_batch_size, device):
                dp = os.path.join(out_dir, 'depth_{:05d}.png'.format(idx))
                rp = os.path.join(out_dir, 'resp_{:05d}.png'.format(idx))
                if mode == 'codec':
                    data_utils.save_depth_encoded(output_depth, dp)
                    data_utils.save_response_encoded(response, rp)
                else:
                    data_utils.save_depth(output_depth, dp)
                    data_utils.save_response(response, rp)
                depth_paths.append(dp)
        else:
            n_sample = len(dataset)
            bsz = max(1, min(eval_batch_size, n_sample))
            for start in range(0, n_sample, bsz):
                idxs = list(range(start, min(start + bsz, n_sample)))
                samples = [dataset.get(i) for i in idxs]
                padded = samples + [samples[-1]] * (bsz - len(samples))
                batch = [torch.from_numpy(np.stack([s[j] for s in padded]))
                         .to(device) for j in range(3)]
                depth_b, response_b = (t.cpu().numpy()
                                       for t in forward_fn_b(*batch))
                for j, idx in enumerate(idxs):
                    transport.decode_np(samples[j])
                    dp = os.path.join(out_dir, 'depth_{:05d}.png'.format(idx))
                    data_utils.save_depth(depth_b[j], dp)
                    data_utils.save_response(response_b[j], os.path.join(
                        out_dir, 'resp_{:05d}.png'.format(idx)))
                    depth_paths.append(dp)
    _sync(device)
    return time.perf_counter() - t0, len(depth_paths), depth_paths


def build_model(patch, dtype, device, seed=SEED, perf=None):
    """RadarNet at the canonical widths (the JAX tool's), weights drawn
    from ``seed``, in ``dtype`` on ``device``, in eval mode; ``perf`` its
    PerfConfig."""
    model = radarnet_main.build_model(
        input_channels_image=3, input_channels_depth=3, patch_size=patch,
        encoder_type='radarnetv1_batch_norm',
        n_filters_encoder_image=[32, 64, 128, 128, 128],
        n_neurons_encoder_depth=[32, 64, 128, 128, 128],
        decoder_type='multiscale_batch_norm',
        n_filters_decoder=[256, 128, 64, 32, 16],
        weight_initializer='kaiming_uniform', activation_func='leaky_relu',
        device='cpu', perf=perf)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device, dtype).eval()


def same_bytes(a, b):
    with open(a, 'rb') as f, open(b, 'rb') as g:
        return f.read() == g.read()


def check_modes(outs):
    """prefetch and sync write the same depth; codec the same files as
    prefetch, byte for byte (depth and response). Raises AssertionError."""
    for pa, ps in zip(outs['prefetch'], outs['sync']):
        if not np.array_equal(data_utils.load_depth(pa),
                              data_utils.load_depth(ps)):
            raise AssertionError('prefetch and sync bridge outputs differ: '
                                 '{}'.format(ps))
    for pa, pc in zip(outs['prefetch'], outs['codec']):
        for a, c in ((pa, pc), (pa.replace('depth_', 'resp_'),
                                pc.replace('depth_', 'resp_'))):
            if not same_bytes(a, c):
                raise AssertionError('codec-encoded bridge PNG differs: '
                                     '{}'.format(c))


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.bridgebench')
    parser.add_argument('--n_frames', type=int, default=48)
    parser.add_argument('--height', type=int, default=900)
    parser.add_argument('--width', type=int, default=1600)
    parser.add_argument('--patch', type=int, nargs=2, default=[900, 288])
    parser.add_argument('--n_points', type=int, default=96,
                        help='radar returns per frame (dataset pads to max)')
    parser.add_argument('--eval_batch_size', type=int, default=8)
    parser.add_argument('--dtype', default='bfloat16',
                        choices=['bfloat16', 'float32'])
    parser.add_argument('--mode',
                        choices=['prefetch', 'sync', 'codec', 'both', 'all'],
                        default='both')
    parser.add_argument('--check_only', action='store_true',
                        help='assert prefetch==sync outputs and '
                             'codec==prefetch files (CI smoke, at tiny '
                             'shapes)')
    return parser


def main(argv=None, device=None):
    """Run the harness on ``device`` (``cuda`` unless ``device='cpu'``).
    Returns the JSON row it prints last."""
    args = build_parser().parse_args(argv)
    if args.n_frames < 1 or args.n_points < 1:
        raise SystemExit('--n_frames and --n_points must be >= 1')
    device = default_device(device)
    dtype = torch.bfloat16 if args.dtype == 'bfloat16' else torch.float32
    if args.check_only or args.mode == 'all':
        modes = list(MODES)
    elif args.mode == 'both':
        modes = ['prefetch', 'sync']
    else:
        modes = [args.mode]

    root = tempfile.mkdtemp(prefix='bridgebench_')
    try:
        manifests = make_radarnet_fixture(
            root, n_samples=args.n_frames, height=args.height,
            width=args.width, n_points=args.n_points)
        dataset = RadarNetInferenceDataset(
            image_paths=data_utils.read_paths(manifests['image']),
            radar_paths=data_utils.read_paths(manifests['radar']),
            max_points=args.n_points, device=device)
        model = build_model(args.patch, dtype, device, perf=perf_from_env())
        transforms = Transforms(normalized_image_range=[0, 1])
        forwards = {codec: radarnet_main.make_forward_fn_batched(
            model, transforms, args.height, args.width, codec_encode=codec)
            for codec in (False, True)}

        # warm: cuDNN chooses each forward's algorithms outside the passes
        warm = [torch.from_numpy(np.stack(
            [f] * min(args.eval_batch_size, args.n_frames))).to(device)
            for f in dataset.get(0)[:3]]
        with serving_numerics():
            for codec in (False, True) if 'codec' in modes else (False,):
                forwards[codec](*warm)[0].cpu()

        results, outs = {}, {}
        for mode in modes:
            dt, n, paths = run_bridge(
                mode, forwards[mode == 'codec'], dataset,
                os.path.join(root, 'out_' + mode), args.eval_batch_size,
                device)
            results[mode] = dict(seconds=round(dt, 3),
                                 frames_per_s=round(n / dt, 3))
            outs[mode] = paths
            print('[bridgebench] {}: {} frames in {:.2f}s -> {:.2f} frames/s '
                  '(incl. PNG decode+write)'.format(mode, n, dt, n / dt),
                  file=sys.stderr)
        if args.check_only:
            check_modes(outs)

        row = {
            'harness': 'bridgebench', 'n_frames': args.n_frames,
            'shape': [args.height, args.width],
            'patch': list(args.patch), 'n_points': args.n_points,
            'eval_batch_size': args.eval_batch_size, 'dtype': args.dtype,
            'backend': device.type, 'check_only': args.check_only,
            'results': results, 'device': timing.card_line(device)}
        print(json.dumps(row))
        return row
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == '__main__':
    main()
