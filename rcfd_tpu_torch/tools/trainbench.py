"""Loader-fed training throughput (counterpart of tools/trainbench.py).

Times the real training chain: ``DataLoader`` (threaded workers, PNG
decode, integer transport) -> ``device_prefetch`` (pinned, non-blocking
copies ahead of use) -> the family's ``TrainStep`` (forward, loss,
backward, Adam), not tensors already on the card.

Families:
  --family fusionnet (default): 448x448 crops at canonical widths (5 PNG
    streams a sample, cropped from larger frames)
  --family radarnet: bs 6, 900x288 patches of full frames, K = 4 points
    with their ground-truth crops

``--model tiny`` / ``canonical`` are the JAX tool's widths
(bash/train_*_nuscenes.sh for canonical). The fixture is
``tools/fixtures.py``'s, in TMPDIR unless ``--data_dir`` names one.
``--train_dtype bfloat16`` goes through RCFD_TRAIN_DTYPE (the step's
mixed precision, read when the step is built) and ``--raw_cache`` through
RCFD_RAW_CACHE. ``--n_devices N`` > 1 trains on N ranks
(``parallel.run_ranks``: a rank a card over NCCL, or gloo ranks on the
CPU), each loading its slice of the global ``--batch_size`` and averaging
gradients before Adam (``parallel.data_parallel_step``).

    python -m rcfd_tpu_torch.tools.trainbench --model canonical \\
        --height 448 --width 448 --batch_size 16
    python -m rcfd_tpu_torch.tools.trainbench --family radarnet \\
        --model canonical --height 900 --width 1600 --batch_size 6

``main(argv, device='cpu')`` runs on the CPU. Prints one JSON line: the
JAX tool's keys (``backend`` the device type) and ``device``, the card's
name and power limit (or ``cpu``). ``step_ms`` is the wall time of the
loader-fed steps after ``--n_warmup``; ``step_only_ms`` that of
max(4, n_steps // 2) steps on the last batch already on the device,
between two CUDA events (``timing.chain_ms``). Under several ranks the
row is rank 0's, ``loader_only_samples_per_s`` its slice's rate times
the ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from .. import default_device, fusionnet_main, parallel, radarnet_main
from ..data import io as data_utils
from ..data import raw_cache
from ..data.datasets import FusionNetTrainingDataset, RadarNetTrainingDataset
from ..data.loader import DataLoader, device_prefetch
from ..data.transforms import Transforms
from ..models import FusionNetModel, RadarNetModel
from ..training import make_optimizer, step_seed, training_numerics
from . import serving_config, timing
from .fixtures import make_fusionnet_fixture, make_radarnet_fixture

FUSIONNET_MODELS = {
    'tiny': dict(
        n_filters_encoder_image=[8, 12, 16, 16, 16],
        n_filters_encoder_depth=[4, 6, 8, 8, 8],
        n_filters_decoder=[16, 12, 8, 8, 8]),
    # bash/train_fusionnet_nuscenes.sh
    'canonical': dict(
        n_filters_encoder_image=[32, 64, 128, 256, 256, 256],
        n_filters_encoder_depth=[16, 32, 64, 128, 128, 128],
        n_filters_decoder=[256, 256, 128, 64, 64, 32]),
}

RADARNET_MODELS = {
    'tiny': dict(
        n_filters_encoder_image=[4, 8, 8, 8, 8],
        n_neurons_encoder_depth=[4, 8, 8, 8, 8],
        n_filters_decoder=[8, 8, 8, 8, 8]),
    # bash/train_radarnet_nuscenes.sh
    'canonical': dict(
        n_filters_encoder_image=[32, 64, 128, 128, 128],
        n_neurons_encoder_depth=[32, 64, 128, 128, 128],
        n_filters_decoder=[256, 128, 64, 32, 16]),
}

LEARNING_RATE = 1e-4
AUGMENTATION_PROBABILITY = 1.0


def _transforms():
    return Transforms(normalized_image_range=[0, 1],
                      random_brightness=[0.8, 1.2],
                      random_contrast=[0.8, 1.2],
                      random_saturation=[0.8, 1.2],
                      random_flip_type=['horizontal'])


def _manifests(data_dir, names):
    return {n: data_utils.read_paths(os.path.join(data_dir, n + '.txt'))
            for n in names}


def fixture_dir(args) -> str:
    """The family's fixture directory (``--data_dir``, else one in TMPDIR
    named by its frame size and sample count), made if it holds no
    manifest: FusionNet's frames 16 larger than the crop, RadarNet's the
    patch height by ``--width``."""
    if args.family == 'radarnet':
        src_h = args.source_height or args.height
        src_w = args.source_width or args.width
        name = 'trainbench_rn_{}x{}_{}'
    else:
        src_h = args.source_height or args.height + 16
        src_w = args.source_width or args.width + 16
        name = 'trainbench_{}x{}_{}'
    data_dir = args.data_dir or os.path.join(
        tempfile.gettempdir(), name.format(src_h, src_w, args.n_samples))
    if not os.path.exists(os.path.join(data_dir, 'image.txt')):
        if args.family == 'radarnet':
            make_radarnet_fixture(
                data_dir, n_samples=args.n_samples, height=src_h,
                width=src_w, n_points=max(args.total_points_sampled * 4, 8))
        else:
            make_fusionnet_fixture(data_dir, n_samples=args.n_samples,
                                   height=src_h, width=src_w)
    return data_dir


def build_fusionnet(args, device):
    """FusionNet's dataset, model (drawn from seed 0, trainable) and
    ``make_step(model, optimizer)``: 448x448 crops of frames 16 larger at
    the canonical flags, 5 PNG streams a sample."""
    m = _manifests(fixture_dir(args), ['image', 'depth', 'response',
                                       'ground_truth', 'lidar'])
    dataset = FusionNetTrainingDataset(
        m['image'], m['depth'], m['response'], m['ground_truth'], m['lidar'],
        shape=(args.height, args.width),
        random_crop_type=['horizontal', 'vertical'], device=device)
    config = dict(
        input_channels_image=3, input_channels_depth=2,
        encoder_type='fusionnet18_batch_norm',
        fusion_type='weight_and_project',
        decoder_type='multiscale_batch_norm', n_resolution_decoder=1,
        min_predict_depth=1.0, max_predict_depth=100.0,
        **FUSIONNET_MODELS[args.model])
    model = serving_config.build(FusionNetModel, config, 0, device,
                                 trainable=True)
    transforms = _transforms()

    def make_step(model, optimizer):
        return fusionnet_main.TrainStep(
            model, transforms, optimizer, loss_func='l1', w_smoothness=0.1,
            w_lidar_loss=2.0, loss_smoothness_kernel_size=-1,
            outlier_kernel_size=7, outlier_threshold=1.5,
            dilation_kernel_size=-1)

    return dataset, model, make_step, transforms


def build_radarnet(args, device):
    """RadarNet's dataset, model (drawn from seed 0, trainable) and
    ``make_step(model, optimizer)``: full-frame loads, patches of
    (height, patch_width), K sampled points with their ground-truth
    crops."""
    patch = (args.height, args.patch_width)
    m = _manifests(fixture_dir(args), ['image', 'radar', 'ground_truth'])
    dataset = RadarNetTrainingDataset(
        m['image'], m['radar'], m['ground_truth'], patch_size=patch,
        total_points_sampled=args.total_points_sampled,
        sample_probability_of_lidar=0.10, device=device)
    config = dict(
        input_channels_image=3, input_channels_depth=3,
        input_patch_size_image=patch, encoder_type='radarnetv1_batch_norm',
        decoder_type='multiscale_batch_norm', **RADARNET_MODELS[args.model])
    model = serving_config.build(RadarNetModel, config, 0, device,
                                 trainable=True)
    transforms = _transforms()

    def make_step(model, optimizer):
        return radarnet_main.TrainStep(
            model, transforms, optimizer, patch,
            max_distance_correspondence=0.4,
            set_invalid_to_negative_class=True, w_positive_class=2.0)

    return dataset, model, make_step, transforms


def make_loader(args, dataset, batch_size: int, rank: int = 0,
                world: int = 1):
    """The JAX tool's loader: shuffled, seed 0, ragged tail dropped; this
    rank's slice of each global batch."""
    return DataLoader(dataset, batch_size=batch_size, shuffle=True,
                      num_workers=args.n_thread, seed=0, drop_last=True,
                      process_index=rank, process_count=world)


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.trainbench')
    parser.add_argument('--family', choices=['fusionnet', 'radarnet'],
                        default='fusionnet')
    parser.add_argument('--n_devices', type=int, default=None)
    parser.add_argument('--model', choices=['tiny', 'canonical'],
                        default='tiny')
    parser.add_argument('--height', type=int, default=64,
                        help='fusionnet: crop height; radarnet: patch '
                             'height (the bottom rows of the frame)')
    parser.add_argument('--width', type=int, default=96)
    parser.add_argument('--patch_width', type=int, default=None,
                        help='radarnet patch width (canonical 288; '
                             'default width//3 rounded to 32)')
    parser.add_argument('--total_points_sampled', type=int, default=4)
    parser.add_argument('--source_height', type=int, default=None,
                        help='on-disk frame height (crop source); '
                             'default height + 16 (fusionnet) or height '
                             '(radarnet)')
    parser.add_argument('--source_width', type=int, default=None)
    parser.add_argument('--batch_size', type=int, default=None,
                        help='default: n_devices samples')
    parser.add_argument('--n_samples', type=int, default=64,
                        help='fixture size (loader cycles epochs)')
    parser.add_argument('--n_steps', type=int, default=20)
    parser.add_argument('--n_warmup', type=int, default=3)
    parser.add_argument('--n_thread', type=int, default=4)
    parser.add_argument('--train_dtype',
                        default=os.environ.get('RCFD_TRAIN_DTYPE'),
                        choices=[None, 'bfloat16'], nargs='?')
    parser.add_argument('--data_dir', type=str, default=None,
                        help='reuse an existing fixture dir')
    parser.add_argument('--raw_cache', type=str, default=None,
                        help='decode-once raw cache dir '
                             '(rcfd_tpu_torch/data/raw_cache.py)')
    return parser


def bench(device, a: dict):
    """One rank's run (all of it without ranks): the loader-only epoch,
    the timed loader-fed steps, the device-resident steps. Returns the
    row."""
    args = argparse.Namespace(**a)
    world, rank = parallel.world_size(), parallel.rank()
    device = torch.device(device)
    build = build_radarnet if args.family == 'radarnet' else build_fusionnet
    if rank == 0:
        fixture_dir(args)  # the other ranks read it
    parallel.barrier()
    with raw_cache.raw_cache_for(args.raw_cache):
        dataset, model, make_step, transforms = build(args, device)
        loader = make_loader(args, dataset, args.batch_size, rank, world)
        local = args.batch_size // world

        # ---- loader-only throughput (the input pipeline's roofline) ----
        t0 = time.perf_counter()
        n_loader = 0
        loader.set_epoch(0)
        for batch in loader:
            n_loader += batch[0].shape[0]
        loader_sps = n_loader * world / (time.perf_counter() - t0)

        optimizer = make_optimizer(model, LEARNING_RATE, 0.0)
        if world > 1:
            parallel.broadcast_module(model)
        step = make_step(model, optimizer)
        if world > 1:
            step = parallel.data_parallel_step(step)
        points_shape = (local, args.total_points_sampled, 3) \
            if args.family == 'radarnet' else ()
        generator = torch.Generator(device=device)
        n_done = 0

        def one_step(batch):
            nonlocal n_done
            n_done += 1
            generator.manual_seed(step_seed(1, n_done))
            draws = transforms.draws(generator, local,
                                     AUGMENTATION_PROBABILITY, points_shape)
            return step(batch, draws, LEARNING_RATE)

        def fence():
            if device.type == 'cuda':
                torch.cuda.synchronize(device)

        with training_numerics():
            # ---- timed loop: loader -> prefetch -> step --------------
            t_start = time.perf_counter() if args.n_warmup <= 0 else None
            n_timed_start = 0
            epoch = 0
            info = None
            total = args.n_steps + args.n_warmup
            while n_done < total:
                epoch += 1
                loader.set_epoch(epoch)
                for batch in device_prefetch(loader, device):
                    info = one_step(batch)
                    if n_done == args.n_warmup:
                        fence()
                        t_start = time.perf_counter()
                        n_timed_start = n_done
                    if n_done >= total:
                        break
            loss = float(info['loss'])  # fences the last step
            dt = time.perf_counter() - t_start
            n_timed = n_done - n_timed_start
            step_ms = dt / n_timed * 1e3
            sps = n_timed * args.batch_size / dt
            if not np.isfinite(loss):
                raise AssertionError('loss {}'.format(loss))

            # ---- device-resident steps on the last batch ---------------
            one_step(batch)
            fence()
            n_only = max(4, args.n_steps // 2)
            only_ms, _ = timing.chain_ms(lambda c: one_step(batch), None,
                                         n_only, device, repeats=1)
            step_only_ms = only_ms / n_only

    shape = [args.height, args.width] if args.family == 'fusionnet' else \
        [args.height, args.patch_width, args.total_points_sampled]
    return {
        'harness': 'trainbench',
        'family': args.family,
        'model': args.model,
        'backend': device.type,
        'n_devices': world,
        'batch_size': args.batch_size,
        'shape': shape,
        'train_dtype': args.train_dtype or 'float32',
        'step_ms': round(step_ms, 3),
        'step_only_ms': round(step_only_ms, 3),
        'step_only_samples_per_s': round(
            args.batch_size / step_only_ms * 1e3, 3),
        'samples_per_s': round(sps, 3),
        'samples_per_s_per_chip': round(sps / world, 3),
        'loader_only_samples_per_s': round(loader_sps, 3),
        'loss': round(loss, 5),
        'device': timing.card_line(device),
    }


def main(argv=None, device=None):
    """Run the harness on ``device`` (``cuda`` unless ``device='cpu'``).
    Returns the JSON row it prints."""
    args = build_parser().parse_args(argv)
    if args.n_steps < 1:
        raise SystemExit('--n_steps must be >= 1')
    if args.n_warmup < 0:
        raise SystemExit('--n_warmup must be >= 0')
    device = default_device(device)
    if args.raw_cache:
        os.environ['RCFD_RAW_CACHE'] = args.raw_cache
    if args.train_dtype:
        # the step reads RCFD_TRAIN_DTYPE when it is built, as the
        # training CLIs' steps do
        os.environ['RCFD_TRAIN_DTYPE'] = args.train_dtype
    if args.patch_width is None:
        args.patch_width = 288 if args.width >= 864 else \
            max(32, (args.width // 3) // 32 * 32)
    n_devices = args.n_devices or (
        torch.cuda.device_count() if device.type == 'cuda' else 1)
    args.batch_size = args.batch_size or n_devices
    if args.batch_size % n_devices:
        raise SystemExit('--batch_size {} does not divide over {} '
                         'devices'.format(args.batch_size, n_devices))
    if n_devices > 1:
        row = parallel.run_ranks(bench, (vars(args),), n_devices, device)[0]
    else:
        row = bench(device, vars(args))
    print(json.dumps(row))
    return row


if __name__ == '__main__':
    main()
