"""CLI: train RadarNet on one card or several, the port's counterpart of
train_radarnet.py (reference src/train_radarnet.py).

    python -m rcfd_tpu_torch.train_radarnet --train_image_path ... \\
        --checkpoint_dirpath out [--restore_path latest]

It takes the JAX CLI's flags with the same defaults, plus ``--device``,
which defaults to ``cuda`` (``--device cpu`` trains on the CPU).
``--n_data_parallel`` is train_fusionnet's (ranks sharing ``--batch_size``,
one a card, gloo ranks on the CPU, hosts by RCFD_COORDINATOR /
RCFD_NUM_PROCESSES / RCFD_PROCESS_ID). Refused: a batch size that it does
not divide, ``--device tpu``, an RCFD_TRAIN_DTYPE other than float32 and
bfloat16. ``--raw_cache_dirpath`` (or RCFD_RAW_CACHE)
turns on the decode-once raw cache of the loader (data/raw_cache.py): the
first epoch decodes every file and caches its raw array, later epochs map
it. RCFD_TRAIN_DTYPE=bfloat16
trains in mixed precision, as the JAX CLI does (radarnet_main.py says
what stays float32). RadarNet's PerfConfig comes from the
JAX package's gates RCFD_PALLAS_SCATTER, RCFD_FUSED_POOL2,
RCFD_FUSED_POOL4 and RCFD_DECODE_CHUNKS (``nn.perf.perf_from_env``); they
act on validation, whose scatter is the kernel K1 on the card unless
RCFD_PALLAS_SCATTER says otherwise.
"""

from __future__ import annotations

import argparse

from . import radarnet_main
from .data import raw_cache
from .nn.perf import perf_from_env

parser = argparse.ArgumentParser(
    prog='python -m rcfd_tpu_torch.train_radarnet')

parser.add_argument('--train_image_path', type=str, required=True)
parser.add_argument('--train_radar_path', type=str, required=True)
parser.add_argument('--train_ground_truth_path', type=str, required=True)
parser.add_argument('--val_image_path', type=str, required=True)
parser.add_argument('--val_radar_path', type=str, required=True)
parser.add_argument('--val_ground_truth_path', type=str, required=True)
# Batch settings
parser.add_argument('--batch_size', type=int, default=64)
parser.add_argument('--patch_size', nargs='+', type=int, default=[900, 288])
parser.add_argument('--total_points_sampled', type=int, default=4)
parser.add_argument('--sample_probability_lidar', type=float, default=0.0)
# Input settings
parser.add_argument('--input_channels_image', type=int, default=3)
parser.add_argument('--input_channels_depth', type=int, default=3)
parser.add_argument('--normalized_image_range', nargs='+', type=float,
                    default=[0, 1])
# Network settings
parser.add_argument('--encoder_type', nargs='+', type=str,
                    default=['radarnetv1', 'batch_norm'])
parser.add_argument('--n_filters_encoder_image', nargs='+', type=int,
                    default=[32, 64, 128, 128, 128])
parser.add_argument('--n_neurons_encoder_depth', nargs='+', type=int,
                    default=[32, 64, 128, 128, 128])
parser.add_argument('--decoder_type', nargs='+', type=str,
                    default=['multiscale', 'batch_norm'])
parser.add_argument('--n_filters_decoder', nargs='+', type=int,
                    default=[256, 128, 64, 32, 16])
# Weight settings
parser.add_argument('--weight_initializer', type=str, default='kaiming_uniform')
parser.add_argument('--activation_func', type=str, default='leaky_relu')
# Training settings
parser.add_argument('--learning_rates', nargs='+', type=float, default=[2e-4])
parser.add_argument('--learning_schedule', nargs='+', type=int, default=[200])
# Augmentation settings
parser.add_argument('--augmentation_probabilities', nargs='+', type=float,
                    default=[1.00])
parser.add_argument('--augmentation_schedule', nargs='+', type=int,
                    default=[-1])
parser.add_argument('--augmentation_random_brightness', nargs='+', type=float,
                    default=[-1, -1])
parser.add_argument('--augmentation_random_contrast', nargs='+', type=float,
                    default=[-1, -1])
parser.add_argument('--augmentation_random_saturation', nargs='+', type=float,
                    default=[-1, -1])
parser.add_argument('--augmentation_random_noise_type', type=str,
                    default='none')
parser.add_argument('--augmentation_random_noise_spread', type=float,
                    default=-1)
parser.add_argument('--augmentation_random_flip_type', nargs='+', type=str,
                    default=['none'])
# Loss settings
parser.add_argument('--w_weight_decay', type=float, default=0.0)
parser.add_argument('--w_positive_class', type=float, default=1.0)
parser.add_argument('--max_distance_correspondence', type=float, default=0.4)
parser.add_argument('--set_invalid_to_negative_class', action='store_true')
# Checkpoint settings
parser.add_argument('--checkpoint_dirpath', type=str, required=True)
parser.add_argument('--n_step_per_checkpoint', type=int, default=100)
parser.add_argument('--n_step_per_summary', type=int, default=100)
parser.add_argument('--start_step_validation', type=int, default=100)
parser.add_argument('--restore_path', type=str, default=None)
# Evaluation settings
parser.add_argument('--min_evaluate_depth', type=float, default=0)
parser.add_argument('--max_evaluate_depth', type=float, default=100)
# Hardware settings
parser.add_argument('--device', type=str, default='cuda')
parser.add_argument('--n_thread', type=int, default=10)
parser.add_argument('--n_data_parallel', type=int, default=None,
                    help='data-parallel ranks sharing --batch_size (one a '
                         'card; gloo ranks with --device cpu); default: '
                         'every visible card, 1 on the CPU')
parser.add_argument('--max_points_inference', type=int, default=0)
parser.add_argument('--eval_batch_size', type=int, default=1,
                    help='validation frames per dispatch (identical '
                         'metrics at any value)')
parser.add_argument('--seed', type=int, default=0)
parser.add_argument('--raw_cache_dirpath', type=str, default=None,
                    help='decode-once raw cache dir (mmap raw PNG '
                         'integers after the first epoch, ~16 MB/frame of '
                         'disk; see rcfd_tpu_torch/data/raw_cache.py)')


def main(argv=None, **train_kwargs):
    """Parse ``argv`` (sys.argv[1:] when None) and train; keyword arguments
    go to ``radarnet_main.train`` (``timings``). Returns the best
    validation results."""
    args = parser.parse_args(argv)
    kwargs = vars(args)
    raw_cache_dirpath = kwargs.pop('raw_cache_dirpath')
    kwargs['encoder_type'] = '-'.join(args.encoder_type)
    kwargs['decoder_type'] = '-'.join(args.decoder_type)
    kwargs['sample_probability_of_lidar'] = \
        kwargs.pop('sample_probability_lidar')
    kwargs['perf'] = perf_from_env()
    kwargs.update(train_kwargs)
    with raw_cache.raw_cache_for(raw_cache_dirpath):
        return radarnet_main.train(**kwargs)


if __name__ == '__main__':
    main()
