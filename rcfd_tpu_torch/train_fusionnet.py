"""CLI: train FusionNet on one card or several, the port's counterpart of
train_fusionnet.py (reference src/train_fusionnet.py).

    python -m rcfd_tpu_torch.train_fusionnet --train_image_path ... \\
        --checkpoint_dirpath out [--restore_path latest]

It takes the JAX CLI's flags with the same defaults, plus ``--device``,
which defaults to ``cuda`` (``--device cpu`` trains on the CPU).
``--n_data_parallel N`` trains on N ranks that share ``--batch_size`` (one
a card; gloo ranks with ``--device cpu``; by default every visible card),
and across hosts under RCFD_COORDINATOR, RCFD_NUM_PROCESSES and
RCFD_PROCESS_ID (rcfd_tpu_torch/parallel/mesh.py); a batch size that N does
not divide is refused, as the JAX CLI asserts. ``--device tpu`` is refused,
as is an RCFD_TRAIN_DTYPE other than float32 and bfloat16.
``--raw_cache_dirpath``
(or RCFD_RAW_CACHE) turns on the decode-once raw cache of the loader
(data/raw_cache.py): the first epoch decodes every file and caches its raw
array, later epochs map it and crop before converting.
RCFD_TRAIN_DTYPE=bfloat16 trains in mixed precision, as the JAX CLI does
(fusionnet_main.py says what stays float32).
"""

from __future__ import annotations

import argparse

from . import fusionnet_main
from .data import raw_cache

parser = argparse.ArgumentParser(
    prog='python -m rcfd_tpu_torch.train_fusionnet')

# Training and validation input filepaths
parser.add_argument('--train_image_path', type=str, required=True)
parser.add_argument('--train_depth_path', type=str, required=True)
parser.add_argument('--train_response_path', type=str, required=True)
parser.add_argument('--train_ground_truth_path', type=str, required=True)
parser.add_argument('--train_lidar_map_path', type=str, required=True)
parser.add_argument('--val_image_path', type=str, required=True)
parser.add_argument('--val_depth_path', type=str, required=True)
parser.add_argument('--val_response_path', type=str, required=True)
parser.add_argument('--val_ground_truth_path', type=str, required=True)
# Batch settings
parser.add_argument('--batch_size', type=int, default=64)
parser.add_argument('--n_height', type=int, default=900)
parser.add_argument('--n_width', type=int, default=1600)
# Input settings
parser.add_argument('--input_channels_image', type=int, default=3)
parser.add_argument('--input_channels_depth', type=int, default=2)
parser.add_argument('--normalized_image_range', nargs='+', type=float,
                    default=[0, 1])
# Network settings
parser.add_argument('--encoder_type', nargs='+', type=str,
                    default=['fusionnet18', 'batch_norm'])
parser.add_argument('--n_filters_encoder_image', nargs='+', type=int,
                    default=[32, 64, 128, 256, 256, 256])
parser.add_argument('--n_filters_encoder_depth', nargs='+', type=int,
                    default=[16, 32, 64, 128, 128, 128])
parser.add_argument('--fusion_type', type=str, default='add')
parser.add_argument('--decoder_type', nargs='+', type=str,
                    default=['multiscale', 'batch_norm'])
parser.add_argument('--n_filters_decoder', nargs='+', type=int,
                    default=[256, 256, 128, 64, 64, 32])
parser.add_argument('--n_resolutions_decoder', type=int, default=0)
parser.add_argument('--min_predict_depth', type=float, default=0)
parser.add_argument('--max_predict_depth', type=float, default=100)
# Weight settings
parser.add_argument('--weight_initializer', type=str, default='kaiming_uniform')
parser.add_argument('--activation_func', type=str, default='leaky_relu')
# Training settings
parser.add_argument('--learning_rates', nargs='+', type=float,
                    default=[5e-4, 1e-4])
parser.add_argument('--learning_schedule', nargs='+', type=int,
                    default=[300, 450])
# Loss settings
parser.add_argument('--loss_func', type=str, default='l1')
parser.add_argument('--w_smoothness', type=float, default=0.0)
parser.add_argument('--w_lidar_loss', type=float, default=0.0)
parser.add_argument('--w_weight_decay', type=float, default=0.0)
parser.add_argument('--loss_smoothness_kernel_size', type=int, default=-1)
parser.add_argument('--outlier_removal_kernel_size', type=int, default=-1)
parser.add_argument('--outlier_removal_threshold', type=float, default=-1)
parser.add_argument('--ground_truth_dilation_kernel_size', type=int, default=-1)
# Augmentation settings
parser.add_argument('--augmentation_probabilities', nargs='+', type=float,
                    default=[1.00])
parser.add_argument('--augmentation_schedule', nargs='+', type=int,
                    default=[-1])
parser.add_argument('--augmentation_random_crop_type', nargs='+', type=str,
                    default=['none'])
parser.add_argument('--augmentation_random_brightness', nargs='+', type=float,
                    default=[-1, -1])
parser.add_argument('--augmentation_random_contrast', nargs='+', type=float,
                    default=[-1, -1])
parser.add_argument('--augmentation_random_saturation', nargs='+', type=float,
                    default=[-1, -1])
parser.add_argument('--augmentation_random_flip_type', nargs='+', type=str,
                    default=['none'])
# Evaluation settings
parser.add_argument('--min_evaluate_depth', type=float, default=0)
parser.add_argument('--max_evaluate_depth', type=float, default=100)
# Checkpoint settings
parser.add_argument('--checkpoint_dirpath', type=str, required=True)
parser.add_argument('--n_step_per_checkpoint', type=int, default=100)
parser.add_argument('--n_step_per_summary', type=int, default=100)
parser.add_argument('--start_step_validation', type=int, default=100)
parser.add_argument('--restore_path', type=str, default=None)
# Hardware settings
parser.add_argument('--device', type=str, default='cuda')
parser.add_argument('--n_thread', type=int, default=10)
parser.add_argument('--n_data_parallel', type=int, default=None,
                    help='data-parallel ranks sharing --batch_size (one a '
                         'card; gloo ranks with --device cpu); default: '
                         'every visible card, 1 on the CPU')
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
    go to ``fusionnet_main.train`` (``timings``). Returns the best
    validation results."""
    args = parser.parse_args(argv)
    kwargs = vars(args)
    raw_cache_dirpath = kwargs.pop('raw_cache_dirpath')
    kwargs['encoder_type'] = '-'.join(args.encoder_type)
    kwargs['decoder_type'] = '-'.join(args.decoder_type)
    kwargs['n_resolutions_decoder'] = max(args.n_resolutions_decoder, 1)
    kwargs.update(train_kwargs)
    with raw_cache.raw_cache_for(raw_cache_dirpath):
        return fusionnet_main.train(**kwargs)


if __name__ == '__main__':
    main()
