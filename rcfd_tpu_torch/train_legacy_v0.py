"""CLI: train the legacy v0 single-point correspondence model on one card,
the port's counterpart of train_legacy_v0.py (reference src/train.py ->
src/main.py:26-505).

    python -m rcfd_tpu_torch.train_legacy_v0 \\
        --path_to_pickle_file_gt_train_paths gt_train.pkl \\
        --path_to_pickle_file_radar_train_numpys radar_train.pkl \\
        --path_to_pickle_file_gt_val_paths gt_val.pkl \\
        --path_to_pickle_file_radar_val_numpys radar_val.pkl \\
        --image_path samples/CAM_FRONT --checkpoint_dirpath out

It takes the JAX CLI's flags with the same defaults, plus ``--device``,
which defaults to ``cuda`` (``--device cpu`` trains on the CPU).
"""

from __future__ import annotations

import argparse

from . import legacy_main


def add_training_flags(parser, batch_size=6, patch_size=(900, 288),
                       learning_rates=(2e-4,), learning_schedule=(200,),
                       augmentation_random_noise_spread=-1.0,
                       w_smoothness=0.0, kernel_size_smoothness=(7, 7)):
    """The flags the v0 training CLIs share after their manifest flags,
    with each CLI's own defaults."""
    parser.add_argument('--data_path', type=str, default='')
    parser.add_argument('--image_path', type=str, required=True)
    parser.add_argument('--epsilon', type=float, default=0.4)
    # Input settings
    parser.add_argument('--batch_size', type=int, default=batch_size)
    parser.add_argument('--patch_size', nargs='+', type=int,
                        default=list(patch_size))
    parser.add_argument('--normalized_image_range', nargs='+', type=float,
                        default=[0, 1])
    # Training settings
    parser.add_argument('--learning_rates', nargs='+', type=float,
                        default=list(learning_rates))
    parser.add_argument('--learning_schedule', nargs='+', type=int,
                        default=list(learning_schedule))
    parser.add_argument('--augmentation_probabilities', nargs='+',
                        type=float, default=[1.0])
    parser.add_argument('--augmentation_schedule', nargs='+', type=int,
                        default=[-1])
    parser.add_argument('--augmentation_random_brightness', nargs='+',
                        type=float, default=[-1, -1])
    parser.add_argument('--augmentation_random_noise_type', type=str,
                        default='none')
    parser.add_argument('--augmentation_random_noise_spread', type=float,
                        default=augmentation_random_noise_spread)
    parser.add_argument('--augmentation_random_flip_type', nargs='+',
                        type=str, default=['none'])
    # Loss settings
    parser.add_argument('--w_cross_entropy', type=float, default=1.0)
    parser.add_argument('--w_smoothness', type=float, default=w_smoothness)
    parser.add_argument('--w_weight_decay', type=float, default=0.0)
    parser.add_argument('--kernel_size_smoothness', nargs='+', type=int,
                        default=list(kernel_size_smoothness))
    parser.add_argument('--set_invalid_to_negative', action='store_true')
    parser.add_argument('--w_positive_class', type=float, default=1.0)
    # Checkpoint settings
    parser.add_argument('--checkpoint_dirpath', type=str, required=True)
    parser.add_argument('--num_step_per_checkpoint', type=int, default=5000)
    parser.add_argument('--num_step_per_summary', type=int, default=1000)
    parser.add_argument('--start_step_validation', type=int, default=5000)
    parser.add_argument('--restore_path', type=str, default=None)
    parser.add_argument('--min_evaluate_depth', type=float, default=0)
    parser.add_argument('--max_evaluate_depth', type=float, default=100)
    parser.add_argument('--max_points_inference', type=int, default=128)
    # Hardware and debugging
    parser.add_argument('--debug', action='store_true')
    parser.add_argument('--num_workers', type=int, default=10)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default='cuda')


parser = argparse.ArgumentParser(
    prog='python -m rcfd_tpu_torch.train_legacy_v0')
parser.add_argument('--path_to_pickle_file_gt_train_paths', type=str,
                    required=True)
parser.add_argument('--path_to_pickle_file_radar_train_numpys', type=str,
                    required=True)
parser.add_argument('--path_to_pickle_file_gt_val_paths', type=str,
                    required=True)
parser.add_argument('--path_to_pickle_file_radar_val_numpys', type=str,
                    required=True)
add_training_flags(parser)


def main(argv=None, **train_kwargs):
    """Parse ``argv`` (sys.argv[1:] when None) and train; keyword arguments
    go to ``legacy_main.train`` (``timings``, ``seconds``). Returns the
    best validation results."""
    kwargs = vars(parser.parse_args(argv))
    kwargs.update(train_kwargs)
    return legacy_main.train(**kwargs)


if __name__ == '__main__':
    main()
