"""CLI: run a trained legacy v0 model over a split on one card, writing
quasi-dense depth and response PNGs and pickled output manifests, the
port's counterpart of save_stage_1_depth.py (reference
src/save_stage_1_depth.py).

    python -m rcfd_tpu_torch.save_stage_1_depth --restore_path model.pth \\
        --path_to_pickle_file_gt_paths gt.pkl \\
        --path_to_pickle_file_radar_numpy_paths radar.pkl \\
        --image_dirpath samples/CAM_FRONT --output_dirpath out

It takes the JAX CLI's flags with the same defaults, plus ``--device``
(``cuda`` by default).
"""

from __future__ import annotations

import argparse

from . import legacy_main

parser = argparse.ArgumentParser(
    prog='python -m rcfd_tpu_torch.save_stage_1_depth')
parser.add_argument('--restore_path', type=str, required=True)
parser.add_argument('--path_to_pickle_file_gt_paths', type=str, required=True)
parser.add_argument('--path_to_pickle_file_radar_numpy_paths', type=str,
                    required=True)
parser.add_argument('--image_dirpath', type=str, required=True)
parser.add_argument('--output_dirpath', type=str, required=True)
parser.add_argument('--data_path', type=str, default='')
parser.add_argument('--patch_size', nargs='+', type=int, default=[900, 288])
parser.add_argument('--normalized_image_range', nargs='+', type=float,
                    default=[0, 1])
parser.add_argument('--max_points_inference', type=int, default=128)
parser.add_argument('--file_to_save_radar_output_paths', type=str,
                    default=None)
parser.add_argument('--file_to_save_radar_response_paths', type=str,
                    default=None)
parser.add_argument('--verbose', action='store_true')
parser.add_argument('--device', type=str, default='cuda')


def main(argv=None, **kwargs):
    """Parse ``argv`` (sys.argv[1:] when None) and write the outputs;
    keyword arguments go to ``legacy_main.save_stage_1`` (``seconds``).
    Returns (depth paths, response paths)."""
    args = vars(parser.parse_args(argv))
    args['patch_size'] = tuple(args['patch_size'])
    args.update(kwargs)
    return legacy_main.save_stage_1(**args)


if __name__ == '__main__':
    main()
