"""CLI: score saved legacy stage-1 quasi-dense depth maps against ground
truth, the port's counterpart of eval_stage_1_depth.py (reference
src/eval_stage_1_depth.py). On the host.

    python -m rcfd_tpu_torch.eval_stage_1_depth \\
        --path_to_pickle_file_output_paths out.pkl \\
        --path_to_pickle_file_gt_paths gt.pkl
"""

from __future__ import annotations

import argparse

from . import legacy_main

parser = argparse.ArgumentParser(
    prog='python -m rcfd_tpu_torch.eval_stage_1_depth')
parser.add_argument('--path_to_pickle_file_output_paths', type=str,
                    required=True)
parser.add_argument('--path_to_pickle_file_gt_paths', type=str, required=True)
parser.add_argument('--data_path', type=str, default='')
parser.add_argument('--min_evaluate_depth', type=float, default=0.0)
parser.add_argument('--max_evaluate_depth', type=float, default=100.0)


def main(argv=None):
    """Parse ``argv`` (sys.argv[1:] when None) and score; returns the
    metrics."""
    return legacy_main.eval_stage_1(**vars(parser.parse_args(argv)))


if __name__ == '__main__':
    main()
