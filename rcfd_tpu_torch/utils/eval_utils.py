"""Evaluation metrics (counterpart of rcfd_tpu/utils/eval_utils.py,
reference src/eval_utils.py:17-85).

MAE/RMSE are reported in millimeters (callers pass values x1000);
iMAE/iRMSE in 1/km (callers pass values x0.001).
"""

from __future__ import annotations

import numpy as np


def root_mean_sq_err(src, tgt):
    return np.sqrt(np.mean((tgt - src) ** 2))


def mean_abs_err(src, tgt):
    return np.mean(np.abs(tgt - src))


def inv_root_mean_sq_err(src, tgt):
    return np.sqrt(np.mean(((1.0 / tgt) - (1.0 / src)) ** 2))


def inv_mean_abs_err(src, tgt):
    return np.mean(np.abs((1.0 / tgt) - (1.0 / src)))


def compute_all(output_depth, ground_truth, min_evaluate_depth,
                max_evaluate_depth):
    """Masked MAE/RMSE/iMAE/iRMSE over gt > 0 within the (min, max) interval
    (the reference protocol: src/fusionnet_main.py:528-548)."""
    validity = ground_truth > 0
    min_max = np.logical_and(ground_truth > min_evaluate_depth,
                             ground_truth < max_evaluate_depth)
    mask = np.logical_and(validity, min_max)
    out = output_depth[mask]
    gt = ground_truth[mask]
    return {
        'mae': mean_abs_err(1000.0 * out, 1000.0 * gt),
        'rmse': root_mean_sq_err(1000.0 * out, 1000.0 * gt),
        'imae': inv_mean_abs_err(0.001 * out, 0.001 * gt),
        'irmse': inv_root_mean_sq_err(0.001 * out, 0.001 * gt),
    }
