"""Inference dataset on the host (counterpart of the inference half of
rcfd_tpu/data/datasets.py): a camera frame, its radar points padded to a
static count with a validity mask, and the optional ground truth, as the
integer transport carries them.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from . import io as data_utils


def pad_points(points: np.ndarray, max_points: int):
    """Pad a ragged (N, 3) point set to (max_points, 3) + validity mask.

    If N > max_points the set is truncated WITH A LOUD WARNING: dropped
    radar returns silently change metrics against the reference, which
    processes all N points. Size max_points from the data
    (max_points_in_files) or raise --max_points_inference."""
    n = points.shape[0]
    if n > max_points:
        warnings.warn(
            'pad_points: truncating {} radar points to max_points={} — '
            'dropped returns change results vs the reference; size '
            'max_points from the manifest'.format(n, max_points),
            RuntimeWarning, stacklevel=2)
    out = np.zeros((max_points, 3), dtype=np.float32)
    valid = np.zeros((max_points,), dtype=bool)
    m = min(n, max_points)
    out[:m] = points[:m]
    valid[:m] = True
    return out, valid


def max_points_in_files(radar_paths) -> int:
    """Largest point count across radar .npy files, read from the npy
    headers only (no data I/O): sizes the static point axis so no frame is
    truncated."""
    best = 0
    for path in radar_paths:
        with open(path, 'rb') as f:
            version = np.lib.format.read_magic(f)
            if version >= (2, 0):
                shape, _, _ = np.lib.format.read_array_header_2_0(f)
            else:
                shape, _, _ = np.lib.format.read_array_header_1_0(f)
        n = shape[0] if len(shape) > 1 else 1
        best = max(best, int(n))
    return best


class RadarNetInferenceDataset:
    """Full image + all radar points (padded) + optional ground truth
    (reference src/datasets.py:274-343). ``get`` returns the integer
    transport: the image uint8 (H, W, 3), points float32 (max_points, 3),
    valid bool (max_points,), and the ground truth's raw uint16 (H, W, 1).
    JPEG frames decode on ``device`` (rcfd_tpu_torch/data/io.py)."""

    def __init__(self, image_paths, radar_paths, ground_truth_paths=None,
                 max_points: Optional[int] = 128, device=None):
        self.n_sample = len(image_paths)
        assert self.n_sample == len(radar_paths)
        self.image_paths = image_paths
        self.radar_paths = radar_paths
        self.device = device
        if max_points is None:
            # auto-size the static point axis from the manifest so no
            # frame is ever truncated (npy headers only; padded up to a
            # multiple of 8 for shape stability across runs)
            actual = max(max_points_in_files(radar_paths), 1)
            max_points = -(-actual // 8) * 8
        self.max_points = max_points
        if ground_truth_paths is not None and None not in ground_truth_paths:
            assert self.n_sample == len(ground_truth_paths)
            self.ground_truth_available = True
        else:
            self.ground_truth_available = False
        self.ground_truth_paths = ground_truth_paths

    def __len__(self):
        return self.n_sample

    def get(self, index: int):
        image = data_utils.load_image_u8(self.image_paths[index],
                                         device=self.device)
        radar_points = np.load(self.radar_paths[index]).astype(np.float32)
        if radar_points.ndim == 1:
            radar_points = np.expand_dims(radar_points, axis=0)
        points, valid = pad_points(radar_points, self.max_points)
        out = [image, points, valid]
        if self.ground_truth_available:
            out.append(data_utils.load_depth_u16(
                self.ground_truth_paths[index], data_format='HWC'))
        return tuple(out)
