"""Datasets on the host (counterpart of rcfd_tpu/data/datasets.py), as the
integer transport carries them: RadarNet's inference frames (a camera
frame, its radar points padded to a static count with a validity mask, the
optional ground truth), and FusionNet's training quintuples and inference
frames.

All randomness is the caller's numpy Generator: the loader keys one by
(seed, epoch, position) as the JAX package does, so the port's batches
equal the JAX package's bit for bit.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np

from . import io as data_utils


def random_crop(inputs, shape, crop_type=('none',), rng=None):
    """Joint crop of HWC inputs to ``shape`` (reference
    src/datasets.py:19-109, rcfd_tpu/data/datasets.py ``random_crop``, the
    same draws from ``rng``). crop_type: none, horizontal, vertical,
    anchored, top, bottom, left, right, center; 'vertical' applies with
    probability 0.3."""
    rng = rng or np.random.default_rng()
    n_height, n_width = shape
    o_height, o_width = inputs[0].shape[0], inputs[0].shape[1]
    d_height = o_height - n_height
    d_width = o_width - n_width
    y_start = d_height // 2
    x_start = d_width // 2

    if 'left' in crop_type:
        x_start = 0
    elif 'right' in crop_type:
        x_start = d_width
    elif 'horizontal' in crop_type:
        if 'anchored' in crop_type:
            widths = [0.0, 0.50 * d_width, 1.0 * d_width]
            x_start = int(widths[rng.integers(0, len(widths))])
        else:
            x_start = int(rng.integers(0, max(d_width, 1)))

    if 'top' in crop_type:
        y_start = 0
    elif 'bottom' in crop_type:
        y_start = d_height
    elif 'vertical' in crop_type and rng.random() <= 0.30:
        if 'anchored' in crop_type:
            heights = [0.0, 0.50 * d_height, 1.0 * d_height]
            y_start = int(heights[rng.integers(0, len(heights))])
        else:
            y_start = int(rng.integers(0, max(d_height, 1)))

    return [t[y_start:y_start + n_height, x_start:x_start + n_width, :]
            for t in inputs]


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


class FusionNetTrainingDataset:
    """Image, depth, response, interpolated ground truth and lidar map with
    a joint random crop (reference src/datasets.py:346-443). ``get``
    returns the integer transport: the image uint8 (h, w, 3) and the four
    streams as their raw 16-bit PNG integers (h, w, 1). The response is
    read through the x256 depth codec, as the reference reads it
    (src/datasets.py:412-415). JPEG frames decode on ``device``."""

    def __init__(self, image_paths, depth_paths, response_paths,
                 ground_truth_paths, lidar_map_paths,
                 shape: Optional[Tuple[int, int]] = None,
                 random_crop_type: Sequence[str] = ('none',), device=None):
        self.n_sample = len(image_paths)
        self.streams = (depth_paths, response_paths, ground_truth_paths,
                        lidar_map_paths)
        for paths in self.streams:
            assert len(paths) == self.n_sample
        self.image_paths = image_paths
        self.shape = shape
        self.do_random_crop = \
            shape is not None and all(x > 0 for x in shape)
        self.random_crop_type = tuple(random_crop_type)
        self.device = device

    def __len__(self):
        return self.n_sample

    def get(self, index: int, rng: np.random.Generator):
        sample = [data_utils.load_image_u8(self.image_paths[index],
                                           device=self.device)]
        sample += [data_utils.load_depth_u16(paths[index], data_format='HWC')
                   for paths in self.streams]
        if self.do_random_crop:
            sample = random_crop(sample, self.shape, self.random_crop_type,
                                 rng)
        return tuple(np.ascontiguousarray(t) for t in sample)


class FusionNetInferenceDataset:
    """Image, depth and response (and the optional ground truth) at full
    resolution (reference src/datasets.py:446-527), as integer transport:
    the image uint8 (H, W, 3), the streams raw uint16 (H, W, 1), the
    response read through the x256 codec."""

    def __init__(self, image_paths, depth_paths, response_paths,
                 ground_truth_paths=None, device=None):
        self.n_sample = len(image_paths)
        self.image_paths = image_paths
        self.depth_paths = depth_paths
        self.response_paths = response_paths
        self.ground_truth_available = ground_truth_paths is not None and \
            None not in ground_truth_paths
        if self.ground_truth_available:
            assert self.n_sample == len(ground_truth_paths)
        self.ground_truth_paths = ground_truth_paths
        self.device = device

    def __len__(self):
        return self.n_sample

    def get(self, index: int):
        out = [data_utils.load_image_u8(self.image_paths[index],
                                        device=self.device),
               data_utils.load_depth_u16(self.depth_paths[index],
                                         data_format='HWC'),
               data_utils.load_depth_u16(self.response_paths[index],
                                         data_format='HWC')]
        if self.ground_truth_available:
            out.append(data_utils.load_depth_u16(
                self.ground_truth_paths[index], data_format='HWC'))
        return tuple(out)
