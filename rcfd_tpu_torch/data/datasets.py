"""Datasets on the host (counterpart of rcfd_tpu/data/datasets.py), as the
integer transport carries them: RadarNet's training samples (an edge-padded
frame's bottom rows, K sampled radar points, their boxes and ground-truth
crops) and inference frames (a camera frame, its radar points padded to a
static count with a validity mask, the optional ground truth), and
FusionNet's training quintuples and inference frames.

All randomness is the caller's numpy Generator: the loader keys one by
(seed, epoch, position) as the JAX package does, so the port's batches
equal the JAX package's bit for bit.

Every reader goes through data/io.py, so the decode-once raw cache
(data/raw_cache.py) serves all of them when it is on; FusionNet's
training samples crop the raw arrays before converting.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np

from . import io as data_utils
from .transport import encode_png_int


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


class RadarNetTrainingDataset:
    """Per sample: the image edge-padded by ``patch_w // 2`` columns each
    side and cut to its bottom ``patch_h`` rows, K sampled radar points
    with x shifted by the pad, their full-height boxes and ground-truth
    crops (reference src/datasets.py:112-271, rcfd_tpu/data/datasets.py
    ``RadarNetTrainingDataset``; ``get`` draws from ``rng`` what the JAX
    package's ``get`` draws, in the same order).

    ``get`` returns (image (ph, W + 2 pad, 3), points (K, 3) float32,
    boxes (K, 4) float32 as (x1, 0, x1 + patch_w, ph), ground truth
    (K, ph, patch_w, 1)); under integer transport (the default) the image
    is uint8 and the crops the raw uint16 PNG integers, else both float32.
    JPEG frames decode on ``device`` (rcfd_tpu_torch/data/io.py)."""

    def __init__(self, image_paths, radar_paths, ground_truth_paths,
                 patch_size: Tuple[int, int], total_points_sampled: int,
                 sample_probability_of_lidar: float, transport: bool = True,
                 device=None):
        self.n_sample = len(image_paths)
        assert self.n_sample == len(ground_truth_paths)
        assert self.n_sample == len(radar_paths)
        self.image_paths = image_paths
        self.radar_paths = radar_paths
        self.ground_truth_paths = ground_truth_paths
        self.patch_size = tuple(patch_size)
        self.pad_size_x = patch_size[1] // 2
        self.total_points_sampled = total_points_sampled
        self.sample_probability_of_lidar = sample_probability_of_lidar
        self.transport = transport
        self.device = device

    def __len__(self):
        return self.n_sample

    def get(self, index: int, rng: np.random.Generator):
        if self.transport:
            image = data_utils.load_image_u8(self.image_paths[index],
                                             device=self.device)
            ground_truth = data_utils.load_depth_u16(
                self.ground_truth_paths[index], data_format='HWC')
        else:
            image = data_utils.load_image(self.image_paths[index],
                                          device=self.device)
            ground_truth = data_utils.load_depth(
                self.ground_truth_paths[index], data_format='HWC')
        return self._assemble(index, rng, image, ground_truth)

    def _sample_points(self, index: int, rng: np.random.Generator,
                       gt2d) -> np.ndarray:
        """K radar points of the frame (a set of at most K points repeated
        100 times first), replaced with probability
        ``sample_probability_of_lidar`` by K fake points at ground-truth
        pixels beyond 1 m: x plus N(0, 25) noise, clipped to [0, W] and
        truncated, z plus U(0, 0.4), y the radar point's on purpose
        (reference src/datasets.py:216)."""
        k = self.total_points_sampled
        radar_points = np.load(self.radar_paths[index])
        if radar_points.ndim == 1:
            radar_points = np.expand_dims(radar_points, axis=0)
        if radar_points.shape[0] <= k:
            radar_points = np.repeat(radar_points, 100, axis=0)
        radar_points = radar_points[rng.integers(radar_points.shape[0],
                                                 size=k), :].astype(np.float32)
        if rng.random() < self.sample_probability_of_lidar:
            # under integer transport gt2d holds raw x256 integers: more
            # than 1 m is more than 256, and meters are raw / 256 exactly
            gt_is_raw = gt2d.dtype != np.float32
            idx_y, idx_x = np.where(gt2d > (256 if gt_is_raw else 1))
            if len(idx_y) >= k:
                sel = rng.choice(len(idx_y), size=k, replace=False)
                points_x, points_y = idx_x[sel], idx_y[sel]
                points_z = gt2d[points_y, points_x]
                if gt_is_raw:
                    points_z = points_z.astype(np.float32) / np.float32(256.0)
                noise_x = rng.normal(0, 25, k)
                noise_z = rng.uniform(0.0, 0.4, k)
                fake = np.copy(radar_points)
                fake[:, 0] = np.clip(points_x + noise_x, 0, gt2d.shape[1])
                fake[:, 2] = points_z + noise_z
                fake[:, 0] = fake[:, 0].astype(int)
                fake[:, 1] = fake[:, 1].astype(int)
                radar_points = fake
        return radar_points

    def _assemble(self, index: int, rng: np.random.Generator, image,
                  ground_truth):
        pad = self.pad_size_x
        ph = self.patch_size[0]
        image = np.pad(image, ((0, 0), (pad, pad), (0, 0)), mode='edge')
        radar_points = self._sample_points(index, rng, ground_truth[..., 0])
        # x shifted by the pad; full-height boxes of the patch's width
        radar_points[:, 0] = radar_points[:, 0] + pad
        x1 = radar_points[:, 0] - pad
        bboxes = np.stack([x1, np.zeros_like(x1), radar_points[:, 0] + pad,
                           np.full_like(x1, ph)], axis=1).astype(np.float32)
        ground_truth = np.pad(ground_truth, ((0, 0), (pad, pad), (0, 0)),
                              mode='constant')
        start_y = image.shape[0] - ph
        crops = np.stack([
            ground_truth[start_y:, int(x - pad):int(x + pad), :]
            for x in radar_points[:, 0]])                  # (K, ph, pw, 1)
        image = np.ascontiguousarray(image[start_y:])
        if not self.transport:
            image, crops = image.astype(np.float32), crops.astype(np.float32)
        return (image, radar_points.astype(np.float32), bboxes,
                np.ascontiguousarray(crops))


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
        """The sample of ``index``: the raw arrays (mapped ones when the raw
        cache is on) cropped first, then only the window converted, as
        rcfd_tpu/data/datasets.py ``_get_raw_window`` does with the cache.
        The crop reads only the shapes and ``rng``, and the conversion is
        elementwise, so the window equals the crop of the converted
        frame."""
        raws = [data_utils.load_image_raw(self.image_paths[index],
                                          device=self.device)]
        raws += [data_utils.load_depth_raw(paths[index])[..., None]
                 for paths in self.streams]
        if self.do_random_crop:
            raws = random_crop(raws, self.shape, self.random_crop_type, rng)
        return (np.ascontiguousarray(raws[0]),
                *[np.ascontiguousarray(encode_png_int(w)) for w in raws[1:]])


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
