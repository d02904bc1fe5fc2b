"""The legacy v0 pipeline's pickle-manifest datasets (counterpart of
rcfd_tpu/data/legacy_datasets.py; reference src/dataset.py).

The v0 experiment contract is a set of pickled path lists (written by
setup/data_gen.py) instead of newline manifests, with each camera image
found by the ground truth's basename inside a flat nuScenes CAM_FRONT
directory (reference src/dataset.py:34-45).

``get`` returns the integer transport, as the port's other datasets: the
image uint8 (H, W, 3) and the ground truth's raw 16-bit PNG integers
(H, W, 1), which ``transport.decode`` turns into the JAX package's float32
values exactly. JPEG frames decode on ``device`` (data/io.py).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence

import numpy as np

from . import io as data_utils
from .datasets import pad_points


def load_pickle_paths(path: str):
    """Read a pickled path list (the v0 manifest format)."""
    with open(path, 'rb') as f:
        return pickle.load(f)


def save_pickle_paths(path: str, paths: Sequence[str]):
    with open(path, 'wb') as f:
        pickle.dump(list(paths), f)


def _image_path_for(gt_path: str, image_dirpath: str) -> str:
    """gt .../TOKEN.png -> image_dir/TOKEN.jpg (src/dataset.py:37-45), or
    .png when the .jpg does not exist."""
    name = os.path.splitext(os.path.basename(gt_path))[0]
    jpg = os.path.join(image_dirpath, name + '.jpg')
    if os.path.exists(jpg):
        return jpg
    return os.path.join(image_dirpath, name + '.png')


def _radar_points(path: str) -> np.ndarray:
    radar_points = np.load(path).astype(np.float32)
    if radar_points.ndim == 1:
        radar_points = radar_points[None]
    return radar_points


class BinaryClassificationDataset:
    """Training: the full image, ONE radar point drawn from the loader's
    Generator, and the full ground truth (reference src/dataset.py:54-146).
    The point-centred crop happens in the train step
    (legacy_main.TrainStep)."""

    def __init__(self, ground_truth_paths, radar_points_paths,
                 image_dirpath: str, data_dirpath: str = '', device=None):
        assert len(ground_truth_paths) == len(radar_points_paths)
        self.n_sample = len(ground_truth_paths)
        self.ground_truth_paths = ground_truth_paths
        self.radar_points_paths = radar_points_paths
        self.image_dirpath = image_dirpath
        self.data_dirpath = data_dirpath
        self.device = device

    def __len__(self):
        return self.n_sample

    def _paths(self, index: int):
        gt_path = os.path.join(self.data_dirpath,
                               self.ground_truth_paths[index])
        radar_path = os.path.join(self.data_dirpath,
                                  self.radar_points_paths[index])
        return gt_path, radar_path

    def _image(self, gt_path: str):
        return data_utils.load_image_u8(
            _image_path_for(gt_path, self.image_dirpath), device=self.device)

    def get(self, index: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        gt_path, radar_path = self._paths(index)
        image = self._image(gt_path)
        radar_points = _radar_points(radar_path)
        point = radar_points[int(rng.integers(0, radar_points.shape[0]))]
        ground_truth = data_utils.load_depth_u16(gt_path, data_format='HWC')
        return image, point.astype(np.float32), ground_truth


class BinaryClassificationDatasetVal(BinaryClassificationDataset):
    """Validation: the full image, ALL radar points padded to
    ``max_points`` with a validity mask, and the ground truth (reference
    src/dataset.py:147-219)."""

    def __init__(self, ground_truth_paths, radar_points_paths,
                 image_dirpath: str, data_dirpath: str = '',
                 max_points: int = 128, device=None):
        super().__init__(ground_truth_paths, radar_points_paths,
                         image_dirpath, data_dirpath, device)
        self.max_points = max_points

    def get(self, index: int, rng=None):
        gt_path, radar_path = self._paths(index)
        image = self._image(gt_path)
        points, valid = pad_points(_radar_points(radar_path),
                                   self.max_points)
        ground_truth = data_utils.load_depth_u16(gt_path, data_format='HWC')
        return image, points, valid, ground_truth


class SaveStage1OutputDataset(BinaryClassificationDatasetVal):
    """The stage-1 writer's dataset: the validation tuple and the frame's
    name, the ground truth's basename without its extension (reference
    src/dataset.py:10-51)."""

    def get(self, index: int, rng=None):
        out = super().get(index, rng)
        gt_path, _ = self._paths(index)
        name = os.path.splitext(os.path.basename(gt_path))[0]
        return out + (name,)
