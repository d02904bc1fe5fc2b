"""Inference-time image transform (counterpart of the inference path of
rcfd_tpu/data/transforms.py ``Transforms.transform`` with
``random_transform_probability=0``): the integer-cast emulation of
[0, 255] images followed by normalization. The augmentations wait for the
training slice."""

from __future__ import annotations

import torch


class Transforms:

    def __init__(self, normalized_image_range=(0, 255)):
        self.normalized_image_range = list(normalized_image_range)
        if self.normalized_image_range not in ([0, 1], [-1, 1], [0, 255]):
            raise ValueError('Unsupported normalization range: {}'.format(
                self.normalized_image_range))

    def _normalize(self, images):
        r = self.normalized_image_range
        if r == [0, 1]:
            return images / 255.0
        if r == [-1, 1]:
            return 2.0 * (images / 255.0) - 1.0
        return images

    def transform(self, images):
        """images: float tensor in [0, 255] (or [0, 1]). Intensities above
        1 are floored first, as the reference casts them to int."""
        images = torch.where(images.max() > 1.0, torch.floor(images), images)
        return self._normalize(images)
