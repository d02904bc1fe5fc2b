"""Batched image transforms on the device (counterpart of
rcfd_tpu/data/transforms.py ``Transforms``): the integer-cast emulation of
[0, 255] images and normalization (``transform``, the inference path), and
the training augmentations, split into their random draws (``draws``) and
a deterministic ``apply`` of them.

``draws(generator, n_batch, p)`` takes every random number of a batch from
an explicit torch.Generator; ``apply(draws, images, range_maps)`` and
``noise_points(draws, points)`` are pure functions of them, so the tests
hold them to the JAX package value for value by feeding them the draws that
JAX's key sequence gives. The augmentations: per-sample gates
(Bernoulli(p) AND Bernoulli(0.5)) for brightness, contrast and saturation
with uniform factors, for gaussian or uniform noise of the radar points,
and horizontal and vertical flips of images and range or label maps
(bounding boxes with their fix-up; the points are not flipped, as in the
reference, which never updates them on a flip). As in the
reference, an image with intensities above 1 is truncated to integers
before the photometric ops, and each op clips to [0, int32 max] and
truncates again (torchvision's _blend on an int image); a [0, 1] image
clips to [0, 1].
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

_INT32_MAX = 2147483647.0
PHOTOMETRIC = ('brightness', 'contrast', 'saturation')


def _rgb_to_grayscale(images, truncate):
    gray = (images[..., 0] * 0.2989 + images[..., 1] * 0.587 +
            images[..., 2] * 0.114)[..., None]
    return torch.where(truncate, torch.floor(gray), gray)


def _blend(img1, img2, ratio, truncate, bound):
    out = ratio * img1 + (1.0 - ratio) * img2
    out = torch.minimum(torch.clamp_min(out, 0.0), bound)
    return torch.where(truncate, torch.floor(out), out)


class Transforms:
    """The JAX package's transform pipeline (images NHWC; range maps NHWC
    or label maps (B, K, h, w, C); radar points (B, K, 3); boxes
    (B, K, 4)). Ranges of -1 turn an augmentation off, as do noise type
    'none' or a spread of -1."""

    def __init__(self, normalized_image_range=(0, 255),
                 random_brightness=(-1,), random_contrast=(-1,),
                 random_saturation=(-1,), random_noise_type: str = 'none',
                 random_noise_spread: float = -1,
                 random_flip_type: Sequence[str] = ('none',)):
        self.normalized_image_range = list(normalized_image_range)
        if self.normalized_image_range not in ([0, 1], [-1, 1], [0, 255]):
            raise ValueError('Unsupported normalization range: {}'.format(
                self.normalized_image_range))
        self.ranges = {}
        for name, r in zip(PHOTOMETRIC, (random_brightness, random_contrast,
                                         random_saturation)):
            if -1 not in r:
                self.ranges[name] = (float(r[0]), float(r[1]))
        self.do_random_noise = (random_noise_type != 'none' and
                                random_noise_spread > -1)
        if self.do_random_noise and \
                random_noise_type not in ('gaussian', 'uniform'):
            raise ValueError('Unsupported noise type: {}'.format(
                random_noise_type))
        self.random_noise_type = random_noise_type
        self.random_noise_spread = random_noise_spread
        self.do_random_horizontal_flip = 'horizontal' in random_flip_type
        self.do_random_vertical_flip = 'vertical' in random_flip_type

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

    # -- training augmentation -----------------------------------------------

    def draws(self, generator: torch.Generator, n_batch: int,
              random_transform_probability: float,
              points_shape: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
        """Every random number of one batch's augmentation, drawn from
        ``generator`` on its device in a fixed order: per sample, the
        transform gate (uniform <= p), then for each photometric op a gate
        (uniform <= 0.5, and the transform gate) and a factor (uniform in
        its range), then, where there is point noise and ``points_shape``
        (B, K, 3) is given, its gate (uniform <= 0.5, and the transform
        gate) and the noise of every coordinate (spread x a standard
        normal, or spread x (uniform - 0.5)), then the horizontal and
        vertical flip gates (uniform <= 0.5, and the transform gate). Ops
        that are off draw nothing."""
        def uniform(shape=(n_batch,)):
            return torch.rand(shape, generator=generator,
                              device=generator.device)

        do_transform = uniform() <= random_transform_probability
        out = {}
        for name, (lo, hi) in self.ranges.items():
            out[name + '_gate'] = do_transform & (uniform() <= 0.5)
            out[name + '_factor'] = (hi - lo) * uniform() + lo
        if self.do_random_noise and len(points_shape):
            out['noise_gate'] = do_transform & (uniform() <= 0.5)
            if self.random_noise_type == 'gaussian':
                noise = torch.randn(tuple(points_shape), generator=generator,
                                    device=generator.device)
            else:
                noise = uniform(tuple(points_shape)) - 0.5
            out['points_noise'] = self.random_noise_spread * noise
        if self.do_random_horizontal_flip:
            out['horizontal_flip'] = do_transform & (uniform() <= 0.5)
        if self.do_random_vertical_flip:
            out['vertical_flip'] = do_transform & (uniform() <= 0.5)
        return out

    def apply(self, draws: Dict[str, torch.Tensor], images,
              range_maps: Sequence = (), bounding_boxes: Sequence = ()):
        """Augment one batch with ``draws``: images (B, H, W, 3) in [0,
        255] (or [0, 1]) get the photometric ops and normalization, then
        images, range maps (B, H, W, C) or label maps (B, K, h, w, C) and
        boxes (B, K, 4) as (x0, y0, x1, y1) the flips (maps along their
        last but one and last but two axes, boxes by the images' width and
        height). Returns (images, [maps], [boxes])."""
        n_height, n_width = images.shape[1], images.shape[2]
        truncate = images.max() > 1.0
        images = torch.where(truncate, torch.floor(images), images)
        bound = torch.where(truncate, _INT32_MAX, 1.0).to(images.dtype)
        for name in self.ranges:
            gate = draws[name + '_gate'][:, None, None, None]
            f = draws[name + '_factor'].to(images.dtype)[:, None, None, None]
            if name == 'brightness':
                other = torch.zeros_like(images)
            elif name == 'contrast':
                other = _rgb_to_grayscale(images, truncate).mean(
                    (1, 2, 3), keepdim=True)
            else:
                other = _rgb_to_grayscale(images, truncate)
            images = torch.where(gate, _blend(images, other, f, truncate,
                                              bound), images)
        images = self._normalize(images)
        range_maps, boxes = list(range_maps), list(bounding_boxes)

        def flip(arrays, gate, dim):
            return [torch.where(gate.reshape((-1,) + (1,) * (a.dim() - 1)),
                                a.flip(dim), a) for a in arrays]

        if 'horizontal_flip' in draws:
            gate = draws['horizontal_flip']
            images, = flip([images], gate, -2)
            range_maps = flip(range_maps, gate, -2)
            boxes = [torch.where(gate[:, None, None], torch.stack(
                [n_width - b[..., 2], b[..., 1], n_width - b[..., 0],
                 b[..., 3]], -1), b) for b in boxes]
        if 'vertical_flip' in draws:
            gate = draws['vertical_flip']
            images, = flip([images], gate, -3)
            range_maps = flip(range_maps, gate, -3)
            boxes = [torch.where(gate[:, None, None], torch.stack(
                [b[..., 0], n_height - b[..., 3], b[..., 2],
                 n_height - b[..., 1]], -1), b) for b in boxes]
        return images, range_maps, boxes

    def noise_points(self, draws: Dict[str, torch.Tensor], points):
        """Points (B, K, 3) plus the drawn noise where its gate is open;
        the points themselves without point noise."""
        if 'points_noise' not in draws:
            return points
        gate = draws['noise_gate'][:, None, None]
        return torch.where(gate, points + draws['points_noise'].to(
            points.dtype), points)
