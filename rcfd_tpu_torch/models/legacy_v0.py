"""The legacy v0 network and its plain functions (counterpart of
rcfd_tpu/models/legacy_v0.py; reference src/models.py, src/losses.py,
src/transforms.py, setup/data_gen_*.py).

- ``LegacyFusionNet``: a 5-stage encoder of tall 17x3 kernels (every stage
  stride (2, 2)), an MLP radar branch of Linear + BatchNorm1d + leaky ReLU
  whose output is reshaped to the latent grid, a VOICED-style decoder whose
  output at 1/2 scale is upsampled x2 (nearest), and the logit bias
  (``logits - bias_factor``). Its widths are fixed, as in the JAX package.
  NCHW.
- ``BatchNorm1d``: the JAX package's formula (variance E[x^2] - mean^2; the
  running variance moves by n / (n - 1) times it), in plain PyTorch.
- The plain functions, NHWC where they are held against the JAX package:
  LoG kernels, the point-centred crop (its window start taken as JAX's
  ``dynamic_slice`` takes it: a negative start from the end, then clamped
  into the padded frame), the 3-class labels,
  and the radius registration of radar to lidar points with the
  reorganization of the matches.

Registration is one dense distance matrix, as in the JAX package, made of
separate float32 passes (subtract, square, add, sqrt, compare) chunked
over the radar points: never ``torch.cdist`` or a matrix product, whose
expansion |a|^2 + |b|^2 - 2ab (and TF32 on the card) would move the
``<= radius`` decisions. The same passes on the card and the CPU give the
JAX package's numpy result bit for bit.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ..nn import functional as F
from ..nn.layers import Conv2d, DecoderBlock, FullyConnected, UpConv2d

# radar rows of one registration chunk: a chunk's distance matrix holds at
# most this many rows times the lidar points, float32
REGISTRATION_CHUNK = 256


# ---------------------------------------------------------------------------
# v0 network
# ---------------------------------------------------------------------------

class LegacyResNetBlock(nn.Module):
    """Basic residual block with rectangular kernels and per-dimension
    strides (rcfd_tpu/models/legacy_v0.py:40). The 1x1 projection always
    exists and applies when the shape changes."""

    def __init__(self, in_channels, out_channels, kernel_size=(17, 3),
                 stride=(1, 1), weight_initializer='kaiming_uniform',
                 activation_func='leaky_relu', use_batch_norm=False):
        super().__init__()
        act = F.activation_fn(activation_func)
        self.activation = act
        self.use_projection = (tuple(stride) != (1, 1)) or \
            (in_channels != out_channels)
        self.conv1 = Conv2d(in_channels, out_channels, tuple(kernel_size),
                            tuple(stride), weight_initializer, act,
                            use_batch_norm)
        self.conv2 = Conv2d(out_channels, out_channels, tuple(kernel_size),
                            (1, 1), weight_initializer, act, use_batch_norm)
        self.projection = Conv2d(in_channels, out_channels, 1, tuple(stride),
                                 weight_initializer, None, False)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        shortcut = self.projection(x) if self.use_projection else x
        return self.activation(y + shortcut)


class LegacyResNetEncoder(nn.Module):
    """5-stage encoder with tall 17x3 kernels, every stage stride (2, 2)
    (rcfd_tpu/models/legacy_v0.py:79). Returns (latent, skips): the last
    stage's output and the four before it."""

    def __init__(self, input_channels=3,
                 n_filters=(32, 64, 128, 128, 128),
                 weight_initializer='kaiming_uniform',
                 activation_func='leaky_relu', use_batch_norm=True):
        super().__init__()
        act = F.activation_fn(activation_func)
        n_filters = list(n_filters)
        self.conv1 = Conv2d(input_channels, n_filters[0], (17, 3), (2, 2),
                            weight_initializer, act, use_batch_norm)
        for i in range(4):
            in_ch, out_ch = n_filters[i], n_filters[i + 1]
            self.add_module('blocks{}'.format(i + 2), nn.Sequential(*[
                LegacyResNetBlock(in_ch if n == 0 else out_ch, out_ch,
                                  (17, 3), (2, 2) if n == 0 else (1, 1),
                                  weight_initializer, act, use_batch_norm)
                for n in range(2)]))

    def forward(self, x):
        layers = [self.conv1(x)]
        for i in range(2, 6):
            layers.append(getattr(self, 'blocks{}'.format(i))(layers[-1]))
        return layers[-1], layers[:-1]


class BatchNorm1d(nn.Module):
    """Feature batch norm of the radar branch, eps 1e-5, momentum 0.1
    (rcfd_tpu/models/legacy_v0.py:122), with the JAX package's formula: in
    training mode the batch mean and variance E[x^2] - mean^2, the running
    mean and variance moved toward them, the variance scaled by n / (n - 1);
    in eval mode the running statistics."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.register_buffer('num_batches_tracked',
                             torch.zeros((), dtype=torch.long))

    def forward(self, x):
        if self.training:
            mean = x.mean(0)
            var = (x * x).mean(0) - mean * mean
            n = x.shape[0]
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
                self.running_var.copy_(0.9 * self.running_var +
                                       0.1 * var * (n / max(n - 1, 1)))
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + 1e-5)
        return (x - mean) * inv * self.weight + self.bias


class LegacyRadarBranch(nn.Module):
    """Linear + BatchNorm1d + leaky ReLU (0.1) MLP from a point's (x, y, z)
    to ``n_filters[-1] * n_outputs`` features
    (rcfd_tpu/models/legacy_v0.py:154)."""

    def __init__(self, n_filters=(32, 64, 128, 128), n_outputs=29 * 10,
                 radar_input_dim=3):
        super().__init__()
        dims = [radar_input_dim] + list(n_filters[:-1]) + \
            [n_filters[-1] * n_outputs]
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            self.add_module('linear{}'.format(i), FullyConnected(
                dims[i], dims[i + 1], activation_func=None))
            self.add_module('bn{}'.format(i), BatchNorm1d(dims[i + 1]))

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, 'linear{}'.format(i))(x)
            x = getattr(self, 'bn{}'.format(i))(x)
            x = F.leaky_relu(x, 0.1)
        return x


class LegacyVOICEDDecoder(nn.Module):
    """4-stage decoder; the output at 1/2 scale, then upsampled x2 nearest
    (rcfd_tpu/models/legacy_v0.py:193)."""

    def __init__(self, input_channels=256, output_channels=1,
                 n_filters=(256, 128, 64, 32), n_skips=(128, 128, 64, 32),
                 weight_initializer='kaiming_uniform',
                 activation_func='leaky_relu', output_func='linear',
                 use_batch_norm=True):
        super().__init__()
        act = F.activation_fn(activation_func)
        out_act = F.activation_fn(output_func)
        n_filters, n_skips = list(n_filters), list(n_skips)
        wi, bn = weight_initializer, use_batch_norm
        self.deconv4 = DecoderBlock(input_channels, n_skips[0], n_filters[0],
                                    wi, act, bn, 'up')
        self.deconv3 = DecoderBlock(n_filters[0], n_skips[1], n_filters[1],
                                    wi, act, bn, 'up')
        self.deconv2 = DecoderBlock(n_filters[1], n_skips[2], n_filters[2],
                                    wi, act, bn, 'up')
        self.deconv1 = UpConv2d(n_filters[2], n_filters[3], 3, wi, act, bn)
        self.output1 = Conv2d(n_skips[3] + n_filters[3], output_channels, 3,
                              1, wi, out_act, False)

    def forward(self, x, skips):
        y = self.deconv4(x, skip=skips[3])
        y = self.deconv3(y, skip=skips[2])
        y = self.deconv2(y, skip=skips[1])
        y = self.deconv1(y, skips[0].shape[2:])
        out = self.output1(torch.cat([y, skips[0]], dim=1))
        h, w = out.shape[2], out.shape[3]
        return F.resize_nearest(out, (2 * h, 2 * w))


class LegacyFusionNet(nn.Module):
    """The v0 FusionNet (rcfd_tpu/models/legacy_v0.py:250): per-point
    correspondence logits (N, 1, H, W) for images (N, 3, H, W) and one
    radar point (N, 3) each, minus ``bias_factor``. ``latent_hw`` is the
    encoder's output grid, (ceil(H / 32), ceil(W / 32))."""

    def __init__(self, bias_factor: float = 0.0, radar_input_dim: int = 3,
                 latent_hw: Tuple[int, int] = (29, 10)):
        super().__init__()
        self.bias_factor = bias_factor
        self.latent_hw = tuple(latent_hw)
        self.image_encoder = LegacyResNetEncoder(
            input_channels=3, n_filters=(32, 64, 128, 128, 128),
            use_batch_norm=True)
        self.radar_branch = LegacyRadarBranch(
            n_filters=(32, 64, 128, 128),
            n_outputs=latent_hw[0] * latent_hw[1],
            radar_input_dim=radar_input_dim)
        self.decoder = LegacyVOICEDDecoder(
            input_channels=256, output_channels=1,
            n_filters=(256, 128, 64, 32), n_skips=(128, 128, 64, 32),
            use_batch_norm=True)

    def forward(self, image, radar):
        latent, skips = self.image_encoder(image)
        h, w = self.latent_hw
        rfeat = self.radar_branch(radar).reshape(radar.shape[0], 128, h, w)
        logits = self.decoder(torch.cat([latent, rfeat], dim=1), skips)
        return logits - self.bias_factor


# ---------------------------------------------------------------------------
# LoG kernels (src/losses.py:7-16)
# ---------------------------------------------------------------------------

def log_kernel(sigma: float, x, y):
    """Laplacian of Gaussian at (x, y)."""
    r2 = x ** 2 + y ** 2
    return (-1.0 / (math.pi * sigma ** 4) * (1 - r2 / (2 * sigma ** 2)) *
            np.exp(-r2 / (2 * sigma ** 2)))


def log_kernel_discrete(sigma: float, n: int) -> np.ndarray:
    """n x n discrete LoG filter."""
    idx = np.arange(n) - (n - 1) / 2
    xx, yy = np.meshgrid(idx, idx, indexing='ij')
    return log_kernel(sigma, xx, yy).astype(np.float32)


# ---------------------------------------------------------------------------
# Point-centred crops (src/transforms.py:60-130)
# ---------------------------------------------------------------------------

def crop_windows(points, crop_width: int, padded_width: int):
    """Each point's window start in the frame padded by crop_width // 2 on
    both sides: int32(x + pad) - pad, as JAX's ``dynamic_slice`` takes it:
    a negative start counts from the end (start + padded_width), then the
    start is clamped into [0, padded_width - crop_width]. The sum rounds
    in float32, as JAX's does."""
    pad = crop_width // 2
    start = (points[:, 0] + pad).to(torch.int32) - pad
    start = torch.where(start < 0, start + padded_width, start)
    return start.clamp(0, padded_width - crop_width)


def gather_crops(maps, start, crop_height: int, crop_width: int,
                 fill=None):
    """Crops (N, crop_height, crop_width, C) of NHWC ``maps`` (N frames, or
    one frame that all N crops share, never copied N times): the bottom
    ``crop_height`` rows and the columns [start - pad, start - pad +
    crop_width) of the unpadded frame (pad = crop_width // 2), ``start``
    (N,) from ``crop_windows``. Columns off the frame take the frame's edge
    column (edge padding) when ``fill`` is None, else ``fill``."""
    pad = crop_width // 2
    h, w = maps.shape[1], maps.shape[2]
    top = max(h - crop_height, 0)
    cols = start.long()[:, None] - pad + torch.arange(
        crop_width, device=maps.device)
    rows = maps[:, top:top + crop_height]
    n, c = cols.shape[0], maps.shape[3]
    index = cols.clamp(0, w - 1)[:, None, :, None].expand(
        n, rows.shape[1], crop_width, c)
    crops = torch.gather(rows.expand(n, *rows.shape[1:]), 2, index)
    if fill is not None:
        inside = ((cols >= 0) & (cols < w))[:, None, :, None]
        crops = torch.where(inside, crops,
                            torch.full((), fill, dtype=crops.dtype,
                                       device=crops.device))
    return crops


def crop_image_to_shape_on_point(points, images, labels, crop_height: int,
                                 crop_width: int, label_fill: float = 2.0):
    """Per-sample point-centred crops (rcfd_tpu/models/legacy_v0.py:316):
    the width padded by w // 2 (the edge for images, ``label_fill``, the
    'invalid' class, for labels), the bottom crop_height rows and the
    crop_width columns at the point's column, and the point's x reset to
    the crop's centre column. The padded frames are never made: columns
    off the frame are read from its edge or filled.

    Arg(s): points (B, 3); images (B, H, W, C); labels (B, H, W, c)
    Returns (points', image crops (B, crop_h, crop_w, C), label crops)
    """
    pad = crop_width // 2
    start = crop_windows(points, crop_width, images.shape[2] + 2 * pad)
    image_crops = gather_crops(images, start, crop_height, crop_width)
    label_crops = gather_crops(labels, start, crop_height, crop_width,
                               fill=label_fill)
    points = points.clone()
    points[:, 0] = pad
    return points, image_crops, label_crops


# ---------------------------------------------------------------------------
# Labels and point registration (setup/data_gen_train.py:733-1183)
# ---------------------------------------------------------------------------

def three_class_labels(ground_truth_depth, radar_z,
                       max_distance_correspondence: float = 0.4,
                       invalid_fill: float = 2.0):
    """3-class correspondence labels over a ground-truth map: 1 = match
    (|gt - z| < tau), 0 = valid but no match, ``invalid_fill`` (2) = no
    ground truth (rcfd_tpu/models/legacy_v0.py:381)."""
    gt = ground_truth_depth
    one = torch.ones((), dtype=gt.dtype, device=gt.device)
    zero = torch.zeros((), dtype=gt.dtype, device=gt.device)
    labels = torch.where((gt - radar_z).abs() < max_distance_correspondence,
                         one, zero)
    return torch.where(gt > 0, labels,
                       torch.full((), invalid_fill, dtype=gt.dtype,
                                  device=gt.device))


def _features(x, z, z_scaling_factor, device):
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    z = torch.as_tensor(np.asarray(z, np.float32), device=device)
    return x, z * torch.tensor(z_scaling_factor, dtype=torch.float32,
                               device=device)


def _distances(rx, rz, lx, lz):
    """Distances (R, L) in float32, one pass at a time: the differences,
    their squares, the sum, the root (numpy's order)."""
    dx = rx[:, None] - lx[None, :]
    dz = rz[:, None] - lz[None, :]
    return torch.sqrt(dx * dx + dz * dz)


def register_points(lidar_x, lidar_z, radar_x, radar_z, radius: float = 0.4,
                    z_scaling_factor: float = 0.6, device='cpu'):
    """Per radar point, the index of the nearest lidar point within
    ``radius`` in the (x, z * w) plane, or -1, and its distance (inf when
    none) (rcfd_tpu/models/legacy_v0.py:356): numpy arrays. The first of
    equal distances wins, as argmin's."""
    lx, lz = _features(lidar_x, lidar_z, z_scaling_factor, device)
    rx, rz = _features(radar_x, radar_z, z_scaling_factor, device)
    radius = torch.tensor(radius, dtype=torch.float32, device=device)
    index, distance = [], []
    for i in range(0, rx.shape[0], REGISTRATION_CHUNK):
        d = _distances(rx[i:i + REGISTRATION_CHUNK],
                       rz[i:i + REGISTRATION_CHUNK], lx, lz)
        nearest_d, nearest = d.min(1)
        matched = nearest_d <= radius
        index.append(torch.where(matched, nearest, -1))
        distance.append(torch.where(matched, nearest_d,
                                    torch.full((), float('inf'),
                                               device=device)))
    if not index:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    return (torch.cat(index).cpu().numpy(),
            torch.cat(distance).cpu().numpy())


def register_points_radius(lidar_x, lidar_z, radar_x, radar_z,
                           radius: float = 0.4,
                           z_scaling_factor: float = 0.6,
                           device='cpu') -> List[np.ndarray]:
    """All lidar indices within ``radius`` of each radar point in the
    (x, z * w) plane (rcfd_tpu/models/legacy_v0.py:405), in ascending
    order: a list of int64 numpy arrays, one a radar point (possibly
    empty). The distances are computed on ``device`` in float32 passes,
    REGISTRATION_CHUNK radar points at a time."""
    lx, lz = _features(lidar_x, lidar_z, z_scaling_factor, device)
    rx, rz = _features(radar_x, radar_z, z_scaling_factor, device)
    radius = torch.tensor(radius, dtype=torch.float32, device=device)
    out = []
    for i in range(0, rx.shape[0], REGISTRATION_CHUNK):
        d = _distances(rx[i:i + REGISTRATION_CHUNK],
                       rz[i:i + REGISTRATION_CHUNK], lx, lz)
        rows, cols = torch.nonzero(d <= radius, as_tuple=True)
        counts = torch.bincount(rows, minlength=d.shape[0]).cpu().numpy()
        out.extend(np.split(cols.cpu().numpy(), np.cumsum(counts)[:-1]))
    return out


def check_for_length_and_copy(indices: np.ndarray,
                              final_len: int) -> np.ndarray:
    """Pad an index list to final_len by cyclic repetition, or truncate
    (rcfd_tpu/models/legacy_v0.py:394)."""
    indices = np.asarray(indices)
    n = indices.shape[0]
    if n >= final_len:
        return indices[:final_len]
    reps = int(np.ceil(final_len / max(n, 1)))
    return np.tile(indices, reps)[:final_len]


def reorganize_points(radar_points, lidar_points, idx_arrays,
                      num_points: int):
    """Per-radar-point ground-truth point sets
    (rcfd_tpu/models/legacy_v0.py:423): for each radar point with at least
    one match, its (x, y, z) and its matched lidar (x, y) pixel positions,
    padded or truncated to num_points.

    Arg(s): radar_points (3, N_r) and lidar_points (2 or 3, N_l) image-plane
    points (x, y rows first); idx_arrays, the matches of each radar point.
    Returns input_points (M, 3), ground_truth_points (M, num_points, 2)
    float32 for the M radar points that had a match."""
    radar_points = np.asarray(radar_points)
    lidar_points = np.asarray(lidar_points)
    inputs, gts = [], []
    for r, idx in enumerate(idx_arrays):
        if len(idx) == 0:
            continue
        idx = check_for_length_and_copy(idx, num_points)
        inputs.append(radar_points[:3, r])
        gts.append(lidar_points[:2, idx].T)
    if not inputs:
        return (np.zeros((0, 3), np.float32),
                np.zeros((0, num_points, 2), np.float32))
    return (np.stack(inputs).astype(np.float32),
            np.stack(gts).astype(np.float32))
