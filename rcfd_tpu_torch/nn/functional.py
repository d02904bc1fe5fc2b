"""Functional primitives over NCHW tensors (counterpart of
rcfd_tpu/nn/functional.py, which works in NHWC).

Semantics kept from the JAX package:

- ``activation_fn('leaky_relu')`` gives slope 0.20, while the layers'
  default activation is ``('leaky_relu_default', 0.10)``;
- convolutions pad symmetrically by ``k // 2`` and have no bias;
- ``resize_nearest`` maps ``src = (dst * in) // out`` in integers. It
  does not use ``F.interpolate``, whose float scale can pick another
  source row at ratios such as 57 -> 113 or 112 -> 225. At integer
  factors it repeats each pixel by a broadcast, as the JAX package does;
- ``resize_bilinear_align_corners`` takes its source coordinates in
  float32 as the JAX package does, not through ``F.interpolate``;
- batch norm (inference) computes ``x * scale + shift`` with
  ``scale = w * rsqrt(var + eps)`` in float32, rounded to x's dtype, as
  the JAX package does. Training batch norm (``layers.BatchNorm2d.train()``)
  is torch's ``batch_norm(training=True)`` on float32 input, as the JAX
  package's is XLA's; on bf16 input it takes the JAX package's formula,
  ``batch_norm_train_stats`` then ``batch_norm_apply``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def activation_fn(name):
    """Map an activation name to an elementwise function, or None for
    linear. Substring dispatch and the 0.20 leaky slope as in the JAX
    package (and its reference, src/net_utils.py:4-23)."""
    if name is None:
        return None
    if not isinstance(name, str):
        return name  # already a callable
    if 'linear' in name:
        return None
    elif 'leaky_relu' in name:
        return functools.partial(leaky_relu, negative_slope=0.20)
    elif 'relu' in name:
        return relu
    elif 'elu' in name:
        return elu
    elif 'sigmoid' in name:
        return sigmoid
    raise ValueError('Unsupported activation function: {}'.format(name))


def leaky_relu(x, negative_slope=0.10):
    return torch.where(x >= 0, x, negative_slope * x)


def relu(x):
    return torch.clamp_min(x, 0)


def elu(x):
    return torch.where(x > 0, x, torch.expm1(x))


def sigmoid(x):
    return torch.sigmoid(x)


# ---------------------------------------------------------------------------
# Weight initializers (the JAX package's, drawn from a torch.Generator)
# ---------------------------------------------------------------------------

def _init_(tensor, initializer: str, fan_in: int, fan_out: int, generator):
    if initializer == 'kaiming_uniform':
        bound = 1.0 / math.sqrt(fan_in)
    elif initializer == 'xavier_uniform':
        bound = math.sqrt(6.0 / (fan_in + fan_out))
    elif initializer == 'kaiming_normal':
        std = math.sqrt(2.0 / fan_in)
        return tensor.normal_(0.0, std, generator=generator)
    elif initializer == 'xavier_normal':
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return tensor.normal_(0.0, std, generator=generator)
    else:
        raise ValueError(
            'Unsupported weight initializer: {}'.format(initializer))
    return tensor.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_conv_weight_(weight, initializer: str, generator=None):
    """Initialize an OIHW conv weight in place. 'kaiming_uniform' is
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch.nn.Conv2d's default."""
    o, i, kh, kw = weight.shape
    return _init_(weight, initializer, i * kh * kw, o * kh * kw, generator)


@torch.no_grad()
def init_linear_(weight, bias, initializer: str, generator=None):
    """Initialize an (O, I) linear weight and its bias in place; the bias
    is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) whatever the initializer."""
    out_features, in_features = weight.shape
    _init_(weight, initializer, in_features, out_features, generator)
    b = 1.0 / math.sqrt(in_features)
    bias.uniform_(-b, b, generator=generator)


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------

def conv2d(x, w, stride=1, padding: Optional[int] = None):
    """NCHW x OIHW convolution, symmetric padding k // 2 by default."""
    kh, kw = w.shape[2], w.shape[3]
    pad = (kh // 2, kw // 2) if padding is None else (padding, padding)
    return F.conv2d(x, w, stride=stride, padding=pad)


def conv_transpose2d(x, w, stride: int = 2, padding: Optional[int] = None,
                     output_padding: int = 1):
    """NCHW x IOHW transposed convolution, torch.nn.ConvTranspose2d's
    (stride 2, padding k // 2, output padding 1 by default), which the
    JAX package computes as a convolution of the dilated input with the
    flipped kernel (rcfd_tpu/nn/functional.py ``conv_transpose2d``)."""
    if padding is None:
        padding = w.shape[2] // 2
    return F.conv_transpose2d(x, w, stride=stride, padding=padding,
                              output_padding=output_padding)


def max_pool2d(x, kernel_size: int = 3, stride: int = 2, padding: int = 1):
    """Max pool with -inf padding (torch.nn.MaxPool2d)."""
    return F.max_pool2d(x, kernel_size, stride, padding)


def min_pool2d(x, kernel_size: int, stride: int = 1, padding: int = 0,
               pad_value: float = float('inf')):
    """Min pool of NCHW x, the border padded with ``pad_value`` (+inf by
    default, so that it never wins), as rcfd_tpu/nn/functional.py
    ``min_pool2d``."""
    if padding > 0:
        x = F.pad(x, (padding,) * 4, mode='constant', value=pad_value)
    return -F.max_pool2d(-x, kernel_size, stride)


def outlier_removal(depth, kernel_size: int = 7, threshold: float = 1.5):
    """Zero the sparse depths that stand more than ``threshold`` above the
    smallest depth of their kernel_size neighbourhood (reference
    src/net_utils.py:575-638, rcfd_tpu/nn/functional.py
    ``outlier_removal``). NCHW, C = 1. Empty pixels and the border count
    as 10 times the batch's largest depth, so they are never the minimum
    unless the whole neighbourhood is empty."""
    max_value = 10.0 * depth.max()
    filled = torch.where(depth > 0.0, depth, max_value)
    min_values = min_pool2d(filled, kernel_size, 1, kernel_size // 2,
                            pad_value=float(max_value))
    return torch.where(min_values < depth - threshold,
                       torch.zeros((), dtype=depth.dtype,
                                   device=depth.device), depth)


def batch_norm_apply(x, weight, bias, mean, var, eps: float = 1e-5):
    """Inference batch norm of NCHW x with per-channel statistics. The
    statistics' math runs in at least float32 (wider if the parameters
    are), and ``scale`` and ``shift`` are rounded to x's dtype, as in the
    JAX package: bf16 parameters give bf16 ``scale`` and ``shift`` computed
    from their float32 values."""
    stat_dtype = torch.promote_types(torch.float32, weight.dtype)
    weight, bias, mean, var = (t.to(stat_dtype)
                               for t in (weight, bias, mean, var))
    inv = torch.rsqrt(var + eps)
    scale = (weight * inv).to(x.dtype)
    shift = (bias - mean * weight * inv).to(x.dtype)
    return x * scale[:, None, None] + shift[:, None, None]


def batch_norm_train_stats(x):
    """The batch mean and biased variance of NCHW x over (N, H, W), in at
    least float32, as E[x^2] - mean^2 (rcfd_tpu/nn/functional.py
    ``batch_norm_train_stats``)."""
    xs = x.to(torch.promote_types(torch.float32, x.dtype))
    mean = xs.mean((0, 2, 3))
    return mean, (xs * xs).mean((0, 2, 3)) - mean * mean


def resize_nearest(x, shape: Tuple[int, int]):
    """Nearest resize of NCHW to (H, W): src = (dst * in) // out."""
    h, w = x.shape[2], x.shape[3]
    out_h, out_w = int(shape[0]), int(shape[1])
    if (out_h, out_w) == (h, w):
        return x
    if out_h % h == 0 and out_w % w == 0:
        # integer factors: the index map repeats each pixel, so a broadcast
        # copy gives the gather's result without an index
        n, c = x.shape[0], x.shape[1]
        kh, kw = out_h // h, out_w // w
        return x[:, :, :, None, :, None].expand(n, c, h, kh, w, kw) \
            .reshape(n, c, out_h, out_w)
    rows = torch.arange(out_h, device=x.device) * h // out_h
    cols = torch.arange(out_w, device=x.device) * w // out_w
    return x.index_select(2, rows).index_select(3, cols)


def _align_corners_coords(out_dim: int, in_dim: int, device):
    """Source coordinates of an align-corners resize, in float32 as the
    JAX package computes them: arange(out) * ((in - 1) / (out - 1)), the
    ratio rounded to float32 first; 0 when ``out_dim`` is 1. Returns
    (the lower index, the upper index, the fraction past the lower)."""
    if out_dim == 1:
        coords = torch.zeros(1, dtype=torch.float32, device=device)
    else:
        ratio = torch.tensor((in_dim - 1) / (out_dim - 1),
                             dtype=torch.float32, device=device)
        coords = torch.arange(out_dim, dtype=torch.float32,
                              device=device) * ratio
    lo = torch.floor(coords).long().clamp(0, in_dim - 1)
    hi = (lo + 1).clamp(0, in_dim - 1)
    return lo, hi, coords - lo.to(torch.float32)


def resize_bilinear_align_corners(x, shape: Tuple[int, int]):
    """Bilinear resize of NCHW x to (H, W) with align_corners=True
    (rcfd_tpu/nn/functional.py ``resize_bilinear_align_corners``, torch's
    ``interpolate(mode='bilinear', align_corners=True)`` up to the last
    bit of the coordinates): rows, then columns, each a lerp
    ``a + f * (b - a)`` in x's dtype with the fraction rounded to it. The
    identity at equal size. Differentiable (gathers and lerps)."""
    h, w = x.shape[2], x.shape[3]
    out_h, out_w = int(shape[0]), int(shape[1])
    if (out_h, out_w) == (h, w):
        return x
    y0, y1, wy = _align_corners_coords(out_h, h, x.device)
    x0, x1, wx = _align_corners_coords(out_w, w, x.device)
    top, bot = x.index_select(2, y0), x.index_select(2, y1)
    rows = top + wy.to(x.dtype)[:, None] * (bot - top)
    left, right = rows.index_select(3, x0), rows.index_select(3, x1)
    return left + wx.to(x.dtype) * (right - left)
