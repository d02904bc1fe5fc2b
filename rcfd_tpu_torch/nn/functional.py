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
- batch norm (inference) computes ``x * scale + shift`` with
  ``scale = w * rsqrt(var + eps)``, as the JAX package does.
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


def max_pool2d(x, kernel_size: int = 3, stride: int = 2, padding: int = 1):
    """Max pool with -inf padding (torch.nn.MaxPool2d)."""
    return F.max_pool2d(x, kernel_size, stride, padding)


def batch_norm_apply(x, weight, bias, mean, var, eps: float = 1e-5):
    """Inference batch norm of NCHW x with per-channel statistics."""
    inv = torch.rsqrt(var + eps)
    scale = weight * inv
    shift = bias - mean * weight * inv
    return x * scale[:, None, None] + shift[:, None, None]


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
