"""Network layers and blocks (counterpart of rcfd_tpu/nn/layers.py).

Parameter names follow the JAX package's trees, which follow the
reference's torch state_dicts, so ``utils.checkpoint.state_dict_from_jax``
loads with ``strict=True``. All math is NCHW. Inference only: batch norm
always uses its running statistics. The TPU layout rewrites of the JAX
package (fused upsample, fast split-conv decoder, packed tails) are not
ported; these blocks compute the plain math they rewrite. A DecoderBlock
given a deferred skip (LazyColumnWindows) runs the fused skip gather-add
(ops/fused_skip.py).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_skip import LazyColumnWindows, fused_skip_conv_add
from . import functional as F


def _resolve_activation(activation_func):
    """Accept None, a string, a callable, or ('leaky_relu_default', slope)."""
    if activation_func is None:
        return None
    if isinstance(activation_func, tuple) and \
            activation_func[0] == 'leaky_relu_default':
        slope = activation_func[1]
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    return F.activation_fn(activation_func)


class BatchNorm2d(nn.Module):
    """Inference batch norm, eps 1e-5, with torch.nn.BatchNorm2d's
    parameter and buffer names."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.register_buffer('num_batches_tracked',
                             torch.zeros((), dtype=torch.long))

    @torch.no_grad()
    def reset_parameters(self):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()

    def forward(self, x):
        return F.batch_norm_apply(x, self.weight, self.bias,
                                  self.running_mean, self.running_var,
                                  self.eps)


class Conv2d(nn.Module):
    """Conv (+ batch norm) (+ activation). src/net_utils.py:29-91. The conv
    has no bias until ``nn.optimize.fold_batch_norm`` folds the batch norm
    into its weight and a bias (``conv.bias``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride=1, weight_initializer: str = 'kaiming_uniform',
                 activation_func=('leaky_relu_default', 0.10),
                 use_batch_norm: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.weight_initializer = weight_initializer
        self.activation = _resolve_activation(activation_func)
        ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.conv = nn.Conv2d(in_channels, out_channels, ks, stride,
                              padding=(ks[0] // 2, ks[1] // 2), bias=False)
        self.batch_norm = BatchNorm2d(out_channels) if use_batch_norm \
            else None

    def forward(self, x):
        return self.finish(self.conv(x))

    def finish(self, y):
        """Batch norm and activation of the convolution's output, whose
        bias, if any, is already added."""
        if self.batch_norm is not None:
            y = self.batch_norm(y)
        if self.activation is not None:
            y = self.activation(y)
        return y


class UpConv2d(nn.Module):
    """Nearest upsample to a target shape + conv. src/net_utils.py:156-198."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3,
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func=('leaky_relu_default', 0.10),
                 use_batch_norm: bool = False):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, 1,
                           weight_initializer, activation_func,
                           use_batch_norm)

    def forward(self, x, shape):
        return self.conv(F.resize_nearest(x, shape))


class FullyConnected(nn.Module):
    """Linear (+ activation). src/net_utils.py:201-247 (no dropout at
    inference)."""

    def __init__(self, in_features: int, out_features: int,
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func=('leaky_relu_default', 0.10)):
        super().__init__()
        self.weight_initializer = weight_initializer
        self.activation = _resolve_activation(activation_func)
        self.fully_connected = nn.Linear(in_features, out_features)

    def forward(self, x):
        y = self.fully_connected(x)
        if self.activation is not None:
            y = self.activation(y)
        return y


class ResNetBlock(nn.Module):
    """Basic residual block. src/net_utils.py:253-323. The 1x1 projection
    always exists (as in checkpoints) but applies only when the shape
    changes."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func=('leaky_relu_default', 0.10),
                 use_batch_norm: bool = False):
        super().__init__()
        self.activation = _resolve_activation(activation_func)
        self.use_projection = (stride != 1) or (in_channels != out_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, stride,
                            weight_initializer, activation_func,
                            use_batch_norm)
        self.conv2 = Conv2d(out_channels, out_channels, 3, 1,
                            weight_initializer, activation_func,
                            use_batch_norm)
        self.projection = Conv2d(in_channels, out_channels, 1, stride,
                                 weight_initializer, None, False)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        shortcut = self.projection(x) if self.use_projection else x
        return self.activation(y + shortcut)


class DecoderBlock(nn.Module):
    """Upconv + skip concat + conv. src/net_utils.py:473-569 ('up' deconv
    only)."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int,
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func=('leaky_relu_default', 0.10),
                 use_batch_norm: bool = False, deconv_type: str = 'up'):
        super().__init__()
        if deconv_type != 'up':
            raise NotImplementedError(
                'deconv_type {!r} is not ported yet (ROADMAP.md, port '
                'queue)'.format(deconv_type))
        self.skip_channels = skip_channels
        self.deconv = UpConv2d(in_channels, out_channels, 3,
                               weight_initializer, activation_func,
                               use_batch_norm)
        self.conv = Conv2d(skip_channels + out_channels, out_channels, 3, 1,
                           weight_initializer, activation_func,
                           use_batch_norm)

    def forward(self, x, skip=None, shape=None):
        if skip is not None:
            shape = skip.shape[2:]
        elif shape is None:
            shape = (2 * x.shape[2], 2 * x.shape[3])
        y = self.deconv(x, shape)
        if isinstance(skip, LazyColumnWindows):
            # conv(concat[y, windows]) with the skip half convolved once on
            # the global map and its windows gathered into the sum
            w, b = self.conv.conv.weight, self.conv.conv.bias
            co = y.shape[1]
            y = fused_skip_conv_add(y, w[:, :co], skip, w[:, co:])
            if b is not None:  # a folded batch norm, added after the sum
                y = y + b[:, None, None]
            return self.conv.finish(y)
        if self.skip_channels > 0:
            y = torch.cat([y, skip], dim=1)
        return self.conv(y)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator):
    """Draw every weight of ``module`` from ``generator`` in the JAX
    package's initializer style (nn/functional.py init_conv_weight /
    init_linear); batch norm starts at weight 1, bias 0, running mean 0
    and running variance 1."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            F.init_conv_weight_(m.conv.weight, m.weight_initializer,
                                generator)
        elif isinstance(m, FullyConnected):
            F.init_linear_(m.fully_connected.weight,
                           m.fully_connected.bias, m.weight_initializer,
                           generator)
        elif isinstance(m, BatchNorm2d):
            m.reset_parameters()
    return module
