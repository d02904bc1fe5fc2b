"""Network layers and blocks (counterpart of rcfd_tpu/nn/layers.py).

Parameter names follow the JAX package's trees, which follow the
reference's torch state_dicts, so ``utils.checkpoint.state_dict_from_jax``
loads with ``strict=True``. All math is NCHW. Batch norm uses its running
statistics in eval mode and the batch's in training mode
(``nn.Module.train()``). The TPU layout rewrites of the JAX
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
    """Batch norm, eps 1e-5, momentum 0.1, with torch.nn.BatchNorm2d's
    parameter and buffer names (rcfd_tpu/nn/layers.py ``BatchNorm2d``).

    In eval mode it normalizes by the running statistics
    (``functional.batch_norm_apply``, bit for bit the JAX package's). In
    training mode it normalizes by the batch's mean and biased variance,
    moves the running mean and variance by momentum toward the batch mean
    and unbiased variance, and counts the batch in
    ``num_batches_tracked``, as the JAX package does. On float32 input
    torch's ``batch_norm(training=True)`` computes it (JAX computes it in
    XLA). On bf16 input (bf16 training) it takes the JAX package's formula:
    the batch statistics in float32 as E[x^2] - mean^2
    (``functional.batch_norm_train_stats``), the unbiased variance n/(n-1)
    times theirs for the running statistics, and the normalization by
    ``functional.batch_norm_apply`` (scale and shift rounded to bf16 and
    applied in bf16), all of it differentiable."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
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
        if self.training and x.dtype == torch.bfloat16:
            mean, var = F.batch_norm_train_stats(x)
            n = x.numel() // x.shape[1]
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_((1 - m) * self.running_mean +
                                        m * mean)
                self.running_var.copy_((1 - m) * self.running_var +
                                       m * (var * (n / max(n - 1, 1))))
                self.num_batches_tracked.add_(1)
            return F.batch_norm_apply(x, self.weight, self.bias, mean, var,
                                      self.eps)
        if self.training:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
            return torch.nn.functional.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, True, self.momentum, self.eps)
        return F.batch_norm_apply(x, self.weight, self.bias,
                                  self.running_mean, self.running_var,
                                  self.eps)


class Conv2d(nn.Module):
    """Conv (+ batch norm) (+ activation). src/net_utils.py:29-91. The conv
    has no bias until ``nn.optimize.fold_batch_norm`` folds the batch norm
    into its weight and a bias (``conv.bias``). As in the JAX package, the
    weight is taken in the input's dtype and the bias is added to the
    convolution's output in the output's dtype."""

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
        return self.finish(self._convolve(x))

    def _convolve(self, x):
        """The convolution and its folded bias, if any. The bias is added in
        place, as torch adds a convolution's own bias after cuDNN's
        convolution, so that no second map of the output's size is held."""
        conv = self.conv
        y = F.conv2d(x, conv.weight.to(x.dtype), stride=self.stride)
        if conv.bias is not None:
            y.add_(conv.bias.to(y.dtype)[:, None, None])
        return y

    def finish(self, y):
        """Batch norm and activation of the convolution's output, whose
        bias, if any, is already added."""
        if self.batch_norm is not None:
            y = self.batch_norm(y)
        if self.activation is not None:
            y = self.activation(y)
        return y


class TransposeConv2d(nn.Module):
    """Transposed conv (+ batch norm) (+ activation), stride 2, padding
    k // 2, output padding 1: each side doubles (src/net_utils.py:94-153,
    rcfd_tpu/nn/layers.py ``TransposeConv2d``). The weight is torch's
    ConvTranspose2d layout, IOHW, as in the reference's checkpoints; no
    bias until a folded batch norm's (``deconv.bias``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3,
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func=('leaky_relu_default', 0.10),
                 use_batch_norm: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight_initializer = weight_initializer
        self.activation = _resolve_activation(activation_func)
        self.deconv = nn.ConvTranspose2d(
            in_channels, out_channels, kernel_size, stride=2,
            padding=kernel_size // 2, output_padding=1, bias=False)
        self.batch_norm = BatchNorm2d(out_channels) if use_batch_norm \
            else None

    def forward(self, x):
        deconv = self.deconv
        y = F.conv_transpose2d(x, deconv.weight.to(x.dtype))
        if deconv.bias is not None:
            y.add_(deconv.bias.to(y.dtype)[:, None, None])
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
    """Linear (+ activation). src/net_utils.py:201-247 (no dropout). The weight and bias are taken in the input's dtype, as in
    the JAX package: bf16 parameters serve float32 points in float32."""

    def __init__(self, in_features: int, out_features: int,
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func=('leaky_relu_default', 0.10)):
        super().__init__()
        self.weight_initializer = weight_initializer
        self.activation = _resolve_activation(activation_func)
        self.fully_connected = nn.Linear(in_features, out_features)

    def forward(self, x):
        fc = self.fully_connected
        y = torch.nn.functional.linear(x, fc.weight.to(x.dtype),
                                       fc.bias.to(x.dtype))
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


class ResNetBottleneckBlock(nn.Module):
    """Bottleneck residual block, 1x1 -> 3x3 (strided) -> 1x1 to 4 x
    ``out_channels``, plus a 1x1 projection of the input that always
    applies (src/net_utils.py:326-407, rcfd_tpu/nn/layers.py
    ``ResNetBottleneckBlock``, which keeps the reference's quirk)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func=('leaky_relu_default', 0.10),
                 use_batch_norm: bool = False):
        super().__init__()
        self.activation = _resolve_activation(activation_func)
        wi, act, bn = weight_initializer, activation_func, use_batch_norm
        self.conv1 = Conv2d(in_channels, out_channels, 1, 1, wi, act, bn)
        self.conv2 = Conv2d(out_channels, out_channels, 3, stride, wi, act,
                            bn)
        self.conv3 = Conv2d(out_channels, 4 * out_channels, 1, 1, wi, act,
                            bn)
        self.projection = Conv2d(in_channels, 4 * out_channels, 1, stride,
                                 wi, None, False)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        return self.activation(y + self.projection(x))


class VGGNetBlock(nn.Module):
    """``n_conv`` 3x3 convolutions, the last one strided
    (src/net_utils.py:410-467, rcfd_tpu/nn/layers.py ``VGGNetBlock``)."""

    def __init__(self, in_channels: int, out_channels: int, n_conv: int = 1,
                 stride: int = 1,
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func=('leaky_relu_default', 0.10),
                 use_batch_norm: bool = False):
        super().__init__()
        layers = []
        for n in range(n_conv):
            layers.append(Conv2d(in_channels, out_channels, 3,
                                 stride if n == n_conv - 1 else 1,
                                 weight_initializer, activation_func,
                                 use_batch_norm))
            in_channels = out_channels
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x):
        return self.conv_block(x)


class DecoderBlock(nn.Module):
    """Deconvolution + skip concat + conv. src/net_utils.py:473-569. The
    deconvolution is ``deconv_type`` 'up' (a nearest upsample to the
    skip's shape, then a conv) or 'transpose' (a TransposeConv2d, which
    doubles each side and does not fit itself to the skip: a skip of
    another shape fails the concat, as in the JAX package)."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int,
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func=('leaky_relu_default', 0.10),
                 use_batch_norm: bool = False, deconv_type: str = 'up'):
        super().__init__()
        self.skip_channels = skip_channels
        self.deconv_type = deconv_type
        if deconv_type == 'transpose':
            self.deconv = TransposeConv2d(in_channels, out_channels, 3,
                                          weight_initializer,
                                          activation_func, use_batch_norm)
        elif deconv_type == 'up':
            self.deconv = UpConv2d(in_channels, out_channels, 3,
                                   weight_initializer, activation_func,
                                   use_batch_norm)
        else:
            raise ValueError('Unsupported deconv type: {}'.format(
                deconv_type))
        self.conv = Conv2d(skip_channels + out_channels, out_channels, 3, 1,
                           weight_initializer, activation_func,
                           use_batch_norm)

    def forward(self, x, skip=None, shape=None):
        if self.deconv_type == 'transpose':
            y = self.deconv(x)
        else:
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
                y = y + b.to(y.dtype)[:, None, None]
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
        elif isinstance(m, TransposeConv2d):
            # IOHW, drawn as the JAX package draws its HWIO kernel: the fan
            # in counts the input channels
            F.init_conv_weight_(m.deconv.weight.transpose(0, 1),
                                m.weight_initializer, generator)
        elif isinstance(m, FullyConnected):
            F.init_linear_(m.fully_connected.weight,
                           m.fully_connected.bias, m.weight_initializer,
                           generator)
        elif isinstance(m, BatchNorm2d):
            m.reset_parameters()
    return module
