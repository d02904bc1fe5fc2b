"""Network architectures (counterpart of rcfd_tpu/models/networks.py), NCHW.

Child names follow the JAX package's parameter trees. Ported: the ResNet
encoder, the FusionNet twin encoder, the twin ResNet-based encoder, the
MLP point encoder, the RadarNet v1 encoder and the multiscale decoder at
one to four output resolutions, on the plain path (the TPU layout
rewrites are not ported).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from ..nn import functional as F
from ..nn.layers import Conv2d, DecoderBlock, FullyConnected, ResNetBlock
from ..nn.perf import PerfConfig
from ..ops.roi_pool import roi_pool_column


def _make_layer(n_block, in_channels, out_channels, stride,
                weight_initializer, activation_func, use_batch_norm):
    """Stack of ResNet blocks; the first carries the stride."""
    blocks = []
    for n in range(n_block):
        if n != 0:
            in_channels = out_channels
            stride = 1
        blocks.append(ResNetBlock(in_channels, out_channels, stride,
                                  weight_initializer, activation_func,
                                  use_batch_norm))
    return nn.Sequential(*blocks)


def _resnet_n_blocks(n_layer: int, n_filters: List[int]) -> List[int]:
    if n_layer == 18:
        n_blocks = [2, 2, 2, 2]
    elif n_layer == 34:
        n_blocks = [3, 4, 6, 3]
    else:
        raise ValueError('Only supports 18, 34 layer architecture')
    for _ in range(len(n_filters) - len(n_blocks) - 1):
        n_blocks = n_blocks + [n_blocks[-1]]
    assert len(n_filters) < 8, 'Does not support network depth of 8 or more'
    assert len(n_filters) == len(n_blocks) + 1
    return n_blocks


class ResNetEncoder(nn.Module):
    """conv1 (7x7/2) -> maxpool/2 + blocks2 -> blocks3/2 -> ... Returns
    (latent, skips), the skips being every stage output but the last."""

    def __init__(self, n_layer: int, input_channels: int = 3,
                 n_filters: List[int] = (32, 64, 128, 256, 256),
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func: str = 'leaky_relu',
                 use_batch_norm: bool = False):
        super().__init__()
        n_filters = list(n_filters)
        n_blocks = _resnet_n_blocks(n_layer, n_filters)
        act = F.activation_fn(activation_func)
        self.conv1 = Conv2d(input_channels, n_filters[0], 7, 2,
                            weight_initializer, act, use_batch_norm)
        strides = [1, 2, 2, 2, 2, 2]
        self.stage_names = []
        for i in range(1, len(n_filters)):
            name = 'blocks{}'.format(i + 1)
            self.add_module(name, _make_layer(
                n_blocks[i - 1], n_filters[i - 1], n_filters[i],
                strides[i - 1], weight_initializer, act, use_batch_norm))
            self.stage_names.append(name)

    def forward(self, x):
        y = self.conv1(x)
        layers = [y]
        for i, name in enumerate(self.stage_names):
            if i == 0:
                y = F.max_pool2d(y, 3, 2, 1)
            y = getattr(self, name)(y)
            layers.append(y)
        return layers[-1], layers[:-1]


class FusionNetEncoder(nn.Module):
    """Two-branch (image, depth) ResNet encoder with per-scale fusion:
    add, weight, weight_and_project or concat."""

    def __init__(self, n_layer: int = 18, input_channels_image: int = 3,
                 input_channels_depth: int = 3,
                 n_filters_encoder_image: List[int] = (32, 64, 128, 256, 256),
                 n_filters_encoder_depth: List[int] = (32, 64, 128, 256, 256),
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func: str = 'leaky_relu',
                 use_batch_norm: bool = False, fusion_type: str = 'add'):
        super().__init__()
        if fusion_type not in ('add', 'weight', 'weight_and_project',
                               'concat'):
            raise ValueError('Unsupported fusion type: {}'.format(
                fusion_type))
        self.fusion_type = fusion_type
        n_fi = list(n_filters_encoder_image)
        n_fd = list(n_filters_encoder_depth)
        assert len(n_fi) == len(n_fd)
        n_blocks = _resnet_n_blocks(n_layer, n_fi)
        act = F.activation_fn(activation_func)
        self.n_stages = len(n_fi)
        wi, bn = weight_initializer, use_batch_norm

        self.conv1_image = Conv2d(input_channels_image, n_fi[0], 7, 2, wi,
                                  act, bn)
        self.conv1_depth = Conv2d(input_channels_depth, n_fd[0], 7, 2, wi,
                                  act, bn)
        self._add_fusion(1, n_fd[0], n_fi[0], wi, bn)
        strides = [1, 2, 2, 2, 2, 2]
        for i in range(1, len(n_fi)):
            stage = i + 1
            self.add_module('blocks{}_image'.format(stage), _make_layer(
                n_blocks[i - 1], n_fi[i - 1], n_fi[i], strides[i - 1], wi,
                act, bn))
            self.add_module('blocks{}_depth'.format(stage), _make_layer(
                n_blocks[i - 1], n_fd[i - 1], n_fd[i], strides[i - 1], wi,
                act, bn))
            self._add_fusion(stage, n_fd[i], n_fi[i], wi, bn)

    def _add_fusion(self, stage, c_depth, c_image, wi, bn):
        ft = self.fusion_type
        if ft == 'add':
            self.add_module('conv{}_project'.format(stage),
                            Conv2d(c_depth, c_image, 1, 1, wi, None, bn))
        elif ft == 'weight':
            self.add_module('conv{}_weight'.format(stage),
                            Conv2d(c_depth, c_depth, 3, 1, wi, 'sigmoid', bn))
        elif ft == 'weight_and_project':
            self.add_module('conv{}_weight'.format(stage),
                            Conv2d(c_depth, c_image, 1, 1, wi, 'sigmoid', bn))
            self.add_module('conv{}_project'.format(stage),
                            Conv2d(c_depth, c_image, 1, 1, wi, None, bn))

    def _fuse(self, stage, feat_image, feat_depth):
        ft = self.fusion_type
        if ft == 'add':
            return getattr(self, 'conv{}_project'.format(stage))(
                feat_depth) + feat_image
        if ft == 'weight':
            w = getattr(self, 'conv{}_weight'.format(stage))(feat_depth)
            return w * feat_depth + feat_image
        if ft == 'weight_and_project':
            w = getattr(self, 'conv{}_weight'.format(stage))(feat_depth)
            p = getattr(self, 'conv{}_project'.format(stage))(feat_depth)
            return w * p + feat_image
        # concat: stage 1 depth-first, later stages image-first
        if stage == 1:
            return torch.cat([feat_depth, feat_image], dim=1)
        return torch.cat([feat_image, feat_depth], dim=1)

    def forward(self, image, depth):
        fi = self.conv1_image(image)
        fd = self.conv1_depth(depth)
        layers = [self._fuse(1, fi, fd)]
        for i in range(1, self.n_stages):
            stage = i + 1
            if i == 1:
                fi = F.max_pool2d(fi, 3, 2, 1)
                fd = F.max_pool2d(fd, 3, 2, 1)
            fi = getattr(self, 'blocks{}_image'.format(stage))(fi)
            fd = getattr(self, 'blocks{}_depth'.format(stage))(fd)
            layers.append(self._fuse(stage, fi, fd))
        return layers[-1], layers[:-1]


# the point MLP's row tile: every product of FullyConnectedEncoder has this
# many rows, whatever the batch's row count (B x K)
MLP_TILE_ROWS = 256


class FullyConnectedEncoder(nn.Module):
    """MLP point encoder (src/networks.py:1007-1067).

    ``forward`` runs the MLP over tiles of MLP_TILE_ROWS rows, the last
    padded with zero rows that are dropped at the end, one tile after
    another: each product has the same shape at any row count, and each
    tile starts at a multiple of 256 rows, 16-byte aligned. cuBLAS picks
    its kernel by a product's shape (and its operands' alignment), so one
    product over all B x K rows gave the same points other last bits on the
    card at another row count (the bridge's K = 128 against the main
    script's K = 64). A point's features now depend on the point alone."""

    def __init__(self, input_channels: int = 3,
                 n_neurons: List[int] = (32, 64, 96, 128, 256),
                 latent_size: int = 29 * 10,
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func: str = 'leaky_relu'):
        super().__init__()
        act = F.activation_fn(activation_func)
        dims = [input_channels] + list(n_neurons) + [latent_size]
        self.mlp = nn.Sequential(*[
            FullyConnected(dims[i], dims[i + 1], weight_initializer, act)
            for i in range(len(dims) - 1)])

    def forward(self, x):
        n, t = x.shape[0], MLP_TILE_ROWS
        padded = max(-(-n // t), 1) * t
        if padded != n:
            x = torch.cat([x, x.new_zeros(padded - n, x.shape[1])])
        return torch.cat([self.mlp(x[i:i + t])
                          for i in range(0, padded, t)])[:n]


class RadarNetV1Encoder(nn.Module):
    """Image encoder + per-point column ROI pooling + MLP point encoder.

    forward(image (B, 3, H, W), points (B*K, 3), x1 (B, K)) returns the
    fused latent (B*K, C_img + C_pt, h/32, w/32) and the per-point pooled
    skips. With ``perf.fused_pool2`` (``fused_pool4``) the 1/2-scale
    (1/4-scale) skip is handed on deferred, as a LazyColumnWindows, when
    its pooled width is at most 256.
    """

    def __init__(self, input_channels_image: int = 3,
                 input_channels_depth: int = 3,
                 input_patch_size_image: Tuple[int, int] = (900, 288),
                 n_filters_encoder_image: List[int] = (32, 64, 128, 128, 128),
                 n_neurons_encoder_depth: List[int] = (32, 64, 128, 128, 128),
                 latent_size_depth: int = 128 * 28 * 9,
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func: str = 'leaky_relu',
                 use_batch_norm: bool = False, perf: PerfConfig = None):
        super().__init__()
        self.perf = perf if perf is not None else PerfConfig()
        self.n_neuron_latent_depth = list(n_neurons_encoder_depth)[-1]
        self.input_patch_size_image = tuple(input_patch_size_image)
        self.encoder_image = ResNetEncoder(
            18, input_channels_image, n_filters_encoder_image,
            weight_initializer, activation_func, use_batch_norm)
        self.encoder_depth = FullyConnectedEncoder(
            input_channels_depth, n_neurons_encoder_depth, latent_size_depth,
            weight_initializer, activation_func)

    def encode_image(self, image):
        """Per-image half: the full-frame ResNet encoder."""
        return self.encoder_image(image)

    def fuse_points(self, latent_image, skips_image, points, x1,
                    box_height: int):
        """Per-point half: ROI pooling of the latent and the skips, MLP
        point encoding, and the bottleneck concat."""
        patch_h, patch_w = self.input_patch_size_image
        latent_height = int(patch_h // 32)
        latent_width = int(patch_w // 32)
        skip_scales = [1 / 2., 1 / 4., 1 / 8., 1 / 16., 1 / 32., 1 / 64.,
                       1 / 128.]
        skip_sizes = [(int(patch_h * s), int(patch_w * s))
                      for s in skip_scales]
        latent_pooled = roi_pool_column(
            latent_image, x1, box_width=patch_w, box_y1=0,
            box_y2=box_height, spatial_scale=1 / 32.,
            output_size=(latent_height, latent_width))
        # the deferred pools serve only, as in the JAX package
        fuse_pool2 = self.perf.fused_pool2 and not self.training and \
            skip_sizes[0][1] <= 256
        fuse_pool4 = self.perf.fused_pool4 and not self.training and \
            skip_sizes[1][1] <= 256
        skips_pooled = [
            roi_pool_column(skip, x1, box_width=patch_w, box_y1=0,
                            box_y2=box_height, spatial_scale=skip_scales[i],
                            output_size=skip_sizes[i],
                            return_global=(fuse_pool2 and i == 0) or
                            (fuse_pool4 and i == 1))
            for i, skip in enumerate(skips_image)]
        latent_depth = self.encoder_depth(points)
        # torch .view(N, C, -1, W) of the (N, C*h*w) latent: C-major, which
        # is NCHW as it stands
        latent_depth = latent_depth.reshape(
            points.shape[0], self.n_neuron_latent_depth, -1, latent_width)
        # the MLP runs in the points' float32; its features join the image
        # branch in the image's dtype (bf16 under compute_dtype)
        latent_depth = latent_depth.to(latent_pooled.dtype)
        latent = torch.cat([latent_pooled, latent_depth], dim=1)
        return latent, skips_pooled

    def forward(self, image, points, x1, box_height=None):
        if box_height is None:
            box_height = image.shape[2]
        latent_image, skips_image = self.encode_image(image)
        return self.fuse_points(latent_image, skips_image, points, x1,
                                box_height)


class ResNetBasedEncoder(nn.Module):
    """Twin ResNet-18 encoders, image and depth, fused by concatenating
    each scale's features (src/networks.py:1259-1331,
    rcfd_tpu/models/networks.py ``ResNetBasedEncoder``; the JAX package
    builds it with 18 layers whatever ``n_layer`` says)."""

    def __init__(self, n_layer: int, input_channels_image: int = 3,
                 input_channels_depth: int = 1,
                 n_filters_image: List[int] = (48, 96, 192, 384, 384),
                 n_filters_depth: List[int] = (16, 32, 64, 128, 128),
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func: str = 'leaky_relu',
                 use_batch_norm: bool = False):
        super().__init__()
        self.encoder_image = ResNetEncoder(
            18, input_channels_image, n_filters_image, weight_initializer,
            activation_func, use_batch_norm)
        self.encoder_depth = ResNetEncoder(
            18, input_channels_depth, n_filters_depth, weight_initializer,
            activation_func, use_batch_norm)

    def forward(self, image, depth):
        latent_image, skips_image = self.encoder_image(image)
        latent_depth, skips_depth = self.encoder_depth(depth)
        skips = [torch.cat([a, b], dim=1)
                 for a, b in zip(skips_image, skips_depth)]
        return torch.cat([latent_image, latent_depth], dim=1), skips


class MultiScaleDecoder(nn.Module):
    """Multiscale decoder with skip connections (src/networks.py:1337-1657,
    rcfd_tpu/models/networks.py ``MultiScaleDecoder`` on its plain path).

    With ``n_resolution`` r > 1 the blocks at 1/8, 1/4 and 1/2 of the
    output's resolution (deconv3, deconv2, deconv1) get side heads
    ``output3`` (r > 3), ``output2`` (r > 2) and ``output1``; each head's
    output, resized 2x (bilinear, align corners), joins the next block's
    skip, and deconv0 takes output1's as its skip (after the encoder's
    first skip, where that skip is deconv0's). A 2x resize of a side that
    is odd misses its skip by one and the concat fails, as in the JAX
    package. An ``output_func`` with 'upsample' in it makes r at least 2
    and output0 the resized output1 (deconv0 and output0 are built all the
    same, as the checkpoints hold them). ``forward`` returns the outputs
    from the coarsest to output0."""

    def __init__(self, input_channels: int = 256, output_channels: int = 1,
                 n_resolution: int = 1,
                 n_filters: List[int] = (256, 128, 64, 32, 16),
                 n_skips: List[int] = (256, 128, 64, 32, 0),
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func: str = 'leaky_relu',
                 output_func: str = 'linear', use_batch_norm: bool = False,
                 deconv_type: str = 'up'):
        super().__init__()
        n_filters = list(n_filters)
        n_skips = list(n_skips)
        network_depth = len(n_filters)
        assert network_depth < 8, 'Does not support network depth of 8 or more'
        assert 0 < n_resolution < network_depth
        self.upsample_output = 'upsample' in output_func
        if self.upsample_output:
            n_resolution = max(n_resolution, 2)
        act = F.activation_fn(activation_func)
        out_act = F.activation_fn(output_func)
        self.block_names = []
        self.heads = {}  # block -> the side head after it
        in_ch = input_channels
        for i in range(network_depth):
            level = network_depth - 1 - i  # deconv<level>
            name = 'deconv{}'.format(level)
            # the side output of the block before joins this block's skip
            side = output_channels if level < 3 and \
                n_resolution > level + 1 else 0
            self.add_module(name, DecoderBlock(
                in_ch, n_skips[i] + side, n_filters[i], weight_initializer,
                act, use_batch_norm, deconv_type))
            self.block_names.append(name)
            if 0 < level < 4 and n_resolution > level:
                self.heads[name] = 'output{}'.format(level)
                self.add_module(self.heads[name], Conv2d(
                    n_filters[i], output_channels, 3, 1, weight_initializer,
                    out_act, False))
            in_ch = n_filters[i]
        self.output0 = Conv2d(n_filters[-1], output_channels, 3, 1,
                              weight_initializer, out_act, False)

    def forward(self, x, skips, shape=None):
        """Decode the latent ``x`` with ``skips`` (shallowest first). The
        last block upsamples to ``shape`` (or 2x) when it has neither a
        skip nor a side output."""
        n = len(skips) - 1
        outputs = []
        side = None  # the last side output, resized 2x
        for name in self.block_names:
            block = getattr(self, name)
            if name == 'deconv0' and self.upsample_output:
                return outputs + [side]
            skip = skips[n] if n >= 0 else None
            if side is not None:
                skip = side if skip is None else torch.cat([skip, side], 1)
            if skip is not None:
                x = block(x, skip=skip)
            else:
                x = block(x, shape=tuple(shape[-2:]) if shape is not None
                          else None)
            n -= 1
            head = self.heads.get(name)
            if head is not None:
                outputs.append(getattr(self, head)(x))
                side = F.resize_bilinear_align_corners(
                    outputs[-1], (2 * x.shape[2], 2 * x.shape[3]))
        return outputs + [self.output0(x)]
