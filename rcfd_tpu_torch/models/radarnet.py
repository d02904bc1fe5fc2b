"""RadarNet (counterpart of rcfd_tpu/models/radarnet.py): per-radar-point
correspondence network, inference."""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from .. import default_device
from ..nn.perf import PerfConfig
from .networks import MultiScaleDecoder, RadarNetV1Encoder


class RadarNetModel(nn.Module):
    """ResNet image encoder + per-point ROI pooling + MLP point encoder +
    multiscale decoder (src/radarnet_model.py:36-124).

    Built on ``device`` (``cuda`` unless ``device='cpu'`` is given) and put
    in eval mode; weights come from ``init_parameters`` or
    ``load_state_dict(state_dict_from_jax(...))``. ``perf`` (a PerfConfig)
    turns on the deferred skip pools; it adds no parameter.
    """

    def __init__(self, input_channels_image: int, input_channels_depth: int,
                 input_patch_size_image: Tuple[int, int], encoder_type: str,
                 n_filters_encoder_image: List[int],
                 n_neurons_encoder_depth: List[int], decoder_type: str,
                 n_filters_decoder: List[int],
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func: str = 'leaky_relu', device=None,
                 perf: PerfConfig = None):
        super().__init__()
        device = default_device(device)
        self.input_patch_size_image = tuple(input_patch_size_image)
        height, width = self.input_patch_size_image
        latent_size_depth = (height // 32) * (width // 32) * \
            list(n_neurons_encoder_depth)[-1]
        if 'radarnetv1' not in encoder_type:
            raise ValueError('Encoder type {} not supported.'.format(
                encoder_type))
        self.encoder = RadarNetV1Encoder(
            input_channels_image, input_channels_depth,
            input_patch_size_image, n_filters_encoder_image,
            n_neurons_encoder_depth, latent_size_depth, weight_initializer,
            activation_func, use_batch_norm='batch_norm' in encoder_type,
            perf=perf)
        if 'multiscale' not in decoder_type:
            raise ValueError('Decoder type {} not supported.'.format(
                decoder_type))
        n_skips = list(n_filters_encoder_image)[:-1][::-1] + [0]
        latent_channels = list(n_filters_encoder_image)[-1] + \
            list(n_neurons_encoder_depth)[-1]
        self.decoder = MultiScaleDecoder(
            latent_channels, 1, 1, n_filters_decoder, n_skips,
            weight_initializer, activation_func, 'linear',
            use_batch_norm='batch_norm' in decoder_type, deconv_type='up')
        # inference only in this slice: no autograd graph is recorded
        self.requires_grad_(False)
        self.to(device).eval()

    def forward(self, image, points, x1, box_height=None,
                return_logits: bool = True):
        """NCHW forward. image (B, 3, H, W_pad); points (B*K, 3); x1 (B, K)
        left box edges in padded coordinates. Returns (B*K, 1, ph, pw)
        logits, or sigmoid responses when ``return_logits`` is False."""
        latent, skips = self.encoder(image, points, x1, box_height)
        logits = self.decoder(latent, skips,
                              shape=self.input_patch_size_image)[-1]
        return logits if return_logits else torch.sigmoid(logits)

    def apply(self, image, points, x1, box_height=None,
              return_logits: bool = True):
        """The JAX package's ``RadarNetModel.apply`` contract in NHWC:
        image (B, H, W_pad, 3) -> (B*K, ph, pw, 1)."""
        out = self.forward(image.permute(0, 3, 1, 2), points, x1,
                           box_height, return_logits)
        return out.permute(0, 2, 3, 1)
