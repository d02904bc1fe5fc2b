"""FusionNet (counterpart of rcfd_tpu/models/fusionnet.py): camera + quasi
dense radar depth -> dense depth, inference."""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from .. import default_device
from .networks import FusionNetEncoder, MultiScaleDecoder


class FusionNetModel(nn.Module):
    """Two-branch fusion encoder + multiscale decoder; the output maps to
    depth by ``min_d / (sigmoid(x) + min_d / max_d)``
    (src/fusionnet_model.py:162-165). Built on ``device`` like
    RadarNetModel."""

    def __init__(self, input_channels_image: int, input_channels_depth: int,
                 encoder_type: str, n_filters_encoder_image: List[int],
                 n_filters_encoder_depth: List[int], fusion_type: str,
                 decoder_type: str, n_resolution_decoder: int,
                 n_filters_decoder: List[int], deconv_type: str = 'up',
                 activation_func: str = 'leaky_relu',
                 weight_initializer: str = 'kaiming_uniform',
                 min_predict_depth: float = 1.5,
                 max_predict_depth: float = 100.0, device=None):
        super().__init__()
        device = default_device(device)
        self.min_predict_depth = min_predict_depth
        self.max_predict_depth = max_predict_depth
        if fusion_type in ('add', 'weight', 'weight_and_project'):
            n_filters_encoder = list(n_filters_encoder_image)
        elif fusion_type == 'concat':
            n_filters_encoder = [i + z for i, z in zip(
                n_filters_encoder_image, n_filters_encoder_depth)]
        else:
            raise ValueError('Unsupported fusion type: {}'.format(
                fusion_type))
        if 'fusionnet18' in encoder_type:
            n_layer = 18
        elif 'fusionnet34' in encoder_type:
            n_layer = 34
        else:
            # the image-only resnet encoders are in the port queue
            raise ValueError('Unsupported encoder type: {}'.format(
                encoder_type))
        self.encoder = FusionNetEncoder(
            n_layer, input_channels_image, input_channels_depth,
            n_filters_encoder_image, n_filters_encoder_depth,
            weight_initializer, activation_func,
            'batch_norm' in encoder_type, fusion_type)
        if 'multiscale' not in decoder_type:
            raise ValueError('Unsupported decoder type: {}'.format(
                decoder_type))
        n_skips = n_filters_encoder[:-1][::-1] + [0]
        self.decoder = MultiScaleDecoder(
            n_filters_encoder[-1], 1, n_resolution_decoder,
            n_filters_decoder, n_skips, weight_initializer, activation_func,
            'linear', use_batch_norm='batch_norm' in decoder_type,
            deconv_type=deconv_type)
        # inference only in this slice: no autograd graph is recorded
        self.requires_grad_(False)
        self.to(device).eval()

    def forward(self, image, input_depth):
        """NCHW forward: image (N, 3, H, W), input_depth (N, 2, H, W) ->
        depth (N, 1, H, W) in [min_predict_depth, max_predict_depth]."""
        latent, skips = self.encoder(image, input_depth)
        out = self.decoder(latent, skips, shape=image.shape[2:])[-1]
        return self.min_predict_depth / (
            torch.sigmoid(out) +
            self.min_predict_depth / self.max_predict_depth)

    def apply(self, image, input_depth):
        """The JAX package's ``FusionNetModel.apply`` contract in NHWC."""
        out = self.forward(image.permute(0, 3, 1, 2),
                           input_depth.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1)
