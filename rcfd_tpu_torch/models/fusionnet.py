"""FusionNet (counterpart of rcfd_tpu/models/fusionnet.py): camera + quasi
dense radar depth -> dense depth; inference, and training with
``trainable=True``."""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from .. import default_device
from ..nn import functional as F
from ..utils.checkpoint import restore_module, save_checkpoint
from . import losses
from .networks import FusionNetEncoder, MultiScaleDecoder, ResNetEncoder

# the reference .pth keys of the two halves (src/fusionnet_model.py:360-368)
PTH_KEYS = {'encoder': 'encoder_state_dict',
            'decoder': 'decoder_state_dict'}


class FusionNetModel(nn.Module):
    """Two-branch fusion encoder + multiscale decoder; the output maps to
    depth by ``min_d / (sigmoid(x) + min_d / max_d)``
    (src/fusionnet_model.py:162-165). Built on ``device`` like
    RadarNetModel. ``encoder_type`` 'fusionnet18' / 'fusionnet34' fuses
    the image and the input depth; 'resnet18' / 'resnet34' encodes the
    image alone (the input depth is ignored). ``n_resolution_decoder``
    above 1 adds the decoder's side outputs (``forward(...,
    return_multiscale=True)``); ``deconv_type`` is 'up' or 'transpose'.

    By default the model serves: every parameter is frozen and it is in
    eval mode (batch norm by its running statistics). ``trainable=True``
    leaves the parameters trainable and the model in training mode (batch
    norm by the batch's statistics, updating the running ones); ``eval()``
    and ``train()`` switch batch norm as for any nn.Module.
    ``parameters()`` comes in the JAX package's flat tree order, so that
    an Adam state index is the same tensor in both packages."""

    def __init__(self, input_channels_image: int, input_channels_depth: int,
                 encoder_type: str, n_filters_encoder_image: List[int],
                 n_filters_encoder_depth: List[int], fusion_type: str,
                 decoder_type: str, n_resolution_decoder: int,
                 n_filters_decoder: List[int], deconv_type: str = 'up',
                 activation_func: str = 'leaky_relu',
                 weight_initializer: str = 'kaiming_uniform',
                 min_predict_depth: float = 1.5,
                 max_predict_depth: float = 100.0, device=None,
                 trainable: bool = False):
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
        if 'fusionnet18' in encoder_type or 'resnet18' in encoder_type:
            n_layer = 18
        elif 'fusionnet34' in encoder_type or 'resnet34' in encoder_type:
            n_layer = 34
        else:
            raise ValueError('Unsupported encoder type: {}'.format(
                encoder_type))
        use_batch_norm = 'batch_norm' in encoder_type
        # image only: a ResNet encoder of the image; the input depth is
        # taken and not used
        self.image_only = not ('fusionnet18' in encoder_type or
                               'fusionnet34' in encoder_type)
        if self.image_only:
            self.encoder = ResNetEncoder(
                n_layer, input_channels_image, n_filters_encoder_image,
                weight_initializer, activation_func, use_batch_norm)
            n_filters_encoder = list(n_filters_encoder_image)
        else:
            self.encoder = FusionNetEncoder(
                n_layer, input_channels_image, input_channels_depth,
                n_filters_encoder_image, n_filters_encoder_depth,
                weight_initializer, activation_func, use_batch_norm,
                fusion_type)
        if 'multiscale' not in decoder_type:
            raise ValueError('Unsupported decoder type: {}'.format(
                decoder_type))
        n_skips = n_filters_encoder[:-1][::-1] + [0]
        self.decoder = MultiScaleDecoder(
            n_filters_encoder[-1], 1, n_resolution_decoder,
            n_filters_decoder, n_skips, weight_initializer, activation_func,
            'linear', use_batch_norm='batch_norm' in decoder_type,
            deconv_type=deconv_type)
        if trainable:
            self.to(device).train()
        else:
            # serving: no autograd graph is recorded
            self.requires_grad_(False)
            self.to(device).eval()

    def forward(self, image, input_depth, return_multiscale: bool = False):
        """NCHW forward: image (N, 3, H, W), input_depth (N, 2, H, W) ->
        depth (N, 1, H, W) in [min_predict_depth, max_predict_depth]; with
        ``return_multiscale`` the list of the decoder's outputs, each
        mapped to depth, from the coarsest to the full-resolution one."""
        if self.image_only:
            latent, skips = self.encoder(image)
        else:
            latent, skips = self.encoder(image, input_depth)
        outputs = [self.min_predict_depth / (
            torch.sigmoid(out) +
            self.min_predict_depth / self.max_predict_depth)
            for out in self.decoder(latent, skips, shape=image.shape[2:])]
        return outputs if return_multiscale else outputs[-1]

    def apply(self, image, input_depth, return_multiscale: bool = False):
        """The JAX package's ``FusionNetModel.apply`` contract in NHWC."""
        out = self.forward(image.permute(0, 3, 1, 2),
                           input_depth.permute(0, 3, 1, 2),
                           return_multiscale)
        if return_multiscale:
            return [o.permute(0, 2, 3, 1) for o in out]
        return out.permute(0, 2, 3, 1)

    def compute_loss(self, image, output_depth, ground_truth, lidar_map,
                     loss_func: str, w_smoothness: float,
                     loss_smoothness_kernel_size: int,
                     validity_map_loss_smoothness, w_lidar_loss: float):
        """Masked multi-scale supervised + lidar + smoothness loss
        (src/fusionnet_model.py:172-302, rcfd_tpu/models/fusionnet.py
        ``compute_loss``), NCHW maps with C = 1. With ``w_lidar_loss`` the
        ground truth is masked where the lidar map has a return, so the two
        terms do not count a pixel twice. Returns (loss, loss_info)."""
        loss_supervised = 0.0
        loss_smoothness = 0.0
        loss_lidar = 0.0
        if w_lidar_loss > 0.0:
            ground_truth = torch.where(lidar_map > 0.0,
                                       torch.zeros_like(ground_truth),
                                       ground_truth)
        validity_map_ground_truth = (ground_truth > 0).to(ground_truth.dtype)
        validity_map_lidar = (lidar_map > 0).to(lidar_map.dtype)
        if not isinstance(output_depth, (list, tuple)):
            output_depth = [output_depth]
        loss_fn = {'l1': losses.l1_loss, 'l2': losses.l2_loss,
                   'smoothl1': losses.smooth_l1_loss}.get(loss_func)
        if loss_fn is None:
            raise ValueError('No such loss: {}'.format(loss_func))
        n_scales = len(output_depth)
        for scale, output in enumerate(output_depth):
            oh, ow = output.shape[2:]
            th, tw = ground_truth.shape[2:]
            if oh > th and ow > tw:
                output = F.resize_bilinear_align_corners(output, (th, tw))
            w_scale = 1.0 / (2 ** (n_scales - scale - 1))
            loss_supervised = loss_supervised + w_scale * loss_fn(
                output, ground_truth, weight=validity_map_ground_truth)
            if w_lidar_loss > 0.0:
                loss_lidar = loss_lidar + w_scale * loss_fn(
                    output, lidar_map, weight=validity_map_lidar)
            if w_smoothness > 0.0:
                if loss_smoothness_kernel_size <= 1:
                    term = losses.smoothness_loss_func(predict=output,
                                                       image=image)
                else:
                    k = loss_smoothness_kernel_size
                    term = losses.sobel_smoothness_loss_func(
                        predict=output, image=image,
                        weights=validity_map_loss_smoothness,
                        filter_size=(1, 1, k, k))
                loss_smoothness = loss_smoothness + w_scale * term
        loss = loss_supervised + w_smoothness * loss_smoothness + \
            w_lidar_loss * loss_lidar
        return loss, {'loss': loss, 'loss_supervised': loss_supervised,
                      'loss_smoothness': loss_smoothness,
                      'loss_lidar': loss_lidar}

    def n_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def save_checkpoint(self, path: str, step: int,
                        optimizer_state_dict: Optional[dict] = None,
                        jax_counts: bool = False):
        """Write the reference ``.pth`` (``train_step``,
        ``optimizer_state_dict``, ``encoder_state_dict``,
        ``decoder_state_dict``) or, for a path ending ``.npz``, the JAX
        package's native format; either restores in the JAX package's
        ``FusionNetModel.restore_checkpoint``."""
        save_checkpoint(self, path, PTH_KEYS, step, optimizer_state_dict,
                        model_name='fusionnet',
                        jax_counts=jax_counts)

    def restore_checkpoint(self, path: str, device=None,
                           return_optimizer_state: bool = False):
        """Load the weights of a reference ``.pth`` (keys
        ``encoder_state_dict``, ``decoder_state_dict``) or a JAX ``.npz``
        checkpoint with ``load_state_dict(strict=True)``, and move the
        model to ``device`` (``cuda`` unless ``device='cpu'`` is given).
        Returns the train step, or with ``return_optimizer_state`` (train
        step, the file's optimizer state_dict or None)."""
        return restore_module(self, path, PTH_KEYS, device,
                              return_optimizer_state)
