"""RadarNet (counterpart of rcfd_tpu/models/radarnet.py): per-radar-point
correspondence network; inference, and training with ``trainable=True``."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from .. import default_device
from ..nn.perf import PerfConfig
from ..utils.checkpoint import restore_module, save_checkpoint
from . import losses
from .networks import MultiScaleDecoder, RadarNetV1Encoder

# the reference .pth keys of the two halves and of the optimizer
# (src/radarnet_model.py:225-233)
PTH_KEYS = {'encoder': 'radarnet_encoder_state_dict',
            'decoder': 'radarnet_decoder_state_dict'}
OPTIMIZER_KEY = 'radarnet_optimizer_state_dict'


class RadarNetModel(nn.Module):
    """ResNet image encoder + per-point ROI pooling + MLP point encoder +
    multiscale decoder (src/radarnet_model.py:36-124).

    Built on ``device`` (``cuda`` unless ``device='cpu'`` is given); weights
    come from ``init_parameters`` or
    ``load_state_dict(state_dict_from_jax(...))`` or ``restore_checkpoint``.
    By default the model serves: every parameter is frozen and it is in
    eval mode. ``trainable=True`` leaves the parameters trainable and the
    model in training mode (batch norm by the batch's statistics; the
    deferred skip pools off, as in the JAX package).
    ``perf`` (a PerfConfig) turns on the deferred skip pools, chooses the
    serving pipeline's scatter and sets the batched path's decode chunks;
    it adds no parameter.
    """

    def __init__(self, input_channels_image: int, input_channels_depth: int,
                 input_patch_size_image: Tuple[int, int], encoder_type: str,
                 n_filters_encoder_image: List[int],
                 n_neurons_encoder_depth: List[int], decoder_type: str,
                 n_filters_decoder: List[int],
                 weight_initializer: str = 'kaiming_uniform',
                 activation_func: str = 'leaky_relu', device=None,
                 perf: PerfConfig = None, trainable: bool = False):
        super().__init__()
        device = default_device(device)
        self.perf = perf if perf is not None else PerfConfig()
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
            perf=self.perf)
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
        if trainable:
            self.to(device).train()
        else:
            # serving: no autograd graph is recorded
            self.requires_grad_(False)
            self.to(device).eval()

    def forward(self, image, points, x1, box_height=None,
                return_logits: bool = True):
        """NCHW forward. image (B, 3, H, W_pad); points (B*K, 3); x1 (B, K)
        left box edges in padded coordinates. Returns (B*K, 1, ph, pw)
        logits, or sigmoid responses when ``return_logits`` is False."""
        return self._decode(*self.encoder(image, points, x1, box_height),
                            return_logits)

    def _decode(self, latent, skips, return_logits: bool):
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

    def forward_chunked(self, image, points, x1, n_chunks: int,
                        box_height=None, return_logits: bool = True):
        """``forward`` with the per-point half (ROI pools, MLP, patch
        decode) run in ``n_chunks`` sequential chunks along the point axis,
        so that the peak memory of the patch pyramids falls by n_chunks.
        image (B, 3, H, W_pad); points (B, K, 3); x1 (B, K); n_chunks must
        divide K. Chunk c takes points c*K/n_chunks .. (c+1)*K/n_chunks - 1
        of every frame. Returns (B, K, 1, ph, pw), equal to ``forward``'s
        (B*K, 1, ph, pw) reshaped."""
        b, k = points.shape[0], points.shape[1]
        if n_chunks < 1 or k % n_chunks:
            raise ValueError('n_chunks={} must divide K={}'.format(n_chunks,
                                                                  k))
        kc = k // n_chunks
        if box_height is None:
            box_height = image.shape[2]
        encoded = self.encoder.encode_image(image)
        outs = []
        for c in range(n_chunks):
            chunk = slice(c * kc, (c + 1) * kc)
            latent, skips = self.encoder.fuse_points(
                *encoded, points[:, chunk].reshape(-1, 3),
                x1[:, chunk].contiguous(), box_height)
            if c == n_chunks - 1:
                # the last decode needs no full-frame map: free them first,
                # so that one chunk peaks where ``forward`` does
                del encoded
            out = self._decode(latent, skips, return_logits)
            outs.append(out.reshape(b, kc, *out.shape[1:]))
        return outs[0] if n_chunks == 1 else torch.cat(outs, 1)

    def apply_chunked(self, image, points, x1, n_chunks: int,
                      box_height=None, return_logits: bool = True):
        """The JAX package's ``RadarNetModel.apply_chunked`` contract in
        NHWC: image (B, H, W_pad, 3), points (B, K, 3), x1 (B, K) ->
        (B, K, ph, pw, 1)."""
        out = self.forward_chunked(image.permute(0, 3, 1, 2), points, x1,
                                   n_chunks, box_height, return_logits)
        return out.permute(0, 1, 3, 4, 2)

    def compute_loss(self, logits, ground_truth, validity_map,
                     w_positive_class: float = 1.0):
        """Masked positive-weighted BCE normalized by the validity count
        (src/radarnet_model.py:126-167, rcfd_tpu/models/radarnet.py
        ``compute_loss``): logits, labels and validity of one shape.
        Returns (loss, {'loss': loss})."""
        loss = losses.binary_cross_entropy_with_logits(
            logits, ground_truth, pos_weight=w_positive_class)
        loss = (validity_map * loss).sum() / validity_map.sum()
        return loss, {'loss': loss}

    def n_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def save_checkpoint(self, path: str, step: int,
                        optimizer_state_dict: Optional[dict] = None,
                        jax_counts: bool = False):
        """Write the reference ``.pth`` (``train_step``,
        ``radarnet_optimizer_state_dict``, ``radarnet_encoder_state_dict``,
        ``radarnet_decoder_state_dict``) or, for a path ending ``.npz``,
        the JAX package's native format; either restores in the JAX
        package's ``RadarNetModel.restore_checkpoint``."""
        save_checkpoint(self, path, PTH_KEYS, step, optimizer_state_dict,
                        model_name='radarnet', optimizer_key=OPTIMIZER_KEY,
                        jax_counts=jax_counts)

    def restore_checkpoint(self, path: str, device=None,
                           return_optimizer_state: bool = False):
        """Load the weights of a reference ``.pth`` (keys
        ``radarnet_encoder_state_dict``, ``radarnet_decoder_state_dict``)
        or a JAX ``.npz`` checkpoint with ``load_state_dict(strict=True)``,
        and move the model to ``device`` (``cuda`` unless ``device='cpu'``
        is given). Returns the train step, or with ``return_optimizer_state``
        (train step, the file's optimizer state_dict or None: None also for
        the empty one the JAX package's training writes)."""
        return restore_module(self, path, PTH_KEYS, device,
                              return_optimizer_state, OPTIMIZER_KEY)
