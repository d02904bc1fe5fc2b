"""Two-stage serving pipeline, one frame: RadarNet -> quasi-dense scatter
kernel -> FusionNet (counterpart of rcfd_tpu/pipeline.py
``TwoStagePipeline.__call__``).

The reference composes the stages through 16-bit PNGs: the bridge writes
responses with save_response (x2^14) but FusionNet reads them back with
load_depth (x256), so the fused path scales the response by
2^14 / 256 = 64 to reproduce what a FusionNet checkpoint saw.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from . import default_device
from .data import transport
from .data.transforms import Transforms
from .nn.optimize import fold_batch_norm
from .ops import scatter_cuda

# load_depth(multiplier=256) applied to a save_response(x2^14) PNG
RESPONSE_DECODE_SCALE = float(2 ** 14) / 256.0


def codec_encode(dense, quasi, response):
    """Quantize the three outputs to the 16-bit PNG codec grid: uint16
    floor(x * 256) for the depths, floor(x * 2^14) for the response."""
    return ((dense.float() * 256.0).to(torch.uint16),
            (quasi.float() * 256.0).to(torch.uint16),
            (response.float() * 2.0 ** 14).to(torch.uint16))


def quantize_bridge(depth_map, response_map):
    """Round the quasi-dense maps through the PNG codec (x256 / x2^14), as
    the file-based two-stage path does."""
    return (torch.floor(depth_map * 256.0) / 256.0,
            torch.floor(response_map * 2.0 ** 14) / 2.0 ** 14)


@contextlib.contextmanager
def serving_numerics():
    """The numerics the pipeline serves with, restored on exit: float32
    throughout (TF32 off for convolutions and matmuls, as the parity with
    the JAX package needs), and cuDNN convolution algorithms chosen by
    timing at the first call of each shape, among deterministic ones.
    cuDNN's heuristic choice runs FusionNet's convolutions several times
    slower and in more memory."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
             matmul.allow_tf32)
    cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32 = True, True, False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
         matmul.allow_tf32) = saved


class TwoStagePipeline:
    """Camera frame + radar points -> dense depth, on ``device`` (``cuda``
    unless ``device='cpu'`` is given). The two models carry their weights;
    they are moved to the device and put in eval mode. ``optimize`` folds
    every batch norm into its convolution (nn.optimize.fold_batch_norm),
    in copies of the two models. A request runs under
    ``serving_numerics()``."""

    def __init__(self, radarnet, fusionnet, image_height: int,
                 image_width: int, normalized_image_range=(0, 1),
                 quantize_bridge: bool = True, codec_encode: bool = False,
                 optimize: bool = False, device=None):
        self.device = default_device(device)
        if optimize:
            radarnet = fold_batch_norm(radarnet)
            fusionnet = fold_batch_norm(fusionnet)
        self.radarnet = radarnet.to(self.device).eval()
        self.fusionnet = fusionnet.to(self.device).eval()
        self.image_height = image_height
        self.image_width = image_width
        self.transforms = Transforms(normalized_image_range)
        self.quantize_bridge = quantize_bridge
        self.codec_encode = codec_encode
        self.scatter = scatter_cuda.scatter_quasi_dense

    def _tensor(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device)

    def radarnet_stage(self, image, points):
        """Decode, normalize, edge-pad and run RadarNet. image (1, H, W, 3)
        in [0, 255] (uint8 under integer transport); points (K, 3) as
        (x, y, z). Returns (image_t (1, 3, H, W), crops (K, ph, pw),
        xs (K,) padded x, zs (K,))."""
        pad = self.radarnet.input_patch_size_image[1] // 2
        image = transport.decode(self._tensor(image))
        image_t = self.transforms.transform(image).permute(0, 3, 1, 2)
        image_pad = F.pad(image_t, (pad, pad, 0, 0), mode='replicate')
        points = self._tensor(points).float()
        xs = points[:, 0] + pad
        points_shifted = torch.stack([xs, points[:, 1], points[:, 2]], 1)
        x1 = (xs - pad)[None, :]
        responses = self.radarnet(image_pad, points_shifted, x1,
                                  box_height=self.image_height,
                                  return_logits=False)
        return image_t, responses[:, 0], xs, points[:, 2].contiguous()

    def bridge(self, depth_map, response_map):
        """The codec bridge: optional PNG quantization, then FusionNet's
        (1, 2, H, W) input with the response scaled by 64."""
        if self.quantize_bridge:
            depth_map, response_map = quantize_bridge(depth_map,
                                                      response_map)
        input_depth = torch.stack(
            [depth_map, response_map * RESPONSE_DECODE_SCALE])[None]
        return depth_map, response_map, input_depth

    @torch.inference_mode()
    def __call__(self, image, points, valid):
        """Returns (dense_depth, quasi_depth, response), each (H, W);
        uint16 on the codec grid when ``codec_encode`` is set."""
        with serving_numerics():
            return self._serve(image, points, valid)

    def _serve(self, image, points, valid):
        image_t, crops, xs, zs = self.radarnet_stage(image, points)
        depth_map, response_map = self.scatter(
            crops, xs, zs, self._tensor(valid).to(torch.bool),
            image_height=self.image_height, image_width=self.image_width,
            patch_size=self.radarnet.input_patch_size_image)
        depth_map, response_map, input_depth = self.bridge(depth_map,
                                                           response_map)
        dense = self.fusionnet(image_t, input_depth)[0, 0]
        outs = (dense.float(), depth_map, response_map)
        return codec_encode(*outs) if self.codec_encode else outs
