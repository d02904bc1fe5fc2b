"""The serving graphs the measurement tools time, at the JAX package's
shapes, with weights drawn from a seed.

``CONFIG``, ``HEIGHT``, ``WIDTH`` and ``inputs`` are bench.py's (its
FusionNet, the nuScenes frame and the integer-transport inputs,
bench.py:34-66), copied here once for every tool of the port.
``RADARNET`` and ``FUSIONNET`` are the canonical pair the JAX tools build
their ``TwoStagePipeline`` of (tools/roofline.py, tools/pipebisect.py,
tools/microbench.py). A model is built on the CPU, drawn from its seed by
``init_parameters`` and moved to its device; on the ``meta`` device (shape
only, for the roofline's accounting) it is built there and not drawn.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import FusionNetModel, RadarNetModel
from ..nn.layers import init_parameters
from ..nn.optimize import fold_batch_norm
from ..pipeline import TwoStagePipeline

HEIGHT, WIDTH = 900, 1600
CONFIG = dict(
    input_channels_image=3,
    input_channels_depth=2,
    encoder_type='fusionnet18_batch_norm',
    n_filters_encoder_image=[32, 64, 128, 256, 256, 256],
    n_filters_encoder_depth=[16, 32, 64, 128, 128, 128],
    fusion_type='weight_and_project',
    decoder_type='multiscale_batch_norm',
    n_resolution_decoder=1,
    n_filters_decoder=[256, 256, 128, 64, 64, 32],
    deconv_type='up',
    activation_func='leaky_relu',
    weight_initializer='kaiming_uniform',
    min_predict_depth=1.0,
    max_predict_depth=100.0,
)
RADARNET = dict(
    input_channels_image=3, input_channels_depth=3,
    input_patch_size_image=(900, 288),
    encoder_type='radarnetv1_batch_norm',
    n_filters_encoder_image=[32, 64, 128, 128, 128],
    n_neurons_encoder_depth=[32, 64, 128, 128, 128],
    decoder_type='multiscale_batch_norm',
    n_filters_decoder=[256, 128, 64, 32, 16])
FUSIONNET = dict(
    input_channels_image=3, input_channels_depth=2,
    encoder_type='fusionnet18_batch_norm',
    n_filters_encoder_image=[32, 64, 128, 256, 256, 256],
    n_filters_encoder_depth=[16, 32, 64, 128, 128, 128],
    fusion_type='weight_and_project',
    decoder_type='multiscale_batch_norm',
    n_resolution_decoder=1,
    n_filters_decoder=[256, 256, 128, 64, 64, 32],
    min_predict_depth=1.0, max_predict_depth=100.0)
DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def inputs(batch: int, rng):
    """bench.py's ``_inputs``: uint8 camera frames and uint16 x256-codec
    depth and response streams, NHWC numpy arrays, as the loader ships
    them."""
    image = rng.integers(0, 256, (batch, HEIGHT, WIDTH, 3), dtype=np.uint8)
    depth = rng.integers(0, 80 * 256, (batch, HEIGHT, WIDTH, 1),
                         dtype=np.uint16)
    response = rng.integers(0, 256, (batch, HEIGHT, WIDTH, 1),
                            dtype=np.uint16)
    return image, depth, response


def build(cls, config: dict, seed: int, device, **kwargs):
    """``cls(**config)`` on ``device`` with every weight drawn from
    ``seed`` (built on the CPU and moved), or on ``meta`` undrawn."""
    device = torch.device(device)
    if device.type == 'meta':
        return cls(**config, device=device, **kwargs)
    model = cls(**config, device='cpu', **kwargs)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def fusionnet_folded(dtype: str, device, seed: int = 0):
    """bench.py's FusionNet (``CONFIG``) in eval mode, batch norm folded
    (in float32), then cast to ``dtype`` ('bfloat16' or 'float32')."""
    model = fold_batch_norm(build(FusionNetModel, CONFIG, seed, device))
    return model.to(dtype=DTYPES[dtype]).eval()


def pipeline(dtype: str, device, perf=None):
    """The canonical ``TwoStagePipeline(optimize=True, compute_dtype=...)``
    of the JAX tools: RadarNet drawn from seed 0, FusionNet from seed 1.
    ``perf`` is RadarNet's PerfConfig (``pallas_scatter=True`` takes K1)."""
    rn = build(RadarNetModel, RADARNET, 0, device,
               **({} if perf is None else {'perf': perf}))
    fn = build(FusionNetModel, FUSIONNET, 1, device)
    return TwoStagePipeline(rn, fn, HEIGHT, WIDTH, optimize=True,
                            compute_dtype=DTYPES[dtype], device=device)


def frames_and_points(b: int, k: int, rng, float_images: bool = False):
    """The JAX tools' serving request: b frames (uint8, or float32 in
    [0, 255) with ``float_images``), k points a frame (x, y, z) with z in
    [1, 71), every point valid; numpy arrays."""
    if float_images:
        images = rng.random((b, HEIGHT, WIDTH, 3), dtype=np.float32) * 255
    else:
        images = rng.integers(0, 256, (b, HEIGHT, WIDTH, 3), dtype=np.uint8)
    points = np.stack([
        rng.integers(0, WIDTH, (b, k)).astype(np.float32),
        rng.integers(0, HEIGHT, (b, k)).astype(np.float32),
        rng.random((b, k), dtype=np.float32) * 70 + 1], axis=-1)
    return images, points, np.ones((b, k), bool)


def on(device, *arrays):
    """numpy arrays as tensors on ``device`` (empty ones on ``meta``)."""
    device = torch.device(device)
    if device.type == 'meta':
        return tuple(torch.empty(a.shape, dtype=torch.from_numpy(
            a[:0].copy()).dtype, device=device) for a in arrays)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)
