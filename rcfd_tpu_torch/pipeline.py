"""Two-stage serving pipeline: RadarNet -> quasi-dense scatter ->
FusionNet, one frame a call (``__call__``, or ``from_raw_radar`` from radar
returns in the sensor frame), a batch of frames (``forward_batched``) or a
batch sharded over devices (``forward_sharded``); counterpart of
rcfd_tpu/pipeline.py ``TwoStagePipeline``.

The reference composes the stages through 16-bit PNGs: the bridge writes
responses with save_response (x2^14) but FusionNet reads them back with
load_depth (x256), so the fused path scales the response by
2^14 / 256 = 64 to reproduce what a FusionNet checkpoint saw.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import default_device, parallel
from .data import transport
from .data.transforms import Transforms
from .geometry.transforms import project_points_to_image
from .models import FusionNetModel, RadarNetModel
from .nn.optimize import fold_batch_norm
from .ops import scatter as exact_scatter
from .ops import scatter_cuda

# load_depth(multiplier=256) applied to a save_response(x2^14) PNG
RESPONSE_DECODE_SCALE = float(2 ** 14) / 256.0
# patches the batched path decodes at once before it splits the decode into
# chunks (rcfd_tpu/pipeline.py:263-268)
PATCHES_PER_CHUNK = 512
# the dtypes the models can serve in (``compute_dtype``)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def decode_chunk_count(b: int, k: int, decode_chunks: Optional[int] = None
                       ) -> int:
    """Chunks of the per-point decode for b frames of k points:
    ``decode_chunks`` when it is set, else one per 512 patches; then
    lowered until it divides k."""
    if decode_chunks is not None:
        n_chunks = max(1, decode_chunks)
    else:
        n_chunks = max(1, (b * k) // PATCHES_PER_CHUNK)
    while n_chunks > 1 and k % n_chunks != 0:
        n_chunks -= 1
    return n_chunks


def encode_depth(depth):
    """A depth map on the 16-bit PNG codec grid: uint16 floor(z * 256)
    (float32; the product is exact, 256 being a power of two)."""
    return (depth.float() * 256.0).to(torch.uint16)


def encode_response(response):
    """A response map on the 16-bit PNG codec grid: uint16
    floor(r * 2^14)."""
    return (response.float() * 2.0 ** 14).to(torch.uint16)


def codec_encode(dense, quasi, response):
    """Quantize the three outputs to the 16-bit PNG codec grid: uint16
    floor(x * 256) for the depths, floor(x * 2^14) for the response."""
    return encode_depth(dense), encode_depth(quasi), encode_response(response)


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


def radarnet_crops(radarnet, transforms, images, points, image_height: int,
                   n_chunks: int = 1, compute_dtype=torch.float32):
    """Decode, normalize, edge-pad and run RadarNet, in its mode, on B
    frames: images (B, H, W, 3) in [0, 255] (uint8 under integer
    transport), points (B, K, 3) as (x, y, z), tensors on the model's
    device. RadarNet decodes the B*K patches in ``n_chunks`` chunks of
    K / n_chunks points of every frame (at once for one). Returns
    (image_t (B, 3, H, W), crops (B, K, ph, pw), xs (B, K) padded x, zs
    (B, K)): the image and the crops in ``compute_dtype``, xs and zs
    float32."""
    pad = radarnet.input_patch_size_image[1] // 2
    image_t = transforms.transform(transport.decode(images)).permute(
        0, 3, 1, 2).to(compute_dtype)
    image_pad = F.pad(image_t, (pad, pad, 0, 0), mode='replicate')
    points = points.float()
    xs = points[..., 0] + pad
    points_shifted = torch.stack([xs, points[..., 1], points[..., 2]], -1)
    responses = radarnet.forward_chunked(
        image_pad, points_shifted, xs - pad, n_chunks,
        box_height=image_height, return_logits=False)
    return image_t, responses.squeeze(2), xs, points[..., 2].contiguous()


class TwoStagePipeline:
    """Camera frames + radar points -> dense depth, on ``device`` (``cuda``
    unless ``device='cpu'`` is given). The two models carry their weights;
    they are moved to the device and put in eval mode. ``optimize`` folds
    every batch norm into its convolution (nn.optimize.fold_batch_norm),
    in copies of the two models. A request runs under
    ``serving_numerics()``.

    ``compute_dtype`` (None, torch.float32 or torch.bfloat16; None is
    float32) is the dtype the two models compute in, with the JAX package's
    rules (rcfd_tpu/pipeline.py ``compute_dtype``): after the optional fold,
    copies of both models have their floating parameters and buffers cast to
    it; the normalized image is cast to it, the radar points never (their
    pixel coordinates would move: bf16 steps by 8 above 1024); RadarNet's
    crops reach the scatter in it; FusionNet's input is cast to it after the
    bridge; the dense output comes back as float32. The quasi-dense maps are
    float32 whatever the dtype.

    The scatter is RadarNet's ``perf.pallas_scatter``, as in the JAX
    package (rcfd_tpu/pipeline.py:161-175): by default the exact float max
    (ops/scatter.py), with ``pallas_scatter=True`` the scatter kernel K1
    (ops/scatter_cuda.py) for up to ``scatter_cuda.MAX_POINTS`` points a
    frame. ``scatter`` and ``scatter_batched`` are the chosen route."""

    def __init__(self, radarnet, fusionnet, image_height: int,
                 image_width: int, normalized_image_range=(0, 1),
                 quantize_bridge: bool = True, codec_encode: bool = False,
                 optimize: bool = False, compute_dtype=None, device=None):
        self.device = default_device(device)
        self.compute_dtype = compute_dtype or torch.float32
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise NotImplementedError(
                'compute_dtype {} is not served; it takes None, torch.float32 '
                'or torch.bfloat16'.format(compute_dtype))
        if optimize:
            # the fold runs in float32, on copies, before any cast
            radarnet = fold_batch_norm(radarnet)
            fusionnet = fold_batch_norm(fusionnet)
        elif self.compute_dtype != torch.float32:
            radarnet, fusionnet = copy.deepcopy(radarnet), \
                copy.deepcopy(fusionnet)
        self.radarnet = radarnet.to(self.device, self.compute_dtype).eval()
        self.fusionnet = fusionnet.to(self.device, self.compute_dtype).eval()
        self.image_height = image_height
        self.image_width = image_width
        self.transforms = Transforms(normalized_image_range)
        self.quantize_bridge = quantize_bridge
        self.codec_encode = codec_encode
        self.pallas_scatter = bool(self.radarnet.perf.pallas_scatter)
        route = scatter_cuda if self.pallas_scatter else exact_scatter
        self.scatter = route.scatter_quasi_dense
        self.scatter_batched = route.scatter_quasi_dense_batched
        self._sharded_key = self._sharded = None  # forward_sharded's replicas

    def _tensor(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device)

    def radarnet_stage(self, image, points):
        """Decode, normalize, edge-pad and run RadarNet on one frame.
        image (1, H, W, 3) in [0, 255] (uint8 under integer transport);
        points (K, 3) as (x, y, z). Returns (image_t (1, 3, H, W), crops
        (K, ph, pw), xs (K,) padded x, zs (K,))."""
        image_t, crops, xs, zs = self.radarnet_stage_batched(
            image, self._tensor(points)[None])
        return image_t, crops[0], xs[0], zs[0]

    def radarnet_stage_batched(self, images, points, n_chunks: int = 1):
        """``radarnet_stage`` over B frames: images (B, H, W, 3), points
        (B, K, 3); ``radarnet_crops`` in the compute dtype."""
        return radarnet_crops(self.radarnet, self.transforms,
                              self._tensor(images), self._tensor(points),
                              self.image_height, n_chunks,
                              self.compute_dtype)

    def bridge(self, depth_map, response_map):
        """The codec bridge: optional PNG quantization, then FusionNet's
        (B, 2, H, W) input with the response scaled by 64, in the compute
        dtype, from (H, W) maps (B = 1) or (B, H, W) ones."""
        if self.quantize_bridge:
            depth_map, response_map = quantize_bridge(depth_map,
                                                      response_map)
        input_depth = torch.stack(
            [depth_map, response_map * RESPONSE_DECODE_SCALE], -3)
        input_depth = input_depth.reshape(-1, *input_depth.shape[-3:])
        return depth_map, response_map, input_depth.to(self.compute_dtype)

    def _outputs(self, dense, depth_map, response_map):
        outs = (dense.float(), depth_map, response_map)
        return codec_encode(*outs) if self.codec_encode else outs

    @torch.inference_mode()
    def __call__(self, image, points, valid):
        """Returns (dense_depth, quasi_depth, response), each (H, W);
        uint16 on the codec grid when ``codec_encode`` is set."""
        with serving_numerics():
            return self._serve(image, points, valid)

    @torch.inference_mode()
    def from_raw_radar(self, image, points_sensor, valid, sensor_to_camera,
                       intrinsics, min_distance_from_camera: float = 1.0):
        """Serve from raw radar returns: points_sensor (K, 3) in the radar
        sensor frame, valid (K,), sensor_to_camera the 4x4 rigid transform
        (geometry.sensor_to_camera_matrix), intrinsics the 3x3 K. The
        returns are projected on the device (project_points_to_image), each
        becomes (round(x), round(y), depth) in float32, the ones behind the
        camera or off the frame are made invalid and zeroed, and the rest
        is ``__call__``'s (the same scatter route and outputs)."""
        with serving_numerics():
            xy, depth, proj_mask = project_points_to_image(
                self._tensor(points_sensor).float(), sensor_to_camera,
                intrinsics, self.image_height, self.image_width,
                min_distance_from_camera=min_distance_from_camera,
                device=self.device)
            # image-plane points as stage 0's .npy files carry them
            points_img = torch.stack([torch.round(xy[:, 0]),
                                      torch.round(xy[:, 1]), depth], -1)
            valid_all = self._tensor(valid).to(torch.bool) & proj_mask
            points_img = torch.where(valid_all[:, None], points_img,
                                     torch.zeros_like(points_img))
            return self._serve(image, points_img, valid_all)

    def _scatter_for(self, k: int, batched: bool):
        """The scatter of a request of k points a frame: the chosen route,
        or the exact max where K1 cannot take k points."""
        if self.pallas_scatter and k > scatter_cuda.MAX_POINTS:
            return exact_scatter.scatter_quasi_dense_batched if batched \
                else exact_scatter.scatter_quasi_dense
        return self.scatter_batched if batched else self.scatter

    def _serve(self, image, points, valid):
        image_t, crops, xs, zs = self.radarnet_stage(image, points)
        depth_map, response_map = self._scatter_for(crops.shape[0], False)(
            crops, xs, zs, self._tensor(valid).to(torch.bool),
            image_height=self.image_height, image_width=self.image_width,
            patch_size=self.radarnet.input_patch_size_image)
        depth_map, response_map, input_depth = self.bridge(depth_map,
                                                           response_map)
        dense = self.fusionnet(image_t, input_depth)[0, 0]
        return self._outputs(dense, depth_map, response_map)

    @torch.inference_mode()
    def forward_batched(self, images, points, valid):
        """The batched serving path (fps = B / t). images (B, H, W, 3) in
        [0, 255]; points (B, K, 3); valid (B, K). RadarNet's patch decode
        runs in ``decode_chunk_count(B, K, radarnet.perf.decode_chunks)``
        chunks; the scatter runs once over the B frames. Returns
        (dense, quasi, response), each (B, H, W); frame b equals
        ``__call__`` of frame b."""
        with serving_numerics():
            return self._forward_batched(images, points, valid)

    def _forward_batched(self, images, points, valid):
        points = self._tensor(points)
        b, k = points.shape[0], points.shape[1]
        n_chunks = decode_chunk_count(b, k, self.radarnet.perf.decode_chunks)
        image_t, crops, xs, zs = self.radarnet_stage_batched(
            images, points, n_chunks)
        depth_map, response_map = self._scatter_for(k, True)(
            crops, xs, zs, self._tensor(valid).to(torch.bool),
            image_height=self.image_height, image_width=self.image_width,
            patch_size=self.radarnet.input_patch_size_image)
        depth_map, response_map, input_depth = self.bridge(depth_map,
                                                           response_map)
        dense = self.fusionnet(image_t, input_depth)[:, 0]
        return self._outputs(dense, depth_map, response_map)

    @torch.inference_mode()
    def forward_sharded(self, images, points, valid, devices=None):
        """Data-parallel serving (rcfd_tpu/pipeline.py ``forward_sharded``):
        the batch split along its leading axis into ``len(devices)``
        contiguous shards, which must be equal, each served by
        ``forward_batched``'s path on its device (its own decode chunks,
        its own scatter: K1 once a shard under ``pallas_scatter=True``),
        shard i on the process's thread i (``parallel.shard_threads``: the
        per-point decode waits on the host, and a kept thread keeps cuDNN's
        plans); the outputs gathered on ``devices[0]``. ``devices``
        defaults to ``parallel.get_devices(device=self.device)``: every
        visible card, or the pipeline's CPU. The models are replicated once
        per device list and kept: a device that repeats reuses one replica,
        and the pipeline's own device its own models. Arguments and returns
        as ``forward_batched``'s; each frame equals ``forward_batched`` of
        its shard run on the shard's thread. On a card, where
        ``serving_numerics`` autotunes cuDNN (``cudnn.benchmark``) and the
        plans are kept per thread, a shard thread may choose another
        convolution algorithm than the caller's thread for the same shape:
        the frames may then differ from ``forward_batched`` called in the
        caller's thread in the last bits (dense depth in its float
        rounding, a quasi or response code at a 14-bit tie or the
        threshold)."""
        if devices is None:
            devices = parallel.get_devices(device=self.device)
        devices = [_indexed(d) for d in devices]
        shards = parallel.shard_batch((images, points, valid), len(devices))
        replicas = self._replicas(devices)
        with serving_numerics():
            outs = parallel.shard_threads(len(devices)).map(
                _serve_shard, list(zip(replicas, devices, shards)))
        return tuple(torch.cat([o[i].to(devices[0]) for o in outs])
                     for i in range(3))

    def _replicas(self, devices):
        """The pipeline a shard on each of ``devices`` is served by."""
        key = tuple(devices)
        if self._sharded_key != key:
            by_device = {_indexed(self.device): self}
            for device in devices:
                if device not in by_device:
                    replica = copy.copy(self)
                    replica.device = device
                    replica.radarnet = copy.deepcopy(self.radarnet).to(device)
                    replica.fusionnet = copy.deepcopy(self.fusionnet).to(
                        device)
                    replica._sharded_key = replica._sharded = None
                    by_device[device] = replica
            self._sharded = [by_device[d] for d in devices]
            self._sharded_key = key
        return self._sharded

    @classmethod
    def from_checkpoints(cls, radarnet_restore_path: str,
                         fusionnet_restore_path: str,
                         image_height: int = 900, image_width: int = 1600,
                         patch_size=(900, 288),
                         radarnet_kwargs: Optional[dict] = None,
                         fusionnet_kwargs: Optional[dict] = None,
                         device=None, **kwargs):
        """Build from the reference's canonical configurations (those of
        rcfd_tpu/pipeline.py ``from_checkpoints``), updated by
        ``radarnet_kwargs`` / ``fusionnet_kwargs``, and two checkpoint
        files (reference ``.pth`` or JAX ``.npz``), on ``device``. Other
        keyword arguments go to the constructor."""
        device = default_device(device)
        rn_kwargs = dict(
            input_channels_image=3,
            input_channels_depth=3,
            input_patch_size_image=tuple(patch_size),
            encoder_type='radarnetv1_batch_norm',
            n_filters_encoder_image=[32, 64, 128, 128, 128],
            n_neurons_encoder_depth=[32, 64, 128, 128, 128],
            decoder_type='multiscale_batch_norm',
            n_filters_decoder=[256, 128, 64, 32, 16])
        rn_kwargs.update(radarnet_kwargs or {})
        fn_kwargs = dict(
            input_channels_image=3,
            input_channels_depth=2,
            encoder_type='fusionnet18_batch_norm',
            n_filters_encoder_image=[32, 64, 128, 256, 256, 256],
            n_filters_encoder_depth=[16, 32, 64, 128, 128, 128],
            fusion_type='weight_and_project',
            decoder_type='multiscale_batch_norm',
            n_resolution_decoder=1,
            n_filters_decoder=[256, 256, 128, 64, 64, 32],
            min_predict_depth=1.0,
            max_predict_depth=100.0)
        fn_kwargs.update(fusionnet_kwargs or {})
        radarnet = RadarNetModel(**rn_kwargs, device=device)
        fusionnet = FusionNetModel(**fn_kwargs, device=device)
        radarnet.restore_checkpoint(radarnet_restore_path, device=device)
        fusionnet.restore_checkpoint(fusionnet_restore_path, device=device)
        return cls(radarnet, fusionnet, image_height, image_width,
                   device=device, **kwargs)


def _indexed(device) -> torch.device:
    """``device`` with its index: cuda is the current card."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def _serve_shard(pipe, device, shard):
    """``forward_batched``'s path of ``pipe`` on one shard, in the calling
    thread (inference mode and the current card are the thread's own; the
    caller holds the serving numerics)."""
    cuda = torch.cuda.device(device) if device.type == 'cuda' \
        else contextlib.nullcontext()
    with torch.inference_mode(), cuda:
        return pipe._forward_batched(*shard)
