"""Configuration of the optional paths of the port (counterpart of
rcfd_tpu/nn/perf.py), passed to the model constructors.

Only the gates the port honours are here, with the JAX package's names and
defaults:

  fused_pool2  Defer the 1/2-scale column ROI pool to a LazyColumnWindows
               and let ``deconv1`` convolve the skip half once on the global
               map, gathering windows of the result into its sum
               (ops/fused_skip.py). Taken when the pooled width is at most
               256.
  fused_pool4  The same for the 1/4-scale pool and ``deconv2``.
  pallas_scatter  The quasi-dense scatter of the serving pipeline
               (RadarNet's perf chooses it, as in the JAX package): None or
               False is the exact float max (ops/scatter.py, the JAX
               default); True is the scatter kernel, K1
               (ops/scatter_cuda.py), which quantizes the response to 14
               bits before the max, so that inside one 2^-14 step the first
               point wins. K1 takes at most scatter_cuda.MAX_POINTS points a
               frame; above that the exact max serves.
  decode_chunks  Chunks of the per-point patch decode of the batched
               serving path (``TwoStagePipeline.forward_batched``); None
               chooses one chunk per 512 patches
               (``pipeline.decode_chunk_count``).

The port reads no environment variable. The TPU layout gates of the JAX
package (fast_decoder, packed_*, s2d_*, int8_tail, fused_upsample) are not
ported, nor are those that choose between a Pallas kernel and XLA for the
same result (fused_pool2_pallas, pallas_crop, fused_pool2_gather,
pool_window_gather): in the port a kernel is the route on the card and its
plain PyTorch version the route on the CPU, chosen by the device of the
tensors. pallas_scatter is kept because its two routes give different
results.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class PerfConfig:
    fused_pool2: bool = False
    fused_pool4: bool = False
    pallas_scatter: Optional[bool] = None
    decode_chunks: Optional[int] = None
