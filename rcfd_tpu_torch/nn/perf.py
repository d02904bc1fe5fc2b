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

The port reads no environment variable. The TPU layout gates of the JAX
package (fast_decoder, packed_*, s2d_*, int8_tail, fused_upsample) are not
ported, nor are those that choose between a Pallas kernel and XLA
(fused_pool2_pallas, pallas_crop, fused_pool2_gather, pool_window_gather):
in the port a kernel is the route on the card and its plain PyTorch version
the route on the CPU, chosen by the device of the tensors.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PerfConfig:
    fused_pool2: bool = False
    fused_pool4: bool = False
