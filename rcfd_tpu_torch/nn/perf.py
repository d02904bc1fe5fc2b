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
  pallas_scatter  The quasi-dense scatter (RadarNet's perf chooses it, as
               in the JAX package): True is the scatter kernel, K1
               (ops/scatter_cuda.py), which quantizes the response to 14
               bits before the max, so that inside one 2^-14 step the first
               point wins; False is the exact float max (ops/scatter.py).
               None depends on the context, as in the JAX package: the
               serving pipeline takes the exact max
               (rcfd_tpu/pipeline.py:88-92); RadarNet's own scatter
               inference (radarnet_main.py, training's validation) takes K1
               on the card and the exact max on the CPU, JAX's rule with the
               card in the TPU's place (rcfd_tpu/radarnet_main.py:245-252).
               K1 takes at most scatter_cuda.MAX_POINTS points a frame;
               above that the exact max serves.
  decode_chunks  Chunks of the per-point patch decode of the batched
               serving path (``TwoStagePipeline.forward_batched``); None
               chooses one chunk per 512 patches
               (``pipeline.decode_chunk_count``).

The models read no environment variable; the CLIs build RadarNet's
PerfConfig with ``perf_from_env``, from the JAX package's RCFD_* gates of
the same names, and the run drivers their models' dtype with
``compute_dtype_from_env`` from RCFD_COMPUTE_DTYPE. The TPU layout gates of the JAX
package (fast_decoder, packed_*, s2d_*, int8_tail, fused_upsample) are not
ported, nor are those that choose between a Pallas kernel and XLA for the
same result (fused_pool2_pallas, pallas_crop, fused_pool2_gather,
pool_window_gather): in the port a kernel is the route on the card and its
plain PyTorch version the route on the CPU, chosen by the device of the
tensors. pallas_scatter is kept because its two routes give different
results.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class PerfConfig:
    fused_pool2: bool = False
    fused_pool4: bool = False
    pallas_scatter: Optional[bool] = None
    decode_chunks: Optional[int] = None


def _flag(environ, name):
    """An RCFD_* gate as the JAX package reads it (rcfd_tpu/nn/perf.py):
    unset or empty is None; 0/false/off/no and 1/true/on/yes (any case);
    anything else raises."""
    v = environ.get(name)
    if v in (None, ''):
        return None
    low = v.strip().lower()
    if low in ('0', 'false', 'off', 'no'):
        return False
    if low in ('1', 'true', 'on', 'yes'):
        return True
    raise ValueError('{}={!r}: expected one of 0/false/off/no or '
                     '1/true/on/yes'.format(name, v))


def perf_from_env(environ=None) -> PerfConfig:
    """RadarNet's PerfConfig from RCFD_PALLAS_SCATTER, RCFD_FUSED_POOL2,
    RCFD_FUSED_POOL4 and RCFD_DECODE_CHUNKS."""
    environ = os.environ if environ is None else environ
    chunks = environ.get('RCFD_DECODE_CHUNKS')
    return PerfConfig(
        pallas_scatter=_flag(environ, 'RCFD_PALLAS_SCATTER'),
        fused_pool2=_flag(environ, 'RCFD_FUSED_POOL2') or False,
        fused_pool4=_flag(environ, 'RCFD_FUSED_POOL4') or False,
        decode_chunks=int(chunks) if chunks else None)


def compute_dtype_from_env(environ=None):
    """The dtype the run drivers serve their folded model in, from
    RCFD_COMPUTE_DTYPE as the JAX package's ``run`` reads it: None
    (float32) when it is unset, '' or 'float32'; torch.bfloat16 for
    'bfloat16'; anything else raises."""
    environ = os.environ if environ is None else environ
    value = environ.get('RCFD_COMPUTE_DTYPE', '')
    if value in ('', 'float32'):
        return None
    if value == 'bfloat16':
        return torch.bfloat16
    raise ValueError("RCFD_COMPUTE_DTYPE={!r}: expected 'float32' or "
                     "'bfloat16'".format(value))
