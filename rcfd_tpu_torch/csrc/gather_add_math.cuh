// The element arithmetic of the fused skip gather-add (K3,
// fused_skip_gather_add.cu) and of its vector variants
// (fused_skip_variants.cu), in float32 and bf16, so that both compute the
// plain version's function bit for bit.
//
// add: the sum rounded once to the element type (in bf16, __hadd equals the
// float32 sum rounded to bf16, as PyTorch on the CPU and XLA compute it).
// corrected: x minus a float32 correction, in float32, rounded to the
// element type (the order of the TPU kernel's bf16 path,
// rcfd_tpu/ops/fused_skip.py:155-160).

#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float add(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 x,
                                             __nv_bfloat16 y) {
  return __hadd(x, y);
}

__device__ __forceinline__ float corrected(float x, float c) {
  return __fsub_rn(x, c);
}
__device__ __forceinline__ __nv_bfloat16 corrected(__nv_bfloat16 x,
                                                   float c) {
  return __float2bfloat16_rn(__fsub_rn(__bfloat162float(x), c));
}
