// Fused skip gather-add of the deferred column ROI pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel rcfd_tpu/ops/fused_skip.py::_fused_pallas (kernel
// body `kernel`, driven by fused_skip_conv_add) and computes its function.
// A decoder block's post-conv over concat[up, window(G, s_k)] equals
// conv(up) + window(conv(G), s_k) everywhere but the window's first and last
// column, which differ by one column of the conv's left or right taps. So for
// every window k (point k of image n = k / K), channel c, row h and column j:
//     out[k, c, h, j] = a[k, c, h, j] + cg[n, c, h, s_k + j]
//                       - (j == 0      ? corr_l[k, c, h] : 0)
//                       - (j == pw - 1 ? corr_r[k, c, h] : 0),
// in float32 and in that order, as rcfd_tpu_torch/ops/fused_skip.py's plain
// version does: two adds or subtracts per element and no multiply, so there
// is nothing nvcc could contract into an FMA, and the result equals the plain
// version bit for bit. The start is clipped to [0, wg - pw], which the plain
// version does too (a no-op for starts from the ROI pool).
//
// What bounds it on the card: memory. Each element of `a` is read and each of
// `out` written once; `cg` is read from its windows. At the deconv1 shapes of
// the 900x288 patch (64 windows of 32 x 450 x 144, cg 1 x 32 x 450 x 1088)
// that is about 531 MB read, 531 MB written and 63 MB of cg: about 0.34 ms at
// the 3.35 TB/s of the H100 SXM data sheet. Windows of neighbouring points
// overlap in cg, but cg (63 MB) is larger than the 50 MB L2, so overlapping
// reads hit L2 only in part.
//
// What the design does about it: the Pallas kernel DMAs an 8-aligned window
// of cg into VMEM and selects the true sub-window by one of 8 predicated
// static slices, because Mosaic only takes 8-aligned dynamic offsets. Hopper
// has no such constraint, so none of that is carried over. A block row
// (blockIdx.y) is one window; its threads walk the window's elements in
// order, consecutive threads on consecutive elements, so the reads of `a`
// and the writes of `out` coalesce and the reads of cg are contiguous along
// each row from an unaligned start. The (row, column) of an element is
// stepped forward with the grid stride instead of divided out per element.
// Bias and activation stay outside, as in the JAX package.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;  // elements of a window per thread

__global__ void __launch_bounds__(kThreads)
fused_skip_gather_add_kernel(const float* __restrict__ a,
                             const float* __restrict__ cg,
                             const int* __restrict__ starts,
                             const float* __restrict__ corr_l,
                             const float* __restrict__ corr_r,
                             int k_per_image, int rows, int pw, int wg,
                             float* __restrict__ out) {
  const int win = blockIdx.y;
  const int n = win / k_per_image;
  const int s = min(max(starts[win], 0), wg - pw);
  const unsigned elems = (unsigned)rows * pw;  // rows = channels * ph
  const float* a_w = a + (size_t)win * elems;
  float* out_w = out + (size_t)win * elems;
  const float* cg_w = cg + (size_t)n * rows * wg + s;
  const float* cl = corr_l + (size_t)win * rows;
  const float* cr = corr_r + (size_t)win * rows;

  const unsigned stride = gridDim.x * kThreads;
  unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= elems) return;
  unsigned q = e / pw, j = e - q * pw;
  const unsigned dq = stride / pw, dj = stride - dq * pw;
  for (; e < elems; e += stride) {
    float v = __fadd_rn(a_w[e], cg_w[(size_t)q * wg + j]);
    if (j == 0) v = __fsub_rn(v, cl[q]);
    if (j == (unsigned)pw - 1) v = __fsub_rn(v, cr[q]);
    out_w[e] = v;
    q += dq;
    j += dj;
    if (j >= (unsigned)pw) {
      j -= pw;
      ++q;
    }
  }
}

}  // namespace

// a and out (nk, rows, pw) f32 with rows = channels * ph; cg (nk / k, rows,
// wg) f32; starts (nk,) int32; corr_l and corr_r (nk, rows) f32. Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int rcfd_fused_skip_gather_add(const void* a, const void* cg,
                                          const void* starts,
                                          const void* corr_l,
                                          const void* corr_r, int nk,
                                          int k_per_image, int rows, int pw,
                                          int wg, void* out, void* stream) {
  const unsigned elems = (unsigned)rows * pw;
  const unsigned per_block = kThreads * kPerThread;
  const dim3 grid((elems + per_block - 1) / per_block, nk);
  fused_skip_gather_add_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(cg),
      static_cast<const int*>(starts), static_cast<const float*>(corr_l),
      static_cast<const float*>(corr_r), k_per_image, rows, pw, wg,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
