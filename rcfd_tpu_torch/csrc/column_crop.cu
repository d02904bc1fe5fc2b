// Batched column-window crop of a row-pooled feature map, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rcfd_tpu/ops/crop_pallas.py::_kernel (driven by
// batch_column_crop) and computes its function: for window k of image
// n = k / K, channel c, row h and column t < win,
//     out[k, c, h, t] = s_k + t < w ? rows[n, c, h, s_k + t] : 0,
// with s_k clipped to [0, w]. It is a copy, so it equals the plain version
// of rcfd_tpu_torch/ops/crop_cuda.py bit for bit. The variable-bin branch of
// the column ROI pool takes its bin maxima over these windows.
//
// What bounds it on the card: memory. Each window element is written once and
// each row element read at least once. At the 1/8 scale of a 900x300 patch
// (64 windows of 128 x 112 x 43 from rows of 128 x 112 x 238) that is about
// 158 MB written and 14 MB read: about 0.05 ms at the 3.35 TB/s of the H100
// SXM data sheet. Windows of neighbouring points overlap, and the rows
// (14 MB) fit in the 50 MB L2, so repeated reads mostly hit L2.
//
// What the design does about it: the Pallas kernel revisits one row tile in
// VMEM for all K windows and takes each window by an 8-aligned slice and a
// roll, because Mosaic only takes 8-aligned dynamic offsets. Hopper has no
// such constraint. A block row (blockIdx.y) is one window; its threads walk
// the window's elements in order, consecutive threads on consecutive
// elements, so the writes coalesce and the reads are contiguous along each
// row from an unaligned start. The (row, column) of an element is stepped
// forward with the grid stride instead of divided out per element.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;  // elements of a window per thread

__global__ void __launch_bounds__(kThreads)
column_crop_kernel(const float* __restrict__ rows, const int* __restrict__ starts,
                   int k_per_image, int n_rows, int w, int win,
                   float* __restrict__ out) {
  const int p = blockIdx.y;
  const int n = p / k_per_image;
  const int s = min(max(starts[p], 0), w);
  const unsigned elems = (unsigned)n_rows * win;  // n_rows = channels * ph
  const float* src = rows + (size_t)n * n_rows * w;
  float* dst = out + (size_t)p * elems;

  const unsigned stride = gridDim.x * kThreads;
  unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= elems) return;
  unsigned q = e / win, t = e - q * win;
  const unsigned dq = stride / win, dt = stride - dq * win;
  for (; e < elems; e += stride) {
    const int col = s + (int)t;
    dst[e] = col < w ? src[(size_t)q * w + col] : 0.0f;
    q += dq;
    t += dt;
    if (t >= (unsigned)win) {
      t -= win;
      ++q;
    }
  }
}

}  // namespace

// rows (n, n_rows, w) f32 with n_rows = channels * ph; starts (nk,) int32 with
// nk = n * k_per_image; out (nk, n_rows, win) f32. Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int rcfd_column_crop(const void* rows, const void* starts, int nk,
                                int k_per_image, int n_rows, int w, int win,
                                void* out, void* stream) {
  const unsigned elems = (unsigned)n_rows * win;
  const unsigned per_block = kThreads * kPerThread;
  const dim3 grid((elems + per_block - 1) / per_block, nk);
  column_crop_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(rows), static_cast<const int*>(starts),
      k_per_image, n_rows, w, win, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
