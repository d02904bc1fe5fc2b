// The gradient of the batched column-window crop (column_crop.cu) in its
// rows, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package differentiates the XLA
// formulation of the crop (rcfd_tpu/ops/roi_pool.py::roi_pool_column, the
// vmapped dynamic_slice of the zero-padded rows), whose transpose adds each
// window's gradient into the columns it was cut from. This kernel computes
// that function for the card's training path (ColumnCrop.backward in
// rcfd_tpu_torch/ops/crop_cuda.py), in gather form, without atomics: for
// image n, row q = c * ph + h and column x < w,
//     grad_rows[n, q, x] = sum over k ascending with s_k <= x < s_k + win
//                          of grad_windows[n * K + k, q, x - s_k],
// with s_k clipped to [0, w] as the forward clips it, summed in float32 from
// 0 in that order and rounded once to the output's type (bf16: round to
// nearest even). A column no window covers gets 0; a window's columns past w
// (the forward's zero padding) are read by no one. The plain version of
// crop_cuda.py adds in the same order, so the two are equal bit for bit.
//
// What bounds it on the card: memory. Each element of grad_windows is read
// at most once (once if its column is below w) and each of grad_rows written
// once. At a 900x300 training step's 1/8 pool (6 images of 4 windows, rows
// of 128 x 112 x 238, windows 43 wide) that is 59 MB read and 82 MB written
// in float32: about 0.042 ms at the 3.35 TB/s of the H100 SXM data sheet,
// half of that in bf16. Its adds are one per element read, far below the
// card's rate.
//
// The design: a block owns image n, a strip of columns (the whole row up to
// 256 columns, in a power of 2 of threads from 32; 256 a strip past that)
// and the rows its threads take, kRowsPerThread each (16 bytes of a column:
// 4 float32 rows, 8 bf16). It first lists, in shared memory and in k order,
// the image's windows that overlap its strip: kThreads windows a pass, each
// thread testing one and a warp ballot with a prefix over the block's warps
// compacting them (a list per block, as scatter_quasi_dense.cu keeps its
// points); any K takes as many passes. Then each thread walks the list for
// its column, its rows' loads of a window in flight together, adds into
// float32 registers, and writes its column of each row once. Consecutive
// threads take consecutive columns, so a window's reads coalesce and a
// block writes whole rows; there is no zero fill, no permute and no second
// pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// a block: blockDim.x = the strip's columns (32 to 256), blockDim.y =
// kThreads / blockDim.x row lanes
constexpr int kThreads = 256;  // also the windows listed a pass
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStrip = 256;
// rows a thread adds at once: 16 bytes of a column
template <typename T>
constexpr int kRowsPerThread = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);  // exact
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ unsigned short narrow<unsigned short>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Lists in list_k / list_s, in k order, the windows [base, base +
// kThreads) of image n whose columns [s, s + win) overlap [x0, x_end);
// returns their count. The whole block calls it; it synchronises before it
// returns, and the caller before the next call rewrites the list.
__device__ __forceinline__ int list_windows(const int* __restrict__ starts,
                                            int n, int k_per_image, int base,
                                            int w, int win, int x0, int x_end,
                                            int* list_k, int* list_s,
                                            int* warp_hits) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int k = base + tid;
  int s = 0;
  bool hit = false;
  if (k < k_per_image) {
    s = min(max(__ldg(starts + (size_t)n * k_per_image + k), 0), w);
    hit = s < x_end && s + win > x0;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) warp_hits[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, count = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int c = warp_hits[i];
    before += i < warp ? c : 0;
    count += c;
  }
  if (hit) {
    const int at = before + __popc(ballot & ((1u << lane) - 1u));
    list_k[at] = k;
    list_s[at] = s;
  }
  __syncthreads();
  return count;
}

// T: float (float32) or unsigned short (bf16) gradients. A block owns
// image n = blockIdx.z, columns [x0, x0 + blockDim.x) and blockDim.y *
// kRowsPerThread<T> rows from blockIdx.x times that; thread (threadIdx.x,
// threadIdx.y) takes column x0 + threadIdx.x and rows threadIdx.y + j *
// blockDim.y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
column_crop_backward_kernel(const T* __restrict__ grad_windows,
                            const int* __restrict__ starts, int k_per_image,
                            int n_rows, int w, int win,
                            T* __restrict__ grad_rows) {
  constexpr int kRows = kRowsPerThread<T>;
  __shared__ int list_k[kThreads];
  __shared__ int list_s[kThreads];
  __shared__ int warp_hits[kWarps];
  const int n = blockIdx.z;
  const int x0 = blockIdx.y * blockDim.x;
  const int x = x0 + threadIdx.x;
  const int x_end = min(x0 + (int)blockDim.x, w);
  const int lanes = blockDim.y;
  const int q0 = blockIdx.x * lanes * kRows + threadIdx.y;  // first row
  bool row[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) row[j] = x < w && q0 + j * lanes < n_rows;
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;

  for (int base = 0; base < k_per_image; base += kThreads) {
    if (base > 0) __syncthreads();  // the previous list is read
    const int count = list_windows(starts, n, k_per_image, base, w, win, x0,
                                   x_end, list_k, list_s, warp_hits);
    for (int i = 0; i < count; ++i) {
      const int t = x - list_s[i];
      if (t < 0 || t >= win) continue;
      const T* g = grad_windows +
                   (((size_t)n * k_per_image + list_k[i]) * n_rows + q0) *
                       win + t;
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (row[j]) acc[j] += widen(__ldg(g + (size_t)j * lanes * win));
    }
  }

  T* out = grad_rows + ((size_t)n * n_rows + q0) * w + x;
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    if (row[j]) out[(size_t)j * lanes * w] = narrow<T>(acc[j]);
}

template <typename T>
int launch(const void* grad_windows, const void* starts, int nk,
           int k_per_image, int n_rows, int w, int win, void* grad_rows,
           void* stream) {
  // the strip: the row, or kMaxStrip columns of it, in a power of 2 of
  // threads from 32
  int strip = 32;
  while (strip < kMaxStrip && strip < w) strip *= 2;
  const int block_rows = kThreads / strip * kRowsPerThread<T>;
  const dim3 block(strip, kThreads / strip);
  const dim3 grid((n_rows + block_rows - 1) / block_rows,
                  (w + strip - 1) / strip, nk / k_per_image);
  column_crop_backward_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(grad_windows), static_cast<const int*>(starts),
      k_per_image, n_rows, w, win, static_cast<T*>(grad_rows));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grad_windows (nk, n_rows, win) f32 with n_rows = channels * ph and
// nk = n * k_per_image; starts (nk,) int32; grad_rows (n, n_rows, w) f32,
// every element written. Launches on `stream` and returns cudaGetLastError()
// of the launch.
extern "C" int rcfd_column_crop_backward(const void* grad_windows,
                                         const void* starts, int nk,
                                         int k_per_image, int n_rows, int w,
                                         int win, void* grad_rows,
                                         void* stream) {
  return launch<float>(grad_windows, starts, nk, k_per_image, n_rows, w, win,
                       grad_rows, stream);
}

// The same with bf16 gradients, summed in float32 and rounded once.
extern "C" int rcfd_column_crop_backward_bf16(const void* grad_windows,
                                              const void* starts, int nk,
                                              int k_per_image, int n_rows,
                                              int w, int win,
                                              void* grad_rows,
                                              void* stream) {
  return launch<unsigned short>(grad_windows, starts, nk, k_per_image, n_rows,
                                w, win, grad_rows, stream);
}
