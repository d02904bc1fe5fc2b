// Quasi-dense scatter of K per-point response crops into (ph, w) depth and
// response maps, for Hopper (sm_90a).
//
// Replaces the TPU kernel rcfd_tpu/ops/scatter_pallas.py::_kernel (launched
// by _call, driven by scatter_quasi_dense_pallas) and computes its function.
// For every pixel (r, c) of the crop rows it takes the int32 max, over the
// valid points k whose window covers the pixel, of
//     key = (min(trunc(v * 2^14), 2^14) << 16) | (65535 - k),
//     v   = crop >= threshold ? crop : 0.
// Point k covers padded columns x_start[k] .. x_start[k] + pw - 1, and pixel
// column c sits at padded column c + pw. The same thread then unpacks the
// key into the 14-bit response and the winning point (the first index wins
// ties inside one 2^-14 step) and runs the legacy rewrite cascade of
// rcfd_tpu/ops/scatter.py::_legacy_rewrite: m = winner (0 where the response
// is 0), then for p = 0 .. K-1, if valid[p] and m == p, m = trunc(z[p]).
//
// What bounds it on the card: memory. Each crop element is read at most once
// for a few integer operations, and each output pixel is written once. At
// K = 64, 900 x 288 crops and w = 1600 that is about 66 MB read and 11.5 MB
// written: about 23 us at the 3.35 TB/s of the H100 SXM data sheet.
//
// What the design does about it: the Pallas kernel walks the points in order
// and keeps the whole map in VMEM, which Hopper has no counterpart for. Here
// it is a gather instead. A block owns kThreads columns of kRows rows, and a
// thread owns one column of those rows. The block first lists, in shared
// memory, the valid points whose window meets its columns, computing each
// point's window start from its x in the same pass; its threads then walk
// that list only, kPoints points at a time with all their loads issued
// before any max, so each thread keeps kPoints * kRows loads in flight. The
// threads of a warp own neighbouring columns, so they read neighbouring crop
// elements and the reads coalesce. Points that do not cover a pixel, and
// invalid points, are not read at all. The max needs no atomics: each
// pixel's max is taken by one thread, so the result does not depend on order
// and equals the plain PyTorch version bit for bit.
//
// The rewrite cascade is a chain walk, not a loop over all K points: from
// m = winner, while valid[m], m becomes trunc(z[m]), and the walk goes on
// only if that lands on a later point index (m < new m < K), since the
// sequential loop only meets indices above the current one. That is the
// sequential loop's result in as many steps as the chain is long (one or
// two for real depths).

#include <cuda_runtime.h>

namespace {

constexpr int kIdxBits = 16;
constexpr int kMaxPoints = (1 << kIdxBits) - 1;
constexpr float kQScale = 16384.0f;  // 2^14, the response PNG codec scale
constexpr int kThreads = 64;         // columns of a block, one per thread
constexpr int kRows = 4;             // rows of a block
constexpr int kPoints = 2;           // listed points loaded per step
constexpr int kChunk = 1024;         // points listed in shared memory at a time

__device__ __forceinline__ int window_start(float x, int pw, int w) {
  // first padded column of the point's window, clipped as in
  // scatter_quasi_dense_pallas: trunc(x) - 2 * (pw / 2) + pw in [0, w + pw]
  const int s = __float2int_rz(x) - 2 * (pw / 2) + pw;
  return min(max(s, 0), w + pw);
}

__global__ void __launch_bounds__(kThreads)
scatter_quasi_dense_kernel(const float* __restrict__ crops,
                           const float* __restrict__ x_positions,
                           const float* __restrict__ z_values,
                           const unsigned char* __restrict__ valid,
                           int k, int ph, int pw, int w, float threshold,
                           float* __restrict__ depth,
                           float* __restrict__ response) {
  __shared__ int s_point[kChunk];
  __shared__ int s_start[kChunk];
  __shared__ int s_count;

  const int c0 = blockIdx.x * kThreads;
  const int c = c0 + threadIdx.x;
  const int r0 = blockIdx.y * kRows;
  const bool active = c < w;
  const int col = c + pw;  // padded column of this thread's pixels

  int best[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) best[rr] = 0;

  // packed max over the points; every thread joins the block barriers
  for (int base = 0; base < k; base += kChunk) {
    const int n = min(kChunk, k - base);
    __syncthreads();
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int p = base + i;
      const int s = window_start(x_positions[p], pw, w);
      // pixel columns of the window: [s - pw, s)
      if (valid[p] && s > c0 && s - pw < c0 + kThreads) {
        const int slot = atomicAdd(&s_count, 1);
        s_point[slot] = p;
        s_start[slot] = s;
      }
    }
    __syncthreads();
    const int listed = s_count;
    if (!active) continue;
    for (int t = 0; t < listed; t += kPoints) {
      float v[kPoints][kRows];
      int idx[kPoints];
#pragma unroll
      for (int u = 0; u < kPoints; ++u) {
        int p = 0, j = 0;
        bool covers = false;
        if (t + u < listed) {
          p = s_point[t + u];
          j = col - s_start[t + u];
          covers = j >= 0 && j < pw;
        }
        idx[u] = covers ? kMaxPoints - p : -1;
        const float* src = crops + ((size_t)p * ph + r0) * pw + (covers ? j : 0);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
          v[u][rr] = covers && r0 + rr < ph ? __ldg(src + (size_t)rr * pw)
                                            : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kPoints; ++u) {
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const float x = v[u][rr] < threshold ? 0.0f : v[u][rr];
          const int q = (int)fminf(x * kQScale, kQScale);
          best[rr] = max(best[rr], idx[u] >= 0 ? (q << kIdxBits) | idx[u] : 0);
        }
      }
    }
  }
  if (!active) return;

  // unpack, then the legacy rewrite as a chain walk from the winner
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    if (r0 + rr >= ph) break;
    const float resp = (float)(best[rr] >> kIdxBits) / kQScale;
    float d = 0.0f;
    if (resp > 0.0f) {
      int m = min(kMaxPoints - (best[rr] & kMaxPoints), k);
      while (m < k && valid[m]) {
        const int next = __float2int_rz(z_values[m]);
        const bool later = next > m && next < k;
        m = next;
        if (!later) break;
      }
      d = (float)m;
    }
    const size_t o = (size_t)(r0 + rr) * w + c;
    response[o] = resp;
    depth[o] = d;
  }
}

}  // namespace

// crops (k, ph, pw) f32; x_positions and z_values (k,) f32; valid (k,) bool
// bytes; depth and response point at row 0 of (ph, w) f32 maps with row
// stride w. Launches on `stream` and returns cudaGetLastError() of the
// launch.
extern "C" int rcfd_scatter_quasi_dense(const void* crops,
                                        const void* x_positions,
                                        const void* z_values,
                                        const void* valid, int k, int ph,
                                        int pw, int w, float threshold,
                                        void* depth, void* response,
                                        void* stream) {
  const dim3 grid((w + kThreads - 1) / kThreads, (ph + kRows - 1) / kRows);
  scatter_quasi_dense_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(crops),
      static_cast<const float*>(x_positions),
      static_cast<const float*>(z_values),
      static_cast<const unsigned char*>(valid), k, ph, pw, w, threshold,
      static_cast<float*>(depth), static_cast<float*>(response));
  return static_cast<int>(cudaGetLastError());
}
