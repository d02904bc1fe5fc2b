// Variants of the fused skip gather-add (K3) that split its time on the card
// into its parts, for Hopper (sm_90a).
//
// Replaces the TPU measurement kernel tools/fusepall_exp.py::variant_kernel
// (its five modes of the Pallas gather-add rcfd_tpu/ops/fused_skip.py::
// _fused_pallas). That tool isolates the costs of Mosaic's aligned DMA
// windows and predicated selects; the counterpart of "alignment" on Hopper
// is the 16-byte vector, A = 16 / sizeof(T) elements (4 in float32, 8 in
// bf16). With s_k the window start clipped to [0, wg - pw] as K3 clips it,
// and s^_k = s_k - s_k mod A, every variant computes a defined function:
//
//   full      K3's function: out = a + window(cg, s_k), then the first
//             column minus corr_l and the last minus corr_r. It is K3
//             itself, in either dtype (fused_skip_gather_add.cu), so this
//             file has no kernel for it. `a + window` is added in the
//             element type; the two edge columns are corrected in float32
//             and then rounded to bf16, as the TPU variant's emit does.
//   align16   the same function; `a` read and `out` written as 16-byte
//             vectors, cg read as 16-byte vectors from the aligned column
//             s^_k + j and the true window picked out in registers (a switch
//             on s_k mod A, uniform over a block, so no branch diverges).
//   noselect  align16's computation at s^_k, with no pick-out: wrong on
//             purpose, the cost of the pick-out (and of its second load).
//   dmaonly   out = window(cg, s^_k), vectors: `a` is not read and nothing
//             is corrected; wrong on purpose, the window reads and the
//             writes alone.
//   nodma     out = a * 2, vectors: the streaming floor of this access
//             pattern.
//
// Every element is computed with K3's arithmetic (gather_add_math.cuh), in
// the order of rcfd_tpu_torch/ops/fused_skip_variants.py's plain versions,
// so each variant equals its plain version bit for bit.
//
// What bounds them on the card: memory, as for K3. At the tool's default
// shapes (64 windows of 32 x 450 x 144, cg 1 x 32 x 450 x 1088) K3 moves
// 1,131,725,056 bytes in float32: about 0.34 ms at the 3.35 TB/s of the H100
// SXM data sheet. Each variant keeps K3's grid, a row of blocks per window,
// so the variants differ from K3 only in what a thread loads and how.
//
// What the design does about it: nothing more than the split. The variants
// exist to measure which of K3's parts (its scalar accesses, its unaligned
// window reads, the pick-out) keeps it from its bound. What they pointed to
// (16-byte vectors, and cg read once for all overlapping windows) is K3's
// bf16 instance since its row-tile redesign, which `full` measures in bf16;
// `align16` stays a variant of the old per-window grid, and `nodma` is the
// streaming floor that instance is held against.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

#include "gather_add_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 2;  // vectors per thread

enum Mode { kFull = 0, kAlign16 = 1, kNoSelect = 2, kDmaOnly = 3, kNoDma = 4 };
enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float twice(float x) { return __fmul_rn(x, 2.f); }
__device__ __forceinline__ __nv_bfloat16 twice(__nv_bfloat16 x) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(x), 2.f));
}

// one 16-byte vector of elements
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T e[kN];
};

template <typename T>
__device__ __forceinline__ Vec<T> load(const T* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  Vec<T> v;
  memcpy(&v, &raw, sizeof(v));
  return v;
}

template <typename T>
__device__ __forceinline__ void store(T* p, const Vec<T>& v) {
  uint4 raw;
  memcpy(&raw, &v, sizeof(v));
  *reinterpret_cast<uint4*>(p) = raw;
}

// elements kOff .. kOff + N - 1 of the pair (lo, hi)
template <typename T, int kOff>
__device__ __forceinline__ Vec<T> shifted(const Vec<T>& lo,
                                          const Vec<T>& hi) {
  constexpr int kN = Vec<T>::kN;
  Vec<T> r;
#pragma unroll
  for (int i = 0; i < kN; ++i)
    r.e[i] = i + kOff < kN ? lo.e[(i + kOff) % kN] : hi.e[(i + kOff) % kN];
  return r;
}

template <typename T>
__device__ __forceinline__ Vec<T> pick(const Vec<T>& lo, const Vec<T>& hi,
                                       int off) {
  switch (off) {  // off < Vec<T>::kN, the same for every thread of a block
    case 1: return shifted<T, 1>(lo, hi);
    case 2: return shifted<T, 2>(lo, hi);
    case 3: return shifted<T, 3>(lo, hi);
    case 4: return shifted<T, 4>(lo, hi);
    case 5: return shifted<T, 5>(lo, hi);
    case 6: return shifted<T, 6>(lo, hi);
    case 7: return shifted<T, 7>(lo, hi);
    default: return lo;
  }
}

// align16 (kSelect) and noselect (!kSelect): K3's function over 16-byte
// vectors. Thread vector v of a window covers columns jv*N .. jv*N + N - 1
// of row q; its window elements are cg[q, s + jv*N + i], which lie in the
// two aligned vectors at s^ + jv*N and s^ + jv*N + N. The second is read
// only when s is not aligned, and then lies inside the row: s^ + pw is a
// multiple of N below s + pw <= wg.
template <typename T, bool kSelect>
__global__ void __launch_bounds__(kThreads)
vector_kernel(const T* __restrict__ a, const T* __restrict__ cg,
              const int* __restrict__ starts,
              const float* __restrict__ corr_l,
              const float* __restrict__ corr_r, int k_per_image, int rows,
              int pw, int wg, T* __restrict__ out) {
  constexpr int kN = Vec<T>::kN;
  const int win = blockIdx.y;
  const int n = win / k_per_image;
  const int s = min(max(starts[win], 0), wg - pw);
  const int off = s % kN;
  const unsigned per_row = pw / kN;
  const unsigned vecs = (unsigned)rows * per_row;
  const T* a_w = a + (size_t)win * rows * pw;
  T* out_w = out + (size_t)win * rows * pw;
  const T* cg_w = cg + (size_t)n * rows * wg + (s - off);
  const float* cl = corr_l + (size_t)win * rows;
  const float* cr = corr_r + (size_t)win * rows;

  const unsigned stride = gridDim.x * kThreads;
  unsigned v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= vecs) return;
  unsigned q = v / per_row, jv = v - q * per_row;
  const unsigned dq = stride / per_row, dj = stride - dq * per_row;
  for (; v < vecs; v += stride) {
    const T* src = cg_w + (size_t)q * wg + jv * kN;
    Vec<T> w = load(src);
    if (kSelect && off != 0) w = pick(w, load(src + kN), off);
    Vec<T> y = load(a_w + (size_t)v * kN);
#pragma unroll
    for (int i = 0; i < kN; ++i) y.e[i] = add(y.e[i], w.e[i]);
    if (jv == 0) y.e[0] = corrected(y.e[0], cl[q]);
    if (jv == per_row - 1) y.e[kN - 1] = corrected(y.e[kN - 1], cr[q]);
    store(out_w + (size_t)v * kN, y);
    q += dq;
    jv += dj;
    if (jv >= per_row) {
      jv -= per_row;
      ++q;
    }
  }
}

// dmaonly: out = window(cg, s^), 16-byte vectors
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_kernel(const T* __restrict__ cg, const int* __restrict__ starts,
              int k_per_image, int rows, int pw, int wg,
              T* __restrict__ out) {
  constexpr int kN = Vec<T>::kN;
  const int win = blockIdx.y;
  const int n = win / k_per_image;
  const int s = min(max(starts[win], 0), wg - pw);
  const unsigned per_row = pw / kN;
  const unsigned vecs = (unsigned)rows * per_row;
  T* out_w = out + (size_t)win * rows * pw;
  const T* cg_w = cg + (size_t)n * rows * wg + (s - s % kN);

  const unsigned stride = gridDim.x * kThreads;
  unsigned v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= vecs) return;
  unsigned q = v / per_row, jv = v - q * per_row;
  const unsigned dq = stride / per_row, dj = stride - dq * per_row;
  for (; v < vecs; v += stride) {
    store(out_w + (size_t)v * kN, load(cg_w + (size_t)q * wg + jv * kN));
    q += dq;
    jv += dj;
    if (jv >= per_row) {
      jv -= per_row;
      ++q;
    }
  }
}

// nodma: out = a * 2, 16-byte vectors, on the same grid
template <typename T>
__global__ void __launch_bounds__(kThreads)
twice_kernel(const T* __restrict__ a, int rows, int pw,
             T* __restrict__ out) {
  constexpr int kN = Vec<T>::kN;
  const unsigned vecs = (unsigned)rows * (pw / kN);
  const T* a_w = a + (size_t)blockIdx.y * rows * pw;
  T* out_w = out + (size_t)blockIdx.y * rows * pw;
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned v = blockIdx.x * kThreads + threadIdx.x; v < vecs;
       v += stride) {
    Vec<T> y = load(a_w + (size_t)v * kN);
#pragma unroll
    for (int i = 0; i < kN; ++i) y.e[i] = twice(y.e[i]);
    store(out_w + (size_t)v * kN, y);
  }
}

template <typename T>
int launch(int mode, const void* a_, const void* cg_, const void* starts_,
           const void* corr_l_, const void* corr_r_, int nk, int k_per_image,
           int rows, int pw, int wg, void* out_, cudaStream_t stream) {
  const T* a = static_cast<const T*>(a_);
  const T* cg = static_cast<const T*>(cg_);
  const int* starts = static_cast<const int*>(starts_);
  const float* corr_l = static_cast<const float*>(corr_l_);
  const float* corr_r = static_cast<const float*>(corr_r_);
  T* out = static_cast<T*>(out_);
  const unsigned vecs = (unsigned)rows * (pw / Vec<T>::kN);
  const unsigned per_block = kThreads * kVecPerThread;
  const dim3 grid((vecs + per_block - 1) / per_block, nk);
  switch (mode) {
    case kAlign16:
      vector_kernel<T, true><<<grid, kThreads, 0, stream>>>(
          a, cg, starts, corr_l, corr_r, k_per_image, rows, pw, wg, out);
      break;
    case kNoSelect:
      vector_kernel<T, false><<<grid, kThreads, 0, stream>>>(
          a, cg, starts, corr_l, corr_r, k_per_image, rows, pw, wg, out);
      break;
    case kDmaOnly:
      window_kernel<T><<<grid, kThreads, 0, stream>>>(
          cg, starts, k_per_image, rows, pw, wg, out);
      break;
    case kNoDma:
      twice_kernel<T><<<grid, kThreads, 0, stream>>>(a, rows, pw, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 1 align16, 2 noselect, 3 dmaonly, 4 nodma; dtype: 0 float32, 1 bf16.
// a and out (nk, rows, pw) with rows = channels * ph; cg (nk / k_per_image,
// rows, wg); starts (nk,) int32; corr_l and corr_r (nk, rows) float32. Every
// mode needs pw and wg multiples of 16 / sizeof(element) and 16-byte
// aligned a, cg and out. Launches on `stream` and returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a mode or
// dtype it does not take (mode 0, full, is K3: fused_skip_gather_add.cu).
extern "C" int rcfd_fused_skip_variant(int mode, int dtype, const void* a,
                                       const void* cg, const void* starts,
                                       const void* corr_l,
                                       const void* corr_r, int nk,
                                       int k_per_image, int rows, int pw,
                                       int wg, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(mode, a, cg, starts, corr_l, corr_r, nk,
                                 k_per_image, rows, pw, wg, out, st);
  if (dtype == kFloat32)
    return launch<float>(mode, a, cg, starts, corr_l, corr_r, nk,
                         k_per_image, rows, pw, wg, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
