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
// A second instance takes bf16 `a`, `cg` and `out` (float32 corrections), the
// arithmetic of the TPU kernel's bf16 path (fused_skip.py:155-160, :225-232):
// v = bf16(a + cg), one rounding; at j == 0 or pw - 1, bf16(float(v) - corr)
// (gather_add_math.cuh, shared with K4's vector variants). In both dtypes
// this kernel is also K4's `full` (fused_skip_variants.py).
//
// What bounds it on the card: memory. Each element of `a` is read and each of
// `out` written once, and cg once for all its windows. At the deconv1 shapes
// of the 900x288 patch (64 windows of 32 x 450 x 144, cg 1 x 32 x 450 x 1088)
// that is about 531 MB read, 531 MB written and 63 MB of cg in float32:
// about 0.34 ms at the 3.35 TB/s of the H100 SXM data sheet; in bf16 `a`,
// `cg` and `out` take half of that, and the corrections the same.
//
// The float32 instance: the Pallas kernel DMAs an 8-aligned window of cg
// into VMEM and selects the true sub-window by one of 8 predicated static
// slices, because Mosaic only takes 8-aligned dynamic offsets. Hopper has no
// such constraint, so none of that is carried over. A block row
// (blockIdx.y) is one window; its threads walk the window's elements in
// order, consecutive threads on consecutive elements, so the reads of `a`
// and the writes of `out` coalesce and the reads of cg are contiguous along
// each row from an unaligned start. The (row, column) of an element is
// stepped forward with the grid stride instead of divided out per element.
// Bias and activation stay outside, as in the JAX package.
//
// The bf16 instance replaces that element walk, which moved one 2-byte
// element a thread a step and read each window's slice of cg anew (64
// overlapping 144-wide windows of a 1088-wide row), with the row-tile design
// of row_tiles.cuh. A block owns image n and 8 consecutive rows q of
// cg[n] (fewer where a row is too wide for shared memory): it stages them in
// shared memory once, then loops over the windows of image n, writing each
// window's rows [q0, q0 + 8) of `out`, one contiguous run, as 16-byte
// vectors: `a` read as 16-byte vectors, the cg elements picked from shared
// memory at column s_k + j, the edge corrections applied per element inside
// the vector. So cg is read from device memory once a frame, and `a` and
// `out` stream as 16-byte vectors, the pattern of K4's `nodma`. That path
// needs pw % 8 == 0 (every constant-bin path: pw = patch / 2 or / 4 with
// patch % 32 == 0) and 16-byte aligned `a` and `out`; any other shape takes
// the same kernel's scalar path, one element a thread a step, with the
// element's row and column stepped from its flat index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gather_add_math.cuh"
#include "row_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;  // elements of a window per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_skip_gather_add_kernel(const T* __restrict__ a,
                             const T* __restrict__ cg,
                             const int* __restrict__ starts,
                             const float* __restrict__ corr_l,
                             const float* __restrict__ corr_r,
                             int k_per_image, int rows, int pw, int wg,
                             T* __restrict__ out) {
  const int win = blockIdx.y;
  const int n = win / k_per_image;
  const int s = min(max(starts[win], 0), wg - pw);
  const unsigned elems = (unsigned)rows * pw;  // rows = channels * ph
  const T* a_w = a + (size_t)win * elems;
  T* out_w = out + (size_t)win * elems;
  const T* cg_w = cg + (size_t)n * rows * wg + s;
  const float* cl = corr_l + (size_t)win * rows;
  const float* cr = corr_r + (size_t)win * rows;

  const unsigned stride = gridDim.x * kThreads;
  unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= elems) return;
  unsigned q = e / pw, j = e - q * pw;
  const unsigned dq = stride / pw, dj = stride - dq * pw;
  for (; e < elems; e += stride) {
    T v = add(a_w[e], cg_w[(size_t)q * wg + j]);
    if (j == 0) v = corrected(v, cl[q]);
    if (j == (unsigned)pw - 1) v = corrected(v, cr[q]);
    out_w[e] = v;
    q += dq;
    j += dj;
    if (j >= (unsigned)pw) {
      j -= pw;
      ++q;
    }
  }
}

template <typename T>
int launch(const void* a, const void* cg, const void* starts,
           const void* corr_l, const void* corr_r, int nk, int k_per_image,
           int rows, int pw, int wg, void* out, void* stream) {
  const unsigned elems = (unsigned)rows * pw;
  const unsigned per_block = kThreads * kPerThread;
  const dim3 grid((elems + per_block - 1) / per_block, nk);
  fused_skip_gather_add_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(cg),
      static_cast<const int*>(starts), static_cast<const float*>(corr_l),
      static_cast<const float*>(corr_r), k_per_image, rows, pw, wg,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The bf16 instance: a block stages cg[n, q0 : q0 + rt, :] (rt <= tile_rows
// rows) in shared memory, then writes out[k, q0 : q0 + rt, :] of every window
// k of image n. kVec: 16-byte vectors (pw % 8 == 0, `a` and `out` 16-byte
// aligned, so every chunk starts on a vector and holds whole vectors, and a
// vector lies in one row); else one element a step.
template <bool kVec>
__global__ void __launch_bounds__(row_tiles::kThreads)
fused_skip_gather_add_bf16_kernel(const unsigned short* __restrict__ a,
                                  const unsigned short* __restrict__ cg,
                                  const int* __restrict__ starts,
                                  const float* __restrict__ corr_l,
                                  const float* __restrict__ corr_r,
                                  int k_per_image, int rows, int pw, int wg,
                                  int tile_rows,
                                  unsigned short* __restrict__ out) {
  extern __shared__ __align__(16) unsigned short tile[];
  const int n = blockIdx.y;
  const int q0 = blockIdx.x * tile_rows;
  const int rt = min(tile_rows, rows - q0);
  row_tiles::stage_rows(cg + ((size_t)n * rows + q0) * wg, rt * wg, wg, wg,
                        tile);
  __syncthreads();

  constexpr int kWidth = kVec ? 8 : 1;  // elements a thread a step
  row_tiles::Walk it(threadIdx.x * kWidth, row_tiles::kThreads * kWidth, rt,
                     pw);
  for (; it.k < k_per_image; it.next(rt, pw)) {
    const int win = n * k_per_image + it.k;
    const int s = min(max(__ldg(starts + win), 0), wg - pw);
    const size_t q = (size_t)win * rows + q0 + it.r;  // (window, row)
    const size_t off = q * pw + it.c;
    const int p = it.r * wg + s + it.c;  // in the tile
    if (kVec) {
      const uint4 va = __ldg(reinterpret_cast<const uint4*>(a + off));
      const uint4 vc = row_tiles::pick8(tile, p);
      uint32_t x[4] = {va.x, va.y, va.z, va.w};
      const uint32_t y[4] = {vc.x, vc.y, vc.z, vc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = add_pair(x[i], y[i]);
      if (it.c == 0)
        x[0] = with_low(x[0], corrected(low(x[0]), __ldg(corr_l + q)));
      if (it.c + 8 == pw)
        x[3] = with_high(x[3], corrected(high(x[3]), __ldg(corr_r + q)));
      *reinterpret_cast<uint4*>(out + off) = make_uint4(x[0], x[1], x[2],
                                                        x[3]);
    } else {
      __nv_bfloat16 v = add(__ushort_as_bfloat16(a[off]),
                            __ushort_as_bfloat16(tile[p]));
      if (it.c == 0) v = corrected(v, __ldg(corr_l + q));
      if (it.c == pw - 1) v = corrected(v, __ldg(corr_r + q));
      out[off] = __bfloat16_as_ushort(v);
    }
  }
}

int launch_bf16(const void* a, const void* cg, const void* starts,
                const void* corr_l, const void* corr_r, int nk,
                int k_per_image, int rows, int pw, int wg, void* out,
                void* stream) {
  const int tile_rows = row_tiles::tile_rows(wg);
  if (tile_rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = row_tiles::tile_elems(tile_rows, wg) * 2;
  const bool vec = pw % 8 == 0 && row_tiles::aligned16(a) &&
                   row_tiles::aligned16(out);
  auto kernel = vec ? fused_skip_gather_add_bf16_kernel<true>
                    : fused_skip_gather_add_bf16_kernel<false>;
  const cudaError_t err = row_tiles::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + tile_rows - 1) / tile_rows, nk / k_per_image);
  kernel<<<grid, row_tiles::kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const unsigned short*>(a),
      static_cast<const unsigned short*>(cg), static_cast<const int*>(starts),
      static_cast<const float*>(corr_l), static_cast<const float*>(corr_r),
      k_per_image, rows, pw, wg, tile_rows,
      static_cast<unsigned short*>(out));
  return static_cast<int>(cudaGetLastError());
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
  return launch<float>(a, cg, starts, corr_l, corr_r, nk, k_per_image, rows,
                       pw, wg, out, stream);
}

// The same with bf16 a, cg and out; the corrections stay f32.
extern "C" int rcfd_fused_skip_gather_add_bf16(
    const void* a, const void* cg, const void* starts, const void* corr_l,
    const void* corr_r, int nk, int k_per_image, int rows, int pw, int wg,
    void* out, void* stream) {
  return launch_bf16(a, cg, starts, corr_l, corr_r, nk, k_per_image, rows,
                     pw, wg, out, stream);
}
