// The row-tile design shared by the column crop (K2, column_crop.cu, float32
// and bf16) and the bf16 instance of the fused skip gather-add (K3,
// fused_skip_gather_add.cu), for Hopper (sm_90a).
//
// Both copy, for every window k of image n, the columns [s_k, s_k + W) of
// every row of one input map of that image. A block owns image n and a tile
// of up to kTileRows consecutive rows: it stages those rows of the input in
// shared memory once, then writes, window after window, the window's chunk
// out[k, q0 : q0 + rows of the tile, :], one contiguous run of elements, with
// 16-byte stores where the run allows. Each input row is read from device
// memory once a launch, not once a window; the elements of a 16-byte vector
// (8 bf16 or 4 float32) come from shared memory at any column (pick, merge).
//
// The launch geometry (tile_rows, tile_elems) is mirrored in Python by
// rcfd_tpu_torch/ops/fused_skip.py::row_tile, which the wrappers call before
// a launch; change both together.

#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace row_tiles {

constexpr int kThreads = 256;
// rows a block stages: a multiple of 8, so that a tile's chunk of W-wide rows
// is a whole number of 16-byte vectors, of bf16 or of float32, for any W
constexpr int kTileRows = 8;
// the most rows a tile grows to where a caller's rows move few bytes
constexpr int kMaxTileRows = 64;
// the shared memory a block can use on Hopper (227 KB)
constexpr size_t kSmemLimit = 232448;
// elements past a tile that pick may read (its second 16-byte load)
constexpr int kPad = 16;
constexpr size_t kDefaultSmem = 48 * 1024;

// The elements of type T in a 16-byte vector: 8 bf16 (unsigned short), 4
// float32.
template <typename T>
constexpr int kVecElems = 16 / static_cast<int>(sizeof(T));

// Elements of a tile of `r` rows of `stride` elements, with pick's pad.
__host__ __device__ inline size_t tile_elems(int r, int stride) {
  return ((size_t)r * stride + 7) / 8 * 8 + kPad;
}

// kTileRows, doubled (up to kMaxTileRows) while twice the rows move at
// most block_bytes at row_bytes a row (a caller's bytes read and written
// for one row of the tile; 0: no growth), then halved while the tile of
// `elem`-byte elements does not fit in kSmemLimit; 0 when one row does not
// fit.
inline int tile_rows(int stride, size_t elem = 2, size_t row_bytes = 0,
                     size_t block_bytes = 0) {
  int r = kTileRows;
  while (row_bytes > 0 && r < kMaxTileRows &&
         2 * r * row_bytes <= block_bytes)
    r *= 2;
  while (r > 1 && tile_elems(r, stride) * elem > kSmemLimit) r /= 2;
  return tile_elems(r, stride) * elem <= kSmemLimit ? r : 0;
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Above 48 KB a kernel takes dynamic shared memory only after this.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// A thread's walk over the chunks of a block's windows: column c of row r of
// window k's chunk (rt rows of w elements), advanced by a fixed number of
// elements of the chunks laid end to end, without a division per step.
struct Walk {
  int k, r, c, dk, dr, dc;
  __device__ Walk(int first, int step, int rt, int w) {
    const int len = rt * w;
    k = first / len;
    const int e = first - k * len;
    r = e / w;
    c = e - r * w;
    dk = step / len;
    const int d = step - dk * len;
    dr = d / w;
    dc = d - dr * w;
  }
  __device__ void next(int rt, int w) {
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
    r += dr;
    if (r >= rt) {
      r -= rt;
      ++k;
    }
    k += dk;
  }
};

// Copies the run src[0, count), rows of `width` elements, into `tile`, rows
// of `stride` >= width elements, then zeroes columns [width, stride) of each
// of its count / width rows; 16-byte loads where src is 16-byte aligned.
// The whole block calls it; the caller synchronises after.
template <typename T>
__device__ inline void stage_rows(const T* __restrict__ src, int count,
                                  int width, int stride, T* tile) {
  constexpr int kV = kVecElems<T>;
  int done = 0;
  if (aligned16(src)) {
    const int nvec = count / kV;
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      const uint4 x = __ldg(src4 + v);
      if (stride == width) {
        reinterpret_cast<uint4*>(tile)[v] = x;
        continue;
      }
      union {
        uint4 v;
        T e[kV];
      } u;
      u.v = x;
      int r = kV * v / width, c = kV * v - r * width;
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        tile[r * stride + c] = u.e[i];
        if (++c == width) {
          c = 0;
          ++r;
        }
      }
    }
    done = nvec * kV;
  }
  for (int e = done + threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / width;
    tile[r * stride + e - r * width] = __ldg(src + e);
  }
  const int pad = stride - width;
  for (int e = threadIdx.x; e < count / width * pad; e += blockDim.x) {
    const int r = e / pad;
    tile[r * stride + width + e - r * pad] = T(0);
  }
}

// The 8 elements tile[p, p + 8) as one 16-byte vector, for any p: two
// aligned 16-byte shared loads and a pick in registers.
__device__ __forceinline__ uint4 pick8(const unsigned short* tile, int p) {
  const int o = p & 7;
  const uint4* q = reinterpret_cast<const uint4*>(tile + (p - o));
  const uint4 lo = q[0], hi = q[1];
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int h = o >> 1;
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    v[i] = h == 0 ? w[i] : h == 1 ? w[i + 1] : h == 2 ? w[i + 2] : w[i + 3];
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = (o & 1) ? __funnelshift_r(v[i], v[i + 1], 16) : v[i];
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// Elements [0, m) of x and [m, 8) of y, for 0 < m < 8.
__device__ __forceinline__ uint4 merge8(uint4 x, uint4 y, int m) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = 2 * i + 1 < m ? xs[i]
           : 2 * i >= m  ? ys[i]
                         : __byte_perm(xs[i], ys[i], 0x7610);
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// The 4 float32 elements tile[p, p + 4) as one 16-byte vector, for any p:
// two aligned 16-byte shared loads and a pick in registers.
__device__ __forceinline__ uint4 pick4(const float* tile, int p) {
  const int o = p & 3;
  const uint4* q = reinterpret_cast<const uint4*>(tile + (p - o));
  const uint4 lo = q[0], hi = q[1];
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = o == 0 ? w[i] : o == 1 ? w[i + 1] : o == 2 ? w[i + 2] : w[i + 3];
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// Elements [0, m) of x and [m, 4) of y, float32, for 0 < m < 4.
__device__ __forceinline__ uint4 merge4(uint4 x, uint4 y, int m) {
  return make_uint4(x.x, m > 1 ? x.y : y.y, m > 2 ? x.z : y.z, y.w);
}

// The kVecElems<T> elements tile[p, p + kVecElems<T>) as one 16-byte vector.
template <typename T>
__device__ __forceinline__ uint4 pick(const T* tile, int p) {
  if constexpr (std::is_same_v<T, float>)
    return pick4(tile, p);
  else
    return pick8(tile, p);
}

// Elements [0, m) of x and [m, kVecElems<T>) of y, for 0 < m < kVecElems<T>.
template <typename T>
__device__ __forceinline__ uint4 merge(uint4 x, uint4 y, int m) {
  if constexpr (std::is_same_v<T, float>)
    return merge4(x, y, m);
  else
    return merge8(x, y, m);
}

}  // namespace row_tiles
