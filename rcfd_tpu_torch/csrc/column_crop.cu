// Batched column-window crop of a row-pooled feature map, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rcfd_tpu/ops/crop_pallas.py::_kernel (driven by
// batch_column_crop) and computes its function: for window k of image
// n = k / K, channel c, row h and column t < win,
//     out[k, c, h, t] = s_k + t < w ? rows[n, c, h, s_k + t] : 0,
// with s_k clipped to [0, w]. It is a copy, so it equals the plain version
// of rcfd_tpu_torch/ops/crop_cuda.py bit for bit. The variable-bin branch of
// the column ROI pool takes its bin maxima over these windows. It has two
// instances: float32, and bf16 for bf16 serving (the Pallas kernel takes any
// float dtype), where the zero past w is bf16 +0.
//
// What bounds it on the card: memory. Each window element is written once and
// each row element read at least once. At the 1/8 scale of a 900x300 patch
// (64 windows of 128 x 112 x 43 from rows of 128 x 112 x 238) that is about
// 158 MB written and 14 MB read: about 0.05 ms at the 3.35 TB/s of the H100
// SXM data sheet, half of that in bf16.
//
// The float32 instance: the Pallas kernel revisits one row tile in VMEM for
// all K windows and takes each window by an 8-aligned slice and a roll,
// because Mosaic only takes 8-aligned dynamic offsets. Hopper has no such
// constraint. A block row (blockIdx.y) is one window; its threads walk the
// window's elements in order, consecutive threads on consecutive elements,
// so the writes coalesce and the reads are contiguous along each row from an
// unaligned start; the rows (14 MB) mostly hit the 50 MB L2 on the repeated
// reads. The (row, column) of an element is stepped forward with the grid
// stride instead of divided out per element.
//
// The bf16 instance replaces that element walk, which stored one 2-byte
// element a thread a step and read each window's slice of the rows anew,
// with the row-tile design of row_tiles.cuh, which is the Pallas kernel's
// own reuse of a row tile for all K windows: a block owns image n and 8
// consecutive rows (fewer where a row is too wide for shared memory), stages
// them in shared memory once, zero-filled to w + win columns so that a
// column past w reads a zero, then loops over the windows of image n,
// writing each window's rows [q0, q0 + 8) of `out`, one contiguous run, with
// 16-byte stores. A window row is win wide (43 at the 1/8 pool), so a vector
// may span the end of one row and the start of the next: it is picked from
// both rows of the tile and merged in registers. So the rows are read from
// device memory once a launch and the output is written as 16-byte vectors.
// That path needs win >= 8, n_rows * win and the tile's rows * win multiples
// of 8 (every chunk starts on a vector; n_rows = 128 * ph at the three
// variable-bin pools) and a 16-byte aligned `out`; any other shape takes the
// same kernel's scalar path, one element a thread a step.

#include <cuda_runtime.h>

#include "row_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;  // elements of a window per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
column_crop_kernel(const T* __restrict__ rows, const int* __restrict__ starts,
                   int k_per_image, int n_rows, int w, int win,
                   T* __restrict__ out) {
  const int p = blockIdx.y;
  const int n = p / k_per_image;
  const int s = min(max(starts[p], 0), w);
  const unsigned elems = (unsigned)n_rows * win;  // n_rows = channels * ph
  const T* src = rows + (size_t)n * n_rows * w;
  T* dst = out + (size_t)p * elems;

  const unsigned stride = gridDim.x * kThreads;
  unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= elems) return;
  unsigned q = e / win, t = e - q * win;
  const unsigned dq = stride / win, dt = stride - dq * win;
  for (; e < elems; e += stride) {
    const int col = s + (int)t;
    dst[e] = col < w ? src[(size_t)q * w + col] : T(0.0f);
    q += dq;
    t += dt;
    if (t >= (unsigned)win) {
      t -= win;
      ++q;
    }
  }
}

template <typename T>
int launch(const void* rows, const void* starts, int nk, int k_per_image,
           int n_rows, int w, int win, void* out, void* stream) {
  const unsigned elems = (unsigned)n_rows * win;
  const unsigned per_block = kThreads * kPerThread;
  const dim3 grid((elems + per_block - 1) / per_block, nk);
  column_crop_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(rows), static_cast<const int*>(starts),
      k_per_image, n_rows, w, win, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The bf16 instance: a block stages rows[n, q0 : q0 + rt, :] (rt <= tile_rows
// rows) in shared memory, w + win columns a row, then writes
// out[k, q0 : q0 + rt, :] of every window k of image n. kVec: 16-byte
// vectors (see launch_bf16); else one element a step.
template <bool kVec>
__global__ void __launch_bounds__(row_tiles::kThreads)
column_crop_bf16_kernel(const unsigned short* __restrict__ rows,
                        const int* __restrict__ starts, int k_per_image,
                        int n_rows, int w, int win, int tile_rows,
                        unsigned short* __restrict__ out) {
  extern __shared__ __align__(16) unsigned short tile[];
  const int n = blockIdx.y;
  const int q0 = blockIdx.x * tile_rows;
  const int rt = min(tile_rows, n_rows - q0);
  const int ws = w + win;  // a tile row, zero past w
  row_tiles::stage_rows(rows + ((size_t)n * n_rows + q0) * w, rt * w, w, ws,
                        tile);
  __syncthreads();

  constexpr int kWidth = kVec ? 8 : 1;  // elements a thread a step
  row_tiles::Walk it(threadIdx.x * kWidth, row_tiles::kThreads * kWidth, rt,
                     win);
  for (; it.k < k_per_image; it.next(rt, win)) {
    const int p = n * k_per_image + it.k;
    const int s = min(max(__ldg(starts + p), 0), w);
    const size_t off = ((size_t)p * n_rows + q0 + it.r) * win + it.c;
    const int at = it.r * ws + s + it.c;  // in the tile
    if (kVec) {
      uint4 v = row_tiles::pick8(tile, at);
      const int m = win - it.c;  // elements of the vector in row it.r
      // the rest starts row it.r + 1 at column s: tile index at + w + m
      if (m < 8) v = row_tiles::merge8(v, row_tiles::pick8(tile, at + w), m);
      *reinterpret_cast<uint4*>(out + off) = v;
    } else {
      out[off] = tile[at];
    }
  }
}

int launch_bf16(const void* rows, const void* starts, int nk,
                int k_per_image, int n_rows, int w, int win, void* out,
                void* stream) {
  const int tile_rows = row_tiles::tile_rows(w + win);
  if (tile_rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = row_tiles::tile_elems(tile_rows, w + win) * 2;
  // a vector spans at most two rows, and every chunk of a tile starts on a
  // vector and holds whole vectors
  const bool vec = win >= 8 && (long long)n_rows * win % 8 == 0 &&
                   tile_rows * win % 8 == 0 && row_tiles::aligned16(out);
  auto kernel = vec ? column_crop_bf16_kernel<true>
                    : column_crop_bf16_kernel<false>;
  const cudaError_t err = row_tiles::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_rows + tile_rows - 1) / tile_rows, nk / k_per_image);
  kernel<<<grid, row_tiles::kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const unsigned short*>(rows),
      static_cast<const int*>(starts), k_per_image, n_rows, w, win,
      tile_rows, static_cast<unsigned short*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows (n, n_rows, w) f32 with n_rows = channels * ph; starts (nk,) int32 with
// nk = n * k_per_image; out (nk, n_rows, win) f32. Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int rcfd_column_crop(const void* rows, const void* starts, int nk,
                                int k_per_image, int n_rows, int w, int win,
                                void* out, void* stream) {
  return launch<float>(rows, starts, nk, k_per_image, n_rows, w, win, out,
                       stream);
}

// The same with bf16 rows and out.
extern "C" int rcfd_column_crop_bf16(const void* rows, const void* starts,
                                     int nk, int k_per_image, int n_rows,
                                     int w, int win, void* out,
                                     void* stream) {
  return launch_bf16(rows, starts, nk, k_per_image, n_rows, w, win, out,
                     stream);
}
