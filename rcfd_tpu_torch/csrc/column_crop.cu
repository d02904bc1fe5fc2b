// Batched column-window crop of a row-pooled feature map, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rcfd_tpu/ops/crop_pallas.py::_kernel (driven by
// batch_column_crop) and computes its function: for window k of image
// n = k / K, channel c, row h and column t < win,
//     out[k, c, h, t] = s_k + t < w ? rows[n, c, h, s_k + t] : 0,
// with s_k clipped to [0, w]. It is a copy, so it equals the plain version
// of rcfd_tpu_torch/ops/crop_cuda.py bit for bit. The variable-bin branch of
// the column ROI pool takes its bin maxima over these windows. One kernel
// has two instances: float32, and bf16 for bf16 serving and training (the
// Pallas kernel takes any float dtype), where the zero past w is bf16 +0.
//
// What bounds it on the card: memory. Each window element is written once and
// each row element that a window covers read once. At the 1/8 scale of a
// 900x300 patch (64 windows of 128 x 112 x 43 from rows of 128 x 112 x 238)
// that is about 158 MB written and 14 MB read: about 0.05 ms at the 3.35
// TB/s of the H100 SXM data sheet, half of that in bf16. At a training
// step's shapes (6 images of 4 windows each) the writes are 59 MB and the
// covered columns at most 172 of each row's 238.
//
// The design is the Pallas kernel's own reuse of a row tile for all K
// windows (row_tiles.cuh). A block owns image n and 8 consecutive rows
// (fewer where a row is too wide for shared memory), stages them in shared
// memory once, zero-filled to w + win columns so that a column past w reads
// a zero, then loops over the windows of image n, writing each window's
// rows [q0, q0 + 8) of `out`, one contiguous run, with 16-byte stores: 4
// float32 or 8 bf16 elements a vector. A window row is win wide (43 at the
// 1/8 pool), so a vector may span the end of one row and the start of the
// next: it is picked from both rows of the tile and merged in registers. So
// the rows are read from device memory once a launch, not once a window, and
// the output is written as 16-byte vectors. That path needs win at least a
// vector's elements, n_rows * win and the tile's rows * win multiples of
// them (every chunk starts on a vector; n_rows = 128 * ph at the three
// variable-bin pools) and a 16-byte aligned `out`; any other shape takes the
// same kernel's scalar path, one element a thread a step. The Pallas kernel
// took each window by an 8-aligned slice and a roll, because Mosaic only
// takes 8-aligned dynamic offsets; shared memory has no such constraint.
//
// Staging pays where the windows overlap, each row element read once for
// several windows. Where an image's windows cannot cover its row (K * win
// <= w: a training step's 4 windows, which cover about half of each row at
// the 1/8 pool), a staged tile would read every column for windows that
// take half of them; there the block reads each window's columns straight
// from device memory (the L2 cache serves a column two windows share) into
// the same 16-byte stores, so the rows are read about as far as the bound
// counts them.
//
// A tile is 8 rows, or more where its rows move few bytes: a block reads
// and writes w + K * win elements a row, and its tile doubles, up to 64
// rows, while that stays within kBlockBytes. Serving's 64 windows write
// 2,752 elements a row at the 1/8 pool and keep 8 rows; a training step's 4
// windows move 410 a row at 1/8 (16 rows in float32) and 120 at 1/32 (64),
// where 8-row blocks spend their time waiting on their loads rather than
// moving bytes.

#include <cuda_runtime.h>

#include "row_tiles.cuh"

namespace {

// a tile grows while its rows move at most this many bytes (tile_rows)
constexpr size_t kBlockBytes = 32768;

// A block owns image n and rows [q0, q0 + rt) (rt <= tile_rows) and
// writes out[k, q0 : q0 + rt, :] of every window k of image n. kStage: it
// first stages rows[n, q0 : q0 + rt, :] in shared memory, w + win columns a
// row, and takes the windows from there; else it reads them from device
// memory. T: float (float32) or unsigned short (bf16); kVec: 16-byte
// vectors (see launch); else one element a step.
template <typename T, bool kVec, bool kStage>
__global__ void __launch_bounds__(row_tiles::kThreads)
column_crop_kernel(const T* __restrict__ rows, const int* __restrict__ starts,
                   int k_per_image, int n_rows, int w, int win, int tile_rows,
                   T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int n = blockIdx.y;
  const int q0 = blockIdx.x * tile_rows;
  const int rt = min(tile_rows, n_rows - q0);
  const int ws = w + win;  // a tile row, zero past w
  const T* src = rows + ((size_t)n * n_rows + q0) * w;
  if (kStage) {
    row_tiles::stage_rows(src, rt * w, w, ws, tile);
    __syncthreads();
  }

  constexpr int kV = row_tiles::kVecElems<T>;
  constexpr int kWidth = kVec ? kV : 1;  // elements a thread a step
  row_tiles::Walk it(threadIdx.x * kWidth, row_tiles::kThreads * kWidth, rt,
                     win);
  for (; it.k < k_per_image; it.next(rt, win)) {
    const int p = n * k_per_image + it.k;
    const int s = min(max(__ldg(starts + p), 0), w);
    const size_t off = ((size_t)p * n_rows + q0 + it.r) * win + it.c;
    if (kStage) {
      const int at = it.r * ws + s + it.c;  // in the tile
      if (kVec) {
        uint4 v = row_tiles::pick(tile, at);
        const int m = win - it.c;  // elements of the vector in row it.r
        // the rest starts row it.r + 1 at column s: tile index at + w + m
        if (m < kV)
          v = row_tiles::merge<T>(v, row_tiles::pick(tile, at + w), m);
        *reinterpret_cast<uint4*>(out + off) = v;
      } else {
        out[off] = tile[at];
      }
    } else {
      // from device memory: row it.r from column s + it.c, and past the
      // window's end row it.r + 1 from column s; zero past w
      const T* row = src + (size_t)it.r * w;
      int c = it.c;
      union {
        uint4 v;
        T e[kWidth];
      } u;
#pragma unroll
      for (int i = 0; i < kWidth; ++i) {
        u.e[i] = s + c < w ? __ldg(row + s + c) : T(0);
        if (++c == win) {
          c = 0;
          row += w;
        }
      }
      if (kVec)
        *reinterpret_cast<uint4*>(out + off) = u.v;
      else
        out[off] = u.e[0];
    }
  }
}

template <typename T>
int launch(const void* rows, const void* starts, int nk, int k_per_image,
           int n_rows, int w, int win, void* out, void* stream) {
  constexpr int kV = row_tiles::kVecElems<T>;
  const int tile_rows = row_tiles::tile_rows(
      w + win, sizeof(T), ((size_t)w + (size_t)k_per_image * win) * sizeof(T),
      kBlockBytes);
  if (tile_rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  // where the windows cannot cover a row, each reads its own columns
  const bool stage = (long long)k_per_image * win > w;
  const size_t smem =
      stage ? row_tiles::tile_elems(tile_rows, w + win) * sizeof(T) : 0;
  // a vector spans at most two rows, and every chunk of a tile starts on a
  // vector and holds whole vectors
  const bool vec = win >= kV && (long long)n_rows * win % kV == 0 &&
                   tile_rows * win % kV == 0 && row_tiles::aligned16(out);
  auto kernel = vec ? (stage ? column_crop_kernel<T, true, true>
                             : column_crop_kernel<T, true, false>)
                    : (stage ? column_crop_kernel<T, false, true>
                             : column_crop_kernel<T, false, false>);
  const cudaError_t err = row_tiles::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_rows + tile_rows - 1) / tile_rows, nk / k_per_image);
  kernel<<<grid, row_tiles::kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(rows), static_cast<const int*>(starts),
      k_per_image, n_rows, w, win, tile_rows, static_cast<T*>(out));
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
  return launch<unsigned short>(rows, starts, nk, k_per_image, n_rows, w,
                                win, out, stream);
}
