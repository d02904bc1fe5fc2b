// Quasi-dense scatter of K per-point response crops into (ph, w) depth and
// response maps, for Hopper (sm_90a): a row-strip kernel, one wave a frame,
// over one frame or a batch of frames in one launch.
//
// Replaces the TPU kernel rcfd_tpu/ops/scatter_pallas.py::_kernel (launched
// by _call, driven by scatter_quasi_dense_pallas) and computes its function.
// For every pixel (r, c) of the crop rows it takes the int32 max, over the
// valid points k whose window covers the pixel, of
//     key = (min(trunc(v * 2^14), 2^14) << 16) | (65535 - k),
//     v   = crop >= threshold ? crop : 0.
// Point k covers padded columns x_start[k] .. x_start[k] + pw - 1, and pixel
// column c sits at padded column c + pw. The key is then unpacked into the
// 14-bit response and the winning point (the first index wins ties inside
// one 2^-14 step), and the legacy rewrite cascade of
// rcfd_tpu/ops/scatter.py::_legacy_rewrite turns the winner into depth:
// m = winner (0 where the response is 0), then for p = 0 .. K-1, if
// valid[p] and m == p, m = trunc(z[p]).
//
// What bounds it on the card: memory. Each crop element that lands in the
// frame is read once for a few integer operations, and each output pixel is
// written once. At K = 64 (4 of them padding), 900 x 288 crops and w = 1600
// that is 71,413,968 bytes: 21.3 us at the 3.35 TB/s of the H100 SXM data
// sheet.
//
// The Pallas kernel walks the points in order and keeps the whole map in
// VMEM, which Hopper has no counterpart for. Here a block owns a strip of
// kRows whole rows of the crop region. Against what held back the earlier
// form of this kernel (a block of 64 columns x 4 rows, a thread a column,
// scalar loads at arbitrary offsets, 5,625 blocks in two waves):
//
// - One wave a frame. The grid is ceil(ph / kRows) blocks of kThreads = 256
//   threads a frame. kRows = 1 gives 900 blocks at the serving shapes;
//   __launch_bounds__ holds a thread to 32 registers so that
//   kBlocksPerSm = 8 blocks fit on an SM (2,048 threads, about 21 KB of
//   shared memory each): 1,056 slots on 132 SMs, so every block is resident
//   at once and there is no tail wave. Strips of 2 rows (450 blocks, 4 an
//   SM) or more keep fewer warps on an SM and measured slower on an H100.
// - A key map in shared memory with an apron. The block keeps its rows of
//   packed keys as int32, w + 2 pw words a row (rounded up to a multiple of
//   4), zeroed as the plain version zeroes its map. A window at any clipped
//   start in [0, w + pw] lands inside a row, so no write needs a bounds
//   test; the plain version uses the same layout.
// - Aligned 16-byte loads of crop rows. A crop row is contiguous, pw * 4
//   bytes, 16-byte aligned when pw % 4 == 0 and the crops are. A work item
//   is one float4 of one row of one listed point; the items are spread over
//   all 256 threads, consecutive threads on consecutive float4 of a row, so
//   a warp reads 512 contiguous bytes. Each thread issues the loads of
//   kUnroll items, without branches, before its first max, and 8 blocks an
//   SM keep 2,048 threads' loads in flight. Otherwise (pw % 4 != 0, or
//   crops that are not 16-byte aligned) the same kernel takes the scalar
//   branch (V = 1): one float an item, still coalesced. Vectors that fall
//   wholly in the apron are not read.
// - The max by shared-memory atomicMax on int32. The max does not depend on
//   order, so the result equals the plain PyTorch version bit for bit
//   whatever order the points are listed and read in. A thread puts the
//   four keys of its float4 into columns s + 4j + q, and in pass q lane i
//   writes word (q + i / 8) % 4: the 32 lanes of a warp then hit 32
//   distinct banks at any window start.
// - The point list is built once per block: the valid points whose window
//   meets the map, with their window starts, in shared memory, in chunks of
//   up to kChunk points (K goes up to 65,535). Invalid points are never
//   listed and never read, and no thread walks a point that misses its row.
// - The epilogue, after one barrier: the block's threads walk the w columns
//   of each row, unpack the key, and write the response and depth rows with
//   coalesced stores. The rewrite cascade is a chain walk, not a loop over
//   all K points: from m = winner, while valid[m], m becomes trunc(z[m]),
//   and the walk goes on only if that lands on a later point index
//   (m < new m < K), since the sequential loop only meets indices above the
//   current one. That is the sequential loop's result in as many steps as
//   the chain is long. A block walks the chain once for each of the first
//   kDepths points, into a table in shared memory, which the epilogue reads;
//   a winner beyond the table walks its chain there.
// - A batch of B frames is one launch: the grid's second dimension runs over
//   the frames (blockIdx.y), and a block offsets its crops, point tables and
//   map rows by its frame. One frame is one wave; at B frames the blocks of
//   later frames fill the SMs as those of earlier frames reach their
//   epilogue, so the map writes of one frame overlap the crop reads of the
//   next. Each frame's crops start k * ph * pw floats after the last, so
//   with pw % 4 == 0 and an aligned base every frame's rows stay 16-byte
//   aligned. A block computes its frame's offsets where it uses them
//   rather than keeping six offset pointers: at 32 registers a thread
//   those spilled to the stack and cost the single frame 12% of its time.
//   One frame launches the kBatched = false instance, where every offset
//   is 0 at compile time.
// - bf16 crops (bf16 serving: the Pallas kernel takes them too, and its
//   float32 upcast is exact, scatter_pallas.py:59-61) are the same kernel
//   on the crop type T. A work item is still 4 values: 4 bf16 are one
//   aligned 8-byte load (a uint2) where pw % 4 == 0 and the crops are
//   8-byte aligned, else the scalar branch reads one bf16. Each value is
//   widened with __bfloat162float, which is exact, so the keys are the
//   float32 path's keys for the same values and the maps equal the plain
//   version's bit for bit. The crops are half the bytes, the maps stay
//   float32: 41,467,368 bytes at the serving shapes above (12.4 us).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kIdxBits = 16;
constexpr int kMaxPoints = (1 << kIdxBits) - 1;
constexpr float kQScale = 16384.0f;  // 2^14, the response PNG codec scale
constexpr int kThreads = 256;        // threads of a block
constexpr int kBlocksPerSm = 8;      // resident blocks an SM must hold
constexpr int kRows = 1;             // rows of a strip, one strip a block
constexpr int kUnroll = 2;           // work items a thread loads before a max
constexpr int kChunk = 1024;         // points listed in shared memory at a time
constexpr int kDepths = 1024;        // winners whose depth a block tables
constexpr int kStaticSmem =
    kChunk * sizeof(int2) + kDepths * sizeof(float) + sizeof(int);
constexpr int kDefaultSmem = 48 * 1024;  // a block's shared memory without opt-in

__device__ __forceinline__ int window_start(float x, int pw, int w) {
  // first padded column of the point's window, clipped as in
  // scatter_quasi_dense_pallas: trunc(x) - 2 * (pw / 2) + pw in [0, w + pw]
  const int s = __float2int_rz(x) - 2 * (pw / 2) + pw;
  return min(max(s, 0), w + pw);
}

__device__ __forceinline__ int packed_key(float v, float threshold, int idx) {
  const float x = v < threshold ? 0.0f : v;
  const int q = (int)fminf(x * kQScale, kQScale);
  return (q << kIdxBits) | idx;
}

// the legacy rewrite of winner m, as a chain walk
__device__ __forceinline__ int chain_walk(int m, int k,
                                          const float* __restrict__ z_values,
                                          const unsigned char* __restrict__ valid) {
  while (m < k && __ldg(valid + m)) {
    const int next = __float2int_rz(__ldg(z_values + m));
    const bool later = next > m && next < k;
    m = next;
    if (!later) break;
  }
  return m;
}

// this block's frame's first entry in arrays of per_frame entries a frame
// (the point tables, the crops' points, the maps); 0 for one frame
template <bool kBatched>
__device__ __forceinline__ size_t frame_offset(long long per_frame) {
  return kBatched ? (size_t)blockIdx.y * (size_t)per_frame : 0;
}

// key map row length in words: the row and both aprons, a multiple of 4 so
// that every row starts 16-byte aligned
__host__ __device__ __forceinline__ int map_stride(int w, int pw) {
  return (w + 2 * pw + 3) & ~3;
}

// One work item: V consecutive values of a crop row of type T, read by one
// load (a float4 or a float; 4 bf16 as a uint2, or one bf16). at(i) is value
// i as a float; i is a constant wherever it is called.
template <typename T, int V>
struct CropItem;

template <>
struct CropItem<float, 4> {
  float4 r;
  __device__ __forceinline__ void load(const float* p) {
    r = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float at(int i) const {
    return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
  }
};

template <>
struct CropItem<float, 1> {
  float r;
  __device__ __forceinline__ void load(const float* p) { r = __ldg(p); }
  __device__ __forceinline__ float at(int) const { return r; }
};

template <>
struct CropItem<__nv_bfloat16, 4> {
  uint2 r;  // values 0, 1 in r.x (0 in the low half), 2, 3 in r.y
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ float at(int i) const {
    const unsigned word = i < 2 ? r.x : r.y;
    return __bfloat162float(__ushort_as_bfloat16(
        (unsigned short)(i & 1 ? word >> 16 : word & 0xffffu)));
  }
};

template <>
struct CropItem<__nv_bfloat16, 1> {
  __nv_bfloat16 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(p);
  }
  __device__ __forceinline__ float at(int) const {
    return __bfloat162float(r);
  }
};

// T: the crops' type (float or bf16). V = 4: a work item is 4 values of a
// crop row (pw % 4 == 0, crops aligned to 4 values); V = 1: one value.
// kBatched: the grid's second dimension runs over frames.
template <typename T, int V, bool kBatched>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
scatter_strip_kernel(const T* __restrict__ crops,
                     const float* __restrict__ x_positions,
                     const float* __restrict__ z_values,
                     const unsigned char* __restrict__ valid,
                     int k, int ph, int pw, int w, float threshold,
                     float* __restrict__ depth,
                     float* __restrict__ response,
                     long long map_frame_stride) {
  extern __shared__ int4 s_map4[];
  __shared__ int2 s_list[kChunk];     // (point, window start)
  __shared__ float s_depth[kDepths];  // rewritten depth of winner m
  __shared__ int s_count;
  int* const s_map = reinterpret_cast<int*>(s_map4);

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, ph - r0);  // the last strip may be ragged
  const int stride = map_stride(w, pw);
  for (int i = tid; i < kRows * stride / 4; i += kThreads)
    s_map4[i] = make_int4(0, 0, 0, 0);
  for (int m = tid; m < min(k, kDepths); m += kThreads)
    s_depth[m] = (float)chain_walk(m, k,
                                   z_values + frame_offset<kBatched>(k),
                                   valid + frame_offset<kBatched>(k));

  // work item j = (i * kRows + r) * nv + v is vector v of row r of listed
  // point i; thread tid takes items tid, tid + kThreads, ...
  const int nv = pw / V;
  const int step_rows = kThreads / nv, step_cols = kThreads % nv;
  // lane i's word order (V = 4): pass q writes word (q + rot) % 4
  const int rot = (tid >> 3) & 3;
  const bool rot1 = rot & 1, rot2 = rot & 2;

  for (int base = 0; base < k; base += kChunk) {
    const int n = min(kChunk, k - base);
    __syncthreads();
    if (tid == 0) s_count = 0;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const int p = base + i;
      const size_t q = frame_offset<kBatched>(k) + p;
      const int s = window_start(__ldg(x_positions + q), pw, w);
      // pixel columns of the window: [s - pw, s)
      if (__ldg(valid + q) && s > 0 && s < w + pw) {
        const int slot = atomicAdd(&s_count, 1);
        s_list[slot] = make_int2(p, s);
      }
    }
    __syncthreads();
    const int items = s_count * kRows;  // (listed point, strip row) pairs
    int g = tid / nv, v = tid - g * nv;
    while (g < items) {
      // all loads first, without branches: an idle slot reads the crops'
      // first vector, which is cached, and writes nothing
      CropItem<T, V> val[kUnroll];
      int at[kUnroll];  // key map word of the vector's first element
      int idx[kUnroll];
      bool on[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool live = g < items;
        const int i = live ? g / kRows : 0, r = live ? g % kRows : 0;
        const int2 pt = s_list[i];
        const int col = pt.y + v * V;  // padded column of the first element
        at[u] = r * stride + col;
        idx[u] = kMaxPoints - pt.x;
        on[u] = live && r < rows && col + V > pw && col < w + pw;
        const T* src =
            on[u] ? crops + ((frame_offset<kBatched>(k) + pt.x) * ph + r0 +
                             r) * pw + (size_t)v * V
                  : crops;
        val[u].load(src);
        v += step_cols;
        g += step_rows;
        if (v >= nv) {
          v -= nv;
          ++g;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!on[u]) continue;
        int* const word = s_map + at[u];
        if constexpr (V == 4) {
          // pass q writes word (q + rot) % 4, so takes element (q + rot) % 4
          const float a0 = rot1 ? val[u].at(1) : val[u].at(0);
          const float a1 = rot1 ? val[u].at(2) : val[u].at(1);
          const float a2 = rot1 ? val[u].at(3) : val[u].at(2);
          const float a3 = rot1 ? val[u].at(0) : val[u].at(3);
          const float b[4] = {rot2 ? a2 : a0, rot2 ? a3 : a1, rot2 ? a0 : a2,
                              rot2 ? a1 : a3};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            atomicMax(word + ((q + rot) & 3),
                      packed_key(b[q], threshold, idx[u]));
        } else {
          atomicMax(word, packed_key(val[u].at(0), threshold, idx[u]));
        }
      }
    }
  }
  __syncthreads();

  // unpack, then the legacy rewrite from the table or by a chain walk
  for (int r = 0; r < rows; ++r) {
    const int* keys = s_map + r * stride + pw;
    const size_t o =
        frame_offset<kBatched>(map_frame_stride) + (size_t)(r0 + r) * w;
    for (int c = tid; c < w; c += kThreads) {
      const int best = keys[c];
      const float resp = (float)(best >> kIdxBits) / kQScale;
      float d = 0.0f;
      if (resp > 0.0f) {
        const int m = min(kMaxPoints - (best & kMaxPoints), k);
        d = m < kDepths && m < k ? s_depth[m]
                                 : (float)chain_walk(
                                       m, k,
                                       z_values + frame_offset<kBatched>(k),
                                       valid + frame_offset<kBatched>(k));
      }
      response[o + c] = resp;
      depth[o + c] = d;
    }
  }
}

template <typename T>
int launch(const void* crops, const void* x_positions, const void* z_values,
           const void* valid, int b, int k, int ph, int pw, int w,
           float threshold, void* depth, void* response,
           long long map_frame_stride, void* stream) {
  const bool vec = pw % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(crops) % (4 * sizeof(T)) == 0;
  auto kernel = b == 1 ? (vec ? scatter_strip_kernel<T, 4, false>
                               : scatter_strip_kernel<T, 1, false>)
                        : (vec ? scatter_strip_kernel<T, 4, true>
                               : scatter_strip_kernel<T, 1, true>);
  const int smem = kRows * map_stride(w, pw) * (int)sizeof(int);
  if (smem + kStaticSmem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so that no later check meets it
      return static_cast<int>(err);
    }
  }
  const dim3 grid((ph + kRows - 1) / kRows, b);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(crops), static_cast<const float*>(x_positions),
      static_cast<const float*>(z_values),
      static_cast<const unsigned char*>(valid), k, ph, pw, w, threshold,
      static_cast<float*>(depth), static_cast<float*>(response),
      map_frame_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// crops (b, k, ph, pw) f32; x_positions and z_values (b, k) f32; valid
// (b, k) bool bytes; depth and response point at row 0 of frame 0's (ph, w)
// f32 maps with row stride w, and frame f's rows start map_frame_stride
// floats after frame f - 1's (one frame: b = 1). Launches on `stream` and
// returns cudaGetLastError() of the launch (or the error of raising the
// block's shared-memory limit, for a w whose key map rows do not fit).
extern "C" int rcfd_scatter_quasi_dense(const void* crops,
                                        const void* x_positions,
                                        const void* z_values,
                                        const void* valid, int b, int k,
                                        int ph, int pw, int w,
                                        float threshold, void* depth,
                                        void* response,
                                        long long map_frame_stride,
                                        void* stream) {
  return launch<float>(crops, x_positions, z_values, valid, b, k, ph, pw, w,
                       threshold, depth, response, map_frame_stride, stream);
}

// The same with bf16 crops; everything else as above.
extern "C" int rcfd_scatter_quasi_dense_bf16(
    const void* crops, const void* x_positions, const void* z_values,
    const void* valid, int b, int k, int ph, int pw, int w, float threshold,
    void* depth, void* response, long long map_frame_stride, void* stream) {
  return launch<__nv_bfloat16>(crops, x_positions, z_values, valid, b, k, ph,
                               pw, w, threshold, depth, response,
                               map_frame_stride, stream);
}
