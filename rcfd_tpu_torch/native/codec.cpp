// PNG row filters and JPEG color conversion of the port's codec
// (rcfd_tpu_torch/native).
//
// Counterpart of the PNG half of rcfd_tpu/native/dataloader.cpp. The JAX
// package decodes and encodes PNGs through libpng; the GPU machine has no
// libpng, so the port parses the chunks and runs zlib in Python (the
// standard library's zlib module) and keeps here only what is sequential
// along a row and too slow for a Python loop: undoing the five PNG row
// filters on read (Average and Paeth depend on the byte just written), and
// choosing and applying a filter per row on write. JPEG frames are decoded
// to their YCbCr planes (by libjpeg on the CPU, nvJPEG on the card) and
// turned into RGB here, with libjpeg-turbo's arithmetic, so both routes
// give what PIL gives but for the inverse DCT. No library is needed: any
// C++17 compiler builds this file.
//
// Build: rcfd_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// Filter one row (type T) of n bytes into out; prev is the row above
// (unfiltered), all zeros for the first row. Returns the sum of the
// filtered bytes read as signed, libpng's heuristic for choosing a filter.
// Every predictor reads unfiltered bytes only, so the loop vectorizes.
template <int T>
uint64_t filter_row(const uint8_t* cur, const uint8_t* prev, int64_t n,
                    int bpp, uint8_t* out) {
  uint64_t cost = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int a = i >= bpp ? cur[i - bpp] : 0;
    const int b = prev[i];
    const int c = i >= bpp ? prev[i - bpp] : 0;
    int pred = 0;
    if (T == 1) pred = a;
    if (T == 2) pred = b;
    if (T == 3) pred = (a + b) >> 1;
    if (T == 4) pred = paeth(a, b, c);
    const uint8_t v = static_cast<uint8_t>(cur[i] - pred);
    out[i] = v;
    cost += v < 128 ? v : 256 - v;
  }
  return cost;
}

uint64_t filter_row(int t, const uint8_t* cur, const uint8_t* prev,
                    int64_t n, int bpp, uint8_t* out) {
  switch (t) {
    case 1: return filter_row<1>(cur, prev, n, bpp, out);
    case 2: return filter_row<2>(cur, prev, n, bpp, out);
    case 3: return filter_row<3>(cur, prev, n, bpp, out);
    case 4: return filter_row<4>(cur, prev, n, bpp, out);
    default: return filter_row<0>(cur, prev, n, bpp, out);
  }
}

}  // namespace

extern "C" {

// Undo the row filters of a decompressed, non-interlaced PNG image.
// src holds `rows` rows of 1 + rowbytes bytes (the filter type, then the
// filtered row); dst receives rows * rowbytes bytes. bpp is the distance
// in bytes to the corresponding byte of the pixel to the left (at least
// 1). Returns 0, or -(row + 1) for a row whose filter type is not 0-4.
int64_t rcfd_png_unfilter(const uint8_t* src, uint8_t* dst, int64_t rows,
                          int64_t rowbytes, int bpp) {
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* in = src + y * (rowbytes + 1);
    const int t = in[0];
    ++in;
    uint8_t* cur = dst + y * rowbytes;
    const uint8_t* prev = y > 0 ? cur - rowbytes : nullptr;
    switch (t) {
      case 0:
        std::memcpy(cur, in, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          cur[i] = in[i] + (i >= bpp ? cur[i - bpp] : 0);
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          cur[i] = in[i] + (prev ? prev[i] : 0);
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = in[i] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = in[i] + paeth(a, b, c);
        }
        break;
      default:
        return -(y + 1);
    }
  }
  return 0;
}

// YCbCr planes of a JPEG, as its decoder leaves them before upsampling and
// color conversion (luma h x w; chroma ceil(h / vs) x ceil(w / hs), hs and
// vs the luma's sampling factors over the chroma's: 1x1, 2x1 or 2x2), to
// interleaved RGB out[h*w*3] exactly as libjpeg-turbo's default decode
// makes it (PIL's decoder): "fancy" triangle-filter upsampling of the
// chroma (jdsample.c h2v1/h2v2_fancy_upsample, edge rows and columns
// replicated), then its fixed-point YCbCr->RGB (jdcolor.c, 16 fraction
// bits, clamped to 0-255). cb == nullptr is a grayscale image, replicated.
// Returns 0, or -1 for sampling factors other than those three.
int64_t rcfd_jpeg_ycc_to_rgb(const uint8_t* y, const uint8_t* cb,
                             const uint8_t* cr, int64_t h, int64_t w, int hs,
                             int vs, uint8_t* out) {
  if (cb == nullptr) {
    for (int64_t i = 0; i < h * w; ++i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    return 0;
  }
  if (!((hs == 1 && vs == 1) || (hs == 2 && vs == 1) ||
        (hs == 2 && vs == 2)))
    return -1;
  constexpr int kBits = 16;
  constexpr int64_t kHalf = int64_t(1) << (kBits - 1);
  auto fix = [](double x) {
    return static_cast<int64_t>(x * (int64_t(1) << kBits) + 0.5);
  };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kBits);
    cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kBits);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + kHalf;
  }
  const int64_t cw = (w + hs - 1) / hs;
  const int64_t ch = (h + vs - 1) / vs;
  // one upsampled chroma row of each plane: 2 * cw samples
  int32_t* sums = new int32_t[2 * cw];
  uint8_t* up = new uint8_t[2 * 2 * cw];
  for (int64_t r = 0; r < h; ++r) {
    for (int p = 0; p < 2; ++p) {
      const uint8_t* plane = p == 0 ? cb : cr;
      uint8_t* row = up + p * 2 * cw;
      const int64_t in = r / vs;
      const uint8_t* near = plane + in * cw;
      if (vs == 1 && hs == 1) {
        for (int64_t i = 0; i < cw; ++i) row[i] = near[i];
      } else if (vs == 1) {
        // h2v1: 3/4 nearer + 1/4 further sample, biased 1 then 2
        if (cw == 1) {
          row[0] = row[1] = near[0];
        } else {
          row[0] = near[0];
          row[1] = static_cast<uint8_t>((near[0] * 3 + near[1] + 2) >> 2);
          for (int64_t i = 1; i < cw - 1; ++i) {
            const int v = near[i] * 3;
            row[2 * i] = static_cast<uint8_t>((v + near[i - 1] + 1) >> 2);
            row[2 * i + 1] = static_cast<uint8_t>((v + near[i + 1] + 2) >> 2);
          }
          row[2 * cw - 2] = static_cast<uint8_t>(
              (near[cw - 1] * 3 + near[cw - 2] + 1) >> 2);
          row[2 * cw - 1] = near[cw - 1];
        }
      } else {
        // h2v2: the row above for even output rows, below for odd ones
        // (edge rows replicated), then 3/4 : 1/4 along the row
        const int64_t other = (r % 2 == 0) ? (in > 0 ? in - 1 : 0)
                                           : (in + 1 < ch ? in + 1 : ch - 1);
        const uint8_t* far = plane + other * cw;
        for (int64_t i = 0; i < cw; ++i) sums[i] = near[i] * 3 + far[i];
        if (cw == 1) {
          row[0] = static_cast<uint8_t>((sums[0] * 4 + 8) >> 4);
          row[1] = static_cast<uint8_t>((sums[0] * 4 + 7) >> 4);
        } else {
          row[0] = static_cast<uint8_t>((sums[0] * 4 + 8) >> 4);
          row[1] = static_cast<uint8_t>((sums[0] * 3 + sums[1] + 7) >> 4);
          for (int64_t i = 1; i < cw - 1; ++i) {
            row[2 * i] = static_cast<uint8_t>(
                (sums[i] * 3 + sums[i - 1] + 8) >> 4);
            row[2 * i + 1] = static_cast<uint8_t>(
                (sums[i] * 3 + sums[i + 1] + 7) >> 4);
          }
          row[2 * cw - 2] = static_cast<uint8_t>(
              (sums[cw - 1] * 3 + sums[cw - 2] + 8) >> 4);
          row[2 * cw - 1] = static_cast<uint8_t>((sums[cw - 1] * 4 + 7) >> 4);
        }
      }
    }
    const uint8_t* yr = y + r * w;
    const uint8_t* cbr = up;
    const uint8_t* crr = up + 2 * cw;
    uint8_t* o = out + r * w * 3;
    for (int64_t i = 0; i < w; ++i) {
      const int yy = yr[i];
      const int b = cbr[i], c = crr[i];
      const int rv = yy + cr_r[c];
      const int gv = yy + static_cast<int>((cb_g[b] + cr_g[c]) >> kBits);
      const int bv = yy + cb_b[b];
      o[3 * i] = static_cast<uint8_t>(rv < 0 ? 0 : rv > 255 ? 255 : rv);
      o[3 * i + 1] = static_cast<uint8_t>(gv < 0 ? 0 : gv > 255 ? 255 : gv);
      o[3 * i + 2] = static_cast<uint8_t>(bv < 0 ? 0 : bv > 255 ? 255 : bv);
    }
  }
  delete[] sums;
  delete[] up;
  return 0;
}

// Filter `rows` rows of rowbytes bytes (src) into dst (rows * (1 +
// rowbytes) bytes), each row with the filter type of least cost (libpng's
// default heuristic: the least sum of the filtered bytes read as signed).
// scratch holds 2 * rowbytes bytes. Returns 0.
int64_t rcfd_png_filter(const uint8_t* src, uint8_t* dst, int64_t rows,
                        int64_t rowbytes, int bpp, uint8_t* scratch) {
  uint8_t* zeros = scratch;
  uint8_t* trial = scratch + rowbytes;
  std::memset(zeros, 0, rowbytes);
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* cur = src + y * rowbytes;
    const uint8_t* prev = y > 0 ? cur - rowbytes : zeros;
    uint8_t* out = dst + y * (rowbytes + 1);
    uint64_t best = filter_row(0, cur, prev, rowbytes, bpp, out + 1);
    int best_t = 0;
    for (int t = 1; t <= 4; ++t) {
      const uint64_t cost = filter_row(t, cur, prev, rowbytes, bpp, trial);
      if (cost < best) {
        best = cost;
        best_t = t;
        std::memcpy(out + 1, trial, rowbytes);
      }
    }
    out[0] = static_cast<uint8_t>(best_t);
  }
  return 0;
}

}  // extern "C"
