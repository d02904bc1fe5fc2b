// JPEG decode on the card through nvJPEG (libnvjpeg of the CUDA toolkit):
// the route of the port's codec for frames served on a CUDA device
// (rcfd_tpu_torch/native). The GPU machine has no libjpeg, which the JAX
// package's codec (rcfd_tpu/native/dataloader.cpp) links. nvJPEG's own RGB
// output upsamples the chroma by repeating samples, where libjpeg (and PIL)
// interpolate, which moves an RGB value by up to 85 levels at a sharp color
// edge. So this decodes the YCbCr planes into device memory, and codec.cpp
// upsamples and converts them with libjpeg-turbo's arithmetic.
//
// One nvJPEG handle and decode state serve the process, behind a mutex: a
// decode state is not safe to share between threads.
//
// Build: rcfd_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC with the
// toolkit's include directory, links libnvjpeg).

#include <cstddef>
#include <cstdint>
#include <mutex>

#include <nvjpeg.h>

namespace {
std::mutex g_mutex;
nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_state = nullptr;

// 0, or -(100 + status) of the nvJPEG call that failed
int ensure_handle() {
  if (g_state != nullptr) return 0;
  nvjpegStatus_t s = g_handle ? NVJPEG_STATUS_SUCCESS
                              : nvjpegCreateSimple(&g_handle);
  if (s != NVJPEG_STATUS_SUCCESS) return -(100 + (int)s);
  s = nvjpegJpegStateCreate(g_handle, &g_state);
  if (s != NVJPEG_STATUS_SUCCESS) return -(100 + (int)s);
  return 0;
}

// info: h, w, components (1 or 3), the luma's sampling factors over the
// chroma's (hs, vs), then each plane's width and height. 0, -4 for a
// subsampling the codec does not read, or -(100 + status).
int image_info(const uint8_t* data, size_t len, int* info) {
  int n = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegStatus_t s = nvjpegGetImageInfo(g_handle, data, len, &n, &css,
                                        widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) return -(100 + (int)s);
  info[0] = heights[0];
  info[1] = widths[0];
  switch (css) {
    case NVJPEG_CSS_GRAY: info[2] = 1; info[3] = 1; info[4] = 1; break;
    case NVJPEG_CSS_444: info[2] = 3; info[3] = 1; info[4] = 1; break;
    case NVJPEG_CSS_422: info[2] = 3; info[3] = 2; info[4] = 1; break;
    case NVJPEG_CSS_420: info[2] = 3; info[3] = 2; info[4] = 2; break;
    default: return -4;
  }
  if (n != info[2]) return -4;
  for (int c = 0; c < 3; ++c) {
    info[5 + 2 * c] = c < info[2] ? widths[c] : 0;
    info[6 + 2 * c] = c < info[2] ? heights[c] : 0;
  }
  return 0;
}
}  // namespace

extern "C" {

// The header of the JPEG data[len] into info[11] (see image_info).
int rcfd_nvjpeg_info(const uint8_t* data, size_t len, int* info) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int rc = ensure_handle();
  return rc ? rc : image_info(data, len, info);
}

// Decode the JPEG data[len] into its planes: planes[c] device memory of
// the width x height that rcfd_nvjpeg_info gives for plane c, rows of that
// width. The decode is queued on `stream` (a cudaStream_t); the caller
// orders what reads the planes after it on the same stream. Returns 0, or
// what rcfd_nvjpeg_info would, or -(100 + status) of the decode.
int rcfd_nvjpeg_decode_planes(const uint8_t* data, size_t len,
                              uint8_t** planes, void* stream) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int rc = ensure_handle();
  if (rc) return rc;
  int info[11];
  rc = image_info(data, len, info);
  if (rc) return rc;
  nvjpegImage_t image = {};
  for (int c = 0; c < info[2]; ++c) {
    image.channel[c] = planes[c];
    image.pitch[c] = (size_t)info[5 + 2 * c];
  }
  nvjpegStatus_t s = nvjpegDecode(
      g_handle, g_state, data, len,
      info[2] == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV, &image,
      static_cast<cudaStream_t>(stream));
  if (s != NVJPEG_STATUS_SUCCESS) return -(100 + (int)s);
  return 0;
}

}  // extern "C"
