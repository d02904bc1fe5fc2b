// JPEG decode on the host through libjpeg: the route of the port's codec
// for frames read on the CPU (rcfd_tpu_torch/native). Its error handler is
// copied from the JPEG half of rcfd_tpu/native/dataloader.cpp. It returns
// the image's YCbCr (or gray) planes as libjpeg decodes them, before
// upsampling and color conversion; codec.cpp turns them into RGB with
// libjpeg-turbo's arithmetic, the same code the card's route (nvJPEG,
// jpeg_nvjpeg.cpp) feeds.
//
// Build: rcfd_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC, links
// libjpeg).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

// libjpeg's default error handler calls exit(); from a worker thread of a
// batch read that would abort the whole process on one corrupt JPEG.
// Install a longjmp-based handler (the documented libjpeg recovery
// pattern) so bad files return an error.
namespace {
struct RcfdJpegErr {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

void rcfd_jpeg_error_exit(j_common_ptr cinfo) {
  RcfdJpegErr* err = reinterpret_cast<RcfdJpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// 1 x 1 chroma under 1 x 1, 2 x 1 or 2 x 2 luma (4:4:4, 4:2:2, 4:2:0)
// YCbCr, or one gray component; anything else the codec does not read.
bool supported(const jpeg_decompress_struct& cinfo) {
  if (cinfo.num_components == 1)
    return cinfo.jpeg_color_space == JCS_GRAYSCALE;
  if (cinfo.num_components != 3 || cinfo.jpeg_color_space != JCS_YCbCr)
    return false;
  const jpeg_component_info* c = cinfo.comp_info;
  for (int i = 1; i < 3; ++i)
    if (c[i].h_samp_factor != 1 || c[i].v_samp_factor != 1) return false;
  const int hs = c[0].h_samp_factor, vs = c[0].v_samp_factor;
  return (hs == 1 && vs == 1) || (hs == 2 && vs == 1) ||
         (hs == 2 && vs == 2);
}
}  // namespace

extern "C" {

// Decode a JPEG file's planes. info receives h, w, the number of
// components (1 or 3) and the luma's sampling factors over the chroma's
// (hs, vs). With planes == nullptr only the header is read; otherwise
// planes[c] receives component c, ceil(h / vs) x ceil(w / hs) for the
// chroma and h x w for the luma. Returns 0; -1 when the file does not
// open, -4 for a layout the codec does not read, -6 when libjpeg reports
// an error.
int rcfd_jpeg_read_planes(const char* path, int* info, uint8_t** planes) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  jpeg_decompress_struct cinfo;
  RcfdJpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = rcfd_jpeg_error_exit;
  // allocated before setjmp so the longjmp never skips a destructor
  std::vector<std::vector<JSAMPLE>> bufs(3);
  std::vector<std::vector<JSAMPROW>> rows(3);
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return -6;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  const int n = cinfo.num_components;
  info[0] = cinfo.image_height;
  info[1] = cinfo.image_width;
  info[2] = n;
  info[3] = cinfo.comp_info[0].h_samp_factor;
  info[4] = cinfo.comp_info[0].v_samp_factor;
  if (!supported(cinfo)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return -4;
  }
  if (planes == nullptr) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return 0;
  }
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);
  // each component's rows of one iMCU row, into buffers padded to whole
  // MCUs, then cropped into planes
  size_t stride[3], rows_per_imcu[3];
  for (int c = 0; c < n; ++c) {
    const jpeg_component_info& comp = cinfo.comp_info[c];
    stride[c] = (size_t)cinfo.MCUs_per_row * comp.h_samp_factor * DCTSIZE;
    if (stride[c] < (size_t)comp.width_in_blocks * DCTSIZE)
      stride[c] = (size_t)comp.width_in_blocks * DCTSIZE;
    rows_per_imcu[c] = (size_t)comp.v_samp_factor * DCTSIZE;
    bufs[c].resize(stride[c] * rows_per_imcu[c] * cinfo.total_iMCU_rows);
    rows[c].resize(rows_per_imcu[c] * cinfo.total_iMCU_rows);
    for (size_t r = 0; r < rows[c].size(); ++r)
      rows[c][r] = bufs[c].data() + r * stride[c];
  }
  JDIMENSION imcu = 0;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPARRAY arrays[3];
    for (int c = 0; c < n; ++c)
      arrays[c] = rows[c].data() + imcu * rows_per_imcu[c];
    jpeg_read_raw_data(&cinfo, arrays,
                       cinfo.max_v_samp_factor * DCTSIZE);
    ++imcu;
  }
  for (int c = 0; c < n; ++c) {
    const jpeg_component_info& comp = cinfo.comp_info[c];
    for (JDIMENSION r = 0; r < comp.downsampled_height; ++r)
      std::memcpy(planes[c] + (size_t)r * comp.downsampled_width,
                  rows[c][r], comp.downsampled_width);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return 0;
}

}  // extern "C"
