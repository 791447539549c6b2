// Native host-side data preparation for racformer_tpu_torch: a copy of
// racformer_tpu/csrc/dataloader.cpp, built by data/native.py.
//
// The reference relies on turbojpeg + 4 dataloader worker processes per GPU
// for image decode and resize (the reference's loaders/pipelines/loading.py:
// 603-738, loaders/builder.py:9-49). This library provides the equivalent hot
// path as a small C++ shared object bound via ctypes: JPEG decode (libjpeg),
// bilinear resize, crop and horizontal flip fused into one pass, writing
// directly into caller-provided (pinned) buffers so the python side does no
// per-pixel work.
//
// Build: g++ -O3 -shared -fPIC dataloader.cpp -ljpeg -o libracloader.so

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

}  // namespace

extern "C" {

// Decode a JPEG from memory into an RGB uint8 buffer.
// Returns 0 on success; fills *out_w / *out_h. `out` must hold max_w*max_h*3.
int rac_decode_jpeg(const uint8_t* data, int len, uint8_t* out, int max_w,
                    int max_h, int* out_w, int* out_h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  if (w > max_w || h > max_h) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  *out_w = w;
  *out_h = h;
  JSAMPROW row;
  while (cinfo.output_scanline < cinfo.output_height) {
    row = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Fused resize(bilinear) + crop + optional horizontal flip + RGB->BGR.
// src: [src_h, src_w, 3] uint8. dst: [out_h, out_w, 3] float32.
// The source pixel for output (x, y) is ((crop_x + x') / scale, (crop_y + y) /
// scale) with x' mirrored when flip — matching PIL resize->crop->flip
// semantics used by the reference pipeline.
void rac_resize_crop_flip(const uint8_t* src, int src_h, int src_w, float scale,
                          int crop_x, int crop_y, int flip, float* dst,
                          int out_h, int out_w, int to_bgr) {
  const float inv = 1.0f / scale;
  for (int y = 0; y < out_h; ++y) {
    // PIL box-center convention: map output pixel center to source coords
    float sy = (crop_y + y + 0.5f) * inv - 0.5f;
    if (sy < 0) sy = 0;
    if (sy > src_h - 1) sy = static_cast<float>(src_h - 1);
    const int y0 = static_cast<int>(sy);
    const int y1 = y0 + 1 < src_h ? y0 + 1 : y0;
    const float wy = sy - y0;
    float* out_row = dst + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const int xo = flip ? (out_w - 1 - x) : x;
      float sx = (crop_x + x + 0.5f) * inv - 0.5f;
      if (sx < 0) sx = 0;
      if (sx > src_w - 1) sx = static_cast<float>(src_w - 1);
      const int x0 = static_cast<int>(sx);
      const int x1 = x0 + 1 < src_w ? x0 + 1 : x0;
      const float wx = sx - x0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * src_w + x0) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * src_w + x1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * src_w + x0) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * src_w + x1) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] * (1 - wx) + p01[c] * wx;
        const float bot = p10[c] * (1 - wx) + p11[c] * wx;
        const float v = top * (1 - wy) + bot * wy;
        const int cc = to_bgr ? 2 - c : c;
        out_row[static_cast<size_t>(xo) * 3 + cc] = v;
      }
    }
  }
}

// Radar depth/RCS column rasterizer (the reference's no-elevation smear,
// loaders/pipelines/loading.py:547-548). points: [n, 4+] rows of
// (u, v, depth, rcs) already projected; writes depth/rcs whole columns,
// nearest depth wins.
void rac_radar_columns(const float* uvdr, int n, float* depth_map,
                       float* rcs_map, int h, int w, float d_min, float d_max) {
  std::vector<float> best(w, 1e30f);
  std::vector<float> rcs(w, -1000.0f);
  std::vector<uint8_t> hit(w, 0);
  for (int i = 0; i < n; ++i) {
    const float u = uvdr[i * 4 + 0];
    const float d = uvdr[i * 4 + 2];
    const int ui = static_cast<int>(u + 0.5f);
    if (d < d_min || d >= d_max || ui < 0 || ui >= w) continue;
    if (d < best[ui]) {
      best[ui] = d;
      rcs[ui] = uvdr[i * 4 + 3];
      hit[ui] = 1;
    }
  }
  for (int x = 0; x < w; ++x) {
    const float dv = hit[x] ? best[x] : 0.0f;
    const float rv = rcs[x];
    for (int y = 0; y < h; ++y) {
      depth_map[static_cast<size_t>(y) * w + x] = dv;
      rcs_map[static_cast<size_t>(y) * w + x] = rv;
    }
  }
}

}  // extern "C"
