// yolodata: native host-side data pipeline of the PyTorch/CUDA YOLOv4 port
// (yolov4tpu_torch).  A copy of the JAX package's native/yolodata.cpp, kept
// so the port imports and loads nothing of that package; its functions,
// their C ABI and their arithmetic are unchanged, so with the same compiler
// and flags both libraries give the same bytes.  yolov4tpu_torch/native.py
// builds it with g++ at first use (build/torch_native/) and binds it with
// ctypes.
//
// The reference runs its host hot loops in OpenCV's C++ resize (reference
// utils.py:195) and GT label encoding as a Python double loop over batch x
// boxes (reference utils.py:256-294).  Here, all OpenMP-parallel:
//
//   - resize_bilinear_batch: u8 HWC -> f32 stretch-resize + /255 normalise
//     across the batch;
//   - encode_labels_batch: boxes -> 3 anchor-assigned label grids + xywh,
//     byte-identical to the numpy/python reference semantics;
//   - assemble_batch: fused resize + normalise + box-rescale for a whole
//     batch in one call (one GIL release per batch from Python);
//   - yolo_imread / yolo_ingest_batch: libjpeg JPEG decode, the step that
//     dominates host ingest cost.  yolo_ingest_batch fuses file read +
//     decode + resize + normalise + box-rescale per image under one OpenMP
//     loop, with DCT-domain 1/2, 1/4, 1/8 downscaling when the decode
//     target is much smaller than the source (large photos decode up to ~8x
//     faster AND the IDCT low-pass replaces most of the resize work);
//   - yolo_ingest_aug_batch: the same per mosaic/letterbox tile, with HSV
//     jitter and the horizontal flip fused into the write.
//
// Exposed as a plain C ABI consumed via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

#if !defined(YOLO_NO_JPEG)
#include <csetjmp>

#include <jpeglib.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Bilinear stretch-resize u8 -> f32 (+ /255), cv2-compatible sampling:
// src_x = (dst_x + 0.5) * (src_w / dst_w) - 0.5, edge-clamped.
// src: (sh, sw, 3) uint8; dst: (dh, dw, 3) float32.
// ---------------------------------------------------------------------------
static void resize_one(const uint8_t* src, int sh, int sw, float* dst, int dh,
                       int dw) {
  const float sx = (float)sw / (float)dw;
  const float sy = (float)sh / (float)dh;
  for (int y = 0; y < dh; ++y) {
    float fy = ((float)y + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - (float)y0;
    int y1 = y0 + 1;
    y0 = std::min(std::max(y0, 0), sh - 1);
    y1 = std::min(std::max(y1, 0), sh - 1);
    const uint8_t* row0 = src + (size_t)y0 * sw * 3;
    const uint8_t* row1 = src + (size_t)y1 * sw * 3;
    float* out = dst + (size_t)y * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float fx = ((float)x + 0.5f) * sx - 0.5f;
      int x0 = (int)std::floor(fx);
      float wx = fx - (float)x0;
      int x1 = x0 + 1;
      x0 = std::min(std::max(x0, 0), sw - 1);
      x1 = std::min(std::max(x1, 0), sw - 1);
      const float w00 = (1.0f - wy) * (1.0f - wx);
      const float w01 = (1.0f - wy) * wx;
      const float w10 = wy * (1.0f - wx);
      const float w11 = wy * wx;
      for (int c = 0; c < 3; ++c) {
        float v = w00 * row0[x0 * 3 + c] + w01 * row0[x1 * 3 + c] +
                  w10 * row1[x0 * 3 + c] + w11 * row1[x1 * 3 + c];
        out[x * 3 + c] = v * (1.0f / 255.0f);
      }
    }
  }
}

void resize_bilinear_batch(const uint8_t* const* srcs, const int* src_hw,
                           float* dst, int batch, int dh, int dw) {
#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < batch; ++b) {
    resize_one(srcs[b], src_hw[2 * b], src_hw[2 * b + 1],
               dst + (size_t)b * dh * dw * 3, dh, dw);
  }
}

// ---------------------------------------------------------------------------
// HSV color jitter on one [0,1] RGB pixel — the same float-path formulas as
// cv2.cvtColor(..., COLOR_RGB2HSV/HSV2RGB) used by the python augmentation
// (data/pipeline.py::random_color_jitter): H in [0,360), S/V in [0,1].
// dh360: hue shift in degrees; fs/fv: saturation/value scale factors.
// ---------------------------------------------------------------------------
// NOTE: no per-function fast-math attribute here — differing optimize()
// flags stop GCC inlining this into resize_into's pixel loop, and the
// call-per-pixel costs more than fast-math saves (measured).
static inline void hsv_jitter_px(float* pr, float* pg, float* pb, float dh360,
                                 float fs, float fv) {
  const float r = *pr, g = *pg, b = *pb;
  const float v = std::max(r, std::max(g, b));
  const float mn = std::min(r, std::min(g, b));
  const float d = v - mn;
  float s = v > 0.0f ? d / v : 0.0f;
  float h;
  if (d <= 0.0f) {
    h = 0.0f;
  } else if (v == r) {
    h = 60.0f * (g - b) / d;
    if (h < 0.0f) h += 360.0f;
  } else if (v == g) {
    h = 120.0f + 60.0f * (b - r) / d;
  } else {
    h = 240.0f + 60.0f * (r - g) / d;
  }
  // Wrap without fmod: h is already in [0,360) and |dh360| <= 360, so one
  // conditional add/subtract covers the whole range (fmodf costs ~2x the
  // rest of this function combined — measured 42ns/px before, <15 after).
  h += dh360;
  if (h >= 360.0f) h -= 360.0f;
  else if (h < 0.0f) h += 360.0f;
  s = std::min(std::max(s * fs, 0.0f), 1.0f);
  float vv = std::min(std::max(v * fv, 0.0f), 1.0f);
  const float c = vv * s;
  const float hp = h * (1.0f / 60.0f);
  const int sector = (int)hp;  // 0..5 (hp < 6)
  // fmod(hp, 2) == hp - 2*(sector>>1) for hp in [0, 6).
  const float x =
      c * (1.0f - std::fabs(hp - (float)(2 * (sector >> 1)) - 1.0f));
  const float m = vv - c;
  float ro = 0, go = 0, bo = 0;
  switch (sector) {
    case 0: ro = c; go = x; break;
    case 1: ro = x; go = c; break;
    case 2: go = c; bo = x; break;
    case 3: go = x; bo = c; break;
    case 4: ro = x; bo = c; break;
    default: ro = c; bo = x; break;  // sector 5 (and hp==6.0 edge)
  }
  *pr = ro + m;
  *pg = go + m;
  *pb = bo + m;
}

// Bilinear-resize a u8 HWC source into a SUBRECT of a float canvas
// (row stride cw pixels), with /255 normalise, optional fused HSV jitter,
// and optional fused horizontal mirror (the rect maps to its canvas-width
// mirror image — one pass instead of a later whole-canvas flip).  Same
// cv2-compatible sampling as resize_one.  Disjoint rects stay disjoint
// under the mirror, so the tile loop remains writer-safe under OpenMP.
static void resize_into(const uint8_t* src, int sh, int sw, float* canvas,
                        int cw, int x0, int y0, int qw, int qh, int jitter,
                        float dh360, float fs, float fv, int mirror) {
  const float sx = (float)sw / (float)qw;
  const float sy = (float)sh / (float)qh;
  for (int y = 0; y < qh; ++y) {
    float fy = ((float)y + 0.5f) * sy - 0.5f;
    int yy0 = (int)std::floor(fy);
    float wy = fy - (float)yy0;
    int yy1 = yy0 + 1;
    yy0 = std::min(std::max(yy0, 0), sh - 1);
    yy1 = std::min(std::max(yy1, 0), sh - 1);
    const uint8_t* row0 = src + (size_t)yy0 * sw * 3;
    const uint8_t* row1 = src + (size_t)yy1 * sw * 3;
    float* out_row = canvas + (size_t)(y0 + y) * cw * 3;
    for (int x = 0; x < qw; ++x) {
      float fx = ((float)x + 0.5f) * sx - 0.5f;
      int xx0 = (int)std::floor(fx);
      float wx = fx - (float)xx0;
      int xx1 = xx0 + 1;
      xx0 = std::min(std::max(xx0, 0), sw - 1);
      xx1 = std::min(std::max(xx1, 0), sw - 1);
      const float w00 = (1.0f - wy) * (1.0f - wx);
      const float w01 = (1.0f - wy) * wx;
      const float w10 = wy * (1.0f - wx);
      const float w11 = wy * wx;
      float px[3];
      for (int c = 0; c < 3; ++c) {
        float v = w00 * row0[xx0 * 3 + c] + w01 * row0[xx1 * 3 + c] +
                  w10 * row1[xx0 * 3 + c] + w11 * row1[xx1 * 3 + c];
        px[c] = v * (1.0f / 255.0f);
      }
      if (jitter) hsv_jitter_px(&px[0], &px[1], &px[2], dh360, fs, fv);
      const int xc = mirror ? cw - 1 - (x0 + x) : x0 + x;
      float* out = out_row + (size_t)xc * 3;
      out[0] = px[0];
      out[1] = px[1];
      out[2] = px[2];
    }
  }
}

// ---------------------------------------------------------------------------
// GT label encoding (parity with data/encode.preprocess_true_boxes, which in
// turn matches reference utils.py:210-303):
//   - centers via floor((x1+x2)/2) (the reference's float floor-division);
//   - best of 9 origin-centred anchors by IoU; anchor // 3 selects the scale;
//   - grids store absolute-pixel xy/wh, conf 1, one-hot class (accumulating);
//   - later boxes overwrite earlier ones in the same (cell, anchor);
//   - out-of-range cells are clipped (reference would crash).
//
// boxes:  (bs, max_boxes, 5) f32 [x1,y1,x2,y2,cls]; zero rows are padding.
// anchors: (9, 2) f32. grids: 3 pointers to zeroed
// (bs, h/stride, w/stride, 3, 5+nc) f32. xywh_out: (bs, max_boxes, 4) f32.
// ---------------------------------------------------------------------------
void encode_labels_batch(const float* boxes, int bs, int max_boxes, int img_h,
                         int img_w, const float* anchors, int num_classes,
                         const int* strides, float* const* grids,
                         float* xywh_out) {
  const int nf = 5 + num_classes;
  int gh[3], gw[3];
  size_t gstride_b[3];
  for (int s = 0; s < 3; ++s) {
    gh[s] = img_h / strides[s];
    gw[s] = img_w / strides[s];
    gstride_b[s] = (size_t)gh[s] * gw[s] * 3 * nf;
  }
#pragma omp parallel for schedule(static)
  for (int b = 0; b < bs; ++b) {
    for (int m = 0; m < max_boxes; ++m) {
      const float* bx = boxes + ((size_t)b * max_boxes + m) * 5;
      const float cx = std::floor((bx[0] + bx[2]) * 0.5f);
      const float cy = std::floor((bx[1] + bx[3]) * 0.5f);
      const float w = bx[2] - bx[0];
      const float h = bx[3] - bx[1];
      float* xo = xywh_out + ((size_t)b * max_boxes + m) * 4;
      xo[0] = cx;
      xo[1] = cy;
      xo[2] = w;
      xo[3] = h;
      if (!(w > 0.0f)) continue;

      // Best anchor by IoU of origin-centred rectangles.
      int best = 0;
      float best_iou = -1.0f;
      for (int a = 0; a < 9; ++a) {
        const float aw = anchors[2 * a], ah = anchors[2 * a + 1];
        const float iw = std::max(
            0.0f, std::min(w * 0.5f, aw * 0.5f) - std::max(-w * 0.5f, -aw * 0.5f));
        const float ih = std::max(
            0.0f, std::min(h * 0.5f, ah * 0.5f) - std::max(-h * 0.5f, -ah * 0.5f));
        const float inter = iw * ih;
        const float iou = inter / (w * h + aw * ah - inter);
        if (iou > best_iou) {
          best_iou = iou;
          best = a;
        }
      }
      const int stage = best / 3;
      const int aidx = best % 3;
      // Cell index must match the numpy reference bit-for-bit: an f64
      // divide rounded to f32 (the reference stores into a float32 array),
      // then an f64 multiply before the floor.  Centers are integers, so
      // cx/img_w*grid == cx/stride hits exact integers for 1-in-stride
      // boxes — the rounding path decides which cell those land in.
      const float nx = (float)((double)cx / (double)img_w);
      const float ny = (float)((double)cy / (double)img_h);
      int col = (int)std::floor((double)nx * (double)gw[stage]);
      int row = (int)std::floor((double)ny * (double)gh[stage]);
      col = std::min(std::max(col, 0), gw[stage] - 1);
      row = std::min(std::max(row, 0), gh[stage] - 1);
      const int cls = (int)bx[4];

      float* cell = grids[stage] + (size_t)b * gstride_b[stage] +
                    (((size_t)row * gw[stage] + col) * 3 + aidx) * nf;
      cell[0] = cx;
      cell[1] = cy;
      cell[2] = w;
      cell[3] = h;
      cell[4] = 1.0f;
      if (cls >= 0 && cls < num_classes) cell[5 + cls] = 1.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// Fused batch assembly: per-sample resize+normalise AND box rescale to the
// target size.  boxes are (max_boxes, 5) per sample, rescaled in place by
// (dw/sw, dh/sh) — matching reference utils.py:199-204 stretch semantics.
// ---------------------------------------------------------------------------
void assemble_batch(const uint8_t* const* srcs, const int* src_hw,
                    float* imgs_out, float* boxes_inout, int batch,
                    int max_boxes, int dh, int dw) {
#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < batch; ++b) {
    const int sh = src_hw[2 * b], sw = src_hw[2 * b + 1];
    resize_one(srcs[b], sh, sw, imgs_out + (size_t)b * dh * dw * 3, dh, dw);
    const float fx = (float)dw / (float)sw;
    const float fy = (float)dh / (float)sh;
    float* bx = boxes_inout + (size_t)b * max_boxes * 5;
    for (int m = 0; m < max_boxes; ++m) {
      bx[m * 5 + 0] *= fx;
      bx[m * 5 + 2] *= fx;
      bx[m * 5 + 1] *= fy;
      bx[m * 5 + 3] *= fy;
    }
  }
}

int yolodata_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg / libjpeg-turbo).
//
// Error contract: every failure path returns a negative status instead of
// calling libjpeg's exit(); Python falls back to cv2 for that image.
//   -1 file unreadable, -2 not a decodable JPEG (or libjpeg error),
//   -3 unsupported color layout / undersized buffer,
//   -4 EXIF orientation != 1 (cv2.imread auto-rotates such files; decoding
//      the raw raster here would silently train rotated images against
//      unrotated boxes — the caller's cv2 fallback applies the rotation),
//   -100 built w/o libjpeg.
// ---------------------------------------------------------------------------
#if !defined(YOLO_NO_JPEG)

namespace {

// EXIF orientation (tag 0x0112) from a JPEG byte stream, or 1 when absent/
// unparseable.  Scans the marker chain for APP1/"Exif\0\0" and walks IFD0
// of the embedded TIFF with full bounds checking.
int exif_orientation(const uint8_t* d, size_t n) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return 1;
  size_t i = 2;
  while (i + 4 <= n) {
    if (d[i] != 0xFF) return 1;               // desynced marker chain
    uint8_t m = d[i + 1];
    if (m == 0xFF) { i++; continue; }          // fill byte
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) { i += 2; continue; }
    if (m == 0xD9 || m == 0xDA) return 1;      // EOI / SOS: no EXIF ahead
    size_t seg = (static_cast<size_t>(d[i + 2]) << 8) | d[i + 3];
    if (seg < 2 || i + 2 + seg > n) return 1;
    if (m == 0xE1 && seg >= 2 + 6 + 8) {
      const uint8_t* p = d + i + 4;            // APP1 payload
      size_t len = seg - 2;
      if (std::memcmp(p, "Exif\0\0", 6) == 0) {
        const uint8_t* t = p + 6;              // TIFF header
        size_t tlen = len - 6;
        bool le;
        if (t[0] == 'I' && t[1] == 'I') le = true;
        else if (t[0] == 'M' && t[1] == 'M') le = false;
        else return 1;
        auto u16 = [&](size_t off) -> unsigned {
          return le ? t[off] | (t[off + 1] << 8)
                    : (t[off] << 8) | t[off + 1];
        };
        auto u32 = [&](size_t off) -> size_t {
          return le ? static_cast<size_t>(t[off]) | (t[off + 1] << 8)
                          | (static_cast<size_t>(t[off + 2]) << 16)
                          | (static_cast<size_t>(t[off + 3]) << 24)
                    : (static_cast<size_t>(t[off]) << 24)
                          | (static_cast<size_t>(t[off + 1]) << 16)
                          | (t[off + 2] << 8) | t[off + 3];
        };
        if (tlen < 8 || u16(2) != 0x2A) return 1;
        size_t ifd = u32(4);
        if (ifd + 2 > tlen) return 1;
        unsigned cnt = u16(ifd);
        for (unsigned e = 0; e < cnt; e++) {
          size_t ent = ifd + 2 + static_cast<size_t>(e) * 12;
          if (ent + 12 > tlen) return 1;
          if (u16(ent) == 0x0112 && u16(ent + 2) == 3) {
            unsigned v = u16(ent + 8);
            return (v >= 1 && v <= 8) ? static_cast<int>(v) : 1;
          }
        }
        return 1;  // Exif APP1 without an orientation tag in IFD0
      }
      // Non-Exif APP1 (XMP etc.): fall through and keep scanning — an
      // Exif APP1 may legally follow it in the marker chain.
    }
    i += 2 + seg;
  }
  return 1;
}

struct JerrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jerr_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JerrMgr*>(cinfo->err)->jb, 1);
}

void jerr_silent(j_common_ptr) {}  // no stderr spam from corrupt files

// Largest DCT scale denominator in {8,4,2} whose output still covers
// (min_h, min_w); 1 when the source is already small (or no minimum given).
int pick_denom(int h, int w, int min_h, int min_w) {
  if (min_h <= 0 || min_w <= 0) return 1;
  for (int d = 8; d >= 2; d /= 2) {
    if ((h + d - 1) / d >= min_h && (w + d - 1) / d >= min_w) return d;
  }
  return 1;
}

// Decode an in-memory JPEG byte stream to tightly-packed RGB u8.
// out == nullptr probes only (header parse, no pixel work).
// oh/ow: decode (post-scaling) dims; fh/fw: full source dims (for box
// rescale in original-pixel annotation coordinates).
int decode_jpeg_mem(const uint8_t* data, size_t len, int min_h, int min_w,
                    uint8_t* out, size_t cap, int* oh, int* ow, int* fh,
                    int* fw) {
  // cv2.imread applies EXIF rotation by default; this decoder does not.
  // Route EXIF-rotated files (a small minority of real datasets) to the
  // caller's cv2 fallback instead of silently mis-orienting them.
  if (exif_orientation(data, len) != 1) return -4;
  jpeg_decompress_struct cinfo;
  JerrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  jerr.pub.output_message = jerr_silent;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *fh = static_cast<int>(cinfo.image_height);
  *fw = static_cast<int>(cinfo.image_width);
  cinfo.scale_num = 1;
  cinfo.scale_denom = pick_denom(*fh, *fw, min_h, min_w);
  cinfo.out_color_space = JCS_RGB;  // converts YCbCr and grayscale sources
  if (out == nullptr) {
    jpeg_calc_output_dimensions(&cinfo);
    *oh = static_cast<int>(cinfo.output_height);
    *ow = static_cast<int>(cinfo.output_width);
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_start_decompress(&cinfo);
  *oh = static_cast<int>(cinfo.output_height);
  *ow = static_cast<int>(cinfo.output_width);
  if (cinfo.output_components != 3 ||
      cap < static_cast<size_t>(*oh) * (*ow) * 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * (*ow) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Slurp a file into `buf`.  Returns 0 or -1.
int read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  if (sz <= 0) {
    std::fclose(f);
    return -1;
  }
  std::fseek(f, 0, SEEK_SET);
  buf->resize(static_cast<size_t>(sz));
  size_t got = std::fread(buf->data(), 1, buf->size(), f);
  std::fclose(f);
  return got == buf->size() ? 0 : -1;
}

// File-path convenience wrapper (one read, then in-memory decode).
int decode_jpeg_file(const char* path, int min_h, int min_w, uint8_t* out,
                     size_t cap, int* oh, int* ow, int* fh, int* fw) {
  std::vector<uint8_t> buf;
  if (read_file(path, &buf) != 0) return -1;
  return decode_jpeg_mem(buf.data(), buf.size(), min_h, min_w, out, cap, oh,
                         ow, fh, fw);
}

}  // namespace

#endif  // !YOLO_NO_JPEG

extern "C" {

int yolodata_has_jpeg() {
#if defined(YOLO_NO_JPEG)
  return 0;
#else
  return 1;
#endif
}

// Probe a JPEG: fills decode dims for the given minimum (DCT scaling) and
// the full source dims.  Returns 0 on success, <0 otherwise.
int yolo_imread_probe(const char* path, int min_h, int min_w, int* oh,
                      int* ow, int* fh, int* fw) {
#if defined(YOLO_NO_JPEG)
  (void)path; (void)min_h; (void)min_w; (void)oh; (void)ow; (void)fh;
  (void)fw;
  return -100;
#else
  return decode_jpeg_file(path, min_h, min_w, nullptr, 0, oh, ow, fh, fw);
#endif
}

// Decode a JPEG to RGB u8 into `out` (capacity `cap` bytes) at the same
// scale yolo_imread_probe chose for (min_h, min_w).
int yolo_imread(const char* path, int min_h, int min_w, uint8_t* out,
                long cap, int* oh, int* ow, int* fh, int* fw) {
#if defined(YOLO_NO_JPEG)
  (void)path; (void)min_h; (void)min_w; (void)out; (void)cap; (void)oh;
  (void)ow; (void)fh; (void)fw;
  return -100;
#else
  return decode_jpeg_file(path, min_h, min_w, out,
                          static_cast<size_t>(cap), oh, ow, fh, fw);
#endif
}

// In-memory variants of probe/decode: the caller reads the file bytes ONCE
// (Python: np.fromfile) and runs header probe + pixel decode from the same
// buffer — halves per-image disk I/O vs the path-based pair above, which
// each slurp the file.
int yolo_imread_mem_probe(const uint8_t* data, long len, int min_h,
                          int min_w, int* oh, int* ow, int* fh, int* fw) {
#if defined(YOLO_NO_JPEG)
  (void)data; (void)len; (void)min_h; (void)min_w; (void)oh; (void)ow;
  (void)fh; (void)fw;
  return -100;
#else
  return decode_jpeg_mem(data, static_cast<size_t>(len), min_h, min_w,
                         nullptr, 0, oh, ow, fh, fw);
#endif
}

int yolo_imread_mem(const uint8_t* data, long len, int min_h, int min_w,
                    uint8_t* out, long cap, int* oh, int* ow, int* fh,
                    int* fw) {
#if defined(YOLO_NO_JPEG)
  (void)data; (void)len; (void)min_h; (void)min_w; (void)out; (void)cap;
  (void)oh; (void)ow; (void)fh; (void)fw;
  return -100;
#else
  return decode_jpeg_mem(data, static_cast<size_t>(len), min_h, min_w, out,
                         static_cast<size_t>(cap), oh, ow, fh, fw);
#endif
}

// Fully-native batch ingest: per image (OpenMP-parallel) read the file,
// JPEG-decode, bilinear-resize + /255 into imgs_out, and rescale its
// (max_boxes, 5) box rows from ORIGINAL source pixels to target pixels
// (stretch semantics, reference utils.py:195-204).
// dct_scale != 0 allows libjpeg's DCT-domain 1/2, 1/4, 1/8 downscaling as
// long as the decode still covers (dh, dw) — up to ~8x faster on large
// photos, with the IDCT acting as the anti-alias low-pass; 0 decodes at
// full resolution (bit-compatible with a cv2-decode + resize pipeline).
// status[b] = 0 on success, <0 on failure (that image slot is left
// untouched; the caller backfills via its cv2 fallback).  Returns the
// number of failures.
// Augmentation-capable batch ingest (tile-based).  The PYTHON side plans
// every random draw (per-sample seeded rngs -> deterministic regardless of
// thread count) and all box math; this kernel only executes pixels:
// per TILE (OpenMP-parallel; mosaic emits 4 tiles per sample, letterbox
// and plain emit 1): read file, JPEG-decode (DCT-downscaled to just cover
// the tile rect), bilinear-resize + /255 + optional fused HSV jitter into
// the sample canvas rect; then per SAMPLE: horizontal flip if flagged.
// Tiles of one sample have disjoint rects, so the tile loop is write-safe.
//
// paths/tile_sample/tile_rect(x0,y0,w,h)/tile_hsv(hue deg, sat, val;
// sat<0 -> no jitter): one row per tile.  flip/fill: one per sample
// (fill initialises the canvas — 0 for mosaic, 0.5 for letterbox bars).
// status[t] <0 on tile failure (caller re-does that SAMPLE in python);
// src_hw_out[t] = full source (h, w) for the caller's box math.
// Returns the number of failed tiles.
int yolo_ingest_aug_batch(const char* const* paths, int n_tiles,
                          const int32_t* tile_sample, const int32_t* tile_rect,
                          const float* tile_hsv, const uint8_t* flip,
                          const float* fill, float* imgs_out, int batch,
                          int dh, int dw, int dct_scale, int32_t* status,
                          int32_t* src_hw_out) {
#if defined(YOLO_NO_JPEG)
  for (int t = 0; t < n_tiles; ++t) status[t] = -100;
  (void)paths; (void)tile_sample; (void)tile_rect; (void)tile_hsv; (void)flip;
  (void)fill; (void)imgs_out; (void)batch; (void)dh; (void)dw;
  (void)dct_scale; (void)src_hw_out;
  return n_tiles;
#else
  const size_t canvas_px = (size_t)dh * dw;
  // Skip the canvas fill for samples whose tiles exactly cover it (the
  // common full-rect and non-degenerate mosaic cases) — tiles are
  // disjoint, so covered area == canvas area means full coverage.
  std::vector<size_t> covered(batch, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = tile_sample[t];
    if (s >= 0 && s < batch)
      covered[s] += (size_t)tile_rect[4 * t + 2] * tile_rect[4 * t + 3];
  }
#pragma omp parallel for schedule(static)
  for (int b = 0; b < batch; ++b) {
    if (covered[b] == canvas_px) continue;
    float* c = imgs_out + (size_t)b * canvas_px * 3;
    std::fill(c, c + canvas_px * 3, fill[b]);
  }
  int failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
  for (int t = 0; t < n_tiles; ++t) {
    const int x0 = tile_rect[4 * t], y0 = tile_rect[4 * t + 1];
    const int qw = tile_rect[4 * t + 2], qh = tile_rect[4 * t + 3];
    src_hw_out[2 * t] = 0;
    src_hw_out[2 * t + 1] = 0;
    if (qw < 1 || qh < 1 || x0 < 0 || y0 < 0 || x0 + qw > dw ||
        y0 + qh > dh || tile_sample[t] < 0 || tile_sample[t] >= batch) {
      status[t] = -5;  // malformed rect/sample — planner bug, fail loudly
      ++failures;
      continue;
    }
    const int min_h = dct_scale ? qh : 0;
    const int min_w = dct_scale ? qw : 0;
    int oh = 0, ow = 0, fh = 0, fw = 0;
    std::vector<uint8_t> file;
    int rc = read_file(paths[t], &file);
    std::vector<uint8_t> scratch;
    if (rc == 0) {
      rc = decode_jpeg_mem(file.data(), file.size(), min_h, min_w, nullptr,
                           0, &oh, &ow, &fh, &fw);
    }
    if (rc == 0) {
      scratch.resize(static_cast<size_t>(oh) * ow * 3);
      rc = decode_jpeg_mem(file.data(), file.size(), min_h, min_w,
                           scratch.data(), scratch.size(), &oh, &ow, &fh,
                           &fw);
    }
    status[t] = rc;
    if (rc != 0) {
      ++failures;
      continue;
    }
    src_hw_out[2 * t] = fh;
    src_hw_out[2 * t + 1] = fw;
    const float sat = tile_hsv[3 * t + 1];
    // The sample flip is fused as a mirrored write (identical values to a
    // post-pass whole-canvas flip — a pure permutation — without the extra
    // canvas read+write).  A failed tile leaves its rect unwritten even
    // when the fill was skipped; the caller redoes that whole sample in
    // python, so uninitialised pixels never escape.
    resize_into(scratch.data(), oh, ow,
                imgs_out + (size_t)tile_sample[t] * canvas_px * 3, dw, x0,
                y0, qw, qh, sat >= 0.0f, tile_hsv[3 * t], sat,
                tile_hsv[3 * t + 2], flip[tile_sample[t]]);
  }
  return failures;
#endif
}

int yolo_ingest_batch(const char* const* paths, int batch, float* imgs_out,
                      float* boxes_inout, int max_boxes, int dh, int dw,
                      int dct_scale, int32_t* status) {
#if defined(YOLO_NO_JPEG)
  for (int b = 0; b < batch; ++b) status[b] = -100;
  (void)paths; (void)imgs_out; (void)boxes_inout; (void)max_boxes;
  (void)dh; (void)dw; (void)dct_scale;
  return batch;
#else
  const int min_h = dct_scale ? dh : 0;
  const int min_w = dct_scale ? dw : 0;
  int failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
  for (int b = 0; b < batch; ++b) {
    int oh = 0, ow = 0, fh = 0, fw = 0;
    // One file read; header-only probe sizes the scratch buffer, then the
    // pixel decode runs from the same in-memory bytes.
    std::vector<uint8_t> file;
    int rc = read_file(paths[b], &file);
    std::vector<uint8_t> scratch;
    if (rc == 0) {
      rc = decode_jpeg_mem(file.data(), file.size(), min_h, min_w, nullptr,
                           0, &oh, &ow, &fh, &fw);
    }
    if (rc == 0) {
      scratch.resize(static_cast<size_t>(oh) * ow * 3);
      rc = decode_jpeg_mem(file.data(), file.size(), min_h, min_w,
                           scratch.data(), scratch.size(), &oh, &ow, &fh,
                           &fw);
    }
    status[b] = rc;
    if (rc != 0) {
      ++failures;
      continue;
    }
    resize_one(scratch.data(), oh, ow,
               imgs_out + static_cast<size_t>(b) * dh * dw * 3, dh, dw);
    const float fx = static_cast<float>(dw) / static_cast<float>(fw);
    const float fy = static_cast<float>(dh) / static_cast<float>(fh);
    float* bx = boxes_inout + static_cast<size_t>(b) * max_boxes * 5;
    for (int m = 0; m < max_boxes; ++m) {
      bx[m * 5 + 0] *= fx;
      bx[m * 5 + 2] *= fx;
      bx[m * 5 + 1] *= fy;
      bx[m * 5 + 3] *= fy;
    }
  }
  return failures;
#endif
}

}  // extern "C"
