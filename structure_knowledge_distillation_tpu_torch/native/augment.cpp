// Fused host-side augmentation for the segmentation data pipeline.
//
// The port's copy of structure_knowledge_distillation_tpu/native/augment.cpp,
// unchanged in its arithmetic. The per-sample chain cv2.resize -> LUT ->
// float cast -> mean-subtract -> pad -> crop -> flip (reference
// dataset/datasets.py:173-210) makes five full-image passes in numpy. This
// kernel emits the final crop directly from the source image in ONE pass:
// for each output pixel, invert flip/crop/pad/scale to a source coordinate,
// bilinear-sample (cv2 INTER_LINEAR center-aligned convention), subtract the
// BGR mean; labels go through nearest-neighbour (cv2 INTER_NEAREST floor
// convention) + the trainId LUT.
//
// Build: data/native.py compiles it with g++ on first use (the flags of the
// Makefile here, which builds the same library by hand) and loads it through
// ctypes. A failed build raises; the numpy path runs only when a dataset is
// made with use_native=False.

#include <cstdint>
#include <cmath>
#include <algorithm>

namespace {

inline float clampf(float v, float lo, float hi) {
  return std::min(std::max(v, lo), hi);
}

}  // namespace

extern "C" {

// img:    (src_h, src_w, 3) uint8, BGR
// label:  (src_h, src_w) uint8 raw labelIds (may be null for test sets)
// lut:    256-entry labelId -> trainId table (may be null for identity)
// out_img:(crop_h, crop_w, 3) float32; out_label: (crop_h, crop_w) int32
void skd_augment(const uint8_t* img, const uint8_t* label,
                 int src_h, int src_w,
                 double f_scale, int crop_h, int crop_w,
                 int h_off, int w_off, int flip,
                 const float* mean, const uint8_t* lut, int ignore_label,
                 float* out_img, int32_t* out_label) {
  // dst size: cv2's cvRound = round-half-to-even (nearbyint under the
  // default FE_TONEAREST mode); lround's half-away rounding disagrees at
  // exact .5 products (e.g. 55*0.7 = 38.5 -> cv2 38, lround 39), which
  // would shift the pad/crop bounds by a row vs the cv2 reference path.
  const int new_h = (int)std::nearbyint(src_h * f_scale);
  const int new_w = (int)std::nearbyint(src_w * f_scale);
  // cv2.resize called with EXPLICIT fx/fy maps through the given factor
  // (inverse scale = 1/f) — NOT src/dst recomputed from the rounded dst
  // size (those differ whenever src*f is fractional, e.g. 87*1.7 -> 148:
  // 87/148 != 1/1.7, shifting ~5% of nearest indices; verified empirically
  // against cv2 for INTER_NEAREST and INTER_LINEAR).
  const double sy = 1.0 / f_scale;
  const double sx = 1.0 / f_scale;

  for (int y = 0; y < crop_h; ++y) {
    const int ry = y + h_off;  // row in the (padded) resized image
    const bool row_pad = ry >= new_h;
    // bilinear source coordinates for this row (center-aligned)
    double fy = (ry + 0.5) * sy - 0.5;
    fy = clampf((float)fy, 0.0f, (float)(src_h - 1));
    const int y0 = (int)fy;
    const int y1 = std::min(y0 + 1, src_h - 1);
    const float wy = (float)(fy - y0);
    // nearest row for the label (cv2 INTER_NEAREST: floor(dst*scale))
    const int ny = std::min((int)(ry * sy), src_h - 1);

    for (int x = 0; x < crop_w; ++x) {
      const int out_x = flip ? (crop_w - 1 - x) : x;
      const int rx = x + w_off;
      float* op = out_img + ((size_t)y * crop_w + out_x) * 3;
      if (row_pad || rx >= new_w) {
        op[0] = 0.f; op[1] = 0.f; op[2] = 0.f;
        if (out_label) out_label[(size_t)y * crop_w + out_x] = ignore_label;
        continue;
      }
      double fx = (rx + 0.5) * sx - 0.5;
      fx = clampf((float)fx, 0.0f, (float)(src_w - 1));
      const int x0 = (int)fx;
      const int x1 = std::min(x0 + 1, src_w - 1);
      const float wx = (float)(fx - x0);

      const uint8_t* p00 = img + ((size_t)y0 * src_w + x0) * 3;
      const uint8_t* p01 = img + ((size_t)y0 * src_w + x1) * 3;
      const uint8_t* p10 = img + ((size_t)y1 * src_w + x0) * 3;
      const uint8_t* p11 = img + ((size_t)y1 * src_w + x1) * 3;
      const float w00 = (1.f - wy) * (1.f - wx);
      const float w01 = (1.f - wy) * wx;
      const float w10 = wy * (1.f - wx);
      const float w11 = wy * wx;
      for (int c = 0; c < 3; ++c) {
        const float v = w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c];
        // round to uint8 like cv2.resize on a uint8 image does BEFORE the
        // float cast + mean subtract (reference dataset/datasets.py:159,182)
        // — also makes every pixel integer−mean, so the u8 wire format
        // (data/prefetch.py cast_batches) round-trips exactly.
        op[c] = nearbyintf(v) - mean[c];
      }
      if (out_label && label) {
        const int nx = std::min((int)(rx * sx), src_w - 1);
        uint8_t raw = label[(size_t)ny * src_w + nx];
        out_label[(size_t)y * crop_w + out_x] = lut ? (int32_t)lut[raw] : (int32_t)raw;
      }
    }
  }
}

// Confusion-matrix accumulation for host-side evaluation paths.
void skd_confusion(const int32_t* pred, const int32_t* gt, int64_t n,
                   int num_classes, int ignore_label, int64_t* conf) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t g = gt[i];
    if (g == ignore_label) continue;
    const int32_t p = pred[i];
    if (g < 0 || g >= num_classes || p < 0 || p >= num_classes) continue;
    conf[(int64_t)g * num_classes + p] += 1;
  }
}

}  // extern "C"
