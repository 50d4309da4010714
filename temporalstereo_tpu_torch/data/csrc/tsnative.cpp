// tsnative — the host data path of temporalstereo_tpu_torch in C++.
//
// The loader's hot loops (data/native.py loads this file's library with
// ctypes; it is built with g++ at first use):
//   ts_decode_pfm      — PFM header parse + endian fix + vertical flip
//   ts_resize_bilinear — align-corners bilinear resize, HWC float32
//   ts_normalize       — (x - mean) / std, in place, channels-last
//   ts_crop            — HWC crop
//   ts_color_jitter    — torchvision-exact photometric aug (random-order
//                        brightness/contrast/saturation/HSV-hue + gamma)
//   ts_png_unfilter    — PNG row unfiltering (all five filters) of the
//                        inflated image data, 16-bit samples to native
//                        order; Python's zlib inflates, so this file
//                        needs no zlib.
//
// The arithmetic of every entry point is the JAX package's native library's
// (native/tsnative.cpp), built with the same flags, so the two agree bit
// for bit.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdlib>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- PFM ----

// Parse a PFM buffer. Returns 0 on success. Writes H, W, C and the header's
// scale and fills `out` (size h*w*c floats, row 0 = top). `out` may be null
// to query dims only.
int ts_decode_pfm(const uint8_t* buf, int64_t len, int* out_h, int* out_w,
                  int* out_c, double* out_scale, float* out) {
  if (len < 3) return -1;
  int color;
  if (buf[0] == 'P' && buf[1] == 'F') color = 1;
  else if (buf[0] == 'P' && buf[1] == 'f') color = 0;
  else return -2;

  // read three whitespace-separated tokens: width, height, scale
  int64_t pos = 2;
  auto skip_ws = [&]() {
    while (pos < len && (buf[pos] == ' ' || buf[pos] == '\n' ||
                         buf[pos] == '\r' || buf[pos] == '\t'))
      pos++;
  };
  auto read_token = [&](char* tok, int cap) -> bool {
    skip_ws();
    int i = 0;
    while (pos < len && i < cap - 1 && buf[pos] != ' ' && buf[pos] != '\n' &&
           buf[pos] != '\r' && buf[pos] != '\t')
      tok[i++] = (char)buf[pos++];
    tok[i] = 0;
    return i > 0;
  };
  char t1[64], t2[64], t3[64];
  if (!read_token(t1, 64) || !read_token(t2, 64) || !read_token(t3, 64))
    return -3;
  int w = atoi(t1), h = atoi(t2);
  double scale = atof(t3);
  if (w <= 0 || h <= 0) return -4;
  // exactly one whitespace char after the scale line
  pos++;

  int c = color ? 3 : 1;
  *out_h = h;
  *out_w = w;
  *out_c = c;
  *out_scale = scale;
  if (!out) return 0;

  int64_t n = (int64_t)h * w * c;
  if (pos + n * 4 > len) return -5;
  const uint8_t* data = buf + pos;
  bool little = scale < 0;
  // PFM rows are bottom-up: flip vertically while copying
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = data + (int64_t)(h - 1 - y) * w * c * 4;
    float* dst = out + (int64_t)y * w * c;
    if (little) {
      memcpy(dst, src, (size_t)w * c * 4);
    } else {
      for (int i = 0; i < w * c; ++i) {
        uint8_t b0 = src[i * 4], b1 = src[i * 4 + 1], b2 = src[i * 4 + 2],
                b3 = src[i * 4 + 3];
        uint8_t swapped[4] = {b3, b2, b1, b0};
        memcpy(dst + i, swapped, 4);
      }
    }
  }
  return 0;
}

// ------------------------------------------------------------- resize ----

// Align-corners bilinear resize of [H, W, C] float32 -> [OH, OW, C].
void ts_resize_bilinear(const float* in, int h, int w, int c, float* out,
                        int oh, int ow) {
  const double sy = oh > 1 ? (double)(h - 1) / (oh - 1) : 0.0;
  const double sx = ow > 1 ? (double)(w - 1) / (ow - 1) : 0.0;

  std::vector<int> x0(ow);
  std::vector<float> fx(ow);
  for (int x = 0; x < ow; ++x) {
    double src = x * sx;
    int lo = (int)src;
    if (lo > w - 2) lo = w - 2 < 0 ? 0 : w - 2;
    x0[x] = lo;
    fx[x] = (float)(src - lo);
  }

  int nthreads = (int)std::min<int64_t>(std::thread::hardware_concurrency(),
                                        (int64_t)oh);
  if (nthreads < 1) nthreads = 1;
  auto work = [&](int y_begin, int y_end) {
    for (int y = y_begin; y < y_end; ++y) {
      double src = y * sy;
      int y0 = (int)src;
      if (y0 > h - 2) y0 = h - 2 < 0 ? 0 : h - 2;
      float wy = (float)(src - y0);
      const float* r0 = in + (int64_t)y0 * w * c;
      const float* r1 = in + (int64_t)std::min(y0 + 1, h - 1) * w * c;
      float* dst = out + (int64_t)y * ow * c;
      for (int x = 0; x < ow; ++x) {
        const float* a = r0 + (int64_t)x0[x] * c;
        const float* b = r0 + (int64_t)std::min(x0[x] + 1, w - 1) * c;
        const float* d = r1 + (int64_t)x0[x] * c;
        const float* e = r1 + (int64_t)std::min(x0[x] + 1, w - 1) * c;
        float wx = fx[x];
        for (int ch = 0; ch < c; ++ch) {
          float top = a[ch] * (1 - wx) + b[ch] * wx;
          float bot = d[ch] * (1 - wx) + e[ch] * wx;
          dst[(int64_t)x * c + ch] = top * (1 - wy) + bot * wy;
        }
      }
    }
  };
  if (nthreads == 1) {
    work(0, oh);
  } else {
    std::vector<std::thread> threads;
    int chunk = (oh + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      int b = t * chunk, e = std::min(oh, b + chunk);
      if (b < e) threads.emplace_back(work, b, e);
    }
    for (auto& th : threads) th.join();
  }
}

// ---------------------------------------------------------- normalize ----

void ts_normalize(float* data, int64_t n_pixels, int c, const float* mean,
                  const float* std_) {
  for (int64_t i = 0; i < n_pixels; ++i) {
    float* p = data + i * c;
    for (int ch = 0; ch < c; ++ch) p[ch] = (p[ch] - mean[ch]) / std_[ch];
  }
}

// --------------------------------------------------------------- crop ----

void ts_crop(const float* in, int h, int w, int c, int y, int x, int ch_,
             int cw, float* out) {
  (void)h;
  for (int row = 0; row < ch_; ++row) {
    memcpy(out + (int64_t)row * cw * c,
           in + ((int64_t)(y + row) * w + x) * c, (size_t)cw * c * 4);
  }
}

// ------------------------------------------------------- color jitter ----

static inline float ts_clip01(float v) {
  return v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
}

// torchvision-exact photometric aug on [n_pixels, 3] RGB float32 in [0,1],
// IN PLACE — the native mirror of data/transforms.py color_jitter
// (reference base.py:73-97 semantics):
//   * the four adjustments run in the CALLER-SUPPLIED order (Python keeps
//     RNG control: factors + torch-style random op permutation drawn there)
//   * op 0 brightness   clip(x * fb)
//   * op 1 contrast     blend with the scalar mean of the ITU-R 601-2
//                       grayscale: clip(fc*x + (1-fc)*mean(gray))
//   * op 2 saturation   blend with per-pixel grayscale
//   * op 3 hue          true HSV rotation by fh (branch structure mirrors
//                       the numpy _rgb_to_hsv/_hsv_to_rgb pair exactly,
//                       including tie-breaks and the floored mod)
//   * then gamma        clip(clip(x)^fgamma)
void ts_color_jitter(float* img, int64_t n_pixels, const int32_t* order,
                     int n_ops, float fb, float fc, float fs, float fh,
                     float fgamma) {
  const int64_t n = n_pixels * 3;
  for (int oi = 0; oi < n_ops; ++oi) {
    switch (order[oi]) {
      case 0: {  // brightness
        for (int64_t i = 0; i < n; ++i) img[i] = ts_clip01(img[i] * fb);
        break;
      }
      case 1: {  // contrast: blend with mean grayscale
        double sum = 0.0;
        for (int64_t i = 0; i < n_pixels; ++i) {
          const float* p = img + i * 3;
          sum += 0.2989f * p[0] + 0.587f * p[1] + 0.114f * p[2];
        }
        const float bg = (1.f - fc) * (float)(sum / (double)n_pixels);
        for (int64_t i = 0; i < n; ++i) img[i] = ts_clip01(fc * img[i] + bg);
        break;
      }
      case 2: {  // saturation: blend with per-pixel grayscale
        for (int64_t i = 0; i < n_pixels; ++i) {
          float* p = img + i * 3;
          const float bg =
              (1.f - fs) * (0.2989f * p[0] + 0.587f * p[1] + 0.114f * p[2]);
          p[0] = ts_clip01(fs * p[0] + bg);
          p[1] = ts_clip01(fs * p[1] + bg);
          p[2] = ts_clip01(fs * p[2] + bg);
        }
        break;
      }
      default: {  // hue rotation in HSV
        for (int64_t i = 0; i < n_pixels; ++i) {
          float* p = img + i * 3;
          const float r = p[0], g = p[1], b = p[2];
          const float maxc = std::max(r, std::max(g, b));
          const float minc = std::min(r, std::min(g, b));
          const float v = maxc, delta = maxc - minc;
          const float s = maxc > 0.f ? delta / std::max(maxc, 1e-12f) : 0.f;
          const float safe = std::max(delta, 1e-12f);
          float h;
          if (maxc == r) h = (g - b) / safe;          // first-match order =
          else if (maxc == g) h = 2.f + (b - r) / safe;  // numpy np.where
          else h = 4.f + (r - g) / safe;
          if (delta > 0.f) {
            h = fmodf(h / 6.f, 1.f);
            if (h < 0.f) h += 1.f;                    // floored mod
          } else {
            h = 0.f;
          }
          h = fmodf(h + fh, 1.f);
          if (h < 0.f) h += 1.f;
          const float h6 = h * 6.f;
          const float ns[3] = {5.f, 3.f, 1.f};
          for (int ch = 0; ch < 3; ++ch) {
            float k = fmodf(ns[ch] + h6, 6.f);
            float t = std::min(k, 4.f - k);
            t = t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
            p[ch] = v * (1.f - s * t);
          }
        }
        break;
      }
    }
  }
  for (int64_t i = 0; i < n; ++i)
    img[i] = ts_clip01(powf(ts_clip01(img[i]), fgamma));
}

// ---------------------------------------------------------------- PNG ----

}  // extern "C"

// The Paeth predictor without branches: p - a = b - c, p - b = a - c and
// p - c = a + b - 2c, so the three distances need no p; the selects
// compile to conditional moves.  On noise-like rows the branches of the
// textbook form mispredict about every other byte.
static inline int ts_paeth(int a, int b, int c) {
  int pa = std::abs(b - c);
  int pb = std::abs(a - c);
  int pc = std::abs(a + b - 2 * c);
  int ab = pb < pa ? b : a;
  int pab = pb < pa ? pb : pa;
  return pc < pab ? c : ab;
}

// One Paeth row of BPP-byte pixels after its first pixel: the left and
// upper-left pixels stay in registers, so the chain from one pixel to the
// next is the predictor alone, not a store and a reload.
template <int BPP>
static void ts_paeth_row(const uint8_t* in, const uint8_t* prev,
                         uint8_t* row, int64_t stride) {
  int left[BPP], upleft[BPP];
  for (int k = 0; k < BPP; ++k) {
    left[k] = row[k];
    upleft[k] = prev[k];
  }
  for (int64_t i = BPP; i < stride; i += BPP) {
    for (int k = 0; k < BPP; ++k) {
      const int b = prev[i + k];
      const int v = (uint8_t)(in[i + k] + ts_paeth(left[k], b, upleft[k]));
      row[i + k] = (uint8_t)v;
      left[k] = v;
      upleft[k] = b;
    }
  }
}

extern "C" {

// Undo the row filters of a non-interlaced PNG's inflated image data: `raw`
// holds h rows of a filter byte and `stride` bytes, `bpp` bytes a pixel
// (the filter unit).  Writes h*stride bytes of samples to `out`, 16-bit
// samples (bitdepth 16) as native-endian uint16.  Returns 0, or -8 for an
// unknown filter.  A row's first pixel has no left neighbour (a = c = 0),
// so it is done first and the rest of the row runs without that test.
int ts_png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int bpp,
                    int bitdepth, void* out) {
  uint8_t* dst8 = (uint8_t*)out;
  std::vector<uint8_t> zeros(stride, 0);
  const int64_t lead = std::min<int64_t>(bpp, stride);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    uint8_t ft = src[0];
    const uint8_t* in = src + 1;
    uint8_t* row = dst8 + y * stride;   // reconstruct into output
    const uint8_t* prev = y > 0 ? row - stride : zeros.data();
    switch (ft) {
      case 0:
        memcpy(row, in, stride);
        break;
      case 1:  // sub
        memcpy(row, in, lead);
        for (int64_t i = lead; i < stride; ++i)
          row[i] = (uint8_t)(in[i] + row[i - bpp]);
        break;
      case 2:  // up
        for (int64_t i = 0; i < stride; ++i)
          row[i] = (uint8_t)(in[i] + prev[i]);
        break;
      case 3:  // average
        for (int64_t i = 0; i < lead; ++i)
          row[i] = (uint8_t)(in[i] + (prev[i] >> 1));
        for (int64_t i = lead; i < stride; ++i)
          row[i] = (uint8_t)(in[i] + ((row[i - bpp] + prev[i]) >> 1));
        break;
      case 4:  // paeth: a = c = 0 makes the predictor b on the first pixel
        for (int64_t i = 0; i < lead; ++i)
          row[i] = (uint8_t)(in[i] + prev[i]);
        switch (bpp) {   // gray, gray + alpha, RGB, RGBA; 16-bit doubles
          case 1: ts_paeth_row<1>(in, prev, row, stride); break;
          case 2: ts_paeth_row<2>(in, prev, row, stride); break;
          case 3: ts_paeth_row<3>(in, prev, row, stride); break;
          case 4: ts_paeth_row<4>(in, prev, row, stride); break;
          case 6: ts_paeth_row<6>(in, prev, row, stride); break;
          case 8: ts_paeth_row<8>(in, prev, row, stride); break;
          default:
            for (int64_t i = lead; i < stride; ++i)
              row[i] = (uint8_t)(in[i] + ts_paeth(row[i - bpp], prev[i],
                                                  prev[i - bpp]));
        }
        break;
      default:
        return -8;
    }
  }

  // 16-bit samples are big-endian on the wire -> native uint16
  if (bitdepth == 16) {
    int64_t n = h * stride / 2;
    uint16_t* p16 = (uint16_t*)out;
    for (int64_t i = 0; i < n; ++i) {
      uint8_t hi = dst8[i * 2], lo = dst8[i * 2 + 1];
      p16[i] = (uint16_t)((hi << 8) | lo);
    }
  }
  return 0;
}

}  // extern "C"
