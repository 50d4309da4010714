// The softsplat's backward for Hopper (sm_90a): the vjp of the bilinear
// summation splat, as a gather.
//
// Replaces the JAX package's temporalstereo_tpu/ops/pallas/splat.py:104
// _bwd, the custom_vjp backward of summation_splat_pallas (no pallas_call
// of its own: XLA autodiff of ops/softsplat.py:summation_splat_einsum),
// which re-designs the reference CUDA kernels updateGradInput and
// updateGradFlow.  For values [B,H,W,C], flow [B,H,W,2] = (fx, fy) in
// pixels and the output's gradient g [B,H,W,C] (all f32, read with their
// own element strides), the source s = (x, y) has the taps t_k, k = 0..3,
// at (x0 + (k & 1), y0 + (k >> 1)) with x0 = floor(x + fx), y0 =
// floor(y + fy), ax = x + fx - x0, ay = y + fy - y0, and the weights
//   w_0 = (1-ax)(1-ay), w_1 = ax(1-ay), w_2 = (1-ax)ay, w_3 = ax ay,
// each tap bounds-checked on its own exactly as csrc/softsplat.cu checks
// it (an invalid tap adds nothing).  Then
//   g_values[s, c] = sum_k w_k g[t_k, c]
//   g_flow[s]      = sum_k (dw_k/dax, dw_k/day) sum_c g[t_k, c] v[s, c]
// with floor() a constant, as JAX differentiates it.
//
// What bounds it on an H100: latency.  At the training step's shape
// (4 x 40 x 148, 7 channels + the weight) it moves about 2.65 MB, 0.8 us at
// 3.35 TB/s, below what one launch costs.  So the design is the simplest
// that is deterministic: one thread per source pixel, which recomputes its
// four taps and weights, reads g at them and writes its own g_values row
// and g_flow pair.  Nothing is scattered, so no atomics: every output is a
// sum in a fixed order (taps 0..3, channels 0..C-1), and two runs give the
// same bits.  Products and sums are rounded one by one (no FMA), as the
// plain version (kernels/splat.py:summation_splat_vjp_plain) forms them.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Args {
  const float* v;
  const float* flow;
  const float* g;
  float* gv;
  float* gf;
  int H, W, C;
  long long n;                          // B * H * W sources
  long long v_s[4], f_s[4], g_s[4];     // element strides: b, h, w, c
};

__global__ void __launch_bounds__(THREADS) softsplat_backward_kernel(Args a) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= a.n) return;
  const long long hw = (long long)a.H * a.W;
  const int b = (int)(p / hw);
  const int s = (int)(p - (long long)b * hw);
  const int y = s / a.W, x = s - y * a.W;

  const float* f = a.flow + b * a.f_s[0] + y * a.f_s[1] + x * a.f_s[2];
  const float xs = (float)x + __ldg(f), ys = (float)y + __ldg(f + a.f_s[3]);
  const float x0 = floorf(xs), y0 = floorf(ys);
  const float ax = xs - x0, ay = ys - y0;

  const float* tap[4];
  float w[4], dwx[4], dwy[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const float tx = x0 + (float)(d & 1), ty = y0 + (float)(d >> 1);
    const bool valid = tx >= 0.f && tx <= (float)(a.W - 1) && ty >= 0.f &&
                       ty <= (float)(a.H - 1);
    tap[d] = valid ? a.g + b * a.g_s[0] + (long long)ty * a.g_s[1] +
                         (long long)tx * a.g_s[2]
                   : nullptr;
    const float wx = (d & 1) ? ax : 1.f - ax;
    const float wy = (d >> 1) ? ay : 1.f - ay;
    w[d] = __fmul_rn(wx, wy);
    dwx[d] = (d & 1) ? wy : -wy;        // d w_d / d ax
    dwy[d] = (d >> 1) ? wx : -wx;       // d w_d / d ay
  }

  const float* v = a.v + b * a.v_s[0] + y * a.v_s[1] + x * a.v_s[2];
  float* gv = a.gv + p * a.C;
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < a.C; ++c) {
    const float vc = __ldg(v + c * a.v_s[3]);
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      if (tap[d] == nullptr) continue;
      const float gt = __ldg(tap[d] + c * a.g_s[3]);
      acc = __fadd_rn(acc, __fmul_rn(w[d], gt));
      dot[d] = __fadd_rn(dot[d], __fmul_rn(gt, vc));
    }
    gv[c] = acc;
  }
  float gx = 0.f, gy = 0.f;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    gx = __fadd_rn(gx, __fmul_rn(dwx[d], dot[d]));
    gy = __fadd_rn(gy, __fmul_rn(dwy[d], dot[d]));
  }
  a.gf[2 * p] = gx;
  a.gf[2 * p + 1] = gy;
}

}  // namespace

// values [B,H,W,C], flow [B,H,W,2], g [B,H,W,C], all float32 with the
// element strides given (b, h, w, c); g_values [B,H,W,C] and g_flow
// [B,H,W,2] float32, contiguous, written whole.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int softsplat_backward(const void* values, const void* flow,
                                  const void* g, void* g_values,
                                  void* g_flow, int B, int H, int W, int C,
                                  long long v_sb, long long v_sh,
                                  long long v_sw, long long v_sc,
                                  long long fl_sb, long long fl_sh,
                                  long long fl_sw, long long fl_sc,
                                  long long g_sb, long long g_sh,
                                  long long g_sw, long long g_sc, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0 || W == 0) return 0;
  if (B < 0 || H < 0 || W < 0 || C < 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.v = (const float*)values;
  a.flow = (const float*)flow;
  a.g = (const float*)g;
  a.gv = (float*)g_values;
  a.gf = (float*)g_flow;
  a.H = H;
  a.W = W;
  a.C = C;
  a.n = (long long)B * H * W;
  a.v_s[0] = v_sb; a.v_s[1] = v_sh; a.v_s[2] = v_sw; a.v_s[3] = v_sc;
  a.f_s[0] = fl_sb; a.f_s[1] = fl_sh; a.f_s[2] = fl_sw; a.f_s[3] = fl_sc;
  a.g_s[0] = g_sb; a.g_s[1] = g_sh; a.g_s[2] = g_sw; a.g_s[3] = g_sc;
  const long long blocks = (a.n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  softsplat_backward_kernel<<<(unsigned)blocks, THREADS, 0,
                              (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
