// The softsplat's whole backward for Hopper (sm_90a), in one launch.
//
// Replaces the JAX package's temporalstereo_tpu/ops/pallas/splat.py:104
// _bwd, the custom_vjp backward of summation_splat_pallas (no pallas_call
// of its own: XLA autodiff of ops/softsplat.py:summation_splat_einsum),
// which re-designs the reference CUDA kernels updateGradInput and
// updateGradFlow, together with the vjp of the mode weighting and
// normalisation around the splat (ops/softsplat.py:softsplat).  It takes
// inputs [B,H,W,C], flow [B,H,W,2] = (fx, fy) in pixels, metric [B,H,W,1]
// (linear and softmax modes), the forward's output out [B,H,W,C] and its
// normaliser norm [B,H,W,1] (each target's summed weight before + eps, as
// csrc/softsplat.cu keeps it; neither in summation mode) and the output's
// gradient g [B,H,W,C], all f32, read with their own element strides.
//
// The source s = (x, y) has the multiplier m_s = exp(metric) (softmax,
// the same expf as the forward's), metric (linear) or 1 (average), and the
// taps t_k, k = 0..3, at (x0 + (k & 1), y0 + (k >> 1)) with x0 =
// floor(x + fx), y0 = floor(y + fy), ax = x + fx - x0, ay = y + fy - y0,
// the weights
//   w_0 = (1-ax)(1-ay), w_1 = ax(1-ay), w_2 = (1-ax)ay, w_3 = ax ay
// and their derivatives dw_k = (dw_k/dax, dw_k/day), floor() a constant,
// each tap bounds-checked on its own exactly as csrc/softsplat.cu checks it
// (an invalid tap adds nothing).  At a target t, with n_t = norm[t] + eps,
//   gs_c(t) = g[t, c] / n_t,   gs_w(t) = -(sum_c g[t, c] out[t, c]) / n_t
// (in summation mode gs = g and there is no weight term); with v_c =
// inputs[s, c] m_s, the values the forward splatted,
//   G_c = sum_k w_k gs_c(t_k),   G_w = sum_k w_k gs_w(t_k)
//   g_flow[s]    = sum_k dw_k (sum_c gs_c(t_k) v_c + gs_w(t_k) m_s)
//   g_inputs[s]  = G_c m_s (G_c in average and summation modes)
//   g_metric[s]  = sum_c G_c inputs[s, c] + G_w, times m_s in softmax mode.
// G_c, g_inputs and gs_c are f32, each product, quotient and sum rounded
// one by one (no FMA), as the plain version
// (kernels/splat.py:softsplat_vjp_plain) forms them.  gs_c is a quotient,
// as in the chain of whole-tensor steps that tests/test_torch_splat_grad.py
// holds the plain version to: a product with 1 / n_t rounds twice, which
// put g_metric (its two terms cancel in linear mode) more than 1e-6 of its
// largest value from that chain.  The sums that cancel run in f64, where
// the product of two f32 values is exact, and are rounded to f32 once:
// sum_c g out and gs_w, each tap's dot product with the source's values,
// the flow's sum over the taps (its dw_k have opposite signs) and
// g_metric's two terms.  Summed in f32 in channel order, the flow gradient
// on the stream's rigid flow in average mode fell outside chip_smoke.py's
// gate (no further from the f64 plain version than twice the plain f32
// version's own sums); in f64 it sits inside it.
//
// What bounds it on an H100: latency.  Each input is read once and each
// output written once: in softmax mode 25 f32 in and 10 out a source, at
// the training step's temporal update [4,40,148, C = 7] 3.32 MB, 0.99 us at
// 3.35 TB/s, and 1.05 MB, 0.31 us at the stream's [1,48,156], both below
// what one launch costs.
//
// Why one thread per source.  Every output of a source is a gather from
// its own four taps, so a thread that owns the source writes its outputs
// once, with no atomics, each a sum in a fixed order (taps 0..3, channels
// 0..C-1): two runs give the same bits.  The sources are 23,680 at the
// training shape and 7,488 at the stream's.  Channels across the lanes of
// a warp would leave 25 of 32 lanes idle at C = 7.  The kernel's cost is
// each thread's chain: the flow, then the taps' 4 (2C + 1) = 60 values and
// the source's C inputs, then the quotients and the f64 sums.  So the
// loads of a chunk of CHUNK = 8 channels, all independent, are unrolled to
// be in flight together, and one pass over the chunks forms every sum
// (gs_w(t) needs sum_c g out first, but enters only after the pass): a
// loop over single channels waits out one load's latency per channel and
// tap.  A quad of lanes per source, one tap each, joined in
// tap order by shuffles (the same bits), ran faster at the stream's shape,
// where one thread per source leaves most SMs with one warp, and slower at
// the training shape, where it makes 4x the threads repeat the flow, the
// inputs and the sums over channels; only a training step differentiates
// the splat, so a source keeps one thread.  A target's n_t and gs_w(t) are
// formed again by each of the ~4 sources that tap it, from L1.  Blocks of
// 64 threads: 370 blocks at the training shape and 117 at the stream's.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int CHUNK = 8;              // channels a pass, unrolled

enum Mode { SUMMATION = 0, AVERAGE = 1, LINEAR = 2, SOFTMAX = 3 };

struct Args {
  const float* in;
  const float* flow;
  const float* metric;
  const float* out;
  const float* norm;
  const float* g;
  float* g_in;
  float* g_flow;
  float* g_metric;
  int H, W, C, mode;
  float eps;
  long long n;                          // B * H * W sources
  long long in_s[4], fl_s[4], me_s[3], out_s[4], no_s[3], g_s[4];
};

__global__ void __launch_bounds__(THREADS) softsplat_backward_kernel(Args a) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= a.n) return;
  const long long hw = (long long)a.H * a.W;
  const int b = (int)(p / hw);
  const int s = (int)(p - (long long)b * hw);
  const int y = s / a.W, x = s - y * a.W;
  const bool weighted = a.mode != SUMMATION;

  float m = 1.f;
  if (a.mode >= LINEAR) {
    const float mv =
        __ldg(a.metric + b * a.me_s[0] + y * a.me_s[1] + x * a.me_s[2]);
    m = a.mode == SOFTMAX ? expf(mv) : mv;
  }

  const float* f = a.flow + b * a.fl_s[0] + y * a.fl_s[1] + x * a.fl_s[2];
  const float xs = (float)x + __ldg(f), ys = (float)y + __ldg(f + a.fl_s[3]);
  const float x0 = floorf(xs), y0 = floorf(ys);
  const float ax = xs - x0, ay = ys - y0;

  // per tap: g and out at the target (null if the tap is invalid), the
  // weight, its derivatives and n_t
  const float* gt[4];
  const float* ot[4];
  float w[4], dwx[4], dwy[4], n[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const float tx = x0 + (float)(d & 1), ty = y0 + (float)(d >> 1);
    const bool valid = tx >= 0.f && tx <= (float)(a.W - 1) && ty >= 0.f &&
                       ty <= (float)(a.H - 1);
    const long long ity = (long long)ty, itx = (long long)tx;
    gt[d] = valid ? a.g + b * a.g_s[0] + ity * a.g_s[1] + itx * a.g_s[2]
                  : nullptr;
    ot[d] = valid && weighted
                ? a.out + b * a.out_s[0] + ity * a.out_s[1] +
                      itx * a.out_s[2]
                : nullptr;
    const float wx = (d & 1) ? ax : 1.f - ax;
    const float wy = (d >> 1) ? ay : 1.f - ay;
    w[d] = __fmul_rn(wx, wy);
    dwx[d] = (d & 1) ? wy : -wy;        // d w_d / d ax
    dwy[d] = (d >> 1) ? wx : -wx;       // d w_d / d ay
    n[d] = ot[d] != nullptr
               ? __fadd_rn(__ldg(a.norm + b * a.no_s[0] + ity * a.no_s[1] +
                                 itx * a.no_s[2]),
                           a.eps)
               : 1.f;
  }

  // one pass over the channels, CHUNK at a time: sum_c g out (go), G_c,
  // each tap's dot product with the values (dot) and sum_c G_c inputs_c
  // (gm); a chunk's loads, unrolled, are in flight together
  const float* v = a.in + b * a.in_s[0] + y * a.in_s[1] + x * a.in_s[2];
  float* gi = a.g_in + p * a.C;
  double go[4] = {0.0, 0.0, 0.0, 0.0}, dot[4] = {0.0, 0.0, 0.0, 0.0};
  double gm = 0.0;
  for (int c0 = 0; c0 < a.C; c0 += CHUNK) {
    float iv[CHUNK], gv[4][CHUNK], ov[4][CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      iv[j] = c0 + j < a.C ? __ldg(v + (c0 + j) * a.in_s[3]) : 0.f;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const bool in = c0 + j < a.C;
        gv[d][j] = in && gt[d] ? __ldg(gt[d] + (c0 + j) * a.g_s[3]) : 0.f;
        ov[d][j] = in && ot[d] ? __ldg(ot[d] + (c0 + j) * a.out_s[3]) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (c0 + j >= a.C) continue;
      const float vc = a.mode >= LINEAR ? __fmul_rn(iv[j], m) : iv[j];
      float acc = 0.f;                  // G_c
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        if (gt[d] == nullptr) continue;
        const float gs = weighted ? __fdiv_rn(gv[d][j], n[d]) : gv[d][j];
        go[d] = __dadd_rn(go[d],
                          __dmul_rn((double)gv[d][j], (double)ov[d][j]));
        acc = __fadd_rn(acc, __fmul_rn(w[d], gs));
        dot[d] = __dadd_rn(dot[d], __dmul_rn((double)gs, (double)vc));
      }
      gi[c0 + j] = a.mode >= LINEAR ? __fmul_rn(acc, m) : acc;
      gm = __dadd_rn(gm, __dmul_rn((double)acc, (double)iv[j]));
    }
  }
  double gx = 0.0, gy = 0.0, gw = 0.0;  // gw: G_w
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (ot[d] != nullptr) {
      const double gsw = __ddiv_rn(-go[d], (double)n[d]);   // gs_w(t_d)
      dot[d] = __dadd_rn(dot[d], __dmul_rn(gsw, (double)m));
      gw = __dadd_rn(gw, __dmul_rn((double)w[d], gsw));
    }
    gx = __dadd_rn(gx, __dmul_rn((double)dwx[d], dot[d]));
    gy = __dadd_rn(gy, __dmul_rn((double)dwy[d], dot[d]));
  }
  a.g_flow[2 * p] = (float)gx;
  a.g_flow[2 * p + 1] = (float)gy;
  if (a.mode >= LINEAR) {
    const float gmf = (float)__dadd_rn(gm, gw);
    a.g_metric[p] = a.mode == SOFTMAX ? __fmul_rn(gmf, m) : gmf;
  }
}

}  // namespace

// inputs [B,H,W,C], flow [B,H,W,2], metric [B,H,W,1] (null in summation and
// average modes), out [B,H,W,C] and norm [B,H,W,1] (null in summation
// mode), g [B,H,W,C], all float32 with the element strides given (b, h, w,
// c); g_inputs [B,H,W,C], g_flow [B,H,W,2] and g_metric [B,H,W,1] (null in
// summation and average modes) float32, contiguous, written whole.  mode:
// 0 summation, 1 average, 2 linear, 3 softmax.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int softsplat_backward(
    const void* inputs, const void* flow, const void* metric,
    const void* out, const void* norm, const void* g, void* g_inputs,
    void* g_flow, void* g_metric, int B, int H, int W, int C, int mode,
    float eps, long long in_sb, long long in_sh, long long in_sw,
    long long in_sc, long long fl_sb, long long fl_sh, long long fl_sw,
    long long fl_sc, long long me_sb, long long me_sh, long long me_sw,
    long long out_sb, long long out_sh, long long out_sw, long long out_sc,
    long long no_sb, long long no_sh, long long no_sw, long long g_sb,
    long long g_sh, long long g_sw, long long g_sc, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || H < 0 || W < 0 || C < 0 || mode < SUMMATION ||
      mode > SOFTMAX ||
      (mode >= LINEAR && (metric == nullptr || g_metric == nullptr)) ||
      (mode != SUMMATION && (out == nullptr || norm == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  Args a;
  a.in = (const float*)inputs;
  a.flow = (const float*)flow;
  a.metric = (const float*)metric;
  a.out = (const float*)out;
  a.norm = (const float*)norm;
  a.g = (const float*)g;
  a.g_in = (float*)g_inputs;
  a.g_flow = (float*)g_flow;
  a.g_metric = (float*)g_metric;
  a.H = H;
  a.W = W;
  a.C = C;
  a.mode = mode;
  a.eps = eps;
  a.n = (long long)B * H * W;
  a.in_s[0] = in_sb; a.in_s[1] = in_sh; a.in_s[2] = in_sw; a.in_s[3] = in_sc;
  a.fl_s[0] = fl_sb; a.fl_s[1] = fl_sh; a.fl_s[2] = fl_sw; a.fl_s[3] = fl_sc;
  a.me_s[0] = me_sb; a.me_s[1] = me_sh; a.me_s[2] = me_sw;
  a.out_s[0] = out_sb; a.out_s[1] = out_sh; a.out_s[2] = out_sw;
  a.out_s[3] = out_sc;
  a.no_s[0] = no_sb; a.no_s[1] = no_sh; a.no_s[2] = no_sw;
  a.g_s[0] = g_sb; a.g_s[1] = g_sh; a.g_s[2] = g_sw; a.g_s[3] = g_sc;
  const long long blocks = (a.n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  softsplat_backward_kernel<<<(unsigned)blocks, THREADS, 0,
                              (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
