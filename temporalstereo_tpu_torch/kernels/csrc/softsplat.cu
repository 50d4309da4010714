// Softmax splatting (bilinear forward warp) in one launch, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// temporalstereo_tpu/ops/pallas/splat.py:72 summation_splat_pallas (_kernel),
// and the importance weighting and normalisation around it
// (ops/softsplat.py:softsplat).  For inputs [B,H,W,C], flow [B,H,W,2] =
// (fx, fy) in pixels and metric [B,H,W,1] (all f32, read with their own
// element strides), every source pixel s = (x, y) adds
//   inputs[s] * m_s  and the weight  m_s
// bilinearly to the four target pixels around (x + fx, y + fy), where m_s
// is exp(metric) (softmax), metric (linear) or 1 (average); in summation
// mode it adds inputs[s] alone.  The output [B,H,W,C] is the sum divided by
// (weight + eps), or the sum itself in summation mode.  Each tap is
// bounds-checked on its own, in f32, before its coordinate becomes an
// index, so a NaN or huge flow drops the tap instead of wrapping.  The
// output is written once; nothing is zeroed before the launch and the
// kernel needs no scratch in device memory.  Where the caller asks for it
// (a gradient will be taken; not in summation mode), the kernel also
// stores the normaliser norm [B,H,W,1], each target's summed weight before
// + eps, which csrc/softsplat_backward.cu reads; without it the kernel
// writes exactly what it writes otherwise.
//
// What bounds it on an H100: latency and instruction issue.  At the
// temporal update's shape (48x156, 7 channels + the weight) it moves
// 0.51-0.54 MB, 0.16 us at 3.35 TB/s, far below what one launch costs.
//
// Why a gather.  The sums must come out the same in every run: the JAX
// reference is bit-deterministic, and the stream carries the splat's output
// into the next frame through top-k and a sort, where a flipped near-tie
// changes the result.  A float atomicAdd is not deterministic, and to
// shared memory it compiles on sm_90a to a compare-and-swap loop.  An
// integer (fixed-point) sum would be order-free, but the metric is clamped
// to +-50 before exp, so the weights span 1e-22 to 5e21 and no fixed-point
// format holds the sums.  So each target adds its contributions in a fixed
// order, the order of their keys (source index * 4 + tap), in f32.
//
// Why every block reads every source.  A first version split each batch
// item over one 8-block cluster (targets' buckets in distributed shared
// memory, keys in a global scratch array, four cluster barriers) and ran
// 0.08-0.12 ms: on this card a cluster barrier costs ~1400 cycles, and
// scattered loads are paced by requests per SM: with 512 threads each
// waiting on one, a load from another block's shared memory took ~1450
// cycles and one from L2 ~510 (clock64, H100 SXM; scripts and numbers in
// PERF.md).  So the blocks share nothing: block (i, b) owns the tile of
// TILE <= MAX_TILE targets [i * TILE, (i + 1) * TILE) of batch item b
// (about one block per SM), reads the whole flow of b (coalesced, 60 KB at
// 48x156), keeps the taps that land in its tile, and works in its own
// shared memory only:
//   1. each tap takes a slot in its target's bucket of SMALL keys with a
//      shared-memory integer atomic (the slot depends on timing, the set of
//      keys in a bucket does not);
//   2. each bucket is sorted in registers (a fixed network of SMALL keys);
//   3. one thread per key computes the tap's contributions to every
//      channel and to the weight, from the source's flow, metric and inputs;
//   4. one thread per (target, channel) adds its bucket's contributions in
//      key order, normalises and stores.
// A target hit by more than SMALL taps (many sources onto one point) is
// summed by the whole block instead: each thread adds the taps of a fixed
// range of sources in order, and the block adds the threads' sums in a
// fixed tree.  Every sum has a fixed order: the output is bit-identical
// from run to run.  Keys are int32, which bounds H * W per batch item below
// 2^28 (kernels/splat.py:splat_plan); any C is taken CHUNK channels at a
// time.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_TILE = 128;         // targets per block
constexpr int SMALL = 16;             // keys a target's bucket holds
constexpr int CHUNK = 8;              // channels per pass, plus the weight
constexpr int ROW = CHUNK + 1;
constexpr int SMEM = MAX_TILE * SMALL * ROW * 4;  // dynamic: contributions

enum Mode { SUMMATION = 0, AVERAGE = 1, LINEAR = 2, SOFTMAX = 3 };

struct Args {
  const float* in;
  const float* flow;
  const float* metric;
  float* out;
  float* norm;                          // null: not kept
  int H, W, C, mode, tile;
  float eps;
  long long in_s[4], fl_s[4], me_s[3];  // element strides: b, h, w (, c)
};

__device__ __forceinline__ float2 load_flow(const Args& a, int b, int x,
                                            int y) {
  const float* f = a.flow + b * a.fl_s[0] + y * a.fl_s[1] + x * a.fl_s[2];
  return make_float2(__ldg(f), __ldg(f + a.fl_s[3]));
}

// Calls fn(s, x, y, flow) for every source pixel s = y * W + x of batch
// item b, thread tid taking s = tid, tid + THREADS, ...
template <typename F>
__device__ __forceinline__ void for_sources(const Args& a, int b, F fn) {
  const int HW = a.H * a.W, dx = THREADS % a.W, dy = THREADS / a.W;
  int x = threadIdx.x % a.W, y = threadIdx.x / a.W;
  for (int s = threadIdx.x; s < HW; s += THREADS) {
    fn(s, x, y, load_flow(a, b, x, y));
    x += dx;
    y += dy;
    if (x >= a.W) {
      x -= a.W;
      ++y;
    }
  }
}

// Calls fn(l, d, w) for each valid tap d of the source at (x, y) with flow
// fl whose target is t0 + l, 0 <= l < nt, with its bilinear weight w as the
// plain version computes it; rows [ty_lo, ty_hi] hold the targets.
template <typename F>
__device__ __forceinline__ void for_taps(const Args& a, int x, int y,
                                         float2 fl, int t0, int nt,
                                         int ty_lo, int ty_hi, F fn) {
  const float ys = (float)y + fl.y;
  const float y0 = floorf(ys);
  if (!(y0 + 1.f >= (float)ty_lo && y0 <= (float)ty_hi)) return;
  const float xs = (float)x + fl.x;
  const float x0 = floorf(xs);
  const float fx = xs - x0, fy = ys - y0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const float tx = x0 + (float)(d & 1), ty = y0 + (float)(d >> 1);
    if (!(tx >= 0.f && tx <= (float)(a.W - 1) && ty >= 0.f &&
          ty <= (float)(a.H - 1)))
      continue;
    const int l = (int)ty * a.W + (int)tx - t0;
    if (l < 0 || l >= nt) continue;
    const float wx = (d & 1) ? fx : 1.f - fx;
    const float wy = (d >> 1) ? fy : 1.f - fy;
    fn(l, d, __fmul_rn(wx, wy));
  }
}

// The multiplier of a source's values and weight: exp(metric) (softmax),
// metric (linear) or 1.
__device__ __forceinline__ float load_m(const Args& a, int b, int x, int y) {
  if (a.mode < LINEAR) return 1.f;
  const float m =
      __ldg(a.metric + b * a.me_s[0] + y * a.me_s[1] + x * a.me_s[2]);
  return a.mode == SOFTMAX ? expf(m) : m;
}

// A source's contributions to channels [c0, c0 + CHUNK) and to the weight
// through a tap of weight w, as the plain version forms them: (v * m) * w
// and m * w, or v * w in summation and average modes.
__device__ __forceinline__ void contributions(const Args& a, int b, int x,
                                              int y, float w, float m,
                                              int c0, float* row) {
  const float* v = a.in + b * a.in_s[0] + y * a.in_s[1] + x * a.in_s[2];
  float val[CHUNK];
#pragma unroll
  for (int j = 0; j < CHUNK; ++j)
    val[j] = c0 + j < a.C ? __ldg(v + (c0 + j) * a.in_s[3]) : 0.f;
#pragma unroll
  for (int j = 0; j < CHUNK; ++j)
    row[j] = __fmul_rn(a.mode >= LINEAR ? __fmul_rn(val[j], m) : val[j], w);
  row[CHUNK] = __fmul_rn(m, w);
}

__device__ __forceinline__ void store(const Args& a, int b, int t, int c,
                                      float sum, float wsum) {
  a.out[((long long)b * a.H * a.W + t) * a.C + c] =
      a.mode == SUMMATION ? sum : sum / __fadd_rn(wsum, a.eps);
}

// A target hit by more than SMALL taps: thread tid adds the taps of sources
// [tid * q, (tid + 1) * q) in order, then a fixed tree over the threads.
__device__ void big_target(const Args& a, int b, int t, float* part) {
  const int tid = threadIdx.x, HW = a.H * a.W, ty = t / a.W;
  const int q = (HW + THREADS - 1) / THREADS;
  const int lo = min(tid * q, HW), hi = min(lo + q, HW);
  for (int c0 = 0; c0 < a.C; c0 += CHUNK) {
    float acc[ROW], row[ROW];
#pragma unroll
    for (int j = 0; j < ROW; ++j) acc[j] = 0.f;
    int x = lo % a.W, y = lo / a.W;
    for (int s = lo; s < hi; ++s) {
      for_taps(a, x, y, load_flow(a, b, x, y), t, 1, ty, ty,
               [&](int, int, float w) {
                 contributions(a, b, x, y, w, load_m(a, b, x, y), c0, row);
#pragma unroll
                 for (int j = 0; j < ROW; ++j)
                   acc[j] = __fadd_rn(acc[j], row[j]);
               });
      if (++x == a.W) {
        x = 0;
        ++y;
      }
    }
    float* mine = part + tid * ROW;
#pragma unroll
    for (int j = 0; j < ROW; ++j) mine[j] = acc[j];
    __syncthreads();
    for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
      if (tid < stride) {
        const float* other = part + (tid + stride) * ROW;
#pragma unroll
        for (int j = 0; j < ROW; ++j) mine[j] = __fadd_rn(mine[j], other[j]);
      }
      __syncthreads();
    }
    if (tid < CHUNK && c0 + tid < a.C)
      store(a, b, t, c0 + tid, part[tid], part[CHUNK]);
    if (a.norm && tid == 0 && c0 == 0)
      a.norm[(long long)b * HW + t] = part[CHUNK];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) softsplat_kernel(Args a) {
  extern __shared__ float contrib[];  // [SMALL][MAX_TILE][ROW]
  __shared__ int cnt[MAX_TILE];       // taps per target
  __shared__ int keys[MAX_TILE][SMALL];
  __shared__ int big[MAX_TILE];       // targets of more than SMALL taps
  __shared__ int nbig;
  const int tid = threadIdx.x;
  const int b = blockIdx.y, HW = a.H * a.W;
  const int t0 = blockIdx.x * a.tile, nt = min(a.tile, HW - t0);
  if (nt <= 0) return;
  const int ty_lo = t0 / a.W, ty_hi = (t0 + nt - 1) / a.W;

  // 1: the taps landing in the tile: a key each in its target's bucket
  if (tid < MAX_TILE) cnt[tid] = 0;
  if (tid == 0) nbig = 0;
  __syncthreads();
  for_sources(a, b, [&](int s, int x, int y, float2 fl) {
    for_taps(a, x, y, fl, t0, nt, ty_lo, ty_hi, [&](int l, int d, float) {
      const int slot = atomicAdd(cnt + l, 1);
      if (slot < SMALL) keys[l][slot] = 4 * s + d;
    });
  });
  __syncthreads();

  // 2: each bucket in key order (odd-even transposition network); the
  // targets of more than SMALL taps are listed
  if (tid < nt) {
    const int m = cnt[tid];
    if (m > SMALL) {
      big[atomicAdd(&nbig, 1)] = tid;
    } else if (m > 1) {
      int k[SMALL];
#pragma unroll
      for (int j = 0; j < SMALL; ++j) k[j] = j < m ? keys[tid][j] : INT_MAX;
#pragma unroll
      for (int r = 0; r < SMALL; ++r) {
#pragma unroll
        for (int j = r & 1; j + 1 < SMALL; j += 2) {
          const int lo = min(k[j], k[j + 1]), hi = max(k[j], k[j + 1]);
          k[j] = lo;
          k[j + 1] = hi;
        }
      }
#pragma unroll
      for (int j = 0; j < SMALL; ++j)
        if (j < m) keys[tid][j] = k[j];
    }
  }
  __syncthreads();

  for (int c0 = 0; c0 < a.C; c0 += CHUNK) {
    // 3: every tap's contributions, one thread per bucket slot, slot-major
    // so that the warps of the first slots hold most of the taps
    for (int p = tid; p < nt * SMALL; p += THREADS) {
      const int k = p / nt, i = p % nt;
      if (k >= cnt[i] || cnt[i] > SMALL) continue;  // empty, or a big one
      const int key = keys[i][k], s = key >> 2, d = key & 3;
      const int x = s % a.W, y = s / a.W;
      const float2 fl = load_flow(a, b, x, y);
      const float m = load_m(a, b, x, y);
      const float xs = (float)x + fl.x, ys = (float)y + fl.y;
      const float fx = xs - floorf(xs), fy = ys - floorf(ys);
      const float w =
          __fmul_rn((d & 1) ? fx : 1.f - fx, (d >> 1) ? fy : 1.f - fy);
      contributions(a, b, x, y, w, m, c0,
                    contrib + (k * MAX_TILE + i) * ROW);
    }
    __syncthreads();
    // 4: one thread per (target, channel) adds its bucket in key order,
    // normalises and stores
    for (int q = tid; q < nt * CHUNK; q += THREADS) {
      const int i = q / CHUNK, j = q % CHUNK;
      const int m = cnt[i];
      if (m > SMALL || c0 + j >= a.C) continue;
      const float* row = contrib + i * ROW;
      float sum = 0.f, wsum = 0.f;
      for (int k = 0; k < m; ++k) {
        sum = __fadd_rn(sum, row[k * MAX_TILE * ROW + j]);
        wsum = __fadd_rn(wsum, row[k * MAX_TILE * ROW + CHUNK]);
      }
      store(a, b, t0 + i, c0 + j, sum, wsum);
      if (a.norm && c0 + j == 0) a.norm[(long long)b * HW + t0 + i] = wsum;
    }
    __syncthreads();
  }

  // 5: the targets of more than SMALL taps, by the whole block
  for (int j = 0; j < nbig; ++j) big_target(a, b, t0 + big[j], contrib);
}

}  // namespace

// inputs [B,H,W,C], flow [B,H,W,2], metric [B,H,W,1] (null in summation and
// average modes), all float32 with the element strides given (b, h, w, c);
// out [B,H,W,C] float32, contiguous; norm [B,H,W,1] float32, contiguous, or
// null (not written in summation mode).  mode: 0 summation, 1 average,
// 2 linear, 3 softmax.  tile (<= 128 targets per block) comes from
// kernels/splat.py:splat_plan.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int softsplat(const void* inputs, const void* flow,
                         const void* metric, void* out, void* norm, int B,
                         int H, int W, int C, int mode, float eps,
                         long long in_sb, long long in_sh, long long in_sw,
                         long long in_sc, long long fl_sb, long long fl_sh,
                         long long fl_sw, long long fl_sc, long long me_sb,
                         long long me_sh, long long me_sw, int tile,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (mode < SUMMATION || mode > SOFTMAX || (mode >= LINEAR && !metric) ||
      tile < 1 || tile > MAX_TILE)
    return (int)cudaErrorInvalidValue;
  // the shared-memory attribute is raised once per device and process
  static bool smem_set[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[device]) {
    err = cudaFuncSetAttribute(softsplat_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set[device] = true;
  }
  Args a;
  a.in = (const float*)inputs;
  a.flow = (const float*)flow;
  a.metric = (const float*)metric;
  a.out = (float*)out;
  a.norm = mode == SUMMATION ? nullptr : (float*)norm;
  a.H = H;
  a.W = W;
  a.C = C;
  a.mode = mode;
  a.tile = tile;
  a.eps = eps;
  a.in_s[0] = in_sb; a.in_s[1] = in_sh; a.in_s[2] = in_sw; a.in_s[3] = in_sc;
  a.fl_s[0] = fl_sb; a.fl_s[1] = fl_sh; a.fl_s[2] = fl_sw; a.fl_s[3] = fl_sc;
  a.me_s[0] = me_sb; a.me_s[1] = me_sh; a.me_s[2] = me_sw;
  const dim3 grid((unsigned)((H * W + tile - 1) / tile), (unsigned)B);
  softsplat_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
