// Backward of the fused sparse cost-volume base for Hopper (sm_90a).
//
// Replaces the backward of the JAX package's
// temporalstereo_tpu/ops/pallas/cost.py:fused_cost_base_pallas (its
// custom_vjp _bwd: autodiff of _xla_reference).  The forward
// (fused_cost_base.cu) maps ref/tgt [B,H,W,C] and hypotheses disp [B,D,H,W]
// to out [B,D,H,W,2C+C/8] = (ref, w, corr), w = tgt sampled along W at
// x - d (rounded to the I/O type), corr_g = -sum_{c in g} (ref_c - w_c)^2.
// For the output's gradient go = (g_ref, g_w, g_corr) this computes, per
// hypothesis, with diff = ref - w:
//   grad_ref[b,h,x,c] = sum_d  g_ref_c - 2 diff_c g_corr_g
//   gw_c              =        g_w_c   + 2 diff_c g_corr_g
//   grad_tgt[.., x0, c] += (1-f) gw_c,  grad_tgt[.., x0+1, c] += f gw_c
//   grad_disp = -sum_c gw_c (v1 tgt[x0+1, c] - v0 tgt[x0, c])
// (the warp samples at x + shift with shift = -disp; the gradient through
// floor is 0, through the fraction 1, each tap's validity on its own).  All
// arithmetic is f32; w is recomputed and rounded as the forward rounds it.
//
// What bounds it on an H100: bytes.  It reads go (the forward's output size)
// plus ref, tgt and disp, and writes grad_ref, grad_tgt (both in the I/O
// type) and grad_disp: 128.8 MB at the fine training shape ([4,8,40,148],
// C=128, bf16) and 358.4 MB at the precise one ([4,5,80,296]), 38 / 107 us
// at 3.35 TB/s.
//
// Design (row_owner.cuh): the target side's gradient is a scatter along W
// that many hypotheses of many pixels hit.  One warp owns 32 channels of
// one row (b, h) and keeps that slice of the row's grad_tgt in shared
// memory; it walks the row's D * W pairs x-major, with no atomics (on
// sm_90a a float atomicAdd to shared memory is a compare-and-swap loop),
// and stores the slice once, in the I/O type.  The producer stage computes,
// per pair and channel, w (as the forward rounds it), gw and g_ref - 2 diff
// g_corr, and the pair's sum of gw (t1 - t0) over the slice; the owner stage
// adds gw's two taps into the row and sums a pixel's grad_ref over its D
// hypotheses in a register, stored once.  grad_disp is summed over the
// C / 32 slices (one cluster) through distributed shared memory and stored
// once.  Every sum has a fixed order: the gradients are deterministic.
// What holds it back now: instructions and their latency, with 4 (W = 296)
// to 5 (W = 148) warps per SM: its bytes are read at a fraction of the
// card's rate (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "row_owner.cuh"
#include "vec8.cuh"

namespace {

using tsk::PAIRS;
using tsk::SLICE;
using tsk::Stage;
using tsk::Taps;
using tsk::round_io;
using tsk::store1;
using tsk::to_f32;

// A pair's ring entry: g_ref, g_w, ref, tgt tap 0, tgt tap 1 (32 each),
// g_corr (4 of the slice's groups, padded to 8).
constexpr int PER = 5 * SLICE + 8;
// The producer's stage: the taps, then gw and g_ref - 2 diff g_corr in the
// I/O type (autograd of the plain version rounds gw to it too).
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return sizeof(Stage) + 2 * PAIRS * SLICE * sizeof(T);
}

// One block (one warp) per (row b*H + h, slice of 32 channels); the row's
// slices are one cluster.  ASYNC: rows and go pixels are 16-byte aligned
// and C % 32 == 0, so the ring fills with cp.async.
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(SLICE)
fused_cost_base_backward_kernel(const T* __restrict__ go,
                                const T* __restrict__ ref,
                                const T* __restrict__ tgt,
                                const float* __restrict__ disp,
                                T* __restrict__ grad_ref,
                                T* __restrict__ grad_tgt,
                                float* __restrict__ grad_disp, int D, int H,
                                int W, int C, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = D * W;
  float* acc = reinterpret_cast<float*>(smem);
  char* col = reinterpret_cast<char*>(acc + threadIdx.x);   // lane's column
  float* pd = acc + SLICE * (W + 1);
  T* ring = reinterpret_cast<T*>(smem + tsk::ring_offset(W, n));
  const int lane = threadIdx.x;
  const long long row_id = blockIdx.x / S;     // b * H + h
  const int c0 = (int)(blockIdx.x % S) * SLICE;
  const int c = c0 + lane;
  const bool on = c < C;
  const int CO = 2 * C + C / tsk::GROUP;
  const long long HW = (long long)H * W;
  const long long pix0 = (row_id / H * D * H + row_id % H) * W;  // (b,0,h,0)
  const long long feat0 = row_id * W * C;
  const T* go_row = go + pix0 * CO;
  const T* ref_row = ref + feat0;
  const T* tgt_row = tgt + feat0;
  T* grad_ref_col = grad_ref + feat0 + c;   // (b, h, 0, c)
  const float inv_d = 1.f / (float)D;

  auto fill = [&](int p0, T* slot) {
    if constexpr (ASYNC) {
      constexpr int VEC = 16 / sizeof(T);        // elements per chunk
      constexpr int CH = SLICE / VEC;            // chunks per 32 channels
#pragma unroll
      for (int r = 0; r < (PAIRS * CH + SLICE - 1) / SLICE; ++r) {
        const int k = r * (SLICE / CH) + lane / CH, e = lane % CH * VEC;
        const int p = p0 + k;
        if (k < PAIRS && p < n) {
          const int x = tsk::pair_x(p, inv_d), d = p - x * D;
          const Taps tp = tsk::taps(pd[p], W);
          T* q = slot + k * PER + e;
          const T* o = go_row + (d * HW + x) * CO + c0;
          tsk::cp16(q, o + e);
          tsk::cp16(q + SLICE, o + C + e);
          tsk::cp16(q + 2 * SLICE, ref_row + (long long)x * C + c0 + e);
          tsk::cp16z(q + 3 * SLICE, tgt_row + (long long)tp.s0 * C + c0 + e,
                     tp.v0);
          tsk::cp16z(q + 4 * SLICE, tgt_row + (long long)tp.s1 * C + c0 + e,
                     tp.v1);
          if (e == 0) {   // the slice's 4 groups of g_corr
            if constexpr (sizeof(T) == 2)
              tsk::cp8(q + 5 * SLICE, o + 2 * C - c0 + c0 / tsk::GROUP);
            else
              tsk::cp16(q + 5 * SLICE, o + 2 * C - c0 + c0 / tsk::GROUP);
          }
        }
      }
    } else {   // lanes past C and invalid taps stage zeros
      const int cc = on ? c : C - 1;
      const int gi = c0 / tsk::GROUP + (lane & 3);
      for (int k = 0; k < PAIRS && p0 + k < n; ++k) {
        const int p = p0 + k, x = tsk::pair_x(p, inv_d), d = p - x * D;
        const Taps tp = tsk::taps(pd[p], W);
        T* q = slot + k * PER;
        const T* o = go_row + (d * HW + x) * CO;
        store1(q + lane, on ? to_f32(o[cc]) : 0.f);
        store1(q + SLICE + lane, on ? to_f32(o[C + cc]) : 0.f);
        store1(q + 2 * SLICE + lane,
               on ? to_f32(ref_row[(long long)x * C + cc]) : 0.f);
        store1(q + 3 * SLICE + lane,
               on && tp.v0 ? to_f32(tgt_row[(long long)tp.s0 * C + cc]) : 0.f);
        store1(q + 4 * SLICE + lane,
               on && tp.v1 ? to_f32(tgt_row[(long long)tp.s1 * C + cc]) : 0.f);
        if (lane < 4)
          store1(q + 5 * SLICE + lane,
                 gi < C / tsk::GROUP ? to_f32(o[2 * C + gi]) : 0.f);
      }
    }
  };

  // The producer stage: 16-byte chunks of 8 (bf16) or 4 (f32) channels, a
  // pair's CH lanes side by side, PW pairs per round; it computes gw and
  // g_ref - 2 diff g_corr per channel into a stage half and the pair's sum
  // of gw (t1 - t0) over the slice into pd.  The owner stage: lane =
  // channel.
  constexpr int VEC = tsk::Chunk<T>::N, CH = SLICE / VEC, PW = SLICE / CH;
  constexpr int ROUNDS = PAIRS / PW;
  char* stages = reinterpret_cast<char*>(smem) +
                 tsk::stage_offset(W, n, PER, sizeof(T));
  auto stage = [&](int half) {
    return reinterpret_cast<Stage*>(stages + half * stage_bytes<T>());
  };
  Taps tp[ROUNDS];
  float g_ref[ROUNDS][VEC], g_w[ROUNDS][VEC], rf[ROUNDS][VEC];
  float t0[ROUNDS][VEC], t1[ROUNDS][VEC], g_corr[ROUNDS], sp[ROUNDS];
  auto load = [&](int p0, const T* slot) {
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int k = r * PW + lane / CH, e = lane % CH * VEC;
      tp[r] = tsk::taps(pd[p0 + k], W);
      const T* q = slot + k * PER + e;
      tsk::load_chunk(q, g_ref[r]);
      tsk::load_chunk(q + SLICE, g_w[r]);
      tsk::load_chunk(q + 2 * SLICE, rf[r]);
      tsk::load_chunk(q + 3 * SLICE, t0[r]);   // an invalid tap: zeros
      tsk::load_chunk(q + 4 * SLICE, t1[r]);
      g_corr[r] = to_f32(slot[k * PER + 5 * SLICE + e / tsk::GROUP]);
    }
  };
  auto produce = [&](int p0, int half) {
    Stage* st = stage(half);
    T* st_gw = reinterpret_cast<T*>(st + 1);   // [PAIRS][32]
    T* st_gd = st_gw + PAIRS * SLICE;           // [PAIRS][32]
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int k = r * PW + lane / CH, e = lane % CH * VEC;
      const float fx = tp[r].fx;
      float gw[VEC], gd[VEC], sk = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        // the forward's warped value, as it rounds it
        float v = 0.f;
        v += (1.f - fx) * t0[r][j];
        v += fx * t1[r][j];
        const float w = round_io(v, T());
        const float two_diff_gc = 2.f * (rf[r][j] - w) * g_corr[r];
        gw[j] = g_w[r][j] + two_diff_gc;
        gd[j] = g_ref[r][j] - two_diff_gc;
        sk -= gw[j] * t0[r][j];
        sk += gw[j] * t1[r][j];
      }
      tsk::store_chunk(st_gw + k * SLICE + e, gw);
      tsk::store_chunk(st_gd + k * SLICE + e, gd);
      sp[r] = tsk::segment_sum(sk, CH);
      if (e == 0) st->tap[k] = tsk::stage_tap(tp[r]);
    }
  };
  auto keep = [&](int p0) {   // after every lane has read the positions
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int p = p0 + r * PW + lane / CH;
      if (lane % CH == 0 && p < n) pd[p] = sp[r];
    }
  };
  // the owner stage; a pair past the end (p >= n) has both taps on the
  // trash row and stores no grad_ref
  float gr = 0.f;   // grad_ref of the current pixel over its hypotheses
  auto own = [&](int p0, const T*, int half) {
    const Stage* st = stage(half);
    const T* st_gw = reinterpret_cast<const T*>(st + 1);
    const T* st_gd = st_gw + PAIRS * SLICE;
    float a0[PAIRS], a1[PAIRS], gout[PAIRS];
    int o0[PAIRS], o1[PAIRS], xs[PAIRS];
    bool last[PAIRS];
    int x = tsk::pair_x(p0, inv_d), d = p0 - x * D;
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const float4 t = st->tap[k];
      const float fx = t.x;
      o0[k] = __float_as_int(t.y);
      o1[k] = __float_as_int(t.z);
      const float gw = to_f32(st_gw[k * SLICE + lane]);
      a0[k] = (1.f - fx) * gw;
      a1[k] = fx * gw;
      gr += to_f32(st_gd[k * SLICE + lane]);
      gout[k] = gr;
      last[k] = on && d == D - 1 && p0 + k < n;
      xs[k] = x;
      gr = d == D - 1 ? 0.f : gr;
      if (++d == D) { d = 0; ++x; }
    }
    tsk::add_step_taps(col, o0, o1, a0, a1);
#pragma unroll
    for (int k = 0; k < PAIRS; ++k)
      tsk::store_if(grad_ref_col + xs[k] * C, gout[k], last[k]);
  };

  tsk::begin_row(acc, pd, disp + pix0, -1.f, D, W, HW, lane);
  tsk::walk<T, PER>(n, ring, fill, load, own, produce, keep);
  tsk::end_row(acc, pd, grad_tgt + feat0, grad_disp + pix0, -1.f, D, W, C,
               HW, c, lane);
}

template <typename T>
cudaError_t launch(const void* go, const void* ref, const void* tgt,
                   const void* disp, void* grad_ref, void* grad_tgt,
                   void* grad_disp, int B, int D, int H, int W, int C,
                   int slices, int smem, cudaStream_t stream) {
  if ((long long)B * D * H * W * C == 0) return cudaSuccess;
  if (C % tsk::GROUP || slices > 8 || slices * SLICE < C ||
      (slices - 1) * SLICE >= C ||
      smem < tsk::shared_bytes(W, D * W, PER, sizeof(T), stage_bytes<T>()))
    return cudaErrorInvalidValue;
  const bool async = C % SLICE == 0 &&
                     (2 * C + C / tsk::GROUP) * sizeof(T) % 16 == 0;
  auto kernel = async ? fused_cost_base_backward_kernel<T, true>
                      : fused_cost_base_backward_kernel<T, false>;
  return tsk::launch_rows(kernel, (long long)B * H, slices, smem, stream,
                          (const T*)go, (const T*)ref, (const T*)tgt,
                          (const float*)disp, (T*)grad_ref, (T*)grad_tgt,
                          (float*)grad_disp, D, H, W, C, slices);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (go, ref, tgt, grad_ref and grad_tgt);
// disp and grad_disp ([B,D,H,W]) are float32.  Every output element is
// written exactly once (nothing needs zeroing).  slices = ceil(C / 32) and
// smem = 4 * (32 W + D W) bytes come from the wrapper's plan
// (kernels/launches.py:row_plan).  Returns the cudaError_t of the launch.
extern "C" int fused_cost_base_backward(const void* go, const void* ref,
                                        const void* tgt, const void* disp,
                                        void* grad_ref, void* grad_tgt,
                                        void* grad_disp, int B, int D, int H,
                                        int W, int C, int slices, int smem,
                                        int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(go, ref, tgt, disp, grad_ref, grad_tgt,
                              grad_disp, B, D, H, W, C, slices, smem, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(go, ref, tgt, disp, grad_ref, grad_tgt,
                                      grad_disp, B, D, H, W, C, slices, smem,
                                      s);
  return (int)cudaErrorInvalidValue;
}
