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
// plus ref, tgt and disp, and writes grad_ref, the f32 grad_tgt and
// grad_disp: ~135 MB at the fine training shape ([4,8,40,148], C=128, bf16)
// and ~383 MB at the precise one ([4,5,80,296]), ~40 / ~114 us at 3.35 TB/s.
//
// Design: one thread per (b, h, x, group of 8 channels), the group fastest,
// looping over the D hypotheses.  grad_ref stays in 8 registers over the
// loop and is stored once (each thread owns its group: no atomics).  The
// warped-side gradient goes to the two taps of an f32 grad_tgt with
// atomicAdd, since hypotheses of different pixels hit the same target
// pixel.  The pixel's grad_disp is summed over its channel groups with warp
// shuffles and stored once per hypothesis.  The atomics make the last bits
// of grad_tgt vary from run to run; the JAX backward is deterministic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "vec8.cuh"

namespace {

using tsk::GROUP;
using tsk::load8;
using tsk::pow2_le_32;
using tsk::round_io;
using tsk::segment_sum;
using tsk::store8;
using tsk::to_f32;

// VEC: the go row stride (2C + C/8 elements) keeps 16-byte alignment.
// SEG: a pixel's G = C/8 threads form an aligned power-of-two segment of a
// warp.  No thread returns early: all lanes take part in the shuffles, and
// lanes past the end write nothing.
template <typename T, bool VEC, bool SEG>
__global__ void __launch_bounds__(256)
fused_cost_base_backward_kernel(const T* __restrict__ go,
                                const T* __restrict__ ref,
                                const T* __restrict__ tgt,
                                const float* __restrict__ disp,
                                T* __restrict__ grad_ref,
                                float* __restrict__ grad_tgt,
                                float* __restrict__ grad_disp, int B, int D,
                                int H, int W, int C) {
  const int G = C / GROUP;
  const int CO = 2 * C + G;
  const long long total = (long long)B * H * W * G;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < total;
  const long long ic = active ? i : total - 1;
  const int g = (int)(ic % G);
  long long t = ic / G;
  const int x = (int)(t % W); t /= W;
  const int h = (int)(t % H);
  const int b = (int)(t / H);
  const long long row = ((long long)b * H + h) * W;   // [B,H,W] row start
  const int c0 = g * GROUP;

  float r[8], gr[8];
  load8<true>(ref + (row + x) * C + c0, r);
#pragma unroll
  for (int k = 0; k < 8; ++k) gr[k] = 0.f;

  for (int d = 0; d < D; ++d) {
    const long long pix = (((long long)b * D + d) * H + h) * W + x;
    const float xs = (float)x - disp[pix];
    const float x0f = floorf(xs);
    const float fx = xs - x0f;
    const float x1f = x0f + 1.f;
    const bool v0 = x0f >= 0.f && x0f <= (float)(W - 1);
    const bool v1 = x1f >= 0.f && x1f <= (float)(W - 1);

    float t0[8], t1[8], w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) t0[k] = t1[k] = 0.f;
    if (v0) load8<true>(tgt + (row + (int)x0f) * C + c0, t0);
    if (v1) load8<true>(tgt + (row + (int)x1f) * C + c0, t1);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float v = 0.f;
      if (v0) v += (1.f - fx) * t0[k];
      if (v1) v += fx * t1[k];
      w[k] = round_io(v, T());
    }

    const T* o = go + pix * CO;
    float g_ref[8], g_w[8];
    load8<VEC>(o + c0, g_ref);
    load8<VEC>(o + C + c0, g_w);
    const float g_corr = to_f32(o[2 * C + g]);

    float s = 0.f;   // d out / d shift, over this group's channels
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float two_diff_gc = 2.f * (r[k] - w[k]) * g_corr;
      gr[k] += g_ref[k] - two_diff_gc;
      const float gw = g_w[k] + two_diff_gc;
      if (v0) {
        if (active) atomicAdd(grad_tgt + (row + (int)x0f) * C + c0 + k,
                              (1.f - fx) * gw);
        s -= gw * t0[k];
      }
      if (v1) {
        if (active) atomicAdd(grad_tgt + (row + (int)x1f) * C + c0 + k,
                              fx * gw);
        s += gw * t1[k];
      }
    }
    if (SEG) {
      s = segment_sum(s, G);
      if (active && g == 0) grad_disp[pix] = -s;
    } else if (active) {
      atomicAdd(grad_disp + pix, -s);
    }
  }
  if (active) store8<true>(grad_ref + (row + x) * C + c0, gr);
}

template <typename T, bool VEC>
void launch_vec(const void* go, const void* ref, const void* tgt,
                const void* disp, void* grad_ref, void* grad_tgt,
                void* grad_disp, int B, int D, int H, int W, int C,
                cudaStream_t stream) {
  const long long total = (long long)B * H * W * (C / GROUP);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (pow2_le_32(C / GROUP))
    fused_cost_base_backward_kernel<T, VEC, true>
        <<<blocks, threads, 0, stream>>>(
            (const T*)go, (const T*)ref, (const T*)tgt, (const float*)disp,
            (T*)grad_ref, (float*)grad_tgt, (float*)grad_disp, B, D, H, W, C);
  else
    fused_cost_base_backward_kernel<T, VEC, false>
        <<<blocks, threads, 0, stream>>>(
            (const T*)go, (const T*)ref, (const T*)tgt, (const float*)disp,
            (T*)grad_ref, (float*)grad_tgt, (float*)grad_disp, B, D, H, W, C);
}

template <typename T>
cudaError_t launch(const void* go, const void* ref, const void* tgt,
                   const void* disp, void* grad_ref, void* grad_tgt,
                   void* grad_disp, int B, int D, int H, int W, int C,
                   cudaStream_t stream) {
  if ((long long)B * H * W * C == 0) return cudaSuccess;
  if (((2 * C + C / GROUP) * sizeof(T)) % 16 == 0)
    launch_vec<T, true>(go, ref, tgt, disp, grad_ref, grad_tgt, grad_disp, B,
                        D, H, W, C, stream);
  else
    launch_vec<T, false>(go, ref, tgt, disp, grad_ref, grad_tgt, grad_disp,
                         B, D, H, W, C, stream);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (go, ref, tgt and grad_ref); disp is
// float32.  grad_tgt ([B,H,W,C]) and grad_disp ([B,D,H,W]) are float32 and
// must be zeroed by the caller.  Returns the cudaError_t of the launch.
extern "C" int fused_cost_base_backward(const void* go, const void* ref,
                                        const void* tgt, const void* disp,
                                        void* grad_ref, void* grad_tgt,
                                        void* grad_disp, int B, int D, int H,
                                        int W, int C, int dtype, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(go, ref, tgt, disp, grad_ref, grad_tgt,
                              grad_disp, B, D, H, W, C, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(go, ref, tgt, disp, grad_ref, grad_tgt,
                                      grad_disp, B, D, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
