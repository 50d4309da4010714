// Fused sparse cost-volume base for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// temporalstereo_tpu/ops/pallas/cost.py:fused_cost_base_pallas (_kernel).
// Computes, for ref/tgt features [B,H,W,C] and per-pixel disparity
// hypotheses [B,D,H,W] (f32), the [B,D,H,W,2C+C/8] volume
//   out[..., 0:C]     = ref                       (broadcast over D)
//   out[..., C:2C]    = tgt sampled bilinearly along W at x - d, zero padding
//   out[..., 2C+g]    = -sum_{c in group g} (ref - warped)^2, groups of 8
// Coordinates are f32 whatever the I/O type; the warped value is rounded to
// the I/O type before the correlation, as the TPU kernel does.
//
// Column offsets (the W-sharded forward, parallel/spatial.py): ref's column
// x is the frame's column x0 + x, and tgt [B,H,Wt,C] holds the frame's
// columns [t0, t0 + Wt); a tap outside them reads zero.  x0 = t0 = 0 with
// Wt = W is the unsharded call, the same arithmetic.
//
// What bounds it on an H100: bytes.  Per output element it does ~3 flops, so
// it sits far below the card's ridge point; the output (2C+C/8 channels per
// hypothesis) is ~90% of the traffic: ~36.6 MB at the fine stage
// (48x156, C=128, D=8, bf16) and ~97 MB at the precise stage (96x312,
// C=128, D=5), i.e. ~11 us and ~29 us at 3.35 TB/s.
//
// Design: one thread per (b, d, h, x, group of 8 channels), the group index
// fastest.  The 16 threads of a C=128 pixel read the ref vector and the two
// tgt taps as 16-byte (bf16) or 2x16-byte (f32) loads that are contiguous
// across the threads, and write the ref and warped vectors the same way, so
// every warp issues fully coalesced stores of the dominant output.  The TPU
// kernel's one-hot interpolation matmul (a way onto the MXU) is not carried
// over: on this card a 2-tap gather from L1/L2 is cheaper than a W x W
// product.  The ref/tgt rows are re-read for every hypothesis; they are
// 1/17 of the output bytes per hypothesis and stay in L2 (50 MB).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "vec8.cuh"

namespace {

using tsk::GROUP;
using tsk::load8;
using tsk::round_io;
using tsk::store1;
using tsk::store8;

// VEC: the output row stride (2C + C/8 elements) keeps 16-byte alignment.
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
fused_cost_base_kernel(const T* __restrict__ ref, const T* __restrict__ tgt,
                       const float* __restrict__ disp, T* __restrict__ out,
                       int B, int D, int H, int W, int C, int x0, int t0,
                       int Wt) {
  const int G = C / GROUP;
  const long long total = (long long)B * D * H * W * G;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int g = (int)(i % G);
  long long t = i / G;
  const int x = (int)(t % W); t /= W;
  const int h = (int)(t % H); t /= H;
  const int d = (int)(t % D);
  const int b = (int)(t / D);

  const long long pix = ((long long)b * D + d) * H * W + (long long)h * W + x;
  const long long row = ((long long)b * H + h) * W;   // ref's row start
  const long long trow = ((long long)b * H + h) * Wt;  // tgt's row start
  // x + (-disp) in f32, exactly the reference's iota + shift
  const float xs = (float)(x0 + x) - disp[pix];
  const float x0f = floorf(xs);
  const float fx = xs - x0f;

  float r[8], w[8];
  load8<true>(ref + (row + x) * C + g * GROUP, r);
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = 0.f;
  float a0[8], a1[8];
  const float lo = (float)t0, hi = (float)(t0 + Wt - 1);
  if (x0f >= lo && x0f <= hi) {
    load8<true>(tgt + (trow + (int)x0f - t0) * C + g * GROUP, a0);
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] += (1.f - fx) * a0[k];
  }
  const float x1f = x0f + 1.f;
  if (x1f >= lo && x1f <= hi) {
    load8<true>(tgt + (trow + (int)x1f - t0) * C + g * GROUP, a1);
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] += fx * a1[k];
  }
  float corr = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    w[k] = round_io(w[k], T());
    const float df = r[k] - w[k];
    corr -= df * df;
  }

  T* o = out + pix * (2 * C + G);
  store8<VEC>(o + g * GROUP, r);
  store8<VEC>(o + C + g * GROUP, w);
  store1(o + 2 * C + g, corr);
}

template <typename T>
cudaError_t launch(const void* ref, const void* tgt, const void* disp,
                   void* out, int B, int D, int H, int W, int C, int x0,
                   int t0, int Wt, cudaStream_t stream) {
  const long long total = (long long)B * D * H * W * (C / GROUP);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  const bool vec = ((2 * C + C / GROUP) * sizeof(T)) % 16 == 0;
  if (vec) {
    fused_cost_base_kernel<T, true><<<blocks, threads, 0, stream>>>(
        (const T*)ref, (const T*)tgt, (const float*)disp, (T*)out, B, D, H, W, C,
        x0, t0, Wt);
  } else {
    fused_cost_base_kernel<T, false><<<blocks, threads, 0, stream>>>(
        (const T*)ref, (const T*)tgt, (const float*)disp, (T*)out, B, D, H, W, C,
        x0, t0, Wt);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (ref, tgt and out); disp is float32.
// ref is [B,H,W,C] at the frame's column x0, tgt [B,H,Wt,C] at column t0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_cost_base(const void* ref, const void* tgt,
                               const void* disp, void* out, int B, int D,
                               int H, int W, int C, int x0, int t0, int Wt,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    return (int)launch<float>(ref, tgt, disp, out, B, D, H, W, C, x0, t0,
                              Wt, (cudaStream_t)stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(ref, tgt, disp, out, B, D, H, W, C,
                                      x0, t0, Wt, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
