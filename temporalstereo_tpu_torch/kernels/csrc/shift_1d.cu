// W-axis bilinear shift of a cost volume, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// temporalstereo_tpu/ops/pallas/shift.py:shift_1d_pallas (_kernel, and its
// custom_vjp backward, autodiff of ops/warp.py:shift_1d).  For img
// [B,Di,H,W,C] with Di = 1 (broadcast over the D hypotheses, read in place)
// or Di = D, and shift [B,D,H,W] (f32):
//   out[b,d,h,x,c] = (1-f) * img[b,d,h,x0,c] + f * img[b,d,h,x0+1,c]
//   x0 = floor(x + shift), f = x + shift - x0, in f32; an out-of-range tap
//   contributes 0.
// The taps are weighted in f32 and the sum is rounded once to the I/O type
// (the JAX formulation rounds the weights to the I/O type first; in f32 the
// two are the same).
// Backward, for the output's gradient g:
//   grad_img[.., x0, c]   += (1-f) * g    (tap valid)
//   grad_img[.., x0+1, c] +=  f    * g    (tap valid)
//   grad_shift = sum_c g * (v1 * img[x0+1, c] - v0 * img[x0, c])
// the gradient through floor being 0 and through the fraction 1, with each
// tap's validity v0 / v1 taken on its own, also at integer positions.
// grad_img accumulates with atomicAdd into a zeroed f32 buffer of img's shape
// (so a broadcast img sums over D in place); grad_shift is summed over a
// pixel's channel groups with warp shuffles and stored once.
//
// What bounds them on an H100: bytes.  A few flops per element.  At the
// training shapes of the BLOCK_COST_SCALE 0 variant (img [4,1,H,W,128]
// bf16, D=8 at 40x148 and D=5 at 80x296) the forward moves ~55 / ~147 MB
// (~16 / ~44 us at 3.35 TB/s), dominated by the [B,D,H,W,C] output; the
// backward reads g and img and writes the f32 img gradient and the shift
// gradient (~68 / ~197 MB).
//
// Design: one thread per (b, d, h, x, group of 8 channels), the group index
// fastest, so a pixel's 16 threads (C = 128) issue contiguous 16-byte loads
// and stores; C % 8 != 0 takes one channel per thread.  The TPU kernel builds
// a W x W one-hot interpolation matrix per row for the MXU; on this card a
// 2-tap gather from L1/L2 is cheaper.  The img rows are re-read for every
// hypothesis and stay in L2.  The atomics make the last bits of grad_img
// vary from run to run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "vec8.cuh"

namespace {

using tsk::loadv;
using tsk::pow2_le_32;
using tsk::segment_sum;
using tsk::storev;

struct Pixel {
  int cv, x, h, d, b;
};

__device__ __forceinline__ Pixel split(long long i, int NV, int W, int H,
                                       int D) {
  Pixel p;
  p.cv = (int)(i % NV);
  long long t = i / NV;
  p.x = (int)(t % W); t /= W;
  p.h = (int)(t % H); t /= H;
  p.d = (int)(t % D);
  p.b = (int)(t / D);
  return p;
}

template <typename T, int V>
__global__ void __launch_bounds__(256)
shift_1d_forward_kernel(const T* __restrict__ img,
                        const float* __restrict__ shift, T* __restrict__ out,
                        int B, int D, int Di, int H, int W, int C) {
  const int NV = C / V;
  const long long total = (long long)B * D * H * W * NV;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const Pixel p = split(i, NV, W, H, D);
  const long long pix = (((long long)p.b * D + p.d) * H + p.h) * W + p.x;
  const long long row =
      (((long long)p.b * Di + (Di == 1 ? 0 : p.d)) * H + p.h) * W;
  const float xs = (float)p.x + shift[pix];
  const float x0f = floorf(xs);
  const float fx = xs - x0f;
  const float x1f = x0f + 1.f;

  float o[V], a[V];
#pragma unroll
  for (int k = 0; k < V; ++k) o[k] = 0.f;
  if (x0f >= 0.f && x0f <= (float)(W - 1)) {
    loadv<V>(img + (row + (int)x0f) * C + p.cv * V, a);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] += (1.f - fx) * a[k];
  }
  if (x1f >= 0.f && x1f <= (float)(W - 1)) {
    loadv<V>(img + (row + (int)x1f) * C + p.cv * V, a);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] += fx * a[k];
  }
  storev<V>(out + pix * C + p.cv * V, o);
}

// SEG: the NV threads of a pixel form an aligned power-of-two segment of a
// warp, so grad_shift is reduced with shuffles and stored once; otherwise
// every thread adds its part with atomicAdd.  No thread returns early: all
// lanes take part in the shuffles, and lanes past the end write nothing.
template <typename T, int V, bool SEG>
__global__ void __launch_bounds__(256)
shift_1d_backward_kernel(const T* __restrict__ g, const T* __restrict__ img,
                         const float* __restrict__ shift,
                         float* __restrict__ grad_img,
                         float* __restrict__ grad_shift, int B, int D, int Di,
                         int H, int W, int C) {
  const int NV = C / V;
  const long long total = (long long)B * D * H * W * NV;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < total;
  const Pixel p = split(active ? i : total - 1, NV, W, H, D);
  const long long pix = (((long long)p.b * D + p.d) * H + p.h) * W + p.x;
  const long long row =
      (((long long)p.b * Di + (Di == 1 ? 0 : p.d)) * H + p.h) * W;
  const float xs = (float)p.x + shift[pix];
  const float x0f = floorf(xs);
  const float fx = xs - x0f;
  const float x1f = x0f + 1.f;

  float s = 0.f;
  if (active) {
    float gv[V], a[V];
    loadv<V>(g + pix * C + p.cv * V, gv);
    if (x0f >= 0.f && x0f <= (float)(W - 1)) {
      const long long at = (row + (int)x0f) * C + p.cv * V;
      loadv<V>(img + at, a);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        atomicAdd(grad_img + at + k, (1.f - fx) * gv[k]);
        s -= gv[k] * a[k];
      }
    }
    if (x1f >= 0.f && x1f <= (float)(W - 1)) {
      const long long at = (row + (int)x1f) * C + p.cv * V;
      loadv<V>(img + at, a);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        atomicAdd(grad_img + at + k, fx * gv[k]);
        s += gv[k] * a[k];
      }
    }
  }
  if (SEG) {
    s = segment_sum(s, NV);
    if (active && p.cv == 0) grad_shift[pix] = s;
  } else if (active) {
    atomicAdd(grad_shift + pix, s);
  }
}

constexpr int THREADS = 256;

unsigned blocks_for(long long total) {
  return (unsigned)((total + THREADS - 1) / THREADS);
}

template <typename T>
cudaError_t forward(const void* img, const void* shift, void* out, int B,
                    int D, int Di, int H, int W, int C, cudaStream_t stream) {
  const int V = C % tsk::GROUP == 0 ? tsk::GROUP : 1;
  const long long total = (long long)B * D * H * W * (C / V);
  if (total == 0) return cudaSuccess;
  if (V == tsk::GROUP)
    shift_1d_forward_kernel<T, 8><<<blocks_for(total), THREADS, 0, stream>>>(
        (const T*)img, (const float*)shift, (T*)out, B, D, Di, H, W, C);
  else
    shift_1d_forward_kernel<T, 1><<<blocks_for(total), THREADS, 0, stream>>>(
        (const T*)img, (const float*)shift, (T*)out, B, D, Di, H, W, C);
  return cudaGetLastError();
}

template <typename T, int V>
void backward_v(const void* g, const void* img, const void* shift,
                void* grad_img, void* grad_shift, int B, int D, int Di, int H,
                int W, int C, cudaStream_t stream) {
  const long long total = (long long)B * D * H * W * (C / V);
  if (pow2_le_32(C / V))
    shift_1d_backward_kernel<T, V, true>
        <<<blocks_for(total), THREADS, 0, stream>>>(
            (const T*)g, (const T*)img, (const float*)shift,
            (float*)grad_img, (float*)grad_shift, B, D, Di, H, W, C);
  else
    shift_1d_backward_kernel<T, V, false>
        <<<blocks_for(total), THREADS, 0, stream>>>(
            (const T*)g, (const T*)img, (const float*)shift,
            (float*)grad_img, (float*)grad_shift, B, D, Di, H, W, C);
}

template <typename T>
cudaError_t backward(const void* g, const void* img, const void* shift,
                     void* grad_img, void* grad_shift, int B, int D, int Di,
                     int H, int W, int C, cudaStream_t stream) {
  if ((long long)B * D * H * W * C == 0) return cudaSuccess;
  if (C % tsk::GROUP == 0)
    backward_v<T, 8>(g, img, shift, grad_img, grad_shift, B, D, Di, H, W, C,
                     stream);
  else
    backward_v<T, 1>(g, img, shift, grad_img, grad_shift, B, D, Di, H, W, C,
                     stream);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (img and out); shift is float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int shift_1d_forward(const void* img, const void* shift, void* out,
                                int B, int D, int Di, int H, int W, int C,
                                int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)forward<float>(img, shift, out, B, D, Di, H, W, C, s);
  if (dtype == 1)
    return (int)forward<__nv_bfloat16>(img, shift, out, B, D, Di, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

// g and img in the I/O type; grad_img (img's shape) and grad_shift
// ([B,D,H,W]) are float32 and must be zeroed by the caller.
extern "C" int shift_1d_backward(const void* g, const void* img,
                                 const void* shift, void* grad_img,
                                 void* grad_shift, int B, int D, int Di,
                                 int H, int W, int C, int dtype, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)backward<float>(g, img, shift, grad_img, grad_shift, B, D, Di,
                                H, W, C, s);
  if (dtype == 1)
    return (int)backward<__nv_bfloat16>(g, img, shift, grad_img, grad_shift,
                                        B, D, Di, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
