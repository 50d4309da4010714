// Bilinear forward splat (summation mode) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// temporalstereo_tpu/ops/pallas/splat.py:summation_splat_pallas (_kernel).
// For values [B,H,W,C] and flow [B,H,W,2] = (fx, fy) in pixels (both f32),
// every source pixel (x, y) adds its C values, weighted bilinearly, to the
// four target pixels around (x + fx, y + fy).  Each tap is bounds-checked on
// its own, in f32, before the coordinate becomes an index, so a NaN or huge
// flow drops the tap instead of wrapping.  The output must be zeroed by the
// caller.
//
// What bounds it on an H100: launch latency.  On the temporal update the
// inputs are tiny (48x156 pixels, C=8 in f32: 0.24 MB in, 0.06 MB of flow,
// 0.24 MB out, ~0.16 us at 3.35 TB/s), far below what a launch costs.
//
// Design: one thread per source pixel, looping over C and doing four
// atomicAdds per channel into the zeroed f32 output, as the reference's CuPy
// kernel does.  The TPU kernel's one-hot row/column matmuls exist only
// because a TPU has no fast scatter; on this card the scatter is the cheap
// form.  atomicAdd makes the summation order, and so the last bits of a
// target that several sources hit, vary from run to run: the JAX reference
// is bit-deterministic, this kernel is not (the tolerance that follows is
// stated where the kernel is compared with its plain version).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void splat_tap(float* __restrict__ out,
                                          const float* __restrict__ v,
                                          float tx, float ty, float wgt,
                                          int b, int H, int W, int C) {
  if (!(tx >= 0.f && tx <= (float)(W - 1) && ty >= 0.f &&
        ty <= (float)(H - 1)))
    return;
  float* o = out + (((long long)b * H + (int)ty) * W + (int)tx) * C;
  for (int c = 0; c < C; ++c) atomicAdd(o + c, v[c] * wgt);
}

__global__ void __launch_bounds__(256)
summation_splat_kernel(const float* __restrict__ values,
                       const float* __restrict__ flow,
                       float* __restrict__ out, int B, int H, int W, int C) {
  const long long total = (long long)B * H * W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int b = (int)(i / ((long long)H * W));

  const float xs = (float)x + flow[2 * i];
  const float ys = (float)y + flow[2 * i + 1];
  const float x0 = floorf(xs);
  const float y0 = floorf(ys);
  const float fx = xs - x0;
  const float fy = ys - y0;
  const float* v = values + i * C;
  splat_tap(out, v, x0, y0, (1.f - fx) * (1.f - fy), b, H, W, C);
  splat_tap(out, v, x0 + 1.f, y0, fx * (1.f - fy), b, H, W, C);
  splat_tap(out, v, x0, y0 + 1.f, (1.f - fx) * fy, b, H, W, C);
  splat_tap(out, v, x0 + 1.f, y0 + 1.f, fx * fy, b, H, W, C);
}

}  // namespace

// values/out [B,H,W,C] f32, flow [B,H,W,2] f32, out zeroed by the caller.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int summation_splat(const void* values, const void* flow,
                               void* out, int B, int H, int W, int C,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  summation_splat_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)values, (const float*)flow, (float*)out, B, H, W, C);
  return (int)cudaGetLastError();
}
