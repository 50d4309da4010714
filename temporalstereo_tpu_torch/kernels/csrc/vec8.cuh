// Device helpers shared by the port's kernels: loads and stores of 8
// channels as 16-byte vectors (one for bf16, two for f32) with f32
// arithmetic, rounding to the I/O type, and a sum over the aligned lanes
// that hold one pixel's channel groups.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace tsk {

constexpr int GROUP = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float round_io(float v, float) { return v; }
__device__ __forceinline__ float round_io(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// VEC: p is 16-byte aligned; otherwise element by element.
template <bool VEC>
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  if (VEC) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = p[i];
  }
}

template <bool VEC>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  if (VEC) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  if (VEC) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = v[i];
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  if (VEC) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// Sum of v over each aligned segment of `seg` lanes (a power of two <= 32).
// Every lane of the warp must call it.
__device__ __forceinline__ float segment_sum(float v, int seg) {
  for (int off = seg >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace tsk
