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
// The forward takes column offsets (the W-sharded forward,
// parallel/spatial.py): out's column x is the frame's column x0 + x, and img
// [B,Di,H,Wt,C] holds the frame's columns [t0, t0 + Wt); a tap outside them
// contributes 0.  x0 = t0 = 0 with Wt = W is the unsharded call.
// Backward, for the output's gradient g:
//   grad_img[.., x0, c]   += (1-f) * g    (tap valid)
//   grad_img[.., x0+1, c] +=  f    * g    (tap valid)
//   grad_shift = sum_c g * (v1 * img[x0+1, c] - v0 * img[x0, c])
// the gradient through floor being 0 and through the fraction 1, with each
// tap's validity v0 / v1 taken on its own, also at integer positions.  A
// broadcast img (Di = 1) sums its gradient over the D hypotheses.
//
// What bounds them on an H100: bytes.  A few flops per element.  At the
// training shapes of the BLOCK_COST_SCALE 0 variant (img [4,1,H,W,128]
// bf16, D=8 at 40x148 and D=5 at 80x296) the forward moves 55.3 / 147.4 MB
// (17 / 44 us at 3.35 TB/s), dominated by the [B,D,H,W,C] output; the
// backward reads g and img and writes grad_img (in img's type) and
// grad_shift: 62.1 / 173.5 MB (19 / 52 us).
//
// Forward design: one thread per (b, d, h, x, group of 8 channels), the
// group index fastest, so a pixel's 16 threads (C = 128) issue contiguous
// 16-byte loads and stores; C % 8 != 0 takes one channel per thread.  The
// TPU kernel builds a W x W one-hot interpolation matrix per row for the
// MXU; on this card a 2-tap gather from L1/L2 is cheaper.  The img rows are
// re-read for every hypothesis and stay in L2.
//
// Backward design (row_owner.cuh): the img gradient is a scatter along W.
// A float atomicAdd to shared memory is a compare-and-swap loop on sm_90a,
// so one warp owns 32 channels of one gradient row, (b, h) for a broadcast
// img with its D * W pairs, (b, d, h) otherwise with W: each lane adds into
// its own column of the row's f32 gradient in shared memory, in a fixed
// order and without atomics, and stores it once in img's type.  The
// producer stage sums g (t1 - t0) of each pair over the slice; grad_shift
// is summed over the C / 32 slices (one cluster) through distributed shared
// memory and stored once.  The backward is deterministic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "row_owner.cuh"
#include "vec8.cuh"

namespace {

using tsk::loadv;
using tsk::PAIRS;
using tsk::SLICE;
using tsk::Stage;
using tsk::store1;
using tsk::storev;
using tsk::Taps;
using tsk::to_f32;

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
                        int B, int D, int Di, int H, int W, int C, int x0,
                        int t0, int Wt) {
  const int NV = C / V;
  const long long total = (long long)B * D * H * W * NV;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const Pixel p = split(i, NV, W, H, D);
  const long long pix = (((long long)p.b * D + p.d) * H + p.h) * W + p.x;
  const long long row =
      (((long long)p.b * Di + (Di == 1 ? 0 : p.d)) * H + p.h) * Wt;
  const float xs = (float)(x0 + p.x) + shift[pix];
  const float x0f = floorf(xs);
  const float fx = xs - x0f;
  const float x1f = x0f + 1.f;
  const float lo = (float)t0, hi = (float)(t0 + Wt - 1);

  float o[V], a[V];
#pragma unroll
  for (int k = 0; k < V; ++k) o[k] = 0.f;
  if (x0f >= lo && x0f <= hi) {
    loadv<V>(img + (row + (int)x0f - t0) * C + p.cv * V, a);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] += (1.f - fx) * a[k];
  }
  if (x1f >= lo && x1f <= hi) {
    loadv<V>(img + (row + (int)x1f - t0) * C + p.cv * V, a);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] += fx * a[k];
  }
  storev<V>(out + pix * C + p.cv * V, o);
}

// A pair's ring entry: g, img tap 0, img tap 1 (32 each).
constexpr int PER = 3 * SLICE;
// The producer's stage: the taps.
constexpr int STAGE_BYTES = sizeof(Stage);

// One block (one warp) per (gradient row, slice of 32 channels); a row's
// slices are one cluster.  The gradient rows are img's rows: (b, h) with
// the D hypotheses as pairs when Di = 1, else (b, d, h).  ASYNC: C % 32 ==
// 0, so rows are 16-byte aligned and the ring fills with cp.async.
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(SLICE)
shift_1d_backward_kernel(const T* __restrict__ g, const T* __restrict__ img,
                         const float* __restrict__ shift,
                         T* __restrict__ grad_img,
                         float* __restrict__ grad_shift, int D, int Di, int H,
                         int W, int C, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dw = Di == 1 ? D : 1;
  const int n = Dw * W;
  float* acc = reinterpret_cast<float*>(smem);
  char* col = reinterpret_cast<char*>(acc + threadIdx.x);   // lane's column
  float* pd = acc + SLICE * (W + 1);
  T* ring = reinterpret_cast<T*>(smem + tsk::ring_offset(W, n));
  const int lane = threadIdx.x;
  const long long row_id = blockIdx.x / S;     // a row of img: (b, di, h)
  const int c0 = (int)(blockIdx.x % S) * SLICE;
  const int c = c0 + lane;
  const bool on = c < C;
  const long long HW = (long long)H * W;
  // pixel (b, d0, h, 0) of [B,D,H,W]: d0 = 0 for a broadcast img
  const long long pix0 = Di == 1
      ? ((row_id / H) * D * H + row_id % H) * W : row_id * W;
  const T* g_row = g + pix0 * C;
  const T* img_row = img + row_id * W * C;
  const float inv_d = 1.f / (float)Dw;

  auto fill = [&](int p0, T* slot) {
    if constexpr (ASYNC) {
      constexpr int VEC = 16 / sizeof(T);        // elements per chunk
      constexpr int CH = SLICE / VEC;            // chunks per 32 channels
#pragma unroll
      for (int r = 0; r < (PAIRS * CH + SLICE - 1) / SLICE; ++r) {
        const int k = r * (SLICE / CH) + lane / CH, e = lane % CH * VEC;
        const int p = p0 + k;
        if (k < PAIRS && p < n) {
          const int x = tsk::pair_x(p, inv_d), d = p - x * Dw;
          const Taps tp = tsk::taps(pd[p], W);
          T* q = slot + k * PER + e;
          tsk::cp16(q, g_row + (d * HW + x) * C + c0 + e);
          tsk::cp16z(q + SLICE, img_row + (long long)tp.s0 * C + c0 + e,
                     tp.v0);
          tsk::cp16z(q + 2 * SLICE, img_row + (long long)tp.s1 * C + c0 + e,
                     tp.v1);
        }
      }
    } else {   // lanes past C and invalid taps stage zeros
      const int cc = on ? c : C - 1;
      for (int k = 0; k < PAIRS && p0 + k < n; ++k) {
        const int p = p0 + k, x = tsk::pair_x(p, inv_d), d = p - x * Dw;
        const Taps tp = tsk::taps(pd[p], W);
        T* q = slot + k * PER;
        store1(q + lane, on ? to_f32(g_row[(d * HW + x) * C + cc]) : 0.f);
        store1(q + SLICE + lane,
               on && tp.v0 ? to_f32(img_row[(long long)tp.s0 * C + cc]) : 0.f);
        store1(q + 2 * SLICE + lane,
               on && tp.v1 ? to_f32(img_row[(long long)tp.s1 * C + cc]) : 0.f);
      }
    }
  };

  // The producer stage: 16-byte chunks of 8 (bf16) or 4 (f32) channels, a
  // pair's CH lanes side by side, PW pairs per round; it puts the pair's
  // taps into a stage half and its sum of g (t1 - t0) over the slice into
  // pd.  The owner stage (lane = channel) adds g into the accumulator; a
  // pair past the end (p >= n) has both taps on the trash row.
  constexpr int VEC = tsk::Chunk<T>::N, CH = SLICE / VEC, PW = SLICE / CH;
  constexpr int ROUNDS = PAIRS / PW;
  char* stages = reinterpret_cast<char*>(smem) +
                 tsk::stage_offset(W, n, PER, sizeof(T));
  auto stage = [&](int half) {
    return reinterpret_cast<Stage*>(stages + half * STAGE_BYTES);
  };
  Taps tp[ROUNDS];
  float gv[ROUNDS][VEC], t0[ROUNDS][VEC], t1[ROUNDS][VEC], sp[ROUNDS];
  auto load = [&](int p0, const T* slot) {
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int k = r * PW + lane / CH, e = lane % CH * VEC;
      tp[r] = tsk::taps(pd[p0 + k], W);
      const T* q = slot + k * PER + e;
      tsk::load_chunk(q, gv[r]);
      tsk::load_chunk(q + SLICE, t0[r]);   // an invalid tap: zeros
      tsk::load_chunk(q + 2 * SLICE, t1[r]);
    }
  };
  auto produce = [&](int p0, int half) {
    Stage* st = stage(half);
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int k = r * PW + lane / CH, e = lane % CH * VEC;
      float sk = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sk -= gv[r][j] * t0[r][j];
        sk += gv[r][j] * t1[r][j];
      }
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
  auto own = [&](int p0, const T* slot, int half) {
    const Stage* st = stage(half);
    float a0[PAIRS], a1[PAIRS];
    int o0[PAIRS], o1[PAIRS];
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const float4 t = st->tap[k];
      const float fx = t.x;
      o0[k] = __float_as_int(t.y);
      o1[k] = __float_as_int(t.z);
      const float g = to_f32(slot[k * PER + lane]);
      a0[k] = (1.f - fx) * g;
      a1[k] = fx * g;
    }
    tsk::add_step_taps(col, o0, o1, a0, a1);
  };

  tsk::begin_row(acc, pd, shift + pix0, 1.f, Dw, W, HW, lane);
  tsk::walk<T, PER>(n, ring, fill, load, own, produce, keep);
  tsk::end_row(acc, pd, grad_img + row_id * W * C, grad_shift + pix0, 1.f,
               Dw, W, C, HW, c, lane);
}

constexpr int THREADS = 256;

unsigned blocks_for(long long total) {
  return (unsigned)((total + THREADS - 1) / THREADS);
}

template <typename T>
cudaError_t forward(const void* img, const void* shift, void* out, int B,
                    int D, int Di, int H, int W, int C, int x0, int t0,
                    int Wt, cudaStream_t stream) {
  const int V = C % tsk::GROUP == 0 ? tsk::GROUP : 1;
  const long long total = (long long)B * D * H * W * (C / V);
  if (total == 0) return cudaSuccess;
  if (V == tsk::GROUP)
    shift_1d_forward_kernel<T, 8><<<blocks_for(total), THREADS, 0, stream>>>(
        (const T*)img, (const float*)shift, (T*)out, B, D, Di, H, W, C, x0,
        t0, Wt);
  else
    shift_1d_forward_kernel<T, 1><<<blocks_for(total), THREADS, 0, stream>>>(
        (const T*)img, (const float*)shift, (T*)out, B, D, Di, H, W, C, x0,
        t0, Wt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* g, const void* img, const void* shift,
                     void* grad_img, void* grad_shift, int B, int D, int Di,
                     int H, int W, int C, int slices, int smem,
                     cudaStream_t stream) {
  if ((long long)B * D * H * W * C == 0) return cudaSuccess;
  if (slices > 8 || slices * SLICE < C || (slices - 1) * SLICE >= C ||
      smem < tsk::shared_bytes(W, (Di == 1 ? D : 1) * W, PER, sizeof(T),
                               STAGE_BYTES))
    return cudaErrorInvalidValue;
  auto kernel = C % SLICE == 0 ? shift_1d_backward_kernel<T, true>
                               : shift_1d_backward_kernel<T, false>;
  return tsk::launch_rows(kernel, (long long)B * Di * H,
                          slices, smem, stream, (const T*)g, (const T*)img,
                          (const float*)shift, (T*)grad_img,
                          (float*)grad_shift, D, Di, H, W, C, slices);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (img and out); shift is float32.
// shift and out are [B,D,H,W] at the frame's column x0, img [B,Di,H,Wt,C] at
// column t0.  Returns the cudaError_t of the launch (0 on success).
extern "C" int shift_1d_forward(const void* img, const void* shift, void* out,
                                int B, int D, int Di, int H, int W, int C,
                                int x0, int t0, int Wt, int dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)forward<float>(img, shift, out, B, D, Di, H, W, C, x0, t0, Wt,
                               s);
  if (dtype == 1)
    return (int)forward<__nv_bfloat16>(img, shift, out, B, D, Di, H, W, C, x0,
                                       t0, Wt, s);
  return (int)cudaErrorInvalidValue;
}

// g, img and grad_img (img's shape) in the I/O type; shift and grad_shift
// ([B,D,H,W]) float32.  Every output element is written exactly once.
// slices = ceil(C / 32) and smem = 4 * (32 W + Dw W) bytes (Dw = D for a
// broadcast img, else 1) come from the wrapper's plan
// (kernels/launches.py:row_plan).
extern "C" int shift_1d_backward(const void* g, const void* img,
                                 const void* shift, void* grad_img,
                                 void* grad_shift, int B, int D, int Di,
                                 int H, int W, int C, int slices, int smem,
                                 int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)backward<float>(g, img, shift, grad_img, grad_shift, B, D, Di,
                                H, W, C, slices, smem, s);
  if (dtype == 1)
    return (int)backward<__nv_bfloat16>(g, img, shift, grad_img, grad_shift,
                                        B, D, Di, H, W, C, slices, smem, s);
  return (int)cudaErrorInvalidValue;
}
