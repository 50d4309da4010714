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
// Forward design: a block of 256 threads per (img row, slice of channels,
// block of hypotheses), from the wrapper's plan (kernels/launches.py:
// shift_forward_plan).  The block stages its row slice [Wt][Cs] with
// 16-byte cp.async and its hypotheses' shift rows in shared memory, then
// its threads, [256 / NV][NV] with NV = Cs / V (a pixel's slice is one row
// of threads), walk the (d, x) pixels two at a time: both taps from shared
// memory, one 16-byte streaming store (__stcs) per thread and pixel.  All
// indices are 32-bit and come from blockIdx and threadIdx; a broadcast row
// is staged once for a block of hypotheses.  C % 8 != 0 takes one channel a
// thread (V = 1).  The earlier design (a thread per 16-byte output, its
// flat index split by 64-bit divisions, both taps gathered from L2)
// reached 49% / 54% of the bound in bf16 at the training shapes; this one
// 83% / 79% (0.0199 / 0.0555 ms device, NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke.py phase 3).  The W-sharded stream's fine stage writes 7.5 MB
// and stays near half its bound: a fill of that output alone takes 0.0032
// ms against 0.0028 (scripts/port_shift_forward_sweep.py).  The TPU kernel
// builds a W x W one-hot interpolation matrix per row for the MXU; on this
// card the two taps are read from shared memory.
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

using tsk::PAIRS;
using tsk::SLICE;
using tsk::Stage;
using tsk::store1;
using tsk::Taps;
using tsk::to_f32;

// The forward's blocks: FWD_THREADS threads as [FWD_THREADS / NV][NV],
// NV = the slice's channels / V, so a pixel's slice is one row of threads.
constexpr int FWD_THREADS = 256;
constexpr int UNROLL = 2;            // pixels a thread has in flight

// V channels: a 16-byte chunk (8 bf16, 4 f32), or 1.
template <int V, typename T>
__device__ __forceinline__ void loadv(const T* p, float* v) {
  if constexpr (V > 1) tsk::load_chunk(p, v);
  else v[0] = to_f32(*p);
}

// The output is written once: streaming stores (evict-first in L1 and L2).
__device__ __forceinline__ void store_cs(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

template <int V, typename T>
__device__ __forceinline__ void storev(T* p, const float* v) {
  if constexpr (V > 1) store_cs(p, v);
  else store1(p, v[0]);
}

// Bytes of a staged img row slice, padded so that the shift rows after it
// stay 16-byte aligned.
__host__ __device__ __forceinline__ long long row_bytes(int Wt, int Cs,
                                                        int size) {
  return ((long long)Wt * Cs * size + 15) / 16 * 16;
}

// One pixel's V channels of one hypothesis, from the staged row: o = 0,
// o += (1-f) a0, o += f a1, each tap only where it lies in the row (the
// order and rounding of the earlier one-thread-per-output design, whose
// results this one reproduces bit for bit).
template <typename T, int V>
__device__ __forceinline__ void interpolate(const T* row, int Cs, float xs,
                                            float lo, float hi, int t0,
                                            float o[V]) {
  const float x0f = floorf(xs);
  const float fx = xs - x0f;
  const float x1f = x0f + 1.f;
  float a[V];
#pragma unroll
  for (int k = 0; k < V; ++k) o[k] = 0.f;
  if (x0f >= lo && x0f <= hi) {
    loadv<V>(row + ((int)x0f - t0) * Cs, a);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] += (1.f - fx) * a[k];
  }
  if (x1f >= lo && x1f <= hi) {
    loadv<V>(row + ((int)x1f - t0) * Cs, a);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] += fx * a[k];
  }
}

// (d, x) of a flat index d * W + x, carried forward without a division
// until it crosses a row.
__device__ __forceinline__ void wrap(int& x, int& d, int W) {
  if (x >= W) {
    const int k = x / W;
    d += k;
    x -= k * W;
  }
}

// One block per (img row, channel slice, block of hypotheses).  The img
// row's slice [Wt][Cs] and the block's shift rows [per][W] are staged in
// shared memory; then each thread walks pixels (d, x) of the block, UNROLL
// at a time, and writes its V channels of each.
template <typename T, int V>
__global__ void __launch_bounds__(FWD_THREADS)
shift_1d_forward_kernel(const T* __restrict__ img,
                        const float* __restrict__ shift, T* __restrict__ out,
                        int D, int Di, int H, int W, int C, int x0, int t0,
                        int Wt, int S, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cs = C / S;
  const int nb = Di == 1 ? (D + per - 1) / per : 1;
  const int q = blockIdx.x / nb, r = q / S;   // r: the img row (b, di, h)
  const int s = q - r * S;
  const int h = r % H, bd = r / H, b = bd / Di;
  const int d0 = Di == 1 ? (blockIdx.x - q * nb) * per : bd - b * Di;
  const int dn = Di == 1 ? min(per, D - d0) : 1;
  const int tx = threadIdx.x, ty = threadIdx.y, TY = blockDim.y;
  T* row = reinterpret_cast<T*>(smem);
  float* sh = reinterpret_cast<float*>(smem + row_bytes(Wt, Cs, sizeof(T)));

  const T* src = img + (long long)r * Wt * C + s * Cs + tx * V;
  for (int t = ty; t < Wt; t += TY) {
    if constexpr (V > 1) tsk::cp16(row + t * Cs + tx * V, src + t * C);
    else row[t * Cs + tx] = src[t * C];
  }
  tsk::cp_commit();
  const long long plane = (long long)H * W;
  const float* srow = shift + ((long long)b * D + d0) * plane
                      + (long long)h * W;
  const int threads = blockDim.x * TY;
  for (int d = 0; d < dn; ++d)
    for (int x = ty * blockDim.x + tx; x < W; x += threads)
      sh[d * W + x] = srow[d * plane + x];
  tsk::cp_wait<0>();
  __syncthreads();

  T* dst = out + (((long long)b * D + d0) * plane + (long long)h * W) * C
           + s * Cs + tx * V;
  const T* tap = row + tx * V;
  const float lo = (float)t0, hi = (float)(t0 + Wt - 1);
  const long long dstride = plane * C;
  int x[UNROLL], d[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    x[u] = ty + u * TY;
    d[u] = 0;
    wrap(x[u], d[u], W);
  }
  while (d[0] < dn) {
    float o[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (d[u] < dn)
        interpolate<T, V>(tap, Cs, (float)(x0 + x[u]) + sh[d[u] * W + x[u]],
                          lo, hi, t0, o[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (d[u] < dn) storev<V>(dst + d[u] * dstride + x[u] * C, o[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x[u] += UNROLL * TY;
      wrap(x[u], d[u], W);
    }
  }
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

template <typename T>
cudaError_t forward(const void* img, const void* shift, void* out, int B,
                    int D, int Di, int H, int W, int C, int x0, int t0,
                    int Wt, int slices, int per, int smem,
                    cudaStream_t stream) {
  if ((long long)B * D * H * W * C == 0) return cudaSuccess;
  const int V = C % tsk::GROUP == 0 ? tsk::Chunk<T>::N : 1;
  const int Dh = Di == 1 ? D : 1;
  // (more shared memory than a block may have: cudaFuncSetAttribute below
  // returns cudaErrorInvalidValue)
  if (slices < 1 || C % slices != 0 || (C / slices) % V != 0 ||
      C / slices / V > FWD_THREADS || per < 1 || per > Dh ||
      smem < row_bytes(Wt, C / slices, sizeof(T)) + 4LL * per * W)
    return cudaErrorInvalidValue;
  const long long blocks =
      (long long)B * Di * H * slices * ((Dh + per - 1) / per);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int nv = C / slices / V;
  const dim3 block(nv, FWD_THREADS / nv);
  auto kernel = V == 1 ? shift_1d_forward_kernel<T, 1>
                       : shift_1d_forward_kernel<T, tsk::Chunk<T>::N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, block, smem, stream>>>(
      (const T*)img, (const float*)shift, (T*)out, D, Di, H, W, C, x0, t0, Wt,
      slices, per);
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
// column t0.  The launch plan (kernels/launches.py:shift_forward_plan):
// C / slices channels per block, per hypotheses per block of a broadcast
// img (1 otherwise), smem bytes of shared memory; a plan that does not
// cover the shape or does not fit returns cudaErrorInvalidValue.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int shift_1d_forward(const void* img, const void* shift, void* out,
                                int B, int D, int Di, int H, int W, int C,
                                int x0, int t0, int Wt, int slices, int per,
                                int smem, int dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)forward<float>(img, shift, out, B, D, Di, H, W, C, x0, t0, Wt,
                               slices, per, smem, s);
  if (dtype == 1)
    return (int)forward<__nv_bfloat16>(img, shift, out, B, D, Di, H, W, C, x0,
                                       t0, Wt, slices, per, smem, s);
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
