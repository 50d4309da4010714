// The row-owner scheme shared by the two backward kernels that scatter
// along W (fused_cost_base_backward.cu, shift_1d.cu).
//
// Why: a gradient row's target pixels receive contributions only from the
// pairs (x, d) of the same row, d over the row's Dw hypotheses, but many
// pairs hit one target.  A float atomicAdd to global memory is paced by the
// L2's atomic units, and to shared memory it compiles, on sm_90a, to a
// compare-and-swap loop (LDS, ATOMS.CAST.SPIN, branch; cuobjdump -sass,
// nvcc 12.9).  So no thread here adds atomically: each word has one owner.
//
// Ownership: one block of one warp owns a slice of SLICE = 32 channels of
// one row, lane l channel 32 * slice + l.  It keeps the row's f32 gradient
// [W + 1][32] in dynamic shared memory (the last row takes the invalid
// taps), walks the row's Dw * W pairs in a fixed order (x-major), and each
// lane adds into its own column; the column is cast to the I/O type and
// stored once at the end.  The order of every sum is fixed: the results are
// deterministic.  A warp's lanes touch 32 consecutive words of one row: no
// bank conflicts.  32 channels per block is what balances the card: the
// accumulator takes W * 128 bytes per warp whatever the slicing, so shared
// memory holds 4-9 such warps per SM at W = 296-148, and slices of 32 give
// B * H * C / 32 blocks (640 and 1280 at the training shapes), all
// resident at once at W = 148 and 2.4 waves at W = 296.
//
// The walk goes in steps of PAIRS pairs, software-pipelined by one step:
//  - a ring of RING steps in shared memory is filled RING - 1 steps ahead
//    with cp.async: each pair's 32-channel slices of the output gradient and
//    of its two taps (an invalid tap is zero-filled);
//  - the producer stage reads a step from the ring pair-major, a pair's 16-
//    byte chunks on neighbouring lanes, and does the per-pair arithmetic
//    once per channel, with the pair's sum over the slice by a few shuffles;
//    it hands each pair's taps (and, for the cost base, its per-channel
//    gradients) to the owner stage through a stage in shared memory;
//  - the owner stage (lane = channel) adds the step into the accumulator,
//    2 pairs (4 taps) at a time: it reads the 4 words, adds in registers
//    what hits the row of an earlier tap, in order, and writes them back,
//    instead of a chain of read-modify-writes;
//  - step k's owner stage runs between step k + 1's producer loads and its
//    arithmetic, from the other half of a double-buffered stage.
//
// The per-pair gradient of the hypothesis (a sum over all C channels) is
// kept per pair in shared memory (over the row's staged sampling
// positions) and summed over the C / 32 slices through distributed shared
// memory: the slices of a row are one thread block cluster, and each block
// sums a share of the pairs over the cluster's blocks in rank order and
// stores it once.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "vec8.cuh"

namespace tsk {

constexpr int SLICE = 32;   // channels per block: one per lane of one warp
constexpr int PAIRS = 8;    // pairs per step of the walk
constexpr int RING = 4;     // steps staged in the ring

// cp.async of 16 (or 8) bytes from global to shared memory, in a group.
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}
// The same with the copy's source size: 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp16z(void* dst, const void* src, bool copy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(copy ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A chunk of 16 bytes of the I/O type from shared memory, as f32: 8 bf16 or
// 4 f32 channels.
template <typename T>
struct Chunk {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void load_chunk(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float v[8]) {
  load8<true>(p, v);
}

// A chunk's channels to shared memory in the I/O type, 16 bytes.
__device__ __forceinline__ void store_chunk(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p,
                                            const float v[8]) {
  store8<true>(p, v);
}

// The bilinear taps of position xs in a row of W: x0 = floor(xs), fraction
// fx, each tap's validity on its own (the gradient through floor is 0).
// i0 / i1 are the taps' rows of the accumulator, W (a trash row) for an
// invalid tap; s0 / s1 are rows to read the taps from, any valid pixel for
// an invalid tap.
struct Taps {
  float fx;
  int i0, i1, s0, s1;
  bool v0, v1;
};

__device__ __forceinline__ Taps taps(float xs, int W) {
  Taps t;
  const float x0f = floorf(xs);
  t.fx = xs - x0f;
  t.v0 = x0f >= 0.f && x0f <= (float)(W - 1);
  t.v1 = x0f >= -1.f && x0f <= (float)(W - 2);
  const int x0 = (int)fminf(fmaxf(x0f, -1.f), (float)W);
  t.i0 = t.v0 ? x0 : W;
  t.i1 = t.v1 ? x0 + 1 : W;
  t.s0 = t.v0 ? x0 : 0;
  t.s1 = t.v1 ? x0 + 1 : 0;
  return t;
}

// A pair past the end of the row (the walk's last step is padded to PAIRS
// pairs) samples at -2: both taps invalid, to the trash row.
constexpr float NO_PAIR = -2.f;

// The number of pairs padded to whole steps, and one step more (the walk
// produces one step past the end).
__host__ __device__ __forceinline__ int padded(int n) {
  return (n + PAIRS - 1) / PAIRS * PAIRS + PAIRS;
}

// Pair p = x * Dw + d of the walk -> x (exact for p < 2^22).
__device__ __forceinline__ int pair_x(int p, float inv_dw) {
  return __float2int_rd(((float)p + 0.5f) * inv_dw);
}

// The row of tap i in the accumulator, as a byte offset from a lane's
// column.
__device__ __forceinline__ int row_offset(int i) { return i * SLICE * 4; }

// col[off[k]] += c[k] for the N taps in order (col = this lane's column,
// off in bytes), as N reads, then sums kept in registers (a tap that hits
// the row of an earlier one adds that one's contribution first, in order),
// then N writes: the same result as N read-modify-writes one after the
// other, without their chain of latency.
template <int N>
__device__ __forceinline__ void add_taps(char* col, const int off[N],
                                         const float c[N]) {
  float v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = *reinterpret_cast<float*>(col + off[k]);
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int m = 0; m < k; ++m)
      if (off[m] == off[k]) v[k] += c[m];
    v[k] += c[k];
  }
#pragma unroll
  for (int k = 0; k < N; ++k) *reinterpret_cast<float*>(col + off[k]) = v[k];
}

// A step's PAIRS pairs' taps into this lane's column, 2 pairs (4 taps) at a
// time.
__device__ __forceinline__ void add_step_taps(char* col, const int o0[PAIRS],
                                              const int o1[PAIRS],
                                              const float c0[PAIRS],
                                              const float c1[PAIRS]) {
#pragma unroll
  for (int q = 0; q < PAIRS; q += 2) {
    const int off[4] = {o0[q], o1[q], o0[q + 1], o1[q + 1]};
    const float c[4] = {c0[q], c1[q], c0[q + 1], c1[q + 1]};
    add_taps<4>(col, off, c);
  }
}

// What the producer stage of a step hands the owner stage, per pair: the
// fraction and the byte offsets of its taps' accumulator rows, in one
// 16-byte word (fx, off0, off1, -).
struct Stage {
  float4 tap[PAIRS];
};

__device__ __forceinline__ float4 stage_tap(const Taps& t) {
  return make_float4(t.fx, __int_as_float(row_offset(t.i0)),
                     __int_as_float(row_offset(t.i1)), 0.f);
}

// A store to global memory under a predicate, without a branch.
__device__ __forceinline__ void store_if(float* p, float v, bool on) {
  asm volatile("{.reg .pred q; setp.ne.u32 q, %2, 0; @q st.global.f32 [%0], %1;}"
               ::"l"(p), "f"(v), "r"((unsigned)on));
}
__device__ __forceinline__ void store_if(__nv_bfloat16* p, float v, bool on) {
  const unsigned short b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  asm volatile("{.reg .pred q; setp.ne.u32 q, %2, 0; @q st.global.b16 [%0], %1;}"
               ::"l"(p), "h"(b), "r"((unsigned)on));
}

// Stage the row's sampling positions: pd[x * Dw + d] = x + sign * src[d *
// HW + x] (src at the row's pair (0, 0)), and zero this lane's accumulator
// column (W + 1 rows: the last one takes the invalid taps).
__device__ __forceinline__ void begin_row(float* acc, float* pd,
                                          const float* src, float sign,
                                          int Dw, int W, long long HW,
                                          int lane) {
  for (int d = 0; d < Dw; ++d) {
#pragma unroll 4
    for (int x = lane; x < W; x += SLICE)
      pd[x * Dw + d] = (float)x + sign * src[d * HW + x];
  }
  for (int p = Dw * W + lane; p < padded(Dw * W); p += SLICE)
    pd[p] = NO_PAIR;
  for (int x = 0; x <= W; ++x) acc[x * SLICE + lane] = 0.f;
  __syncwarp();
}

// The walk over n pairs, software-pipelined by one step: fill(p0, slot)
// stages the pairs p0.. of a step into a ring slot of PAIRS * PER elements
// (RING - 1 steps ahead); load(p0, slot) reads a step's inputs from its
// slot into registers; own(p0, slot, half) adds the step whose producer
// output is in stage half `half` into the accumulator; produce(p0, half)
// computes the loaded step into stage half `half`; keep(p0) stores the
// produced step's per-pair sums.  Step k's owner stage runs between step
// k + 1's loads and its math, so that neither waits for the other.  The
// walk produces one step past the end (padded pairs, to the trash row).
template <typename T, int PER, typename Fill, typename Load, typename Own,
          typename Produce, typename Keep>
__device__ __forceinline__ void walk(int n, T* ring, Fill fill, Load load,
                                     Own own, Produce produce, Keep keep) {
  const int steps = (n + PAIRS - 1) / PAIRS;
  auto slot = [&](int k) { return ring + (k % RING) * PAIRS * PER; };
  for (int k = 0; k < RING - 1; ++k) {
    if (k < steps) fill(k * PAIRS, slot(k));
    cp_commit();
  }
  cp_wait<RING - 2>();
  __syncwarp();
  load(0, slot(0));
  produce(0, 0);
  __syncwarp();
  keep(0);
  for (int k = 0; k < steps; ++k) {
    const int f = k + RING - 1;   // refills the slot step k - 1 used
    if (f < steps) fill(f * PAIRS, slot(f));
    cp_commit();
    cp_wait<RING - 2>();          // step k + 1 has landed
    __syncwarp();
    load((k + 1) * PAIRS, slot(k + 1));
    own(k * PAIRS, slot(k), k & 1);
    produce((k + 1) * PAIRS, (k + 1) & 1);
    __syncwarp();
    keep((k + 1) * PAIRS);
  }
}

// Shared memory: acc [W + 1][32] f32, the positions pd [padded(n)] f32,
// then (16-byte aligned) the ring of RING * PAIRS * per elements of the I/O
// type and the producer's stage, two halves of stage_bytes.  The wrapper's plan
// (kernels/launches.py:row_plan) sizes it.
__host__ __device__ __forceinline__ int ring_offset(int W, int n) {
  return (4 * SLICE * (W + 1) + 4 * padded(n) + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int stage_offset(int W, int n, int per,
                                                     int elem) {
  return ring_offset(W, n) + RING * PAIRS * per * elem;
}
__host__ __device__ __forceinline__ int shared_bytes(int W, int n, int per,
                                                     int elem,
                                                     int stage_bytes) {
  return stage_offset(W, n, per, elem) + 2 * stage_bytes;
}

// End of the walk: this lane's column to out_row[x * C + c] in T, then the
// pair sums over the cluster's slices, times sign, to
// out_pair[(p % Dw) * HW + p / Dw].
template <typename T>
__device__ __forceinline__ void end_row(const float* acc, float* pd,
                                        T* out_row, float* out_pair, float sign,
                                        int Dw, int W, int C, long long HW,
                                        int c, int lane) {
  namespace cg = cooperative_groups;
  if (c < C) {
#pragma unroll 8
    for (int x = 0; x < W; ++x) store1(out_row + (long long)x * C + c,
                                       acc[x * SLICE + lane]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n = Dw * W;
  for (int p = rank * SLICE + lane; p < n; p += S * SLICE) {
    float part[8];   // at most 8 slices: every remote read, then the sum
#pragma unroll
    for (int q = 0; q < 8; ++q)
      part[q] = q < S ? cluster.map_shared_rank(pd, q)[p] : 0.f;
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) t += part[q];
    out_pair[(p % Dw) * HW + p / Dw] = sign * t;
  }
  cluster.sync();   // no block leaves while another reads its pd
}

// One block of one warp per (row, slice), the slices of a row one cluster.
template <typename... P, typename... A>
cudaError_t launch_rows(void (*kernel)(P...), long long rows, int slices,
                        int smem, cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * slices));
  cfg.blockDim = dim3(SLICE);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace tsk
