"""Latency of the memory and barrier operations a splat kernel is built
from, on one CUDA card.

    python3 scripts/port_latency_probe.py

Builds a small probe kernel (into kernels/_build/probe/) and runs it as one
cluster of 8 blocks.  Thread 0 of each block, or every thread, walks a
dependent chain of 256 steps through each of: its own shared memory; the
shared memory of the next block of the cluster (distributed shared memory);
an integer atomicAdd with return on that memory and on its own; a 1 MB
array in device memory (resident in L2) with ld.global.cg and with a
default load; and times 64 cluster barriers, __syncthreads and
__threadfence.  Prints the card's name and power limit, then per setting
(one thread or all of 512 / 1024 threads) the SM cycles per step of each
block.  These are why csrc/softsplat.cu keeps its work in each block's own
shared memory.  Needs one CUDA card and nvcc.
"""
import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from temporalstereo_tpu_torch.kernels import build  # noqa: E402

NAMES = ("local", "dsmem", "dsmem_atomic", "smem_atomic", "global_cg",
         "global", "cluster_sync", "syncthreads", "threadfence")
SOURCE = r"""#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
// out[r*16 + k]: cycles per step of test k, measured by CTA r thread 0 (or all threads: max)
__global__ void micro(int* gbuf, int gmask, long long* out, int all) {
  cg::cluster_group cl = cg::this_cluster();
  int rank = cl.block_rank();
  extern __shared__ int sm[];
  const int N = 4096;
  for (int i = threadIdx.x; i < N; i += blockDim.x) sm[i] = (i * 97 + 13) & (N - 1);
  cl.sync();
  const int STEPS = 256;
  bool me = all || threadIdx.x == 0;
  long long t0, t1; int p;
  // 0 local chase
  p = threadIdx.x & (N-1);
  t0 = clock64();
  if (me) for (int i = 0; i < STEPS; ++i) p = sm[p];
  t1 = clock64();
  if (threadIdx.x == 0) out[rank*16+0] = (t1-t0)/STEPS;
  sm[N + threadIdx.x] = p;
  cl.sync();
  // 1 remote chase
  int* rem = cl.map_shared_rank(sm, (rank + 1) % 8);
  p = threadIdx.x & (N-1);
  t0 = clock64();
  if (me) for (int i = 0; i < STEPS; ++i) p = rem[p];
  t1 = clock64();
  if (threadIdx.x == 0) out[rank*16+1] = (t1-t0)/STEPS;
  sm[N + threadIdx.x] += p;
  cl.sync();
  // 2 remote atomicAdd with return, chained
  p = threadIdx.x & (N-1);
  t0 = clock64();
  if (me) for (int i = 0; i < STEPS; ++i) p = (atomicAdd(rem + N + 1024 + (p & 1023), 1) + p * 7) & (N - 1);
  t1 = clock64();
  if (threadIdx.x == 0) out[rank*16+2] = (t1-t0)/STEPS;
  cl.sync();
  // 3 local shared atomicAdd with return, chained
  p = threadIdx.x & (N-1);
  t0 = clock64();
  if (me) for (int i = 0; i < STEPS; ++i) p = (atomicAdd(sm + N + 1024 + (p & 1023), 1) + p * 7) & (N - 1);
  t1 = clock64();
  if (threadIdx.x == 0) out[rank*16+3] = (t1-t0)/STEPS;
  cl.sync();
  // 4 global chase ld.cg
  p = (threadIdx.x * 131 + rank * 7919) & gmask;
  t0 = clock64();
  if (me) for (int i = 0; i < STEPS; ++i) p = __ldcg(gbuf + p);
  t1 = clock64();
  if (threadIdx.x == 0) out[rank*16+4] = (t1-t0)/STEPS;
  sm[N + threadIdx.x] += p;
  // 5 global chase default
  p = (threadIdx.x * 131 + rank * 7919 + 5) & gmask;
  t0 = clock64();
  if (me) for (int i = 0; i < STEPS; ++i) p = gbuf[p];
  t1 = clock64();
  if (threadIdx.x == 0) out[rank*16+5] = (t1-t0)/STEPS;
  sm[N + threadIdx.x] += p;
  // 6 cluster.sync
  t0 = clock64();
  for (int i = 0; i < 64; ++i) cl.sync();
  t1 = clock64();
  if (threadIdx.x == 0) out[rank*16+6] = (t1-t0)/64;
  // 7 syncthreads
  t0 = clock64();
  for (int i = 0; i < 64; ++i) __syncthreads();
  t1 = clock64();
  if (threadIdx.x == 0) out[rank*16+7] = (t1-t0)/64;
  // 8 threadfence
  t0 = clock64();
  for (int i = 0; i < 64; ++i) __threadfence();
  t1 = clock64();
  if (threadIdx.x == 0) out[rank*16+8] = (t1-t0)/64;
  if (sm[N + threadIdx.x] == 123456789) gbuf[0] = 1;
  cl.sync();
}
extern "C" int run_micro(void* gbuf, int gmask, void* out, int all, int threads, void* stream) {
  cudaFuncSetAttribute(micro, cudaFuncAttributeMaxDynamicSharedMemorySize, 64 * 1024);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(8); cfg.blockDim = dim3(threads); cfg.dynamicSmemBytes = 64 * 1024; cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1]; attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 8; attr[0].val.clusterDim.y = 1; attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr; cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, micro, (int*)gbuf, gmask, (long long*)out, all);
  if (e) return e; return cudaGetLastError();
}
"""


def main():
    print(cs.card_line(), flush=True)
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "probe.cu", out_dir / "libprobe.so"
    src.write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).run_micro
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    n = 1 << 18
    chain = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    chain = chain.to(torch.int32).cuda()
    for every, threads in ((0, 512), (1, 512), (1, 1024)):
        out = torch.zeros(8 * 16, dtype=torch.int64, device="cuda")
        for _ in range(3):
            err = fn(chain.data_ptr(), n - 1, out.data_ptr(), every, threads,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed, CUDA error {err}")
        torch.cuda.synchronize()
        o = out.view(8, 16)[:, :len(NAMES)].cpu()
        print(("all threads" if every else "one thread"), threads,
              {k: o[:, i].tolist() for i, k in enumerate(NAMES)}, flush=True)


if __name__ == "__main__":
    main()
