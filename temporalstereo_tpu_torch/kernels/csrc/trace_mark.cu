// A stage mark of the served stream: one thread writes the device's clock
// into a ring of int64 nanoseconds, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package times its stages from the host.
// A CUDA graph keeps no host range at replay, so the marks are kernels
// placed in the graph between the model's stages (serving.py, tracing.py):
//   ring[cursor % slots][mark] = %globaltimer (ns)
//   advance: cursor += 1 (the stage's last mark of a replay)
// One thread, a few bytes: what bounds it is the launch, 1-3 us a graph
// node.  Each mark starts after the kernel before it in the stream has
// ended, so the difference of two marks is the device time of the work
// between them.
#include <cuda_runtime.h>

__global__ void trace_mark_kernel(long long* ring, long long* cursor, int mark,
                                  int marks, int slots, int advance) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long n = *cursor;
  ring[(n % slots) * marks + mark] = (long long)now;
  if (advance) *cursor = n + 1;
}

extern "C" int trace_mark(void* ring, void* cursor, int mark, int marks,
                          int slots, int advance, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mark < 0 || mark >= marks || slots < 1) return (int)cudaErrorInvalidValue;
  trace_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)ring, (long long*)cursor, mark, marks, slots, advance);
  return (int)cudaGetLastError();
}
