// Device stamps at the layer boundaries of the train step, with a plain C
// interface (bound from Python with ctypes, see utils/tracing.py).
//
// step_mark_kernel replaces no TPU kernel of the JAX package: it is the
// port's instrumentation. A train step captured as a CUDA graph
// (train/step_graph.py) is one launch a step, so the host cannot see where
// inside it the time goes. The step launches this kernel at its layer
// boundaries (utils/tracing.py mark); it is captured with the step and runs
// in every replay. Stream order runs it after every kernel queued before
// it, and it writes the card's %globaltimer (nanoseconds) into
// stamps[*cursor, slot], where cursor is the step graph's device row cursor
// (read as the replay runs, so each replay writes its own row) and slot is
// fixed at the launch. One thread, one 8-byte read and one 8-byte write: the
// launch bounds it (a few microseconds), not bytes or operations. A cursor
// outside [0, steps) writes nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void step_mark_kernel(const int64_t* __restrict__ cursor,
                                 int64_t* __restrict__ stamps, int slots,
                                 int slot, int64_t steps) {
  uint64_t now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const int64_t row = *cursor;
  if (row >= 0 && row < steps) {
    stamps[row * slots + slot] = static_cast<int64_t>(now);
  }
}

}  // namespace

extern "C" {

// cursor [1] int64 and stamps [steps, slots] int64, on the card; 0 <= slot
// < slots. Returns cudaGetLastError() after the launch.
int step_mark(const int64_t* cursor, int64_t* stamps, int slots, int slot,
              long long steps, void* stream) {
  step_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      cursor, stamps, slots, slot, static_cast<int64_t>(steps));
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
