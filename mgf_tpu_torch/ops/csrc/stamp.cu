// A device time stamp that closes one interval of the step's stage table,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package reads its stage times from XLA's
// profiler, whose ranges cover a compiled chunk.  Here the step replays
// from CUDA graphs, and a host range open during a capture is not replayed,
// so the stages are timed from inside the stream: one thread reads the
// card's nanosecond clock (%globaltimer, the same on every SM) once the
// kernel before it in the stream has finished, adds the time since the
// previous stamp to the interval it closes, counts it, and keeps the clock
// for the next stamp.  A capture records the launch as a node, so every
// replay of the graph stamps again.
//
// What bounds it: the launch, ~1-2 us inside a graph; it moves 32 bytes.
//
// The buffer (int64, zeroed by the host between windows):
//   [0] the last stamp's clock, 0 before the first
//   [1] the first stamp's clock
//   [2 + 2 * slot] nanoseconds summed into interval `slot`
//   [3 + 2 * slot] stamps that closed interval `slot`
// The first stamp after a reset opens the first interval and closes none.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* buf, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long last = buf[0];
  if (last == 0ull) {
    buf[1] = now;
  } else {
    buf[2 + 2 * slot] += now - last;
    buf[3 + 2 * slot] += 1ull;
  }
  buf[0] = now;
}

}  // namespace

extern "C" int mgf_stamp(void* buf, int slot, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(buf), slot);
  return static_cast<int>(cudaGetLastError());
}
