// K2: the Task Bench memory kernel, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/memory.py::_memory_kernel (the Pallas TPU
// kernel behind taskbench_memory).  Row c of the (C, size) scratch is cut
// into nwin = size / span windows; window w gets
// iterations[c] / nwin + (w < iterations[c] % nwin) applications of
// x * 1.0001 + 1.  That is bitwise the sequential walk in which step k
// touches window k % nwin, because the windows are disjoint.
//
// Bound on the H100: bytes.  Each value is read once and written once
// (8 bytes) against 2 flops per application, far below the card's
// ~20 flop/byte balance point for fp32.  Design: one block per
// (row, window), 256 threads streaming the window with neighbouring
// threads on neighbouring addresses, each value stepped in a register
// between its load and its store.  Where the wrapper finds `x`, `out` and
// `span` whole float4s (`wide`), each thread keeps kWideUnroll 16-byte
// loads in flight before it steps them (bodies.cuh::memory_window), the
// same loop K3's memory body runs; the blocks resident on an SM add to
// that.  The scratch a task bench run hands this kernel (132 columns x
// 1 MiB) exceeds the 50 MB L2, so the walk reaches device memory, as the
// paper's memory kernel intends.
#include "bodies.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    memory_kernel(const float* __restrict__ x,
                  const int* __restrict__ iterations, int iterations_scalar,
                  float* __restrict__ out, int size, int span, int nwin,
                  bool wide) {
  const int c = blockIdx.x / nwin;
  const int w = blockIdx.x % nwin;
  const int its = iterations != nullptr ? iterations[c] : iterations_scalar;
  const int reps = taskbench::window_reps(max(its, 0), nwin, w);
  const size_t off = static_cast<size_t>(c) * size
                     + static_cast<size_t>(w) * span;
  taskbench::memory_window<kThreads>(x + off, out + off, span, reps, wide);
}

}  // namespace

// `iterations` is a (rows,) int32 device array, or null with every row
// taking `iterations_scalar`.  `wide` != 0: `x` and `out` lie on 16-byte
// boundaries and `span` is a multiple of 4 (the wrapper checks).
extern "C" int taskbench_memory_launch(const float* x, const int* iterations,
                                       int iterations_scalar, float* out,
                                       int rows, int size, int span, int wide,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nwin = size / span;
  const long long blocks = static_cast<long long>(rows) * nwin;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  memory_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      x, iterations, iterations_scalar, out, size, span, nwin, wide != 0);
  return static_cast<int>(cudaGetLastError());
}
