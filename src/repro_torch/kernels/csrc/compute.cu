// K1: the Task Bench compute kernel, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/compute.py::_compute_kernel (the Pallas TPU
// kernel behind taskbench_compute).  For each of W task columns, an (8, 128)
// f32 tile iterates a = a*a - 1 for min(iters[w], max_iters) steps; that
// equals the reference's keep-masked loop of max_iters steps bitwise.
//
// Bound on the H100: operations.  A tile is 4 KiB read and written once
// against 2048 flops per step, so past a few steps the fp32 pipes are the
// limit.  Design: one block of 256 threads per column, each thread holding
// 4 tile values in registers for the whole loop (4 independent dependency
// chains per thread, 8 warps per block), one load and one store per value.
// The block of 8 columns the TPU grid walks has no meaning here: columns
// are independent and each gets its own block, spread over the 132 SMs.
#include "bodies.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    compute_kernel(const float* __restrict__ tiles,
                   const int* __restrict__ iters, float* __restrict__ out,
                   int max_iters) {
  const size_t w = blockIdx.x;
  const int n = min(max(iters[w], 0), max_iters);
  taskbench::compute_tile<kThreads>(tiles + w * taskbench::kTileElems,
                                    out + w * taskbench::kTileElems, n);
}

}  // namespace

extern "C" int taskbench_compute_launch(const float* tiles, const int* iters,
                                        float* out, int width, int max_iters,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (width == 0) return 0;
  compute_kernel<<<width, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, iters, out, max_iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
