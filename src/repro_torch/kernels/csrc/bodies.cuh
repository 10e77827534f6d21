// Device-side Task Bench bodies shared by the three kernels (K1 compute.cu,
// K2 memory.cu, K3 fused.cu).
//
// Numerics: the oracle (core/kernel_ref.py) rounds after every multiply and
// every add.  nvcc would contract `a * a - 1.0f` and `x * 1.0001f + 1.0f`
// into one FMA, which rounds once and breaks bitwise equality, so each step
// is written with the explicitly rounded intrinsics, which are never
// contracted.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace taskbench {

constexpr int kTileElems = 8 * 128;        // core.kernel_spec.COMPUTE_TILE
constexpr int kMxuDim = 128;               // core.kernel_spec.MXU_DIM
constexpr int kChecksumMask = (1 << 20) - 1;  // x % 2^20 for x >= 0
constexpr float kFoldBlock = 0x1p-46f;     // kernels.bodies.FOLD_BLOCK

__device__ __forceinline__ float compute_step(float a) {
  return __fsub_rn(__fmul_rn(a, a), 1.0f);
}

__device__ __forceinline__ float memory_step(float a) {
  return __fadd_rn(__fmul_rn(a, 1.0001f), 1.0f);
}

// Memory steps that window w of a row receives when `iterations` steps walk
// the row's nwin windows in order (step k touches window k % nwin).  The
// windows are disjoint, so this per-window count gives results bitwise
// equal to the sequential walk.
__device__ __forceinline__ int window_reps(int iterations, int nwin, int w) {
  return iterations / nwin + (w < iterations % nwin ? 1 : 0);
}

// n compute steps on the kTileElems values at `in`, written to `out` (which
// may be `in`).  All kThreads threads of the block take part; each holds
// kTileElems / kThreads values in registers for the whole loop.
template <int kThreads>
__device__ __forceinline__ void compute_tile(const float* in, float* out,
                                             int n) {
  static_assert(kTileElems % kThreads == 0, "tile must split evenly");
  constexpr int kPer = kTileElems / kThreads;
  float a[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) a[j] = in[threadIdx.x + j * kThreads];
  for (int k = 0; k < n; ++k) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) a[j] = compute_step(a[j]);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) out[threadIdx.x + j * kThreads] = a[j];
}

// `reps` memory steps on each of the `count` values at `in`, written to
// `out` (which may be `in`): each value is read once, stepped in a register
// and written once.  All threads of the block take part.
__device__ __forceinline__ void memory_window(const float* in, float* out,
                                              int count, int reps) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    float v = in[e];
    for (int r = 0; r < reps; ++r) v = memory_step(v);
    out[e] = v;
  }
}

}  // namespace taskbench
