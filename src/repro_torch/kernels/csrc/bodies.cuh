// Device-side Task Bench bodies shared by the kernels (K1 compute.cu,
// K2 memory.cu, K3 fused.cu, K4 onesided.cu).  K3 and K4 run the same task:
// warp_combine, run_body and write_payload below.
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

// backends.megakernel.KIND_CODES
enum Kind { kEmpty = 0, kCompute = 1, kComputeMxu = 2, kMemory = 3 };

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

// The table entries of one task: lane r of warp 0 holds dependency slot r
// (r < 32; warp_combine loads slots past 32 itself), every thread holds the
// base checksum and the duration.  They depend on nothing, so K3 and K4 load
// a task's entries before they wait on its inputs, off the timestep chain.
struct TaskEntries {
  int dep, live, base, n;
};

__device__ __forceinline__ TaskEntries load_entries(
    const int* idx, const int* mask, const int* base, const int* iters,
    size_t row, int R, int max_iters) {
  TaskEntries e{0, 0, base[row], min(max(iters[row], 0), max_iters)};
  if (threadIdx.x < 32 && threadIdx.x < R) {
    e.dep = idx[row * R + threadIdx.x];
    e.live = mask[row * R + threadIdx.x];
  }
  return e;
}

// The dependency combine of one task, run by the 32 lanes of warp 0: the
// sum mod 2^20 of value(idx[r]) over the live slots r < R of the task's row
// (`idx`, `mask`), lane r taking slots r (from its entries), r+32, ...  Every
// partial sum stays below 2^21, so int32 holds it before the mask.  The sum
// lands in lane 0.
template <class Value>
__device__ __forceinline__ int warp_combine(const TaskEntries& e,
                                            const int* idx, const int* mask,
                                            int R, Value value) {
  int part = 0;
  if (threadIdx.x < R && e.live != 0)
    part = (part + value(e.dep)) & kChecksumMask;
  for (int r = threadIdx.x + 32; r < R; r += 32) {
    const int j = idx[r];
    if (mask[r] != 0) part = (part + value(j)) & kChecksumMask;
  }
  for (int off = 16; off > 0; off >>= 1)
    part = (part + __shfl_down_sync(0xffffffffu, part, off)) & kChecksumMask;
  return part;
}

// The task body of one task, run by all kThreads threads of the block:
// returns the kernel result, the same value in every thread.  The state
// lives in the task's scratch row `scr` in global memory (see fused.cu).
template <int kThreads>
__device__ float run_body(int kind, float seed, int n, float* scr,
                          const float* mxu_w, int span, int size) {
  if (kind == kEmpty) return __fmul_rn(seed, 0.0f);

  if (kind == kCompute) {
    const float start = __fadd_rn(0.5f, seed);
    for (int e = threadIdx.x; e < kTileElems; e += kThreads) scr[e] = start;
    __syncthreads();
    compute_tile<kThreads>(scr, scr, n);
    __syncthreads();
    return scr[0];
  }

  if (kind == kMemory) {
    const float start = __fadd_rn(1.0f, seed);
    for (int e = threadIdx.x; e < size; e += kThreads) scr[e] = start;
    __syncthreads();
    const int nwin = size / span;
    for (int w = 0; w < nwin; ++w) {
      const int reps = window_reps(n, nwin, w);
      if (reps == 0) break;  // later windows get no more steps than this one
      memory_window(scr + static_cast<size_t>(w) * span,
                    scr + static_cast<size_t>(w) * span, span, reps);
    }
    __syncthreads();
    return scr[0];
  }

  // compute_mxu: b <- (b @ w) / 128 + b / 2, ping-ponging two 128x128
  // buffers of the task's scratch row
  constexpr int kElems = kMxuDim * kMxuDim;
  const float start = __fadd_rn(0.25f, seed);
  float* cur = scr;
  float* nxt = scr + kElems;
  for (int e = threadIdx.x; e < kElems; e += kThreads) cur[e] = start;
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    for (int o = threadIdx.x; o < kElems; o += kThreads) {
      const int i = o / kMxuDim, c = o % kMxuDim;
      const float* brow = cur + i * kMxuDim;
      float dot = 0.0f;
      for (int j = 0; j < kMxuDim; ++j)
        dot = fmaf(brow[j], mxu_w[j * kMxuDim + c], dot);
      nxt[o] = __fadd_rn(__fmul_rn(dot, 1.0f / kMxuDim),
                         __fmul_rn(cur[o], 0.5f));
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur[0];
}

// The payload row [t, col, base, combined, res, res...] of one task.
template <int kThreads>
__device__ __forceinline__ void write_payload(float* out, int P, int t,
                                              int col, int base,
                                              int combined, float res) {
  for (int s = threadIdx.x; s < P; s += kThreads) {
    float v = res;
    if (s == 0) v = static_cast<float>(t);
    else if (s == 1) v = static_cast<float>(col);
    else if (s == 2) v = static_cast<float>(base);
    else if (s == 3) v = static_cast<float>(combined);
    out[s] = v;
  }
}

}  // namespace taskbench
