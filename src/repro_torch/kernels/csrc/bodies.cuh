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
// and written once.  All kThreads threads of the block take part.
//
// What bounds the walk is the bytes in flight: at ~1 us of loaded latency
// an SM has to keep ~25 KB of loads outstanding for its share of 3.35 TB/s.
// One value a thread, loaded and stepped before the next load, leaves
// 1 KiB in flight for a 256-thread block, which is all K3 has on an SM.  So
// where `wide` (the wrapper's check: `in` and `out` on 16-byte boundaries
// and `count` a multiple of 4), each thread issues kWideUnroll independent
// 16-byte loads, neighbouring threads on neighbouring float4s, before it
// steps any of them: 32 KiB in flight a block (16 loads ran no faster on an
// H100, 32 far slower, and a streaming hint on the stores gained nothing).
// It then steps each lane `reps` times in registers and issues the stores.
// The plain loop takes what the groups of kThreads * kWideUnroll float4s
// leave, and all of an input that is not `wide`.  The loads are plain
// `ld.global`: in K3 and K4 the block itself wrote `in` (the fill), so the
// non-coherent path is not allowed.  Every value gets the same explicitly
// rounded steps in the same order, so the result is bitwise that of the
// plain loop.
constexpr int kWideUnroll = 8;

__device__ __forceinline__ float4 memory_step4(float4 v) {
  return make_float4(memory_step(v.x), memory_step(v.y), memory_step(v.z),
                     memory_step(v.w));
}

template <int kThreads>
__device__ __forceinline__ void memory_window(const float* in, float* out,
                                              int count, int reps,
                                              bool wide) {
  int done = 0;
  if (wide) {
    constexpr int kGroup = kThreads * kWideUnroll;  // float4s a group
    const float4* in4 = reinterpret_cast<const float4*>(in);
    float4* out4 = reinterpret_cast<float4*>(out);
    const int groups = count / 4 / kGroup;
    for (int g = 0; g < groups; ++g) {
      const int at = g * kGroup + threadIdx.x;
      float4 v[kWideUnroll];
#pragma unroll
      for (int u = 0; u < kWideUnroll; ++u) v[u] = in4[at + u * kThreads];
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int u = 0; u < kWideUnroll; ++u) v[u] = memory_step4(v[u]);
      }
#pragma unroll
      for (int u = 0; u < kWideUnroll; ++u) out4[at + u * kThreads] = v[u];
    }
    done = groups * kGroup * 4;
  }
  for (int e = done + threadIdx.x; e < count; e += blockDim.x) {
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
// `wide` (memory only): the wrapper found the scratch on a 16-byte
// boundary and `span` a multiple of 4, so every row and window starts on
// one (rows are whole numbers of windows apart).
template <int kThreads>
__device__ float run_body(int kind, float seed, int n, float* scr,
                          const float* mxu_w, int span, int size,
                          bool wide) {
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
    // the whole row is filled before the walk reads any of it: fused into
    // the walk, or filled a window at a time, the fill would hand the walk
    // its values through the L2 instead of the task's scratch row
    const float start = __fadd_rn(1.0f, seed);
    if (wide) {
      const float4 start4 = make_float4(start, start, start, start);
      float4* scr4 = reinterpret_cast<float4*>(scr);
      for (int e = threadIdx.x; e < size / 4; e += kThreads) scr4[e] = start4;
    } else {
      for (int e = threadIdx.x; e < size; e += kThreads) scr[e] = start;
    }
    __syncthreads();
    const int nwin = size / span;
    for (int w = 0; w < nwin; ++w) {
      const int reps = window_reps(n, nwin, w);
      if (reps == 0) break;  // later windows get no more steps than this one
      memory_window<kThreads>(scr + static_cast<size_t>(w) * span,
                              scr + static_cast<size_t>(w) * span, span, reps,
                              wide);
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
