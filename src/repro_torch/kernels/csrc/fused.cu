// K3: the fused Task Bench megakernel, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/backends/megakernel.py::_fused_kernel (the Pallas TPU
// kernel built by MegakernelBackend._call).  One launch runs G stacked task
// graphs for all H timesteps.  Each timestep, each (graph, column) task
//   1. sums the slot-3 values of its dependencies in the previous wave
//      (at most R slots of the dense idx/mask table), mod 2^20;
//   2. adds its base checksum;
//   3. runs the task body (empty / compute / compute_mxu / memory) seeded
//      with acc * 2^-46;
//   4. writes its payload row [t, i, base, combined, result, result...].
//
// Bound on the H100: the timestep chain.  The work of one timestep is small
// (132 columns of a compute task are ~0.3 MFLOP per iteration), so at fine
// granularity the limit is the latency of one grid-wide barrier plus one
// dependent table and payload read per timestep, not flops or bytes.
// Design: one persistent cooperative launch with the timestep loop inside
// the kernel, a grid.sync() between timesteps, the grid sized by occupancy
// (blocks per SM x SMs, capped at the G*W tasks) and the tasks of a timestep
// spread over the blocks in a grid-stride loop, so G*W has no limit.  The
// payload wave is double-buffered in global memory: timestep t reads buffer
// (t+1)&1 and writes buffer t&1; the kernel writes the t = 0 wave itself.
// The dependency combine is native int32 math done by one warp (the
// reference's f32 one-hot select-sum exists only because Mosaic lacks
// integer reductions; the values are the same).  Task bodies keep their
// state in a per-task global scratch row the wrapper allocates, so the
// compiler can neither merge the identical tile values nor drop the values
// that do not reach the payload.  compute_mxu is a plain SIMT fp32 loop
// over the 128 x 128 x 128 product: no tensor cores, no TF32.
#include <cooperative_groups.h>

#include "bodies.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

enum Kind { kEmpty = 0, kCompute = 1, kComputeMxu = 2, kMemory = 3 };

struct FusedArgs {
  const int* idx;     // (G*H, W, R) dependency columns
  const int* mask;    // (G*H, W, R) 1 where the slot is live
  const int* iters;   // (G*H, W) task durations
  const int* base;    // (G*H, W) base checksums
  const float* mxu_w;  // (128, 128), compute_mxu only
  float* waves;       // (2, G*W, P) double-buffered payload wave
  float* scratch;     // (G*W, scratch_stride) per-task body state
  long long scratch_stride;
  int kind, G, H, W, R, P, max_iters, span, size;
};

// The task body: returns the kernel result, the same value in every thread.
__device__ float run_body(const FusedArgs& a, float seed, int n,
                          float* scr) {
  using namespace taskbench;
  if (a.kind == kEmpty) return __fmul_rn(seed, 0.0f);

  if (a.kind == kCompute) {
    const float start = __fadd_rn(0.5f, seed);
    for (int e = threadIdx.x; e < kTileElems; e += kThreads) scr[e] = start;
    __syncthreads();
    compute_tile<kThreads>(scr, scr, n);
    __syncthreads();
    return scr[0];
  }

  if (a.kind == kMemory) {
    const float start = __fadd_rn(1.0f, seed);
    for (int e = threadIdx.x; e < a.size; e += kThreads) scr[e] = start;
    __syncthreads();
    const int nwin = a.size / a.span;
    for (int w = 0; w < nwin; ++w) {
      const int reps = window_reps(n, nwin, w);
      if (reps == 0) break;  // later windows get no more steps than this one
      memory_window(scr + static_cast<size_t>(w) * a.span,
                    scr + static_cast<size_t>(w) * a.span, a.span, reps);
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
        dot = fmaf(brow[j], a.mxu_w[j * kMxuDim + c], dot);
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

__global__ void __launch_bounds__(kThreads) fused_kernel(FusedArgs a) {
  using namespace taskbench;
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_acc;
  const int tasks = a.G * a.W;
  const size_t wave = static_cast<size_t>(tasks) * a.P;

  for (int t = 0; t < a.H; ++t) {
    const float* prev = a.waves + static_cast<size_t>((t + 1) & 1) * wave;
    float* cur = a.waves + static_cast<size_t>(t & 1) * wave;
    for (int task = blockIdx.x; task < tasks; task += gridDim.x) {
      const int g = task / a.W;
      const int i = task % a.W;
      const size_t row = (static_cast<size_t>(g) * a.H + t) * a.W + i;

      // 1. dependency combine: lane r takes slots r, r+32, ...; every
      // partial sum stays below 2^21, so int32 holds it before the mask.
      // At t = 0 there are no dependencies and no previous wave to read.
      if (threadIdx.x < 32) {
        int part = 0;
        if (t > 0) {
          for (int r = threadIdx.x; r < a.R; r += 32) {
            if (a.mask[row * a.R + r] != 0) {
              const size_t src =
                  static_cast<size_t>(g) * a.W + a.idx[row * a.R + r];
              part = (part + static_cast<int>(prev[src * a.P + 3]))
                     & kChecksumMask;
            }
          }
        }
        for (int off = 16; off > 0; off >>= 1)
          part = (part + __shfl_down_sync(0xffffffffu, part, off))
                 & kChecksumMask;
        if (threadIdx.x == 0) s_acc = part;
      }
      __syncthreads();
      const int acc = s_acc;

      // 2.-3. checksum and task body
      const int base = a.base[row];
      const int combined = (base + acc) & kChecksumMask;
      const int n = min(max(a.iters[row], 0), a.max_iters);
      const float seed = __fmul_rn(static_cast<float>(acc), kFoldBlock);
      float* scr = a.scratch + static_cast<size_t>(task) * a.scratch_stride;
      const float res = run_body(a, seed, n, scr);

      // 4. the payload row; slot 1 is the column within its graph
      float* out = cur + static_cast<size_t>(task) * a.P;
      for (int s = threadIdx.x; s < a.P; s += kThreads) {
        float v = res;
        if (s == 0) v = static_cast<float>(t);
        else if (s == 1) v = static_cast<float>(i);
        else if (s == 2) v = static_cast<float>(base);
        else if (s == 3) v = static_cast<float>(combined);
        out[s] = v;
      }
      __syncthreads();  // s_acc is rewritten by the next task
    }
    grid.sync();
  }
}

int blocks_for(int tasks, int device, cudaError_t* err) {
  int per_sm = 0, sms = 0, coop = 0;
  *err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (*err != cudaSuccess) return 0;
  if (!coop) {
    *err = cudaErrorNotSupported;
    return 0;
  }
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel,
                                                       kThreads, 0);
  if (*err != cudaSuccess) return 0;
  const long long cap = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(tasks < cap ? tasks : cap);
}

}  // namespace

// The grid the launch below uses for `tasks` = G*W tasks (0 on error).
extern "C" int taskbench_fused_blocks(int tasks, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return 0;
  return blocks_for(tasks, device, &err);
}

extern "C" int taskbench_fused_launch(
    const int* idx, const int* mask, const int* iters, const int* base,
    const float* mxu_w, float* waves, float* scratch,
    long long scratch_stride, int kind, int G, int H, int W, int R, int P,
    int max_iters, int span, int size, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tasks = G * W;
  if (tasks == 0 || H == 0) return 0;
  const int blocks = blocks_for(tasks, device, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  FusedArgs args{idx,   mask,    iters, base, mxu_w,     waves, scratch,
                 scratch_stride, kind,  G,    H,         W,     R,
                 P,     max_iters, span, size};
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_kernel),
                                    dim3(blocks), dim3(kThreads), params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
