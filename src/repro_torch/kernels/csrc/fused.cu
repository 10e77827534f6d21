// K3: the fused Task Bench megakernel, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/backends/megakernel.py::_fused_kernel (the Pallas TPU
// kernel built by MegakernelBackend._call).  One launch runs G stacked task
// graphs for all H timesteps.  Each timestep, each (graph, column) task
//   1. sums the combined checksums of its dependencies at t-1 (at most R
//      slots of the dense idx/mask table), mod 2^20;
//   2. adds its base checksum;
//   3. runs the task body (empty / compute / compute_mxu / memory) seeded
//      with acc * 2^-46;
//   4. writes its payload row [t, i, base, combined, result, result...]
//      and publishes its combined checksum in its (t, task) signal word.
//
// Bound on the H100: the timestep chain.  The work of one timestep is small
// (132 columns of a compute task are ~0.3 MFLOP per iteration), so at fine
// granularity the limit is the latency with which a task learns that its
// dependencies are done, not flops or bytes.  Design: one persistent
// cooperative launch with the timestep loop inside the kernel, the grid
// sized by occupancy (blocks per SM x SMs, capped at the G*W tasks) and the
// tasks of a timestep spread over the blocks in a grid-stride loop, so G*W
// has no limit.  There is no barrier across CTAs: a task waits only on the
// words of its own dependencies (signal.cuh).  Each (graph, timestep, task)
// has one 64-bit word, tag t+1 over the combined checksum, written by one
// relaxed store when the task is done: (G, H, W) words, zeroed by a memset
// on the launch's stream.  A consumer's lane r polls the t-1 word of
// dependency r until its tag is t and takes the value from the same word,
// so one L2 trip carries both the signal and the data, with no fence.  The
// table entries of a task depend on nothing: a CTA loads those of its next
// task before it waits on the current one's inputs.
// A word is written once per launch, so a task that runs ahead never
// overwrites a word a slow consumer has yet to read, whatever the pattern.
//
// Why the waits cannot deadlock: every CTA is resident at once (the launch
// is cooperative, and fails rather than runs when the grid does not fit),
// and each CTA walks t outermost, finishing all its tasks of t-1 before any
// task of t.  By induction on t: every t = 0 task waits on nothing; if every
// word of t-1 is eventually written, every task of t eventually has its
// inputs, and a CTA blocked in a task of t has already written all its
// words of t-1, so it holds back no task of t.  Every wait is still bounded
// by the launch's deadlock guard, which traps (signal.cuh).
//
// The memory body is bound by bytes, not by the chain: a task fills its
// scratch row (4 * size bytes written), then reads and writes each window
// once, 3 * 4 * size bytes a task a step (6 MiB at the benchmark's 2 MiB
// row), and one 256-thread CTA on each SM has to keep that stream busy.
// Where the wrapper finds the scratch and `span` whole float4s (`wide`), the
// fill stores float4s and the walk keeps kWideUnroll 16-byte loads in flight
// a thread before it steps them (bodies.cuh::memory_window), instead of one
// 4-byte load at a time.  That body needs more registers than the others
// (built into one instance with it, the compute body ran ~2 % slower on an
// H100), so it is an instance of its own (`fused_kernel_wide`, launched
// only where `wide`): the other bodies keep their code and their grid.
//
// The payload rows are written, never read, inside the kernel: one (G*W, P)
// buffer holds the last wave.  The dependency combine is native int32 math
// done by one warp (the reference's f32 one-hot select-sum exists only
// because Mosaic lacks integer reductions; the values are the same).  Task
// bodies keep their state in a per-task global scratch row the wrapper
// allocates, so the compiler can neither merge the identical tile values nor
// drop the values that do not reach the payload.  compute_mxu is a plain
// SIMT fp32 loop over the 128 x 128 x 128 product: no tensor cores, no TF32.
//
// Tracing: the timestep loop is one template on kTrace (and kWide), built
// twice for each body.  The untraced instance is `fused_kernel` (or
// `fused_kernel_wide`), the launch without a counter buffer, its code the
// same as without tracing (every tracing statement is under `if
// constexpr`).  `fused_kernel_traced` (`fused_kernel_traced_wide`) is
// launched when the wrapper passes `stats` (only while repro_torch.trace is
// recording), on the untraced instance's grid, which blocks_for sizes so
// that both keep it resident.  Each of its CTAs sums, with
// clock64() (the SM's cycle counter: durations within a CTA only), the
// cycles its warp 0 spends in the dependency combine (the wait_word polls
// of its slowest lane and the 5-step shuffle that sums their values), the
// cycles from each task's start to its signal store, and the tasks that
// found a dependency not ready at the first poll, and writes them to its
// row of `stats`, (grid, kStats) int64.  Each lane timing its own polls,
// the warp's maximum then taken with 64-bit shuffles, made the benchmark's
// compute launch 1.70x as long (1.98 -> 3.38 ms, H100 at 700 W); lane 0's
// clock around the combine costs 1.026x.
#include "bodies.cuh"
#include "signal.cuh"

namespace {

constexpr int kThreads = 256;

struct FusedArgs {
  const int* idx;     // (G*H, W, R) dependency columns
  const int* mask;    // (G*H, W, R) 1 where the slot is live
  const int* iters;   // (G*H, W) task durations
  const int* base;    // (G*H, W) base checksums
  const float* mxu_w;  // (128, 128), compute_mxu only
  float* wave;        // (G*W, P) payload rows, the last wave at the end
  unsigned long long* words;  // (G*H, W) signal words, zero at launch
  float* scratch;     // (G*W, scratch_stride) per-task body state
  long long scratch_stride;
  int kind, G, H, W, R, P, max_iters, span, size;
  unsigned long long wait_timeout_ns;  // deadlock guard (signal.cuh)
};

// a traced CTA's row of counters (backends/megakernel.py::K3_COUNTERS)
enum Stat { kWaitCycles = 0, kTaskCycles = 1, kLateTasks = 2, kStats = 3 };

template <bool kTrace, bool kWide>
__device__ __forceinline__ void run_tasks(FusedArgs a, long long* stats) {
  using namespace taskbench;
  __shared__ int s_acc;
  const int tasks = a.G * a.W;
  // the traced instance's sums, kept by thread 0
  [[maybe_unused]] long long wait_cycles = 0, task_cycles = 0, late_tasks = 0;

  const auto row_of = [&](int t, int task) {
    return (static_cast<size_t>(task / a.W) * a.H + t) * a.W + task % a.W;
  };
  const auto entries_of = [&](int t, int task) {
    return load_entries(a.idx, a.mask, a.base, a.iters, row_of(t, task), a.R,
                        a.max_iters);
  };
  // the table entries of this CTA's next task, loaded one task ahead
  TaskEntries next = entries_of(0, blockIdx.x);  // the grid is <= tasks

  for (int t = 0; t < a.H; ++t) {
    for (int task = blockIdx.x; task < tasks; task += gridDim.x) {
      [[maybe_unused]] long long task_start = 0;
      if constexpr (kTrace) task_start = clock64();
      const int i = task % a.W;
      const size_t row = row_of(t, task);
      const TaskEntries e = next;
      if (task + gridDim.x < tasks) next = entries_of(t, task + gridDim.x);
      else if (t + 1 < a.H) next = entries_of(t + 1, blockIdx.x);

      // 1. dependency combine (bodies.cuh): lane r waits on the t-1 word of
      // dependency r, (row - i - W) + j; at t = 0 there is none
      if (threadIdx.x < 32) {
        const unsigned long long* prev = a.words + (row - i);
        if constexpr (kTrace) {
          bool late = false;
          const long long c0 = clock64();
          const int part = warp_combine(
              e, a.idx + row * a.R, a.mask + row * a.R, t > 0 ? a.R : 0,
              [&](int j) {
                return static_cast<int>(wait_word<true>(
                    prev - a.W + j, t, a.wait_timeout_ns, &late));
              });
          // warp_combine's sum ends in a shuffle that waits for every lane,
          // so lane 0's clock is past the slowest lane's polls
          const long long waited = clock64() - c0;
          late = __any_sync(0xffffffffu, late);
          if (threadIdx.x == 0) {
            s_acc = part;
            wait_cycles += waited;
            late_tasks += late;
          }
        } else {
          const int part = warp_combine(
              e, a.idx + row * a.R, a.mask + row * a.R, t > 0 ? a.R : 0,
              [&](int j) {
                return static_cast<int>(
                    wait_word(prev - a.W + j, t, a.wait_timeout_ns));
              });
          if (threadIdx.x == 0) s_acc = part;
        }
      }
      __syncthreads();
      const int acc = s_acc;

      // 2.-3. checksum and task body
      const int base = e.base, n = e.n;
      const int combined = (base + acc) & kChecksumMask;
      const float seed = __fmul_rn(static_cast<float>(acc), kFoldBlock);
      float* scr = a.scratch + static_cast<size_t>(task) * a.scratch_stride;
      const float res = run_body<kThreads>(a.kind, seed, n, scr, a.mxu_w,
                                           a.span, a.size, kWide);

      // 4. the payload row (slot 1 is the column within its graph), then
      // the signal: the body has ended in every thread (run_body)
      write_payload<kThreads>(a.wave + static_cast<size_t>(task) * a.P, a.P,
                              t, i, base, combined, res);
      if (threadIdx.x == 0) {
        if constexpr (kTrace) task_cycles += clock64() - task_start;
        store_word(a.words + row, t + 1, combined);
      }
      __syncthreads();  // s_acc is rewritten by the next task
    }
  }
  if constexpr (kTrace) {
    if (threadIdx.x == 0) {
      long long* out = stats + static_cast<size_t>(blockIdx.x) * kStats;
      out[kWaitCycles] = wait_cycles;
      out[kTaskCycles] = task_cycles;
      out[kLateTasks] = late_tasks;
    }
  }
}

__global__ void __launch_bounds__(kThreads) fused_kernel(FusedArgs a) {
  run_tasks<false, false>(a, nullptr);
}

__global__ void __launch_bounds__(kThreads)
    fused_kernel_traced(FusedArgs a, long long* stats) {
  run_tasks<true, false>(a, stats);
}

__global__ void __launch_bounds__(kThreads) fused_kernel_wide(FusedArgs a) {
  run_tasks<false, true>(a, nullptr);
}

__global__ void __launch_bounds__(kThreads)
    fused_kernel_traced_wide(FusedArgs a, long long* stats) {
  run_tasks<true, true>(a, stats);
}

// The untraced and the traced instance of one body, and the grid both can
// keep resident, so a traced launch runs the untraced one's grid.
struct Instances {
  void (*untraced)(FusedArgs);
  void (*traced)(FusedArgs, long long*);
};

Instances instances(bool wide) {
  if (wide) return {fused_kernel_wide, fused_kernel_traced_wide};
  return {fused_kernel, fused_kernel_traced};
}

int blocks_for(int tasks, bool wide, int device, cudaError_t* err) {
  int per_sm = 0, traced_per_sm = 0, sms = 0, coop = 0;
  *err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (*err != cudaSuccess) return 0;
  if (!coop) {
    *err = cudaErrorNotSupported;
    return 0;
  }
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err != cudaSuccess) return 0;
  const Instances k = instances(wide);
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k.untraced,
                                                       kThreads, 0);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&traced_per_sm,
                                                       k.traced, kThreads, 0);
  if (*err != cudaSuccess) return 0;
  if (traced_per_sm < per_sm) per_sm = traced_per_sm;
  const long long cap = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(tasks < cap ? tasks : cap);
}

}  // namespace

// The grid the launch below uses for `tasks` = G*W tasks and `wide` (0 on
// error).
extern "C" int taskbench_fused_blocks(int tasks, int wide, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return 0;
  return blocks_for(tasks, wide != 0, device, &err);
}

extern "C" int taskbench_fused_launch(
    const int* idx, const int* mask, const int* iters, const int* base,
    const float* mxu_w, float* wave, unsigned long long* words,
    float* scratch, long long* stats, long long scratch_stride, int kind,
    int G, int H, int W, int R, int P, int max_iters, int span, int size,
    int wide, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tasks = G * W;
  if (tasks == 0 || H == 0) return 0;
  const int blocks = blocks_for(tasks, wide != 0, device, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(words, 0,
                        static_cast<size_t>(tasks) * H * sizeof(*words), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_cta = (tasks + blocks - 1) / blocks;
  FusedArgs args{idx,     mask,  iters, base,     mxu_w, wave, words,
                 scratch, scratch_stride, kind,  G,    H,     W,
                 R,       P,     max_iters, span, size,
                 taskbench::wait_timeout_ns(kind, H, per_cta, max_iters,
                                            span, size)};
  const Instances k = instances(wide != 0);
  if (stats == nullptr) {
    void* params[] = {&args};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(k.untraced),
                                      dim3(blocks), dim3(kThreads), params, 0,
                                      s);
  } else {
    void* params[] = {&args, &stats};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(k.traced),
                                      dim3(blocks), dim3(kThreads), params, 0,
                                      s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
