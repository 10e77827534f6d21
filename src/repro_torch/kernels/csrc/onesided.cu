// K4: the one-sided Task Bench megakernel, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/backends/megakernel.py::_onesided_kernel (the Pallas
// TPU kernel built by MegakernelBackend._onesided_call): one persistent,
// communicating kernel per rank, each rank a column block of the graph.
// There a rank is a TPU chip and rows cross chips by remote DMA with a DMA
// semaphore as the signal.  Here a rank is one CTA of a single cooperative
// launch on one card, and rows cross ranks through global memory with a
// release/acquire flag as the signal.  Each timestep t, rank `me`
//   1. waits (t > 0) until every active ring offset has raised its t-1 flag;
//   2. runs its `local` tasks one after another, each a block-wide task:
//      the dependency combine over the context [inbox(t-1) | own t-1 wave],
//      the base checksum, the task body and the payload row, as in K3
//      (bodies.cuh), slot 1 being the global column me*local + i;
//   3. (t < H-1) puts, for every active ring offset oi, the rows
//      send_rows[me, oi, :] of its new wave into inbox slot (t, oi) of rank
//      (me + offsets[oi]) % ranks, then raises that slot's flag.
// Every rank puts to every active offset at every t < H-1, dead pairs
// included (rows no idx/mask entry reads): the reference's SPMD-uniform
// schedule, so every consumer can wait on every offset.  The reference's
// f32 one-hot put selection exists only because Mosaic lacks a row gather;
// here the put table holds the row index.
//
// Bound on the H100: the timestep chain, as in K3.  The flops of a fine
// task are tiny, so the limit is the latency of one put -> fence -> flag ->
// acquire -> inbox read round trip per timestep.  Design for correctness
// first:
// - the inbox (ranks, H, n_off*cap, P) has one slot per timestep, written
//   once per launch, so a producer that runs ahead never overwrites rows a
//   consumer has not read, and no acknowledgement flows back;
// - flags (ranks, H, n_off) int32 are zeroed by a memset on the launch's
//   stream just before it; a producer writes its rows, __syncthreads(),
//   then one thread fences and release-stores each flag; the consumer's
//   thread 0 spins on acquire loads of its flags, then __syncthreads();
// - inbox rows are read with __ldcg (through L2, never a stale L1 line);
// - the own wave is double-buffered in global memory (read and written by
//   the rank's own CTA only);
// - CTAs that spin on each other deadlock unless all are resident, so the
//   launch is cooperative: it fails, and nothing runs, when `ranks` exceeds
//   the CTAs that can be co-resident (taskbench_onesided_blocks);
// - a wait that outlasts its timeout traps, which ends the launch with an
//   error instead of hanging the card on a flag that never comes.  The
//   timeout is a deadlock guard, not a size limit: it is kWaitBaseNs plus H
//   times `local` times a ceiling on one task (wait_timeout_ns).  No wait of
//   a legal run can last longer than the whole launch, and the launch ends
//   within H times (local tasks + one put): when every rank has finished
//   timestep t, every rank has its t inputs.  The ceiling is 100x or more
//   above a task's time on the H100, even with five CTAs sharing an SM, so
//   only a flag that is never raised reaches it.
// A rank spread over a thread-block cluster, and puts into the consumer's
// shared memory with an mbarrier as the signal, are later speed work.
#include <cuda/atomic>

#include "bodies.cuh"

namespace {

constexpr int kThreads = 256;
constexpr double kWaitBaseNs = 20e9;

using Flag = cuda::atomic_ref<int, cuda::thread_scope_device>;

struct OnesidedArgs {
  const int* idx;        // (ranks, H, local, R) slots in [inbox | local]
  const int* mask;       // (ranks, H, local, R) 1 where the slot is live
  const int* iters;      // (ranks, H, local) task durations
  const int* base;       // (ranks, H, local) base checksums
  const int* send_rows;  // (ranks, n_off, cap) local row each put carries
  const int* offsets;    // (n_off,) active ring offsets
  const float* mxu_w;    // (128, 128), compute_mxu only
  float* waves;          // (2, ranks*local, P) double-buffered own waves
  float* scratch;        // (ranks*local, scratch_stride) body state
  long long scratch_stride;
  float* inbox;          // (ranks, H, n_off*cap, P) receive slots
  int* flags;            // (ranks, H, n_off) put signals, zero at launch
  int kind, ranks, H, local, R, P, n_off, cap, max_iters, span, size;
  unsigned long long wait_timeout_ns;  // deadlock guard (wait_timeout_ns())
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// Spin until the flag is raised (acquire), trapping after timeout_ns.
__device__ void wait_flag(int* flag_word, unsigned long long timeout_ns) {
  Flag flag(*flag_word);
  if (flag.load(cuda::memory_order_acquire) != 0) return;
  const unsigned long long start = global_ns();
  while (flag.load(cuda::memory_order_acquire) == 0) {
    if (global_ns() - start > timeout_ns) __trap();
  }
}

__global__ void __launch_bounds__(kThreads) onesided_kernel(OnesidedArgs a) {
  using namespace taskbench;
  __shared__ int s_acc;
  const int me = blockIdx.x;
  const int nin = a.n_off * a.cap;  // inbox rows per timestep
  const size_t wave = static_cast<size_t>(a.ranks) * a.local * a.P;

  for (int t = 0; t < a.H; ++t) {
    const float* prev = a.waves + static_cast<size_t>((t + 1) & 1) * wave;
    float* cur = a.waves + static_cast<size_t>(t & 1) * wave;
    const float* own_prev = prev + static_cast<size_t>(me) * a.local * a.P;

    // 1. wait for the t-1 puts of every active offset
    const float* inbox_prev = nullptr;
    if (t > 0) {
      inbox_prev = a.inbox
                   + (static_cast<size_t>(me) * a.H + (t - 1)) * nin * a.P;
      if (threadIdx.x == 0) {
        const size_t f0 = (static_cast<size_t>(me) * a.H + (t - 1)) * a.n_off;
        for (int oi = 0; oi < a.n_off; ++oi) wait_flag(a.flags + f0 + oi, a.wait_timeout_ns);
      }
    }
    __syncthreads();

    // 2. the rank's tasks
    for (int i = 0; i < a.local; ++i) {
      const int task = me * a.local + i;
      const size_t row = (static_cast<size_t>(me) * a.H + t) * a.local + i;
      if (threadIdx.x < 32) {
        const int part = warp_combine(
            a.idx + row * a.R, a.mask + row * a.R, t > 0 ? a.R : 0,
            [&](int k) {
              if (k < nin)
                return static_cast<int>(
                    __ldcg(inbox_prev + static_cast<size_t>(k) * a.P + 3));
              return static_cast<int>(
                  own_prev[static_cast<size_t>(k - nin) * a.P + 3]);
            });
        if (threadIdx.x == 0) s_acc = part;
      }
      __syncthreads();
      const int acc = s_acc;

      const int base = a.base[row];
      const int combined = (base + acc) & kChecksumMask;
      const int n = min(max(a.iters[row], 0), a.max_iters);
      const float seed = __fmul_rn(static_cast<float>(acc), kFoldBlock);
      float* scr = a.scratch + static_cast<size_t>(task) * a.scratch_stride;
      const float res = run_body<kThreads>(a.kind, seed, n, scr, a.mxu_w,
                                           a.span, a.size);
      write_payload<kThreads>(cur + static_cast<size_t>(task) * a.P, a.P, t,
                              task, base, combined, res);
      __syncthreads();  // s_acc is rewritten by the next task
    }

    // 3. the puts and their signals
    if (t < a.H - 1 && a.n_off > 0) {
      const float* own_cur = cur + static_cast<size_t>(me) * a.local * a.P;
      const int* rows = a.send_rows + static_cast<size_t>(me) * nin;
      for (int e = threadIdx.x; e < nin * a.P; e += kThreads) {
        const int slot = e / a.P, s = e % a.P;
        const int dst = (me + a.offsets[slot / a.cap]) % a.ranks;
        const size_t at = (static_cast<size_t>(dst) * a.H + t) * nin + slot;
        a.inbox[at * a.P + s] =
            own_cur[static_cast<size_t>(rows[slot]) * a.P + s];
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        for (int oi = 0; oi < a.n_off; ++oi) {
          const int dst = (me + a.offsets[oi]) % a.ranks;
          Flag flag(a.flags[(static_cast<size_t>(dst) * a.H + t) * a.n_off
                            + oi]);
          flag.store(1, cuda::memory_order_release);
        }
      }
    }
  }
}

// The deadlock guard of one launch: kWaitBaseNs plus H x local x a ceiling
// on one task of `kind` at max_iters iterations.  The ceiling is 1 ms, plus
// per iteration 100 us (compute), 10 ms (compute_mxu, a 128^3 product) or
// 100 ns an element of the window (memory), plus 100 ns an element of the
// scratch fill.
unsigned long long wait_timeout_ns(int kind, int H, int local, int max_iters,
                                   int span, int size) {
  using namespace taskbench;
  double per_iter = 0.0, fill = 0.0;
  if (kind == kCompute) per_iter = 1e5;
  if (kind == kComputeMxu) per_iter = 1e7;
  if (kind == kMemory) per_iter = 100.0 * span, fill = 100.0 * size;
  const double task = 1e6 + fill + per_iter * (max_iters > 0 ? max_iters : 0);
  const double ns = kWaitBaseNs + static_cast<double>(H) * local * task;
  return static_cast<unsigned long long>(ns < 9e18 ? ns : 9e18);
}

int resident_blocks(int device, cudaError_t* err) {
  int per_sm = 0, sms = 0, coop = 0;
  *err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (*err != cudaSuccess) return 0;
  if (!coop) {
    *err = cudaErrorNotSupported;
    return 0;
  }
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, onesided_kernel, kThreads, 0);
  if (*err != cudaSuccess) return 0;
  return per_sm * sms;
}

}  // namespace

// The most ranks (CTAs) one launch can hold co-resident (0 on error).
extern "C" int taskbench_onesided_blocks(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return 0;
  return resident_blocks(device, &err);
}

extern "C" int taskbench_onesided_launch(
    const int* idx, const int* mask, const int* iters, const int* base,
    const int* send_rows, const int* offsets, const float* mxu_w,
    float* waves, float* scratch, long long scratch_stride, float* inbox,
    int* flags, int kind, int ranks, int H, int local, int R, int P,
    int n_off, int cap, int max_iters, int span, int size, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ranks == 0 || local == 0 || H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_off > 0) {
    err = cudaMemsetAsync(
        flags, 0, static_cast<size_t>(ranks) * H * n_off * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  OnesidedArgs args{idx,   mask,    iters,          base,  send_rows,
                    offsets, mxu_w, waves,          scratch,
                    scratch_stride, inbox,          flags, kind,
                    ranks, H,       local,          R,     P,
                    n_off, cap,     max_iters,      span,  size,
                    wait_timeout_ns(kind, H, local, max_iters, span, size)};
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(onesided_kernel),
                                    dim3(ranks), dim3(kThreads), params, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
