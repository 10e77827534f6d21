// K4: the one-sided Task Bench megakernel, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/backends/megakernel.py::_onesided_kernel (the Pallas
// TPU kernel built by MegakernelBackend._onesided_call): one persistent,
// communicating kernel per rank, each rank a column block of the graph.
// There a rank is a TPU chip and rows cross chips by remote DMA with a DMA
// semaphore as the signal.  Here a rank is one CTA of a single cooperative
// launch on one card, and rows cross ranks through global memory as tagged
// words that carry their own signal (signal.cuh).  Each timestep t, rank `me`
//   1. waits (t > 0) until every word of its t-1 inbox slot, every active
//      offset, carries tag t;
//   2. runs its `local` tasks one after another, each a block-wide task:
//      the dependency combine over the context [inbox(t-1) | own t-1 wave],
//      the base checksum, the task body and the payload row, as in K3
//      (bodies.cuh), slot 1 being the global column me*local + i;
//   3. (t < H-1) puts, for every active ring offset oi, the rows
//      send_rows[me, oi, :] of its new wave into inbox slot (t, oi) of rank
//      (me + offsets[oi]) % ranks, each element one word of tag t+1.
// Every rank puts to every active offset at every t < H-1, dead pairs
// included (rows no idx/mask entry reads): the reference's SPMD-uniform
// schedule, so every consumer waits on the whole put of every offset, as
// the reference waits on every offset's receive semaphore.  The
// reference's f32 one-hot put selection exists only because Mosaic lacks a
// row gather; here the put table holds the row index.
//
// Bound on the H100: the timestep chain, as in K3.  The flops of a fine
// task are tiny, so the limit is the latency with which a put reaches its
// consumer.  Design (NCCL's "LL" protocol):
// - the inbox (ranks, H, n_off*cap, P) holds one 64-bit word an element,
//   tag t+1 over the float's bits, written by one relaxed store; a consumer
//   that sees the tag sees the value of the same store, so the put needs
//   no fence and no flag, and the wait and the read are one L2 trip;
// - the consumer's threads poll the n_off*cap*P words of its t-1 slot in
//   parallel, keep the slot-3 values (the combined checksums the combine
//   reads) in shared memory, then __syncthreads(); the table entries of the
//   step's first task depend on nothing and are loaded before the wait;
// - the inbox has one slot per timestep, written once per launch and zeroed
//   by a memset on the launch's stream just before it, so a producer that
//   runs ahead never overwrites words a consumer has not read, and no
//   acknowledgement flows back;
// - the own wave is double-buffered in global memory (read and written by
//   the rank's own CTA only);
// - CTAs that spin on each other deadlock unless all are resident, so the
//   launch is cooperative: it fails, and nothing runs, when `ranks` exceeds
//   the CTAs that can be co-resident (taskbench_onesided_blocks).  With all
//   resident, by induction on t: a rank's t-1 puts need only its own t-1
//   inputs, so every t-1 word is eventually written and every rank reaches t;
// - every wait is bounded by the launch's deadlock guard (wait_timeout_ns
//   with `local` tasks a CTA a timestep), which traps instead of hanging
//   the card on a word that never comes.
// A rank spread over a thread-block cluster, and puts into the consumer's
// shared memory with an mbarrier as the signal, are later speed work.
#include "bodies.cuh"
#include "signal.cuh"

namespace {

constexpr int kThreads = 256;

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
  unsigned long long* inbox;  // (ranks, H, n_off*cap, P) words, zero at launch
  int kind, ranks, H, local, R, P, n_off, cap, max_iters, span, size;
  bool wide;  // memory body on float4s (bodies.cuh::run_body)
  unsigned long long wait_timeout_ns;  // deadlock guard (signal.cuh)
};

__global__ void __launch_bounds__(kThreads) onesided_kernel(OnesidedArgs a) {
  using namespace taskbench;
  extern __shared__ int s_in[];  // (nin,) slot 3 of the t-1 inbox rows
  __shared__ int s_acc;
  const int me = blockIdx.x;
  const int nin = a.n_off * a.cap;  // inbox rows per timestep
  const size_t wave = static_cast<size_t>(a.ranks) * a.local * a.P;

  for (int t = 0; t < a.H; ++t) {
    const float* prev = a.waves + static_cast<size_t>((t + 1) & 1) * wave;
    float* cur = a.waves + static_cast<size_t>(t & 1) * wave;
    const float* own_prev = prev + static_cast<size_t>(me) * a.local * a.P;

    // the table entries of the step's first task, loaded before the wait
    const size_t row0 = (static_cast<size_t>(me) * a.H + t) * a.local;
    TaskEntries next = load_entries(a.idx, a.mask, a.base, a.iters, row0,
                                    a.R, a.max_iters);

    // 1. wait for every word of the t-1 puts of every active offset
    if (t > 0) {
      const unsigned long long* in =
          a.inbox + (static_cast<size_t>(me) * a.H + (t - 1)) * nin * a.P;
      for (int e = threadIdx.x; e < nin * a.P; e += kThreads) {
        const unsigned v = wait_word(in + e, t, a.wait_timeout_ns);
        if (e % a.P == 3)
          s_in[e / a.P] = static_cast<int>(__uint_as_float(v));
      }
    }
    __syncthreads();

    // 2. the rank's tasks
    for (int i = 0; i < a.local; ++i) {
      const int task = me * a.local + i;
      const size_t row = row0 + i;
      const TaskEntries e = next;  // the next task's, one task ahead
      if (i + 1 < a.local)
        next = load_entries(a.idx, a.mask, a.base, a.iters, row + 1, a.R,
                            a.max_iters);
      if (threadIdx.x < 32) {
        const int part = warp_combine(
            e, a.idx + row * a.R, a.mask + row * a.R, t > 0 ? a.R : 0,
            [&](int k) {
              if (k < nin) return s_in[k];
              return static_cast<int>(
                  own_prev[static_cast<size_t>(k - nin) * a.P + 3]);
            });
        if (threadIdx.x == 0) s_acc = part;
      }
      __syncthreads();
      const int acc = s_acc;

      const int base = e.base, n = e.n;
      const int combined = (base + acc) & kChecksumMask;
      const float seed = __fmul_rn(static_cast<float>(acc), kFoldBlock);
      float* scr = a.scratch + static_cast<size_t>(task) * a.scratch_stride;
      const float res = run_body<kThreads>(a.kind, seed, n, scr, a.mxu_w,
                                           a.span, a.size, a.wide);
      write_payload<kThreads>(cur + static_cast<size_t>(task) * a.P, a.P, t,
                              task, base, combined, res);
      __syncthreads();  // s_acc is rewritten by the next task
    }

    // 3. the puts, each element a tagged word
    if (t < a.H - 1) {
      const float* own_cur = cur + static_cast<size_t>(me) * a.local * a.P;
      const int* rows = a.send_rows + static_cast<size_t>(me) * nin;
      for (int e = threadIdx.x; e < nin * a.P; e += kThreads) {
        const int slot = e / a.P, s = e % a.P;
        const int dst = (me + a.offsets[slot / a.cap]) % a.ranks;
        const size_t at = (static_cast<size_t>(dst) * a.H + t) * nin + slot;
        store_word(a.inbox + at * a.P + s, t + 1,
                   __float_as_uint(
                       own_cur[static_cast<size_t>(rows[slot]) * a.P + s]));
      }
    }
  }
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
    float* waves, float* scratch, long long scratch_stride,
    unsigned long long* inbox, int kind, int ranks, int H, int local, int R,
    int P, int n_off, int cap, int max_iters, int span, int size, int wide,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ranks == 0 || local == 0 || H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t nin = static_cast<size_t>(n_off) * cap;
  if (nin > 0) {
    err = cudaMemsetAsync(
        inbox, 0, static_cast<size_t>(ranks) * H * nin * P * sizeof(*inbox),
        s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  OnesidedArgs args{idx,    mask,  iters,     base,  send_rows,
                    offsets, mxu_w, waves,    scratch,
                    scratch_stride, inbox,    kind,  ranks,
                    H,      local, R,         P,     n_off,
                    cap,    max_iters, span,  size,  wide != 0,
                    taskbench::wait_timeout_ns(kind, H, local, max_iters,
                                               span, size)};
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(onesided_kernel),
                                    dim3(ranks), dim3(kThreads), params,
                                    nin * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
