// Tagged signal words shared by K3 (fused.cu) and K4 (onesided.cu).
//
// A word is 64 bits: a 32-bit tag in the high half and a 32-bit value in
// the low half, written by one relaxed 64-bit store through L2, so a reader
// that sees the tag sees the value of the same store (NCCL's "LL"
// protocol).  No fence and no separate flag: the word is the data and its
// own readiness.  A word is written once per launch (its tag names the
// timestep that wrote it), and the launch zeroes the words first with a
// memset on its stream, so tag 0 means "not yet written".
//
// Every wait is bounded: one that outlasts its launch's deadlock guard
// traps, which ends the launch with an error instead of hanging the card on
// a word that never comes (a wrong table, a CTA that is not resident).
#pragma once

#include <cuda_runtime.h>

#include "bodies.cuh"

namespace taskbench {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// One relaxed, device-scope 64-bit load: it goes to L2, never to a stale
// L1 line, and the compiler may neither cache nor hoist it.
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* word) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(w) : "l"(word) : "memory");
  return w;
}

__device__ __forceinline__ void store_word(unsigned long long* word,
                                           unsigned tag, unsigned value) {
  const unsigned long long w =
      (static_cast<unsigned long long>(tag) << 32) | value;
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(word), "l"(w) : "memory");
}

// Spin until `word` carries `tag`, trapping after timeout_ns; returns the
// value the same store wrote.  The clock is read on every 64th poll only, so
// a poll costs one L2 trip.  kNoteLate (K3's traced instance) also sets
// *late when the first poll finds the word not yet written.
template <bool kNoteLate = false>
__device__ __forceinline__ unsigned wait_word(const unsigned long long* word,
                                              unsigned tag,
                                              unsigned long long timeout_ns,
                                              bool* late = nullptr) {
  unsigned long long w = load_word(word);
  if (static_cast<unsigned>(w >> 32) != tag) {
    if constexpr (kNoteLate) *late = true;
    const unsigned long long start = global_ns();
    for (unsigned polls = 1;; ++polls) {
      w = load_word(word);
      if (static_cast<unsigned>(w >> 32) == tag) break;
      if (polls % 64 == 0 && global_ns() - start > timeout_ns) __trap();
    }
  }
  return static_cast<unsigned>(w);
}

// The deadlock guard of one launch in ns: 20 s plus H x `tasks` (the most
// tasks one CTA runs a timestep) x a ceiling on one task of `kind` at
// max_iters iterations.  The ceiling is 1 ms, plus per iteration 100 us
// (compute), 10 ms (compute_mxu, a 128^3 product) or 100 ns an element of
// the window (memory), plus 100 ns an element of the scratch fill.  No wait
// of a legal run lasts longer than the whole launch, and the launch ends
// within H steps of `tasks` tasks each: when every CTA has finished
// timestep t, every CTA has its t inputs.  The ceiling is 100x or more
// above a task's time on the H100, even with several CTAs sharing an SM, so
// only a word that is never written reaches it.
inline unsigned long long wait_timeout_ns(int kind, int H, int tasks,
                                          int max_iters, int span, int size) {
  double per_iter = 0.0, fill = 0.0;
  if (kind == kCompute) per_iter = 1e5;
  if (kind == kComputeMxu) per_iter = 1e7;
  if (kind == kMemory) per_iter = 100.0 * span, fill = 100.0 * size;
  const double task = 1e6 + fill + per_iter * (max_iters > 0 ? max_iters : 0);
  const double ns = 20e9 + static_cast<double>(H) * tasks * task;
  return static_cast<unsigned long long>(ns < 9e18 ? ns : 9e18);
}

}  // namespace taskbench
