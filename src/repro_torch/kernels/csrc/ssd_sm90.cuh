// K6, bf16 path: the Mamba-2 SSD chunked forward on Hopper's tensor cores
// (sm_90a), in three passes over a chunk-parallel grid.
//
// Replaces src/repro/kernels/ssd.py::_ssd_kernel (the Pallas TPU kernel
// behind ssd_chunked) for bf16 x, B and C with P <= 64 and N <= 128; other
// inputs take the SIMT kernel of ssd.cu.  The function is that file's: for
// each chunk of Q positions, cum = cumsum(dt A), y = (C B^T o exp(cum_i -
// cum_j) [j <= i]) @ (x dt) + (C exp(cum)) @ h^T, h = exp(cum_last) h +
// x^T @ (B exp(cum_last - cum) dt), from a zero state; y in bf16, the final
// (P, N) state in float32.
//
// Bound on the H100: bytes.  At the full-width Mamba-2 2.7B prefill (B=1,
// S=1024, H=80, P=64, G=1, N=128, chunk 128) the function reads x, B, C,
// dt and A and writes y and the state once: 24.4 MB, 0.0073 ms at 3.35
// TB/s.  Its 4.71 GFLOP take 0.0044 ms at the bf16 tensor-core peak, so
// the products go to the tensor cores and the design spends its effort on
// filling the card and on the bytes each CTA moves.
//
// Design, three kernels on the caller's stream (one wrapper call):
//   (a) ssd_chunked_state_kernel, one CTA per (batch, head, chunk): the
//       chunk's cum (a warp scan: 4 values a lane, then shuffles), the
//       decay exp(cum_last), and the chunk's local state x^T @ (B w),
//       w_j = exp(cum_last - cum_j) dt_j, on wgmma (one warpgroup a
//       64-column box of N) into the float32 scratch hs (B, H, nc, P, N).
//   (b) ssd_chunked_pass_kernel, parallel over (batch, head, P N / 4) and
//       serial over the chunks (four chunks' loads in flight): h_in[c + 1]
//       = exp(cum_last[c]) h_in[c] + local[c] in float32, h_in[c] stored
//       as its two bf16 terms into the scratch hin (h_in[0] = 0 is not
//       stored), and the final state.  The scratch (42 MB at S=1024) is
//       the traffic above the bound; it mostly stays in the 50 MB L2.
//   (c) ssd_chunked_scan_kernel, one CTA (a warpgroup) per (batch, head,
//       chunk, 64-row half of the chunk): the inter term (C @ h_in^T)
//       exp(cum_i), then for each 64-key block on or below the diagonal
//       the scores C B^T, scaled by exp(cum_i - cum_j) dt_j in registers
//       (j <= i only: above the diagonal the exponent is positive and
//       could overflow), and scores @ x accumulated on top; y stored from
//       the accumulator.  Second halves (two key blocks) go first.
//   So a 1024-token prefill is 640 CTAs in (a) and 1280 in (c), not 80 as
//   with the SIMT kernel; a one-chunk prompt of 128 tokens is 80 and 160
//   (37 tokens: 80 and 80; P is not split).
// Operands, in the layouts (B, S, H, P) and (B, S, G, N) hold them (no
// copies): C and B are K-major operands of C B^T and C h^T; x is an
// MN-major B of scores @ x (the transpose bit); B an MN-major B of the
// state product, whose A, (x w)^T, a thread builds in registers; the
// scores go from the accumulator to the A fragment in registers, as K5's P.
// Every float32 operand of a bf16 product goes as two bf16 terms, v_hi =
// bf16(v) and v_lo = bf16(v - v_hi): the scores, h_in (split by pass (b),
// both terms B operands in shared memory) and x w.  One term misses the
// card's tolerance for each of the three (tests/test_torch_ssm.py).  No
// TF32, no fast-math.
// Staging: cp.async of every operand, dt included, in 16-byte (8-byte
// where N or P is no multiple of 8) pieces into 128-byte-swizzled boxes of
// 64 bf16 columns, a thread stepping over rows; zeros wherever a row is
// past Q or a column past N or P, so that every dimension is padded to a
// box's 64 and every wgmma step runs (a runtime bound between wgmmas makes
// ptxas fence each one).  The copies are fenced to the async proxy before
// wgmma reads them.  Shared memory of (c) at N=128: the half's C 16 KB, B
// and x 48 KB, h_in 32 KB, 98 KB in all: two CTAs an SM, one loading while
// the other multiplies.
#include "sm90.cuh"  // wgmma and descriptor helpers (sm90::)

namespace ssd90 {

using sm90::fence_reg;
using sm90::make_desc;
using sm90::pack_bf16;
using sm90::smem_u32;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_rs_n64;
using sm90::wgmma_ss_n64;
using sm90::wgmma_wait_all;

constexpr int kQ = 128;  // chunk rows at most
constexpr int kThreads = 256;  // two warpgroups
constexpr int kBoxQ = kQ * 128;  // a box of 128 rows x 64 bf16 columns
constexpr int kBoxP = 64 * 128;  // a box of 64 rows (h_in: P <= 64)
constexpr int kMaxP = 64, kMaxN = 128;
constexpr uint64_t kSwizzle128 = 1;

// byte offset of (row, col) in a tile of 64-column boxes of box_bytes each:
// 128-byte rows, the 16-byte piece index XOR the row's index mod 8 (the
// layout TMA's SWIZZLE_128B writes and wgmma's 128-byte swizzle reads)
__device__ __forceinline__ uint32_t swz(int row, int col, int box_bytes) {
  return (col >> 6) * box_bytes + row * 128 +
         ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// makes this thread's generic-proxy writes of shared memory visible to the
// async proxy (wgmma's operand reads)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

struct Smem {
  uint32_t s;  // shared-window address of the 1024-aligned base
  uint8_t* g;  // the same byte as a generic pointer
};

__device__ __forceinline__ Smem aligned_smem(uint8_t* raw) {
  const uint32_t s = (smem_u32(raw) + 1023u) & ~1023u;
  return {s, raw + (s - smem_u32(raw))};
}

// rows [0, tile_rows) and columns [0, 64 nbox) of a tile of boxes of
// box_bytes at byte offset `tile`: element (r, c) is src[r stride + c] for
// r < rows and c < cols (copied in pieces of vec elements, 8 or 4), zero
// elsewhere
__device__ __forceinline__ void load_tile(Smem sm, uint32_t tile,
                                          int box_bytes, int nbox,
                                          int tile_rows,
                                          const __nv_bfloat16* src,
                                          size_t stride, int rows, int cols,
                                          int vec) {
  // a thread keeps one column piece and steps over rows: no division in
  // the loop (starting these copies is the longest phase of a CTA)
  const int per_row = nbox * 64 / vec;  // 8, 16 or 32: divides blockDim.x
  const int c = (threadIdx.x % per_row) * vec;
  const int r_step = blockDim.x / per_row;
  const size_t g_step = r_step * stride;
  const __nv_bfloat16* g = src + (threadIdx.x / per_row) * stride + c;
  for (int r = threadIdx.x / per_row; r < tile_rows; r += r_step) {
    const uint32_t off = tile + swz(r, c, box_bytes);
    if (r < rows && c < cols) {
      cp_async(sm.s + off, g, 2 * vec);
    } else if (vec == 8) {
      *reinterpret_cast<uint4*>(sm.g + off) = make_uint4(0, 0, 0, 0);
    } else {
      *reinterpret_cast<uint2*>(sm.g + off) = make_uint2(0, 0);
    }
    g += g_step;
  }
}

// dt of the chunk's rows into the floats at byte offset `at` (0 past Q)
__device__ __forceinline__ void load_dt(Smem sm, uint32_t at, const float* dt,
                                        size_t row0, int H, int h, int Q) {
  for (int q = threadIdx.x; q < kQ; q += blockDim.x) {
    if (q < Q)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       sm.s + at + 4 * q),
                   "l"(dt + (row0 + q) * H + h)
                   : "memory");
    else
      reinterpret_cast<float*>(sm.g + at)[q] = 0.f;
  }
}

// Inclusive cumsum of dt a over kQ rows by warp 0: lane l sums its four
// rows in order, a Hillis-Steele scan adds the lanes' totals, and each row
// adds the total of the lanes before its own.  Rounded adds and products
// (no contraction), so both passes get the same cum and the CPU emulation
// can take the same order.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a,
                                             float* cum) {
  const int lane = threadIdx.x % 32;
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float la = __fmul_rn(dts[4 * lane + k], a);
    run = k == 0 ? la : __fadd_rn(run, la);
    v[k] = run;
  }
  float t = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float o = __shfl_up_sync(0xffffffffu, t, off);
    if (lane >= off) t = __fadd_rn(t, o);
  }
  float before = __shfl_up_sync(0xffffffffu, t, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) cum[4 * lane + k] = __fadd_rn(before, v[k]);
}

// the bf16 pair of (v0, v1) and of what it leaves over
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(hv);
  hi = pack_bf16(hv);
  lo = pack_bf16(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// What a CTA of pass (a) or (c) works on: chunk c of head h of batch row b
// (and in pass (c) the 64-row half of the chunk)
struct Chunk {
  int b, h, g, c, half;
  size_t row0;  // first position: b S + c Q
};

// CTA blockIdx.x of a grid of (batch, chunk, halves, head), heads fastest
// (a chunk's B and C stay in L2), the heavier second half of a chunk first
__device__ __forceinline__ Chunk chunk_of(int S, int H, int G, int Q, int nc,
                                          int halves) {
  Chunk k;
  k.h = blockIdx.x % H;
  int rest = blockIdx.x / H;
  k.half = halves - 1 - rest % halves;
  rest /= halves;
  k.c = rest % nc;
  k.b = rest / nc;
  k.g = k.h / (H / G);
  k.row0 = static_cast<size_t>(k.b) * S + static_cast<size_t>(k.c) * Q;
  return k;
}

// ---------------------------------------------------------------- pass (a)
// shared memory: B (NB boxes), x (one box), then dt, cum and w (kQ each)
template <int NB>
struct StateSmem {
  static constexpr int kB = 0, kX = NB * kBoxQ, kF = kX + kBoxQ;
  static constexpr int kBytes = kF + 3 * kQ * 4 + 1024;
};

template <int NB>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunked_state_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    float* __restrict__ hs, float* __restrict__ decay, int S, int H, int P,
    int G, int N, int Q, int nc, int vec_x, int vec_bc) {
  using L = StateSmem<NB>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = aligned_smem(smem_raw);
  float* dts = reinterpret_cast<float*>(sm.g + L::kF);
  float* cum = dts + kQ;
  float* wts = cum + kQ;
  const Chunk k = chunk_of(S, H, G, Q, nc, 1);
  const float a = A[k.h];

  load_tile(sm, L::kB, kBoxQ, NB, kQ, Bm + k.row0 * G * N + k.g * N,
            static_cast<size_t>(G) * N, Q, N, vec_bc);
  load_tile(sm, L::kX, kBoxQ, 1, kQ, x + k.row0 * H * P + k.h * P,
            static_cast<size_t>(H) * P, Q, P, vec_x);
  load_dt(sm, L::kF, dt, k.row0, H, k.h, Q);
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum(dts, a, cum);
  __syncthreads();
  const float last = cum[Q - 1];
  for (int q = threadIdx.x; q < kQ; q += kThreads)
    wts[q] = q < Q ? __fmul_rn(expf(__fsub_rn(last, cum[q])), dts[q]) : 0.f;
  const size_t bhc = (static_cast<size_t>(k.b) * H + k.h) * nc + k.c;
  if (threadIdx.x == 0) decay[bhc] = expf(last);
  __syncthreads();

  // warpgroup w: state rows p (A rows) by the columns of N's box w
  const int wg = threadIdx.x / 128;
  if (wg >= NB) return;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int p_a = 16 * warp + lane / 4;
  // A = (x w)^T as fragments of 16-row steps of the chunk, two bf16 terms:
  // register i holds row p_a (i even) or p_a + 8, columns j and j + 1
  uint32_t a_hi[kQ / 16][4], a_lo[kQ / 16][4];
  const uint8_t* xs = sm.g + L::kX;
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p_a + 8 * (i % 2);
      const int j = 16 * kk + 8 * (i / 2) + 2 * (lane % 4);
      const float x0 = __bfloat162float(
          *reinterpret_cast<const __nv_bfloat16*>(xs + swz(j, p, kBoxQ)));
      const float x1 = __bfloat162float(
          *reinterpret_cast<const __nv_bfloat16*>(xs + swz(j + 1, p, kBoxQ)));
      split2(__fmul_rn(x0, wts[j]), __fmul_rn(x1, wts[j + 1]), a_hi[kk][i],
             a_lo[kk][i]);
    }
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_reg(acc[i]);
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fence_reg(a_hi[kk][i]);
      fence_reg(a_lo[kk][i]);
    }
  wgmma_fence();
  // every step, rows past Q included (zeros): a runtime bound between the
  // wgmmas makes ptxas fence each one
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    // B rows j = 16 kk.., columns n of box wg: MN-major (transposed)
    const uint64_t db = make_desc(sm.s + L::kB + wg * kBoxQ + kk * 16 * 128,
                                  kBoxQ, 1024, kSwizzle128);
    wgmma_rs_n64(acc, a_hi[kk], db);
    wgmma_rs_n64(acc, a_lo[kk], db);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_reg(acc[i]);

  float* out = hs + bhc * P * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = p_a + 8 * half;
    if (p >= P) continue;
#pragma unroll
    for (int gi = 0; gi < 8; ++gi) {
      const int n = 64 * wg + 8 * gi + 2 * (lane % 4);
      if (n < N)
        *reinterpret_cast<float2*>(out + p * N + n) =
            make_float2(acc[4 * gi + 2 * half], acc[4 * gi + 2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------- pass (b)
constexpr int kPassThreads = 256;
constexpr int kAhead = 4;  // chunks a thread of pass (b) loads at once

// h_in[c] for c >= 1 as its two bf16 terms into hin (batch, H, nc, 2, P,
// N), the final state to `state`; a thread carries four consecutive (p, n)
// of one (batch, head)
__global__ void __launch_bounds__(kPassThreads) ssd_chunked_pass_kernel(
    const float* __restrict__ hs, const float* __restrict__ decay,
    __nv_bfloat16* __restrict__ hin, float* __restrict__ state, int PN4,
    int nc, int blocks_per_head) {
  const int bh = blockIdx.x / blocks_per_head;
  const int e = (blockIdx.x % blocks_per_head) * kPassThreads + threadIdx.x;
  if (e >= PN4) return;
  const float4* hp = reinterpret_cast<const float4*>(hs) +
                     static_cast<size_t>(bh) * nc * PN4 + e;
  uint2* out = reinterpret_cast<uint2*>(hin) +
               static_cast<size_t>(bh) * nc * 2 * PN4 + e;
  const float* d = decay + static_cast<size_t>(bh) * nc;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  // kAhead chunks' loads in flight at a time: the chain waits once a group
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 l[kAhead];
    float dc[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u < nc) {
        l[u] = hp[static_cast<size_t>(c0 + u) * PN4];
        dc[u] = d[c0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + u;
      if (c >= nc) break;
      if (c > 0) {
        uint2 hi, lo;
        split2(h.x, h.y, hi.x, lo.x);
        split2(h.z, h.w, hi.y, lo.y);
        out[static_cast<size_t>(c) * 2 * PN4] = hi;
        out[static_cast<size_t>(c) * 2 * PN4 + PN4] = lo;
      }
      // exp(cum_last) h + local, rounded as the plain version rounds it
      h = make_float4(__fadd_rn(__fmul_rn(dc[u], h.x), l[u].x),
                      __fadd_rn(__fmul_rn(dc[u], h.y), l[u].y),
                      __fadd_rn(__fmul_rn(dc[u], h.z), l[u].z),
                      __fadd_rn(__fmul_rn(dc[u], h.w), l[u].w));
    }
  }
  reinterpret_cast<float4*>(state)[static_cast<size_t>(bh) * PN4 + e] = h;
}

// ---------------------------------------------------------------- pass (c)
// shared memory: the half's 64 rows of C (NB boxes of 64 rows), B and x
// (NB boxes and one of 128 rows: the rows up to the half's end are loaded),
// h_in's two terms (NB boxes of 64 rows each), then dt and cum
template <int NB>
struct ScanSmem {
  static constexpr int kC = 0, kB = NB * kBoxP, kX = kB + NB * kBoxQ;
  static constexpr int kHhi = kX + kBoxQ, kHlo = kHhi + NB * kBoxP;
  static constexpr int kF = kHlo + NB * kBoxP;
  static constexpr int kBytes = kF + 2 * kQ * 4 + 1024;
};

constexpr int kScanThreads = 128;  // one warpgroup: 64 rows of a chunk

template <int NB>
__global__ void __launch_bounds__(kScanThreads, 2) ssd_chunked_scan_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    const __nv_bfloat16* __restrict__ Cm,
    const __nv_bfloat16* __restrict__ hin, __nv_bfloat16* __restrict__ y,
    int S, int H, int P, int G, int N, int Q, int nc, int vec_x, int vec_bc) {
  using L = ScanSmem<NB>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = aligned_smem(smem_raw);
  float* dts = reinterpret_cast<float*>(sm.g + L::kF);
  float* cum = dts + kQ;
  const Chunk k = chunk_of(S, H, G, Q, nc, (Q + 63) / 64);
  const int r0 = 64 * k.half;  // this CTA's chunk rows [r0, r0 + 64)
  const int r1 = r0 + 64;
  const float a = A[k.h];

  const size_t bc_off = k.row0 * G * N + k.g * N;
  const size_t bc_row = static_cast<size_t>(G) * N;
  load_tile(sm, L::kC, kBoxP, NB, 64, Cm + bc_off + r0 * bc_row, bc_row,
            Q - r0, N, vec_bc);
  load_tile(sm, L::kB, kBoxQ, NB, r1, Bm + bc_off, bc_row, Q, N, vec_bc);
  load_tile(sm, L::kX, kBoxQ, 1, r1, x + k.row0 * H * P + k.h * P,
            static_cast<size_t>(H) * P, Q, P, vec_x);
  load_dt(sm, L::kF, dt, k.row0, H, k.h, Q);
  if (k.c > 0) {
    // h_in's two bf16 terms (P, N) each: K-major B operands, rows p
    const __nv_bfloat16* h2 =
        hin + ((static_cast<size_t>(k.b) * H + k.h) * nc + k.c) * 2 * P * N;
    load_tile(sm, L::kHhi, kBoxP, NB, 64, h2, N, P, N, vec_bc);
    load_tile(sm, L::kHlo, kBoxP, NB, 64, h2 + P * N, N, P, N, vec_bc);
  }
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum(dts, a, cum);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_a = r0 + 16 * warp + lane / 4, row_b = row_a + 8;
  const float cum_a = cum[row_a], cum_b = cum[row_b];
  // the half's C rows, K-major, at step kk (of 16 columns: every step of
  // the NB boxes runs, columns past N are zeros)
  auto c_desc = [&](int kk) {
    return make_desc(sm.s + L::kC + (kk / 4) * kBoxP + (kk % 4) * 32, 16,
                     1024, kSwizzle128);
  };

  float acc[32];  // y rows row_a / row_b, columns 8 gi + 2 (lane % 4)
  if (k.c > 0) {
    // inter: (C h_in^T)(i, p) = sum_n C_in (h_hi + h_lo)_pn, then exp(cum_i)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      wgmma_ss_n64(acc, c_desc(kk),
                   make_desc(sm.s + L::kHhi + (kk / 4) * kBoxP + (kk % 4) * 32,
                             16, 1024, kSwizzle128),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      wgmma_ss_n64(acc, c_desc(kk),
                   make_desc(sm.s + L::kHlo + (kk / 4) * kBoxP + (kk % 4) * 32,
                             16, 1024, kSwizzle128),
                   1);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(acc[i]);
    const float e_a = expf(cum_a), e_b = expf(cum_b);
#pragma unroll
    for (int gi = 0; gi < 8; ++gi) {
      acc[4 * gi] *= e_a;
      acc[4 * gi + 1] *= e_a;
      acc[4 * gi + 2] *= e_b;
      acc[4 * gi + 3] *= e_b;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  }

  // intra: 64-key blocks jb <= half (the rest lie above the diagonal)
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    if (jb > k.half) break;
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      wgmma_ss_n64(s, c_desc(kk),
                   make_desc(sm.s + L::kB + (kk / 4) * kBoxQ + 64 * jb * 128 +
                                 (kk % 4) * 32,
                             16, 1024, kSwizzle128),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(s[i]);

    // s_ij exp(cum_i - cum_j) dt_j for j <= i, else 0
    const bool diag = jb == k.half;
#pragma unroll
    for (int gi = 0; gi < 8; ++gi) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 64 * jb + 8 * gi + 2 * (lane % 4) + e;
        const float cj = cum[j], dj = dts[j];
        float& sa = s[4 * gi + e];
        float& sb = s[4 * gi + 2 + e];
        sa = (!diag || j <= row_a)
                 ? __fmul_rn(__fmul_rn(sa, expf(__fsub_rn(cum_a, cj))), dj)
                 : 0.f;
        sb = (!diag || j <= row_b)
                 ? __fmul_rn(__fmul_rn(sb, expf(__fsub_rn(cum_b, cj))), dj)
                 : 0.f;
      }
    }
    // the scores as A fragments of four 16-key steps, two bf16 terms
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int at = 4 * (2 * kk + i / 2) + 2 * (i % 2);
        split2(s[at], s[at + 1], p_hi[kk][i], p_lo[kk][i]);
      }
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(acc[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fence_reg(p_hi[kk][i]);
        fence_reg(p_lo[kk][i]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // x rows j = 64 jb + 16 kk.., columns p: MN-major (transposed)
      const uint64_t dx = make_desc(sm.s + L::kX + (64 * jb + 16 * kk) * 128,
                                    kBoxQ, 1024, kSwizzle128);
      wgmma_rs_n64(acc, p_hi[kk], dx);
      wgmma_rs_n64(acc, p_lo[kk], dx);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(acc[i]);
  }

  const size_t x_pos = static_cast<size_t>(H) * P;
  __nv_bfloat16* yb = y + k.row0 * x_pos + static_cast<size_t>(k.h) * P;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int i = side == 0 ? row_a : row_b;
    if (i >= Q) continue;
    __nv_bfloat16* dst = yb + i * x_pos;
#pragma unroll
    for (int gi = 0; gi < 8; ++gi) {
      const int p = 8 * gi + 2 * (lane % 4);
      if (p < P)
        *reinterpret_cast<__nv_bfloat162*>(dst + p) = __floats2bfloat162_rn(
            acc[4 * gi + 2 * side], acc[4 * gi + 2 * side + 1]);
    }
  }
}

// -------------------------------------------------------------------- host
template <int NB>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, float* hs, float* decay,
           void* hin, int batch, int S, int H, int P, int G, int N, int chunk,
           cudaStream_t stream) {
  auto state_k = ssd_chunked_state_kernel<NB>;
  auto scan_k = ssd_chunked_scan_kernel<NB>;
  cudaError_t err = cudaFuncSetAttribute(
      state_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      StateSmem<NB>::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(scan_k,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ScanSmem<NB>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = S / chunk;
  const long long ctas = static_cast<long long>(batch) * H * nc;
  const long long scan_ctas = ctas * ((chunk + 63) / 64);
  const int PN4 = P * N / 4;
  const int per_head = (PN4 + kPassThreads - 1) / kPassThreads;
  if (scan_ctas > INT_MAX ||
      static_cast<long long>(batch) * H * per_head > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // 16-byte pieces where rows are whole multiples of 8 elements and the
  // data 16-byte aligned, else 8-byte ones
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = P % 8 == 0 && a16(x) ? 8 : 4;
  const int vec_bc = N % 8 == 0 && a16(Bm) && a16(Cm) ? 8 : 4;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(Bm);
  const auto* cb = static_cast<const __nv_bfloat16*>(Cm);
  state_k<<<static_cast<unsigned>(ctas), kThreads, StateSmem<NB>::kBytes,
            stream>>>(xb, dt, A, bb, hs, decay, S, H, P, G, N, chunk, nc,
                      vec_x, vec_bc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunked_pass_kernel<<<static_cast<unsigned>(batch * H * per_head),
                            kPassThreads, 0, stream>>>(
      hs, decay, static_cast<__nv_bfloat16*>(hin), state, PN4, nc, per_head);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_k<<<static_cast<unsigned>(scan_ctas), kScanThreads,
           ScanSmem<NB>::kBytes, stream>>>(
      xb, dt, A, bb, cb, static_cast<const __nv_bfloat16*>(hin),
      static_cast<__nv_bfloat16*>(y), S, H, P, G, N, chunk, nc, vec_x,
      vec_bc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd90
