// K5, bf16 path: FlashAttention forward on Hopper's tensor cores (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel behind flash_attention) for bf16 q, k and v; float32 inputs
// take the SIMT kernel of flash_attention.cu.  The function is that
// file's: o[b, i, h] = sum_j softmax_j(scale q_i . k_j where allowed) v_j,
// GQA, causal mask and window on positions q_offset + i and j, masked
// scores -1e30, a query with no allowed key gives 0, softmax in float32.
//
// Bound on the H100: operations.  Every allowed (query, key) pair costs
// 4 D flops against 2 D bf16 inputs a key shared by a CTA's 128 queries;
// at the full-width RecurrentGemma-2B prefill (B=1, Hq=10, Hkv=1, D=256,
// window 2048, S=3000) that is 41.4 GFLOP against ~34 MB, 0.039 ms at the
// bf16 tensor-core peak and 0.010 ms of HBM.
//
// Design (one CTA per 128 query rows of one head, 384 threads):
//   - Warp specialisation: warpgroup 0 is the producer (setmaxnreg 24), one
//     thread of which issues every TMA load; warpgroups 1 and 2 are the
//     consumers (setmaxnreg 240), 64 query rows each.  ptxas budgets each
//     role at its setmaxnreg only while the producer fits its 24
//     registers: keep it lean (a clock-bounded barrier wait made D=256
//     spill and serialise its wgmmas).
//   - TMA: q, k and v are 4-D tensor maps over (D, H, S, B) in the layout
//     ops.attention holds, encoded on the host at every call.  A tile
//     arrives as boxes of 64 rows x min(D, 64) columns (128 or 64 bytes a
//     row, the swizzle span), 128- or 64-byte swizzled as wgmma's K-major
//     canonical layout expects.  q is loaded once; k and v tiles of 64 keys
//     go through a ring of kStages stages, each with a "full" mbarrier
//     (TMA bytes) and an "empty" one (one arrival a consumer warp).  Rows
//     past S are zero-filled by TMA (a q box wholly past Sq is not
//     loaded); keys past Skv are masked.
//   - S = Q K^T on wgmma m64n64k16, both operands from shared memory and
//     K-major (rows are D-contiguous: no transpose), f32 accumulate; the
//     scores are scaled after the product.
//   - O += P V on wgmma with P from registers (the accumulator layout of S
//     is the A-fragment layout) and V as an MN-major operand from shared
//     memory (the transpose bit bf16 allows: no transpose copy).  P goes to
//     the tensor cores as two bf16 terms, P_hi = bf16(p) and P_lo =
//     bf16(p - P_hi), so its rounding error is ~2^-17 of p, not 2^-9 (one
//     bf16 term misses the tolerance: tests/test_torch_attention.py); the
//     row sum l adds the float32 p.  That is 1.5x the function's products.
//   - Online softmax in registers, in log2 units (the scale times log2(e)
//     applied after the product, exp2f): a thread owns two rows; row max
//     and sum are reduced over the four threads of a row.  A masked row
//     stays at m = -1e30, p = 0, alpha = 0 and outputs 0, as the SIMT
//     kernel's.
//   - Tiles outside the CTA's causal/window band are not loaded; a tile
//     outside one warpgroup's band is skipped by it (exact: a masked tile
//     leaves m, l and acc unchanged); only tiles on the band's edges or
//     past Skv are masked element by element.
//   - Causal CTAs are issued heaviest first (last q blocks first), so the
//     tail of the grid is short.
//   - D = 80 (HuBERT X-Large's heads), no multiple of the 64-column box:
//     the tiles are two boxes wide, 128 columns, the second box over
//     columns 64..127 of a tensor map whose inner dimension is 80, so TMA
//     zero-fills columns 80..127.  S = Q K^T steps over the 80 columns
//     only (five k16 steps, exact); O += P V runs both 64-column chunks as
//     at D = 128 and stores 80 columns.  Of the products issued a tile,
//     64 x 64 x (80 + 2 x 128), the function needs 64 x 64 x 3 x 80: 1.4x
//     (the P V products alone: 1.6x).  A 16-column tail box with a 32-byte
//     swizzle would issue the exact shape.
// Shared memory: q 128 C, kStages x (k, v) 64 C bf16, C = D padded to whole
// boxes: 192 KB at D=256 with 2 stages; 4 stages below.  Registers, a
// consumer thread at D=256: 128 of accumulator, 32 of scores, 32 of P's two
// parts.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "sm90.cuh"  // wgmma and descriptor helpers

namespace sm90 {

constexpr int kBQ = 128;  // query rows a CTA
constexpr int kWgRows = 64;  // query rows a consumer warpgroup
constexpr int kBK = 64;  // keys a tile
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kNegInf = -1e30f;

template <int D>
struct Tiles {
  static constexpr int kBox = D < 64 ? D : 64;  // columns a TMA box
  static constexpr int kBoxes = (D + kBox - 1) / kBox;
  static constexpr int kCols = kBoxes * kBox;  // D padded to whole boxes
  static_assert(kCols >= D && kCols - kBox < D,
                "the boxes of a row must cover D, none of them wholly past it");
  static_assert(D % 16 == 0,
                "S = Q K^T steps over D in k16 steps and o is stored in "
                "8-column groups: both must cover D exactly");
  static constexpr int kRowBytes = 2 * kBox;  // 128 or 64: the swizzle span
  static constexpr int kBoxBytes = 64 * kRowBytes;  // a box: 64 rows
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr int kQBytes = kBQ * kCols * 2;
  static constexpr int kTileBytes = kBK * kCols * 2;  // one k or v tile
  // tiles, then the barriers (q, kStages full, kStages empty), plus 1024
  // bytes to align the base for the 128-byte swizzle
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 2 * kStages) + 1024;
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;
};

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// waits for the phase of `parity` to complete (a plain try_wait loop: a
// clock-bounded one costs the producer's 24 registers a spill)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------------ kernel
// What a CTA works on: one head of one batch row, query rows [q0, q0 + 128),
// key tiles k_begin + 64 i for i < ntiles, and where its shared memory is
struct Block {
  int b, h, hk, q0, k_begin, ntiles;
  uint32_t sQ, sK, sV, q_bar, full_bar, empty_bar;
};

// The producer: one thread loads q once, then each k and v tile into the
// next free stage of the ring.
template <int D>
__device__ __forceinline__ void produce(const Block& blk, const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int Sq) {
  using T = Tiles<D>;
  // q rows of the warpgroups that have any row in Sq
  const int q_wgs = min(kConsumers, (Sq - blk.q0 + kWgRows - 1) / kWgRows);
  mbar_expect_tx(blk.q_bar, q_wgs * T::kBoxes * T::kBoxBytes);
  for (int w = 0; w < q_wgs; ++w)
    for (int j = 0; j < T::kBoxes; ++j)
      tma_load(blk.sQ + (w * T::kBoxes + j) * T::kBoxBytes, tq, blk.q_bar,
               j * T::kBox, blk.h, blk.q0 + w * kWgRows, blk.b);
  for (int it = 0; it < blk.ntiles; ++it) {
    const int st = it % T::kStages;
    // round r waits for the consumers' release of round r - 1 (round 0
    // passes at once)
    mbar_wait(blk.empty_bar + 8 * st, ((it / T::kStages) & 1) ^ 1);
    const uint32_t full = blk.full_bar + 8 * st;
    mbar_expect_tx(full, 2 * T::kTileBytes);
    const int k0 = blk.k_begin + it * kBK;
    for (int j = 0; j < T::kBoxes; ++j) {
      tma_load(blk.sK + st * T::kTileBytes + j * T::kBoxBytes, tk, full,
               j * T::kBox, blk.hk, k0, blk.b);
      tma_load(blk.sV + st * T::kTileBytes + j * T::kBoxBytes, tv, full,
               j * T::kBox, blk.hk, k0, blk.b);
    }
  }
}

// A consumer warpgroup: 64 query rows (w = 0 or 1 of the CTA's two) through
// every tile, then o.  A thread owns rows row_a and row_a + 8.
template <int D>
__device__ __forceinline__ void consume(const Block& blk, int w,
                                        __nv_bfloat16* __restrict__ o, int Sq,
                                        int Skv, int Hq, float scale_log2,
                                        int causal, int has_window,
                                        int window, int q_offset) {
  using T = Tiles<D>;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int row_a = blk.q0 + w * kWgRows + 16 * warp + lane / 4;
  const int qp_a = q_offset + row_a, qp_b = qp_a + 8;
  // this warpgroup's rows [r0, r1) and the keys they may see [wlo, whi)
  const int r0 = blk.q0 + w * kWgRows;
  const int r1 = min(r0 + kWgRows, Sq);
  int wlo = 0, whi = Skv;
  if (causal) whi = min(whi, q_offset + r1);
  if (has_window) wlo = max(wlo, q_offset + r0 - window + 1);
  if (r1 <= r0) whi = INT_MIN;  // no row of this warpgroup is in Sq

  // 64 x kCols over the warpgroup: columns 8g + 2 (lane % 4); columns past
  // D (D = 80) stay 0 and are not stored
  float acc[T::kCols / 2];
#pragma unroll
  for (int i = 0; i < T::kCols / 2; ++i) acc[i] = 0.f;
  // m is kept in log2 units: exp(x - m) = exp2(x log2(e) - m log2(e))
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  const uint32_t qw = blk.sQ + w * T::kBoxes * T::kBoxBytes;
  mbar_wait(blk.q_bar, 0);
  for (int it = 0; it < blk.ntiles; ++it) {
    const int st = it % T::kStages;
    mbar_wait(blk.full_bar + 8 * st, (it / T::kStages) & 1);
    const int k0 = blk.k_begin + it * kBK;
    if (k0 + kBK > wlo && k0 < whi) {
      const uint32_t kt = blk.sK + st * T::kTileBytes;
      const uint32_t vt = blk.sV + st * T::kTileBytes;
      // S = Q K^T: 64 x 64, f32
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 16 / T::kBox) * T::kBoxBytes +
                             (kk * 16 % T::kBox) * 2;
        wgmma_ss_n64(s, make_desc(qw + off, 16, 8 * T::kRowBytes, T::kSwizzle),
                     make_desc(kt + off, 16, 8 * T::kRowBytes, T::kSwizzle),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_reg(s[i]);

      // scale after the product (by scale log2(e)); mask only tiles on the
      // band's edges
      const bool inside = k0 + kBK <= Skv &&
                          (!causal || k0 + kBK - 1 <= q_offset + r0) &&
                          (!has_window || k0 > q_offset + r1 - 1 - window);
#pragma unroll
      for (int g = 0; g < 8; ++g) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& sa = s[4 * g + e];
          float& sb = s[4 * g + 2 + e];
          sa *= scale_log2;
          sb *= scale_log2;
          if (!inside) {
            const int kp = k0 + 8 * g + 2 * (lane % 4) + e;
            bool ok_a = kp < Skv, ok_b = kp < Skv;
            if (causal) {
              ok_a = ok_a && kp <= qp_a;
              ok_b = ok_b && kp <= qp_b;
            }
            if (has_window) {
              ok_a = ok_a && kp > qp_a - window;
              ok_b = ok_b && kp > qp_b - window;
            }
            sa = ok_a ? sa : kNegInf;
            sb = ok_b ? sb : kNegInf;
          }
        }
      }

      // the online softmax of the reference (_flash_kernel), rows a and b
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * g], s[4 * g + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * g + 2], s[4 * g + 3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const bool alive_a = mn_a > kNegInf / 2, alive_b = mn_b > kNegInf / 2;
      const float alpha_a = alive_a ? exp2f(m_a - mn_a) : 0.f;
      const float alpha_b = alive_b ? exp2f(m_b - mn_b) : 0.f;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& pa = s[4 * g + e];
          float& pb = s[4 * g + 2 + e];
          pa = alive_a ? exp2f(pa - mn_a) : 0.f;
          pb = alive_b ? exp2f(pb - mn_b) : 0.f;
          sum_a += pa;
          sum_b += pb;
        }
      }
      l_a = l_a * alpha_a + quad_sum(sum_a);
      l_b = l_b * alpha_b + quad_sum(sum_b);
      m_a = mn_a;
      m_b = mn_b;

      // P as A fragments of four 16-key steps, in two bf16 terms:
      // [kk][0] row a keys 16 kk + 2 (lane % 4), [1] row b, [2] and [3]
      // the same 8 keys on
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = 4 * (2 * kk + i / 2) + 2 * (i % 2);
          const float x0 = s[at], x1 = s[at + 1];
          const __nv_bfloat162 hv = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hv);
          p_hi[kk][i] = pack_bf16(hv);
          p_lo[kk][i] = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
        }
      }
#pragma unroll
      for (int g = 0; g < T::kCols / 8; ++g) {
        acc[4 * g] *= alpha_a;
        acc[4 * g + 1] *= alpha_a;
        acc[4 * g + 2] *= alpha_b;
        acc[4 * g + 3] *= alpha_b;
      }

      // O += P_hi V + P_lo V, a 64-column chunk (one V box) at a time
#pragma unroll
      for (int i = 0; i < T::kCols / 2; ++i) fence_reg(acc[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fence_reg(p_hi[kk][i]);
          fence_reg(p_lo[kk][i]);
        }
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t* a = part == 0 ? p_hi[kk] : p_lo[kk];
#pragma unroll
          for (int c = 0; c < T::kBoxes; ++c) {
            const uint64_t dv =
                make_desc(vt + c * T::kBoxBytes + kk * 16 * T::kRowBytes,
                          T::kBoxBytes, 8 * T::kRowBytes, T::kSwizzle);
            if constexpr (D == 32)
              wgmma_rs_n32(acc, a, dv);
            else
              wgmma_rs_n64(acc + 32 * c, a, dv);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < T::kCols / 2; ++i) fence_reg(acc[i]);
    }
    // release the stage: every consumer warp is past its wgmma reads
    __syncwarp();
    if (lane == 0) mbar_arrive(blk.empty_bar + 8 * st);
  }

  // o = acc / l, with l = 1 where no key was allowed (acc is 0 there)
  const size_t q_pos = static_cast<size_t>(Hq) * D;
  __nv_bfloat16* ob = o + static_cast<size_t>(blk.b) * Sq * q_pos +
                      static_cast<size_t>(blk.h) * D + 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row_a + 8 * half;
    if (r >= Sq) continue;
    const float l = half == 0 ? l_a : l_b;
    const float safe = l > 0.f ? l : 1.f;
    __nv_bfloat16* dst = ob + static_cast<size_t>(r) * q_pos;
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * g) = __floats2bfloat162_rn(
          acc[4 * g + 2 * half] / safe, acc[4 * g + 2 * half + 1] / safe);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_sm90_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    int Sq, int Skv, int Hq, int Hkv, int nq, float scale_log2, int causal,
    int has_window, int window, int q_offset) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  Block blk;
  blk.sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  blk.sK = blk.sQ + T::kQBytes;
  blk.sV = blk.sK + T::kStages * T::kTileBytes;
  blk.q_bar = blk.sV + T::kStages * T::kTileBytes;
  blk.full_bar = blk.q_bar + 8;  // + 8 stage
  blk.empty_bar = blk.full_bar + 8 * T::kStages;

  // heads fastest, so the heavy q blocks of every head come first
  blk.h = blockIdx.x % Hq;
  const int qb_order = blockIdx.x / Hq;
  blk.q0 = (causal ? nq - 1 - qb_order : qb_order) * kBQ;
  blk.b = blockIdx.y;
  blk.hk = blk.h / (Hq / Hkv);

  // the keys any row of this CTA may see: [lo, hi), in 64-key tiles
  int lo = 0, hi = Skv;
  if (causal) hi = min(hi, q_offset + min(blk.q0 + kBQ, Sq));
  if (has_window) lo = max(lo, q_offset + blk.q0 - window + 1);
  blk.k_begin = (lo / kBK) * kBK;
  blk.ntiles = hi > blk.k_begin ? (hi - blk.k_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(blk.q_bar, 1);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(blk.full_bar + 8 * s, 1);
      mbar_init(blk.empty_bar + 8 * s, kConsumers * 4);  // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one branch a role, never rejoined, so ptxas budgets each at its
  // setmaxnreg
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) produce<D>(blk, &tq, &tk, &tv, Sq);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<D>(blk, wg - 1, o, Sq, Skv, Hq, scale_log2, causal, has_window,
               window, q_offset);
  }
}

// -------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no -lcuda
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (B, S, H, D) contiguous bf16 tensor as a 4-D map over (D, H, S, B),
// boxes of 64 rows x min(D, 64) columns, zero fill out of bounds (rows past
// S, and at D = 80 columns 80..127 of the second box)
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int H, int S, int batch) {
  using T = Tiles<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(H) * D * 2,
      static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kBox), 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int Sq, int Skv, int Hq, int Hkv, float scale, int causal,
           int has_window, int window, int q_offset, cudaStream_t stream) {
  auto kernel = flash_attention_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nq = (Sq + kBQ - 1) / kBQ;
  if (nq * Hq > INT_MAX || batch > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap tq, tk, tv;
  // a map that does not encode (no driver entry point, a shape TMA does not
  // take, such as no key at all) is an invalid argument: the wrapper has
  // checked what it can
  if (!encode<D>(&tq, q, Hq, Sq, batch) || !encode<D>(&tk, k, Hkv, Skv, batch) ||
      !encode<D>(&tv, v, Hkv, Skv, batch))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nq * Hq), batch);
  kernel<<<grid, kThreads, Tiles<D>::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv,
      static_cast<int>(nq), scale * 1.4426950408889634f, causal, has_window,
      window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

inline int smem_bytes(int D) {
  switch (D) {
    case 32: return Tiles<32>::kSmem;
    case 64: return Tiles<64>::kSmem;
    case 80: return Tiles<80>::kSmem;
    case 128: return Tiles<128>::kSmem;
    case 256: return Tiles<256>::kSmem;
    default: return -1;
  }
}

}  // namespace sm90
