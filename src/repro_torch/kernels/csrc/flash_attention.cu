// K5: FlashAttention-2 forward, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel behind flash_attention).  For q (B, Sq, Hq, D) and k, v
// (B, Skv, Hkv, D), in the layout kernels.ops.attention takes, it computes
//   o[b, i, h] = sum_j softmax_j(scale q_i . k_j  where allowed) v_j
// with q head h reading kv head h / (Hq / Hkv) (GQA), query i at position
// q_offset + i and key j at position j, a key allowed when it is not past
// the query (causal) and not `window` or more behind it (sliding window).
// Scores, the running max and sum and the accumulator are float32; masked
// scores are -1e30, and a query that no key is allowed for gives 0.
//
// Two kernels, chosen by the wrapper from the input type:
//   - bf16: flash_attention_sm90.cuh, on wgmma and TMA (its header says
//     how);
//   - float32: the SIMT kernel below.  The tensor cores multiply float32
//     only as TF32, which the port does not use, so this path stays on
//     float32 FMAs.
//
// Bound on the H100: operations.  Every allowed (query, key) pair costs
// 4 D flops (the score and its share of P V) against 2 D input elements
// per key tile shared by 64 queries; at the full-width RecurrentGemma-2B
// prefill (B=1, Hq=10, Hkv=1, D=256, window 2048, S=3000) that is 41.4
// GFLOP against ~3 MB of bf16 q, k, v and o.  The float32 kernel does the
// arithmetic in plain float32 FMAs (no tensor cores, no TF32), so the
// float32 rate (~67 TFLOP/s) is its own limit; the bf16 tensor-core peak
// is the card's.
//
// Design of the float32 kernel:
//   - The TPU grid (batch, head, q block, k block) with the k blocks in
//     order and m, l and acc in VMEM scratch becomes one CTA per (q block
//     of 64 rows, head, batch) that loops over 64-key tiles itself, with
//     m, l and the 64 x D accumulator in registers.
//   - Key tiles that the causal mask or the window wholly removes are
//     skipped, not masked: such a tile leaves m, l and acc as they are.
//   - Shared memory holds the block's q (scaled) and one k tile, both
//     transposed (d-major), one v tile (key-major) and the 64 x 64
//     probabilities: 4 (3 D + 64) 64 bytes, 212,992 at D = 256, so one CTA
//     fits an SM there (two at D = 128).  Both products are register-tiled
//     over shared memory: a thread owns 4 x 4 scores (one float4 of q and
//     one of k per 16 FMAs) and 4 rows x D/16 columns of the output (one
//     float4 of p per row and one of v per column group per 4 keys).
//   - A row's max and sum are reduced across the 16 threads that share it
//     (warp shuffles), so every thread keeps its rows' m and l.
//   - MQA at full width (10 q heads on one kv head, D = 256): a thread
//     holds 64 accumulators and 16 scores (129 registers, no spills), and
//     shared memory, not registers, caps residency at one CTA an SM; the
//     ten heads' CTAs read the same k and v tiles, which L2 serves.
//   - Rows and keys past Sq and Skv are guarded in the kernel: padded q
//     rows are zero and never stored, padded keys are masked and their k
//     and v rows zero, so any Sq and Skv run (the Pallas kernel needs
//     multiples of its blocks).
// D must be 32, 64, 80, 128 or 256 (80: HuBERT X-Large's heads).
#include <cuda_runtime.h>

#include <cstddef>

#include "flash_attention_sm90.cuh"

namespace {

constexpr int kBQ = 64;  // query rows a CTA
constexpr int kBK = 64;  // keys a tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// kVec contiguous output columns a thread per group, kGroups groups: the
// 16 threads of a row cover D columns, exactly (D = 80: five groups of one
// column, as 80 is no multiple of 16 x 2 or 16 x 4)
template <int D>
struct Cols {
  static constexpr int kVec = D % 64 == 0 ? 4 : D % 32 == 0 ? 2 : 1;
  static constexpr int kGroups = D / (16 * kVec);
  static_assert(16 * kVec * kGroups == D,
                "the output columns of a row must cover D exactly");
};

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* out);
template <>
__device__ __forceinline__ void load_vec<1>(const float* p, float* out) {
  out[0] = *p;
}
template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float* out) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x;
  out[1] = t.y;
  out[2] = t.z;
  out[3] = t.w;
}
template <>
__device__ __forceinline__ void load_vec<2>(const float* p, float* out) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  out[0] = t.x;
  out[1] = t.y;
}

__device__ __forceinline__ float row_reduce_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_reduce_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__host__ __device__ constexpr size_t smem_floats(int D) {
  return static_cast<size_t>(D) * kBQ + static_cast<size_t>(D) * kBK +
         static_cast<size_t>(kBK) * D + static_cast<size_t>(kBQ) * kBK;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int Sq, int Skv, int Hq, int Hkv, float scale,
                           int causal, int has_window, int window,
                           int q_offset) {
  static_assert(D % 4 == 0, "q, k and v rows are staged a float4 at a time");
  constexpr int kVec = Cols<D>::kVec;
  constexpr int kGroups = Cols<D>::kGroups;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;             // [d][r], q * scale
  float* kT = qT + D * kBQ;     // [d][c]
  float* vs = kT + D * kBK;     // [c][d]
  float* ps = vs + kBK * D;     // [r][c], probabilities

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows 4 ty .. 4 ty + 3
  const int tx = tid & 15;  // score columns 4 tx .. 4 tx + 3
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_pos = static_cast<size_t>(Hq) * D;    // q, o: one position
  const size_t kv_pos = static_cast<size_t>(Hkv) * D;  // k, v: one position
  const float* qb = q + static_cast<size_t>(b) * Sq * q_pos +
                    static_cast<size_t>(h) * D;
  float* ob =
      o + static_cast<size_t>(b) * Sq * q_pos + static_cast<size_t>(h) * D;
  const float* kb = k + static_cast<size_t>(b) * Skv * kv_pos +
                    static_cast<size_t>(hk) * D;
  const float* vb = v + static_cast<size_t>(b) * Skv * kv_pos +
                    static_cast<size_t>(hk) * D;

  // q, scaled in float32 as the reference does, transposed: lanes walk
  // rows so the shared stores are conflict-free
  for (int e = tid; e < kBQ * (D / 4); e += kThreads) {
    const int r = e % kBQ, d0 = (e / kBQ) * 4;
    float val[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Sq) {
      const float* src = qb + static_cast<size_t>(q0 + r) * q_pos + d0;
#pragma unroll
      for (int i = 0; i < 4; ++i) val[i] = src[i] * scale;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) qT[(d0 + i) * kBQ + r] = val[i];
  }

  // the keys any row of this block may see: [lo, hi)
  const long long q_first = static_cast<long long>(q_offset) + q0;
  const long long q_last =
      static_cast<long long>(q_offset) + min(q0 + kBQ, Sq) - 1;
  long long lo = 0, hi = Skv;
  if (causal && q_last + 1 < hi) hi = q_last + 1;
  if (has_window && q_first - window + 1 > lo) lo = q_first - window + 1;
  const int k_begin = static_cast<int>((lo / kBK) * kBK);
  const int k_end = static_cast<int>(hi);

  float acc[4][kGroups][kVec];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[i][g][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // q staged; the previous tile's k, v and p read
    for (int e = tid; e < kBK * (D / 4); e += kThreads) {
      const int c = e % kBK, d0 = (e / kBK) * 4;
      float val[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + c < Skv) {
        const float* src = kb + static_cast<size_t>(k0 + c) * kv_pos + d0;
#pragma unroll
        for (int i = 0; i < 4; ++i) val[i] = src[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) kT[(d0 + i) * kBK + c] = val[i];
    }
    for (int e = tid; e < kBK * (D / 4); e += kThreads) {
      const int c = e / (D / 4), d0 = (e % (D / 4)) * 4;
      float val[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + c < Skv) {
        const float* src = vb + static_cast<size_t>(k0 + c) * kv_pos + d0;
#pragma unroll
        for (int i = 0; i < 4; ++i) val[i] = src[i];
      }
      *reinterpret_cast<float4*>(vs + c * D + d0) =
          make_float4(val[0], val[1], val[2], val[3]);
    }
    __syncthreads();

    // scores s_ij = (scale q_i) . k_j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qT + d * kBQ + 4 * ty);
      const float4 kv = *reinterpret_cast<const float4*>(kT + d * kBK + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(part(qv, i), part(kv, j), s[i][j]);
    }

    // mask, then the online softmax of the reference (_flash_kernel)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = q_first + 4 * ty + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + 4 * tx + j;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qpos;
        if (has_window) ok = ok && kp > qpos - window;
        s[i][j] = ok ? s[i][j] : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = row_reduce_max(rmax);
      const float m_new = fmaxf(m[i], rmax);
      const bool alive = m_new > kNegInf / 2;
      const float alpha = alive ? expf(m[i] - m_new) : 0.f;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = alive ? expf(s[i][j] - m_new) : 0.f;
        rsum += s[i][j];
      }
      rsum = row_reduce_sum(rsum);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[i][g][j] *= alpha;
      *reinterpret_cast<float4*>(ps + (4 * ty + i) * kBK + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc += p v
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kBK + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = vs + (c + cc) * D;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          float vv[kVec];
          load_vec<kVec>(vrow + (g * 16 + tx) * kVec, vv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = part(pr[i], cc);
#pragma unroll
            for (int j = 0; j < kVec; ++j)
              acc[i][g][j] = fmaf(p, vv[j], acc[i][g][j]);
          }
        }
      }
    }
  }

  // o = acc / l, with l = 1 where no key was allowed (acc is 0 there)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= Sq) continue;
    const float safe = l[i] > 0.f ? l[i] : 1.f;
    float* dst = ob + static_cast<size_t>(r) * q_pos;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        dst[(g * 16 + tx) * kVec + j] = acc[i][g][j] / safe;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int Sq, int Skv, int Hq, int Hkv, float scale, int causal,
           int has_window, int window, int q_offset, cudaStream_t stream) {
  const size_t bytes = smem_floats(D) * sizeof(float);
  auto kernel = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, Hq, Hkv,
      scale, causal, has_window, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_f32_smem_bytes(int D) {
  return static_cast<int>(smem_floats(D) * sizeof(float));
}

extern "C" int flash_attention_bf16_smem_bytes(int D) {
  return sm90::smem_bytes(D);
}

// q, o: (batch, Sq, Hq, D); k, v: (batch, Skv, Hkv, D); all contiguous
// float32.  D in {32, 64, 80, 128, 256}, Hq a multiple of Hkv.  The window
// applies when has_window.
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* o, int batch,
                                          int Sq, int Skv, int Hq, int Hkv,
                                          int D, float scale, int causal,
                                          int has_window, int window,
                                          int q_offset, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || Sq == 0 || Hq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, batch, Sq, Skv, Hq, Hkv, scale, causal,
                        has_window, window, q_offset, s);
    case 64:
      return launch<64>(q, k, v, o, batch, Sq, Skv, Hq, Hkv, scale, causal,
                        has_window, window, q_offset, s);
    case 80:
      return launch<80>(q, k, v, o, batch, Sq, Skv, Hq, Hkv, scale, causal,
                        has_window, window, q_offset, s);
    case 128:
      return launch<128>(q, k, v, o, batch, Sq, Skv, Hq, Hkv, scale, causal,
                         has_window, window, q_offset, s);
    case 256:
      return launch<256>(q, k, v, o, batch, Sq, Skv, Hq, Hkv, scale, causal,
                         has_window, window, q_offset, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As flash_attention_f32_launch for bf16 q, k, v and o, whose data and
// strides must also be 16-byte aligned (TMA).
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int batch,
                                           int Sq, int Skv, int Hq, int Hkv,
                                           int D, float scale, int causal,
                                           int has_window, int window,
                                           int q_offset, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || Sq == 0 || Hq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return sm90::launch<32>(q, k, v, o, batch, Sq, Skv, Hq, Hkv, scale,
                              causal, has_window, window, q_offset, s);
    case 64:
      return sm90::launch<64>(q, k, v, o, batch, Sq, Skv, Hq, Hkv, scale,
                              causal, has_window, window, q_offset, s);
    case 80:
      return sm90::launch<80>(q, k, v, o, batch, Sq, Skv, Hq, Hkv, scale,
                              causal, has_window, window, q_offset, s);
    case 128:
      return sm90::launch<128>(q, k, v, o, batch, Sq, Skv, Hq, Hkv, scale,
                               causal, has_window, window, q_offset, s);
    case 256:
      return sm90::launch<256>(q, k, v, o, batch, Sq, Skv, Hq, Hkv, scale,
                               causal, has_window, window, q_offset, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
