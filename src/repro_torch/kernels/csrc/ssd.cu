// K6: the Mamba-2 SSD chunked forward, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd.py::_ssd_kernel (the Pallas TPU kernel
// behind ssd_chunked).  For x (B, S, H, P), dt (B, S, H), A (H,) and the
// grouped projections B, C (B, S, G, N), each chunk of Q positions does:
//   1. cum = inclusive cumsum of dt*A;
//   2. y  = (C B^T o exp(cum_i - cum_j)[j <= i]) @ (x dt);
//   3. y += (C exp(cum)) @ h^T;
//   4. h  = exp(cum_last) h + x^T @ (B exp(cum_last - cum) dt);
// from a zero state, returning y (in x's type) and the final (P, N) state.
// The D skip stays outside, as in the reference.
//
// Bound on the H100: operations.  Per (head, chunk) the three products take
// 2Q^2N + 2Q^2P + 4QNP flops (~10.5 MFLOP at Q=128, N=128, P=64) against
// ~50 KB of input, and the arithmetic is float32 (no TF32, no tensor
// cores), so the fp32 rate of ~67 TFLOP/s is the limit: a 1024-token
// prefill of Mamba-2 2.7B (80 heads, 8 chunks) is ~6.7 GFLOP a layer, a
// ~0.10 ms bound, while its ~24 MB of bytes take ~7 us.
//
// Design:
//   - The TPU's sequential chunk grid dimension, which carries the state in
//     VMEM scratch, becomes a loop inside one CTA: one CTA per (batch, head)
//     walks the chunks in order with the state resident in shared memory.
//   - The chunk's x, B and C tiles are staged in shared memory as float32
//     (read from bf16 or f32), C transposed (n-major) and the state as
//     h^T (n-major), so that each of the three products reads its operands
//     along the contraction index and its output dims contiguously.  A
//     (Q x Q) score tile does not fit beside them in 227 KB: scores are
//     formed kRows rows at a time, stored transposed, and consumed at once
//     by the rows of y they feed.
//   - Every pass is a register-tiled product over shared memory: a thread
//     owns a 4x4 (scores, state) or 2x4 (y) tile of outputs and loads one
//     float4 and 1-4 scalars per 8-16 FMAs.  B rows keep a stride of N + 1
//     floats, so the scalar B reads of the score pass hit distinct banks.
//   - exp(cum_i - cum_j) is formed only for j <= i (tiles wholly above the
//     diagonal are skipped): above it the exponent is positive and could
//     overflow into inf * 0 = NaN.
//   - Plain float32 FMAs; the products follow the reference's order up to
//     where dt and exp(cum_i) are applied (dt folded into the scores, and
//     exp(cum_i) applied to C.h), a float32 rounding apart.
// P and N must be multiples of 4.  At full width a B=1 prefill is 80 CTAs
// on 132 SMs.  This kernel runs float32 and mixed inputs, and bf16 ones
// past the tensor-core kernel's P <= 64, N <= 128; bf16 x, B and C within
// them take that kernel (ssd_sm90.cuh: three chunk-parallel passes on
// wgmma).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "ssd_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // score rows formed and consumed per pass

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ inline int padded(int Q) { return (Q + 3) & ~3; }

// Shared floats, Qp = Q rounded up to 4 (rows past Q are zero): x (Qp, P),
// B (Qp, N+1), C^T (N, Qp), h^T (N, P), scores^T (Qp, kRows), then dt,
// cum, exp(cum_last - cum) dt and exp(cum), Qp each.  Every array starts
// on a multiple of 4 floats, so float4 reads stay aligned.
__host__ __device__ size_t smem_floats(int Q, int P, int N) {
  const size_t Qp = padded(Q);
  return Qp * P + Qp * (N + 1) + static_cast<size_t>(N) * Qp +
         static_cast<size_t>(N) * P + Qp * kRows + 4 * Qp;
}

template <typename TX, typename TBC>
__global__ void __launch_bounds__(kThreads)
    ssd_chunked_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const TBC* __restrict__ Bm, const TBC* __restrict__ Cm,
                       TX* __restrict__ y, float* __restrict__ state, int S,
                       int H, int P, int G, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int Qp = padded(Q);
  const int ldb = N + 1;
  float* xs = smem;               // [j][p]
  float* bs = xs + Qp * P;        // [j][n], stride N + 1
  float* cT = bs + Qp * ldb;      // [n][i]
  float* hT = cT + N * Qp;        // [n][p]
  float* sT = hT + N * P;         // [j][r], scores of rows r0 + r
  float* dts = sT + Qp * kRows;
  float* cum = dts + Qp;
  float* wts = cum + Qp;
  float* ecum = wts + Qp;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const float a = A[h];
  const size_t x_pos = static_cast<size_t>(H) * P;  // x, y: one position
  const size_t bc_pos = static_cast<size_t>(G) * N;  // B, C: one position
  const TX* xb = x + static_cast<size_t>(b) * S * x_pos +
                 static_cast<size_t>(h) * P;
  TX* yb = y + static_cast<size_t>(b) * S * x_pos +
           static_cast<size_t>(h) * P;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;
  const size_t bc_off = static_cast<size_t>(b) * S * bc_pos +
                        static_cast<size_t>(g) * N;
  const TBC* Bb = Bm + bc_off;
  const TBC* Cb = Cm + bc_off;
  const int P4 = P / 4, N4 = N / 4;

  for (int e = tid; e < N * P; e += kThreads) hT[e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the previous chunk's state update is done
    for (int e = tid; e < Qp * P; e += kThreads) {
      const int q = e / P;
      xs[e] = q < Q ? load_f(xb + (s0 + q) * x_pos + e % P) : 0.f;
    }
    for (int e = tid; e < Qp * N; e += kThreads) {
      const int q = e / N, n = e % N;
      const size_t off = (s0 + q) * bc_pos + n;
      bs[q * ldb + n] = q < Q ? load_f(Bb + off) : 0.f;
      cT[n * Qp + q] = q < Q ? load_f(Cb + off) : 0.f;
    }
    for (int q = tid; q < Qp; q += kThreads)
      dts[q] = q < Q ? dtb[(s0 + q) * H] : 0.f;
    __syncthreads();
    if (tid == 0) {  // 1. inclusive cumsum, in order
      float run = 0.f;
      for (int q = 0; q < Q; ++q) {
        run += dts[q] * a;
        cum[q] = run;
      }
    }
    __syncthreads();
    const float last = cum[Q - 1];
    for (int q = tid; q < Qp; q += kThreads) {
      wts[q] = q < Q ? expf(last - cum[q]) * dts[q] : 0.f;
      ecum[q] = q < Q ? expf(cum[q]) : 0.f;
    }

    for (int r0 = 0; r0 < Q; r0 += kRows) {
      __syncthreads();  // scores free again; wts and ecum visible
      // 2a. scores^T: s_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i
      for (int t = tid; t < (kRows / 4) * (Qp / 4); t += kThreads) {
        const int i0 = 4 * (t % (kRows / 4)), j0 = 4 * (t / (kRows / 4));
        if (r0 + i0 >= Qp) continue;  // rows past the chunk
        float acc[4][4] = {};
        if (j0 <= r0 + i0 + 3) {
          for (int n = 0; n < N; ++n) {
            const float4 c = *reinterpret_cast<const float4*>(
                cT + n * Qp + r0 + i0);
            const float* bn = bs + j0 * ldb + n;
            const float bj[4] = {bn[0], bn[ldb], bn[2 * ldb], bn[3 * ldb]};
            const float ci[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v)
                acc[u][v] = fmaf(ci[u], bj[v], acc[u][v]);
          }
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = j0 + v;
          float out[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = r0 + i0 + u;
            out[u] = (j <= i && i < Q)
                         ? acc[u][v] * expf(cum[i] - cum[j]) * dts[j]
                         : 0.f;
          }
          *reinterpret_cast<float4*>(sT + j * kRows + i0) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
      }
      __syncthreads();
      // 2b + 3. y_ip = sum_{j<=i} s_ij x_jp + exp(cum_i) sum_n C_in h_pn
      for (int t = tid; t < (kRows / 2) * P4; t += kThreads) {
        const int p0 = 4 * (t % P4), u0 = 2 * (t / P4);
        const int i0 = r0 + u0;
        if (i0 >= Q) continue;
        float intra[2][4] = {}, inter[2][4] = {};
        const int jend = min(Q, i0 + 2);
        for (int j = 0; j < jend; ++j) {
          const float2 sv = *reinterpret_cast<const float2*>(
              sT + j * kRows + u0);
          const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + p0);
          const float su[2] = {sv.x, sv.y};
          const float xp[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              intra[u][v] = fmaf(su[u], xp[v], intra[u][v]);
        }
        for (int n = 0; n < N; ++n) {
          const float2 cv = *reinterpret_cast<const float2*>(
              cT + n * Qp + i0);
          const float4 hv = *reinterpret_cast<const float4*>(hT + n * P + p0);
          const float cu[2] = {cv.x, cv.y};
          const float hp[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              inter[u][v] = fmaf(cu[u], hp[v], inter[u][v]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = i0 + u;
          if (i >= Q) continue;
          TX* yrow = yb + (s0 + i) * x_pos + p0;
#pragma unroll
          for (int v = 0; v < 4; ++v)
            store_f(yrow + v, intra[u][v] + ecum[i] * inter[u][v]);
        }
      }
    }
    __syncthreads();  // every row of y has read the old state
    // 4. h^T_np = exp(cum_last) h^T_np + sum_j (B_jn exp(cum_last - cum_j)
    //    dt_j) x_jp
    const float dlast = expf(last);
    for (int t = tid; t < N4 * P4; t += kThreads) {
      const int p0 = 4 * (t % P4), n0 = 4 * (t / P4);
      float acc[4][4] = {};
      for (int j = 0; j < Q; ++j) {
        const float w = wts[j];
        const float* bj = bs + j * ldb + n0;
        const float bw[4] = {bj[0] * w, bj[1] * w, bj[2] * w, bj[3] * w};
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + p0);
        const float xp[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[u][v] = fmaf(bw[u], xp[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4* hrow = reinterpret_cast<float4*>(hT + (n0 + u) * P + p0);
        const float4 old = *hrow;
        *hrow = make_float4(fmaf(dlast, old.x, acc[u][0]),
                            fmaf(dlast, old.y, acc[u][1]),
                            fmaf(dlast, old.z, acc[u][2]),
                            fmaf(dlast, old.w, acc[u][3]));
      }
    }
  }
  __syncthreads();
  float* st = state + (static_cast<size_t>(b) * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) st[e] = hT[(e % N) * P + e / N];
}

template <typename TX, typename TBC>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, int batch, int S, int H,
           int P, int G, int N, int chunk, cudaStream_t stream) {
  const size_t bytes = smem_floats(chunk, P, N) * sizeof(float);
  auto kernel = ssd_chunked_kernel<TX, TBC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch * H, kThreads, bytes, stream>>>(
      static_cast<const TX*>(x), dt, A, static_cast<const TBC*>(Bm),
      static_cast<const TBC*>(Cm), static_cast<TX*>(y), state, S, H, P, G, N,
      chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_chunked_smem_bytes(int P, int N, int chunk) {
  return static_cast<int>(smem_floats(chunk, P, N) * sizeof(float));
}

// x, y: (batch, S, H, P) in bf16 when x_bf16 else f32; B, C: (batch, S, G,
// N) in bf16 when bc_bf16 else f32; dt (batch, S, H) and A (H,) f32; state
// (batch, H, P, N) f32.  All contiguous; S a multiple of chunk <= 128.
extern "C" int ssd_chunked_launch(const void* x, const float* dt,
                                  const float* A, const void* Bm,
                                  const void* Cm, void* y, float* state,
                                  int batch, int S, int H, int P, int G,
                                  int N, int chunk, int x_bf16, int bc_bf16,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && bc_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, Bm, Cm, y, state,
                                                batch, S, H, P, G, N, chunk, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, dt, A, Bm, Cm, y, state, batch, S,
                                        H, P, G, N, chunk, s);
  if (bc_bf16)
    return launch<float, __nv_bfloat16>(x, dt, A, Bm, Cm, y, state, batch, S,
                                        H, P, G, N, chunk, s);
  return launch<float, float>(x, dt, A, Bm, Cm, y, state, batch, S, H, P, G,
                              N, chunk, s);
}

// The tensor-core path: x, B, C and y bf16 with P <= 64 and N <= 128, the
// rest as ssd_chunked_launch; scratch: hs (batch, H, S / chunk, P, N) and
// decay (batch, H, S / chunk) float32, hin (batch, H, S / chunk, 2, P, N)
// bf16.  x, B and C 8-byte aligned.
extern "C" int ssd_chunked_bf16_launch(const void* x, const float* dt,
                                       const float* A, const void* Bm,
                                       const void* Cm, void* y, float* state,
                                       float* hs, float* decay, void* hin,
                                       int batch, int S, int H, int P, int G,
                                       int N, int chunk, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || H == 0) return 0;
  if (P > ssd90::kMaxP || N > ssd90::kMaxN || P % 4 || N % 4 ||
      chunk > ssd90::kQ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 64)
    return ssd90::launch<1>(x, dt, A, Bm, Cm, y, state, hs, decay, hin,
                            batch, S, H, P, G, N, chunk, s);
  return ssd90::launch<2>(x, dt, A, Bm, Cm, y, state, hs, decay, hin, batch,
                          S, H, P, G, N, chunk, s);
}

// shared memory a CTA of the tensor-core path's passes (a) and (c)
extern "C" int ssd_chunked_bf16_smem_bytes(int N, int pass_c) {
  if (N <= 64)
    return pass_c ? ssd90::ScanSmem<1>::kBytes : ssd90::StateSmem<1>::kBytes;
  return pass_c ? ssd90::ScanSmem<2>::kBytes : ssd90::StateSmem<2>::kBytes;
}
