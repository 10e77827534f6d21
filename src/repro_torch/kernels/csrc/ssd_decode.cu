// K7: one Mamba-2 SSD decode step, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference's decode step
// (src/repro/kernels/ops.py::ssd_decode_step) is plain jnp, one step of
// the sequential oracle, which XLA fuses into a pass over the state.  In
// PyTorch that step is four operations over the float32 state (the outer
// product, the decay, their sum, y as a gemv), each reading or writing
// all of it, and a fifth copies the new state into the cache.  This kernel
// does the step in one pass.  For every (slot b, head h), with the
// grouped projections B, C of group h / (H / G):
//   da = exp(dt A);  h' = da h + (x dt) outer B;  y = h' . C + D x
// The state (B, H, P, N) is read once and written once, in place; y
// (B, 1, H, P) comes out of the same pass in x's type.
//
// Bound on the H100: bytes.  A state element costs 8 bytes (read and
// written) against 5 operations.  Granite 4.0-H Small's decode at 128
// slots (H 128, P 64, N 128) moves 537 MB in and 537 MB out a layer:
// 0.32 ms at 3.35 TB/s.  The state is 11 times the 50 MB L2, so every
// step streams it from HBM.
//
// Design:
//   - One CTA of 256 threads per (slot, head): its P x N block is
//     contiguous (32 KB at P 64, N 128).  Each warp takes every 8th row
//     of P; along a row, lane l takes units l, l + 32, ... of VEC floats
//     (VEC = 4, one float4, where N % 4 == 0 and the state is 16-byte
//     aligned; else VEC = 1, the scalar path of the same kernel).
//   - A thread starts the loads of kUnroll = 8 rows before it uses any
//     of them (8 float4s, 128 bytes in flight a thread; the pattern of
//     bodies.cuh::memory_window), with streaming hints (__ldcs, __stcs):
//     the state is touched once a step and should not evict the L2.
//   - The update is elementwise and rounded as the plain path rounds it:
//     __fmul_rn / __fadd_rn keep nvcc from contracting da h + (x dt) B
//     into an FMA, and expf (not __expf) takes the exponential, so the
//     new state equals ssd_ref's bit for bit.
//   - y[p] is each lane's partial dot of the new row with C, summed over
//     the warp by a butterfly of shuffles (a fixed order, so a replay
//     gives the same bits; another order than einsum's gemv), then D x
//     added and rounded to x's type.
// Any H, P, N and G with G dividing H.  x, B and C are float32 or bf16,
// all three alike; dt, A, D and the state float32.  The slot (batch)
// stride of x, dt, B and C is an argument; within a slot each is dense.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // rows of the state in flight a warp

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int VEC>
__device__ __forceinline__ void load_unit(const float* p, float (&v)[VEC]);
template <>
__device__ __forceinline__ void load_unit<4>(const float* p, float (&v)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
template <>
__device__ __forceinline__ void load_unit<1>(const float* p, float (&v)[1]) {
  v[0] = __ldcs(p);
}

template <int VEC>
__device__ __forceinline__ void store_unit(float* p, const float (&v)[VEC]);
template <>
__device__ __forceinline__ void store_unit<4>(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
template <>
__device__ __forceinline__ void store_unit<1>(float* p, const float (&v)[1]) {
  __stcs(p, v[0]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    ssd_decode_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ D, float* __restrict__ h,
                      T* __restrict__ y, int H, int P, int N, int G,
                      long long x_slot, long long dt_slot, long long b_slot,
                      long long c_slot) {
  const int bh = blockIdx.x;
  const long long b = bh / H;
  const int head = bh % H;
  const int g = head / (H / G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float dtv = dt[b * dt_slot + head];
  const float da = expf(__fmul_rn(dtv, A[head]));
  const T* xr = x + b * x_slot + static_cast<long long>(head) * P;
  const T* br = Bm + b * b_slot + static_cast<long long>(g) * N;
  const T* cr = Cm + b * c_slot + static_cast<long long>(g) * N;
  float* hb = h + static_cast<size_t>(bh) * P * N;
  T* yr = y + static_cast<size_t>(bh) * P;
  const int units = N / VEC;

  for (int p0 = warp; p0 < P; p0 += kWarps * kUnroll) {
    float acc[kUnroll];
    float xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kWarps;
      acc[u] = 0.f;
      xv[u] = p < P ? to_f(xr[p]) : 0.f;
    }
    for (int c0 = 0; c0 < units; c0 += 32) {
      const int c = c0 + lane;
      const bool on = c < units;
      const size_t col = static_cast<size_t>(c) * VEC;
      float hv[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kWarps;
        if (on && p < P) load_unit<VEC>(hb + static_cast<size_t>(p) * N + col,
                                        hv[u]);
      }
      float bv[VEC], cv[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        bv[e] = on ? to_f(br[col + e]) : 0.f;
        cv[e] = on ? to_f(cr[col + e]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kWarps;
        if (on && p < P) {
          const float xdt = __fmul_rn(xv[u], dtv);
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            hv[u][e] = __fadd_rn(__fmul_rn(da, hv[u][e]),
                                 __fmul_rn(xdt, bv[e]));
            part = fmaf(hv[u][e], cv[e], part);
          }
          store_unit<VEC>(hb + static_cast<size_t>(p) * N + col, hv[u]);
          acc[u] += part;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float s = acc[u];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int p = p0 + u * kWarps;
      if (lane == 0 && p < P)
        store_f(yr + p,
                D != nullptr ? __fadd_rn(s, __fmul_rn(xv[u], D[head])) : s);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, const float* D,
                         float* h, void* y, unsigned blocks, int H, int P,
                         int N, int G, long long x_slot, long long dt_slot,
                         long long b_slot, long long c_slot, bool wide,
                         cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  T* yt = static_cast<T*>(y);
  if (wide)
    ssd_decode_kernel<T, 4><<<blocks, kThreads, 0, stream>>>(
        xt, dt, A, bt, ct, D, h, yt, H, P, N, G, x_slot, dt_slot, b_slot,
        c_slot);
  else
    ssd_decode_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        xt, dt, A, bt, ct, D, h, yt, H, P, N, G, x_slot, dt_slot, b_slot,
        c_slot);
  return cudaGetLastError();
}

}  // namespace

// x (B, 1, H, P), y (B, 1, H, P, contiguous), B and C (B, 1, G, N), all
// four in float32 or all in bf16 (`bf16`); dt (B, 1, H), A (H,), D (H,)
// or null, the state h (B, H, P, N) contiguous float32, updated in place.  `*_slot` are the slot strides of x, dt, B
// and C in elements.  `wide` != 0: N % 4 == 0 and h 16-byte aligned (the
// wrapper checks).
extern "C" int ssd_decode_launch(const void* x, const float* dt,
                                 const float* A, const void* Bm,
                                 const void* Cm, const float* D, float* h,
                                 void* y, int batch, int H, int P, int N,
                                 int G, long long x_slot, long long dt_slot,
                                 long long b_slot, long long c_slot,
                                 int bf16, int wide,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G <= 0 || H % G != 0 || (wide && N % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(batch) * H;
  if (blocks == 0 || P == 0 || N == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nb = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = wide != 0;
  if (bf16)
    err = launch_typed<__nv_bfloat16>(x, dt, A, Bm, Cm, D, h, y, nb, H, P,
                                      N, G, x_slot, dt_slot, b_slot, c_slot,
                                      w, s);
  else
    err = launch_typed<float>(x, dt, A, Bm, Cm, D, h, y, nb, H, P, N, G,
                              x_slot, dt_slot, b_slot, c_slot, w, s);
  return static_cast<int>(err);
}
