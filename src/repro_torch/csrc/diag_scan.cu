// Diagonal linear recurrence (the RG-LRU scan) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_diag_kernel` / `diag_scan_kernel`
// (src/repro/kernels/linear_scan/kernel.py). Same function, per channel
// (b, d), with the carry in fp32:
//
//   h_t = a_t * h_{t-1} + b_t,    h_{-1} = h0 (zeros without it)
//
// h [B, T, D] and h_T [B, D] are written in a's dtype. a and b are fp32 or
// bf16 (one type for both); h0 is fp32. Any T >= 1: the TPU kernel's chunk
// padding is not needed.
//
// What bounds it on the H100: one multiply and one add per element against
// 3 elements moved (a and b read, h written), so memory: at the served
// prefill shape ([4, 2100, 4096] bf16) 206 MB over 3.35 TB/s, 0.062 ms.
// The B * D = 16,384 channels are independent but each walks T in order;
// one thread per channel walking all of T would put ~4 warps on each SM,
// too few loads in flight to reach that rate. The design:
// * a block owns 64 adjacent channels (two per lane, so a warp reads 128
//   contiguous bytes of bf16 or 256 of fp32 per step) and cuts T into
//   segments of `seg` steps, one warp each (up to 16 warps), so the served
//   shape runs 256 blocks of 9 warps;
// * pass 1: each warp scans its segment from zero, keeping the product of
//   its a's (A) and its local end state (H); loads run UNROLL steps ahead
//   of the arithmetic, which they do not depend on;
// * one warp chains the segments in shared memory, h_in[s+1] = A_s h_in[s]
//   + H_s, from h0;
// * pass 2: each warp walks its segment again from h_in and writes h (its
//   a and b come a second time, partly from L2), and the last one h_T.
// The recurrence in pass 2 rounds its multiply and its add apart, as the
// plain version does, so one segment (T <= seg, as in decode) gives the
// plain version's bits; with several, the chaining reorders fp32 products
// and the result agrees to the reference's tolerance. Pass 2's second read
// of a and b makes 5 units of traffic against the bound's 3; a single-pass
// scan with look-back is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr int TILE = 2 * LANES;     // channels per block, two per lane
constexpr int SEG_MAX = 16;         // warps (time segments) per block
constexpr int UNROLL = 8;

// Two adjacent channels as fp32: `n` of them (0, 1 or 2) lie inside D;
// `vec` when the pair is one aligned 2-element load.
__device__ __forceinline__ float2 load2(const float* p, bool vec, int n) {
  if (vec) return *reinterpret_cast<const float2*>(p);
  return make_float2(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, bool vec, int n) {
  if (vec) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(n > 0 ? __bfloat162float(p[0]) : 0.f,
                     n > 1 ? __bfloat162float(p[1]) : 0.f);
}
__device__ __forceinline__ void store2(float* p, float2 v, bool vec, int n) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = v;
  } else {
    if (n > 0) p[0] = v.x;
    if (n > 1) p[1] = v.y;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v, bool vec, int n) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  } else {
    if (n > 0) p[0] = __float2bfloat16(v.x);
    if (n > 1) p[1] = __float2bfloat16(v.y);
  }
}

// h = a * h + b, the multiply and the add each rounded (no FMA).
__device__ __forceinline__ float2 step(float2 a, float2 h, float2 b) {
  return make_float2(__fadd_rn(__fmul_rn(a.x, h.x), b.x),
                     __fadd_rn(__fmul_rn(a.y, h.y), b.y));
}

// Grid (ceil(D / 64), B); block: one warp per segment of `seg` steps.
template <typename T>
__global__ void __launch_bounds__(LANES * SEG_MAX)
diag_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const float* __restrict__ h0, T* __restrict__ h,
                 T* __restrict__ hT, int Tlen, int D, int seg, int vec_ok) {
  __shared__ float2 sA[SEG_MAX][LANES];
  __shared__ float2 sH[SEG_MAX][LANES];
  __shared__ float2 sIn[SEG_MAX][LANES];

  const int lane = threadIdx.x & (LANES - 1);
  const int w = threadIdx.x / LANES;
  const int nseg = blockDim.x / LANES;
  const int d = blockIdx.x * TILE + 2 * lane;
  const int n = max(0, min(2, D - d));
  const bool vec = vec_ok && n == 2;
  const size_t row = (size_t)blockIdx.y * Tlen * D + d;   // (b, t = 0, d)
  const int t0 = w * seg;
  const int t1 = min(Tlen, t0 + seg);

  // pass 1: this segment from a zero state
  float2 A = make_float2(1.f, 1.f), H = make_float2(0.f, 0.f);
  if (n > 0) {
    int t = t0;
    for (; t + UNROLL <= t1; t += UNROLL) {
      float2 av[UNROLL], bv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        av[u] = load2(a + row + (size_t)(t + u) * D, vec, n);
        bv[u] = load2(b + row + (size_t)(t + u) * D, vec, n);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        A = make_float2(A.x * av[u].x, A.y * av[u].y);
        H = step(av[u], H, bv[u]);
      }
    }
    for (; t < t1; ++t) {
      const float2 av = load2(a + row + (size_t)t * D, vec, n);
      const float2 bv = load2(b + row + (size_t)t * D, vec, n);
      A = make_float2(A.x * av.x, A.y * av.y);
      H = step(av, H, bv);
    }
  }
  sA[w][lane] = A;
  sH[w][lane] = H;
  __syncthreads();

  // chain the segments from h0
  if (w == 0) {
    const size_t c = (size_t)blockIdx.y * D + d;
    float2 carry = make_float2(h0 && n > 0 ? h0[c] : 0.f,
                               h0 && n > 1 ? h0[c + 1] : 0.f);
    for (int s = 0; s < nseg; ++s) {
      sIn[s][lane] = carry;
      carry = step(sA[s][lane], carry, sH[s][lane]);
    }
  }
  __syncthreads();

  // pass 2: the segment again from its true start state, writing h
  if (n == 0 || t0 >= t1) return;
  float2 hv = sIn[w][lane];
  int t = t0;
  for (; t + UNROLL <= t1; t += UNROLL) {
    float2 av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = load2(a + row + (size_t)(t + u) * D, vec, n);
      bv[u] = load2(b + row + (size_t)(t + u) * D, vec, n);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      hv = step(av[u], hv, bv[u]);
      store2(h + row + (size_t)(t + u) * D, hv, vec, n);
    }
  }
  for (; t < t1; ++t) {
    hv = step(load2(a + row + (size_t)t * D, vec, n), hv,
              load2(b + row + (size_t)t * D, vec, n));
    store2(h + row + (size_t)t * D, hv, vec, n);
  }
  if (t1 == Tlen) store2(hT + (size_t)blockIdx.y * D + d, hv, vec, n);
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, void* h,
           void* hT, int B, int Tlen, int D, int seg, cudaStream_t stream) {
  const int nseg = (Tlen + seg - 1) / seg;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(h) |
                         reinterpret_cast<uintptr_t>(hT);
  const int vec_ok = D % 2 == 0 && addr % (2 * sizeof(T)) == 0;
  dim3 grid((D + TILE - 1) / TILE, B);
  diag_scan_kernel<T><<<grid, LANES * nseg, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(h), static_cast<T*>(hT), Tlen, D, seg, vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (of a, b, h, h_T): 0 = float32, 1 = bfloat16. a, b, h: [B, T, D];
// h_T: [B, D]; h0: [B, D] fp32, or null for zeros; all contiguous.
// seg: time steps per warp, with ceil(T / seg) <= 16. Returns
// cudaGetLastError() after the launch.
int diag_scan_fwd(int dtype, const void* a, const void* b, const float* h0,
                  void* h, void* hT, int B, int T, int D, int seg,
                  void* stream) {
  if (B < 0 || T < 1 || D < 1 || seg < 1 || B > 65535 ||
      (T + seg - 1) / seg > SEG_MAX)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, b, h0, h, hT, B, T, D, seg, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0, h, hT, B, T, D, seg, s);
  return (int)cudaErrorInvalidValue;
}

const char* diag_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
