// Diagonal linear recurrence (the RG-LRU scan) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_diag_kernel` / `diag_scan_kernel`
// (src/repro/kernels/linear_scan/kernel.py). Same function, per channel
// (b, d), with the carry in fp32:
//
//   h_t = a_t * h_{t-1} + b_t,    h_{-1} = h0 (zeros without it)
//
// h [B, T, D] and h_T [B, D] are written in a's dtype. a and b are fp32 or
// bf16 (one type for both); h0 is fp32 or bf16, read in its own type. Any
// T >= 1: the TPU kernel's chunk padding is not needed.
//
// What bounds it on the H100: one multiply and one add per element against
// 3 elements moved (a and b read, h written), so memory: at the served
// prefill shape ([4, 2100, 4096] bf16) 206 MB over 3.35 TB/s, 0.062 ms; in
// decode (T = 1) the 160 KB of a step take under a microsecond, so there the
// floor is one launch and one trip to device memory. Two kernels, chosen by
// T alone (`diag_scan_plan` says which and how it is tiled):
//
// * `diag_scan_ring` (T > 1), one pass over device memory. A block owns 64
//   adjacent channels of one batch row (the served shape gives 4 x 64 = 256
//   blocks for 132 SMs) and one thread walks one channel through all of T in
//   order. The walk is cheap (~10 cycles a step: 2100 steps are ~12 us
//   against the 62 us of traffic); what the old two-pass kernel lacked was
//   bytes in flight. So a and b stream through a ring of 4 shared-memory
//   stages of 16 KB (64 steps of bf16, 32 of fp32), filled by 16-byte
//   `cp.async` copies three stages ahead of the walk: 48 KB in flight a
//   block, ~96 KB an SM, where Little's law asks ~18 KB an SM for 3.35 TB/s
//   at ~700 ns latency. A row of a stage is 128 bytes (bf16) or 256 (fp32)
//   of adjacent channels, one piece of 16 bytes a lane. The walk reads a and
//   b from the staged copy and writes h once; the carry stays in a
//   register. 3 units of traffic, the bound's.
//   Widths that are not whole 16-byte rows (or unaligned pointers) fill the
//   same ring with plain element loads.
// * `diag_scan_step` (T = 1, every decode step): a flat elementwise pass
//   over the B * D channels, 8 a thread, with 16-byte loads and stores where
//   aligned, no shared memory and no barrier; h and h_T get the same values.
//
// Both kernels round the multiply and the add apart (`__fmul_rn`,
// `__fadd_rn`) and walk each channel in order from h0, exactly as the plain
// version does, so they give its bits for every T, in fp32 and in bf16
// (rounded to nearest even once, on the store).
//
// The backward (`diag_scan_bwd_ring`, no TPU kernel's counterpart: the
// reference takes this gradient by autodiff of its sequential scan) is the
// same recurrence run backwards in time, with the fp32 carry mu (gT, the
// cotangent of h_T, or 0 before the last step):
//
//   lam_t = g_t + mu,   db_t = lam_t,   da_t = lam_t * h_{t-1},   mu = a_t * lam_t
//
// and dh0 = mu after t = 0 (h_{-1} = h0). It is the ring kernel walking T
// from the last step down: one thread a channel, 64 channels a block, a
// ring of 4 stages filled three ahead by 16-byte `cp.async` copies, a stage
// holding a, g and h for `bwd_steps` steps (32 of bf16, 16 of fp32: 12 KB),
// h's rows shifted by one (h_{t-1} beside a_t; the row before t = 0 is h0,
// read once into a register). It reads a, g and h once and writes da and db
// once: 5 units of traffic, the bound's (84 MB at [4, 512, 4096] bf16,
// 0.025 ms). Any T >= 1 takes this one kernel. It rounds as the plain
// version (`diag_scan_bwd_ref`) does, so it gives its bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RING_CH = 64;             // channels a block, one a thread
constexpr int RING_STAGES = 4;
constexpr int RING_STAGE_BYTES = 16384;  // a and b of one stage
constexpr int BWD_STAGE_BYTES = 12288;  // a, g and h of one backward stage
constexpr int STEP_PER_THREAD = 8;      // decode: channels a thread
constexpr int STEP_THREADS = 128;

template <typename T>
__host__ __device__ constexpr int ring_steps() {   // time steps a stage
  return RING_STAGE_BYTES / (2 * RING_CH * (int)sizeof(T));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// h = a * h + b, the multiply and the add each rounded (no FMA).
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

__device__ __forceinline__ float load_h0(const void* h0, int h0_dtype, size_t i) {
  if (!h0) return 0.f;
  return h0_dtype == 0 ? static_cast<const float*>(h0)[i]
                       : __bfloat162float(static_cast<const __nv_bfloat16*>(h0)[i]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Fill one stage (steps [t0, t0 + S) of this block's channels) of a and b:
// 16-byte cp.async pieces when `vec`, else plain element loads.
template <typename T>
__device__ __forceinline__ void fill(T* sa, T* sb, const T* __restrict__ a,
                                     const T* __restrict__ b, size_t base,
                                     int t0, int Tlen, int D, int c0, bool vec) {
  constexpr int S = ring_steps<T>();
  constexpr int PER = 16 / sizeof(T);            // elements a piece
  constexpr int PIECES = RING_CH / PER;          // pieces a row
  const int rows = min(S, Tlen - t0);
  if (rows <= 0) return;
  if (vec) {
    for (int e = threadIdx.x; e < 2 * S * PIECES; e += RING_CH) {
      const int which = e / (S * PIECES), rem = e - which * S * PIECES;
      const int row = rem / PIECES, col = (rem - row * PIECES) * PER;
      if (row >= rows || c0 + col >= D) continue;
      const size_t g = base + (size_t)(t0 + row) * D + col;
      T* dst = (which ? sb : sa) + row * RING_CH + col;
      cp_async16(dst, (which ? b : a) + g);
    }
  } else if (c0 + (int)threadIdx.x < D) {
    const int c = threadIdx.x;
    for (int row = 0; row < rows; ++row) {
      const size_t g = base + (size_t)(t0 + row) * D + c;
      sa[row * RING_CH + c] = a[g];
      sb[row * RING_CH + c] = b[g];
    }
  }
}

// Grid (ceil(D / 64), B), 64 threads; dynamic shared memory: the ring.
template <typename T>
__global__ void __launch_bounds__(RING_CH)
diag_scan_ring(const T* __restrict__ a, const T* __restrict__ b,
               const void* __restrict__ h0, int h0_dtype, T* __restrict__ h,
               T* __restrict__ hT, int Tlen, int D, int vec) {
  constexpr int S = ring_steps<T>();
  extern __shared__ __align__(16) unsigned char ring_raw[];
  T* ring = reinterpret_cast<T*>(ring_raw);      // [stage][a | b][S][64]
  const int c = threadIdx.x;
  const int c0 = blockIdx.x * RING_CH;
  const int d = c0 + c;
  const bool live = d < D;
  const size_t base = (size_t)blockIdx.y * Tlen * D + c0;   // (b, t = 0, c0)
  const int tiles = (Tlen + S - 1) / S;
  auto sa = [&](int tile) { return ring + (size_t)(tile % RING_STAGES) * 2 * S * RING_CH; };

#pragma unroll
  for (int s = 0; s < RING_STAGES - 1; ++s) {
    fill(sa(s), sa(s) + S * RING_CH, a, b, base, s * S, Tlen, D, c0, vec);
    cp_async_commit();
  }
  float carry = live ? load_h0(h0, h0_dtype, (size_t)blockIdx.y * D + d) : 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<RING_STAGES - 2>();            // this tile's copies landed
    __syncthreads();                             // all of them; the stage
                                                 // refilled next is read out
    const int ahead = tile + RING_STAGES - 1;
    fill(sa(ahead), sa(ahead) + S * RING_CH, a, b, base, ahead * S, Tlen, D,
         c0, vec);
    cp_async_commit();
    if (!live) continue;
    const T* ta = sa(tile) + c;
    const T* tb = ta + S * RING_CH;
    T* out = h + base + (size_t)tile * S * D + c;
    const int rows = min(S, Tlen - tile * S);
    if (rows == S) {
#pragma unroll 16
      for (int i = 0; i < S; ++i) {
        carry = step(to_f(ta[i * RING_CH]), carry, to_f(tb[i * RING_CH]));
        put(out + (size_t)i * D, carry);
      }
    } else {
      for (int i = 0; i < rows; ++i) {
        carry = step(to_f(ta[i * RING_CH]), carry, to_f(tb[i * RING_CH]));
        put(out + (size_t)i * D, carry);
      }
    }
  }
  cp_async_wait<0>();
  if (live) put(hT + (size_t)blockIdx.y * D + d, carry);
}

// ---------------------------------------------------------------------------
// Backward: the ring walked from the last time step down
// ---------------------------------------------------------------------------
template <typename T>
__host__ __device__ constexpr int bwd_steps() {    // time steps a stage
  return BWD_STAGE_BYTES / (3 * RING_CH * (int)sizeof(T));
}

// Fill one stage of the backward: steps [t0, t0 + rows) of a and g, and h's
// rows t0 - 1 .. t0 + rows - 2 (row -1, h0, is not loaded), 16-byte
// cp.async pieces when `vec`, else plain element loads.
template <typename T>
__device__ __forceinline__ void fill_bwd(T* st, const T* __restrict__ a,
                                         const T* __restrict__ g,
                                         const T* __restrict__ h, size_t base,
                                         int t0, int rows, int D, int c0,
                                         bool vec) {
  constexpr int S = bwd_steps<T>();
  constexpr int PER = 16 / sizeof(T);
  constexpr int PIECES = RING_CH / PER;
  if (rows <= 0) return;
  if (vec) {
    for (int e = threadIdx.x; e < 3 * S * PIECES; e += RING_CH) {
      const int which = e / (S * PIECES), rem = e - which * S * PIECES;
      const int row = rem / PIECES, col = (rem - row * PIECES) * PER;
      const int t = t0 + row - (which == 2);
      if (row >= rows || t < 0 || c0 + col >= D) continue;
      const T* src = which == 0 ? a : which == 1 ? g : h;
      cp_async16(st + (which * S + row) * RING_CH + col,
                 src + base + (size_t)t * D + col);
    }
  } else if (c0 + (int)threadIdx.x < D) {
    const int c = threadIdx.x;
    for (int row = 0; row < rows; ++row) {
      const size_t g0 = base + (size_t)(t0 + row) * D + c;
      st[row * RING_CH + c] = a[g0];
      st[(S + row) * RING_CH + c] = g[g0];
      if (t0 + row > 0) st[(2 * S + row) * RING_CH + c] = h[g0 - D];
    }
  }
}

// Grid (ceil(D / 64), B), 64 threads; dynamic shared memory: the ring.
// da, db: [B, T, D] in T; dh0: [B, D] fp32 or null; gT: [B, D] in T or null.
template <typename T>
__global__ void __launch_bounds__(RING_CH)
diag_scan_bwd_ring(const T* __restrict__ a, const T* __restrict__ h,
                   const T* __restrict__ g, const T* __restrict__ gT,
                   const void* __restrict__ h0, int h0_dtype,
                   T* __restrict__ da, T* __restrict__ db,
                   float* __restrict__ dh0, int Tlen, int D, int vec) {
  constexpr int S = bwd_steps<T>();
  extern __shared__ __align__(16) unsigned char ring_raw[];
  T* ring = reinterpret_cast<T*>(ring_raw);      // [stage][a | g | h][S][64]
  const int c = threadIdx.x;
  const int c0 = blockIdx.x * RING_CH;
  const int d = c0 + c;
  const bool live = d < D;
  const size_t base = (size_t)blockIdx.y * Tlen * D + c0;
  const int tiles = (Tlen + S - 1) / S;
  // the j-th stage walked holds tile tiles - 1 - j: steps from its t0
  auto stage = [&](int j) { return ring + (size_t)(j % RING_STAGES) * 3 * S * RING_CH; };
  auto t0_of = [&](int j) { return (tiles - 1 - j) * S; };
  auto rows_of = [&](int j) { return j < tiles ? min(S, Tlen - t0_of(j)) : 0; };

#pragma unroll
  for (int j = 0; j < RING_STAGES - 1; ++j) {
    fill_bwd(stage(j), a, g, h, base, t0_of(j), rows_of(j), D, c0, vec);
    cp_async_commit();
  }
  float mu = 0.f, hm1 = 0.f;
  if (live) {
    const size_t i = (size_t)blockIdx.y * D + d;
    if (gT) mu = to_f(gT[i]);
    hm1 = load_h0(h0, h0_dtype, i);
  }
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<RING_STAGES - 2>();            // this stage's copies landed
    __syncthreads();                             // all of them; the stage
                                                 // refilled next is read out
    const int ahead = j + RING_STAGES - 1;
    fill_bwd(stage(ahead), a, g, h, base, t0_of(ahead), rows_of(ahead), D,
             c0, vec);
    cp_async_commit();
    if (!live) continue;
    const T* sa = stage(j) + c;
    const T* sg = sa + S * RING_CH;
    const T* sh = sg + S * RING_CH;
    const int t0 = t0_of(j);
    const size_t off = base + (size_t)t0 * D + c;
    for (int i = rows_of(j) - 1; i >= 0; --i) {
      const float lam = __fadd_rn(to_f(sg[i * RING_CH]), mu);
      const float hp = (t0 + i == 0) ? hm1 : to_f(sh[i * RING_CH]);
      put(db + off + (size_t)i * D, lam);
      put(da + off + (size_t)i * D, __fmul_rn(lam, hp));
      mu = __fmul_rn(to_f(sa[i * RING_CH]), lam);
    }
  }
  cp_async_wait<0>();
  if (live && dh0) dh0[(size_t)blockIdx.y * D + d] = mu;
}

// 8 elements at p as fp32: one or two 16-byte loads when `vec`, else the
// first n (0..8) one by one and zeros past them.
__device__ __forceinline__ void load8(const float* p, bool vec, int n, float* out) {
  if (vec) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    const float4 y = *reinterpret_cast<const float4*>(p + 4);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
    out[4] = y.x; out[5] = y.y; out[6] = y.z; out[7] = y.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = i < n ? p[i] : 0.f;
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, bool vec, int n, float* out) {
  if (vec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = i < n ? __bfloat162float(p[i]) : 0.f;
  }
}
__device__ __forceinline__ void store8(float* p, bool vec, int n, const float* v) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[i] = v[i];
  }
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, bool vec, int n, const float* v) {
  if (vec) {
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// T = 1 over the N = B * D channels, flat: grid ceil(N / 1024), 128 threads.
// `vec`: every pointer 16-byte aligned (each thread's 8 elements then are).
template <typename T>
__global__ void __launch_bounds__(STEP_THREADS)
diag_scan_step(const T* __restrict__ a, const T* __restrict__ b,
               const void* __restrict__ h0, int h0_dtype, T* __restrict__ h,
               T* __restrict__ hT, long long N, int vec) {
  const long long i0 =
      ((long long)blockIdx.x * STEP_THREADS + threadIdx.x) * STEP_PER_THREAD;
  if (i0 >= N) return;
  const int n = (int)min((long long)STEP_PER_THREAD, N - i0);
  const bool v = vec && n == STEP_PER_THREAD;
  float av[8], bv[8], hv[8];
  load8(a + i0, v, n, av);
  load8(b + i0, v, n, bv);
  if (!h0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) hv[i] = 0.f;
  } else if (h0_dtype == 0) {
    load8(static_cast<const float*>(h0) + i0, v, n, hv);
  } else {
    load8(static_cast<const __nv_bfloat16*>(h0) + i0, v, n, hv);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) hv[i] = step(av[i], hv[i], bv[i]);
  store8(h + i0, v, n, hv);
  store8(hT + i0, v, n, hv);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* a, const void* b, const void* h0, int h0_dtype, void* h,
           void* hT, int B, int Tlen, int D, cudaStream_t stream) {
  const bool ptrs = aligned16(a) && aligned16(b) && aligned16(h) && aligned16(hT) &&
                    (!h0 || aligned16(h0));
  if (Tlen == 1) {
    const long long N = (long long)B * D;
    const long long per_block = (long long)STEP_THREADS * STEP_PER_THREAD;
    diag_scan_step<T><<<(unsigned)((N + per_block - 1) / per_block), STEP_THREADS,
                        0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), h0, h0_dtype,
        static_cast<T*>(h), static_cast<T*>(hT), N, ptrs);
    return (int)cudaGetLastError();
  }
  const int smem = RING_STAGES * RING_STAGE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      diag_scan_ring<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = ptrs && (D * (int)sizeof(T)) % 16 == 0;
  dim3 grid((D + RING_CH - 1) / RING_CH, B);
  diag_scan_ring<T><<<grid, RING_CH, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, h0_dtype,
      static_cast<T*>(h), static_cast<T*>(hT), Tlen, D, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* a, const void* h, const void* g, const void* gT,
               const void* h0, int h0_dtype, void* da, void* db, float* dh0,
               int B, int Tlen, int D, cudaStream_t stream) {
  const int smem = RING_STAGES * BWD_STAGE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      diag_scan_bwd_ring<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = aligned16(a) && aligned16(h) && aligned16(g) &&
                  (D * (int)sizeof(T)) % 16 == 0;
  dim3 grid((D + RING_CH - 1) / RING_CH, B);
  diag_scan_bwd_ring<T><<<grid, RING_CH, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(g), static_cast<const T*>(gT), h0, h0_dtype,
      static_cast<T*>(da), static_cast<T*>(db), dh0, Tlen, D, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// How a call of shape [B, T, D] in dtype (0 = float32, 1 = bfloat16) runs:
// route (0 = the ring, T > 1; 1 = the step, T = 1), blocks, threads a block,
// channels a block (ring) or a thread (step), time steps a stage, stages,
// and dynamic shared memory bytes a block. Returns 0, or
// cudaErrorInvalidValue for a shape or dtype the kernels do not take.
int diag_scan_plan(int dtype, int B, int T, int D, int* route, int* blocks,
                   int* threads, int* channels, int* steps, int* stages,
                   int* smem_bytes) {
  if ((dtype != 0 && dtype != 1) || B < 0 || T < 1 || D < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  if (T == 1) {
    const long long per_block = (long long)STEP_THREADS * STEP_PER_THREAD;
    *route = 1;
    *blocks = (int)(((long long)B * D + per_block - 1) / per_block);
    *threads = STEP_THREADS;
    *channels = STEP_PER_THREAD;
    *steps = 1;
    *stages = 0;
    *smem_bytes = 0;
  } else {
    *route = 0;
    *blocks = (D + RING_CH - 1) / RING_CH * B;
    *threads = RING_CH;
    *channels = RING_CH;
    *steps = RING_STAGE_BYTES / (2 * RING_CH * elem);
    *stages = RING_STAGES;
    *smem_bytes = RING_STAGES * RING_STAGE_BYTES;
  }
  return 0;
}

// dtype (of a, b, h, h_T): 0 = float32, 1 = bfloat16. a, b, h: [B, T, D];
// h_T: [B, D]; h0: [B, D] in h0_dtype (0 = float32, 1 = bfloat16), or null
// for zeros; all contiguous. Returns cudaGetLastError() after the launch.
int diag_scan_fwd(int dtype, const void* a, const void* b, const void* h0,
                  int h0_dtype, void* h, void* hT, int B, int T, int D,
                  void* stream) {
  if (B < 0 || T < 1 || D < 1 || B > 65535 ||
      (h0 && h0_dtype != 0 && h0_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, b, h0, h0_dtype, h, hT, B, T, D, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0, h0_dtype, h, hT, B, T, D, s);
  return (int)cudaErrorInvalidValue;
}

// How a backward call of shape [B, T, D] in dtype runs: blocks, threads a
// block, time steps a stage, stages and dynamic shared memory bytes a
// block. Returns 0, or cudaErrorInvalidValue for a shape or dtype the
// kernel does not take.
int diag_scan_bwd_plan(int dtype, int B, int T, int D, int* blocks,
                       int* threads, int* steps, int* stages, int* smem_bytes) {
  if ((dtype != 0 && dtype != 1) || B < 0 || T < 1 || D < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  *blocks = (D + RING_CH - 1) / RING_CH * B;
  *threads = RING_CH;
  *steps = dtype == 0 ? bwd_steps<float>() : bwd_steps<__nv_bfloat16>();
  *stages = RING_STAGES;
  *smem_bytes = RING_STAGES * BWD_STAGE_BYTES;
  return 0;
}

// The backward of diag_scan_fwd. dtype (of a, h, g, gT, da, db): 0 =
// float32, 1 = bfloat16. a, h (the forward's output), g (its cotangent),
// da, db: [B, T, D]; gT (the cotangent of h_T) [B, D] or null for zeros;
// h0 [B, D] in h0_dtype or null for zeros; dh0 [B, D] fp32, or null when
// the forward had no h0. All contiguous. Returns cudaGetLastError() after
// the launch.
int diag_scan_bwd(int dtype, const void* a, const void* h, const void* g,
                  const void* gT, const void* h0, int h0_dtype, void* da,
                  void* db, void* dh0, int B, int T, int D, void* stream) {
  if (B < 0 || T < 1 || D < 1 || B > 65535 ||
      (h0 && h0_dtype != 0 && h0_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dh = static_cast<float*>(dh0);
  if (dtype == 0)
    return launch_bwd<float>(a, h, g, gT, h0, h0_dtype, da, db, dh, B, T, D, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, h, g, gT, h0, h0_dtype, da, db, dh, B,
                                     T, D, s);
  return (int)cudaErrorInvalidValue;
}

const char* diag_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
