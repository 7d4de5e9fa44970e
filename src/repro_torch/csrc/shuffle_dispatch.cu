// MoE shuffle dispatch and combine for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels `_dispatch_kernel` / `dispatch_kernel` and
// `_combine_kernel` / `combine_kernel`
// (src/repro/kernels/shuffle_dispatch/kernel.py). Same functions:
//
//   dispatch: out[e, c, :] = sum of x[t, :] over the pairs (t, k) with
//             expert_id[t, k] = e and slot[t, k] = c           [E, C, D]
//   combine:  out[t, :]    = sum over k of gate[t, k] * y[expert_id[t, k],
//                            slot[t, k], :]                     [N, D]
//
// A pair with expert_id outside [0, E) or slot outside [0, C) is dropped.
// x / y and the output are fp32 or bf16 (one type); gates fp32 or bf16; ids
// and slots int32; sums in fp32, written in the input's type. Any N and D:
// the TPU kernels' `T % block_t == 0` is a Pallas tiling rule.
//
// What bounds them on the H100: a handful of adds per element moved, so
// memory. At grok-1-314b's prefill (N = 2048 tokens, K = 2, E = 32 buffers,
// 4 batch rows x 8 experts, C = 160, D = 6144, bf16) dispatch reads x
// (25.2 MB) and writes the buffers (62.9 MB), 0.026 ms at 3.35 TB/s; combine
// reads the selected buffer rows (50.3 MB) and writes out (25.2 MB),
// 0.023 ms.
//
// The TPU builds one-hot masks in VMEM and turns both into MXU products. On
// Hopper they are gathers:
// * dispatch is output-stationary, as the TPU grid is: a block owns ROWS
//   (expert, slot) rows of the output and a tile of THREADS * 16 bytes of
//   columns. It walks the [N, K] assignment in token order, THREADS pairs at
//   a time; the pairs that land on its rows are compacted in order into
//   shared memory (warp ballots), and every thread adds those x rows into
//   its own columns of an fp32 accumulator in shared memory. Each output
//   element thus sums its pairs in token order: repeated slots add up as
//   the contract says, the bits do not depend on scheduling, and no atomics
//   are needed. Rows no pair lands on are written as zeros. The price is
//   that every block reads the whole assignment (from L2); a scatter with
//   one writer per pair is cheaper where slots are unique, and is later
//   work.
// * combine: one block per (token, column tile); each thread gathers the K
//   rows of its token and sums gate * row in fp32.
// Rows move in 16-byte loads and stores where D and the pointers allow.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;             // output rows of a dispatch block

template <typename T> struct Vec;   // elements in 16 bytes
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of a row as fp32, from `p`; `n` elements lie inside the row,
// `vec`: one aligned 16-byte load.
__device__ __forceinline__ void load_vec(const float* p, bool vec, int n,
                                         float* out) {
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = i < n ? p[i] : 0.f;
  }
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, bool vec,
                                         int n, float* out) {
  if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = i < n ? __bfloat162float(p[i]) : 0.f;
  }
}

__device__ __forceinline__ void store_vec(float* p, bool vec, int n,
                                          const float* v) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) p[i] = v[i];
  }
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, bool vec, int n,
                                          const float* v) {
  if (vec) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[i] = __float2bfloat16(v[i]);
  }
}

// Grid (ceil(E*C / ROWS), ceil(D / (THREADS * V))). Dynamic shared memory:
// the fp32 accumulator, ROWS x THREADS x V floats, laid out so that thread
// i's q-th float4 of row r is acc[(r * V/4 + q) * THREADS + i] (a warp's
// float4 accesses are contiguous).
template <typename T>
__global__ void __launch_bounds__(THREADS)
dispatch_kernel(const T* __restrict__ x, const int* __restrict__ eid,
                const int* __restrict__ slot, T* __restrict__ out, int P,
                int K, int E, int C, int D, int vec_ok) {
  constexpr int V = Vec<T>::N;
  constexpr int Q = V / 4;                        // float4s a thread, a row
  extern __shared__ float4 acc[];
  __shared__ int s_row[THREADS];                  // a chunk's hits, in order
  __shared__ int s_tok[THREADS];
  __shared__ int s_warp[WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int r0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, E * C - r0);
  const int col = (blockIdx.y * THREADS + tid) * V;
  const int n = max(0, min(V, D - col));
  const bool vec = vec_ok && n == V;

#pragma unroll
  for (int i = 0; i < ROWS * Q; ++i)
    acc[i * THREADS + tid] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int base = 0; base < P; base += THREADS) {
    // which of this chunk's pairs land on the block's rows
    const int p = base + tid;
    int hit = -1;
    if (p < P) {
      const int e = eid[p], s = slot[p];
      if (e >= 0 && e < E && s >= 0 && s < C) {
        const int r = e * C + s - r0;
        if (r >= 0 && r < rows) hit = r;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit >= 0);
    if (lane == 0) s_warp[w] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      before += i < w ? s_warp[i] : 0;
      total += s_warp[i];
    }
    if (hit >= 0) {
      const int at = before + __popc(ballot & ((1u << lane) - 1u));
      s_row[at] = hit;
      s_tok[at] = p / K;
    }
    __syncthreads();
    // add the hits' x rows, in token order, into this thread's columns
    if (n > 0) {
      for (int i = 0; i < total; ++i) {
        float xv[V];
        load_vec(x + (size_t)s_tok[i] * D + col, vec, n, xv);
        float4* a = acc + (size_t)s_row[i] * Q * THREADS + tid;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          float4 v = a[q * THREADS];
          v.x += xv[4 * q];
          v.y += xv[4 * q + 1];
          v.z += xv[4 * q + 2];
          v.w += xv[4 * q + 3];
          a[q * THREADS] = v;
        }
      }
    }
    __syncthreads();                              // the next chunk reuses s_*
  }

  if (n == 0) return;
  for (int r = 0; r < rows; ++r) {
    float v[V];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 a = acc[(r * Q + q) * THREADS + tid];
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
    store_vec(out + (size_t)(r0 + r) * D + col, vec, n, v);
  }
}

// Grid (N, ceil(D / (THREADS * V))).
template <typename T, typename G>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const T* __restrict__ y, const int* __restrict__ eid,
               const int* __restrict__ slot, const G* __restrict__ gates,
               T* __restrict__ out, int K, int E, int C, int D, int vec_ok) {
  constexpr int V = Vec<T>::N;
  const int col = (blockIdx.y * THREADS + threadIdx.x) * V;
  const int n = max(0, min(V, D - col));
  if (n == 0) return;
  const bool vec = vec_ok && n == V;
  const size_t t = blockIdx.x;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  for (int k = 0; k < K; ++k) {
    const size_t p = t * K + k;
    const int e = eid[p], s = slot[p];
    if (e < 0 || e >= E || s < 0 || s >= C) continue;
    const float g = to_f(gates[p]);
    float yv[V];
    load_vec(y + ((size_t)e * C + s) * D + col, vec, n, yv);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(g, yv[i], acc[i]);
  }
  store_vec(out + t * D + col, vec, n, acc);
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) |
           reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

template <typename T>
int launch_dispatch(const void* x, const int* eid, const int* slot, void* out,
                    int N, int K, int E, int C, int D, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int cols = THREADS * V;
  const int smem = ROWS * cols * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dispatch_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((E * C + ROWS - 1) / ROWS, (D + cols - 1) / cols);
  const int vec_ok = D % V == 0 && aligned16(x, out);
  dispatch_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), eid, slot, static_cast<T*>(out), N * K, K, E,
      C, D, vec_ok);
  return (int)cudaGetLastError();
}

template <typename T, typename G>
int launch_combine(const void* y, const int* eid, const int* slot,
                   const void* gates, void* out, int N, int K, int E, int C,
                   int D, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int cols = THREADS * V;
  const dim3 grid(N, (D + cols - 1) / cols);
  const int vec_ok = D % V == 0 && aligned16(y, out);
  combine_kernel<T, G><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(y), eid, slot, static_cast<const G*>(gates),
      static_cast<T*>(out), K, E, C, D, vec_ok);
  return (int)cudaGetLastError();
}

bool bad_sizes(int N, int K, int E, int C, int D) {
  const int max_tiles = 65535;                    // gridDim.y
  return N < 0 || K < 0 || E < 0 || C < 0 || D < 0 ||
         (long long)N * K > INT_MAX || (long long)E * C > INT_MAX ||
         (D + THREADS * 4 - 1) / (THREADS * 4) > max_tiles;
}

}  // namespace

extern "C" {

// dtype (of x and out): 0 = float32, 1 = bfloat16. x: [N, D]; expert_id,
// slot: [N, K] int32; out: [E, C, D]; all contiguous. Returns
// cudaGetLastError() after the launch.
int shuffle_dispatch_fwd(int dtype, const void* x, const int* expert_id,
                         const int* slot, void* out, int N, int K, int E,
                         int C, int D, void* stream) {
  if (bad_sizes(N, K, E, C, D)) return (int)cudaErrorInvalidValue;
  if (E * C == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dispatch<float>(x, expert_id, slot, out, N, K, E, C, D, s);
  if (dtype == 1)
    return launch_dispatch<__nv_bfloat16>(x, expert_id, slot, out, N, K, E, C,
                                          D, s);
  return (int)cudaErrorInvalidValue;
}

// dtype (of y and out) and gate_dtype: 0 = float32, 1 = bfloat16. y:
// [E, C, D]; expert_id, slot: [N, K] int32; gates: [N, K]; out: [N, D]; all
// contiguous. Returns cudaGetLastError() after the launch.
int shuffle_combine_fwd(int dtype, int gate_dtype, const void* y,
                        const int* expert_id, const int* slot,
                        const void* gates, void* out, int N, int K, int E,
                        int C, int D, void* stream) {
  if (bad_sizes(N, K, E, C, D)) return (int)cudaErrorInvalidValue;
  if (N == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  const int* e = expert_id;
  if (dtype == 0 && gate_dtype == 0)
    return launch_combine<float, float>(y, e, slot, gates, out, N, K, E, C, D, s);
  if (dtype == 0 && gate_dtype == 1)
    return launch_combine<float, bf16>(y, e, slot, gates, out, N, K, E, C, D, s);
  if (dtype == 1 && gate_dtype == 0)
    return launch_combine<bf16, float>(y, e, slot, gates, out, N, K, E, C, D, s);
  if (dtype == 1 && gate_dtype == 1)
    return launch_combine<bf16, bf16>(y, e, slot, gates, out, N, K, E, C, D, s);
  return (int)cudaErrorInvalidValue;
}

const char* shuffle_dispatch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
