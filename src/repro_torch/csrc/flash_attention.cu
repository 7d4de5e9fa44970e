// Flash attention forward for Hopper (sm_90a), fp32 or bf16 in, fp32 math.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py). Same function: online
// softmax attention with GQA (query head h reads kv head h / G), causal,
// sliding-window, q_offset and kv_len masks, out = acc / max(l, 1e-20).
//
// Layout: q, o [B, H, Tq, D]; k, v [B, KH, Tk, D]; all contiguous; D <= 256.
// Grid: (ceil(Tq / 64), H, B); one block of 256 threads per 64-row q tile.
// The block walks 64-key tiles of k and v staged in shared memory as fp32
// and keeps m, l and the output accumulator in registers (fp32). Thread
// (ty, tx) of a 16 x 16 grid owns rows 4*ty .. 4*ty+3 of the tile, score
// columns tx + 16*j and output columns tx + 16*j; a row's 16 threads sit in
// one half-warp, so row max and row sum are half-warp shuffles. The kernel
// is compiled twice, for D <= 128 and for D <= 256 (recurrentgemma's heads):
// the accumulator holds 4 x DJ floats a thread, DJ = 8 or 16, so the
// narrow heads keep their registers. At D = 256 the staged q, k, v and the
// probabilities take 214 KB of shared memory (one block per SM), under the
// 227 KB a block may opt into.
//
// Masked blocks are skipped through the loop bounds (causal end, window
// start). Masked scores are filled with -1e30 as on the TPU, and their
// probabilities are set to 0 explicitly, so a row whose first visited tile
// is fully masked adds nothing (the TPU kernel relies on a later live
// block's correction factor to wipe that contribution).
//
// What bounds it on the H100: at qwen3-0.6b's prefill (T = 512, D = 128) the
// bytes are ~25 MB against ~4 GFLOP of causal attention, so the floor is
// memory (~7.5 us at 3.35 TB/s); at recurrentgemma-9b's (B = 4, 16 heads
// over 1 kv head, T = 2100, D = 256, window 2048) ~146 MB against 0.145
// TFLOP, so the floor is the bf16 tensor-core rate (0.146 ms), and the
// fp32 FMA rate this kernel uses puts its own floor at ~2.2 ms. This first
// version does its products as
// scalar fp32 FMAs from shared memory, so in practice it is bound by shared
// memory loads and FMA throughput, far above that floor; tensor-core tiles
// (mma.sync / wgmma) and TMA staging are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int D_NARROW = 128;      // DJ = 8
constexpr int D_MAX = 256;         // DJ = 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * (BK + 1));
}

template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KH,
                 int Tq, int Tk, int D, float scale, int causal,
                 int has_window, int window, int q_offset, int kv_len) {
  extern __shared__ float smem[];
  const int ld = D + 1;        // padded rows: column reads hit distinct banks
  const int ldp = BK + 1;
  float* sQ = smem;
  float* sK = sQ + BQ * ld;
  float* sV = sK + BK * ld;
  float* sP = sV + BK * ld;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* qb = q + ((size_t)b * H + h) * Tq * D;
  const T* kb = k + ((size_t)b * KH + kh) * Tk * D;
  const T* vb = v + ((size_t)b * KH + kh) * Tk * D;
  T* ob = o + ((size_t)b * H + h) * Tq * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    sQ[r * ld + d] = (q0 + r < Tq) ? to_f(qb[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  // live key range of this q tile, in whole 64-key tiles
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQ, Tq) - 1;
  int k_end = min(Tk, kv_len);
  if (causal) k_end = min(k_end, qpos_hi + 1);
  int k_begin = has_window ? max(0, qpos_lo - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers of sK / sV / sP are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      const bool in = k0 + r < Tk;
      const size_t off = (size_t)(k0 + r) * D + d;
      sK[r * ld + d] = in ? to_f(kb[off]) : 0.f;
      sV[r * ld + d] = in ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qpos_lo + ty * 4 + i;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        live[j] = kpos < kv_len && (!causal || kpos <= qpos) &&
                  (!has_window || kpos > qpos - window);
        s[i][j] = live[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty * 4 + i) * ldp + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * ldp + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = sV[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(&ob[(size_t)r * D + d], acc[i][j] / den);
    }
  }
}

template <typename T, int DJ>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KH, int Tq, int Tk, int D, float scale, int causal,
           int has_window, int window, int q_offset, int kv_len,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Tq, Tk, D, scale,
      causal, has_window, window, q_offset, kv_len);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for_width(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KH, int Tq, int Tk, int D, float scale,
                     int causal, int has_window, int window, int q_offset,
                     int kv_len, cudaStream_t stream) {
  if (D <= D_NARROW)
    return launch<T, D_NARROW / 16>(q, k, v, o, B, H, KH, Tq, Tk, D, scale,
                                    causal, has_window, window, q_offset,
                                    kv_len, stream);
  return launch<T, D_MAX / 16>(q, k, v, o, B, H, KH, Tq, Tk, D, scale, causal,
                               has_window, window, q_offset, kv_len, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                        void* o, int B, int H, int KH, int Tq, int Tk, int D,
                        float scale, int causal, int has_window, int window,
                        int q_offset, int kv_len, void* stream) {
  if (D < 1 || D > D_MAX || KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_for_width<float>(q, k, v, o, B, H, KH, Tq, Tk, D, scale,
                                   causal, has_window, window, q_offset,
                                   kv_len, s);
  if (dtype == 1)
    return launch_for_width<__nv_bfloat16>(q, k, v, o, B, H, KH, Tq, Tk, D,
                                           scale, causal, has_window, window,
                                           q_offset, kv_len, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
