// Chunked GLA scan (the RWKV6 wkv core), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gla_kernel` / `gla_scan_kernel`
// (src/repro/kernels/linear_scan/kernel.py). Same function, per row b (one
// (batch, head) pair) and chunk of L tokens, with w the log decays (<= 0),
// c = cumsum(w) over the chunk, c_L its last row, and S carried in fp32 from
// chunk to chunk (zero at the start):
//
//   q_inter = r * e^{c - w}          q_intra = r * e^{c - w - c_L}
//   k_intra = k * e^{c_L - c}        A = q_intra k_intra^T, strictly lower
//   o = q_inter S + A v + (sum_d r u k) v
//   S <- e^{c_L} S + k_intra^T v
//
// o is written in v's dtype and the final S in fp32. Inputs are fp32 or bf16
// (one dtype for all five) and are widened to fp32 on load; every product is
// an fp32 FMA, as the reference's preferred_element_type=f32 asks (no TF32).
//
// Layout: r, k, w [B, T, Dk]; v, o [B, T, Dv]; u [B, Dk]; s_out [B, Dk, Dv];
// T is a multiple of the chunk (the wrapper pads).
//
// What bounds it on the H100: per (row, chunk) it does 2 L Dk Dv (q_inter S)
// + L (L - 1) Dk (A, strictly lower) + L (L - 1) Dv (A v) + 2 L Dk Dv (state)
// flops on L (3 Dk + Dv) input elements, about 56 flops per input byte at
// L = 64, Dk = Dv = 80 in bf16; in fp32 FMAs (67 TFLOP/s) that is above the
// card's ridge point (20 flops per byte), so the floor is the flops. The
// design:
// * the TPU kernel carries S in VMEM scratch across a sequential grid axis;
//   here blocks run in no order, so the chunk loop runs inside the block:
//   one block per (row, Dv tile), its S tile [Dk, tile] resident in fp32 in
//   shared memory for the whole sequence. The wrapper cuts Dv into tiles so
//   that there are at least as many blocks as SMs (B = 128 rows at the served
//   shape is under the 132 SMs); each tile recomputes A, which is small;
// * each chunk's r, k, w rows and the tile's v columns are staged in shared
//   memory with 16-byte loads when the layout allows, widened to fp32;
// * the cumulative sums run as warp scans (a warp per Dk column, a lane per
//   two rows), which also write q_inter, q_intra and k_intra in place and
//   the bonus's partial sums;
// * the three products run from shared memory with a 4x4 register tile per
//   thread (operand rows padded to an odd stride against bank conflicts).
//   Tensor-core tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int L_MAX = 64;          // chunk length
constexpr int D_MAX = 128;         // Dk and Dv
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of T widened to fp32.
__device__ __forceinline__ void unpack(const uint4& raw, float* out, const float*) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Shared-memory layout, in floats (every offset a multiple of 4):
// r / q_inter, k / k_intra and w / q_intra [LP, LDK]; v [LP, TVp]; S [DKp,
// TVp]; A [LP, LP + 1]; bonus partial sums [WARPS, LP]; e^{c_L} [DKp]; u [DKp].
struct Layout {
  int LP, DKp, LDK, TVp, LA;
  __host__ __device__ Layout(int L, int Dk, int TV)
      : LP(round4(L)), DKp(round4(Dk)), LDK(round4(Dk) + 1), TVp(round4(TV)),
        LA(round4(L) + 1) {}
  __host__ __device__ size_t floats() const {
    return 3 * (size_t)LP * LDK + (size_t)LP * TVp + (size_t)DKp * TVp +
           (size_t)LP * LA + (size_t)WARPS * LP + 2 * (size_t)DKp;
  }
};

// Copy rows [0, rows) x cols [0, cols) of a row-major global tile (row stride
// `ld` elements) into shared memory (row stride `lds` floats), widened to
// fp32; 16-byte loads when `vec` (src 16-byte aligned, cols and ld multiples
// of 16 bytes).
template <typename T>
__device__ __forceinline__ void stage(float* dst, int lds, const T* __restrict__ src,
                                      int ld, int rows, int cols, bool vec) {
  constexpr int PER = 16 / sizeof(T);
  if (vec) {
    const int per_row = cols / PER;
    for (int e = threadIdx.x; e < rows * per_row; e += THREADS) {
      const int i = e / per_row, p = e - i * per_row;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + (size_t)i * ld + p * PER));
      float f[PER];
      unpack(raw, f, src);
      float* d = dst + i * lds + p * PER;
#pragma unroll
      for (int q = 0; q < PER; ++q) d[q] = f[q];
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int i = e / cols, c = e - i * cols;
      dst[i * lds + c] = to_f(src[(size_t)i * ld + c]);
    }
  }
}

// Grid (B, Dv tiles). Padding rows and columns of every shared buffer are
// zeroed once and never written again, so the 4x4 tiles may run over them.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gla_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const T* __restrict__ u, T* __restrict__ o,
                float* __restrict__ s_out, int T_len, int L, int Dk, int Dv,
                int TV, int vec_rkw, int vec_v) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(L, Dk, TV);
  const int LP = lay.LP, DKp = lay.DKp, LDK = lay.LDK, TVp = lay.TVp, LA = lay.LA;
  float* sR = smem;                       // r, then q_inter
  float* sK = sR + LP * LDK;              // k, then k_intra
  float* sW = sK + LP * LDK;              // w, then q_intra
  float* sV = sW + LP * LDK;
  float* sS = sV + LP * TVp;
  float* sA = sS + DKp * TVp;
  float* sP = sA + LP * LA;               // bonus partials; row 0 = the sums
  float* sE = sP + WARPS * LP;
  float* sU = sE + DKp;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * TV;
  const int tv = min(TV, Dv - c0);        // this tile's live columns
  const int RG = LP / 4, CG = TVp / 4, DG = DKp / 4;

  for (size_t i = tid; i < lay.floats(); i += THREADS) smem[i] = 0.f;
  __syncthreads();
  for (int d = tid; d < Dk; d += THREADS) sU[d] = to_f(u[(size_t)b * Dk + d]);

  const int n_chunks = T_len / L;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const size_t t0 = (size_t)b * T_len + (size_t)ch * L;   // first row
    __syncthreads();                      // the last chunk is done with all buffers
    stage(sR, LDK, r + t0 * Dk, Dk, L, Dk, vec_rkw);
    stage(sK, LDK, k + t0 * Dk, Dk, L, Dk, vec_rkw);
    stage(sW, LDK, w + t0 * Dk, Dk, L, Dk, vec_rkw);
    stage(sV, TVp, v + t0 * Dv + c0, Dv, L, tv, vec_v);
    __syncthreads();

    // Cumulative log decays: a warp per column d, lane l holds rows l and
    // l + 32. Then q_inter, q_intra, k_intra in place, and the bonus
    // sum_d r u k of each row, partial over this warp's columns.
    float bonus_lo = 0.f, bonus_hi = 0.f;
    const bool lo = lane < L, hi = lane + 32 < L;
    for (int d = warp; d < Dk; d += WARPS) {
      const float w_lo = lo ? sW[lane * LDK + d] : 0.f;
      const float w_hi = hi ? sW[(lane + 32) * LDK + d] : 0.f;
      float c_lo = w_lo, c_hi = w_hi;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y_lo = __shfl_up_sync(FULL, c_lo, off);
        const float y_hi = __shfl_up_sync(FULL, c_hi, off);
        if (lane >= off) {
          c_lo += y_lo;
          c_hi += y_hi;
        }
      }
      c_hi += __shfl_sync(FULL, c_lo, 31);
      const float c_last = __shfl_sync(FULL, c_hi, 31);
      if (lane == 0) sE[d] = expf(c_last);
      const float ud = sU[d];
      if (lo) {
        const int at = lane * LDK + d;
        const float rr = sR[at], kk = sK[at], ex = c_lo - w_lo;
        sR[at] = rr * expf(ex);
        sW[at] = rr * expf(ex - c_last);
        sK[at] = kk * expf(c_last - c_lo);
        bonus_lo = fmaf(rr * ud, kk, bonus_lo);
      }
      if (hi) {
        const int at = (lane + 32) * LDK + d;
        const float rr = sR[at], kk = sK[at], ex = c_hi - w_hi;
        sR[at] = rr * expf(ex);
        sW[at] = rr * expf(ex - c_last);
        sK[at] = kk * expf(c_last - c_hi);
        bonus_hi = fmaf(rr * ud, kk, bonus_hi);
      }
    }
    if (lane < LP) sP[warp * LP + lane] = bonus_lo;
    if (lane + 32 < LP) sP[warp * LP + lane + 32] = bonus_hi;
    __syncthreads();

    // A = q_intra k_intra^T on the 4x4 tiles on or below the diagonal,
    // strictly lower entries kept. And the bonus sums, into row 0 of sP.
    for (int tt = tid; tt < RG * (RG + 1) / 2; tt += THREADS) {
      int ti = (int)((sqrtf(8.f * tt + 1.f) - 1.f) * 0.5f);
      while ((ti + 1) * (ti + 2) / 2 <= tt) ++ti;
      while (ti * (ti + 1) / 2 > tt) --ti;
      const int tj = tt - ti * (ti + 1) / 2;
      const float* qa = sW + 4 * ti * LDK;
      const float* kb = sK + 4 * tj * LDK;
      float acc[4][4] = {};
      for (int d = 0; d < Dk; ++d) {
        float a[4], bb[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          a[x] = qa[x * LDK + d];
          bb[x] = kb[x * LDK + d];
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(a[x], bb[y], acc[x][y]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int i = 4 * ti + x, j = 4 * tj + y;
          sA[i * LA + j] = j < i ? acc[x][y] : 0.f;
        }
    }
    for (int i = tid; i < LP; i += THREADS) {
      float s = 0.f;
      for (int wp = 0; wp < WARPS; ++wp) s += sP[wp * LP + i];
      sP[i] = s;
    }
    __syncthreads();

    // o = q_inter S + A v + bonus v, a 4x4 tile (rows x columns) a thread.
    for (int tt = tid; tt < RG * CG; tt += THREADS) {
      const int rg = tt / CG, cg = tt - rg * CG, i0 = 4 * rg;
      float acc[4][4] = {};
      for (int d = 0; d < Dk; ++d) {
        const float4 sv = *reinterpret_cast<const float4*>(sS + d * TVp + 4 * cg);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float a = sR[(i0 + x) * LDK + d];
          acc[x][0] = fmaf(a, sv.x, acc[x][0]);
          acc[x][1] = fmaf(a, sv.y, acc[x][1]);
          acc[x][2] = fmaf(a, sv.z, acc[x][2]);
          acc[x][3] = fmaf(a, sv.w, acc[x][3]);
        }
      }
      for (int j = 0; j < i0 + 4; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + j * TVp + 4 * cg);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float a = sA[(i0 + x) * LA + j];
          acc[x][0] = fmaf(a, vv.x, acc[x][0]);
          acc[x][1] = fmaf(a, vv.y, acc[x][1]);
          acc[x][2] = fmaf(a, vv.z, acc[x][2]);
          acc[x][3] = fmaf(a, vv.w, acc[x][3]);
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = i0 + x;
        const float bo = sP[i];
        const float4 vv = *reinterpret_cast<const float4*>(sV + i * TVp + 4 * cg);
        const float ov[4] = {fmaf(bo, vv.x, acc[x][0]), fmaf(bo, vv.y, acc[x][1]),
                             fmaf(bo, vv.z, acc[x][2]), fmaf(bo, vv.w, acc[x][3])};
        if (i < L) {
          T* orow = o + (t0 + i) * Dv + c0;
#pragma unroll
          for (int y = 0; y < 4; ++y)
            if (4 * cg + y < tv) store(orow + 4 * cg + y, ov[y]);
        }
      }
    }
    __syncthreads();                      // every o tile has read the old S

    // S <- e^{c_L} S + k_intra^T v, a 4x4 tile (Dk rows x columns) a thread.
    for (int tt = tid; tt < DG * CG; tt += THREADS) {
      const int dg = tt / CG, cg = tt - dg * CG, d0 = 4 * dg;
      float acc[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float e = sE[d0 + x];
        const float4 sv = *reinterpret_cast<const float4*>(sS + (d0 + x) * TVp + 4 * cg);
        acc[x][0] = e * sv.x;
        acc[x][1] = e * sv.y;
        acc[x][2] = e * sv.z;
        acc[x][3] = e * sv.w;
      }
      for (int i = 0; i < L; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + i * TVp + 4 * cg);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float a = sK[i * LDK + d0 + x];
          acc[x][0] = fmaf(a, vv.x, acc[x][0]);
          acc[x][1] = fmaf(a, vv.y, acc[x][1]);
          acc[x][2] = fmaf(a, vv.z, acc[x][2]);
          acc[x][3] = fmaf(a, vv.w, acc[x][3]);
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
        *reinterpret_cast<float4*>(sS + (d0 + x) * TVp + 4 * cg) =
            make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
    }
  }
  __syncthreads();
  for (int e = tid; e < Dk * tv; e += THREADS) {
    const int d = e / tv, c = e - d * tv;
    s_out[((size_t)b * Dk + d) * Dv + c0 + c] = sS[d * TVp + c];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* o, float* s_out, int B, int T_len, int Dk,
           int Dv, int L, int TV, int vec_rkw, int vec_v, cudaStream_t stream) {
  const size_t smem = Layout(L, Dk, TV).floats() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gla_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (Dv + TV - 1) / TV;
  gla_scan_kernel<T><<<dim3(B, tiles), THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), static_cast<T*>(o),
      s_out, T_len, L, Dk, Dv, TV, vec_rkw, vec_v);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, u and o); s_out is fp32.
// chunk in [1, 64] divides T; Dk, Dv in [1, 128]; tv in [1, Dv] is the Dv
// tile of one block. vec_rkw / vec_v: the caller vouches that r, k, w (v)
// rows may be read with 16-byte loads. Returns cudaGetLastError() after the
// launch.
int gla_scan_fwd(int dtype, const void* r, const void* k, const void* v,
                 const void* w, const void* u, void* o, void* s_out, int B,
                 int T_len, int Dk, int Dv, int chunk, int tv, int vec_rkw,
                 int vec_v, void* stream) {
  if (chunk < 1 || chunk > L_MAX || T_len < 0 || T_len % chunk != 0 || Dk < 1 ||
      Dk > D_MAX || Dv < 1 || Dv > D_MAX || tv < 1 || tv > Dv || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* so = static_cast<float*>(s_out);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, o, so, B, T_len, Dk, Dv, chunk, tv,
                         vec_rkw, vec_v, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, o, so, B, T_len, Dk, Dv, chunk,
                                 tv, vec_rkw, vec_v, s);
  return (int)cudaErrorInvalidValue;
}

const char* linear_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
