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
// (one dtype for all five); S and every sum stay fp32.
//
// Layout: r, k, w [B, T, Dk]; v, o [B, T, Dv]; u [B, Dk]; s_out [B, Dk, Dv];
// T is a multiple of the chunk (the wrapper pads).
//
// What bounds it on the H100: per (row, chunk) it does 2 L Dk Dv (q_inter S)
// + L (L - 1) Dk (A, strictly lower) + L (L - 1) Dv (A v) + 2 L Dk Dv (state)
// flops on L (3 Dk + Dv) input elements. At the served shape (B = 128 rows,
// T = 512, L = 64, Dk = Dv = 80, bf16) that is ~2.4 GFLOP on ~56 MB: 0.017
// ms of traffic, 0.035 ms of fp32 FMAs, a few microseconds on tensor cores.
// The TPU kernel carries S in VMEM scratch across a sequential grid axis;
// here blocks run in no order, so the chunk loop runs inside the block: one
// block per (row, Dv tile), its S tile resident in shared memory for the
// whole sequence. The wrapper cuts Dv into tiles so that there are at least
// as many blocks as SMs (128 rows are under the 132 SMs); each tile
// recomputes A. Two kernels, chosen by the inputs' dtype alone:
//
// * `gla_scan_mma` (bf16 inputs, any width): the four products of a chunk
//   (q_inter S, A = q_intra k_intra^T, A v, k_intra^T v) on the tensor cores,
//   mma.sync m16n8k16 with fp32 accumulation. Its operands are fp32 values
//   (r and k times exponentials of the cumulative decays, up to ~e^20 at
//   rwkv's decays; S; A), so each is split into two bf16 parts, x = hi + lo
//   with lo the bf16 rounding of x - hi (~16 bits kept, the exponent range
//   of fp32), and a product of two such operands takes three products (hi
//   hi, hi lo, lo hi); v is exact in bf16 and takes two. Rounded once, to
//   bf16 or to TF32, the operands miss GLA's bf16 tolerance (2e-2) at the
//   served shape with unit-scale r and k: the chunked plain version with
//   its operands so rounded lands up to 12x (bf16) and 1.5x (TF32) past it,
//   and the split 0.4x within it
//   (tests/test_torch_linear_scan.py::test_gla_operand_rounding_choice). On
//   the card the split route lands as close to the exact (fp64) scan as the
//   plain version in o, and within 4e-5 in S (chip_smoke.py's `gla_witness`
//   line). Per chunk: (1) the decay scans, a thread per (8 rows, 2 columns),
//   turn the staged inputs into the operands' bf16 planes, with the bonus's
//   partial sums; then the next chunk's r, k, w and v start arriving by
//   16-byte cp.async while (2) A, (3) o and (4) S run, a warp taking 16 x
//   16 of a product at a time with ldmatrix operands and the split's
//   products in separate accumulators. 512 threads; the operand planes keep
//   the block at one per SM, so 256 blocks run in two waves.
// * `gla_scan_kernel` (fp32 inputs): fp32 FMAs from shared memory with a 4x4
//   register tile per thread (operand rows padded to an odd stride against
//   bank conflicts), as the reference's preferred_element_type=f32 asks: the
//   fp32 tolerance (2e-4) rules out rounded operands. The chunk's inputs are
//   staged with 16-byte loads when the layout allows, and the cumulative sums
//   run as warp scans (a warp per Dk column, a lane per two rows).
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// 16 bytes of fp32.
__device__ __forceinline__ void unpack(const uint4& raw, float* out, const float*) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
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

// ---------------------------------------------------------------------------
// The tensor-core route, for bf16 inputs.

constexpr int MMA_THREADS = 512;
constexpr int MMA_WARPS = MMA_THREADS / 32;
constexpr int SMEM_MAX = 232448;   // shared memory a block may use (227 KB)

__host__ __device__ __forceinline__ int round_to(int x, int m) { return (x + m - 1) / m * m; }
// Row stride (elements) of a bf16 plane read by ldmatrix: a multiple of 8
// elements (16 bytes) with an odd number of 16-byte units, so that the 8
// rows of each 8 x 8 matrix fall in distinct banks.
__host__ __device__ __forceinline__ int ld_plane(int n) {
  return round_to(n, 8) % 16 ? round_to(n, 8) : round_to(n, 8) + 8;
}

// Shared memory of one block, every operand of the products as bf16 planes
// (x = hi + lo, each plane one bf16 of it; v is exact in one plane), then
// fp32 vectors, then one chunk's bf16 inputs as they arrive (r, k, w
// [L][Dk], this tile's v [L][TV]). LP and DKp are L and Dk rounded up to 16
// (the products' m and k steps), TVp the tile rounded up to 16 (two n-tiles
// at a time); padding is zero.
//   q_inter, q_intra, k_intra: hi and lo [LP][LDK]; A: hi and lo [LP][LDL];
//   v: [LP][LDV]; S: hi and lo [DKp][LDV] and fp32 [DKp][LDS];
//   fp32: bonus [LP], e^{c_L} [DKp], u [DKp], the bonus's partial sums by
//   column pair [LP][DKp / 2], the log decays' sums by 8-row segment and
//   column pair [LP / 8][DKp / 2] (float2).
struct MmaLayout {
  int LP, DKp, TVp, LDK, LDL, LDV, LDS, raw;   // raw: staged bf16 elements
  __host__ __device__ MmaLayout(int L, int Dk, int TV)
      : LP(round_to(L, 16)), DKp(round_to(Dk, 16)), TVp(round_to(TV, 16)),
        LDK(ld_plane(round_to(Dk, 16))), LDL(ld_plane(round_to(L, 16))),
        LDV(ld_plane(round_to(TV, 16))), LDS(round_to(TV, 16) + 8),
        raw(3 * L * Dk + L * TV) {}
  __host__ __device__ size_t planes() const {      // bf16 elements
    return 6 * (size_t)LP * LDK + 2 * (size_t)LP * LDL + (size_t)LP * LDV +
           2 * (size_t)DKp * LDV;
  }
  __host__ __device__ size_t floats() const {
    return (size_t)DKp * LDS + LP + 2 * (size_t)DKp + (size_t)LP * DKp / 2 +
           (size_t)LP * DKp / 8;
  }
  __host__ __device__ size_t raw_offset() const {  // bytes
    return round_to((int)(planes() * 2 + floats() * 4), 16);
  }
  __host__ __device__ size_t bytes() const { return raw_offset() + round_to(2 * raw, 16); }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// (x, y) = hi + lo: hi their bf16 rounding, lo the bf16 rounding of the rest
// (exact in fp32), so hi + lo keeps ~16 bits of each.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - f.x, y - f.y));
}
// c += a b on the tensor cores: a 16x16 (row), b 16x8 (col), bf16; c fp32.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l naming a row of
// matrix l / 8; with TRANS each arrives transposed.
template <bool TRANS>
__device__ __forceinline__ void ldm4(uint32_t* d, const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(s));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(s));
}
// The A operand of a 16 x 16 tile at p (row stride ld): element (m, k) at
// p[m * ld + k]; or at p[k * ld + m] when TRANS.
template <bool TRANS>
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* p, int ld, int lane) {
  if (TRANS)
    ldm4<true>(a, p + ((lane & 7) + 8 * (lane >> 4)) * ld + 8 * ((lane >> 3) & 1));
  else
    ldm4<false>(a, p + (lane & 15) * ld + 8 * (lane >> 4));
}
// The B operands of two n-tiles (16 k x 16 n) at p: b[0..1] the first
// n-tile's, b[2..3] the second's. Element (k, n) at p[k * ld + n]; or at
// p[n * ld + k] when NK.
template <bool NK>
__device__ __forceinline__ void frag_b2(uint32_t* b, const __nv_bfloat16* p, int ld, int lane) {
  if (NK)
    ldm4<false>(b, p + ((lane & 7) + 8 * (lane >> 4)) * ld + 8 * ((lane >> 3) & 1));
  else
    ldm4<true>(b, p + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4));
}

// Which 16-byte pieces of a chunk's rows a thread copies: piece `p` of rows
// i0, i0 + step, ... (threads past rows_per_pass * pieces copy none).
struct Pieces {
  int p, i0, step;
  __device__ Pieces(int pieces) {
    step = MMA_THREADS / pieces;
    p = threadIdx.x % pieces;
    i0 = threadIdx.x < step * pieces ? threadIdx.x / pieces : 1 << 30;
  }
};

// One chunk's r, k, w rows and this tile's v columns into the staging area:
// 16-byte cp.async pieces where the caller vouches for the layout, else
// plain element copies.
__device__ __forceinline__ void fill_chunk(__nv_bfloat16* raw, const __nv_bfloat16* __restrict__ r,
                                           const __nv_bfloat16* __restrict__ k,
                                           const __nv_bfloat16* __restrict__ w,
                                           const __nv_bfloat16* __restrict__ v, size_t t0,
                                           int L, int Dk, int Dv, int c0, int tv, int TV,
                                           int vec_rkw, int vec_v, const Pieces& prkw,
                                           const Pieces& pv) {
  const int n = L * Dk;
  if (vec_rkw) {
    for (int i = prkw.i0; i < L; i += prkw.step) {
      const size_t g = (t0 + i) * Dk + 8 * prkw.p;
      __nv_bfloat16* dst = raw + i * Dk + 8 * prkw.p;
      cp_async16(dst, r + g);
      cp_async16(dst + n, k + g);
      cp_async16(dst + 2 * n, w + g);
    }
  } else {
    for (int e = threadIdx.x; e < 3 * n; e += MMA_THREADS) {
      const int which = e / n, rem = e - which * n;
      const __nv_bfloat16* src = which == 0 ? r : which == 1 ? k : w;
      raw[e] = src[t0 * Dk + rem];
    }
  }
  __nv_bfloat16* rv = raw + 3 * n;
  if (vec_v) {
    for (int i = pv.i0; i < L; i += pv.step)
      cp_async16(rv + i * TV + 8 * pv.p, v + (t0 + i) * Dv + c0 + 8 * pv.p);
  } else {
    for (int e = threadIdx.x; e < L * tv; e += MMA_THREADS) {
      const int i = e / tv, c = e - i * tv;
      rv[i * TV + c] = v[(t0 + i) * Dv + c0 + c];
    }
  }
}

// e^x as ex2.approx.ftz of x log2(e): relative error ~2e-6 where |x| <= 30,
// far under the split's 2^-17.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.44269504f));
  return y;
}
// Columns d and d + 1 of a staged bf16 row as fp32, zero past Dk; one 4-byte
// load where Dk is even.
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* row, int d, int Dk) {
  if (!(Dk & 1)) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + d));
  return make_float2(d < Dk ? __bfloat162float(row[d]) : 0.f,
                     d + 1 < Dk ? __bfloat162float(row[d + 1]) : 0.f);
}

// Grid (B, Dv tiles), 512 threads. Per chunk: (1) the decay scans turn the
// staged inputs into the planes of q_inter, q_intra, k_intra, with the
// bonus's partial sums and v; then the next chunk's copies start; (2)
// A = q_intra k_intra^T, strictly lower, into its planes; (3) o = q_inter S
// + A v + bonus v, written out; (4) S <- e^{c_L} S + k_intra^T v in place.
// A warp takes 16 rows by 16 columns of a product at a time: operands by
// ldmatrix, the main product and the correction products of the split in
// separate accumulators (independent chains).
__global__ void __launch_bounds__(MMA_THREADS)
gla_scan_mma(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ w,
             const __nv_bfloat16* __restrict__ u, __nv_bfloat16* __restrict__ o,
             float* __restrict__ s_out, int T_len, int L, int Dk, int Dv, int TV,
             int vec_rkw, int vec_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaLayout lay(L, Dk, TV);
  const int LP = lay.LP, DKp = lay.DKp, LDK = lay.LDK, LDL = lay.LDL, LDV = lay.LDV,
            LDS = lay.LDS;
  using bf = __nv_bfloat16;
  bf* pRh = reinterpret_cast<bf*>(smem_raw);   // q_inter
  bf* pRl = pRh + LP * LDK;
  bf* pQh = pRl + LP * LDK;                     // q_intra
  bf* pQl = pQh + LP * LDK;
  bf* pKh = pQl + LP * LDK;                     // k_intra
  bf* pKl = pKh + LP * LDK;
  bf* pAh = pKl + LP * LDK;
  bf* pAl = pAh + LP * LDL;
  bf* pV = pAl + LP * LDL;
  bf* pSh = pV + LP * LDV;
  bf* pSl = pSh + DKp * LDV;
  float* sS = reinterpret_cast<float*>(smem_raw + lay.planes() * 2);
  float* sB = sS + DKp * LDS;             // bonus
  float* sE = sB + LP;                    // e^{c_L}
  float* sU = sE + DKp;
  float* pB = sU + DKp;                   // bonus partials [LP][DPl]
  float2* sG = reinterpret_cast<float2*>(pB + LP * DKp / 2);   // [LP / 8][DPl]
  bf* raw = reinterpret_cast<bf*>(smem_raw + lay.raw_offset());
  const bf* rawR = raw;
  const bf* rawK = raw + L * Dk;
  const bf* rawW = rawK + L * Dk;
  const bf* rawV = rawW + L * Dk;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * TV;
  const int tv = min(TV, Dv - c0);        // this tile's live columns
  const int MT = LP / 16, KT = DKp / 16, NP = lay.TVp / 16;
  // the decay scans: a thread per (segment of 8 rows, pair of columns)
  const int DPl = (Dk + 1) / 2, nseg = LP / 8;

  const Pieces prkw(max(1, Dk / 8)), pv(max(1, tv / 8));
  fill_chunk(raw, r, k, w, v, (size_t)b * T_len, L, Dk, Dv, c0, tv, TV, vec_rkw, vec_v,
             prkw, pv);
  cp_async_commit();
  {
    uint32_t* z = reinterpret_cast<uint32_t*>(smem_raw);
    for (size_t i = tid; i < lay.raw_offset() / 4; i += MMA_THREADS) z[i] = 0u;
  }
  __syncthreads();
  for (int d = tid; d < Dk; d += MMA_THREADS) sU[d] = __bfloat162float(u[(size_t)b * Dk + d]);

  const int n_chunks = T_len / L;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const size_t t0 = (size_t)b * T_len + (size_t)ch * L;   // first row
    cp_async_wait_all();
    __syncthreads();                      // this chunk staged; the last done

    // (1a) Columns d = 2p and 2p + 1, rows [8 s, 8 s + 8): the sums of the
    // log decays, and the bonus r u k summed over the pair; v into its plane.
    for (int e = tid; e < nseg * DPl; e += MMA_THREADS) {
      const int sg = e / DPl, pp = e - sg * DPl, d = 2 * pp;
      const float u0 = sU[d], u1 = sU[d + 1];
      float2 sum = make_float2(0.f, 0.f);
      // whole segments unrolled without a branch, so that rows interleave
      auto row_a = [&](int i) {
        const float2 w2 = ld_pair(rawW + i * Dk, d, Dk);
        const float2 r2 = ld_pair(rawR + i * Dk, d, Dk);
        const float2 k2 = ld_pair(rawK + i * Dk, d, Dk);
        sum.x += w2.x;
        sum.y += w2.y;
        pB[i * DPl + pp] = fmaf(r2.y * u1, k2.y, r2.x * u0 * k2.x);
      };
      if (8 * sg + 8 <= L) {
#pragma unroll
        for (int i = 0; i < 8; ++i) row_a(8 * sg + i);
      } else {
        for (int i = 8 * sg; i < L; ++i) row_a(i);
      }
      sG[e] = sum;
    }
    if (TV % 8 == 0 && tv == TV) {          // 16 bytes at a time
      const int per_row = TV / 8;
      for (int e = tid; e < L * per_row; e += MMA_THREADS) {
        const int i = e / per_row, q = e - i * per_row;
        *reinterpret_cast<uint4*>(pV + i * LDV + 8 * q) =
            *reinterpret_cast<const uint4*>(rawV + i * TV + 8 * q);
      }
    } else {
      for (int e = tid; e < L * tv; e += MMA_THREADS) {
        const int i = e / tv, c = e - i * tv;
        pV[i * LDV + c] = rawV[i * TV + c];
      }
    }
    __syncthreads();

    // (1b) The cumulative log decay c from the segments before, c_L from
    // all, then q_inter = r e^{c - w}, q_intra = r e^{c - w - c_L}, k_intra =
    // k e^{c_L - c}, two columns at a time into the planes.
    for (int e = tid; e < nseg * DPl; e += MMA_THREADS) {
      const int sg = e / DPl, pp = e - sg * DPl, d = 2 * pp;
      float2 c = make_float2(0.f, 0.f), cl = make_float2(0.f, 0.f);
      for (int q = 0; q < nseg; ++q) {
        if (q == sg) c = cl;
        const float2 x = sG[q * DPl + pp];
        cl.x += x.x;
        cl.y += x.y;
      }
      if (sg == 0) {
        sE[d] = expf(cl.x);
        if (d + 1 < Dk) sE[d + 1] = expf(cl.y);
      }
      auto row_b = [&](int i) {
        const float2 w2 = ld_pair(rawW + i * Dk, d, Dk);
        const float2 r2 = ld_pair(rawR + i * Dk, d, Dk);
        const float2 k2 = ld_pair(rawK + i * Dk, d, Dk);
        c.x += w2.x;
        c.y += w2.y;
        const float ex0 = c.x - w2.x, ex1 = c.y - w2.y;
        const int at = i * LDK + d;
        uint32_t hi, lo;
        split2(r2.x * fast_exp(ex0), r2.y * fast_exp(ex1), hi, lo);
        *reinterpret_cast<uint32_t*>(pRh + at) = hi;
        *reinterpret_cast<uint32_t*>(pRl + at) = lo;
        split2(r2.x * fast_exp(ex0 - cl.x), r2.y * fast_exp(ex1 - cl.y), hi, lo);
        *reinterpret_cast<uint32_t*>(pQh + at) = hi;
        *reinterpret_cast<uint32_t*>(pQl + at) = lo;
        split2(k2.x * fast_exp(cl.x - c.x), k2.y * fast_exp(cl.y - c.y), hi, lo);
        *reinterpret_cast<uint32_t*>(pKh + at) = hi;
        *reinterpret_cast<uint32_t*>(pKl + at) = lo;
      };
      if (8 * sg + 8 <= L) {
#pragma unroll
        for (int i = 0; i < 8; ++i) row_b(8 * sg + i);
      } else {
        for (int i = 8 * sg; i < L; ++i) row_b(i);
      }
    }
    __syncthreads();                      // the staging area is read out
    if (ch + 1 < n_chunks)
      fill_chunk(raw, r, k, w, v, t0 + L, L, Dk, Dv, c0, tv, TV, vec_rkw, vec_v, prkw,
                 pv);
    cp_async_commit();

    // the bonus of each row from its partial sums, eight lanes a row (read
    // in phase 3)
    for (int e = tid; e < LP * 8; e += MMA_THREADS) {
      const int i = e >> 3, part = e & 7;
      float acc = 0.f;
      if (i < L)
        for (int q = part; q < DPl; q += 8) acc += pB[i * DPl + q];
      acc += __shfl_xor_sync(FULL, acc, 1);
      acc += __shfl_xor_sync(FULL, acc, 2);
      acc += __shfl_xor_sync(FULL, acc, 4);
      if (part == 0 && i < L) sB[i] = acc;
    }

    // (2) A = q_intra k_intra^T on the 16 x 16 blocks on or below the
    // diagonal (row block mi: column blocks 0 .. mi), strictly lower kept.
    for (int tt = warp; tt < MT * (MT + 1) / 2; tt += MMA_WARPS) {
      int mi = 0;
      while ((mi + 1) * (mi + 2) / 2 <= tt) ++mi;
      const int nb = tt - mi * (mi + 1) / 2;
      float acc[2][4] = {}, cor[2][4] = {}, cor2[2][4] = {};
#pragma unroll 2
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t ah[4], al[4], bh[4], bl[4];
        frag_a<false>(ah, pQh + 16 * mi * LDK + 16 * kt, LDK, lane);
        frag_a<false>(al, pQl + 16 * mi * LDK + 16 * kt, LDK, lane);
        frag_b2<true>(bh, pKh + 16 * nb * LDK + 16 * kt, LDK, lane);
        frag_b2<true>(bl, pKl + 16 * nb * LDK + 16 * kt, LDK, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma(cor[h], al, bh + 2 * h);
          mma(cor2[h], ah, bl + 2 * h);
          mma(acc[h], ah, bh + 2 * h);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const int i = 16 * mi + g + 4 * q, j = 16 * nb + 8 * h + 2 * t;
          uint32_t hi, lo;
          split2(j < i ? acc[h][q] + (cor[h][q] + cor2[h][q]) : 0.f,
                 j + 1 < i ? acc[h][q + 1] + (cor[h][q + 1] + cor2[h][q + 1]) : 0.f,
                 hi, lo);
          *reinterpret_cast<uint32_t*>(pAh + i * LDL + j) = hi;
          *reinterpret_cast<uint32_t*>(pAl + i * LDL + j) = lo;
        }
    }
    __syncthreads();

    // (3) o = q_inter S + A v + bonus v, 16 rows by 16 columns at a time; v
    // is exact in bf16, so A v and k_intra^T v take two products.
    for (int tt = warp; tt < MT * NP; tt += MMA_WARPS) {
      const int mi = tt / NP, nc = 16 * (tt - mi * NP);
      float acc[2][4] = {}, cor[2][4] = {}, cor2[2][4] = {};
#pragma unroll 2
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t ah[4], al[4], bh[4], bl[4];
        frag_a<false>(ah, pRh + 16 * mi * LDK + 16 * kt, LDK, lane);
        frag_a<false>(al, pRl + 16 * mi * LDK + 16 * kt, LDK, lane);
        frag_b2<false>(bh, pSh + 16 * kt * LDV + nc, LDV, lane);
        frag_b2<false>(bl, pSl + 16 * kt * LDV + nc, LDV, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma(cor[h], al, bh + 2 * h);
          mma(cor2[h], ah, bl + 2 * h);
          mma(acc[h], ah, bh + 2 * h);
        }
      }
#pragma unroll 2
      for (int kt = 0; kt <= mi; ++kt) {
        uint32_t ah[4], al[4], bv[4];
        frag_a<false>(ah, pAh + 16 * mi * LDL + 16 * kt, LDL, lane);
        frag_a<false>(al, pAl + 16 * mi * LDL + 16 * kt, LDL, lane);
        frag_b2<false>(bv, pV + 16 * kt * LDV + nc, LDV, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma(cor[h], al, bv + 2 * h);
          mma(acc[h], ah, bv + 2 * h);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 16 * mi + g + 8 * (q >> 1), c = nc + 8 * h + 2 * t + (q & 1);
          if (i < L && c < tv)
            o[(t0 + i) * Dv + c0 + c] = __float2bfloat16(
                fmaf(sB[i], __bfloat162float(pV[i * LDV + c]),
                     acc[h][q] + (cor[h][q] + cor2[h][q])));
        }
    }
    __syncthreads();                      // every o tile has read the old S

    // (4) S <- e^{c_L} S + k_intra^T v, 16 Dk rows by 16 columns at a time,
    // in place: the fp32 S and its planes.
    for (int tt = warp; tt < KT * NP; tt += MMA_WARPS) {
      const int mi = tt / NP, nc = 16 * (tt - mi * NP);
      float acc[2][4], cor[2][4] = {};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const int d = 16 * mi + g + 4 * q, c = nc + 8 * h + 2 * t;
          const float2 sv = *reinterpret_cast<const float2*>(sS + d * LDS + c);
          acc[h][q] = sE[d] * sv.x;
          acc[h][q + 1] = sE[d] * sv.y;
        }
#pragma unroll 2
      for (int kt = 0; kt < MT; ++kt) {
        uint32_t ah[4], al[4], bv[4];
        frag_a<true>(ah, pKh + 16 * kt * LDK + 16 * mi, LDK, lane);
        frag_a<true>(al, pKl + 16 * kt * LDK + 16 * mi, LDK, lane);
        frag_b2<false>(bv, pV + 16 * kt * LDV + nc, LDV, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma(cor[h], al, bv + 2 * h);
          mma(acc[h], ah, bv + 2 * h);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const int d = 16 * mi + g + 4 * q, c = nc + 8 * h + 2 * t;
          const float x = acc[h][q] + cor[h][q], y = acc[h][q + 1] + cor[h][q + 1];
          *reinterpret_cast<float2*>(sS + d * LDS + c) = make_float2(x, y);
          uint32_t hi, lo;
          split2(x, y, hi, lo);
          *reinterpret_cast<uint32_t*>(pSh + d * LDV + c) = hi;
          *reinterpret_cast<uint32_t*>(pSl + d * LDV + c) = lo;
        }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int e = tid; e < Dk * tv; e += MMA_THREADS) {
    const int d = e / tv, c = e - d * tv;
    s_out[((size_t)b * Dk + d) * Dv + c0 + c] = sS[d * LDS + c];
  }
}

int launch_mma(const void* r, const void* k, const void* v, const void* w, const void* u,
               void* o, float* s_out, int B, int T_len, int Dk, int Dv, int L, int TV,
               int vec_rkw, int vec_v, cudaStream_t stream) {
  const size_t smem = MmaLayout(L, Dk, TV).bytes();
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gla_scan_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  const int tiles = (Dv + TV - 1) / TV;
  gla_scan_mma<<<dim3(B, tiles), MMA_THREADS, smem, stream>>>(
      static_cast<const bf*>(r), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(w), static_cast<const bf*>(u), static_cast<bf*>(o), s_out,
      T_len, L, Dk, Dv, TV, vec_rkw, vec_v);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The FMA route. dtype: 0 = float32 (r, k, v, w, u and o; bf16 inputs take
// gla_scan_fwd_mma), else cudaErrorInvalidValue; s_out is fp32.
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
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: bf16 r, k, v, w, u and o, otherwise as
// gla_scan_fwd. Returns cudaErrorInvalidValue where one block's shared memory
// (gla_scan_mma_smem) passes 227 KB.
int gla_scan_fwd_mma(const void* r, const void* k, const void* v, const void* w,
                     const void* u, void* o, void* s_out, int B, int T_len, int Dk,
                     int Dv, int chunk, int tv, int vec_rkw, int vec_v, void* stream) {
  if (chunk < 1 || chunk > L_MAX || T_len < 0 || T_len % chunk != 0 || Dk < 1 ||
      Dk > D_MAX || Dv < 1 || Dv > D_MAX || tv < 1 || tv > Dv || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return launch_mma(r, k, v, w, u, o, static_cast<float*>(s_out), B, T_len, Dk, Dv,
                    chunk, tv, vec_rkw, vec_v, static_cast<cudaStream_t>(stream));
}

// Bytes of shared memory one block of the tensor-core route takes.
int gla_scan_mma_smem(int chunk, int Dk, int tv) {
  return (int)MmaLayout(chunk, Dk, tv).bytes();
}

const char* linear_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
