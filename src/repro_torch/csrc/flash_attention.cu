// Flash attention forward for Hopper (sm_90a): a tensor-core kernel for
// bf16 and a scalar kernel for fp32.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py:26, :84). Same function:
// online-softmax attention with GQA (query head h reads kv head h / G),
// causal, sliding-window, q_offset and kv_len masks, fully masked key tiles
// skipped, out = acc / max(l, 1e-20).
//
// Layout: q [B, H, Tq, D]; k [B, KH, Tk, D]; v [B, KH, Tk, Dv]; o [B, H, Tq, Dv];
// all contiguous; D, Dv <= 256. Dv may differ from D (MLA: deepseek-v2-lite's
// heads are D = 192, 128 nope + 64 rope, and Dv = 128); the TPU kernel sizes
// v and o by q's D, so there only the XLA path takes Dv != D.
//
// What bounds it on the H100, at the served prefills (bf16, causal):
//   qwen3-0.6b        B=4 H=16 KH=8 T=512 D=128: ~25 MB against ~4 GFLOP, so
//                     memory (7.5 us at 3.35 TB/s);
//   grok-1-314b       B=4 H=48 KH=8 T=512 D=128: ~59 MB against ~13 GFLOP,
//                     memory again (17.5 us);
//   recurrentgemma-9b B=4 H=16 KH=1 T=2100 D=256 window 2048: ~146 MB against
//                     0.145 TFLOP, so the bf16 tensor-core rate (0.146 ms);
//   deepseek-v2-lite  B=4 H=KH=16 T=512 D=192 Dv=128: ~42 MB against ~5.4
//                     GFLOP, so memory (12.5 us).
// The tensor cores are the only way to that floor: the fp32 FMA rate puts
// the scalar kernel's own floor at ~2.2 ms at recurrentgemma's shape.
//
// The tensor-core kernel (bf16, D % 8 == 0; `flash_fwd_wgmma`):
// - Both products on `wgmma.mma_async`, bf16 in, fp32 accumulators.
//   S = Q K^T reads Q and K from shared memory (K-major). O += P V takes P
//   from registers: the S accumulator, rounded to bf16 pairs in place, is the
//   A operand, since for 16-bit types the accumulator and register-A layouts
//   coincide. V is the B operand read MN-major (transposed) from shared
//   memory. P is rounded to bf16 before P V, as the reference's `p_bf16`
//   option of its XLA path does (ops.py:100-103): <= 2^-9 relative on each
//   weight.
// - Tiles come in by TMA into 128-byte-swizzled 64-column panels: a q tile
//   per work tile, K and V through a ring of NST = 2 stages, each completed
//   on its own mbarrier (S waits for K only, P V for V) and released on its
//   own empty mbarrier (K once S is done, V once P V is). The tensor maps
//   are 3-D, [B*H or B*KH, T, D], so rows past T read as zeros and stores
//   past Tq are dropped; the tile's D rounds up to 64, 128 or 256 and TMA
//   zero-fills the columns past D, which adds nothing to Q K^T. V and O take
//   a tile of their own head dim, Dv rounded up the same way (zero columns of
//   V give zero columns of O, which the store drops): at D = 192, Dv = 128 the
//   Q and K tiles are 256 wide and V and O 128. TMA wants 16-byte global
//   strides, hence D % 8 == 0 and Dv % 8 == 0. The maps are built on the host
//   (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//   nothing links -lcuda) and passed as __grid_constant__ parameters.
// - Warp-specialised, 384 threads: warpgroups 0 and 1 are consumers of 64
//   query rows each (BQ = 128), warpgroup 2 the producer, one thread of which
//   issues every TMA load. setmaxnreg moves registers from the producer (24)
//   to the consumers (240): a 384-thread block starts at 168 a thread, and
//   the consumers need up to ~230 (the 64 x D fp32 O tile, S and P). ptxas
//   allocates the code after `setmaxnreg.inc` within 240 only while no trap
//   path is in the kernel; with one it keeps 168 and spills.
// - Tiles: BK = 128 keys where both head tiles are at most 128 wide, and 80
//   where one is 256 (S in 40 registers beside the up to 128 of O, and two
//   stages of 256-wide K or V tiles within the shared memory). Shared memory:
//   q tile, two stages of K and V and, where it fits, an output tile of its
//   own: 193 KB at D = Dv = 128, 217 KB at D = 192, Dv = 128; at D = Dv = 256
//   the output is staged in the q tile's place, 225 KB.
// - Within a consumer warpgroup, tile j's S = Q K^T is issued with tile
//   j-1's O += P V, and tile j's softmax runs while that P V computes. The
//   two consumer warpgroups take turns to issue their products (named
//   barriers), so one's softmax runs under the other's products; both walk
//   the same key tiles, so their turns pair up.
// - Online softmax in registers: a row lives in the 4 threads of a quad, so
//   row max is two shuffles; each thread keeps a partial row sum that is
//   reduced once at the end. Masked scores enter the max as -inf (the
//   running max starts at -1e30, the floor the scalar kernel fills masked
//   scores with) and their probabilities are exactly 0, so a row whose first
//   visited tile is fully masked adds nothing; a row with no live key gives 0.
// - Masks only where needed: fully masked key tiles are cut by the loop
//   bounds (causal end, window start, kv_len); the element-wise mask runs
//   only on the diagonal, window-edge and kv_len-edge tiles of each
//   warpgroup.
// - Persistent: one block per SM walks the work tiles (a q tile of one batch
//   and head). Under a causal mask the q tiles with the most keys come
//   first, and a block walks its rounds forwards and backwards in turn, so
//   the last wave is not the longest tiles. The producer loads the next work
//   tile's q tile and K/V as soon as the ring and the q buffer free up, under
//   the current tile's last products and output store.
// - The output is scaled by 1 / max(l, 1e-20), written as bf16 into the
//   warpgroup's rows of the output buffer in the swizzled layout, and stored
//   by TMA.
//
// The scalar kernel (fp32, or D % 8 != 0; `flash_fwd_kernel`): 64x64 tiles
// staged in shared memory as fp32, both products as scalar fp32 FMAs, so fp32
// inputs keep the 3e-5 tolerance (TF32 would not). Grid (ceil(Tq / 64), H, B),
// 256 threads a block; thread (ty, tx) of a 16 x 16 grid owns rows 4*ty ..
// 4*ty+3, score columns tx + 16*j and output columns tx + 16*j; a row's 16
// threads sit in one half-warp. Compiled for Dv <= 128 and for Dv <= 256 (the
// accumulator holds output columns), so the narrow heads keep their
// registers; Q and K rows are D wide, V rows Dv. Masked scores are -1e30 and their
// probabilities 0.
//
// Both kernels also write each row's log-sum-exp of the scaled scores,
// lse = m + log(l) in fp32 ([B, H, Tq]), when they are given a pointer for it
// (nullptr: no write, and the output's bits are those of a launch without
// it). The running max and sum of a row are in registers at the end of its
// key loop, so the epilogue writes one float a row: in the wgmma kernel the
// first thread of each quad, from the max kept in log2 units, (m + log2 l)
// ln 2; in the scalar kernel the first thread of each row's half-warp. A row
// with no live key gets +inf, so that exp(s - lse) = 0 for it, as its output
// is 0. The training path's backward (kernels/flash_attention/ops.py
// `_FlashAttention`) recomputes the probabilities from it.
//
// The route is chosen by dtype and shape in Python (kernels/flash_attention/
// kernel.py `kernel_route`), never on failure: each entry point returns the
// CUDA error of its launch and the wrapper raises.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;
#define PLUS_INF __int_as_float(0x7f800000)

// lse of a row from its running max m and sum l (natural units): +inf for a
// row with no live key
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : PLUS_INF;
}

// Fills n floats with +inf (the lse of a launch with no key at all).
__global__ void fill_plus_inf(float* __restrict__ p, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    p[i] = PLUS_INF;
}

// ---------------------------------------------------------------------------
// Scalar kernel (fp32 FMAs)
// ---------------------------------------------------------------------------
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int D_NARROW = 128;      // DJ = 8
constexpr int D_MAX = 256;         // DJ = 16

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

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + (size_t)BK * (Dv + 1) +
                          (size_t)BQ * (BK + 1));
}

template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int KH,
                 int Tq, int Tk, int D, int Dv, float scale, int causal,
                 int has_window, int window, int q_offset, int kv_len) {
  extern __shared__ float smem[];
  const int ld = D + 1;        // padded rows: column reads hit distinct banks
  const int ldv = Dv + 1;
  const int ldp = BK + 1;
  float* sQ = smem;
  float* sK = sQ + BQ * ld;
  float* sV = sK + BK * ld;
  float* sP = sV + BK * ldv;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* qb = q + ((size_t)b * H + h) * Tq * D;
  const T* kb = k + ((size_t)b * KH + kh) * Tk * D;
  const T* vb = v + ((size_t)b * KH + kh) * Tk * Dv;
  T* ob = o + ((size_t)b * H + h) * Tq * Dv;

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
      sK[r * ld + d] = k0 + r < Tk ? to_f(kb[(size_t)(k0 + r) * D + d]) : 0.f;
    }
    for (int i = tid; i < BK * Dv; i += THREADS) {
      const int r = i / Dv, d = i - r * Dv;
      sV[r * ldv + d] = k0 + r < Tk ? to_f(vb[(size_t)(k0 + r) * Dv + d]) : 0.f;
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
        if (d < Dv) {
          const float vv = sV[c * ldv + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  if (lse != nullptr && tx == 0) {
    float* lb = lse + ((size_t)b * H + h) * Tq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      if (r < Tq) lb[r] = row_lse(m[i], l[i]);
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
      if (d < Dv) store(&ob[(size_t)r * Dv + d], acc[i][j] / den);
    }
  }
}

template <typename T, int DJ>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H,
           int KH, int Tq, int Tk, int D, int Dv, float scale, int causal,
           int has_window, int window, int q_offset, int kv_len,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, KH, Tq, Tk, D, Dv,
      scale, causal, has_window, window, q_offset, kv_len);
  return (int)cudaGetLastError();
}

// the accumulator's width follows the output's head dim Dv
template <typename T>
int launch_for_width(const void* q, const void* k, const void* v, void* o,
                     float* lse,
                     int B, int H, int KH, int Tq, int Tk, int D, int Dv,
                     float scale, int causal, int has_window, int window,
                     int q_offset, int kv_len, cudaStream_t stream) {
  if (Dv <= D_NARROW)
    return launch<T, D_NARROW / 16>(q, k, v, o, lse, B, H, KH, Tq, Tk, D, Dv,
                                    scale, causal, has_window, window,
                                    q_offset, kv_len, stream);
  return launch<T, D_MAX / 16>(q, k, v, o, lse, B, H, KH, Tq, Tk, D, Dv, scale,
                               causal, has_window, window, q_offset, kv_len,
                               stream);
}


// ---------------------------------------------------------------------------
// Tensor-core kernel (wgmma, TMA ring, warp-specialised)
// ---------------------------------------------------------------------------
constexpr int TC_THREADS = 384;    // 2 consumer warpgroups + a producer warpgroup
constexpr int TC_BQ = 128;         // 64 query rows per consumer warpgroup
constexpr int PANEL_COLS = 64;     // a 128-byte swizzle span of bf16
constexpr int SW_GROUP = 1024;     // 8 rows of 128 bytes: the swizzle period
constexpr int NST = 2;             // K/V ring depth

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. For a K-major operand
// `sbo` is the stride between 8-row groups and `lbo` is unused; for an
// MN-major one `lbo` is the stride between 64-element column panels and `sbo`
// the stride between 8-row groups along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from touching accumulator registers across the
// asynchronous wgmma: reads after the wait depend on this barrier.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define MINUS_INF __int_as_float(0xff800000)

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define F8(a, i)                                                          \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]), "+f"(a[i + 4]), \
      "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// S[64 x 80] (+)= A[64 x 16] * B[80 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[40], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24),
        F8(d, 32)
      : "l"(da), "l"(db), "r"(scale_d));
}

// S[64 x 128] (+)= A[64 x 16] * B[128 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24),
        F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x 64] += P[64 x 16] * V[16 x 64], P in registers, V MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// O[64 x 128] += P[64 x 16] * V[16 x 128], P in registers, V MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24),
        F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// O[64 x 256] += P[64 x 16] * V[16 x 256], P in registers, V MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24),
        F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56),
        F8(d, 64), F8(d, 72), F8(d, 80), F8(d, 88),
        F8(d, 96), F8(d, 104), F8(d, 112), F8(d, 120)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// Shared-memory plan of one block, from a 1024-byte aligned base: the q tile
// as DT/64 panels of TC_BQ rows x 128 bytes; NST K tiles as DT/64 panels and
// NST V tiles as DVT/64 panels of BKT rows x 128 bytes; where it fits, an
// output tile of DVT/64 panels laid out as the q tile's (else the output is
// staged in the q tile's place); then the mbarriers.
constexpr int SMEM_MAX = 232448;   // what a block may opt into on the H100

template <int DT, int DVT, int BKT>
struct TcPlan {
  static constexpr int PANELS = DT / PANEL_COLS;          // q and K
  static constexpr int VPANELS = DVT / PANEL_COLS;        // V and the output
  static constexpr int PANEL_Q = TC_BQ * 128;
  static constexpr int PANEL_KV = BKT * 128;
  static constexpr int Q_BYTES = PANELS * PANEL_Q;
  static constexpr int K_BYTES = PANELS * PANEL_KV;       // one K tile
  static constexpr int V_BYTES = VPANELS * PANEL_KV;      // one V tile
  static constexpr int O_BYTES = VPANELS * PANEL_Q;
  static constexpr int BARS = 8 * (2 + 4 * NST);
  static constexpr int O_OFF = Q_BYTES + NST * (K_BYTES + V_BYTES);
  static constexpr bool OWN_O = SW_GROUP + O_OFF + O_BYTES + BARS <= SMEM_MAX;
  static constexpr int BAR_OFF = O_OFF + (OWN_O ? O_BYTES : 0);
  static constexpr int SMEM = SW_GROUP + BAR_OFF + BARS;
  static_assert(SMEM <= SMEM_MAX, "tiles exceed the shared memory of a block");
  static_assert(OWN_O || O_BYTES <= Q_BYTES,
                "an output staged in the q tile's place must fit it");
};

// One work tile: 128 query rows of one (batch, head), and its live key
// range in whole BKT-key tiles. Work w runs the q tiles in the order of
// their key counts, the most first under a causal mask.
template <int BKT>
struct Work {
  int bh, bhk, q0, qpos_lo, qpos_hi, k_begin, n_tiles;
  __device__ __forceinline__ Work(int w, int BH, int H, int KH, int n_qtiles,
                                  int Tq, int klim, int causal, int has_window,
                                  int window, int q_offset) {
    const int order = w / BH;
    bh = w - order * BH;                               // b * H + h
    bhk = (bh / H) * KH + (bh % H) / (H / KH);
    q0 = (causal ? n_qtiles - 1 - order : order) * TC_BQ;
    qpos_lo = q_offset + q0;
    qpos_hi = q_offset + min(q0 + TC_BQ, Tq) - 1;
    int k_end = klim;
    if (causal) k_end = min(k_end, qpos_hi + 1);
    k_begin = has_window ? max(0, qpos_lo - window + 1) : 0;
    k_begin = (k_begin / BKT) * BKT;
    n_tiles = k_end > k_begin ? (k_end - k_begin + BKT - 1) / BKT : 0;
  }
};

// S = Q K^T for one warpgroup: DT / 16 steps of 16 columns, Q and K K-major.
// `dq`, `dk`: descriptors of panel 0 of the warpgroup's Q rows and of the K
// tile; a step moves 32 bytes along a 128-byte row, every 4 steps a panel.
template <int DT, int BKT>
__device__ __forceinline__ void issue_qk(float (&s)[BKT / 2], uint64_t dq,
                                         uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk)
    wgmma_ss(s, dq + (((kk / 4) * TC_BQ * 128 + (kk % 4) * 32) >> 4),
             dk + (((kk / 4) * BKT * 128 + (kk % 4) * 32) >> 4), kk > 0);
}

// O += P V for one warpgroup: BKT / 16 steps of 16 keys (16 rows of the
// MN-major V tile, 2048 bytes); P's registers are the A operand.
template <int DT, int BKT>
__device__ __forceinline__ void issue_pv(float (&o)[DT / 2],
                                         const uint32_t (&p)[BKT / 4],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < BKT / 16; ++kk)
    wgmma_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
             dv + ((kk * 16 * 128) >> 4));
}

// Sets to -inf the scores of the keys that rows pos0 and pos1 may not see.
template <int BKT>
__device__ __forceinline__ void mask_tile(float (&s)[BKT / 2], int k0, int c0,
                                          int pos0, int pos1, int klim,
                                          int causal, int has_window,
                                          int window) {
#pragma unroll
  for (int c = 0; c < BKT / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = k0 + 8 * c + c0 + (e & 1);
      const int qpos = (e & 2) ? pos1 : pos0;
      const bool live = kpos < klim && (!causal || kpos <= qpos) &&
                        (!has_window || kpos > qpos - window);
      if (!live) s[4 * c + e] = MINUS_INF;
    }
}

// One online-softmax step over the thread's two rows: new running maxima
// (quad shuffles), the correction factors `cr` for the older accumulator,
// the probabilities in place of the scores, and the thread's partial row
// sums (reduced over the quad only at the end).
template <int BKT>
__device__ __forceinline__ void softmax_step(float (&s)[BKT / 2], float sl2,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& cr0, float& cr1) {
  float mx0 = MINUS_INF, mx1 = MINUS_INF;
#pragma unroll
  for (int c = 0; c < BKT / 8; ++c) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
  cr0 = ex2(m0 - mn0);
  cr1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int c = 0; c < BKT / 8; ++c) {
    s[4 * c] = ex2(fmaf(s[4 * c], sl2, -mn0));
    s[4 * c + 1] = ex2(fmaf(s[4 * c + 1], sl2, -mn0));
    s[4 * c + 2] = ex2(fmaf(s[4 * c + 2], sl2, -mn1));
    s[4 * c + 3] = ex2(fmaf(s[4 * c + 3], sl2, -mn1));
    rs0 += s[4 * c] + s[4 * c + 1];
    rs1 += s[4 * c + 2] + s[4 * c + 3];
  }
  l0 = l0 * cr0 + rs0;
  l1 = l1 * cr1 + rs1;
}

// The probabilities as bf16 pairs in the register-A layout of P V: pair
// (c, row) of the S accumulator is A register 2c + row.
template <int BKT>
__device__ __forceinline__ void to_bf16(const float (&s)[BKT / 2],
                                        uint32_t (&p)[BKT / 4]) {
#pragma unroll
  for (int i = 0; i < BKT / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int DT>
__device__ __forceinline__ void rescale(float (&o)[DT / 2], float cr0, float cr1) {
#pragma unroll
  for (int c = 0; c < DT / 8; ++c) {
    o[4 * c] *= cr0;
    o[4 * c + 1] *= cr0;
    o[4 * c + 2] *= cr1;
    o[4 * c + 3] *= cr1;
  }
}

template <int DT, int DVT, int BKT>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_o,
                float* __restrict__ lse, int H, int KH,
                int Tq, int Tk, float scale, int causal, int has_window,
                int window, int q_offset, int kv_len, int n_qtiles, int n_work) {
  using P = TcPlan<DT, DVT, BKT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + SW_GROUP - 1) & ~(uint32_t)(SW_GROUP - 1);
  const uint32_t sK = sQ + P::Q_BYTES;
  const uint32_t sV = sK + NST * P::K_BYTES;
  const uint32_t sO = P::OWN_O ? sQ + P::O_OFF : sQ;
  // mbarriers: Q full, Q empty; per stage K full, V full, K empty, V empty
  const uint32_t q_full = sQ + P::BAR_OFF;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;               // + 8 * stage
  const uint32_t v_full = k_full + 8 * NST;
  const uint32_t k_empty = v_full + 8 * NST;
  const uint32_t v_empty = k_empty + 8 * NST;
  const int BH = (int)(n_work / n_qtiles);
  const int klim = min(Tk, kv_len);
  // the block's wi-th work tile: rounds of gridDim.x, walked forwards and
  // backwards in turn, so that a block that took a long tile in one round
  // takes a short one in the next
  auto work_index = [&](int wi) {
    const int x = (wi & 1) ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
    return wi * (int)gridDim.x + x;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * 128);                     // every consumer thread
    for (int s = 0; s < NST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2 * 128);
      mbar_init(v_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, through a shuffle so that the compiler knows it is
  // uniform across the warp (wgmma in a branch it cannot prove uniform is
  // serialised)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---- producer warpgroup: one thread issues every load -----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      int it = 0;                                    // K/V tiles so far
      for (int wi = 0, w; (w = work_index(wi)) < n_work; ++wi) {
        const Work<BKT> wk(w, BH, H, KH, n_qtiles, Tq, klim, causal,
                           has_window, window, q_offset);
        mbar_wait(q_empty, (wi & 1) ^ 1);            // the first round passes
        mbar_expect_tx(q_full, P::Q_BYTES);
#pragma unroll
        for (int p = 0; p < P::PANELS; ++p)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            tma_load(sQ + p * P::PANEL_Q + half * (TC_BQ / 2) * 128, &tm_q,
                     q_full, p * PANEL_COLS, wk.q0 + half * (TC_BQ / 2), wk.bh);
        for (int j = 0; j < wk.n_tiles; ++j, ++it) {
          const int s = it % NST;
          const uint32_t par = ((it / NST) & 1) ^ 1;
          const int k0 = wk.k_begin + j * BKT;
          mbar_wait(k_empty + 8 * s, par);
          mbar_expect_tx(k_full + 8 * s, P::K_BYTES);
#pragma unroll
          for (int p = 0; p < P::PANELS; ++p)
            tma_load(sK + s * P::K_BYTES + p * P::PANEL_KV, &tm_k,
                     k_full + 8 * s, p * PANEL_COLS, k0, wk.bhk);
          mbar_wait(v_empty + 8 * s, par);
          mbar_expect_tx(v_full + 8 * s, P::V_BYTES);
#pragma unroll
          for (int p = 0; p < P::VPANELS; ++p)
            tma_load(sV + s * P::V_BYTES + p * P::PANEL_KV, &tm_v,
                     v_full + 8 * s, p * PANEL_COLS, k0, wk.bhk);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = wg;
    const int t = threadIdx.x & 127;
    const int r0 = ((t >> 5) << 4) + ((t & 31) >> 2);  // rows r0 and r0 + 8
    const int c0 = (t & 3) * 2;                        // columns c0, c0 + 1 of each 8
    const uint32_t q_base = sQ + cw * 64 * 128;        // this warpgroup's rows
    const uint32_t o_base = sO + cw * 64 * 128;
    const uint64_t dq = smem_desc(q_base, 16, SW_GROUP);
    const float sl2 = scale * 1.4426950408889634f;     // exp(x) = 2^(x log2 e)
    // The two warpgroups take turns to issue their products (named barriers
    // 3 and 4, warpgroup 0 first), so that one's softmax runs while the
    // other's products are on the tensor cores. Both walk the same key tiles
    // of every work tile, so their turns pair up.
    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;" ::"r"(3 + cw) : "memory");
    };
    auto your_turn = [&]() {
      asm volatile("bar.arrive %0, 256;" ::"r"(4 - cw) : "memory");
    };
    if (cw == 1) your_turn();
    int it = 0;
    for (int wi = 0, w; (w = work_index(wi)) < n_work; ++wi) {
      const Work<BKT> wk(w, BH, H, KH, n_qtiles, Tq, klim, causal, has_window,
                         window, q_offset);
      const int wq_lo = wk.qpos_lo + cw * 64;          // position of the first row
      const int wq_hi = min(wq_lo + 63, wk.qpos_hi);   // and of the last real one
      const int pos0 = wq_lo + r0, pos1 = pos0 + 8;
      // some key of tile j is masked for some row of this warpgroup: the
      // element-wise mask runs (a tile with no live key for the warpgroup
      // adds exactly nothing: its probabilities are 0 and its factors 1)
      auto edge = [&](int j) {
        const int k0 = wk.k_begin + j * BKT;
        return k0 + BKT > klim || (causal && k0 + BKT - 1 > wq_lo) ||
               (has_window && k0 <= wq_hi - window);
      };
      const int n = wk.n_tiles;

      float o[DVT / 2];
#pragma unroll
      for (int i = 0; i < DVT / 2; ++i) o[i] = 0.f;
      float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

      mbar_wait(q_full, wi & 1);
      if (n > 0) {
        // Tile j's S = Q K^T is issued together with tile j-1's O += P V, and
        // tile j's softmax runs while that P V (and the other warpgroup's
        // products, issued in the next turn) are on the tensor cores.
        uint32_t pa[BKT / 4];
        float cr0, cr1;
        {
          const int s = it % NST;
          float sacc[BKT / 2];
          mbar_wait(k_full + 8 * s, (it / NST) & 1);
          my_turn();
          wgmma_fence();
          issue_qk<DT, BKT>(sacc, dq, smem_desc(sK + s * P::K_BYTES, 16, SW_GROUP));
          wgmma_commit();
          your_turn();
          wgmma_wait<0>();
          fence_regs(sacc);
          mbar_arrive(k_empty + 8 * s);
          if (edge(0))
            mask_tile<BKT>(sacc, wk.k_begin, c0, pos0, pos1, klim, causal,
                           has_window, window);
          softmax_step<BKT>(sacc, sl2, m0, m1, l0, l1, cr0, cr1);
          to_bf16<BKT>(sacc, pa);
        }
        for (int j = 1; j < n; ++j) {
          const int s = (it + j) % NST, sp = (it + j - 1) % NST;
          float sacc[BKT / 2];
          mbar_wait(k_full + 8 * s, ((it + j) / NST) & 1);
          my_turn();
          wgmma_fence();
          issue_qk<DT, BKT>(sacc, dq, smem_desc(sK + s * P::K_BYTES, 16, SW_GROUP));
          wgmma_commit();
          mbar_wait(v_full + 8 * sp, ((it + j - 1) / NST) & 1);
          issue_pv<DVT, BKT>(o, pa, smem_desc(sV + sp * P::V_BYTES, P::PANEL_KV, SW_GROUP));
          wgmma_commit();
          your_turn();
          wgmma_wait<1>();                             // S of tile j is done
          fence_regs(sacc);
          mbar_arrive(k_empty + 8 * s);
          if (edge(j))
            mask_tile<BKT>(sacc, wk.k_begin + j * BKT, c0, pos0, pos1, klim,
                           causal, has_window, window);
          softmax_step<BKT>(sacc, sl2, m0, m1, l0, l1, cr0, cr1);
          wgmma_wait<0>();                             // P V of tile j-1 is done
          fence_regs(o);
          mbar_arrive(v_empty + 8 * sp);
          rescale<DVT>(o, cr0, cr1);
          to_bf16<BKT>(sacc, pa);
        }
        // every S of this work tile is done: with its own output buffer, the
        // block may load the next q tile now
        if (P::OWN_O) mbar_arrive(q_empty);
        const int s = (it + n - 1) % NST;
        mbar_wait(v_full + 8 * s, ((it + n - 1) / NST) & 1);
        my_turn();
        wgmma_fence();
        issue_pv<DVT, BKT>(o, pa, smem_desc(sV + s * P::V_BYTES, P::PANEL_KV, SW_GROUP));
        wgmma_commit();
        your_turn();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(v_empty + 8 * s);
      } else if (P::OWN_O) {
        mbar_arrive(q_empty);
      }
      it += n;

      // ---- epilogue: O / max(l, 1e-20) as bf16 into this warpgroup's rows of
      // the output buffer (swizzled as TMA expects), then one TMA store per
      // panel. The store of the previous work tile has been read (below).
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      if (lse != nullptr && (t & 3) == 0) {
        // m0, m1 are in log2 units of the scaled scores
        float* lb = lse + (size_t)wk.bh * Tq;
        const int row = wk.q0 + cw * 64 + r0;
        if (row < Tq) lb[row] = l0 > 0.f ? (m0 + log2f(l0)) * LN2 : PLUS_INF;
        if (row + 8 < Tq)
          lb[row + 8] = l1 > 0.f ? (m1 + log2f(l1)) * LN2 : PLUS_INF;
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
      const uint32_t sw = (uint32_t)(r0 & 7);
#pragma unroll
      for (int c = 0; c < DVT / 8; ++c) {
        const uint32_t panel = o_base + (c / 8) * P::PANEL_Q;
        const uint32_t col = (((c % 8) ^ sw) << 4) + c0 * 2;
        const uint32_t v0 = pack_bf16(o[4 * c] * inv0, o[4 * c + 1] * inv0);
        const uint32_t v1 = pack_bf16(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(panel + r0 * 128 + col), "r"(v0)
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(panel + (r0 + 8) * 128 + col),
                     "r"(v1)
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
      if (t == 0) {
        if (wk.q0 + cw * 64 < Tq) {
#pragma unroll
          for (int p = 0; p < P::VPANELS; ++p)
            tma_store(&tm_o, o_base + p * P::PANEL_Q, p * PANEL_COLS,
                      wk.q0 + cw * 64, wk.bh);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      // the output buffer may be written again (and, where it is the q
      // tile's, the next q tile loaded) once the store has read it
      asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
      if (!P::OWN_O) mbar_arrive(q_empty);
    }
    if (cw == 0) my_turn();   // takes warpgroup 1's last turn: none is left open
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor [BH, T, D] (D innermost) read or written in boxes of 64
// columns x `rows` rows of one head, 128-byte swizzled, zeros past its ends.
int make_map(CUtensorMap* map, const void* ptr, int BH, int T, int D, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {PANEL_COLS, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                            const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DT, int DVT, int BKT>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B,
                 int H, int KH, int Tq, int Tk, int D, int Dv, float scale,
                 int causal, int has_window, int window, int q_offset,
                 int kv_len, cudaStream_t stream) {
  using P = TcPlan<DT, DVT, BKT>;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  int err;
  if ((err = make_map(&tm_q, q, B * H, Tq, D, TC_BQ / 2)) ||
      (err = make_map(&tm_k, k, B * KH, Tk, D, BKT)) ||
      (err = make_map(&tm_v, v, B * KH, Tk, Dv, BKT)) ||
      (err = make_map(&tm_o, o, B * H, Tq, Dv, TC_BQ / 2)))
    return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<DT, DVT, BKT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::SMEM);
  if (e != cudaSuccess) return (int)e;
  // persistent: one block per SM walks the work tiles
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return (int)e;
  const int n_qtiles = (Tq + TC_BQ - 1) / TC_BQ;
  const int n_work = B * H * n_qtiles;
  flash_fwd_wgmma<DT, DVT, BKT><<<min(n_work, sms), TC_THREADS, P::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_o, lse, H, KH, Tq, Tk, scale, causal, has_window, window,
      q_offset, kv_len, n_qtiles, n_work);
  return (int)cudaGetLastError();
}

// head tile of a width: D rounded up to 64, 128 or 256
int head_tile(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

// The wgmma kernel for the q/K tile DT and the V/O tile of Dv: 80 keys a
// tile where either is 256 wide, else 128.
template <int DT>
int launch_wgmma_dv(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int H, int KH, int Tq, int Tk, int D,
                    int Dv, float scale, int causal, int has_window, int window,
                    int q_offset, int kv_len, cudaStream_t stream) {
  constexpr int BKT = DT == 256 ? 80 : 128;
  switch (head_tile(Dv)) {
    case 64:
      return launch_wgmma<DT, 64, BKT>(q, k, v, o, lse, B, H, KH, Tq, Tk, D, Dv,
                                       scale, causal, has_window, window,
                                       q_offset, kv_len, stream);
    case 128:
      return launch_wgmma<DT, 128, BKT>(q, k, v, o, lse, B, H, KH, Tq, Tk, D,
                                        Dv, scale, causal, has_window, window,
                                        q_offset, kv_len, stream);
    default:
      return launch_wgmma<DT, 256, 80>(q, k, v, o, lse, B, H, KH, Tq, Tk, D, Dv,
                                       scale, causal, has_window, window,
                                       q_offset, kv_len, stream);
  }
}

}  // namespace

extern "C" {

// The scalar kernel. dtype: 0 = float32, 1 = bfloat16. D: q's and k's head
// dim, Dv: v's and the output's. `lse`: [B, H, Tq] fp32, or nullptr for
// none. Returns cudaGetLastError() after launch.
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                        void* o, float* lse, int B, int H, int KH, int Tq,
                        int Tk, int D, int Dv,
                        float scale, int causal, int has_window, int window,
                        int q_offset, int kv_len, void* stream) {
  if (D < 1 || D > D_MAX || Dv < 1 || Dv > D_MAX || KH < 1 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_for_width<float>(q, k, v, o, lse, B, H, KH, Tq, Tk, D, Dv,
                                   scale, causal, has_window, window, q_offset,
                                   kv_len, s);
  if (dtype == 1)
    return launch_for_width<__nv_bfloat16>(q, k, v, o, lse, B, H, KH, Tq, Tk, D,
                                           Dv, scale, causal, has_window, window,
                                           q_offset, kv_len, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel's tiles at head dims D (q, k) and Dv (v, output):
// the q/K tile's head dim and the V/O tile's (each rounded up to 64, 128 or
// 256), query rows and keys per tile. Returns 0.
int flash_attention_wgmma_tiles(int D, int Dv, int* head_dim_tile,
                                int* v_head_dim_tile, int* block_q,
                                int* block_k) {
  *head_dim_tile = head_tile(D);
  *v_head_dim_tile = head_tile(Dv);
  *block_q = TC_BQ;
  *block_k = *head_dim_tile == 256 || *v_head_dim_tile == 256 ? 80 : 128;
  return 0;
}

// The tensor-core kernel: bf16, D % 8 == 0 and Dv % 8 == 0, both <= 256,
// every pointer 16-byte aligned. `lse`: [B, H, Tq] fp32, or nullptr for
// none. Returns cudaGetLastError() after launch.
int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int H, int KH,
                              int Tq, int Tk,
                              int D, int Dv, float scale, int causal,
                              int has_window, int window, int q_offset,
                              int kv_len, void* stream) {
  if (D < 8 || D > D_MAX || D % 8 != 0 || Dv < 8 || Dv > D_MAX || Dv % 8 != 0 ||
      KH < 1 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (B == 0 || Tq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tk == 0) {      // no key at all: every row is 0, its lse +inf
    cudaError_t e = cudaMemsetAsync(o, 0, (size_t)B * H * Tq * Dv * 2, s);
    if (e != cudaSuccess || lse == nullptr) return (int)e;
    fill_plus_inf<<<64, 256, 0, s>>>(lse, (size_t)B * H * Tq);
    return (int)cudaGetLastError();
  }
  switch (head_tile(D)) {
    case 64:
      return launch_wgmma_dv<64>(q, k, v, o, lse, B, H, KH, Tq, Tk, D, Dv, scale,
                                 causal, has_window, window, q_offset, kv_len, s);
    case 128:
      return launch_wgmma_dv<128>(q, k, v, o, lse, B, H, KH, Tq, Tk, D, Dv, scale,
                                  causal, has_window, window, q_offset, kv_len,
                                  s);
    default:
      return launch_wgmma_dv<256>(q, k, v, o, lse, B, H, KH, Tq, Tk, D, Dv, scale,
                                  causal, has_window, window, q_offset, kv_len,
                                  s);
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
