// Paged decode attention over the KV page pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel` / `paged_attention_kernel`
// (src/repro/kernels/paged_attention/kernel.py). Same function: attention of
// one new token per sequence over its KV pages, read in place from the pool
// in block-table order; -1 entries are clamped to page 0, pages with
// p * page >= length are skipped, the softmax statistics (m, l, acc) are
// carried in fp32, and out = acc / max(l, 1e-20).
//
// Layout: q, out [B, H, D]; kv_pages [P, page, 2, KH, D] (one layer of
// PagedKVCache.kv); block_tables [B, max_pages] int32; lengths [B] int32.
//
// What bounds it on the H100: decode attention moves every live K/V byte once
// and does 4 flops per K/V element pair, far below the card's ridge point, so
// the floor is the live K/V bytes over 3.35 TB/s. Two things keep the memory
// system busy:
// * split over pages (flash-decoding): grid (KH, B, splits); a block takes
//   `pages_per_split` consecutive table entries of one (sequence, kv head),
//   computes the G = H / KH query heads that share that kv head (each K/V
//   byte is read once for all of them) and writes its partial (m, l, acc);
//   `paged_combine_kernel` merges the splits. The wrapper sizes the split so
//   that there are about two blocks per SM; with one block per (sequence, kv
//   head) a small batch left most SMs idle and each block ran its per-page
//   reductions at latency;
// * each page's K and V rows of the kv head ([page, D] each) are staged in
//   shared memory with 16-byte cp.async copies, double-buffered when a block
//   has more than one page, so the next page streams in while this one is
//   scored (one warp per key row, lanes across D).
//
// At length 0 no page is live and the output is 0, as in the TPU kernel (the
// reference's gather-based version returns a mean over page 0 instead).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GD_MAX = 1024;                 // G * D held in registers
constexpr int ACC = GD_MAX / THREADS;
constexpr int SPLITS_MAX = 64;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Shared memory: `stages` x [K rows | V rows] of one page in the input type,
// then fp32 q [G, D], scores [G, page] and the per-head max, sum and
// correction [G].
size_t smem_bytes(int G, int D, int page, int elem, int stages) {
  return 2 * (size_t)stages * page * D * elem +
         sizeof(float) * ((size_t)G * D + (size_t)G * page + 3 * (size_t)G);
}

// Start the copies of page `slot`'s K and V rows of kv head `kh` into `dst`.
template <typename T>
__device__ __forceinline__ void stage_page(T* dst, const T* kv, int slot, int kh,
                                           int KH, int D, int page) {
  constexpr int PER = 16 / sizeof(T);            // elements per 16-byte copy
  const int per_row = D / PER;
  const size_t tok = (size_t)2 * KH * D;
  const T* base = kv + (size_t)slot * page * tok + (size_t)kh * D;
  for (int c = threadIdx.x; c < 2 * page * per_row; c += THREADS) {
    const int kvsel = c / (page * per_row);
    const int rem = c - kvsel * page * per_row;
    const int t = rem / per_row, part = rem - t * per_row;
    cp_async16(dst + ((size_t)kvsel * page + t) * D + part * PER,
               base + t * tok + (size_t)kvsel * KH * D + part * PER);
  }
}

// One block per (kv head, sequence, split): partial softmax statistics over
// table entries [split * pages_per_split, ...) into part_m / part_l [B, KH,
// splits, G] and the unnormalised part_acc [B, KH, splits, G, D].
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ lengths, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc,
                   int H, int KH, int D, int page, int max_pages,
                   int pages_per_split, int stages, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KH;
  T* stage_buf = reinterpret_cast<T*>(smem);
  float* sQ = reinterpret_cast<float*>(stage_buf + (size_t)2 * stages * page * D);
  float* sS = sQ + G * D;         // [G, page] scores, then probabilities
  float* sM = sS + G * page;      // [G] running max
  float* sL = sM + G;             // [G] running sum
  float* sC = sL + G;             // [G] this page's correction factor

  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int length = lengths[b];
  const int* table = block_tables + (size_t)b * max_pages;
  const int n_live = min(max_pages, (length + page - 1) / page);
  const int p_begin = split * pages_per_split;
  const int p_end = min(p_begin + pages_per_split, n_live);

  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += THREADS) sQ[i] = to_f(qb[i]);
  if (tid < G) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;

  if (p_begin < p_end) {
    stage_page(stage_buf, kv, max(table[p_begin], 0), kh, KH, D, page);
    cp_async_commit();
  }
  for (int p = p_begin; p < p_end; ++p) {
    const int st = stages == 2 ? ((p - p_begin) & 1) : 0;
    const T* sK = stage_buf + (size_t)st * 2 * page * D;
    const T* sV = sK + (size_t)page * D;
    if (stages == 2 && p + 1 < p_end) {   // the next page streams in meanwhile
      stage_page(stage_buf + (size_t)(st ^ 1) * 2 * page * D, kv,
                 max(table[p + 1], 0), kh, KH, D, page);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();            // page p is in shared memory for every thread

    for (int t = warp; t < page; t += WARPS) {
      const bool live = p * page + t < length;
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s = fmaf(sQ[g * D + d], to_f(sK[t * D + d]), s);
        s = warp_sum(s);
        if (lane == 0) sS[g * page + t] = live ? s * scale : NEG_INF;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, sS[g * page + t]);
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float e = (p * page + t < length) ? expf(sS[g * page + t] - m_new) : 0.f;
        sS[g * page + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sC[g] = corr;
        sL[g] = sL[g] * corr + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int e = tid + a * THREADS;
      if (e < G * D) {
        const int g = e / D, d = e - g * D;
        float pv = 0.f;
        for (int t = 0; t < page; ++t) pv = fmaf(sS[g * page + t], to_f(sV[t * D + d]), pv);
        acc[a] = acc[a] * sC[g] + pv;
      }
    }
    __syncthreads();            // this stage and sS are free for reuse
  }

  const size_t part = ((size_t)b * KH + kh) * splits + split;
  if (tid < G) {
    part_m[part * G + tid] = sM[tid];
    part_l[part * G + tid] = sL[tid];
  }
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = tid + a * THREADS;
    if (e < G * D) part_acc[part * G * D + e] = acc[a];
  }
}

// One block per (kv head, sequence): merge the splits' partial statistics,
// out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-20) with w_s = exp(m_s - M).
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_combine_kernel(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc, T* __restrict__ out,
                     int H, int KH, int D, int splits) {
  extern __shared__ float cs[];
  const int G = H / KH;
  float* sW = cs;                 // [splits, G] weights
  float* sDen = cs + splits * G;  // [G] denominators
  const int kh = blockIdx.x, b = blockIdx.y;
  const size_t base = ((size_t)b * KH + kh) * splits;
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float M = NEG_INF;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, part_m[(base + s) * G + g]);
    float den = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(part_m[(base + s) * G + g] - M);
      sW[s * G + g] = w;
      den = fmaf(w, part_l[(base + s) * G + g], den);
    }
    sDen[g] = fmaxf(den, 1e-20f);
  }
  __syncthreads();
  T* ob = out + ((size_t)b * H + (size_t)kh * G) * D;
  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int g = e / D;
    float a = 0.f;
    for (int s = 0; s < splits; ++s)
      a = fmaf(sW[s * G + g], part_acc[(base + s) * G * D + e], a);
    store(&ob[e], a / sDen[g]);
  }
}

template <typename T>
int launch(const void* q, const void* kv, const void* block_tables,
           const void* lengths, void* out, float* part_m, float* part_l,
           float* part_acc, int B, int H, int KH, int D, int page,
           int max_pages, int splits, int pages_per_split, float scale,
           cudaStream_t stream) {
  const int G = H / KH;
  const int stages = pages_per_split > 1 ? 2 : 1;
  const size_t smem = smem_bytes(G, D, page, sizeof(T), stages);
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_split_kernel<T><<<dim3(KH, B, splits), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv),
      static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
      part_m, part_l, part_acc, H, KH, D, page, max_pages, pages_per_split,
      stages, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t csmem = sizeof(float) * ((size_t)splits * G + G);
  paged_combine_kernel<T><<<dim3(KH, B), THREADS, csmem, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), H, KH, D, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. part_m / part_l: fp32 [B, KH, splits, G];
// part_acc: fp32 [B, KH, splits, G, D]; splits * pages_per_split must cover
// max_pages. Returns cudaGetLastError() after the two launches.
int paged_attention_fwd(int dtype, const void* q, const void* kv_pages,
                        const void* block_tables, const void* lengths, void* out,
                        void* part_m, void* part_l, void* part_acc, int B,
                        int H, int KH, int D, int page, int max_pages,
                        int splits, int pages_per_split, float scale,
                        void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (KH < 1 || H % KH != 0 || (H / KH) * D > GD_MAX || (D * elem) % 16 != 0 ||
      splits < 1 || splits > SPLITS_MAX || pages_per_split < 1 ||
      (long long)splits * pages_per_split < max_pages)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return launch<float>(q, kv_pages, block_tables, lengths, out, pm, pl, pa,
                         B, H, KH, D, page, max_pages, splits, pages_per_split,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kv_pages, block_tables, lengths, out, pm,
                                 pl, pa, B, H, KH, D, page, max_pages, splits,
                                 pages_per_split, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
