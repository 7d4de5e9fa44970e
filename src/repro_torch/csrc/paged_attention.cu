// Paged decode attention over the KV page pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel` / `paged_attention_kernel`
// (src/repro/kernels/paged_attention/kernel.py). Same function: attention of
// one new token per sequence over its KV pages, read in place from the pool
// in block-table order; -1 entries are clamped to page 0, keys at or past
// `length` are masked (pages at or past it never read), the softmax
// statistics (m, l, acc) are carried in fp32, and out = acc / max(l, 1e-20)
// in q's dtype. At length 0 no key is live and the output is 0, as in the
// TPU kernel (the reference's gather-based version returns a mean over page
// 0 instead).
//
// Layout: q, out [B, H, D]; kv_pages [P, page, 2, KH, D] (one layer of
// PagedKVCache.kv); block_tables [B, max_pages] int32; lengths [B] int32.
// G = H / KH query heads share a kv head; G <= 16, D <= 256.
//
// What bounds it on the H100: decode attention reads every live K/V byte
// once and does 4 G flops per K/V element pair, far below the card's ridge
// point, so the floor is the live K/V bytes over 3.35 TB/s; at a served
// batch of a few short sequences that floor (a few microseconds) is below
// the fixed cost of one launch. The design:
//
// * One launch a call. The grid is (KH, splits, B) in thread-block clusters
//   of `splits` blocks (at most 8, the portable size): the blocks of one
//   cluster share a (sequence, kv head) and take that sequence's live
//   chunks of keys in turn, so the plan follows each sequence's own length,
//   not the table's width, and a block's first chunks are known before the
//   length is (their table entries load beside it). Each block reduces its
//   keys to (m, l, acc) in its shared memory; after a cluster barrier every
//   block reads the others' statistics through distributed shared memory
//   (all loads issued before any is used) and writes its share of the
//   output. Chosen over the alternative (the last block of a pair to finish
//   merging partials from device memory, found by an atomic ticket) because
//   it needs no workspace, no counter that must start at zero and no second
//   trip through device memory: the merge stays on the chip. The wrapper
//   sizes `splits` from how many clusters the card runs at once
//   (paged_attention_capacity): a batch of few pairs runs in one wave.
// * Bytes in flight. Each block streams its keys' K and V rows of its kv
//   head through a ring of STAGES = 3 chunks of KC keys in shared memory,
//   two chunks ahead of use. Where it can, the copy engine fills the ring
//   (TMA): a 3-D tensor map over the pool seen as [P page, 2 KH, D] gives a
//   run of one page's rows of one kv head as one box, so one thread issues
//   two copies a chunk at page 64 (K and V), completing on the stage's
//   mbarrier; the box is as wide as the padded row, and the columns past D
//   arrive as zeros. Rows are padded by 16 bytes in shared memory, so that
//   eight rows fall on eight distinct bank groups (ldmatrix and 16-byte
//   loads without conflicts). Where a box cannot hold a padded row (over
//   256 elements: D = 256) or a page's run is under 8 rows, 16-byte
//   `cp.async` copies fill the same ring. Rows past the length are zeroed
//   (V; K is masked), so no stale value reaches a product. A row's page
//   comes from its table entry, loaded a chunk before its copies start, so
//   pages of any size are read in place and no copy waits on the table.
//   The copies set the pace at long contexts: on the H100 the same kernel
//   with its ring filled by `cp.async` alone (-DPAGED_NO_TMA) is 10-13%
//   slower at 32 sequences of 2-4K keys and within 6% at a batch of four
//   short ones (tools/paged_shapes.py --cp-async; PERF.md).
// * The arithmetic is latency-bound: with a few warps an SM, a chunk's
//   dependent chain (loads, products, exponentials) decides how fast a
//   block can consume bytes. So the loops carry no runtime bounds inside
//   (the head dim rounded up, DM, and the group bound, GB, are template
//   parameters; padding columns and rows are zero), the score sums run as
//   two independent chains, and the softmax runs in base 2 (scores scaled
//   by log2 e) with masked keys at -1e30, whose exp2 is exactly 0, so no
//   key takes a branch.
// * bf16 pool: tensor cores. A chunk is 64 keys, 16 a warp. Scores
//   S[g, t] = q[g] . K[t] on mma.sync m16n8k16 with the query group (padded
//   to 16 rows, a full tile for G = 16) as M and the keys as N, q's
//   fragments held in registers up to D = 128; the score fragment becomes,
//   rounded to bf16, the A operand of O += P V (V read by ldmatrix.trans),
//   so P never leaves registers. Each warp carries its own online softmax
//   over its keys (one 2-step quad reduction per row and 16 keys, none per
//   key); the 4 warps' (m, l, O) are merged in shared memory at the end.
//   Accumulation in fp32.
// * fp32 pool: fp32 FMAs (the 3e-5 tolerance rules out TF32). A chunk is
//   32 keys: for the scores a lane owns a key and a warp every fourth query
//   head, so a dot product is a lane's own sum over D (16-byte loads of its
//   K row, q broadcast, four independent chains); the row's max and sum
//   over the chunk take one warp reduction per row and chunk. For P V a
//   thread owns 4 columns of a few heads (and, when the group is small, a
//   slice of the chunk's keys) and reads P four keys at a time.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int G_MAX = 16;
constexpr int D_MAX = 256;
constexpr int SPLITS_MAX = 8;                // blocks of a cluster (portable)
constexpr int STAGES = 3;
constexpr int SLOT_RING = STAGES + 1;        // chunks whose token rows are known
constexpr int SMEM_ALIGN = 128;              // TMA destinations: 128-byte aligned
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// keys a chunk (one ring stage): 16 a warp on tensor cores; a lane a key in
// fp32
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> { static constexpr int KC = 64; };
template <> struct Chunk<float> { static constexpr int KC = 32; };

// Shared memory, in this order: the statistics below (fp32), the ring of
// STAGES x [K rows | V rows] of KC keys (row stride `row_stride`, the input
// type), q (bf16: [16, row_stride] zero-padded for ldmatrix; fp32:
// [max(GB, 4), D] zero-padded), and, fp32 only, the chunk's probabilities
// [GB, KC]; then the pool token rows of the next SLOT_RING chunks' keys
// (int32 [SLOT_RING, KC]). The base is rounded up to SMEM_ALIGN. After the
// key loop the ring holds the block's partial sums and its acc [G, D]. m is
// in base 2 (log2 e times the natural-log max) throughout.
struct __align__(SMEM_ALIGN) Stats {
  unsigned long long full[STAGES];           // TMA: a stage's rows have landed
  float m[G_MAX], l[G_MAX], corr[G_MAX];     // block-wide (fp32 route)
  float wm[WARPS][G_MAX], wl[WARPS][G_MAX];  // per warp (bf16 route)
  float w[SPLITS_MAX][G_MAX], den[G_MAX];    // the cluster merge
};
static_assert(sizeof(Stats) % SMEM_ALIGN == 0, "the ring starts aligned");

// bf16: the head dim rounded up to the kernel's bound DM (16, 32, 64, 128
// or 256); fp32: the group rounded up to a power of 2
__host__ __device__ inline int dm_of(int D) {
  int dm = 16;
  while (dm < D) dm *= 2;
  return dm;
}
__host__ __device__ inline int gb_of(int G) {
  int gb = 1;
  while (gb < G) gb *= 2;
  return gb;
}

__host__ __device__ inline int row_stride(int D, int elem) {
  if (elem == 2) return dm_of(D) + 8;                // 16 bytes of pad
  return D + ((D / 4) % 2 == 0 ? 4 : 8);             // an odd count of 16 B
}

size_t smem_bytes(int G, int D, int elem) {
  const int KC = elem == 2 ? Chunk<__nv_bfloat16>::KC : Chunk<float>::KC;
  const int GB = gb_of(G);
  const size_t ring = (size_t)STAGES * 2 * KC * row_stride(D, elem) * elem;
  const size_t qb = elem == 2 ? (size_t)16 * row_stride(D, elem) * 2
                              : (size_t)(GB < 4 ? 4 : GB) * D * 4;
  const size_t pb = elem == 2 ? 0 : (size_t)GB * KC * 4;
  return SMEM_ALIGN + sizeof(Stats) + ring + qb + pb + (size_t)SLOT_RING * KC * 4;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
// One box of the pool's tensor map (coordinates: column, K/V head, token
// row) into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}
// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 fp32
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(v.x, v.y);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(v.z, v.w);
}

// What a block needs to address its keys.
struct Keys {
  const int* table;          // this sequence's block-table row
  int live;                  // keys to attend: min(length, max_pages * page)
  int cap;                   // keys the table can hold: max_pages * page
  int page, page_shift;      // page_shift = log2(page), or -1
  size_t tok;                // elements between a page's token rows: 2 KH D
  size_t head;               // offset of kv head kh in a token row: kh D
  size_t v_off;              // offset of V in a token row: KH D
};

// The table entry of the page that holds key `t` (-1 clamped to 0), or -1
// past the table. Independent of the length, so that it can be loaded
// beside it.
__device__ __forceinline__ int key_slot(const Keys& k, int t) {
  if (t >= k.cap) return -1;
  const int p = k.page_shift >= 0 ? t >> k.page_shift : t / k.page;
  return max(__ldg(k.table + p), 0);
}
// Key `t`'s token row in the pool (slot * page + its place in the page),
// from its page's table entry `slot`; -1 past the length.
__device__ __forceinline__ int key_token(const Keys& k, int t, int slot) {
  if (t >= k.live) return -1;
  const int in_page = k.page_shift >= 0 ? t & (k.page - 1) : t % k.page;
  return slot * k.page + in_page;
}

// Start the copies of one chunk into `stage`: K rows, then V rows, each
// `rs` elements apart; `toks` holds each key's token row (key_token).
// cp.async route: a thread copies 16-byte piece `part` of rows r0, r0 +
// rows_per_pass, ...; rows past the length are zero-filled.
template <typename T, int KC>
__device__ __forceinline__ void load_chunk(T* stage, const T* __restrict__ kv,
                                           const Keys& k, const int* toks,
                                           int rs, int r0, int part,
                                           int rows_per_pass) {
  constexpr int PER = 16 / sizeof(T);
  if (r0 < 0) return;
  const T* base = kv + k.head + part * PER;
  T* dst = stage + r0 * rs + part * PER;
  for (int row = r0; row < 2 * KC; row += rows_per_pass, dst += rows_per_pass * rs) {
    const int tk = toks[row & (KC - 1)];
    cp_async16(dst, tk >= 0 ? base + (size_t)tk * k.tok + (row >= KC ? k.v_off : 0) : kv,
               tk >= 0 ? 16 : 0);
  }
}

// TMA route, one thread: a box of `br` keys (of one page) a copy, K then
// V, for each box whose first key is live; rows past the length inside a
// box land too and are zeroed after the wait (V) or masked (K).
template <typename T, int KC>
__device__ __forceinline__ void load_chunk_tma(T* stage, uint32_t bar,
                                               const CUtensorMap* tm, const int* toks,
                                               int rs, int br, int KH, int kh) {
  uint32_t boxes = 0;
  for (int r = 0; r < KC; r += br) boxes += toks[r] >= 0;
  mbar_expect_tx(bar, boxes * 2 * br * rs * (uint32_t)sizeof(T));
  for (int r = 0; r < KC; r += br) {
    const int tk = toks[r];
    if (tk < 0) continue;
    tma_load(smem_u32(stage + (size_t)r * rs), tm, bar, 0, kh, tk);
    tma_load(smem_u32(stage + (size_t)(KC + r) * rs), tm, bar, 0, KH + kh, tk);
  }
}

// One chunk on tensor cores (bf16): warp `warp` takes keys [16 warp, 16 warp
// + 16) of the chunk starting at key `t0`. `qf`: q's A fragments (QREG), or
// `qa`, their ldmatrix address. State: running maxima m (base 2) and
// partial sums l of rows gid and gid + 8, and O [16, DM] as DM / 8
// accumulator fragments.
template <int DM, bool QREG>
__device__ __forceinline__ void chunk_mma(const __nv_bfloat16* sK,
                                          const __nv_bfloat16* sV,
                                          const __nv_bfloat16* qa,
                                          const uint32_t (&qf)[QREG ? DM / 16 : 1][4],
                                          int t0, int live, float scale2,
                                          float (&m)[2], float (&l)[2],
                                          float (&o)[DM / 8][4]) {
  constexpr int RS = DM + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kbase = t0 + 16 * warp;
  if (kbase >= live) return;                 // no live key in this stripe
  const int tig = lane & 3;
  sK += 16 * warp * RS;
  sV += 16 * warp * RS;
  const __nv_bfloat16* ka =
      sK + ((lane & 7) + 8 * (lane >> 4)) * RS + 8 * ((lane >> 3) & 1);
  float s[2][2][4] = {};                     // [even/odd k-step][n-tile][fragment]
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk) {
    uint32_t a[4], b[4];
    if constexpr (QREG) {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qf[kk][r];
    } else {
      ldsm_x4(a, qa + 16 * kk);
    }
    ldsm_x4(b, ka + 16 * kk);
    mma16816(s[kk & 1][0], a, b[0], b[1]);
    mma16816(s[kk & 1][1], a, b[2], b[3]);
  }
  // s[0][j][e]: row gid (e < 2) or gid + 8, key kbase + 8 j + 2 tig + (e & 1)
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = kbase + 8 * j + 2 * tig + (e & 1) < live;
      s[0][j][e] = ok ? (s[0][j][e] + s[1][j][e]) * scale2 : NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[0][j][e]);
    }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);  // finite: key kbase is live
    corr[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[0][j][e] - m[e >> 1]);   // 0 where masked
      s[0][j][e] = p;
      l[e >> 1] += p;
    }
  uint32_t pa[4] = {pack_bf16(s[0][0][0], s[0][0][1]), pack_bf16(s[0][0][2], s[0][0][3]),
                    pack_bf16(s[0][1][0], s[0][1][1]), pack_bf16(s[0][1][2], s[0][1][3])};
  const __nv_bfloat16* va =
      sV + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS + 8 * (lane >> 4);
#pragma unroll
  for (int pp = 0; pp < DM / 16; ++pp) {
    uint32_t b[4];
    ldsm_x4_t(b, va + 16 * pp);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[2 * pp + h][0] *= corr[0];
      o[2 * pp + h][1] *= corr[0];
      o[2 * pp + h][2] *= corr[1];
      o[2 * pp + h][3] *= corr[1];
    }
    mma16816(o[2 * pp], pa, b[0], b[1]);
    mma16816(o[2 * pp + 1], pa, b[2], b[3]);
  }
}

// fp32 scores of one chunk, keys [t0, t0 + KC): warp w, lane t owns key t
// of rows g = w, w + 4, ... (RW of them; q's rows past G are zero); the
// softmax statistics per row in `st`; probabilities into sP [GB, KC].
template <int GB>
__device__ __forceinline__ void chunk_scores_f32(const float* sK, const float* sQ,
                                                 float* sP, Stats& st, int rs, int G,
                                                 int D, int t0, int live, float scale2) {
  constexpr int KC = Chunk<float>::KC;
  constexpr int RW = GB < WARPS ? 1 : GB / WARPS;      // rows a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* kr = sK + (size_t)lane * rs;
  const float* qr = sQ + (size_t)warp * D;
  float4 acc[RW];                            // four independent chains a row
#pragma unroll
  for (int r = 0; r < RW; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float4 q4 = *reinterpret_cast<const float4*>(qr + (size_t)WARPS * r * D + d);
      acc[r].x = fmaf(q4.x, k4.x, acc[r].x);
      acc[r].y = fmaf(q4.y, k4.y, acc[r].y);
      acc[r].z = fmaf(q4.z, k4.z, acc[r].z);
      acc[r].w = fmaf(q4.w, k4.w, acc[r].w);
    }
  }
  const bool ok = t0 + lane < live;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int g = warp + WARPS * r;
    if (g < G) {                               // warp-uniform
      const float dot = (acc[r].x + acc[r].y) + (acc[r].z + acc[r].w);
      const float s = ok ? dot * scale2 : NEG_INF;
      const float m_old = st.m[g];
      const float m_new = fmaxf(m_old, warp_max(s));   // finite: key t0 is live
      const float p = exp2f(s - m_new);                // 0 where masked
      const float sum = warp_sum(p);
      sP[g * KC + lane] = p;
      if (lane == 0) {
        const float corr = exp2f(m_old - m_new);
        st.corr[g] = corr;
        st.l[g] = st.l[g] * corr + sum;
        st.m[g] = m_new;
      }
    }
  }
}

struct PvPlan {              // the P V thread layout of the fp32 route
  int c, rg, RG, k0, k1;     // columns 4c.., rows rg + RG j, keys [k0, k1)
  int RK;                    // key slices
  bool active;
};

__device__ __forceinline__ PvPlan pv_plan(int G, int D) {
  constexpr int KC = Chunk<float>::KC;
  const int NQ = D / 4, R = THREADS / NQ;   // column quads, thread rows
  PvPlan p;
  p.RK = 1;                                  // a power of 2, at most 8
  while (p.RK < 8 && 2 * p.RK * G <= R) p.RK *= 2;
  p.RG = R / p.RK;
  const int r = threadIdx.x / NQ;
  p.c = threadIdx.x % NQ;
  p.rg = r / p.RK;
  p.k0 = (r % p.RK) * (KC / p.RK);
  p.k1 = p.k0 + KC / p.RK;
  p.active = r < R && p.rg < min(p.RG, G);
  return p;
}

// P V of one chunk in fp32: rows g = rg + RG j of the thread (at most NG,
// since RG >= 2 and G <= GB), its 4 columns, its slice of keys.
template <int NG>
__device__ __forceinline__ void chunk_pv_f32(const float* sV, const float* sP,
                                             const Stats& st, const PvPlan& pl,
                                             int G, int rs, float4 (&o)[NG]) {
  constexpr int KC = Chunk<float>::KC;
  if (!pl.active) return;
  const float* vc = sV + 4 * pl.c;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int g = pl.rg + pl.RG * j;
    if (g >= G) break;
    const float c = st.corr[g];
    float4 a = make_float4(o[j].x * c, o[j].y * c, o[j].z * c, o[j].w * c);
    const float* pg = sP + g * KC;
    for (int t = pl.k0; t < pl.k1; t += 4) {
      const float4 p = *reinterpret_cast<const float4*>(pg + t);
      const float4 v0 = *reinterpret_cast<const float4*>(vc + (size_t)t * rs);
      const float4 v1 = *reinterpret_cast<const float4*>(vc + (size_t)(t + 1) * rs);
      const float4 v2 = *reinterpret_cast<const float4*>(vc + (size_t)(t + 2) * rs);
      const float4 v3 = *reinterpret_cast<const float4*>(vc + (size_t)(t + 3) * rs);
      a.x = fmaf(p.x, v0.x, fmaf(p.y, v1.x, fmaf(p.z, v2.x, fmaf(p.w, v3.x, a.x))));
      a.y = fmaf(p.x, v0.y, fmaf(p.y, v1.y, fmaf(p.z, v2.y, fmaf(p.w, v3.y, a.y))));
      a.z = fmaf(p.x, v0.z, fmaf(p.y, v1.z, fmaf(p.z, v2.z, fmaf(p.w, v3.z, a.z))));
      a.w = fmaf(p.x, v0.w, fmaf(p.y, v1.w, fmaf(p.z, v2.w, fmaf(p.w, v3.w, a.w))));
    }
    o[j] = a;
  }
}

// One block per (kv head, split, sequence); the `gridDim.y` splits of a
// (sequence, kv head) form one cluster, and the kv heads of a (sequence,
// split), which read the same token rows, run side by side. bf16: DM = the
// head dim rounded up (dm_of); fp32: GB = the group rounded up (gb_of).
template <typename T, int DM, int GB>
__global__ void __launch_bounds__(THREADS, 1)
paged_attention_kernel(const __grid_constant__ CUtensorMap tm,
                       const T* __restrict__ q, const T* __restrict__ kv,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int KH, int D, int page, int page_shift,
                       int max_pages, float scale2, int tma_rows) {
  constexpr bool MMA = sizeof(T) == 2;
  constexpr bool QREG = MMA && DM <= 128;    // q's fragments in registers
  constexpr int KC = Chunk<T>::KC;
  constexpr int NG = GB < 2 ? 1 : GB / 2;    // fp32 P V rows a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (SMEM_ALIGN - smem_u32(smem_raw) % SMEM_ALIGN) % SMEM_ALIGN;
  cg::cluster_group cluster = cg::this_cluster();
  const bool tma = tma_rows > 0;             // else the cp.async route
  const int G = H / KH;
  const int rs = MMA ? DM + 8 : row_stride(D, sizeof(T));
  const int QR = MMA ? 16 : (GB < WARPS ? WARPS : GB);   // q rows, zero-padded
  Stats& st = *reinterpret_cast<Stats*>(smem);
  T* ring = reinterpret_cast<T*>(smem + sizeof(Stats));
  const size_t stage_elems = (size_t)2 * KC * rs;
  T* sQ = ring + STAGES * stage_elems;
  float* sP = reinterpret_cast<float*>(sQ + (size_t)QR * (MMA ? rs : D));
  int* sTok = reinterpret_cast<int*>(sP + (MMA ? 0 : GB * KC));

  const int split = cluster.block_rank(), splits = gridDim.y;
  const int kh = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  Keys k;
  k.table = block_tables + (size_t)b * max_pages;
  k.cap = max_pages * page;
  k.page = page;
  k.page_shift = page_shift;
  k.tok = (size_t)2 * KH * D;
  k.head = (size_t)kh * D;
  k.v_off = (size_t)KH * D;
  // this block's chunks: split, split + splits, ... of the sequence's live
  // ones (chunk c: keys [c KC, c KC + KC)). The first STAGES chunks' table
  // entries are loaded beside the length.
  int pre[STAGES];
#pragma unroll
  for (int j = 0; j < STAGES; ++j)
    pre[j] = tid < KC ? key_slot(k, (split + j * splits) * KC + tid) : -1;
  k.live = min(max(lengths[b], 0), k.cap);
  const int n_chunks = (k.live + KC - 1) / KC;
  const int n = split < n_chunks ? (n_chunks - split + splits - 1) / splits : 0;

  // the copy plan: piece `part` of every rows_per_pass-th row
  const int per_row = D * (int)sizeof(T) / 16;
  const int rows_per_pass = THREADS / per_row;
  const int r0 = tid < rows_per_pass * per_row ? tid / per_row : -1;
  const int part = tid % per_row;
  // q's copies first (a group of their own, so that they are not queued
  // behind the keys'); then the first STAGES chunks' token rows and the
  // first STAGES - 1 chunks' copies. From then on a chunk's table entries
  // are loaded a chunk before its copies start.
  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * per_row; i += THREADS) {
    const int g = i / per_row, pc = i - g * per_row;
    cp_async16(sQ + (size_t)g * (MMA ? rs : D) + pc * (16 / sizeof(T)),
               qb + (size_t)g * D + pc * (16 / sizeof(T)), 16);
  }
  cp_async_commit();
  if (tid < KC)
#pragma unroll
    for (int j = 0; j < STAGES; ++j)
      sTok[j * KC + tid] = key_token(k, (split + j * splits) * KC + tid, pre[j]);
  if (tma && tid == 0) {
    for (int j = 0; j < STAGES; ++j) mbar_init(smem_u32(&st.full[j]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (tma) {
      if (tid == 0 && i < n)
        load_chunk_tma<T, KC>(ring + i * stage_elems, smem_u32(&st.full[i]), &tm,
                              sTok + i * KC, rs, tma_rows, KH, kh);
    } else {
      if (i < n) load_chunk<T, KC>(ring + i * stage_elems, kv, k, sTok + i * KC, rs,
                                   r0, part, rows_per_pass);
      cp_async_commit();
    }
  }

  if (MMA) {
    // q's padding to a [16, DM] tile and the K and V rows' columns D..DM
    // (never copied) zeroed once, so that padded products add nothing
    for (int i = tid; i < 16 * DM; i += THREADS) {
      const int g = i / DM, d = i % DM;
      if (g >= G || d >= D) sQ[g * rs + d] = T(0.f);
    }
    if (DM != D && !tma)                     // TMA fills them itself
      for (int i = tid; i < STAGES * 2 * KC * (DM - D); i += THREADS) {
        const int row = i / (DM - D), d = D + i % (DM - D);
        ring[(size_t)row * rs + d] = T(0.f);
      }
  } else {
    for (int i = G * D + tid; i < QR * D; i += THREADS) sQ[i] = T(0.f);
  }
  if (tid < G_MAX) {
    st.m[tid] = NEG_INF;
    st.l[tid] = 0.f;
  }

  // per-thread state of the key loop (q's fragments once q has landed)
  uint32_t qf[QREG ? DM / 16 : 1][4];
  const __nv_bfloat16* qa = reinterpret_cast<const __nv_bfloat16*>(sQ) +
                            ((lane & 7) + 8 * ((lane >> 3) & 1)) * rs + 8 * (lane >> 4);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};      // bf16 route
  float o[MMA ? DM / 8 : 1][4] = {};
  float4 of[NG];                                            // fp32 route
#pragma unroll
  for (int j = 0; j < NG; ++j) of[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  const PvPlan pl = pv_plan(G, D);

  for (int i = 0; i < n; ++i) {
    const int t0 = (split + i * splits) * KC;
    T* sK = ring + (i % STAGES) * stage_elems;
    T* sV = sK + (size_t)KC * rs;
    if (tma) {
      if (i == 0) cp_async_wait<0>();        // q
      mbar_wait(smem_u32(&st.full[i % STAGES]), (i / STAGES) & 1);   // chunk i
      if (t0 + KC > k.live) {                // V rows past the length: zero
        const int first = max(k.live - t0, 0), per = rs * (int)sizeof(T) / 16;
        for (int e = tid; e < (KC - first) * per; e += THREADS)
          reinterpret_cast<int4*>(sV + (size_t)(first + e / per) * rs)[e % per] =
              make_int4(0, 0, 0, 0);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      }
    } else {
      cp_async_wait<STAGES - 2>();           // q, chunk i landed (this thread's part)
    }
    __syncthreads();                         // ... every part; stage i - 1 is free
    if constexpr (QREG)
      if (i == 0)
#pragma unroll
        for (int kk = 0; kk < DM / 16; ++kk) ldsm_x4(qf[kk], qa + 16 * kk);
    const int j = i + STAGES - 1;            // the chunk whose copies start now
    if (tma) {
      if (tid == 0 && j < n)
        load_chunk_tma<T, KC>(ring + (j % STAGES) * stage_elems,
                              smem_u32(&st.full[j % STAGES]), &tm,
                              sTok + (j % SLOT_RING) * KC, rs, tma_rows, KH, kh);
    } else {
      if (j < n)
        load_chunk<T, KC>(ring + (j % STAGES) * stage_elems, kv, k,
                          sTok + (j % SLOT_RING) * KC, rs, r0, part, rows_per_pass);
      cp_async_commit();
    }
    // the table entries of the chunk after, stored after this chunk's
    // arithmetic
    const int t_next = (split + (j + 1) * splits) * KC + tid;
    const int next = tid < KC && j + 1 < n ? key_slot(k, t_next) : -1;
    if constexpr (MMA) {
      chunk_mma<DM, QREG>(reinterpret_cast<const __nv_bfloat16*>(sK),
                          reinterpret_cast<const __nv_bfloat16*>(sV), qa, qf, t0,
                          k.live, scale2, m, l, o);
    } else {
      chunk_scores_f32<GB>(reinterpret_cast<const float*>(sK),
                           reinterpret_cast<const float*>(sQ), sP, st, rs, G, D,
                           t0, k.live, scale2);
      __syncthreads();                       // sP, st.corr
      chunk_pv_f32<NG>(reinterpret_cast<const float*>(sV), sP, st, pl, G, rs, of);
    }
    if (tid < KC) sTok[((j + 1) % SLOT_RING) * KC + tid] = key_token(k, t_next, next);
  }
  cp_async_wait<0>();
  __syncthreads();                           // the ring is free

  // the block's acc [G, D] (fp32, relative to st.m) in the ring
  float* part_buf = reinterpret_cast<float*>(ring);
  float* sO;
  if constexpr (MMA) {
    // each warp's (m, l, O [16, DM]); then merged over the warps
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      if (tig == 0) {
        st.wm[warp][gid + 8 * h] = m[h];
        st.wl[warp][gid + 8 * h] = l[h];
      }
    }
    float* wo = part_buf + (size_t)warp * 16 * DM;
#pragma unroll
    for (int dt = 0; dt < DM / 8; ++dt) {
      *reinterpret_cast<float2*>(wo + gid * DM + 8 * dt + 2 * tig) =
          make_float2(o[dt][0], o[dt][1]);
      *reinterpret_cast<float2*>(wo + (gid + 8) * DM + 8 * dt + 2 * tig) =
          make_float2(o[dt][2], o[dt][3]);
    }
    __syncthreads();
    if (tid < G) {
      float mb = NEG_INF;
      for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, st.wm[w][tid]);
      float lb = 0.f;
      for (int w = 0; w < WARPS; ++w) {
        const float x = exp2f(st.wm[w][tid] - mb);
        st.wm[w][tid] = x;                   // the warp's weight
        lb = fmaf(x, st.wl[w][tid], lb);
      }
      st.m[tid] = mb;
      st.l[tid] = lb;
    }
    __syncthreads();
    sO = part_buf + (size_t)WARPS * 16 * DM;
    for (int e = tid; e < G * D; e += THREADS) {
      const int g = e / D, d = e - g * D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        a = fmaf(st.wm[w][g], part_buf[((size_t)w * 16 + g) * DM + d], a);
      sO[e] = a;
    }
  } else {
    // the key slices' partial sums; then summed over the slices
    if (pl.active) {
      const int NQ = D / 4, rk = (tid / NQ) % pl.RK;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int g = pl.rg + pl.RG * j;
        if (g < G) store4(part_buf + ((size_t)rk * G + g) * D + 4 * pl.c, of[j]);
      }
    }
    __syncthreads();
    sO = part_buf + (size_t)pl.RK * G * D;
    for (int e = tid; e < G * D; e += THREADS) {
      float a = 0.f;
      for (int r = 0; r < pl.RK; ++r) a += part_buf[(size_t)r * G * D + e];
      sO[e] = a;
    }
  }

  // merge the cluster's splits: out = sum_s w_s acc_s / max(sum_s w_s l_s,
  // 1e-20), w_s = exp2(m_s - max_s m_s); this block writes its share of the
  // [G, D] outputs. Each thread issues all its remote loads before it uses
  // any, so the merge waits for one round trip, not one a split.
  cluster.sync();                            // every split's m, l, acc are final
  if (tid < G) {
    float ms[SPLITS_MAX], ls[SPLITS_MAX];
#pragma unroll
    for (int s = 0; s < SPLITS_MAX; ++s)
      if (s < splits) {
        ms[s] = cluster.map_shared_rank(st.m, s)[tid];
        ls[s] = cluster.map_shared_rank(st.l, s)[tid];
      }
    float M = NEG_INF;
#pragma unroll
    for (int s = 0; s < SPLITS_MAX; ++s)
      if (s < splits) M = fmaxf(M, ms[s]);
    float den = 0.f;
#pragma unroll
    for (int s = 0; s < SPLITS_MAX; ++s)
      if (s < splits) {
        const float w = exp2f(ms[s] - M);
        st.w[s][tid] = w;
        den = fmaf(w, ls[s], den);
      }
    st.den[tid] = fmaxf(den, 1e-20f);
  }
  __syncthreads();
  const int n4 = G * D / 4, share = (n4 + splits - 1) / splits;
  T* ob = out + ((size_t)b * H + (size_t)kh * G) * D;
  for (int e = split * share + tid; e < min(n4, (split + 1) * share); e += THREADS) {
    const int g = 4 * e / D;
    float4 xs[SPLITS_MAX];
#pragma unroll
    for (int s = 0; s < SPLITS_MAX; ++s)
      if (s < splits)
        xs[s] = reinterpret_cast<const float4*>(cluster.map_shared_rank(sO, s))[e];
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < SPLITS_MAX; ++s)
      if (s < splits) {
        const float w = st.w[s][g];
        a.x = fmaf(w, xs[s].x, a.x); a.y = fmaf(w, xs[s].y, a.y);
        a.z = fmaf(w, xs[s].z, a.z); a.w = fmaf(w, xs[s].w, a.w);
      }
    const float inv = 1.f / st.den[g];
    store4(ob + 4 * e, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
  }
  cluster.sync();                            // no block leaves while read
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

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

// Keys a TMA box holds (a run of one page, dividing the chunk), or 0 where
// the copy engine cannot fill the ring: a padded row over the 256 elements
// of a box, or a box under 8 rows (its shared-memory start would not be
// 128-byte aligned). Those geometries take the cp.async route.
// Built with -DPAGED_NO_TMA, every geometry takes the cp.async route
// (tools/paged_shapes.py --cp-async times the two routes side by side).
template <typename T>
int tma_box_rows(int D, int page) {
#ifdef PAGED_NO_TMA
  return 0;
#else
  const int br = gcd(page, Chunk<T>::KC);
  return row_stride(D, sizeof(T)) <= 256 && br >= 8 ? br : 0;
#endif
}

// The pool [P, page, 2, KH, D] seen as [P page, 2 KH, D] (tokens, K/V heads,
// columns), read in boxes of `rows` tokens of one K/V head and row_stride
// columns: the columns past D are filled with zeros, which gives the ring's
// padded rows.
template <typename T>
int make_map(CUtensorMap* map, const void* kv, int P, int page, int KH, int D,
             int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)2 * KH,
                              (cuuint64_t)P * page};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T),
                                 (cuuint64_t)2 * KH * D * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)row_stride(D, sizeof(T)), 1,
                             (cuuint32_t)rows};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(kv), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Launch the kernel, or with `capacity` set only write how many clusters of
// `splits` blocks of it can run on the card at once.
template <typename T, int DM, int GB>
int launch(const void* q, const void* kv, const void* block_tables,
           const void* lengths, void* out, int B, int H, int KH, int D, int P,
           int page, int max_pages, int splits, float scale, cudaStream_t stream,
           int* capacity) {
  auto kernel = paged_attention_kernel<T, DM, GB>;
  const size_t smem = smem_bytes(H / KH, D, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm = {};
  const int tma_rows = capacity ? 0 : tma_box_rows<T>(D, page);
  if (tma_rows) {
    const int e = make_map<T>(&tm, kv, P, page, KH, D, tma_rows);
    if (e) return e;
  }
  int page_shift = -1;
  if ((page & (page - 1)) == 0)
    for (page_shift = 0; (1 << page_shift) < page; ++page_shift) {}
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KH, splits, capacity ? 1 : B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (capacity) return (int)cudaOccupancyMaxActiveClusters(capacity, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, tm, static_cast<const T*>(q),
                           static_cast<const T*>(kv),
                           static_cast<const int*>(block_tables),
                           static_cast<const int*>(lengths), static_cast<T*>(out),
                           H, KH, D, page, page_shift, max_pages, scale * LOG2E,
                           tma_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int dispatch(int dtype, const void* q, const void* kv_pages, const void* block_tables,
             const void* lengths, void* out, int B, int H, int KH, int D, int P,
             int page, int max_pages, int splits, float scale, void* stream,
             int* capacity) {
  const int elem = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || KH < 1 || H % KH != 0 || H / KH > G_MAX ||
      D < 1 || D > D_MAX || (D * elem) % 16 != 0 || P < 1 || page < 1 || max_pages < 0 ||
      splits < 1 || splits > SPLITS_MAX || B > 65535 || KH > 65535 ||
      (long long)max_pages * page > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  if (B == 0 && !capacity) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_LAUNCH(T, DM, GB)                                                 \
  return launch<T, DM, GB>(q, kv_pages, block_tables, lengths, out, B, H, KH, D, P, \
                           page, max_pages, splits, scale, s, capacity)
  if (dtype == 1) switch (dm_of(D)) {
      case 16: PAGED_LAUNCH(__nv_bfloat16, 16, 16);
      case 32: PAGED_LAUNCH(__nv_bfloat16, 32, 16);
      case 64: PAGED_LAUNCH(__nv_bfloat16, 64, 16);
      case 128: PAGED_LAUNCH(__nv_bfloat16, 128, 16);
      default: PAGED_LAUNCH(__nv_bfloat16, 256, 16);
    }
  switch (gb_of(H / KH)) {
    case 1: PAGED_LAUNCH(float, 16, 1);
    case 2: PAGED_LAUNCH(float, 16, 2);
    case 4: PAGED_LAUNCH(float, 16, 4);
    case 8: PAGED_LAUNCH(float, 16, 8);
    default: PAGED_LAUNCH(float, 16, 16);
  }
#undef PAGED_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; P: pages in the pool. One launch: grid
// (KH, splits, B) in clusters of `splits` blocks. Returns cudaGetLastError()
// after the launch.
int paged_attention_fwd(int dtype, const void* q, const void* kv_pages,
                        const void* block_tables, const void* lengths, void* out,
                        int B, int H, int KH, int D, int P, int page, int max_pages,
                        int splits, float scale, void* stream) {
  return dispatch(dtype, q, kv_pages, block_tables, lengths, out, B, H, KH, D, P,
                  page, max_pages, splits, scale, stream, nullptr);
}

// Bytes of dynamic shared memory one block takes for a group of G query
// heads of D (into *bytes; the launch passes the same smem_bytes); returns
// cudaErrorInvalidValue past the kernel's limits.
int paged_attention_smem(int dtype, int G, int D, int* bytes) {
  if ((dtype != 0 && dtype != 1) || G < 1 || G > G_MAX || D < 1 || D > D_MAX)
    return (int)cudaErrorInvalidValue;
  *bytes = (int)smem_bytes(G, D, dtype == 0 ? 4 : 2);
  return 0;
}

// How many clusters of `splits` blocks can run on the current card at once
// at this geometry (into *capacity); returns a CUDA error code.
int paged_attention_capacity(int dtype, int H, int KH, int D, int splits,
                             int* capacity) {
  return dispatch(dtype, nullptr, nullptr, nullptr, nullptr, nullptr, 0, H, KH, D, 1,
                  1, 0, splits, 1.f, nullptr, capacity);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
