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
// the TPU kernels' `T % block_t == 0` is a Pallas tiling rule. Slots need
// not be unique: pairs that share a row add up, in token order.
//
// What bounds them on the H100: a handful of adds per element moved, so
// memory. At grok-1-314b's prefill (N = 2048 tokens, K = 2, E = 32 buffers,
// 4 batch rows x 8 experts, C = 160, D = 6144, bf16) dispatch reads x
// (25.2 MB) and writes the buffers (62.9 MB), 0.026 ms at 3.35 TB/s; combine
// reads the selected buffer rows (50.3 MB) and writes out (25.2 MB),
// 0.023 ms. At decode (N = 4, C = 4) both move under 2 MB and one launch
// sets the time.
//
// The TPU builds one-hot masks in VMEM and turns both into MXU products. On
// Hopper they are gathers, with every sum in registers:
// * dispatch, `walk` route (more than DIRECT_MAX_PAIRS pairs, a prefill):
//   one block of WALK_THREADS an SM, each owning an equal run of at most
//   WALK_ROWS (expert, slot) rows over the whole width (39 rows at grok's
//   prefill), so that the assignment is read once a block: 132 times 32 KB
//   from L2, against once per 8 rows and 2048 columns before. Its threads
//   walk the [N, K] ids, WALK_PAIRS each with one 16-byte load of each
//   array, and one block-wide exclusive scan of their hit counts (one
//   barrier a window of WALK_WINDOW pairs) lists the hits on the block's
//   rows in shared memory in pair order, i.e. token order, with each row's
//   count and first entry. Then:
//   - a row with at most one listed pair (every row under served routing,
//     where `compute_slots` gives each kept pair a row of its own) is a copy
//     of that x row or zeros: a warp takes a chunk of 32 * COPY_BATCH
//     16-byte pieces of a row, the block's warps spread over as many rows as
//     there are warps, and each lane issues its COPY_BATCH loads before its
//     stores (evict-first: the 63 MB of buffers do not fit L2);
//   - any other row sums in order: a warp a (row, column chunk) walks the
//     row's listed hits (a ballot over the list) and adds each x row into
//     fp32 registers. The list holds HIT_CAP hits; past that (a hot expert,
//     repeated slots) the walk goes on counting and marks the rows whose
//     hits did not fit, and the warp of such a row then walks the pairs
//     after the last listed hit itself, in order, so that the sum keeps its
//     order whatever the list holds.
// * dispatch, `direct` route (at most DIRECT_MAX_PAIRS pairs, every decode
//   step): no walk and no barrier. A block owns one row and a column tile;
//   each warp reads the few pairs straight from L1/L2, 32 a load, finds its
//   row's hits by ballot and adds them in order.
// Either way each output element is 0 + x[t1] + x[t2] + ... in fp32 in token
// order: repeated slots add up, the bits do not depend on scheduling (nor on
// the route: they equal the earlier kernel's), no atomics touch the data,
// and a row with one pair holds exactly that x row.
// * combine: a block a token and a column tile, a thread a 16-byte piece of
//   it; each thread reads the token's ids and gates for KG pairs at once,
//   issues those rows' loads (read-only, L2 fetching 256 bytes at a time)
//   before their FMAs, which run in k order in fp32.
// Rows move in 16-byte loads and stores where D and the pointers allow,
// else element by element. No load is issued for a piece past the row's end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// dispatch, walk route
constexpr int WALK_THREADS = 1024;
constexpr int WALK_WARPS = WALK_THREADS / 32;
constexpr int WALK_ROWS = 64;        // most (expert, slot) rows a block owns
constexpr int WALK_MIN_ROWS = 8;     // fewest, while there are blocks to spare
constexpr int WALK_BLOCKS_PER_SM = 1;
constexpr int WALK_PAIRS = 4;        // pairs a thread walks a window
constexpr int WALK_WINDOW = WALK_THREADS * WALK_PAIRS;
constexpr int HIT_CAP = 1024;        // hits the shared list holds
constexpr int COPY_BATCH = 8;        // 16-byte loads a thread has in flight
constexpr int WALK_VECS = 2;         // 16-byte pieces a lane sums a chunk
// dispatch, direct route
constexpr int DIRECT_MAX_PAIRS = 64; // kernel.py DIRECT_MAX_PAIRS
constexpr int DIRECT_THREADS = 128;
constexpr int DIRECT_VECS = 1;
// combine
constexpr int COMBINE_THREADS = 256;
constexpr int COMBINE_VECS = 1;

template <typename T> struct Vec;   // elements in 16 bytes
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of a row as they lie in memory, from `p`: one aligned 16-byte
// load where `vec`, else the `n` elements inside the row one by one, the
// rest zero bits. `widen` turns them into fp32.
// `Prefetch`: read-only, no L1 line, and L2 fetches 256 bytes at a time
// (combine's rows). `Stream`: evict-first stores (outputs larger than L2).
template <bool Prefetch>
__device__ __forceinline__ uint4 ld16(const void* p) {
  if (!Prefetch) return *reinterpret_cast<const uint4*>(p);
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}
template <bool Stream>
__device__ __forceinline__ void st16(void* p, uint4 v) {
  if (Stream) __stcs(reinterpret_cast<uint4*>(p), v);
  else *reinterpret_cast<uint4*>(p) = v;
}
template <bool Prefetch = false>
__device__ __forceinline__ uint4 load_raw(const float* p, bool vec, int n) {
  if (vec) return ld16<Prefetch>(p);
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = i < n ? __float_as_uint(p[i]) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <bool Prefetch = false>
__device__ __forceinline__ uint4 load_raw(const __nv_bfloat16* p, bool vec,
                                          int n) {
  if (vec) return ld16<Prefetch>(p);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (2 * i < n ? h[2 * i] : 0u) |
           (2 * i + 1 < n ? (unsigned)h[2 * i + 1] << 16 : 0u);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void widen(const uint4& r, float* out);
template <>
__device__ __forceinline__ void widen<float>(const uint4& r, float* out) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& r,
                                                     float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <bool Stream = false>
__device__ __forceinline__ void store_vec(float* p, bool vec, int n,
                                          const float* v) {
  if (vec) {
    st16<Stream>(p, make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                       __float_as_uint(v[2]), __float_as_uint(v[3])));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) p[i] = v[i];
  }
}
template <bool Stream = false>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, bool vec, int n,
                                          const float* v) {
  if (vec) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    st16<Stream>(p, u);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[i] = __float2bfloat16(v[i]);
  }
}

// A warp's chunk of a row: lane `lane` holds the NV 16-byte pieces at
// columns c0 + (i * 32 + lane) * V, i < NV, so that each piece index is one
// contiguous 512-byte access of the warp. `load_chunk` issues all NV loads
// before it widens any.
template <typename T, int NV>
__device__ __forceinline__ void load_chunk(const T* row, int c0, int D,
                                           bool vec, int lane, float* v) {
  constexpr int V = Vec<T>::N;
  uint4 raw[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = c0 + (i * 32 + lane) * V;
    const int n = min(V, D - col);
    raw[i] = n > 0 ? load_raw(row + col, vec && n == V, n)
                   : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) widen<T>(raw[i], v + i * V);
}

template <typename T, int NV, bool Stream = false>
__device__ __forceinline__ void store_chunk(T* row, int c0, int D, bool vec,
                                            int lane, const float* v) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = c0 + (i * 32 + lane) * V;
    const int n = min(V, D - col);
    if (n > 0) store_vec<Stream>(row + col, vec && n == V, n, v + i * V);
  }
}

// acc += x[tok] over the chunk, element by element in fp32.
template <typename T, int NV>
__device__ __forceinline__ void add_row(const T* x, int tok, int c0, int D,
                                        bool vec, int lane, float* acc) {
  float v[NV * Vec<T>::N];
  load_chunk<T, NV>(x + (size_t)tok * D, c0, D, vec, lane, v);
#pragma unroll
  for (int i = 0; i < NV * Vec<T>::N; ++i) acc[i] += v[i];
}

// The (expert, slot) row of a pair, or -1 where the pair is dropped.
__device__ __forceinline__ int pair_row(int e, int s, int E, int C) {
  return e >= 0 && e < E && s >= 0 && s < C ? e * C + s : -1;
}

// Ballot the 32 pairs q0 .. q0 + 31 (lane l reads pair q0 + l) for `row`
// and add their x rows in pair order. Returns nothing; reads ids from L1/L2.
template <typename T, int NV>
__device__ __forceinline__ void add_pairs(const T* x, const int* eid,
                                          const int* slot, int q0, int P,
                                          int K, int E, int C, int D,
                                          int row, int c0, bool vec, int lane,
                                          float* acc) {
  const int p = q0 + lane;
  const bool hit = p < P && pair_row(eid[p], slot[p], E, C) == row;
  unsigned m = __ballot_sync(FULL, hit);
  while (m) {
    const int b = __ffs(m) - 1;
    m &= m - 1;
    add_row<T, NV>(x, (q0 + b) / K, c0, D, vec, lane, acc);
  }
}

typedef unsigned long long RowMask;          // a bit for each row of a block
static_assert(WALK_ROWS <= 64 && WALK_WARPS <= 32 && WALK_PAIRS % 4 == 0,
              "row masks, the scan of warp counts and 16-byte id loads");

// Walk route. Grid walk_blocks(E*C): block b owns rows [b*R/G, (b+1)*R/G),
// at most WALK_ROWS; no dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(WALK_THREADS)
dispatch_walk(const T* __restrict__ x, const int* __restrict__ eid,
              const int* __restrict__ slot, T* __restrict__ out, int P,
              int K, int E, int C, int D, int vec_ok, int ids_vec) {
  constexpr int V = Vec<T>::N;
  constexpr int CHUNK = 32 * WALK_VECS * V;   // columns of a warp's chunk
  __shared__ int s_tok[HIT_CAP];              // the listed hits, pair order
  __shared__ unsigned char s_row[HIT_CAP];
  __shared__ int s_warp[2][WALK_WARPS];       // hit counts, by window parity
  __shared__ int s_count[WALK_ROWS];          // each row's listed hits
  __shared__ int s_first[WALK_ROWS];          // and the first one's entry
  __shared__ RowMask s_over;                  // rows with hits past the list
  __shared__ int s_first_over;                // the pair of the first such hit

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const long long R = (long long)E * C;
  const int r0 = (int)(blockIdx.x * R / gridDim.x);
  const int rows = (int)((blockIdx.x + 1) * R / gridDim.x) - r0;
  if (tid < WALK_ROWS) {
    s_count[tid] = 0;
    s_first[tid] = HIT_CAP;
  }
  if (tid == 0) {
    s_over = 0ull;
    s_first_over = P;
  }

  // 1. the walk: which pairs land on the block's rows, listed in order
  int found = 0;                              // hits before this window
  for (int w0 = 0, par = 0; w0 < P; w0 += WALK_WINDOW, par ^= 1) {
    const int base = w0 + tid * WALK_PAIRS;   // this thread's run of pairs
    int e[WALK_PAIRS], s[WALK_PAIRS];
#pragma unroll
    for (int q = 0; q < WALK_PAIRS; q += 4) {
      const int p = base + q;
      if (ids_vec && p + 4 <= P) {
        const int4 a = *reinterpret_cast<const int4*>(eid + p);
        const int4 b = *reinterpret_cast<const int4*>(slot + p);
        e[q] = a.x; e[q + 1] = a.y; e[q + 2] = a.z; e[q + 3] = a.w;
        s[q] = b.x; s[q + 1] = b.y; s[q + 2] = b.z; s[q + 3] = b.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e[q + i] = p + i < P ? eid[p + i] : -1;
          s[q + i] = p + i < P ? slot[p + i] : -1;
        }
      }
    }
    unsigned mine = 0;                        // bit j: pair base + j hits
#pragma unroll
    for (int j = 0; j < WALK_PAIRS; ++j) {
      const int r = pair_row(e[j], s[j], E, C) - r0;
      e[j] = r;                               // from here on: the local row
      if (r >= 0 && r < rows) mine |= 1u << j;
    }
    // exclusive scan of the hit counts over the block, in thread order
    const int n = __popc(mine);
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_warp[par][w] = incl;
    __syncthreads();   // s_warp[par ^ 1] is free too: all have passed here
    // the warps' counts, scanned across the lanes of every warp
    const int wc = lane < WALK_WARPS ? s_warp[par][lane] : 0;
    int wincl = wc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, wincl, o);
      if (lane >= o) wincl += v;
    }
    int at = found + incl - n + __shfl_sync(FULL, wincl - wc, w);
    const int total = __shfl_sync(FULL, wincl, 31);
    RowMask over = 0;
#pragma unroll
    for (int j = 0; j < WALK_PAIRS; ++j) {
      if (mine >> j & 1u) {
        if (at < HIT_CAP) {
          s_tok[at] = (base + j) / K;
          s_row[at] = (unsigned char)e[j];
          atomicAdd(&s_count[e[j]], 1);
          atomicMin(&s_first[e[j]], at);
        } else {
          over |= 1ull << e[j];
          if (at == HIT_CAP) s_first_over = base + j;
        }
        ++at;
      }
    }
    const unsigned lo = __reduce_or_sync(FULL, (unsigned)over);
    const unsigned hi = __reduce_or_sync(FULL, (unsigned)(over >> 32));
    if (lane == 0 && (lo | hi)) atomicOr(&s_over, (RowMask)hi << 32 | lo);
    found += total;
  }
  __syncthreads();

  // 2. rows with at most one pair, all of it listed (every row under
  // served routing): a copy of that x row, or zeros. A warp a (row, chunk
  // of 32 * COPY_BATCH pieces), the block's warps on as many rows at once
  // (tasks row-minor): each lane's COPY_BATCH loads, then its stores
  const RowMask over_rows = s_over;
  const bool vec = vec_ok;
  const int pieces = (D + V - 1) / V;
  const int copy_chunks = (pieces + 32 * COPY_BATCH - 1) / (32 * COPY_BATCH);
  for (int task = w; task < rows * copy_chunks; task += WALK_WARPS) {
    const int r = task % rows;
    if (s_count[r] > 1 || over_rows >> r & 1ull) continue;   // summed in 3.
    const int tok = s_count[r] == 1 ? s_tok[s_first[r]] : -1;
    const int p0 = (task / rows) * 32 * COPY_BATCH + lane;
    T* dst = out + (size_t)(r0 + r) * D;
    uint4 raw[COPY_BATCH];
#pragma unroll
    for (int b = 0; b < COPY_BATCH; ++b) {
      const int col = (p0 + b * 32) * V;
      const int n = min(V, D - col);
      raw[b] = tok >= 0 && n > 0
          ? load_raw(x + (size_t)tok * D + col, vec && n == V, n)
          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int b = 0; b < COPY_BATCH; ++b) {
      const int col = (p0 + b * 32) * V;
      const int n = min(V, D - col);
      if (n <= 0) continue;
      float v[V];
      widen<T>(raw[b], v);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = 0.f + v[k];  // as the sum has it
      store_vec<true>(dst + col, vec && n == V, n, v);
    }
  }

  // 3. the other rows (repeated slots, a hot row): a warp a (row, column
  // chunk) sums the row's hits in order in registers
  const int listed = min(found, HIT_CAP);
  const int first_over = s_first_over;
  const int chunks = (D + CHUNK - 1) / CHUNK;
  for (int task = w; task < rows * chunks; task += WALK_WARPS) {
    const int r = task / chunks;
    const bool over = over_rows >> r & 1ull;
    if (s_count[r] <= 1 && !over) continue;   // copied in 2.
    const int c0 = (task - r * chunks) * CHUNK;
    float acc[WALK_VECS * V];
#pragma unroll
    for (int i = 0; i < WALK_VECS * V; ++i) acc[i] = 0.f;
    for (int j0 = 0; j0 < listed; j0 += 32) {
      const int j = j0 + lane;
      unsigned m = __ballot_sync(FULL, j < listed && s_row[j] == r);
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        add_row<T, WALK_VECS>(x, s_tok[j0 + b], c0, D, vec, lane, acc);
      }
    }
    if (over) {                               // hits the list did not hold
      for (int q0 = first_over; q0 < P; q0 += 32)
        add_pairs<T, WALK_VECS>(x, eid, slot, q0, P, K, E, C, D, r0 + r, c0,
                                vec, lane, acc);
    }
    store_chunk<T, WALK_VECS, true>(out + (size_t)(r0 + r) * D, c0, D, vec,
                                    lane, acc);
  }
}

// Direct route. Grid (E*C, ceil(D / (DIRECT_THREADS * DIRECT_VECS * V))).
template <typename T>
__global__ void __launch_bounds__(DIRECT_THREADS)
dispatch_direct(const T* __restrict__ x, const int* __restrict__ eid,
                const int* __restrict__ slot, T* __restrict__ out, int P,
                int K, int E, int C, int D, int vec_ok) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.y * DIRECT_THREADS + (threadIdx.x & ~31)) *
                 DIRECT_VECS * V;
  if (c0 >= D) return;                        // the whole warp
  const int row = blockIdx.x;
  float acc[DIRECT_VECS * V];
#pragma unroll
  for (int i = 0; i < DIRECT_VECS * V; ++i) acc[i] = 0.f;
  for (int q0 = 0; q0 < P; q0 += 32)
    add_pairs<T, DIRECT_VECS>(x, eid, slot, q0, P, K, E, C, D, row, c0,
                              vec_ok, lane, acc);
  store_chunk<T, DIRECT_VECS>(out + (size_t)row * D, c0, D, vec_ok, lane,
                              acc);
}

// Grid (N, ceil(D / (COMBINE_THREADS * COMBINE_VECS * V))): a block a token
// and a column tile, thread i the 16-byte pieces i, i + COMBINE_THREADS, ...
// of the tile. KG: pairs whose ids, gates and rows are loaded together (1,
// 2 or 4; K itself where K <= 2).
template <typename T, typename G, int KG>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const T* __restrict__ y, const int* __restrict__ eid,
               const int* __restrict__ slot, const G* __restrict__ gates,
               T* __restrict__ out, int K, int E, int C, int D, int vec_ok) {
  constexpr int V = Vec<T>::N;
  constexpr int NV = COMBINE_VECS;
  const int c0 = blockIdx.y * COMBINE_THREADS * NV * V + threadIdx.x * V;
  if (c0 >= D) return;
  const size_t t = blockIdx.x;
  const bool vec = vec_ok;
  float acc[NV * V];
#pragma unroll
  for (int i = 0; i < NV * V; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KG) {
    int rk[KG];
    float gk[KG];
#pragma unroll
    for (int j = 0; j < KG; ++j) {            // ids and gate, loaded together
      rk[j] = -1;
      gk[j] = 0.f;
      if (k0 + j < K) {
        const size_t p = t * K + k0 + j;
        const int e = eid[p], s = slot[p];
        const G g = gates[p];
        rk[j] = pair_row(e, s, E, C);
        gk[j] = to_f(g);
      }
    }
    uint4 raw[KG][NV];                        // every row's loads, then FMAs
#pragma unroll
    for (int j = 0; j < KG; ++j)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int col = c0 + i * COMBINE_THREADS * V;
        const int n = min(V, D - col);
        raw[j][i] = rk[j] >= 0 && n > 0
            ? load_raw<true>(y + (size_t)rk[j] * D + col, vec && n == V, n)
            : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      if (rk[j] < 0) continue;                // a dropped pair adds nothing
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float v[V];
        widen<T>(raw[j][i], v);
#pragma unroll
        for (int q = 0; q < V; ++q)
          acc[i * V + q] = fmaf(gk[j], v[q], acc[i * V + q]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = c0 + i * COMBINE_THREADS * V;
    const int n = min(V, D - col);
    if (n > 0)
      store_vec<true>(out + t * D + col, vec && n == V, n, acc + i * V);
  }
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) |
           reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// The walk route's grid for R rows: WALK_BLOCKS_PER_SM blocks an SM, so that
// every block runs at once and each owns an equal share of the rows, within
// [WALK_MIN_ROWS, WALK_ROWS] rows a block. A negative CUDA error on failure.
int walk_blocks(int R) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const int least = (R + WALK_ROWS - 1) / WALK_ROWS;
  const int most = (R + WALK_MIN_ROWS - 1) / WALK_MIN_ROWS;
  const int want = sms * WALK_BLOCKS_PER_SM < most ? sms * WALK_BLOCKS_PER_SM
                                                  : most;
  return want > least ? want : least;
}

int dispatch_route(long long pairs) {         // 0: walk, 1: direct
  return pairs <= DIRECT_MAX_PAIRS ? 1 : 0;
}

template <typename T>
int launch_dispatch(const void* x, const int* eid, const int* slot, void* out,
                    int N, int K, int E, int C, int D, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int P = N * K;
  const int vec_ok = D % V == 0 && aligned16(x, out);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (dispatch_route(P)) {
    const int cols = DIRECT_THREADS * DIRECT_VECS * V;
    const dim3 grid(E * C, (D + cols - 1) / cols);
    dispatch_direct<T><<<grid, DIRECT_THREADS, 0, stream>>>(
        xt, eid, slot, ot, P, K, E, C, D, vec_ok);
  } else {
    const int blocks = walk_blocks(E * C);
    if (blocks < 0) return -blocks;
    dispatch_walk<T><<<blocks, WALK_THREADS, 0, stream>>>(
        xt, eid, slot, ot, P, K, E, C, D, vec_ok, aligned16(eid, slot));
  }
  return (int)cudaGetLastError();
}

template <typename T, typename G>
int launch_combine(const void* y, const int* eid, const int* slot,
                   const void* gates, void* out, int N, int K, int E, int C,
                   int D, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int cols = COMBINE_THREADS * COMBINE_VECS * V;
  const dim3 grid(N, (D + cols - 1) / cols);
  const int vec_ok = D % V == 0 && aligned16(y, out);
  const T* yt = static_cast<const T*>(y);
  const G* gt = static_cast<const G*>(gates);
  T* ot = static_cast<T*>(out);
  if (K <= 1)
    combine_kernel<T, G, 1><<<grid, COMBINE_THREADS, 0, stream>>>(
        yt, eid, slot, gt, ot, K, E, C, D, vec_ok);
  else if (K == 2)
    combine_kernel<T, G, 2><<<grid, COMBINE_THREADS, 0, stream>>>(
        yt, eid, slot, gt, ot, K, E, C, D, vec_ok);
  else
    combine_kernel<T, G, 4><<<grid, COMBINE_THREADS, 0, stream>>>(
        yt, eid, slot, gt, ot, K, E, C, D, vec_ok);
  return (int)cudaGetLastError();
}

bool bad_sizes(int N, int K, int E, int C, int D) {
  // the narrowest column tile (fp32) sets the most tiles, the widest (bf16)
  // how far a tile's columns may run past D
  constexpr int narrow = DIRECT_THREADS * DIRECT_VECS < COMBINE_THREADS *
      COMBINE_VECS ? DIRECT_THREADS * DIRECT_VECS : COMBINE_THREADS * COMBINE_VECS;
  constexpr int min_cols = narrow * 4;
  constexpr int max_cols = (DIRECT_THREADS * DIRECT_VECS + COMBINE_THREADS *
                            COMBINE_VECS + 32 * WALK_VECS) * 8;
  const int max_tiles = 65535;                    // gridDim.y
  // pair indices stay below INT_MAX with a window to spare
  return N < 0 || K < 0 || E < 0 || C < 0 || D < 0 ||
         (long long)N * K > INT_MAX - WALK_WINDOW ||
         (long long)E * C > INT_MAX || D > INT_MAX - max_cols ||
         (D + min_cols - 1) / min_cols > max_tiles;
}

}  // namespace

extern "C" {

// The route a dispatch of `pairs` = N * K pairs takes: 0 = walk, 1 = direct
// (kernel.py `dispatch_route` is the same function).
int shuffle_dispatch_route(long long pairs) { return dispatch_route(pairs); }

// dtype (of x and out): 0 = float32, 1 = bfloat16. x: [N, D]; expert_id,
// slot: [N, K] int32; out: [E, C, D]; all contiguous. One launch, on the
// route of shuffle_dispatch_route(N * K). Returns cudaGetLastError() after
// the launch.
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
