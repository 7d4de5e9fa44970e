// AdamW's update of one parameter leaf, in place, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's update (src/repro/optim/adamw.py)
// is a chain of jnp ops that XLA fuses into one pass a leaf. The port's plain
// version (kernels/adamw/ref.py, `adamw_ref`) is the same chain in eager
// PyTorch: about 20 full-size fp32 temporaries a leaf, each written and read
// back, then three copies into the state, some 178 bytes moved a parameter.
//
// Per element, in fp32, with bc1 = 1 - b1^t and bc2 = 1 - b2^t at step t:
//
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + ((1 - b2) g) g
//   u  = (m' / bc1) / (sqrt(v' / bc2) + eps)  [ + wd p, leaves of rank >= 2 ]
//   p' = p - lr u
//
// p' is stored in p's dtype, m' and v' in the moments' dtype; the fp32 m'
// (not its rounded store) feeds u.
//
// What bounds it on the H100: about 16 flops an element against 28 bytes
// (fp32 p, m and v read and written, g read), so memory. The 2.76 B
// parameters of deepseek-v2-lite-16b's 4-layer training state are 77.25 GB a
// step, 23.06 ms at 3.35 TB/s. The design moves those bytes once: one launch
// a leaf, a grid-stride loop over the flat leaf, 8 elements a thread an
// iteration (two 16-byte loads of each fp32 tensor, one of each bf16 one),
// every intermediate in registers; streaming loads and evict-first stores
// (`__ldcs`, `__stcs`), since no byte is read twice. 8 blocks of 256 threads
// an SM keep up to 256 KB in flight an SM.
//
// Two routes, which the wrapper chooses from the pointers alone:
// * `vector`: p, m, v (and g, unless it is a broadcast scalar) start on a
//   16-byte boundary. The last n % 8 elements are taken one a thread in the
//   same launch.
// * `scalar`: any of them does not. The same loop, one element a thread an
//   iteration.
// A gradient with every stride 0 (an unused leaf's zeros, one scalar
// expanded to the leaf's shape) is read once a thread, never materialised.
//
// Bits: every op is a separately rounded intrinsic (`__fmul_rn`, `__fadd_rn`,
// `__fsub_rn`, `__fdiv_rn`, `__fsqrt_rn`) in the plain version's order, so
// nvcc cannot contract a product and a sum into an FMA; the constants are the
// floats PyTorch's scalar ops use (each Python float rounded once to fp32;
// 1 - b1 and 1 - b2 taken in double first); bc1 and bc2 are 0-d fp32 tensors
// that the wrapper computes on the device with the plain version's own ops,
// read here through pointers (no host sync). bf16 stores round to nearest
// even, as `Tensor.to` does. So the kernel gives the plain version's bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int VEC = 8;   // elements a thread an iteration on the vector route

struct Hyper {
  float lr, b1, b2, c1, c2, eps, wd;   // c1 = 1 - b1, c2 = 1 - b2
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// VEC elements from p + i, 16-byte aligned
__device__ __forceinline__ void load8(const float* p, size_t i, float (&x)[VEC]) {
  const float4* q = reinterpret_cast<const float4*>(p + i);
  const float4 a = __ldcs(q), b = __ldcs(q + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, size_t i,
                                      float (&x)[VEC]) {
  const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p + i));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {        // bf16 -> fp32 is exact: the high half
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, size_t i, const float (&x)[VEC]) {
  float4* q = reinterpret_cast<float4*>(p + i);
  __stcs(q, make_float4(x[0], x[1], x[2], x[3]));
  __stcs(q + 1, make_float4(x[4], x[5], x[6], x[7]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, size_t i,
                                       const float (&x)[VEC]) {
  __stcs(reinterpret_cast<uint4*>(p + i),
         make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                    pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7])));
}

// One element, in the plain version's order and rounding
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       float bc1, float bc2, const Hyper& h,
                                       bool decay) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.c1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, h.c2), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps);
  float u = __fdiv_rn(__fdiv_rn(m, bc1), den);
  if (decay) u = __fadd_rn(u, __fmul_rn(p, h.wd));
  p = __fsub_rn(p, __fmul_rn(u, h.lr));
}

template <typename P, typename G, typename M, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
adamw_leaf(P* __restrict__ p, const G* __restrict__ g, M* __restrict__ m,
           M* __restrict__ v, long long n, int g_scalar, int decay,
           const float* __restrict__ bc1p, const float* __restrict__ bc2p,
           Hyper h) {
  const float bc1 = *bc1p, bc2 = *bc2p;
  const float g0 = g_scalar ? to_f(g[0]) : 0.f;
  const size_t N = (size_t)n;
  const size_t stride = (size_t)gridDim.x * THREADS;
  const size_t tid = (size_t)blockIdx.x * THREADS + threadIdx.x;
  size_t tail = 0;
  if (VECTOR) {
    const size_t nv = N / VEC;
    for (size_t j = tid; j < nv; j += stride) {
      const size_t i = j * VEC;
      float pf[VEC], gf[VEC], mf[VEC], vf[VEC];
      load8(p, i, pf);
      load8(m, i, mf);
      load8(v, i, vf);
      if (g_scalar) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) gf[k] = g0;
      } else {
        load8(g, i, gf);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        update(pf[k], gf[k], mf[k], vf[k], bc1, bc2, h, decay);
      store8(p, i, pf);
      store8(m, i, mf);
      store8(v, i, vf);
    }
    tail = nv * VEC;
  }
  for (size_t i = tail + tid; i < N; i += stride) {
    float pf = to_f(p[i]), mf = to_f(m[i]), vf = to_f(v[i]);
    update(pf, g_scalar ? g0 : to_f(g[i]), mf, vf, bc1, bc2, h, decay);
    put(p + i, pf);
    put(m + i, mf);
    put(v + i, vf);
  }
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

template <typename P, typename G, typename M>
int launch(int vector, void* p, const void* g, void* m, void* v, long long n,
           int g_scalar, int decay, const float* bc1, const float* bc2,
           Hyper h, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long work = vector ? n / VEC : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  blocks = blocks < 1 ? 1 : blocks;
  blocks = blocks > (long long)sms * BLOCKS_PER_SM ? (long long)sms * BLOCKS_PER_SM
                                                   : blocks;
  P* pp = static_cast<P*>(p);
  const G* gp = static_cast<const G*>(g);
  M* mp = static_cast<M*>(m);
  M* vp = static_cast<M*>(v);
  if (vector)
    adamw_leaf<P, G, M, true><<<(unsigned)blocks, THREADS, 0, stream>>>(
        pp, gp, mp, vp, n, g_scalar, decay, bc1, bc2, h);
  else
    adamw_leaf<P, G, M, false><<<(unsigned)blocks, THREADS, 0, stream>>>(
        pp, gp, mp, vp, n, g_scalar, decay, bc1, bc2, h);
  return (int)cudaGetLastError();
}

template <typename P, typename G>
int by_moments(int m_dtype, int vector, void* p, const void* g, void* m,
               void* v, long long n, int g_scalar, int decay, const float* bc1,
               const float* bc2, Hyper h, cudaStream_t s) {
  if (m_dtype == 0)
    return launch<P, G, float>(vector, p, g, m, v, n, g_scalar, decay, bc1,
                               bc2, h, s);
  return launch<P, G, __nv_bfloat16>(vector, p, g, m, v, n, g_scalar, decay,
                                     bc1, bc2, h, s);
}

template <typename P>
int by_grad(int g_dtype, int m_dtype, int vector, void* p, const void* g,
            void* m, void* v, long long n, int g_scalar, int decay,
            const float* bc1, const float* bc2, Hyper h, cudaStream_t s) {
  if (g_dtype == 0)
    return by_moments<P, float>(m_dtype, vector, p, g, m, v, n, g_scalar,
                                decay, bc1, bc2, h, s);
  return by_moments<P, __nv_bfloat16>(m_dtype, vector, p, g, m, v, n,
                                      g_scalar, decay, bc1, bc2, h, s);
}

}  // namespace

extern "C" {

// One AdamW step of one leaf of n elements, in place. Dtypes (0 = float32,
// 1 = bfloat16): p_dtype of p, g_dtype of g, m_dtype of m and v. p, m, v
// contiguous; g contiguous, or (g_scalar) one element standing for all.
// vector: take the vector route (every pointer but a scalar g 16-byte
// aligned; refused otherwise). decay: add wd * p (leaves of rank >= 2).
// bc1, bc2: device pointers to fp32 1 - b1^t and 1 - b2^t. c1, c2: 1 - b1
// and 1 - b2. Returns cudaGetLastError() after the launch.
int adamw_step(int p_dtype, int g_dtype, int m_dtype, int vector, void* p,
               const void* g, void* m, void* v, long long n, int g_scalar,
               int decay, const void* bc1, const void* bc2, float lr, float b1,
               float b2, float c1, float c2, float eps, float wd,
               void* stream) {
  if ((p_dtype != 0 && p_dtype != 1) || (g_dtype != 0 && g_dtype != 1) ||
      (m_dtype != 0 && m_dtype != 1) || n < 0)
    return (int)cudaErrorInvalidValue;
  if (vector && !(aligned16(p) && aligned16(m) && aligned16(v) &&
                  (g_scalar || aligned16(g))))
    return (int)cudaErrorMisalignedAddress;
  if (n == 0) return 0;
  const Hyper h{lr, b1, b2, c1, c2, eps, wd};
  const float* b1p = static_cast<const float*>(bc1);
  const float* b2p = static_cast<const float*>(bc2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0)
    return by_grad<float>(g_dtype, m_dtype, vector, p, g, m, v, n, g_scalar,
                          decay, b1p, b2p, h, s);
  return by_grad<__nv_bfloat16>(g_dtype, m_dtype, vector, p, g, m, v, n,
                                g_scalar, decay, b1p, b2p, h, s);
}

const char* adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
