// The optimizer update (clip by global norm, then AdamW) for Hopper
// (sm_90a), as three kernels.
//
// Replaces no Pallas kernel: the reference's jitted train step
// (kubedl_tpu/training/trainer.py:675-735) gets the optax chain
// clip_by_global_norm -> adamw (:193-211) from XLA as a few fusions. These
// kernels are that pass, with XLA's roundings: ops/adamw.py states them
// and holds the plain PyTorch version (adamw_update_plain) that every
// kernel here reproduces bit for bit, op for op. Every float32 operation
// is an explicit __f*_rn intrinsic, so nvcc contracts nothing into an FMA
// that the plain version does not have, and every rounding to bf16 is
// __float2bfloat16_rn (round to nearest even) where the plain version
// rounds.
//
// Bound by bytes: a bf16 parameter with a float32 first moment reads
// p, g, mu and nu (10 bytes) and writes p, mu and nu (8 bytes) in the
// update, and reads g (2 bytes) once more for the norm: 20 bytes a
// parameter, 24.7 GB a Llama-3.2-1B step, 7.4 ms at 3.35 TB/s. So each
// thread moves whole 16-byte vectors (8 elements a step), and nothing
// but the norm is read twice.
//
// - adamw_sumsq_kernel, one launch a leaf: each CTA sums f32(g)^2 over a
//   fixed grid-stride share of the leaf in a fixed order (each thread a
//   compensated sum) and writes the float32 sum to its own slot (no
//   atomics).
// - adamw_norm_finish_kernel, one CTA: sums each leaf's slots in a fixed
//   order into the leaf's float32 sum of squares, rounds it to the
//   leaf's type, chains the leaves in order with a rounding after each
//   add (the reference's Python sum of bf16 scalars), and writes the
//   rounded sqrt: the global norm. The same inputs give the same bits on
//   every call, and the host never waits for it.
// - adamw_update_kernel<P_BF16, M_BF16>, one launch a leaf: reads the
//   norm from device memory (so "clip or not" never reaches the host),
//   and updates p, mu and nu in place. Parameters bf16 or float32, the
//   first moment float32 or bf16; the second moment has the parameters'
//   type. With no norm (a null pointer: optax.adam, no clipping stage)
//   the first two kernels are not launched and g is used as it is.
//
// Every kernel launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements a thread takes a step (16 bytes of bf16)
constexpr int kMaxLeaves = 256;

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// round to the type (bf16 when BF, float32 otherwise: a no-op)
template <bool BF>
__device__ __forceinline__ float rnd(float x) {
  return BF ? rbf(x) : x;
}

template <bool BF>
__device__ __forceinline__ float load1(const void* base, int64_t i) {
  if (BF) return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  return static_cast<const float*>(base)[i];
}

template <bool BF>
__device__ __forceinline__ void store1(void* base, int64_t i, float x) {
  if (BF)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(base)[i] = x;
}

// 8 consecutive elements from a 16-byte-aligned address: one uint4 of
// bf16, two float4 of float32
template <bool BF>
__device__ __forceinline__ void load8(const void* base, int64_t i,
                                      float (&x)[kVec]) {
  if (BF) {
    const uint4 v = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      x[2 * j] = f.x;
      x[2 * j + 1] = f.y;
    }
  } else {
    const float4* f = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + i);
    const float4 a = f[0], b = f[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
}

template <bool BF>
__device__ __forceinline__ void store8(void* base, int64_t i,
                                       const float (&x)[kVec]) {
  if (BF) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + i) = v;
  } else {
    float4* f = reinterpret_cast<float4*>(static_cast<float*>(base) + i);
    f[0] = make_float4(x[0], x[1], x[2], x[3]);
    f[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// one step of a compensated (Kahan) float32 sum: a thread adds ~2,000
// squares of a 262M-element leaf in sequence, which plain float32 adds
// would carry ~1e-5 relative off the exact sum
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = __fsub_rn(x, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// a CTA's float32 sum, in a fixed order: each warp by shuffles, then
// warp 0 over the warps' partials
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? part[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  __syncthreads();  // part[] is reused by the caller's next call
  return v;
}

// ---- the norm -------------------------------------------------------------

template <bool BF>
__global__ void __launch_bounds__(kThreads)
adamw_sumsq_kernel(const void* __restrict__ g, int64_t n, bool vec,
                   float* __restrict__ slots) {
  float acc = 0.0f, comp = 0.0f;
  const int64_t chunks = (n + kVec - 1) / kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       c < chunks; c += stride) {
    const int64_t i = c * kVec;
    float x[kVec];
    if (vec && i + kVec <= n) {
      load8<BF>(g, i, x);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = i + j < n ? load1<BF>(g, i + j) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) kahan_add(acc, comp, __fmul_rn(x[j], x[j]));
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) slots[blockIdx.x] = acc;
}

struct LeafTable {
  int n_leaves;
  int offset[kMaxLeaves + 1];  // leaf i's slots: [offset[i], offset[i+1])
  unsigned char bf16[kMaxLeaves];
};

// out[0]: the global norm (rounded to the chain's type, as a float32);
// out[1 + i]: leaf i's float32 sum of squares
__global__ void __launch_bounds__(kThreads)
adamw_norm_finish_kernel(const float* __restrict__ slots, LeafTable t,
                         float* __restrict__ out) {
  float chain = 0.0f;
  bool chain_bf16 = true;
  for (int leaf = 0; leaf < t.n_leaves; ++leaf) {
    float v = 0.0f, comp = 0.0f;
    for (int s = t.offset[leaf] + threadIdx.x; s < t.offset[leaf + 1];
         s += kThreads)
      kahan_add(v, comp, slots[s]);
    v = block_sum(v);
    if (threadIdx.x == 0) {
      out[1 + leaf] = v;
      const bool bf = t.bf16[leaf] != 0;
      const float r = bf ? rbf(v) : v;
      if (leaf == 0) {
        chain = r;
        chain_bf16 = bf;
      } else {
        chain_bf16 = chain_bf16 && bf;
        chain = __fadd_rn(chain, r);
        if (chain_bf16) chain = rbf(chain);
      }
    }
  }
  if (threadIdx.x == 0) {
    const float nrm = __fsqrt_rn(chain);
    out[0] = chain_bf16 ? rbf(nrm) : nrm;
  }
}

// ---- the update -----------------------------------------------------------

// The step's scalars, each already the float32 value the plain version
// uses (rounded on the host where the reference rounds them): see
// ops/adamw.py::step_scalars.
struct Scalars {
  float clip_cmp, clip, a1, d1, a2, d2, eps, wd, bc1, bc2, neg_lr;
};

// One element of the update. Q, the type of the new first moment before
// it is stored (mu_dtype promoted with the parameters'), is bf16 only if
// both are bf16. Each line is one line of ops/adamw.py::_leaf_plain.
template <bool PB, bool MB>
__device__ __forceinline__ void adamw_elem(float g, float& p, float& m,
                                           float& v, bool keep, float nrm,
                                           const Scalars& c) {
  constexpr bool QB = PB && MB;
  const float gc =
      keep ? g : rnd<PB>(__fmul_rn(rnd<PB>(__fdiv_rn(g, nrm)), c.clip));
  const float t1 = rnd<QB>(__fmul_rn(gc, c.a1));
  const float t2 = rnd<QB>(__fmul_rn(m, c.d1));
  const float mu = rnd<QB>(__fadd_rn(t1, t2));
  const float sq = rnd<PB>(__fmul_rn(gc, gc));
  const float nu = rnd<PB>(__fadd_rn(rnd<PB>(__fmul_rn(sq, c.a2)),
                                     rnd<PB>(__fmul_rn(v, c.d2))));
  const float nu_hat = rnd<PB>(__fdiv_rn(nu, c.bc2));
  const float s = rnd<PB>(__fsqrt_rn(nu_hat));
  const float den = rnd<QB>(__fadd_rn(s, c.eps));
  float u;
  if (QB)
    u = rbf(__fdiv_rn(rbf(__fdiv_rn(mu, c.bc1)), den));
  else  // XLA's form: mu / bc1 / den as mu / (bc1 * den)
    u = __fdiv_rn(mu, __fmul_rn(c.bc1, den));
  const float w = rnd<QB>(__fadd_rn(u, rnd<QB>(__fmul_rn(p, c.wd))));
  const float step = rnd<QB>(__fmul_rn(c.neg_lr, w));
  p = rnd<PB>(__fadd_rn(p, step));
  m = mu;  // rounded to mu's type when stored
  v = nu;
}

template <bool PB, bool MB>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(void* __restrict__ p, const void* __restrict__ g,
                    void* __restrict__ mu, void* __restrict__ nu,
                    const float* __restrict__ norm, int64_t n, bool vec,
                    Scalars c) {
  // no norm: no clipping stage, every element keeps its gradient (a
  // non-finite entry poisons only its own element)
  const float nrm_chain = norm ? norm[0] : 0.0f;
  const bool keep = !norm || nrm_chain < c.clip_cmp;
  // the reference divides by the norm cast to the leaf's type
  const float nrm = rnd<PB>(nrm_chain);
  const int64_t chunks = (n + kVec - 1) / kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t ch = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       ch < chunks; ch += stride) {
    const int64_t i = ch * kVec;
    if (vec && i + kVec <= n) {
      float xg[kVec], xp[kVec], xm[kVec], xv[kVec];
      load8<PB>(g, i, xg);
      load8<PB>(p, i, xp);
      load8<MB>(mu, i, xm);
      load8<PB>(nu, i, xv);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        adamw_elem<PB, MB>(xg[j], xp[j], xm[j], xv[j], keep, nrm, c);
      store8<PB>(p, i, xp);
      store8<MB>(mu, i, xm);
      store8<PB>(nu, i, xv);
    } else {
      for (int64_t k = i; k < n && k < i + kVec; ++k) {
        float xp = load1<PB>(p, k), xm = load1<MB>(mu, k),
              xv = load1<PB>(nu, k);
        adamw_elem<PB, MB>(load1<PB>(g, k), xp, xm, xv, keep, nrm, c);
        store1<PB>(p, k, xp);
        store1<MB>(mu, k, xm);
        store1<PB>(nu, k, xv);
      }
    }
  }
}

int grid_for(int64_t n, int cap) {
  const int64_t chunks = (n + kVec - 1) / kVec;
  const int64_t blocks = (chunks + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

// The CTAs (slots) the norm of a leaf of n elements takes: mirrors
// ops/adamw.py::norm_blocks. A leaf has fewer than 2^31 elements (the
// wrapper checks); the kernels index with 64 bits.
extern "C" int kdl_adamw_norm_blocks(int n) { return grid_for(n, 528); }

// slots: float32, this leaf's kdl_adamw_norm_blocks(n) slots. vec: g is
// 16-byte aligned. Returns cudaGetLastError().
extern "C" int kdl_adamw_sumsq(const void* g, int n, int bf16, int vec,
                               float* slots, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n, 528);
  if (bf16)
    adamw_sumsq_kernel<true><<<blocks, kThreads, 0, st>>>(g, n, vec != 0, slots);
  else
    adamw_sumsq_kernel<false><<<blocks, kThreads, 0, st>>>(g, n, vec != 0, slots);
  return static_cast<int>(cudaGetLastError());
}

// offsets (host, n_leaves + 1 ints) and bf16 (host, n_leaves flags) are
// copied into the launch's parameters; out: float32 [1 + n_leaves].
extern "C" int kdl_adamw_norm_finish(const float* slots, const int* offsets,
                                     const int* bf16, int n_leaves, float* out,
                                     void* stream) {
  if (n_leaves <= 0 || n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  LeafTable t;
  t.n_leaves = n_leaves;
  for (int i = 0; i <= n_leaves; ++i) t.offset[i] = offsets[i];
  for (int i = 0; i < n_leaves; ++i) t.bf16[i] = bf16[i] ? 1 : 0;
  adamw_norm_finish_kernel<<<1, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(slots, t,
                                                                  out);
  return static_cast<int>(cudaGetLastError());
}

// p, g, nu: the leaf's type (p_bf16); mu: bf16 when mu_bf16, else float32.
// norm: the device float the finish kernel wrote (out[0]), or null for
// no clipping stage. vec: every
// pointer 16-byte aligned. s: the 11 floats of Scalars, in order.
extern "C" int kdl_adamw_update(void* p, const void* g, void* mu, void* nu,
                                const float* norm, int n, int p_bf16,
                                int mu_bf16, int vec, const float* s,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Scalars c{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n, 132 * 8);
  const bool v = vec != 0;
  if (p_bf16 && !mu_bf16)
    adamw_update_kernel<true, false><<<blocks, kThreads, 0, st>>>(p, g, mu, nu, norm, n, v, c);
  else if (p_bf16 && mu_bf16)
    adamw_update_kernel<true, true><<<blocks, kThreads, 0, st>>>(p, g, mu, nu, norm, n, v, c);
  else if (!p_bf16 && !mu_bf16)
    adamw_update_kernel<false, false><<<blocks, kThreads, 0, st>>>(p, g, mu, nu, norm, n, v, c);
  else
    adamw_update_kernel<false, true><<<blocks, kThreads, 0, st>>>(p, g, mu, nu, norm, n, v, c);
  return static_cast<int>(cudaGetLastError());
}
