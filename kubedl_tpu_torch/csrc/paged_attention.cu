// Paged attention over a KV block pool, for NVIDIA Hopper (sm_90a).
//
// Replaces the two TPU Pallas kernels of kubedl_tpu/models/paged_attention.py:
//
//   paged_attention_blocked  <- _blocked_kernel (:181, _pallas_paged_attention)
//       S queries per row against the pool through the block table; every
//       chunked-prefill chunk runs it.
//   paged_attention_fused    <- _fused_kernel (:290, _pallas_paged_attention_fused)
//       the decode step (S=1) with this step's K/V write fused in; every
//       decode step with kv_attention="blocked" runs it.
//
// Layouts (all contiguous): q/out [B, S, H, hd]; pools [NB, BS, KV, hd]
// (one layer); bt [B, MB] int32; starts [B] int32; new_k/new_v [B, KV, hd].
// Query row r = s*group + u of CTA (b, g, z) is head g*group + u at
// sequence index s (GQA folded into rows, as the TPU kernel folds it).
//
// Numerics (the reference's contract): query s sees keys at logical
// positions t <= min(starts[b] + s, MB*BS - 1); scores are scaled by
// (1/sqrt(hd))*log2(e) and folded in base 2; masked scores are -1e30 and
// the running max is clamped at -1e29, so a fully masked key tile adds
// exact zeros; sums are float32; out = acc / max(l, 1e-30) in q's dtype.
//
// Bound: both kernels read each attended K/V position once per (row,
// kv-head) from device memory: bytes = sum_b n_keys(b) * KV * hd * 2 *
// sizeof(T), at 3.35 TB/s on an H100 SXM. The flops (4 * rows * keys * hd)
// sit far below the card's ridge point at decode and at these chunk
// sizes, so the kernels are memory-bound.
//
// Design, and what it does about that bound:
// - The TPU grid walked blocks sequentially with the block table in
//   scalar-prefetch memory. Here one CTA owns (row b, kv-head g, a tile of
//   up to 64 query rows); it loads bt[b, :] and starts[b] from global
//   memory itself and loops over the row's keys INSIDE the CTA, so no
//   partial sums ever cross CTAs.
// - It stops at the CTA's last needed key, min(starts + s_max, max_s-1):
//   the row's first block holds position 0, which every query sees, so a
//   fully masked block beyond it would change nothing (exact, not a
//   tolerance). Bytes read therefore track the tokens actually cached.
// - Keys are staged 32 at a time into shared memory as float32 with
//   16-byte vector loads (8 bf16 per thread), each staged tile is shared
//   by all query rows of the CTA (the GQA group and the S queries), so the
//   pool is read once per (row, kv-head) CTA, not once per query head.
// - A half-warp (16 lanes) owns one query row at a time: for scores each
//   lane takes 2 of the 32 staged keys and runs a full dot product against
//   the row's query in shared memory (rows padded by 4 floats: no bank
//   conflicts); for P.V each lane owns hd/16 output dims held in
//   registers. Only max/sum reductions cross lanes (4 shuffles each).
// - Simple first: no tensor cores, no TMA, no split-K over keys. Decode
//   at small batch gets B*KV CTAs only; a split-K pass is the next step.
//
// Fused write: CTA (b, g) writes new_k[b, g, :] / new_v[b, g, :] into
// pool[bt[b, starts/BS], starts%BS, g, :] as a plain copy (bit-identical
// to a scatter for a row that owns its block), and when it stages
// position starts[b] it takes new_k/new_v from the inputs, never from its
// own global write (which lands after its last read). Vacant rows all
// point at trash block 0, where colliding garbage writes are allowed.
//
// C interface (bound with ctypes): each entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMaxFloor = -1e29f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTK = 32;    // keys staged per iteration
constexpr int kHalf = 16;  // lanes per half-warp (one query row at a time)
constexpr int kRowsMax = 64;

template <typename T>
struct Args {
  const T* q;
  const T* k_pool;
  const T* v_pool;
  T* k_pool_w;
  T* v_pool_w;
  const int* bt;
  const int* starts;
  const T* new_k;
  const T* new_v;
  T* out;
  int S, H, KV, BS, MB, group, R, rows_per_cta;
  float scale_log2;
};

__device__ __forceinline__ void load_vec(const float* p, float* o) {
  float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void from_f(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* o) { *o = __float2bfloat16(x); }

// elements per 16-byte vector load
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

template <typename T, int HD, int RPH, bool FUSED>
__global__ void paged_attention_kernel(Args<T> a) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 4;           // padded row stride, floats
  constexpr int CPL = HD / (4 * kHalf);  // float4 output chunks per lane
  constexpr int VN = Vec<T>::n;
  constexpr int KPL = kTK / kHalf;     // keys per lane in the score pass

  const int b = blockIdx.x, g = blockIdx.y;
  const int r0 = blockIdx.z * a.rows_per_cta;
  const int nrows = min(a.rows_per_cta, a.R - r0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & (kHalf - 1);
  const int half = tid / kHalf;
  const int max_s = a.MB * a.BS;
  const int start = a.starts[b];
  const int* btrow = a.bt + (size_t)b * a.MB;

  float* qs = smem;                       // [rows_per_cta][LD]
  float* ks = qs + a.rows_per_cta * LD;   // [kTK][LD]
  float* vs = ks + kTK * LD;              // [kTK][LD]
  float* ps = vs + kTK * LD;              // [nhalves][kTK + 1]

  // this CTA's query rows, pre-scaled into the base-2 domain
  for (int i = tid; i < nrows * (HD / VN); i += nthr) {
    const int rr = i / (HD / VN), d = (i % (HD / VN)) * VN;
    const int r = r0 + rr, s = r / a.group, u = r % a.group;
    float f[VN];
    load_vec(a.q + (((size_t)b * a.S + s) * a.H + g * a.group + u) * HD + d, f);
#pragma unroll
    for (int e = 0; e < VN; ++e) qs[rr * LD + d + e] = f[e] * a.scale_log2;
  }

  float m[RPH], l[RPH], acc[RPH][CPL][4];
#pragma unroll
  for (int j = 0; j < RPH; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][c][e] = 0.f;
  }

  // last key any row of this CTA can see (early stop is exact, see top)
  const int s_hi = (r0 + nrows - 1) / a.group;
  const int n_keys = min(start + s_hi, max_s - 1) + 1;

  for (int t0 = 0; t0 < n_keys; t0 += kTK) {
    __syncthreads();  // previous tile fully consumed (and q staged)
    for (int i = tid; i < kTK * (HD / VN); i += nthr) {
      const int kj = i / (HD / VN), d = (i % (HD / VN)) * VN;
      const int t = t0 + kj;
      float kf[VN], vf[VN];
      if (t < n_keys) {
        const T* kp;
        const T* vp;
        if (FUSED && t == start) {
          const size_t o = ((size_t)b * a.KV + g) * HD + d;
          kp = a.new_k + o;
          vp = a.new_v + o;
        } else {
          const int blk = btrow[t / a.BS];
          const size_t o =
              (((size_t)blk * a.BS + (t % a.BS)) * a.KV + g) * HD + d;
          kp = a.k_pool + o;
          vp = a.v_pool + o;
        }
        load_vec(kp, kf);
        load_vec(vp, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) { kf[e] = 0.f; vf[e] = 0.f; }
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        ks[kj * LD + d + e] = kf[e];
        vs[kj * LD + d + e] = vf[e];
      }
    }
    __syncthreads();

    // every half runs all RPH iterations (warp-uniform shuffles); rows
    // past nrows compute on a clamped row and never store
#pragma unroll
    for (int j = 0; j < RPH; ++j) {
      const int rr = min(half * RPH + j, nrows - 1);
      const int qpos = min(start + (r0 + rr) / a.group, max_s - 1);
      const float* qrow = qs + rr * LD;
      float sc[KPL];
      float mloc = kNegInf;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const int kj = lane + c * kHalf;
        const float* krow = ks + kj * LD;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; d += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
          const float4 kv = *reinterpret_cast<const float4*>(krow + d);
          dot = fmaf(qv.x, kv.x, dot);
          dot = fmaf(qv.y, kv.y, dot);
          dot = fmaf(qv.z, kv.z, dot);
          dot = fmaf(qv.w, kv.w, dot);
        }
        sc[c] = (t0 + kj <= qpos) ? dot : kNegInf;
        mloc = fmaxf(mloc, sc[c]);
      }
#pragma unroll
      for (int o = kHalf / 2; o > 0; o >>= 1)
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));
      const float m_new = fmaxf(fmaxf(m[j], mloc), kMaxFloor);
      const float corr = exp2f(m[j] - m_new);
      float psum = 0.f;
      float* prow = ps + half * (kTK + 1);
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const float p = exp2f(sc[c] - m_new);
        prow[lane + c * kHalf] = p;
        psum += p;
      }
#pragma unroll
      for (int o = kHalf / 2; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[j] = l[j] * corr + psum;
      m[j] = m_new;
      __syncwarp();
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][c][e] *= corr;
      for (int kj = 0; kj < kTK; ++kj) {
        const float p = prow[kj];
        const float* vrow = vs + kj * LD + lane * 4;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + c * 4 * kHalf);
          acc[j][c][0] = fmaf(p, vv.x, acc[j][c][0]);
          acc[j][c][1] = fmaf(p, vv.y, acc[j][c][1]);
          acc[j][c][2] = fmaf(p, vv.z, acc[j][c][2]);
          acc[j][c][3] = fmaf(p, vv.w, acc[j][c][3]);
        }
      }
      __syncwarp();  // prow is rewritten by the next row
    }
  }

#pragma unroll
  for (int j = 0; j < RPH; ++j) {
    const int rr = half * RPH + j;
    if (rr >= nrows) continue;
    const int r = r0 + rr, s = r / a.group, u = r % a.group;
    const float lj = fmaxf(l[j], 1e-30f);
    T* o = a.out + (((size_t)b * a.S + s) * a.H + g * a.group + u) * HD;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        from_f(acc[j][c][e] / lj, o + c * 4 * kHalf + lane * 4 + e);
  }

  if (FUSED && blockIdx.z == 0) {
    // the write lands after this CTA's last read of the pool
    const int jw = start / a.BS;
    if (jw < a.MB) {
      const int blk = btrow[jw];
      const size_t dst = (((size_t)blk * a.BS + (start % a.BS)) * a.KV + g) * HD;
      const size_t src = ((size_t)b * a.KV + g) * HD;
      for (int d = tid; d < HD; d += nthr) {
        a.k_pool_w[dst + d] = a.new_k[src + d];
        a.v_pool_w[dst + d] = a.new_v[src + d];
      }
    }
  }
}

template <typename T, int HD, int RPH, bool FUSED>
cudaError_t launch_one(const Args<T>& a, int B, int threads, cudaStream_t st) {
  constexpr int LD = HD + 4;
  const int nhalves = threads / kHalf;
  const size_t smem =
      sizeof(float) * ((size_t)a.rows_per_cta * LD + 2 * kTK * LD +
                       (size_t)nhalves * (kTK + 1));
  auto kern = paged_attention_kernel<T, HD, RPH, FUSED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int zt = (a.R + a.rows_per_cta - 1) / a.rows_per_cta;
  dim3 grid(B, a.KV, zt);
  kern<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool FUSED>
int launch(Args<T> a, int B, int hd, cudaStream_t st) {
  // small R (decode): one row per half-warp; large R: 4 rows per half,
  // 64 rows per 256-thread CTA
  int rph, threads;
  if (a.R <= kHalf) {
    rph = 1;
    a.rows_per_cta = a.R;
    threads = ((a.R * kHalf + 31) / 32) * 32;
  } else {
    rph = 4;
    a.rows_per_cta = kRowsMax;
    threads = (kRowsMax / rph) * kHalf;
  }
  a.scale_log2 = kLog2e / sqrtf((float)hd);
  cudaError_t err = cudaErrorInvalidValue;
#define KDL_CASE(HD)                                                      \
  case HD:                                                                \
    err = rph == 1 ? launch_one<T, HD, 1, FUSED>(a, B, threads, st)       \
                   : launch_one<T, HD, 4, FUSED>(a, B, threads, st);      \
    break;
  switch (hd) {
    KDL_CASE(64)
    KDL_CASE(128)
    KDL_CASE(256)
    default:
      break;
  }
#undef KDL_CASE
  return (int)err;
}

template <typename T>
Args<T> make_args(const void* q, const void* k_pool, const void* v_pool,
                  const void* bt, const void* starts, const void* new_k,
                  const void* new_v, void* out, int S, int H, int KV, int BS,
                  int MB) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k_pool = static_cast<const T*>(k_pool);
  a.v_pool = static_cast<const T*>(v_pool);
  a.k_pool_w = const_cast<T*>(a.k_pool);
  a.v_pool_w = const_cast<T*>(a.v_pool);
  a.bt = static_cast<const int*>(bt);
  a.starts = static_cast<const int*>(starts);
  a.new_k = static_cast<const T*>(new_k);
  a.new_v = static_cast<const T*>(new_v);
  a.out = static_cast<T*>(out);
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.BS = BS;
  a.MB = MB;
  a.group = H / KV;
  a.R = S * a.group;
  a.rows_per_cta = 0;
  a.scale_log2 = 0.f;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int kdl_paged_attention_blocked(
    const void* q, const void* k_pool, const void* v_pool, const void* bt,
    const void* starts, void* out, int B, int S, int H, int KV, int hd,
    int NB, int BS, int MB, int dtype, void* stream) {
  (void)NB;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return 0;
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(
        make_args<__nv_bfloat16>(q, k_pool, v_pool, bt, starts, nullptr,
                                 nullptr, out, S, H, KV, BS, MB),
        B, hd, st);
  return launch<float, false>(
      make_args<float>(q, k_pool, v_pool, bt, starts, nullptr, nullptr, out,
                       S, H, KV, BS, MB),
      B, hd, st);
}

extern "C" int kdl_paged_attention_fused(
    const void* q, void* k_pool, void* v_pool, const void* bt,
    const void* starts, const void* new_k, const void* new_v, void* out,
    int B, int H, int KV, int hd, int NB, int BS, int MB, int dtype,
    void* stream) {
  (void)NB;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(
        make_args<__nv_bfloat16>(q, k_pool, v_pool, bt, starts, new_k, new_v,
                                 out, 1, H, KV, BS, MB),
        B, hd, st);
  return launch<float, true>(
      make_args<float>(q, k_pool, v_pool, bt, starts, new_k, new_v, out, 1,
                       H, KV, BS, MB),
      B, hd, st);
}
