// Flash attention forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces the four TPU Pallas kernels of kubedl_tpu/ops/flash_attention.py:
//
//   flash_fwd        <- _fwd_kernel       (:120, pallas_call in _fwd :287)
//   flash_bwd_fused  <- _bwd_fused_kernel (:480, pallas_call in _bwd_pallas :729)
//   flash_bwd_dq     <- _bwd_dq_kernel    (:314, pallas_call in _bwd_pallas :776)
//   flash_bwd_dkdv   <- _bwd_dkdv_kernel  (:393, pallas_call in _bwd_pallas :810)
//
// Layouts (all contiguous): q/out/dout/dq [B, Sq, H, hd]; k/v/dk/dv
// [B, Sk, KV, hd]; the split pair's per-q-head dk_h/dv_h [B, Sk, H, hd];
// lse [B, H, Sq] float32 (the Python side keeps it as [B, H, Sq, 1]);
// rope tables cos/sin [>= max(Sq, Sk), hd/2] float32. q-head h reads
// kv-head h / (H / KV) (GQA).
//
// Numerics (the reference's contract, kept by every kernel):
// - scores are s = (q . k) * (1/sqrt(hd)) * log2(e) in float32 and the
//   softmax runs in base 2; masked scores are -1e30 and contribute exact
//   zeros. Causal: query row i sees keys j <= i.
// - forward: out = acc / max(l, 1e-30) in q's type, and the BASE-2
//   lse = m + log2(max(l, 1e-30)), float32. P is rounded to v's type
//   before P.V; l sums the unrounded P.
// - backward: P = exp2(s - lse) from the saved lse; D = rowsum(dO * O) in
//   float32; dP = dO . V^T in float32; dS = P (dP - D) is rounded to q's
//   type before the dq/dk products, and P to dO's type before dv.
// - fused RoPE: pre-rope q/k are rotated in float32 by the split-halves
//   convention and rounded back to the input type before any product,
//   exactly as the plain version does; the backward emits gradients with
//   respect to the PRE-rope q/k by the inverse (transpose) rotation,
//   applied in float32 before the final cast.
//
// Bound: the flops, 4*hd per visible (query, key) pair and head forward
// (QK^T and PV) and 10*hd backward (QK^T, dO.V^T, dV, dK, dQ), against
// bytes that are each input read once and each output written once. At
// the training shape (S = 2048, hd = 64..256) that is far above the
// card's ridge point: the kernels are bound by operations, and the
// published 989 TFLOP/s is a tensor-core rate.
//
// Design, and what it does about that bound:
// - The TPU grid walked (q block, k block) tiles in order and carried
//   the softmax state, and the fused backward's whole-sequence dk/dv, in
//   VMEM scratch from one grid step to the next. Hopper blocks run in no
//   order, so the loop that the TPU ran over its grid runs INSIDE each
//   CTA: the forward and the dq kernel own a q tile and loop over k
//   tiles; the fused backward and the dk/dv kernel own a k tile and loop
//   over q tiles (and, fused, over the GQA group's q-heads), so dk/dv
//   never leave registers until the end. The fused kernel's dq, which
//   would need the TPU's whole-sequence scratch, is summed across CTAs
//   with float32 atomics into a workspace, then cast (and inverse
//   rotated) by a small finishing kernel: one QK^T recompute and one dP
//   product per tile, the property the TPU's fused kernel was built for.
// - Causal tiles above the diagonal are never visited; masking is paid
//   only on tiles that straddle the diagonal or the ragged end of the
//   sequence (any length, masked per element).
// - RoPE is applied while a tile is staged: each CTA rotates the q/k
//   rows it loads (the TPU kernel kept a whole-sequence rotated copy;
//   the values are identical, the rotation is elementwise).
// - Simple first: tiles are staged in shared memory as float32 and the
//   products are float32 FMAs on the CUDA cores (a 16 x 16 thread grid,
//   each thread a register micro-tile), so bf16 runs at the FP32 rate,
//   far below the tensor-core bound. mma/wgmma tiles, TMA staging and
//   warp specialisation are the next steps.
//
// C interface (bound with ctypes): each entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;  // a 16 x 16 grid: tx = tid % 16, ty = tid / 16

template <int HD>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int BQ = 64, BK = 64;
};
template <>
struct Tile<128> {
  static constexpr int BQ = 64, BK = 64;
};
template <>
struct Tile<256> {
  static constexpr int BQ = 32, BK = 32;
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  const float* cos;
  const float* sin;
  void* o;          // forward: out
  float* lse_out;   // forward: lse
  float* dq_ws;     // fused backward: float32 dq sums [B, Sq, H, hd]
  void* dq;
  void* dk;         // fused: [B, Sk, KV, hd]; split: dk_h [B, Sk, H, hd]
  void* dv;
  int B, Sq, Sk, H, KV, group, causal, rope;
  float scale;      // 1 / sqrt(hd)
};

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sum32(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  return qi < p.Sq && kj < p.Sk && (!p.causal || kj <= qi);
}

// The split-halves rotation of one (x1, x2) pair, without FMA contraction
// (the plain version multiplies and adds as separate float32 operations).
__device__ __forceinline__ void rotate(float x1, float x2, float c, float s,
                                       bool inverse, float& o1, float& o2) {
  if (inverse) s = -s;
  o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  o2 = __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
}

// Stage rows [row0, row0 + R) of head `head` of a [B, S, NH, HD] tensor
// into shared memory as float32 (row stride HD + 1: no bank conflicts in
// the products), zero past S. With `rope`, each row is rotated by its
// position's angle and rounded back to T.
template <typename T, int HD, int R>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int b,
                                           int head, int row0, int S, int NH,
                                           const Params& p, bool rope) {
  constexpr int LD = HD + 1;
  if (!rope) {
    for (int i = threadIdx.x; i < R * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD, s = row0 + r;
      dst[r * LD + d] =
          s < S ? to_f<T>(src[((size_t)(b * S + s) * NH + head) * HD + d])
                : 0.f;
    }
    return;
  }
  constexpr int H2 = HD / 2;
  for (int i = threadIdx.x; i < R * H2; i += kThreads) {
    const int r = i / H2, d = i - r * H2, s = row0 + r;
    float o1 = 0.f, o2 = 0.f;
    if (s < S) {
      const T* x = src + ((size_t)(b * S + s) * NH + head) * HD;
      rotate(to_f<T>(x[d]), to_f<T>(x[d + H2]), p.cos[(size_t)s * H2 + d],
             p.sin[(size_t)s * H2 + d], false, o1, o2);
      o1 = round_to<T>(o1);
      o2 = round_to<T>(o2);
    }
    dst[r * LD + d] = o1;
    dst[r * LD + d + H2] = o2;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * Bm[tx + 16 j][d] over staged tiles.
template <int HD, int RI, int CJ>
__device__ __forceinline__ void dot_rows(float (&acc)[RI][CJ], const float* A,
                                         const float* Bm) {
  constexpr int LD = HD + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[RI], bb[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < CJ; ++j) bb[j] = Bm[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// ---- forward ---------------------------------------------------------------

template <int HD>
constexpr size_t fwd_smem_bytes() {
  constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK, LD = HD + 1;
  return (size_t)(BQ * LD + 2 * BK * LD + BQ * (BK + 1)) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK, LD = HD + 1;
  constexpr int RI = BQ / 16, CJ = BK / 16, DJ = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;  // [BQ][BK + 1]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_q = (p.Sq + BQ - 1) / BQ;
  // causal: the longest rows first, so the last wave is the short tiles
  const int qt = p.causal ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int kvh = h / p.group;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const float scale2 = p.scale * kLog2e;

  stage_rows<T, HD, BQ>(sQ, q, b, h, q0, p.Sq, p.H, p, p.rope);
  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(q_last + 1, p.Sk) : p.Sk;
  const int n_k = (k_end + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sK/sV reads are done
    stage_rows<T, HD, BK>(sK, k, b, kvh, k0, p.Sk, p.KV, p, p.rope);
    stage_rows<T, HD, BK>(sV, v, b, kvh, k0, p.Sk, p.KV, p, false);
    __syncthreads();
    float s[RI][CJ];
    dot_rows<HD, RI, CJ>(s, sQ, sK);
    const bool need_mask = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        float x = s[i][j] * scale2;
        if (need_mask && !visible(p, q0 + r, k0 + tx + 16 * j)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float pj = s[i][j] <= kNegInf ? 0.f : exp2f(s[i][j] - m_new);
        rs += pj;
        sP[r * (BK + 1) + tx + 16 * j] = round_to<T>(pj);
      }
      const float corr = exp2f(m[i] - m_new);
      l[i] = l[i] * corr + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // row r of sP was written by this warp's half
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pc[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pc[i] = sP[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = sV[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pc[i], vv, acc[i][j]);
      }
    }
  }
  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)(b * p.Sq + qi) * p.H + h) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / lc);
    if (tx == 0) p.lse_out[(size_t)bh * p.Sq + qi] = m[i] + log2f(lc);
  }
}

// ---- backward --------------------------------------------------------------

template <int HD>
constexpr size_t bwd_smem_bytes() {
  constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK, LD = HD + 1;
  return (size_t)(2 * BQ * LD + 2 * BK * LD + 2 * BQ * (BK + 1) + 2 * BQ) *
         sizeof(float);
}

// Shared-memory carve-up of the three backward kernels.
template <int HD>
struct BwdSmem {
  static constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK, LD = HD + 1;
  float *sQ, *sdO, *sK, *sV, *sP, *sDS, *sL, *sD;
  __device__ explicit BwdSmem(float* base) {
    sQ = base;
    sdO = sQ + BQ * LD;
    sK = sdO + BQ * LD;
    sV = sK + BK * LD;
    sP = sV + BK * LD;
    sDS = sP + BQ * (BK + 1);
    sL = sDS + BQ * (BK + 1);
    sD = sL + BQ;
  }
};

// Stage the q tile's lse and D = rowsum(dO * O) (sdO must be staged).
template <typename T, int HD>
__device__ __forceinline__ void stage_row_stats(const Params& p, int b, int h,
                                                int q0,
                                                const BwdSmem<HD>& sm) {
  constexpr int BQ = Tile<HD>::BQ, LD = HD + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* o = static_cast<const T*>(p.out);
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < p.Sq) {
      const T* orow = o + ((size_t)(b * p.Sq + qi) * p.H + h) * HD;
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(sm.sdO[r * LD + d], to_f<T>(orow[d]), acc);
    }
    acc = sum32(acc);
    if (lane == 0) {
      sm.sD[r] = acc;
      sm.sL[r] = qi < p.Sq ? p.lse[((size_t)b * p.H + h) * p.Sq + qi] : 0.f;
    }
  }
}

// One (q tile, k tile) step shared by the three backward kernels:
// P = exp2(s - lse), dS = P (dP - D); P rounded to dO's type into sP and
// dS rounded to q's type into sDS. Row r = ty + 16 i of both is written
// by one half-warp.
template <typename T, int HD>
__device__ __forceinline__ void bwd_tile_scores(const Params& p, int q0,
                                                int k0,
                                                const BwdSmem<HD>& sm) {
  constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK;
  constexpr int RI = BQ / 16, CJ = BK / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float scale2 = p.scale * kLog2e;
  float s[RI][CJ], dp[RI][CJ];
  dot_rows<HD, RI, CJ>(s, sm.sQ, sm.sK);
  dot_rows<HD, RI, CJ>(dp, sm.sdO, sm.sV);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      const float pj =
          visible(p, q0 + r, k0 + c) ? exp2f(s[i][j] * scale2 - sm.sL[r]) : 0.f;
      sm.sP[r * (BK + 1) + c] = round_to<T>(pj);
      sm.sDS[r * (BK + 1) + c] = round_to<T>(pj * (dp[i][j] - sm.sD[r]));
    }
  }
}

// dk/dv for one k tile: kFused walks the whole GQA group (dk/dv per
// kv-head, dq by atomics into p.dq_ws); otherwise one q-head (dk_h/dv_h).
template <typename T, int HD, bool kFused>
__global__ void __launch_bounds__(kThreads) flash_bwd_kv_kernel(Params p) {
  constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK, LD = HD + 1;
  constexpr int RI = BQ / 16, RK = BK / 16, DJ = HD / 16, H2J = DJ / 2;
  extern __shared__ float smem[];
  const BwdSmem<HD> sm(smem);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  int b, kvh, h_first, n_heads;
  if (kFused) {
    b = bh / p.KV;
    kvh = bh - b * p.KV;
    h_first = kvh * p.group;
    n_heads = p.group;
  } else {
    b = bh / p.H;
    h_first = bh - b * p.H;
    kvh = h_first / p.group;
    n_heads = 1;
  }
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);

  stage_rows<T, HD, BK>(sm.sK, k, b, kvh, k0, p.Sk, p.KV, p, p.rope);
  stage_rows<T, HD, BK>(sm.sV, v, b, kvh, k0, p.Sk, p.KV, p, false);
  float dk[RK][DJ], dv[RK][DJ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int n_q = (p.Sq + BQ - 1) / BQ;
  const int qt0 = p.causal ? min(k0 / BQ, n_q) : 0;  // first tile with a row >= k0
  for (int hh = 0; hh < n_heads; ++hh) {
    const int h = h_first + hh;
    for (int qt = qt0; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile is fully consumed
      stage_rows<T, HD, BQ>(sm.sQ, q, b, h, q0, p.Sq, p.H, p, p.rope);
      stage_rows<T, HD, BQ>(sm.sdO, dout, b, h, q0, p.Sq, p.H, p, false);
      __syncthreads();
      stage_row_stats<T, HD>(p, b, h, q0, sm);
      __syncthreads();
      bwd_tile_scores<T, HD>(p, q0, k0, sm);
      __syncthreads();
      // dv += P^T dO, dk += dS^T Q over the tile's rows
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pr[RK], dsr[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pr[i] = sm.sP[r * (BK + 1) + ty + 16 * i];
          dsr[i] = sm.sDS[r * (BK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float g = sm.sdO[r * LD + tx + 16 * j];
          const float x = sm.sQ[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            dv[i][j] = fmaf(pr[i], g, dv[i][j]);
            dk[i][j] = fmaf(dsr[i], x, dk[i][j]);
          }
        }
      }
      if (kFused) {
        // this tile's share of dq: scale * dS K, summed across CTAs
#pragma unroll 1
        for (int j = 0; j < DJ; ++j) {
          float a[RI];
#pragma unroll
          for (int i = 0; i < RI; ++i) a[i] = 0.f;
#pragma unroll 4
          for (int c = 0; c < BK; ++c) {
            const float kk = sm.sK[c * LD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < RI; ++i)
              a[i] = fmaf(sm.sDS[(ty + 16 * i) * (BK + 1) + c], kk, a[i]);
          }
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const int qi = q0 + ty + 16 * i;
            if (qi < p.Sq)
              atomicAdd(p.dq_ws + ((size_t)(b * p.Sq + qi) * p.H + h) * HD +
                            tx + 16 * j,
                        a[i] * p.scale);
          }
        }
      }
    }
  }
  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
  const int heads_out = kFused ? p.KV : p.H;
  const int head_out = kFused ? kvh : h_first;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= p.Sk) continue;
    float x[DJ];
#pragma unroll
    for (int j = 0; j < DJ; ++j) x[j] = dk[i][j] * p.scale;
    if (p.rope) {
      // the pair (d, d + hd/2) sits in this thread: j and j + DJ/2
#pragma unroll
      for (int j = 0; j < H2J; ++j) {
        const int d = tx + 16 * j;
        rotate(x[j], x[j + H2J], p.cos[(size_t)kj * (HD / 2) + d],
               p.sin[(size_t)kj * (HD / 2) + d], true, x[j], x[j + H2J]);
      }
    }
    const size_t base = ((size_t)(b * p.Sk + kj) * heads_out + head_out) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk_out[base + tx + 16 * j] = from_f<T>(x[j]);
      dv_out[base + tx + 16 * j] = from_f<T>(dv[i][j]);
    }
  }
}

// Split dq: one q tile of one q-head, looping over its k tiles; dq stays
// in registers (no atomics: deterministic).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK, LD = HD + 1;
  constexpr int RI = BQ / 16, DJ = HD / 16, H2J = DJ / 2;
  extern __shared__ float smem[];
  const BwdSmem<HD> sm(smem);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_q = (p.Sq + BQ - 1) / BQ;
  const int qt = p.causal ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int kvh = h / p.group;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);

  stage_rows<T, HD, BQ>(sm.sQ, q, b, h, q0, p.Sq, p.H, p, p.rope);
  stage_rows<T, HD, BQ>(sm.sdO, dout, b, h, q0, p.Sq, p.H, p, false);
  __syncthreads();
  stage_row_stats<T, HD>(p, b, h, q0, sm);
  float dq[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(q_last + 1, p.Sk) : p.Sk;
  const int n_k = (k_end + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // row stats staged / previous sK, sV reads done
    stage_rows<T, HD, BK>(sm.sK, k, b, kvh, k0, p.Sk, p.KV, p, p.rope);
    stage_rows<T, HD, BK>(sm.sV, v, b, kvh, k0, p.Sk, p.KV, p, false);
    __syncthreads();
    bwd_tile_scores<T, HD>(p, q0, k0, sm);
    __syncwarp();  // row r of sDS was written by this warp's half
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) ds[i] = sm.sDS[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = sm.sK[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) dq[i][j] = fmaf(ds[i], kk, dq[i][j]);
      }
    }
  }
  T* dq_out = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Sq) continue;
    float x[DJ];
#pragma unroll
    for (int j = 0; j < DJ; ++j) x[j] = dq[i][j] * p.scale;
    if (p.rope) {
#pragma unroll
      for (int j = 0; j < H2J; ++j) {
        const int d = tx + 16 * j;
        rotate(x[j], x[j + H2J], p.cos[(size_t)qi * (HD / 2) + d],
               p.sin[(size_t)qi * (HD / 2) + d], true, x[j], x[j + H2J]);
      }
    }
    T* row = dq_out + ((size_t)(b * p.Sq + qi) * p.H + h) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_f<T>(x[j]);
  }
}

// The fused backward's epilogue for dq: inverse rotation (with rope) of
// the float32 sums, then the cast.
template <typename T, int HD>
__global__ void flash_dq_finish_kernel(Params p) {
  constexpr int H2 = HD / 2;
  const size_t rows = (size_t)p.B * p.Sq * p.H;
  T* dq = static_cast<T*>(p.dq);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       i < rows * H2; i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / H2;
    const int d = (int)(i - row * H2);
    const int s = (int)((row / p.H) % p.Sq);
    float x1 = p.dq_ws[row * HD + d], x2 = p.dq_ws[row * HD + d + H2];
    if (p.rope)
      rotate(x1, x2, p.cos[(size_t)s * H2 + d], p.sin[(size_t)s * H2 + d],
             true, x1, x2);
    dq[row * HD + d] = from_f<T>(x1);
    dq[row * HD + d + H2] = from_f<T>(x2);
  }
}

// ---- launchers -------------------------------------------------------------

template <typename K>
cudaError_t launch_smem(K kernel, dim3 grid, size_t smem, cudaStream_t st,
                        const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_fwd(const Params& p, cudaStream_t st) {
  const dim3 grid((p.Sq + Tile<HD>::BQ - 1) / Tile<HD>::BQ, p.B * p.H);
  return launch_smem(flash_fwd_kernel<T, HD>, grid, fwd_smem_bytes<HD>(), st,
                     p);
}

template <typename T, int HD>
cudaError_t launch_bwd_fused(const Params& p, cudaStream_t st) {
  const dim3 grid((p.Sk + Tile<HD>::BK - 1) / Tile<HD>::BK, p.B * p.KV);
  cudaError_t err = launch_smem(flash_bwd_kv_kernel<T, HD, true>, grid,
                                bwd_smem_bytes<HD>(), st, p);
  if (err != cudaSuccess) return err;
  const size_t pairs = (size_t)p.B * p.Sq * p.H * (HD / 2);
  const int blocks = (int)((pairs + 255) / 256 < 8192 ? (pairs + 255) / 256 : 8192);
  flash_dq_finish_kernel<T, HD><<<blocks, 256, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_bwd_dq(const Params& p, cudaStream_t st) {
  const dim3 grid((p.Sq + Tile<HD>::BQ - 1) / Tile<HD>::BQ, p.B * p.H);
  return launch_smem(flash_bwd_dq_kernel<T, HD>, grid, bwd_smem_bytes<HD>(),
                     st, p);
}

template <typename T, int HD>
cudaError_t launch_bwd_dkdv(const Params& p, cudaStream_t st) {
  const dim3 grid((p.Sk + Tile<HD>::BK - 1) / Tile<HD>::BK, p.B * p.H);
  return launch_smem(flash_bwd_kv_kernel<T, HD, false>, grid,
                     bwd_smem_bytes<HD>(), st, p);
}

enum Which { kFwd, kBwdFused, kBwdDq, kBwdDkdv };

template <typename T, int HD>
cudaError_t launch(Which w, const Params& p, cudaStream_t st) {
  switch (w) {
    case kFwd:
      return launch_fwd<T, HD>(p, st);
    case kBwdFused:
      return launch_bwd_fused<T, HD>(p, st);
    case kBwdDq:
      return launch_bwd_dq<T, HD>(p, st);
    case kBwdDkdv:
      return launch_bwd_dkdv<T, HD>(p, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int dispatch_hd(Which w, const Params& p, int hd, cudaStream_t st) {
  switch (hd) {
    case 64:
      return (int)launch<T, 64>(w, p, st);
    case 128:
      return (int)launch<T, 128>(w, p, st);
    case 256:
      return (int)launch<T, 256>(w, p, st);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(Which w, const Params& p, int hd, int dtype, void* stream) {
  if (p.B <= 0 || p.Sq <= 0 || p.Sk <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(w, p, hd, st);
  return dispatch_hd<float>(w, p, hd, st);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* cos, const void* sin, int B, int Sq, int Sk,
                   int H, int KV, int hd, int causal, int rope) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.group = KV > 0 ? H / KV : 1;
  p.causal = causal;
  p.rope = rope;
  p.scale = 1.0f / sqrtf((float)hd);
  return p;
}

}  // namespace

extern "C" int kdl_flash_fwd(const void* q, const void* k, const void* v,
                             const void* cos, const void* sin, void* out,
                             void* lse, int B, int Sq, int Sk, int H, int KV,
                             int hd, int causal, int rope, int dtype,
                             void* stream) {
  Params p = make_params(q, k, v, cos, sin, B, Sq, Sk, H, KV, hd, causal, rope);
  p.o = out;
  p.lse_out = static_cast<float*>(lse);
  return dispatch(kFwd, p, hd, dtype, stream);
}

extern "C" int kdl_flash_bwd_fused(
    const void* q, const void* k, const void* v, const void* cos,
    const void* sin, const void* out, const void* lse, const void* dout,
    void* dq_ws, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
    int KV, int hd, int causal, int rope, int dtype, void* stream) {
  Params p = make_params(q, k, v, cos, sin, B, Sq, Sk, H, KV, hd, causal, rope);
  p.out = out;
  p.lse = static_cast<const float*>(lse);
  p.dout = dout;
  p.dq_ws = static_cast<float*>(dq_ws);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  return dispatch(kBwdFused, p, hd, dtype, stream);
}

extern "C" int kdl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* cos, const void* sin,
                                const void* out, const void* lse,
                                const void* dout, void* dq, int B, int Sq,
                                int Sk, int H, int KV, int hd, int causal,
                                int rope, int dtype, void* stream) {
  Params p = make_params(q, k, v, cos, sin, B, Sq, Sk, H, KV, hd, causal, rope);
  p.out = out;
  p.lse = static_cast<const float*>(lse);
  p.dout = dout;
  p.dq = dq;
  return dispatch(kBwdDq, p, hd, dtype, stream);
}

extern "C" int kdl_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* cos, const void* sin,
                                  const void* out, const void* lse,
                                  const void* dout, void* dk_h, void* dv_h,
                                  int B, int Sq, int Sk, int H, int KV, int hd,
                                  int causal, int rope, int dtype,
                                  void* stream) {
  Params p = make_params(q, k, v, cos, sin, B, Sq, Sk, H, KV, hd, causal, rope);
  p.out = out;
  p.lse = static_cast<const float*>(lse);
  p.dout = dout;
  p.dk = dk_h;
  p.dv = dv_h;
  return dispatch(kBwdDkdv, p, hd, dtype, stream);
}
