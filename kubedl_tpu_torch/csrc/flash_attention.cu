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
// (QK^T and PV), 10*hd fused backward (QK^T, dO.V^T, dV, dK, dQ), 6*hd
// split dq (QK^T, dO.V^T, dQ) and 8*hd split dk/dv (QK^T, dO.V^T, dV,
// dK), against bytes that are each input read once and each output
// written once. At the training shapes (S = 2048..32768, hd = 64..256)
// that is far above the card's ridge point: the kernels are bound by
// operations, and the published 989 TFLOP/s bf16 is a tensor-core rate.
//
// Two designs, chosen statically per operator by type and head width
// (TcRoute below; ops/flash_attention.py's tensor_core_route is the same
// table, and kdl_flash_route reports it). There is no fallback between
// them: a refused launch returns its error.
//
// 1. Tensor cores (bf16 at hd 64, 128 and 256 for all four operators;
//    flash_fwd_tc_kernel, flash_bwd_tc_kernel<HD, kFused> for the fused
//    backward and the split dk/dv, flash_bwd_dq_tc_kernel for the split
//    dq, the fused route's dq finish, two pre-passes):
//    - Every product is a warpgroup wgmma.mma_async (sm_90a) on bf16
//      tiles in 128-byte-swizzled shared memory, accumulating in float32
//      registers. Forward: a CTA owns 192 q rows, three warpgroups of 64
//      and one producer warp; S = Q.K^T reads both from shared memory
//      (K-major); P is rounded to bf16 in registers, where the S
//      accumulator's fragment is already the A operand of O += P.V, and V
//      is read MN-major (transposed B). The online softmax runs on the
//      accumulator layout: the four lanes of a quad share a row, so row
//      max and sum are two xor shuffles; exp2 is the MUFU's ex2.approx.
//      At hd 256 the CTA has two warpgroups (128 q rows) and a producer
//      warpgroup that hands its registers to them (fwd_tc_wgs below).
//    - Fused backward: a CTA owns 128 keys of one kv-head (one warpgroup
//      per 64) and walks the GQA group's q-heads and causal q tiles of 64,
//      keeping dK/dV in float32 registers across the group (the
//      reference's contract). Per tile: S^T = K.Q^T and dP^T = V.dO^T
//      (shared memory), P^T and dS^T in registers, dV += P^T.dO and
//      dK += dS^T.Q (register A, MN-major B); dS^T goes to shared memory
//      and dQ = dS.K (both operands MN-major, each warpgroup half of hd)
//      is staged as a float32 tile and added to a [B, H, Sq_pad, hd]
//      workspace by ONE bulk reduce (cp.reduce.async.bulk .add.f32) per
//      tile; flash_dq_finish_kernel casts (and inverse-rotates) it. At hd
//      256 dK and dV do not fit one warpgroup's registers: a CTA owns 64
//      keys of one q-head, one warpgroup keeps dV and the other dK, and
//      the group sum of dK/dV crosses CTAs through a float32 workspace
//      (flash_bwd_tc_kernel<256, true> below says why and how).
//    - The split pair (the reference's route when the fused kernel's
//      whole-sequence scratch would not fit, i.e. long sequences: every
//      backward of a 32k-token training step). dk/dv: the fused kernel's
//      tile code with kFused = false: a CTA owns 128 keys against ONE
//      q-head's causal q tiles, four products a tile (no dS^T staging, no
//      dQ), and writes that head's dk_h / dv_h, rounded, for the group
//      sum outside (the reference's split contract). dq: a CTA owns
//      64 x TcDqWGs q rows of one q-head (a warpgroup per 64) and walks
//      the visible K/V tiles of its kv-head, streamed by a producer warp
//      through a two-stage ring against "empty" barriers, as the forward
//      does (at hd 256: 32-key tiles three deep, and a producer warpgroup
//      that hands its registers to the consumers, as the forward's); per
//      tile S = Q.K^T and dP = dO.V^T from shared memory, P and
//      dS in registers (the {lse, D} of each thread's two rows read once),
//      and dQ += dS.K with dS as the register A operand and K read
//      MN-major. dQ lives in float32 registers for the whole loop and is
//      written once, inverse-rotated in registers (a thread holds columns
//      c and c + hd/2 of its rows): no workspace, no cross-CTA sum, no
//      finishing kernel. Tiles above a warpgroup's diagonal are waited on
//      and released, not multiplied. At hd 256 the dk/dv kernel is the
//      fused hd-256 kernel's layout (64 keys of one q-head a CTA, WG0 dV,
//      WG1 dK) without its dQ work, writing dk_h / dv_h from registers
//      (flash_bwd_tc_kernel<256, false> below).
//    - Tiles arrive by TMA (cp.async.bulk.tensor, 4-D maps over
//      [B, S, heads, hd] with 128-byte swizzle = one 64-wide bf16 panel,
//      an mbarrier per stage), two stages: the next K/V (forward, issued
//      by the producer warp against "empty" barriers, so the warpgroups
//      never wait for each other) or Q/dO (backward, issued at the top of
//      each tile) loads while this one is multiplied. TMA's zero
//      fill past S makes any length safe; masking is per element only on
//      tiles that straddle the diagonal or the ragged end. The maps are
//      encoded on the host for each call and passed as __grid_constant__;
//      cuTensorMapEncodeTiled is fetched with cudaGetDriverEntryPoint, so
//      the library does not link libcuda.
//    - RoPE and D leave the inner loops: flash_rope_kernel writes rotated
//      q and k once per call (float32 rotation, rounded to bf16, as the
//      plain version does) into workspaces the wrapper allocates, and
//      flash_bwd_prep_kernel writes {lse, D = rowsum(dO * O)} per q row
//      into a padded float32 workspace (staged per tile by one bulk copy,
//      or read per row by the dq kernel) and zeroes the fused route's dq
//      workspace. Each of the split pair's two calls runs them for itself.
//    On the card both kernels still take several times their operations
//    bound (PERF.md). Builds with the products, the exponentials or the
//    loads taken out were not much faster than the whole, which points
//    at the serial S -> softmax -> P.V chain of each warpgroup.
//    Overlapping it (the next tile's Q.K^T under this tile's P.V) needs
//    two score tiles in registers; ptxas serialised the wgmmas when that
//    was tried, and it is left for a later change.
// 2. CUDA cores (float32 at every hd, where TF32 tensor cores would break
//    the float32 contract; and bf16 at hd 16 and 32, below the tensor-core
//    kernels' 64-wide panels, where a head's products are too short to pay
//    for them), whose design follows:
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
// - Tiles are staged in shared memory as float32 and the products are
//   float32 FMAs on the CUDA cores (a 16 x 16 thread grid, each thread a
//   register micro-tile): the float32 rate, exact float32 products.
//
// C interface (bound with ctypes): each entry point launches on the given
// stream, allocates nothing (workspaces come from the caller) and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it refuses.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;  // a 16 x 16 grid: tx = tid % 16, ty = tid / 16

template <int HD>
struct Tile;
// hd 16 and 32 (the `tiny`, `tiny-gemma` and step-bench widths) run only
// here, in float32 and bf16 alike: a thread's micro-tile holds HD / 16
// columns (one at hd 16, see unrotate_cols).
template <>
struct Tile<16> {
  static constexpr int BQ = 64, BK = 64;
};
template <>
struct Tile<32> {
  static constexpr int BQ = 64, BK = 64;
};
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
  float* dq_ws;     // fused backward: float32 dq sums, [B, Sq, H, hd]
                    // (CUDA cores) or [B, H, sq_pad, hd] (tensor cores)
  void* dq;
  void* dk;         // fused: [B, Sk, KV, hd]; split: dk_h [B, Sk, H, hd]
  void* dv;
  void* q_rot;      // tensor cores with rope: rotated q / k workspaces
  void* k_rot;
  float* stats;     // tensor-core backward: {lse, D} [B, H, sq_pad, 2]
  float* dkv_ws;    // tensor-core fused backward at hd 256: float32 group
                    // sums of dk and dv, [2, B, KV, sk_pad, hd]
  int B, Sq, Sk, H, KV, group, causal, rope;
  int sq_pad;       // Sq rounded up to the tensor-core backward's q tile
  int sk_pad;       // Sk rounded up to the hd-256 fused backward's key tile
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

// The backward epilogues' inverse rotation of a thread's float32 columns
// tx + 16 j (j < HD / 16) of the row at position `pos`. From hd 32 up the
// pair (d, d + HD / 2) sits in this thread: j and j + HD / 32. At hd 16 a
// thread holds one column, d = tx, and its partner d ^ 8 sits in lane ^ 8
// of the same half-warp (same ty, so the same row): one shuffle exchanges
// them, so every lane of the warp calls this, `valid` or not (a row past
// the sequence reads no table entry).
template <int HD>
__device__ __forceinline__ void unrotate_cols(float (&x)[HD / 16],
                                              const Params& p, int pos,
                                              bool valid) {
  constexpr int DJ = HD / 16, H2 = HD / 2;
  const int tx = threadIdx.x & 15;
  if constexpr (DJ == 1) {
    const float other = __shfl_xor_sync(0xffffffffu, x[0], 8);
    if (!valid) return;
    const bool lo = tx < 8;
    const int d = tx & 7;
    float o1, o2;
    rotate(lo ? x[0] : other, lo ? other : x[0], p.cos[(size_t)pos * H2 + d],
           p.sin[(size_t)pos * H2 + d], true, o1, o2);
    x[0] = lo ? o1 : o2;
  } else {
    if (!valid) return;
#pragma unroll
    for (int j = 0; j < DJ / 2; ++j) {
      const int d = tx + 16 * j;
      rotate(x[j], x[j + DJ / 2], p.cos[(size_t)pos * H2 + d],
             p.sin[(size_t)pos * H2 + d], true, x[j], x[j + DJ / 2]);
    }
  }
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
  constexpr int RI = BQ / 16, RK = BK / 16, DJ = HD / 16;
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
    float x[DJ];
#pragma unroll
    for (int j = 0; j < DJ; ++j) x[j] = dk[i][j] * p.scale;
    if (p.rope) unrotate_cols<HD>(x, p, kj, kj < p.Sk);
    if (kj >= p.Sk) continue;
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
  constexpr int RI = BQ / 16, DJ = HD / 16;
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
    float x[DJ];
#pragma unroll
    for (int j = 0; j < DJ; ++j) x[j] = dq[i][j] * p.scale;
    if (p.rope) unrotate_cols<HD>(x, p, qi, qi < p.Sq);
    if (qi >= p.Sq) continue;
    T* row = dq_out + ((size_t)(b * p.Sq + qi) * p.H + h) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_f<T>(x[j]);
  }
}

// Column of element (row, col) in a float32 workspace row whose 8-float
// chunks are XOR-swizzled by the row's position in its group of 8 rows:
// eight consecutive rows' staging writes then fall on distinct banks.
__host__ __device__ __forceinline__ int swizzled_col(int col, int row) {
  return col ^ ((row & 7) << 3);
}

// The fused backward's epilogue for dq: inverse rotation (with rope) of
// the float32 sums, then the cast. kHeadMajor: the tensor-core kernel's
// [B, H, sq_pad, hd] workspace, else [B, Sq, H, hd]; kSwizzled: its
// columns as swizzled_col (the hd-256 kernel's). blockIdx.x is the
// position s, blockIdx.y the batch; threads cover the heads' hd/2 pairs.
template <typename T, int HD, bool kHeadMajor, bool kSwizzled = false>
__global__ void flash_dq_finish_kernel(Params p) {
  constexpr int H2 = HD / 2;
  const int s = blockIdx.x, b = blockIdx.y;
  T* dq = static_cast<T*>(p.dq);
  for (int i = threadIdx.x; i < p.H * H2; i += blockDim.x) {
    const int h = i / H2, d = i - h * H2;
    const size_t row = ((size_t)b * p.Sq + s) * p.H + h;  // (b, s, h) of dq
    const size_t ws =
        kHeadMajor ? ((size_t)b * p.H + h) * p.sq_pad + s : row;
    const int c1 = kSwizzled ? swizzled_col(d, s) : d;
    const int c2 = kSwizzled ? swizzled_col(d + H2, s) : d + H2;
    float x1 = p.dq_ws[ws * HD + c1], x2 = p.dq_ws[ws * HD + c2];
    if (p.rope)
      rotate(x1, x2, p.cos[(size_t)s * H2 + d], p.sin[(size_t)s * H2 + d],
             true, x1, x2);
    dq[row * HD + d] = from_f<T>(x1);
    dq[row * HD + d + H2] = from_f<T>(x2);
  }
}

// ---- tensor-core kernels (bf16) ---------------------------------------------

enum Which { kFwd, kBwdFused, kBwdDq, kBwdDkdv };

// Static route, per operator: the head widths whose bf16 kernels take the
// tensor cores (ops/flash_attention.py's TENSOR_CORE_HEAD_DIMS is the same
// table): hd 64, 128 and 256 for all four operators; float32, and bf16 at
// hd 16 and 32, stay on the CUDA cores.
constexpr bool tc_head_dim(Which w, int hd) {
  switch (w) {
    case kFwd: return hd == 64 || hd == 128 || hd == 256;
    case kBwdFused: return hd == 64 || hd == 128 || hd == 256;
    case kBwdDq: return hd == 64 || hd == 128 || hd == 256;
    case kBwdDkdv: return hd == 64 || hd == 128 || hd == 256;
  }
  return false;
}

template <Which W, typename T, int HD>
struct TcRoute {
  static constexpr bool value =
      std::is_same<T, __nv_bfloat16>::value && tc_head_dim(W, HD);
};

constexpr int kTcThreads = 256;  // backward: two consumer warpgroups
constexpr int kTcFwdStages = 2;  // forward: K/V tiles in flight

// Forward CTA shape: consumer warpgroups of 64 q rows each and a producer
// that only issues the TMA loads. At hd 64 / 128, three warpgroups and a
// producer warp. At hd 256 a consumer thread holds O as 128 float32
// registers beside a 32-register score tile and P's 16 A-fragment
// registers, more than the 152 a thread of 416 gets or the 168 of 288
// (registers are split between the SM's four quarters warp by warp). So
// two consumer warpgroups (BQ = 128) and a producer WARPGROUP: launched at
// 168 registers a thread, it keeps 24 (setmaxnreg.dec) and the consumers
// take 240 (setmaxnreg.inc), as paged_prefill_tc_kernel<256> does.
template <int HD>
__host__ __device__ constexpr int fwd_tc_wgs() { return HD == 256 ? 2 : 3; }
template <int HD>
__host__ __device__ constexpr int fwd_tc_threads() {
  return fwd_tc_wgs<HD>() * 128 + (HD == 256 ? 128 : 32);
}
// hd 256: registers a producer / consumer thread keeps after the handover
// (24 x 128 + 240 x 256 = 168 x 384, what the launch bounds allot)
constexpr int kTcProducerRegs = 24, kTcConsumerRegs = 240;
constexpr int kTcBwdBK = 128;    // backward: keys per CTA (64 per warpgroup)
constexpr int kTcBwdBQ = 64;     // backward: q rows per tile

// Forward keys per tile: 128 at hd 64; 64 at hd 128 and 256 (the O
// accumulator doubles at 128, so S halves to keep registers under the cap).
template <int HD>
struct TcFwdBK {
  static constexpr int value = HD == 64 ? 128 : 64;
};

// The tensor maps of one launch (each 128 bytes, in kernel parameter
// space via __grid_constant__).
struct TcMaps {
  CUtensorMap q, k, v, dout;
};

// RoPE pre-pass: x [B, S, N, HD] -> y, rotated in float32 by each row's
// position and rounded to T (the values the CUDA-core kernels rotate
// while staging, and the plain version computes). blockIdx.x is the
// position, blockIdx.y the batch; a block's threads cover the N heads'
// HD / 2 pairs, so no thread divides by a run-time size.
template <typename T, int HD>
__global__ void flash_rope_kernel(const T* x, T* y, const float* cos,
                                  const float* sin, int S, int N) {
  constexpr int H2 = HD / 2;
  const int s = blockIdx.x;
  const size_t row0 = ((size_t)blockIdx.y * S + s) * N;
  for (int i = threadIdx.x; i < N * H2; i += blockDim.x) {
    const int n = i / H2, d = i - n * H2;
    const size_t off = (row0 + n) * HD + d;
    float o1, o2;
    rotate(to_f<T>(x[off]), to_f<T>(x[off + H2]), cos[s * H2 + d],
           sin[s * H2 + d], false, o1, o2);
    y[off] = from_f<T>(o1);
    y[off + H2] = from_f<T>(o2);
  }
}

// hd 256: 64 KB of Q and two stages of K and V at 32 KB each, 193 KB; a
// third stage would not fit the 227 KB.
template <int HD>
constexpr size_t fwd_tc_smem_bytes() {
  return 1024 + (size_t)64 * fwd_tc_wgs<HD>() * HD * 2 +
         2 * kTcFwdStages * (size_t)TcFwdBK<HD>::value * HD * 2 + 64;
}

// Forward: one CTA per (64 x WGS q rows, b, h). Warpgroup wg owns rows
// 64 wg .. 64 wg + 63 and walks the visible k tiles; the producer only
// issues the TMA loads, kTcFwdStages K/V tiles ahead, so the consumer
// warpgroups never wait for each other. At hd 256, Q.K^T steps through
// Q's four 64-column panels and P.V is one m64n256k16 wgmma a 16-key step
// across V's four panels (the descriptor's leading offset is the panel
// stride).
template <int HD>
__global__ void __launch_bounds__(fwd_tc_threads<HD>(), 1)
    flash_fwd_tc_kernel(const __grid_constant__ TcMaps maps, Params p) {
  constexpr int WGS = fwd_tc_wgs<HD>(), BQ = 64 * WGS;
  constexpr int BK = TcFwdBK<HD>::value, NP = HD / kPanel;
  constexpr int ST = kTcFwdStages;
  constexpr uint32_t kQBytes = BQ * HD * 2, kKBytes = BK * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);  // [NP panels][BQ rows][128 B]
  uint8_t* sK = sQ + kQBytes;         // [ST stages][NP][BK][128 B]
  uint8_t* sV = sK + ST * kKBytes;
  // q loaded, then per stage: K/V loaded (full), K/V consumed (empty)
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + ST * kKBytes);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int n_q = (p.Sq + BQ - 1) / BQ;
  // causal: the longest rows first, so the last wave is the short tiles
  const int qt = p.causal ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int kvh = h / p.group;
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(q_last + 1, p.Sk) : p.Sk;
  const int n_k = (k_end + BK - 1) / BK;
  const float scale2 = p.scale * kLog2e;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WGS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid >= WGS * 128) {  // the producer warp (warpgroup at hd 256)
    if constexpr (HD == 256) setmaxnreg_dec<kTcProducerRegs>();
    if (tid == WGS * 128) {
      mbar_expect_tx(bar_q, kQBytes);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
        tma_load(sQ + pn * BQ * 128, &maps.q, bar_q, pn * kPanel, h, q0, b);
      for (int kt = 0; kt < n_k; ++kt) {
        const int st = kt % ST;
        if (kt >= ST) mbar_wait(&empty[st], (kt / ST - 1) & 1);
        mbar_expect_tx(&full[st], 2 * kKBytes);
#pragma unroll
        for (int pn = 0; pn < NP; ++pn) {
          const uint32_t off = st * kKBytes + pn * BK * 128;
          tma_load(sK + off, &maps.k, &full[st], pn * kPanel, kvh, kt * BK, b);
          tma_load(sV + off, &maps.v, &full[st], pn * kPanel, kvh, kt * BK, b);
        }
      }
    }
    return;
  }
  if constexpr (HD == 256) setmaxnreg_inc<kTcConsumerRegs>();
  // this thread's accumulator rows (row0, row0 + 8 of its warpgroup's 64)
  // and columns (col0, col0 + 1 of every 8)
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  const int qrow = q0 + 64 * wg + row0;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const uint8_t* qa = sQ + wg * 64 * 128;
  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % ST, k0 = kt * BK;
    mbar_wait(&full[st], (kt / ST) & 1);
    const uint8_t* kb = sK + st * kKBytes;
    const uint8_t* vb = sV + st * kKBytes;
    float s[BK / 2];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss<0, 0>(s, sw128_desc(qa + (ks >> 2) * BQ * 128 + (ks & 3) * 32, 16, 1024),
                     sw128_desc(kb + (ks >> 2) * BK * 128 + (ks & 3) * 32, 16, 1024),
                     ks > 0);
    wg_commit();
    wg_wait_all();
    pin(s);
    const bool need_mask =
        k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0 + 64 * wg);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c] * scale2;
          if (need_mask && !visible(p, qrow + 8 * i, k0 + 8 * j + col0 + c))
            x = kNegInf;
          s[4 * j + 2 * i + c] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_r[i], quad_max(mx[i]));
      corr[i] = exp2_approx(m_r[i] - m_new);
      m_r[i] = m_new;
    }
    // P rounded to bf16 straight into the A fragments of P.V
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float x0 = s[4 * j + 2 * i], x1 = s[4 * j + 2 * i + 1];
        const float p0 = x0 <= kNegInf ? 0.f : exp2_approx(x0 - m_r[i]);
        const float p1 = x1 <= kNegInf ? 0.f : exp2_approx(x1 - m_r[i]);
        rs[i] += p0 + p1;  // l sums the unrounded P
        pa[j >> 1][(j & 1) * 2 + i] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + rs[i];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= corr[i];
        o[4 * j + 2 * i + 1] *= corr[i];
      }
    pin(o);
    pin(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<1>(o, pa[kk], sw128_desc(vb + kk * 2048, BK * 128, 1024), 1);
    wg_commit();
    wg_wait_all();
    pin(o);
    mbar_arrive(&empty[st]);  // this thread is done with stage st
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(quad_sum(l_r[i]), 1e-30f);
    const int qi = qrow + 8 * i;
    if (qi >= p.Sq) continue;
    __nv_bfloat16* orow = out + ((size_t)(b * p.Sq + qi) * p.H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + col0) =
          pack_bf16(o[4 * j + 2 * i] / lc, o[4 * j + 2 * i + 1] / lc);
    if ((lane & 3) == 0)
      p.lse_out[(size_t)bh * p.Sq + qi] = m_r[i] + log2f(lc);
  }
}

// Backward pre-pass: one warp per row (b, h, s) of [B, H, sq_pad]
// (blockIdx.y = b * H + h, 8 rows s per block): stats = {lse, D =
// rowsum(dO * O)} in float32 (zero past Sq), and the row of the dq
// workspace zeroed (the fused route's; the split pair passes none).
template <int HD>
__global__ void flash_bwd_prep_kernel(Params p) {
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int s = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)bh * p.sq_pad + s;
  float acc = 0.f;
  if (s < p.Sq) {
    const size_t off = ((size_t)(b * p.Sq + s) * p.H + h) * HD;
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(p.dout) + off;
    const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.out) + off;
    for (int d = lane; d < HD; d += 32)
      acc = fmaf(__bfloat162float(g[d]), __bfloat162float(o[d]), acc);
  }
  acc = sum32(acc);
  if (p.dq_ws != nullptr)
    for (int d = lane; d < HD; d += 32) p.dq_ws[row * HD + d] = 0.f;
  if (lane == 0) {
    p.stats[2 * row] = s < p.Sq ? p.lse[(size_t)bh * p.Sq + s] : 0.f;
    p.stats[2 * row + 1] = s < p.Sq ? acc : 0.f;
  }
}

// dS^T and the dQ staging tiles: the fused route's only.
template <int HD, bool kFused>
struct BwdTcDq {
  static constexpr uint32_t ds = kFused ? kTcBwdBK * kTcBwdBQ * 2 : 0;
  static constexpr uint32_t dq = kFused ? kTcBwdBQ * HD * 4 : 0;
};

template <int HD, bool kFused>
constexpr size_t bwd_tc_smem_bytes() {
  return 1024 + 2 * (size_t)kTcBwdBK * HD * 2  // K, V
         + 4 * (size_t)kTcBwdBQ * HD * 2        // Q, dO x 2 stages
         + BwdTcDq<HD, kFused>::ds              // dS^T
         + 2 * (size_t)BwdTcDq<HD, kFused>::dq  // dQ staging x 2
         + 2 * (size_t)kTcBwdBQ * 8 + 64;        // stats x 2, barriers
}

// Tensor-core backward: one CTA per 128 keys; warpgroup wg owns keys
// 64 wg .. 64 wg + 63. kFused (flash_bwd_fused): the keys of one
// (b, kv-head), walking the GQA group's q-heads and q tiles, dK/dV summed
// over the group and each tile's dQ added to the workspace. Otherwise
// (flash_bwd_dkdv): the keys against one (b, q-head)'s q tiles, four
// products a tile and no dQ, written as that head's dk_h / dv_h.
template <int HD, bool kFused>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_tc_kernel(const __grid_constant__ TcMaps maps, Params p) {
  constexpr int BK = kTcBwdBK, BQ = kTcBwdBQ, NP = HD / kPanel;
  constexpr uint32_t kKBytes = BK * HD * 2, kQBytes = BQ * HD * 2;
  constexpr uint32_t kDsBytes = BwdTcDq<HD, kFused>::ds;
  constexpr uint32_t kDqBytes = BwdTcDq<HD, kFused>::dq;
  constexpr uint32_t kStatBytes = BQ * 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);  // [NP][BK][128 B]
  uint8_t* sV = sK + kKBytes;
  uint8_t* sQ = sV + kKBytes;         // [2 stages][NP][BQ][128 B]
  uint8_t* sdO = sQ + 2 * kQBytes;
  uint8_t* sDS = sdO + 2 * kQBytes;   // dS^T [BK keys][BQ q], swizzled
  uint8_t* sDQ = sDS + kDsBytes;      // [2][BQ][HD] float32
  uint8_t* sStat = sDQ + 2 * kDqBytes;  // [2][BQ] {lse, D}
  uint64_t* bar = reinterpret_cast<uint64_t*>(sStat + 2 * kStatBytes);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * BK;
  const int heads = kFused ? p.KV : p.H;  // blockIdx.y = b * heads + head
  const int b = blockIdx.y / heads, head = blockIdx.y - b * heads;
  const int kvh = kFused ? head : head / p.group;
  const int h_first = kFused ? kvh * p.group : head;
  const int n_q = (p.Sq + BQ - 1) / BQ;
  const int qt0 = p.causal ? min(k0 / BQ, n_q) : 0;  // first tile with a row >= k0
  const int per_head = n_q - qt0;
  const int n_tiles = (kFused ? p.group : 1) * per_head;
  const float scale2 = p.scale * kLog2e;

  auto load_q = [&](int t) {
    const int st = t & 1, h = h_first + t / per_head;
    const int q0 = (qt0 + t % per_head) * BQ;
    mbar_expect_tx(&bar[1 + st], 2 * kQBytes + kStatBytes);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      const uint32_t off = st * kQBytes + pn * BQ * 128;
      tma_load(sQ + off, &maps.q, &bar[1 + st], pn * kPanel, h, q0, b);
      tma_load(sdO + off, &maps.dout, &bar[1 + st], pn * kPanel, h, q0, b);
    }
    bulk_load(sStat + st * kStatBytes,
              p.stats + ((size_t)(b * p.H + h) * p.sq_pad + q0) * 2,
              kStatBytes, &bar[1 + st]);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[0], 2 * kKBytes);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      tma_load(sK + pn * BK * 128, &maps.k, &bar[0], pn * kPanel, kvh, k0, b);
      tma_load(sV + pn * BK * 128, &maps.v, &bar[0], pn * kPanel, kvh, k0, b);
    }
    if (n_tiles > 0) load_q(0);
  }
  // accumulator rows: keys row0, row0 + 8 of the warpgroup's 64; columns
  // col0, col0 + 1 of every 8 (q in S^T, hd in dK/dV)
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  const int krow = k0 + 64 * wg + row0;
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint8_t* ka = sK + wg * 64 * 128;
  const uint8_t* va = sV + wg * 64 * 128;
  // this warpgroup's half of dQ's columns, as K's MN-major B operand
  const uint8_t* kq =
      sK + (wg * HD / 2 / kPanel) * BK * 128 + (wg * HD / 2 % kPanel) * 2;
  mbar_wait(&bar[0], 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, h = h_first + t / per_head;
    const int q0 = (qt0 + t % per_head) * BQ;
    if (kFused && tid == 0) bulk_wait_read<1>();  // tile t - 2's reduce has read sDQ[st]
    __syncthreads();  // tile t - 1 is done with stage st ^ 1 and sDS
    if (tid == 0 && t + 1 < n_tiles) load_q(t + 1);
    mbar_wait(&bar[1 + st], (t >> 1) & 1);
    const uint8_t* qb = sQ + st * kQBytes;
    const uint8_t* gb = sdO + st * kQBytes;
    float s[BQ / 2], dp[BQ / 2];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss<0, 0>(s, sw128_desc(ka + (ks >> 2) * BK * 128 + (ks & 3) * 32, 16, 1024),
                     sw128_desc(qb + (ks >> 2) * BQ * 128 + (ks & 3) * 32, 16, 1024),
                     ks > 0);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss<0, 0>(dp, sw128_desc(va + (ks >> 2) * BK * 128 + (ks & 3) * 32, 16, 1024),
                     sw128_desc(gb + (ks >> 2) * BQ * 128 + (ks & 3) * 32, 16, 1024),
                     ks > 0);
    wg_commit();
    wg_wait_all();
    pin(s);
    pin(dp);
    const float2* stat = reinterpret_cast<const float2*>(sStat + st * kStatBytes);
    const bool need_mask = q0 + BQ > p.Sq || k0 + BK > p.Sk ||
                           (p.causal && q0 < k0 + 64 * wg + 63);
    // P^T = exp2(s - lse) rounded to bf16 for dV; dS^T = P^T (dP^T - D)
    // rounded to bf16 for dK (registers) and dQ (shared memory)
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      float pv[2][2], dsv[2][2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = 8 * j + col0 + c;
        const float2 ld = stat[qc];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float pr = 0.f;
          if (!need_mask || visible(p, q0 + qc, krow + 8 * i))
            pr = exp2_approx(s[4 * j + 2 * i + c] * scale2 - ld.x);
          pv[i][c] = pr;
          dsv[i][c] = pr * (dp[4 * j + 2 * i + c] - ld.y);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pa[j >> 1][(j & 1) * 2 + i] = pack_bf16(pv[i][0], pv[i][1]);
        const uint32_t d2 = pack_bf16(dsv[i][0], dsv[i][1]);
        da[j >> 1][(j & 1) * 2 + i] = d2;
        if constexpr (kFused) {
          const int r = 64 * wg + row0 + 8 * i;  // key row of sDS
          *reinterpret_cast<uint32_t*>(sDS + r * 128 + ((j ^ (r & 7)) << 4) +
                                       col0 * 2) = d2;
        }
      }
    }
    if constexpr (kFused) fence_proxy_async();
    pin(dv);
    pin(dk);
    pin(pa);
    pin(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<1>(dv, pa[kk], sw128_desc(gb + kk * 2048, BQ * 128, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<1>(dk, da[kk], sw128_desc(qb + kk * 2048, BQ * 128, 1024), 1);
    wg_commit();
    wg_wait_all();
    pin(dv);
    pin(dk);
    if constexpr (kFused) {
      __syncthreads();  // both warpgroups' dS^T rows are in sDS
      // this tile's dQ columns: dS (MN-major A) . K (MN-major B), all 128 keys
      float dq[HD / 4];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<1, 1>(dq, sw128_desc(sDS + kk * 2048, BQ * 128, 1024),
                       sw128_desc(kq + kk * 2048, BK * 128, 1024), kk > 0);
      wg_commit();
      wg_wait_all();
      pin(dq);
      float* sdq = reinterpret_cast<float*>(sDQ + st * kDqBytes);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(sdq + (row0 + 8 * i) * HD + wg * HD / 2 +
                                     8 * j + col0) =
              make_float2(dq[4 * j + 2 * i] * p.scale,
                          dq[4 * j + 2 * i + 1] * p.scale);
      fence_proxy_async();
      __syncthreads();
      if (tid == 0)
        bulk_reduce_add(p.dq_ws + ((size_t)(b * p.H + h) * p.sq_pad + q0) * HD,
                        sdq, kDqBytes);
    }
  }
  if (kFused && tid == 0) bulk_wait_all();
  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(p.dv);
  constexpr int H2 = HD / 2, HJ = HD / 16;  // hd/2 is HJ blocks of 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = krow + 8 * i;
    if (kj >= p.Sk) continue;
    // fused: [B, Sk, KV, hd] at kvh; split: dk_h / dv_h [B, Sk, H, hd] at h
    const size_t base = ((size_t)(b * p.Sk + kj) * heads + head) * HD;
#pragma unroll
    for (int j = 0; j < HJ; ++j) {
      float x1[2], x2[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        x1[c] = dk[4 * j + 2 * i + c] * p.scale;
        x2[c] = dk[4 * (j + HJ) + 2 * i + c] * p.scale;
        if (p.rope) {
          const size_t t = (size_t)kj * H2 + 8 * j + col0 + c;
          rotate(x1[c], x2[c], p.cos[t], p.sin[t], true, x1[c], x2[c]);
        }
      }
      *reinterpret_cast<uint32_t*>(dk_out + base + 8 * j + col0) =
          pack_bf16(x1[0], x1[1]);
      *reinterpret_cast<uint32_t*>(dk_out + base + H2 + 8 * j + col0) =
          pack_bf16(x2[0], x2[1]);
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dv_out + base + 8 * j + col0) =
          pack_bf16(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
  }
}

// ---- the fused backward at hd 256 (tensor cores) ---------------------------
//
// flash_bwd_tc_kernel<hd, true>'s layout (a warpgroup per 64 keys, dK and
// dV in its registers) would need 128 + 128 float32 registers a thread at
// hd 256 before S^T or dP^T, over the 255 cap. So a CTA owns 64 keys of
// ONE q-head, and its two warpgroups split the accumulators, not hd: WG0
// computes S^T = K.Q^T and keeps dV += P^T.dO, WG1 computes dP^T = V.dO^T
// and keeps dK += dS^T.Q, each [64 keys, 256] in 128 registers a thread, a
// full row of hd per thread (so dK's inverse rotation pairs columns c and
// c + 128 in registers at the end). WG0 hands P^T to WG1 as float32
// through shared memory (16 KB; dS = P (dP - D) takes the unrounded P),
// WG1 writes dS^T (bf16) for dQ = dS.K, which the two warpgroups split by
// hd halves (m64n128k16, both operands MN-major). Each product runs once:
// the five of the 10*hd bound, 2.5 a warpgroup. 256 threads and no
// producer, so each keeps up to 255 registers without a handover: peak
// 128 (dV or dK) + 64 (its dQ half) + addressing.
//
// The grid is (B * H q-heads, key tiles), the key tiles slow, so the
// CTAs with the most q tiles (small k0, causal) start first. Spreading a
// GQA group's q-heads over CTAs (an MQA group of 8 at B = 4 gives 32
// heads x 32 key tiles, 1024 CTAs, where one CTA per kv-head would give
// 128 CTAs whose first walks 256 q tiles and whose last 8) means the
// group sum of dK and dV crosses CTAs: each CTA adds its float32 dV and
// unscaled dK into a [2, B, KV, sk_pad, hd] workspace with one bulk
// reduce each (cp.reduce.async.bulk .add.f32, as the dQ tiles), and
// flash_dkv_finish_kernel scales, inverse-rotates and rounds once. The
// reference's contract holds: the group sums in float32, rounded once;
// only the order of the sum changes, as it already does for dq.
//
// Shared memory (217 KB of the 227): K and V 64 KB, two stages of Q and
// dO 128 KB, dS^T 8 KB, P^T 16 KB, stats 1 KB. A float32 dQ staging tile
// of 64 x 256 (64 KB) does not fit beside them. Of the ways out (a single Q/dO stage,
// which serialises each tile's loads with its products; dQ staged a
// warpgroup-half at a time, which serialises the two halves' reduces; dQ
// reduced from registers with red.global.add.f32, 16K scattered float
// atomics a tile), this kernel takes none: dQ = dS.K reads only dS^T and
// K, so once both warpgroups are done with a tile's dV and dK products
// that tile's 64 KB stage of Q and dO is dead and holds the dQ staging
// tile. The next load into that stage (two tiles on) waits until the bulk
// reduce has read it: one thread of WG1 issues every copy and reduce, and
// in tile t + 1 it waits for tile t's reduce to have read its stage
// (cp.async.bulk.wait_group.read 0), then issues tile t + 2's load, while
// WG0 computes P (WG1 has nothing to do until P is in shared memory). Two
// stages of loads and one bulk dQ reduce a tile are both kept. At the end
// the two stages hold dV and dK for their reduces. Staged rows are 1 KB
// apart, so a warp's writes of eight rows would meet one bank group eight
// times over: the staging tiles' 8-float chunks are XOR-swizzled by row
// (swizzled_col), the workspaces keep that order, and the finishing
// kernels undo it.
//
// The split dk/dv at hd 256 (flash_bwd_tc_kernel<256, false>) is the same
// kernel with the dQ work taken out: a CTA owns 64 keys against ONE
// q-head's causal q tiles, WG0 keeps dV and WG1 dK as above, four
// products a tile (S^T, dP^T, dV, dK; no dS^T staging, no dQ product or
// reduce), and each CTA writes its head's dk_h / dv_h straight from
// registers, rounded, dK scaled and inverse-rotated in float32 (columns c
// and c + 128 of a row sit in one thread): no workspace, no finishing
// kernel; the group sum stays outside, in flash_backward (the reference's
// split contract). The generic flash_bwd_tc_kernel<HD, false> (128 keys a
// CTA, dK and dV in one warpgroup's registers) would need 256
// accumulator registers a thread here.
constexpr int kTc256BK = 64;  // keys a CTA
constexpr uint32_t kTc256Stage = 2 * kTcBwdBQ * 256 * 2;  // Q + dO of a tile

template <bool kFused>
constexpr size_t bwd_tc256_smem_bytes() {
  return 1024 + 2 * (size_t)kTc256BK * 256 * 2       // K, V
         + 2 * (size_t)kTc256Stage                    // Q, dO x 2 stages
         + (kFused ? (size_t)kTc256BK * kTcBwdBQ * 2 : 0)  // dS^T
         + (size_t)kTc256BK * kTcBwdBQ * 4            // P^T, float32
         + 2 * (size_t)kTcBwdBQ * 8 + 64;              // stats x 2, barriers
}

template <bool kFused>
__device__ __forceinline__ void bwd_tc256_body(const TcMaps& maps,
                                               const Params& p) {
  constexpr int HD = 256, BK = kTc256BK, BQ = kTcBwdBQ, NP = HD / kPanel;
  constexpr uint32_t kKBytes = BK * HD * 2, kQBytes = BQ * HD * 2;
  constexpr uint32_t kStatBytes = BQ * 8;
  constexpr uint32_t kDsBytes = kFused ? BK * BQ * 2 : 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);  // [NP][BK][128 B]
  uint8_t* sV = sK + kKBytes;
  uint8_t* sQ = sV + kKBytes;  // stage st at sQ + st * kTc256Stage: Q, then dO
  uint8_t* sDS = sQ + 2 * kTc256Stage;  // dS^T [BK keys][BQ q], swizzled
  float* sP = reinterpret_cast<float*>(sDS + kDsBytes);  // [32][128]
  uint8_t* sStat = reinterpret_cast<uint8_t*>(sP + (BQ / 2) * 128);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sStat + 2 * kStatBytes);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, t128 = tid & 127;
  const int b = blockIdx.x / p.H, h = blockIdx.x - b * p.H;
  const int kvh = h / p.group;
  const int k0 = blockIdx.y * BK;
  const int n_q = (p.Sq + BQ - 1) / BQ;
  const int qt0 = p.causal ? min(k0 / BQ, n_q) : 0;  // first tile with a row >= k0
  const int n_tiles = n_q - qt0;
  const float scale2 = p.scale * kLog2e;

  auto load_q = [&](int t) {
    const int st = t & 1, q0 = (qt0 + t) * BQ;
    uint8_t* dst = sQ + st * kTc256Stage;
    mbar_expect_tx(&bar[1 + st], 2 * kQBytes + kStatBytes);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      tma_load(dst + pn * BQ * 128, &maps.q, &bar[1 + st], pn * kPanel, h, q0, b);
      tma_load(dst + kQBytes + pn * BQ * 128, &maps.dout, &bar[1 + st],
               pn * kPanel, h, q0, b);
    }
    bulk_load(sStat + st * kStatBytes,
              p.stats + ((size_t)(b * p.H + h) * p.sq_pad + q0) * 2,
              kStatBytes, &bar[1 + st]);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  // one thread of WG1 issues every copy and reduce: fused, it waits for a
  // dQ reduce's read while WG0 computes the next tile's P
  const bool issuer = tid == 128;
  if (issuer) {
    mbar_expect_tx(&bar[0], 2 * kKBytes);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      tma_load(sK + pn * BK * 128, &maps.k, &bar[0], pn * kPanel, kvh, k0, b);
      tma_load(sV + pn * BK * 128, &maps.v, &bar[0], pn * kPanel, kvh, k0, b);
    }
    if (n_tiles > 0) load_q(0);
  }
  // accumulator rows: keys row0, row0 + 8 of the 64; columns col0, col0 + 1
  // of every 8 (q in S^T / dP^T, hd in dV / dK)
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  const int krow = k0 + row0;
  float acc[HD / 2];  // WG0: dV, WG1: dK (unscaled)
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  // S^T from K (WG0), dP^T from V (WG1)
  const uint8_t* ka = wg == 0 ? sK : sV;
  mbar_wait(&bar[0], 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, q0 = (qt0 + t) * BQ;
    __syncthreads();  // tile t - 1 is done with sP and sDS, its dQ staged
    mbar_wait(&bar[1 + st], (t >> 1) & 1);
    uint8_t* qb = sQ + st * kTc256Stage;
    const uint8_t* gb = qb + kQBytes;
    const uint8_t* bq = wg == 0 ? qb : gb;  // Q^T for S^T, dO^T for dP^T
    float s[BQ / 2];  // WG0: S^T, WG1: dP^T
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss<0, 0>(s, sw128_desc(ka + (ks >> 2) * BK * 128 + (ks & 3) * 32, 16, 1024),
                     sw128_desc(bq + (ks >> 2) * BQ * 128 + (ks & 3) * 32, 16, 1024),
                     ks > 0);
    wg_commit();
    wg_wait_all();
    pin(s);
    const float2* stat = reinterpret_cast<const float2*>(sStat + st * kStatBytes);
    const bool need_mask = q0 + BQ > p.Sq || k0 + BK > p.Sk ||
                           (p.causal && q0 < k0 + BK - 1);
    // bf16 A fragments: WG0 P^T (for dV), WG1 dS^T (for dK)
    uint32_t fa[BQ / 16][4];
    if (wg == 0) {
      // P^T = exp2(s - lse): rounded to bf16 for dV, float32 to WG1
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        float pv[2][2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qc = 8 * j + col0 + c;
          const float lse = stat[qc].x;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = 4 * j + 2 * i + c;
            float pr = 0.f;
            if (!need_mask || visible(p, q0 + qc, krow + 8 * i))
              pr = exp2_approx(s[x] * scale2 - lse);
            pv[i][c] = pr;
            sP[x * 128 + t128] = pr;
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
          fa[j >> 1][(j & 1) * 2 + i] = pack_bf16(pv[i][0], pv[i][1]);
      }
    }
    if (issuer) {
      // stage st ^ 1 is free once tile t - 1's dQ reduce has read it
      if constexpr (kFused) bulk_wait_read<0>();
      if (t + 1 < n_tiles) load_q(t + 1);
    }
    __syncthreads();  // P^T is in sP
    if (wg == 1) {
      // dS^T = P^T (dP^T - D), rounded to bf16 for dK (registers) and,
      // fused, dQ (shared memory); the same thread of WG0 held the same
      // elements
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        float dsv[2][2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float d = stat[8 * j + col0 + c].y;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = 4 * j + 2 * i + c;
            dsv[i][c] = sP[x * 128 + t128] * (s[x] - d);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t d2 = pack_bf16(dsv[i][0], dsv[i][1]);
          fa[j >> 1][(j & 1) * 2 + i] = d2;
          if constexpr (kFused) {
            const int r = row0 + 8 * i;  // key row of sDS
            *reinterpret_cast<uint32_t*>(sDS + r * 128 +
                                         ((j ^ (r & 7)) << 4) + col0 * 2) = d2;
          }
        }
      }
      if constexpr (kFused) fence_proxy_async();
    }
    // WG0: dV += P^T.dO; WG1: dK += dS^T.Q (register A, MN-major B across
    // the four 64-column panels)
    const uint8_t* bsrc = wg == 0 ? gb : qb;
    pin(acc);
    pin(fa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<1>(acc, fa[kk], sw128_desc(bsrc + kk * 2048, BQ * 128, 1024), 1);
    wg_commit();
    wg_wait_all();
    pin(acc);
    if constexpr (kFused) {
      __syncthreads();  // sDS holds dS^T; stage st's Q and dO are dead
      // this warpgroup's half of dQ's columns (panels 2 wg, 2 wg + 1 of K),
      // as the MN-major B operand
      const uint8_t* kq = sK + 2 * wg * BK * 128;
      float dq[HD / 4];  // dQ[:, 128 wg .. 128 wg + 127] = dS.K over the 64 keys
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<1, 1>(dq, sw128_desc(sDS + kk * 2048, BQ * 128, 1024),
                       sw128_desc(kq + kk * 2048, BK * 128, 1024), kk > 0);
      wg_commit();
      wg_wait_all();
      pin(dq);
      // staged as float32 [BQ][HD] in stage st (columns as swizzled_col,
      // which the workspace keeps), then one bulk reduce-add
      float* sdq = reinterpret_cast<float*>(qb);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row0 + 8 * i;
          *reinterpret_cast<float2*>(
              sdq + r * HD + swizzled_col(wg * HD / 2 + 8 * j, r) + col0) =
              make_float2(dq[4 * j + 2 * i] * p.scale,
                          dq[4 * j + 2 * i + 1] * p.scale);
        }
      fence_proxy_async();
      __syncthreads();
      if (issuer)
        bulk_reduce_add(p.dq_ws + ((size_t)(b * p.H + h) * p.sq_pad + q0) * HD,
                        sdq, BQ * HD * 4);
    }
  }
  if constexpr (!kFused) {
    // this head's dV (WG0) and dK (WG1, scaled and inverse-rotated) as
    // dv_h / dk_h [B, Sk, H, hd], rounded once
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(wg == 0 ? p.dv : p.dk);
    const float sc = wg == 0 ? 1.f : p.scale;
    const bool rot = wg == 1 && p.rope;
    constexpr int H2 = HD / 2, HJ = HD / 16;  // hd/2 is HJ blocks of 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kj = krow + 8 * i;
      if (kj >= p.Sk) continue;
      const size_t base = ((size_t)(b * p.Sk + kj) * p.H + h) * HD;
#pragma unroll
      for (int j = 0; j < HJ; ++j) {
        float x1[2], x2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          x1[c] = acc[4 * j + 2 * i + c] * sc;
          x2[c] = acc[4 * (j + HJ) + 2 * i + c] * sc;
          if (rot) {
            const size_t t = (size_t)kj * H2 + 8 * j + col0 + c;
            rotate(x1[c], x2[c], p.cos[t], p.sin[t], true, x1[c], x2[c]);
          }
        }
        *reinterpret_cast<uint32_t*>(out + base + 8 * j + col0) =
            pack_bf16(x1[0], x1[1]);
        *reinterpret_cast<uint32_t*>(out + base + H2 + 8 * j + col0) =
            pack_bf16(x2[0], x2[1]);
      }
    }
  } else {
    if (issuer) bulk_wait_all();  // the last dQ reduce has read its stage
    __syncthreads();
    // this head's dV (WG0) and dK (WG1) as float32 [BK][HD] in stage wg
    // (swizzled as dQ), each added to the group sum by one bulk reduce
    float* sacc = reinterpret_cast<float*>(sQ + wg * kTc256Stage);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + 8 * i;
        *reinterpret_cast<float2*>(sacc + r * HD + swizzled_col(8 * j, r) +
                                   col0) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    fence_proxy_async();
    __syncthreads();
    if (issuer) {
      const size_t plane = (size_t)p.B * p.KV * p.sk_pad * HD;
      const size_t rows = ((size_t)(b * p.KV + kvh) * p.sk_pad + k0) * HD;
      bulk_reduce_add(p.dkv_ws + rows, sQ + kTc256Stage, BK * HD * 4);     // dK
      bulk_reduce_add(p.dkv_ws + plane + rows, sQ, BK * HD * 4);          // dV
      bulk_wait_all();
    }
  }
}

template <>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_tc_kernel<256, true>(const __grid_constant__ TcMaps maps,
                                   Params p) {
  bwd_tc256_body<true>(maps, p);
}

template <>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_tc_kernel<256, false>(const __grid_constant__ TcMaps maps,
                                    Params p) {
  bwd_tc256_body<false>(maps, p);
}

// The hd-256 fused backward's epilogue for dk / dv: the float32 group sums
// of [2, B, KV, sk_pad, hd] (columns as swizzled_col), dk scaled and (with
// rope) inverse-rotated, then each cast once. blockIdx.x is the position
// s, blockIdx.y the batch; threads cover the kv-heads' hd/2 pairs.
template <int HD>
__global__ void flash_dkv_finish_kernel(Params p) {
  constexpr int H2 = HD / 2;
  const int s = blockIdx.x, b = blockIdx.y;
  const size_t plane = (size_t)p.B * p.KV * p.sk_pad * HD;
  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(p.dv);
  for (int i = threadIdx.x; i < p.KV * H2; i += blockDim.x) {
    const int g = i / H2, d = i - g * H2;
    const size_t row = (((size_t)b * p.Sk + s) * p.KV + g) * HD;  // (b, s, g)
    const size_t ws = (((size_t)b * p.KV + g) * p.sk_pad + s) * HD;
    const int c1 = swizzled_col(d, s), c2 = swizzled_col(d + H2, s);
    float x1 = p.dkv_ws[ws + c1] * p.scale, x2 = p.dkv_ws[ws + c2] * p.scale;
    if (p.rope)
      rotate(x1, x2, p.cos[(size_t)s * H2 + d], p.sin[(size_t)s * H2 + d],
             true, x1, x2);
    dk[row + d] = __float2bfloat16(x1);
    dk[row + d + H2] = __float2bfloat16(x2);
    dv[row + d] = __float2bfloat16(p.dkv_ws[plane + ws + c1]);
    dv[row + d + H2] = __float2bfloat16(p.dkv_ws[plane + ws + c2]);
  }
}

// Split dq: the q rows per CTA are 64 per consumer warpgroup: three at
// hd 64, two at hd 128 and 256 (the dQ accumulator doubles at 128, so a
// third warpgroup would push the registers a thread under what it needs).
template <int HD>
struct TcDqWGs {
  static constexpr int value = HD == 64 ? 3 : 2;
};
// Keys per K/V tile and K/V tiles in flight: 64 x 2 at hd 64 / 128. At hd
// 256, Q and dO of 128 rows take 128 KB, and two 64-key stages of K and V
// another 128 KB, over the 227 KB a block may have: 32-key tiles, three
// in flight (96 KB, 225 KB in all). One 64-key stage would serialise each
// tile's loads with its products, and 64 q rows a CTA would load every
// K/V tile twice as often with one consumer warpgroup an SM.
template <int HD>
struct TcDqBK {
  static constexpr int value = HD == 256 ? 32 : 64;
};
template <int HD>
struct TcDqStages {
  static constexpr int value = HD == 256 ? 3 : 2;
};
// A producer warp issues the loads; at hd 256 a producer WARPGROUP that
// hands its registers to the consumers, as the forward's (dQ is 128
// float32 registers a thread beside S, dP and dS's A fragments).
template <int HD>
__host__ __device__ constexpr int dq_tc_threads() {
  return TcDqWGs<HD>::value * 128 + (HD == 256 ? 128 : 32);
}

template <int HD>
constexpr size_t dq_tc_smem_bytes() {
  return 1024 + 2 * (size_t)64 * TcDqWGs<HD>::value * HD * 2  // Q, dO
         + 2 * TcDqStages<HD>::value * (size_t)TcDqBK<HD>::value * HD * 2
         + 64;                                                  // barriers
}

// Split dq: one CTA per (64 x TcDqWGs q rows, b, q-head). Warpgroup wg
// owns rows 64 wg .. 64 wg + 63 and walks the visible k tiles of kv-head
// h / group, which the producer streams through a TcDqStages ring
// against "empty" barriers (as the forward does). Per tile: S = Q.K^T and
// dP = dO.V^T (shared memory), P = exp2(S - lse) and dS = P (dP - D) in
// registers, dS rounded to bf16 where the accumulator fragment is already
// the A operand of dQ += dS.K (K read MN-major; at hd 256 one m64n256k16
// a 16-key step across K's four panels). dQ stays in float32 registers
// across the whole loop and is written once (inverse-rotated under rope):
// no workspace, no cross-CTA sum.
template <int HD>
__global__ void __launch_bounds__(dq_tc_threads<HD>(), 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ TcMaps maps, Params p) {
  constexpr int WGS = TcDqWGs<HD>::value, BQ = 64 * WGS, BK = TcDqBK<HD>::value;
  constexpr int NP = HD / kPanel, ST = TcDqStages<HD>::value;
  constexpr uint32_t kQBytes = BQ * HD * 2, kKBytes = BK * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);  // [NP panels][BQ rows][128 B]
  uint8_t* sdO = sQ + kQBytes;
  uint8_t* sK = sdO + kQBytes;        // [ST stages][NP][BK][128 B]
  uint8_t* sV = sK + ST * kKBytes;
  // Q/dO loaded, then per stage: K/V loaded (full), K/V consumed (empty)
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + ST * kKBytes);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int n_q = (p.Sq + BQ - 1) / BQ;
  // causal: the longest rows first, so the last wave is the short tiles
  const int qt = p.causal ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int kvh = h / p.group;
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(q_last + 1, p.Sk) : p.Sk;
  const int n_k = (k_end + BK - 1) / BK;
  const float scale2 = p.scale * kLog2e;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WGS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid >= WGS * 128) {  // the producer warp (warpgroup at hd 256)
    if constexpr (HD == 256) setmaxnreg_dec<kTcProducerRegs>();
    if (tid == WGS * 128) {
      mbar_expect_tx(bar_q, 2 * kQBytes);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        tma_load(sQ + pn * BQ * 128, &maps.q, bar_q, pn * kPanel, h, q0, b);
        tma_load(sdO + pn * BQ * 128, &maps.dout, bar_q, pn * kPanel, h, q0,
                 b);
      }
      for (int kt = 0; kt < n_k; ++kt) {
        const int st = kt % ST;
        if (kt >= ST) mbar_wait(&empty[st], (kt / ST - 1) & 1);
        mbar_expect_tx(&full[st], 2 * kKBytes);
#pragma unroll
        for (int pn = 0; pn < NP; ++pn) {
          const uint32_t off = st * kKBytes + pn * BK * 128;
          tma_load(sK + off, &maps.k, &full[st], pn * kPanel, kvh, kt * BK, b);
          tma_load(sV + off, &maps.v, &full[st], pn * kPanel, kvh, kt * BK, b);
        }
      }
    }
    return;
  }
  if constexpr (HD == 256) setmaxnreg_inc<kTcConsumerRegs>();
  // this thread's accumulator rows (row0, row0 + 8 of its warpgroup's 64)
  // and columns (col0, col0 + 1 of every 8: keys in S and dP, hd in dQ)
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  const int wq0 = q0 + 64 * wg, qrow = wq0 + row0;
  float lse_r[2], d_r[2];  // the rows' {lse, D} (the pre-pass's stats)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qrow + 8 * i;
    float2 st = make_float2(0.f, 0.f);
    if (qi < p.Sq)
      st = reinterpret_cast<const float2*>(p.stats)[(size_t)bh * p.sq_pad + qi];
    lse_r[i] = st.x;
    d_r[i] = st.y;
  }
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  const uint8_t* qa = sQ + wg * 64 * 128;
  const uint8_t* ga = sdO + wg * 64 * 128;
  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % ST, k0 = kt * BK;
    mbar_wait(&full[st], (kt / ST) & 1);
    // a tile wholly above this warpgroup's diagonal, or a warpgroup wholly
    // past Sq, adds nothing (uniform over the warpgroup, as wgmma needs)
    if (wq0 < p.Sq && !(p.causal && k0 > wq0 + 63)) {
      const uint8_t* kb = sK + st * kKBytes;
      const uint8_t* vb = sV + st * kKBytes;
      float s[BK / 2], dp[BK / 2];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        wgmma_ss<0, 0>(s, sw128_desc(qa + (ks >> 2) * BQ * 128 + (ks & 3) * 32, 16, 1024),
                       sw128_desc(kb + (ks >> 2) * BK * 128 + (ks & 3) * 32, 16, 1024),
                       ks > 0);
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        wgmma_ss<0, 0>(dp, sw128_desc(ga + (ks >> 2) * BQ * 128 + (ks & 3) * 32, 16, 1024),
                       sw128_desc(vb + (ks >> 2) * BK * 128 + (ks & 3) * 32, 16, 1024),
                       ks > 0);
      wg_commit();
      wg_wait_all();
      pin(s);
      pin(dp);
      const bool need_mask =
          k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > wq0);
      // dS = P (dP - D) rounded to bf16 straight into the A fragments
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int x = 4 * j + 2 * i + c;
            float pr = 0.f;
            if (!need_mask || visible(p, qrow + 8 * i, k0 + 8 * j + col0 + c))
              pr = exp2_approx(s[x] * scale2 - lse_r[i]);
            ds[c] = pr * (dp[x] - d_r[i]);
          }
          da[j >> 1][(j & 1) * 2 + i] = pack_bf16(ds[0], ds[1]);
        }
      pin(dq);
      pin(da);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<1>(dq, da[kk], sw128_desc(kb + kk * 2048, BK * 128, 1024), 1);
      wg_commit();
      wg_wait_all();
      pin(dq);
    }
    mbar_arrive(&empty[st]);  // this thread is done with stage st
  }
  __nv_bfloat16* dq_out = static_cast<__nv_bfloat16*>(p.dq);
  constexpr int H2 = HD / 2, HJ = HD / 16;  // hd/2 is HJ blocks of 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qrow + 8 * i;
    if (qi >= p.Sq) continue;
    const size_t base = ((size_t)(b * p.Sq + qi) * p.H + h) * HD;
#pragma unroll
    for (int j = 0; j < HJ; ++j) {
      // columns c and c + hd/2 of one row sit in this thread
      float x1[2], x2[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        x1[c] = dq[4 * j + 2 * i + c] * p.scale;
        x2[c] = dq[4 * (j + HJ) + 2 * i + c] * p.scale;
        if (p.rope) {
          const size_t t = (size_t)qi * H2 + 8 * j + col0 + c;
          rotate(x1[c], x2[c], p.cos[t], p.sin[t], true, x1[c], x2[c]);
        }
      }
      *reinterpret_cast<uint32_t*>(dq_out + base + 8 * j + col0) =
          pack_bf16(x1[0], x1[1]);
      *reinterpret_cast<uint32_t*>(dq_out + base + H2 + 8 * j + col0) =
          pack_bf16(x2[0], x2[1]);
    }
  }
}

// ---- tensor-core launchers ---------------------------------------------------

// Threads for a block that walks the (d, d + hd/2) pairs of `heads` rows.
int pair_threads(int heads, int hd) {
  return heads * hd / 2 < 256 ? heads * hd / 2 : 256;
}

// q_rot / k_rot = the rotated q / k (the tensor-core kernels read these).
template <int HD>
cudaError_t rope_prepass(const Params& p, cudaStream_t st) {
  using T = __nv_bfloat16;
  flash_rope_kernel<T, HD><<<dim3(p.Sq, p.B), pair_threads(p.H, HD), 0, st>>>(
      static_cast<const T*>(p.q), static_cast<T*>(p.q_rot), p.cos, p.sin,
      p.Sq, p.H);
  flash_rope_kernel<T, HD><<<dim3(p.Sk, p.B), pair_threads(p.KV, HD), 0, st>>>(
      static_cast<const T*>(p.k), static_cast<T*>(p.k_rot), p.cos, p.sin,
      p.Sk, p.KV);
  return cudaGetLastError();
}

template <typename K>
cudaError_t launch_tc(K kernel, dim3 grid, int threads, size_t smem,
                      cudaStream_t st, const TcMaps& maps, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(maps, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fwd_tc(const Params& p, cudaStream_t st) {
  if (p.rope && (p.q_rot == nullptr || p.k_rot == nullptr))
    return cudaErrorInvalidValue;
  if (p.rope) {
    const cudaError_t err = rope_prepass<HD>(p, st);
    if (err != cudaSuccess) return err;
  }
  constexpr int BQ = 64 * fwd_tc_wgs<HD>(), BK = TcFwdBK<HD>::value;
  TcMaps maps{};
  if (!encode_map(&maps.q, p.rope ? p.q_rot : p.q, p.B, p.Sq, p.H, HD, BQ) ||
      !encode_map(&maps.k, p.rope ? p.k_rot : p.k, p.B, p.Sk, p.KV, HD, BK) ||
      !encode_map(&maps.v, p.v, p.B, p.Sk, p.KV, HD, BK))
    return cudaErrorInvalidValue;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  return launch_tc(flash_fwd_tc_kernel<HD>, grid, fwd_tc_threads<HD>(),
                   fwd_tc_smem_bytes<HD>(), st, maps, p);
}

// The tensor-core backward's pre-passes (rotated q / k under rope, the
// {lse, D} stats, the fused route's zeroed dq workspace) and its tensor
// maps: q / dout boxes of q_rows rows, k / v boxes of k_rows.
template <int HD>
cudaError_t bwd_tc_prepare(const Params& p, cudaStream_t st, TcMaps& maps,
                           int q_rows, int k_rows) {
  if (p.stats == nullptr ||
      (p.rope && (p.q_rot == nullptr || p.k_rot == nullptr)))
    return cudaErrorInvalidValue;
  if (p.rope) {
    const cudaError_t err = rope_prepass<HD>(p, st);
    if (err != cudaSuccess) return err;
  }
  flash_bwd_prep_kernel<HD><<<dim3(p.sq_pad / 8, p.B * p.H), 256, 0, st>>>(p);
  if (!encode_map(&maps.q, p.rope ? p.q_rot : p.q, p.B, p.Sq, p.H, HD,
                  q_rows) ||
      !encode_map(&maps.k, p.rope ? p.k_rot : p.k, p.B, p.Sk, p.KV, HD,
                  k_rows) ||
      !encode_map(&maps.v, p.v, p.B, p.Sk, p.KV, HD, k_rows) ||
      !encode_map(&maps.dout, p.dout, p.B, p.Sq, p.H, HD, q_rows))
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_fused_tc(const Params& p, cudaStream_t st) {
  if (p.dq_ws == nullptr) return cudaErrorInvalidValue;
  TcMaps maps{};
  cudaError_t err = bwd_tc_prepare<HD>(p, st, maps, kTcBwdBQ, kTcBwdBK);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + kTcBwdBK - 1) / kTcBwdBK, p.B * p.KV);
  err = launch_tc(flash_bwd_tc_kernel<HD, true>, grid, kTcThreads,
                  bwd_tc_smem_bytes<HD, true>(), st, maps, p);
  if (err != cudaSuccess) return err;
  flash_dq_finish_kernel<__nv_bfloat16, HD, true>
      <<<dim3(p.Sq, p.B), pair_threads(p.H, HD), 0, st>>>(p);
  return cudaGetLastError();
}

// hd 256: one CTA per (b, q-head, 64 keys), the dk / dv group sums in
// p.dkv_ws (zeroed here), then both finishing kernels.
template <>
cudaError_t launch_bwd_fused_tc<256>(const Params& p, cudaStream_t st) {
  using T = __nv_bfloat16;
  if (p.dq_ws == nullptr || p.dkv_ws == nullptr ||
      p.sk_pad / kTc256BK > 65535)
    return cudaErrorInvalidValue;
  TcMaps maps{};
  cudaError_t err = bwd_tc_prepare<256>(p, st, maps, kTcBwdBQ, kTc256BK);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(p.dkv_ws, 0,
                        2 * (size_t)p.B * p.KV * p.sk_pad * 256 * 4, st);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, p.sk_pad / kTc256BK);
  err = launch_tc(flash_bwd_tc_kernel<256, true>, grid, kTcThreads,
                  bwd_tc256_smem_bytes<true>(), st, maps, p);
  if (err != cudaSuccess) return err;
  flash_dq_finish_kernel<T, 256, true, true>
      <<<dim3(p.Sq, p.B), pair_threads(p.H, 256), 0, st>>>(p);
  flash_dkv_finish_kernel<256>
      <<<dim3(p.Sk, p.B), pair_threads(p.KV, 256), 0, st>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_dq_tc(const Params& p, cudaStream_t st) {
  constexpr int BQ = 64 * TcDqWGs<HD>::value;
  TcMaps maps{};
  const cudaError_t err =
      bwd_tc_prepare<HD>(p, st, maps, BQ, TcDqBK<HD>::value);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  return launch_tc(flash_bwd_dq_tc_kernel<HD>, grid, dq_tc_threads<HD>(),
                   dq_tc_smem_bytes<HD>(), st, maps, p);
}

template <int HD>
cudaError_t launch_bwd_dkdv_tc(const Params& p, cudaStream_t st) {
  TcMaps maps{};
  const cudaError_t err =
      bwd_tc_prepare<HD>(p, st, maps, kTcBwdBQ, kTcBwdBK);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + kTcBwdBK - 1) / kTcBwdBK, p.B * p.H);
  return launch_tc(flash_bwd_tc_kernel<HD, false>, grid, kTcThreads,
                   bwd_tc_smem_bytes<HD, false>(), st, maps, p);
}

// hd 256: one CTA per (b, q-head, 64 keys), writing that head's dk_h /
// dv_h itself (no workspace, no finishing kernel).
template <>
cudaError_t launch_bwd_dkdv_tc<256>(const Params& p, cudaStream_t st) {
  const int key_tiles = (p.Sk + kTc256BK - 1) / kTc256BK;
  if (key_tiles > 65535) return cudaErrorInvalidValue;
  TcMaps maps{};
  const cudaError_t err = bwd_tc_prepare<256>(p, st, maps, kTcBwdBQ, kTc256BK);
  if (err != cudaSuccess) return err;
  return launch_tc(flash_bwd_tc_kernel<256, false>,
                   dim3(p.B * p.H, key_tiles), kTcThreads,
                   bwd_tc256_smem_bytes<false>(), st, maps, p);
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
  flash_dq_finish_kernel<T, HD, false>
      <<<dim3(p.Sq, p.B), pair_threads(p.H, HD), 0, st>>>(p);
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

template <typename T, int HD>
cudaError_t launch(Which w, const Params& p, cudaStream_t st) {
  switch (w) {
    case kFwd:
      if constexpr (TcRoute<kFwd, T, HD>::value) return launch_fwd_tc<HD>(p, st);
      else return launch_fwd<T, HD>(p, st);
    case kBwdFused:
      if constexpr (TcRoute<kBwdFused, T, HD>::value)
        return launch_bwd_fused_tc<HD>(p, st);
      else return launch_bwd_fused<T, HD>(p, st);
    case kBwdDq:
      if constexpr (TcRoute<kBwdDq, T, HD>::value)
        return launch_bwd_dq_tc<HD>(p, st);
      else return launch_bwd_dq<T, HD>(p, st);
    case kBwdDkdv:
      if constexpr (TcRoute<kBwdDkdv, T, HD>::value)
        return launch_bwd_dkdv_tc<HD>(p, st);
      else return launch_bwd_dkdv<T, HD>(p, st);
  }
  return cudaErrorInvalidValue;
}

// 1 where operator w launches its tensor-core kernel at (T, HD) (its case
// of launch() reads the same TcRoute), 0 where its CUDA-core one.
template <typename T, int HD>
int route_of(Which w) {
  switch (w) {
    case kFwd: return TcRoute<kFwd, T, HD>::value;
    case kBwdFused: return TcRoute<kBwdFused, T, HD>::value;
    case kBwdDq: return TcRoute<kBwdDq, T, HD>::value;
    case kBwdDkdv: return TcRoute<kBwdDkdv, T, HD>::value;
  }
  return -1;
}

// -1 for a head width (or an operator) with no kernel.
template <typename T>
int route_hd(Which w, int hd) {
  switch (hd) {
    case 16:
      return route_of<T, 16>(w);
    case 32:
      return route_of<T, 32>(w);
    case 64:
      return route_of<T, 64>(w);
    case 128:
      return route_of<T, 128>(w);
    case 256:
      return route_of<T, 256>(w);
  }
  return -1;
}

template <typename T>
int dispatch_hd(Which w, const Params& p, int hd, cudaStream_t st) {
  switch (hd) {
    case 16:
      return (int)launch<T, 16>(w, p, st);
    case 32:
      return (int)launch<T, 32>(w, p, st);
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

// q_rot / k_rot: the tensor-core route's rotated-q/k workspaces (shaped as
// q / k; with rope only, else null).
extern "C" int kdl_flash_fwd(const void* q, const void* k, const void* v,
                             const void* cos, const void* sin, void* out,
                             void* lse, void* q_rot, void* k_rot, int B,
                             int Sq, int Sk, int H, int KV, int hd,
                             int causal, int rope, int dtype, void* stream) {
  Params p = make_params(q, k, v, cos, sin, B, Sq, Sk, H, KV, hd, causal, rope);
  p.o = out;
  p.lse_out = static_cast<float*>(lse);
  p.q_rot = q_rot;
  p.k_rot = k_rot;
  return dispatch(kFwd, p, hd, dtype, stream);
}

// Workspaces by route. Tensor cores: q_rot / k_rot (rope only, else null),
// stats float32 [B, H, sq_pad, 2] and dq_ws float32 [B, H, sq_pad, hd],
// sq_pad = Sq rounded up to 64, neither initialised; at hd 256 also
// dkv_ws float32 [2, B, KV, sk_pad, hd], sk_pad = Sk rounded up to 64,
// not initialised (null at hd 64 / 128). CUDA cores: q_rot, k_rot, stats
// and dkv_ws null, dq_ws float32 [B, Sq, H, hd] zeroed.
extern "C" int kdl_flash_bwd_fused(
    const void* q, const void* k, const void* v, const void* cos,
    const void* sin, const void* out, const void* lse, const void* dout,
    void* q_rot, void* k_rot, void* stats, void* dq_ws, void* dkv_ws,
    void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
    int hd, int causal, int rope, int dtype, void* stream) {
  Params p = make_params(q, k, v, cos, sin, B, Sq, Sk, H, KV, hd, causal, rope);
  p.out = out;
  p.lse = static_cast<const float*>(lse);
  p.dout = dout;
  p.q_rot = q_rot;
  p.k_rot = k_rot;
  p.stats = static_cast<float*>(stats);
  p.sq_pad = (Sq + kTcBwdBQ - 1) / kTcBwdBQ * kTcBwdBQ;
  p.sk_pad = (Sk + kTc256BK - 1) / kTc256BK * kTc256BK;
  p.dq_ws = static_cast<float*>(dq_ws);
  p.dkv_ws = static_cast<float*>(dkv_ws);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  return dispatch(kBwdFused, p, hd, dtype, stream);
}

// The split pair's workspaces by route. Tensor cores: q_rot / k_rot
// (rope only, else null) and stats float32 [B, H, sq_pad, 2] (sq_pad = Sq
// rounded up to 64, written by the pre-pass). CUDA cores: all three null.
extern "C" int kdl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* cos, const void* sin,
                                const void* out, const void* lse,
                                const void* dout, void* q_rot, void* k_rot,
                                void* stats, void* dq, int B, int Sq, int Sk,
                                int H, int KV, int hd, int causal, int rope,
                                int dtype, void* stream) {
  Params p = make_params(q, k, v, cos, sin, B, Sq, Sk, H, KV, hd, causal, rope);
  p.out = out;
  p.lse = static_cast<const float*>(lse);
  p.dout = dout;
  p.q_rot = q_rot;
  p.k_rot = k_rot;
  p.stats = static_cast<float*>(stats);
  p.sq_pad = (Sq + kTcBwdBQ - 1) / kTcBwdBQ * kTcBwdBQ;
  p.dq = dq;
  return dispatch(kBwdDq, p, hd, dtype, stream);
}

extern "C" int kdl_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* cos, const void* sin,
                                  const void* out, const void* lse,
                                  const void* dout, void* q_rot, void* k_rot,
                                  void* stats, void* dk_h, void* dv_h, int B,
                                  int Sq, int Sk, int H, int KV, int hd,
                                  int causal, int rope, int dtype,
                                  void* stream) {
  Params p = make_params(q, k, v, cos, sin, B, Sq, Sk, H, KV, hd, causal, rope);
  p.out = out;
  p.lse = static_cast<const float*>(lse);
  p.dout = dout;
  p.q_rot = q_rot;
  p.k_rot = k_rot;
  p.stats = static_cast<float*>(stats);
  p.sq_pad = (Sq + kTcBwdBQ - 1) / kTcBwdBQ * kTcBwdBQ;
  p.dk = dk_h;
  p.dv = dv_h;
  return dispatch(kBwdDkdv, p, hd, dtype, stream);
}

// The static route table as the launches read it: 1 = tensor cores,
// 0 = CUDA cores, -1 = no kernel; op: 0 flash_fwd, 1 flash_bwd_fused,
// 2 flash_bwd_dq, 3 flash_bwd_dkdv; dtype: 1 bf16, 0 float32.
extern "C" int kdl_flash_route(int op, int dtype, int hd) {
  if (op < kFwd || op > kBwdDkdv) return -1;
  const Which w = static_cast<Which>(op);
  return dtype == 1 ? route_hd<__nv_bfloat16>(w, hd) : route_hd<float>(w, hd);
}
