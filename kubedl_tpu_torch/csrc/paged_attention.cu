// Paged attention over a KV block pool, for NVIDIA Hopper (sm_90a).
//
// Replaces the two TPU Pallas kernels of kubedl_tpu/models/paged_attention.py:
//
//   kdl_paged_attention_blocked  <- _blocked_kernel (:181, _pallas_paged_attention)
//       S queries per row against the pool through the block table; every
//       chunked-prefill chunk runs it.
//   kdl_paged_attention_fused    <- _fused_kernel (:290, _pallas_paged_attention_fused)
//       the decode step (S=1) with this step's K/V write fused in; every
//       decode step with kv_attention="blocked" runs it.
//
// Layouts (all contiguous): q/out [B, S, H, hd]; pools [NB, BS, KV, hd]
// (one layer); bt [B, MB] int32; starts [B] int32; new_k/new_v [B, KV, hd].
// Query row r = s*group + u of kv-head g is head g*group + u at sequence
// index s (GQA folded into rows, as the TPU kernel folds it); R = S*group.
//
// Numerics (the reference's contract, kept by every route): query s sees
// keys at logical positions t <= min(starts[b] + s, MB*BS - 1); scores are
// scaled by (1/sqrt(hd))*log2(e) and folded in base 2; masked scores are
// -1e30 and the running max is clamped at -1e29, so a fully masked key
// tile (or an empty split) adds exact zeros; sums are float32; out =
// acc / max(l, 1e-30) in q's dtype.
//
// Four designs, chosen statically (route_of below; the Python side's
// models/paged_attention.py::paged_route mirrors it). There is no fallback
// between them: a refused launch returns its error.
//
// (a) Split-K (paged_split_kernel + paged_combine_kernel): every fused
//     decode call, and any blocked call with R < 64, that route (d) does
//     not take (float32, hd 64 / 128). Decode reads each
//     attended K/V position once and does 4*hd flops per (query head, key):
//     it is bound by BYTES (Llama-3-8B, B=8: ~12 MB, 3.6 us at 3.35 TB/s,
//     below one launch's latency). The fix is parallelism over the key
//     range and bytes in flight, not the tensor cores: a 64-row wgmma tile
//     would be >90 % idle at 4-8 query rows, so this route stays on the
//     CUDA cores (float32 FMAs on bf16 or f32 data).
//     - Grid (B, KV * row chunks, NSPLIT). NSPLIT and the split length L
//       are fixed by the host from MB*BS and B*KV alone (the wrapper reads
//       no device value, so a decode segment never syncs); CTA `split`
//       takes keys [split*L, min((split+1)*L, n_keys)), n_keys =
//       min(starts[b] + S - 1, MB*BS - 1) + 1. A CTA whose range is empty
//       writes an empty partial (m = -1e29, l = 0, acc = 0).
//     - K/V go through the block table with cp.async 16-byte copies into
//       a ring of 4 stages of 4 KB of K (and of V) each, kept in the
//       input type in shared memory (no float32 staging copy): three
//       tiles are in flight while one is consumed, one barrier a tile.
//     - Lanes split a key's hd elements (16 bytes a lane); each warp works
//       on whole keys, 1-4 keys a pass, with a warp-level dot product
//       against up to 8 query rows whose scaled values live in registers.
//       Per stage each lane group folds its keys into its own online
//       softmax state; lane groups, then warps (through shared memory)
//       are merged at the end into one partial per row.
//     - Partials (acc[hd], m, l; float32) go to a workspace the wrapper
//       allocates, [B, KV, NSPLIT, R, hd + 2]; paged_combine_kernel merges
//       the splits a row used with the same clamp (the rest would add
//       exact zeros) and writes out in q's type.
//     - Fused write: the one CTA whose range holds starts[b] takes that
//       position's K/V from new_k/new_v (never from the pool) and, after
//       its reads, writes the pool slot (bt[b, starts/BS], starts % BS) as
//       a plain copy (bit-identical to a scatter). No other CTA of the row
//       reads that slot; vacant rows all point at the trash block 0, where
//       colliding writes are allowed.
// (b) Tensor cores (paged_prefill_tc_kernel<HD>): bf16 at hd 64, 128 and
//     256, R >= 64, BS a multiple of 8 dividing 64 and group dividing 64.
//     A prefill chunk of 512 tokens is bound by OPERATIONS, which only
//     wgmma reaches: Llama-3-8B (B=8) ~41 GFLOP against ~100 MB of q, out
//     and attended K/V (0.042 ms of bf16 operations, 0.029 ms of bytes);
//     Gemma-2B (B=8, MQA, hd 256) ~21 GFLOP against ~41 MB (0.021 ms
//     against 0.012). The structure of flash_fwd_tc_kernel with the key
//     stream gathered through the block table:
//     - One CTA per (b, kv-head g, BQ folded query rows): WGS consumer
//       warpgroups of 64 rows and a producer. At hd 64 / 128, WGS = 3
//       (BQ = 192) and the producer is one warp. At hd 256 a consumer
//       thread holds O as 128 float32 registers beside the 32 of a score
//       tile and the 16 of P's A fragments, more than the 152 a thread of
//       416 gets (or the 168 of 288: registers are split between the SM's
//       four quarters, warp by warp). So WGS = 2 (BQ = 128) and the
//       producer is a whole warpgroup: launched at 168 registers a thread,
//       it keeps 24 (setmaxnreg.dec) and the consumers take 240
//       (setmaxnreg.inc). Shared memory at hd 256: 64 KB of Q and two
//       stages of K and V at 32 KB each, 193 KB with the bt row; a third
//       stage would not fit.
//     - The Q tile is one TMA box per 64-column panel over q viewed as
//       [B, S, H, hd]: (64 columns, the group's heads, BQ/group
//       positions), 128-byte swizzled; its lines land in row order r.
//     - A 64-key K/V tile is 64/BS pool blocks; each block is one TMA copy
//       per panel over a 4-D map of the layer's pool [NB, BS, KV, hd] (box
//       1 x BS x 1 x 64) at bt[b, j], 1024-byte aligned in the stage, so
//       the blocks assemble the same swizzled tile as one box would. Two
//       stages with full/empty mbarriers; the producer warp reads the bt
//       row into shared memory first. The maps are encoded per call (a
//       layer's pool is a view with its own base) and passed as
//       __grid_constant__.
//     - S = Q.K^T is a wgmma m64n64k16 with a K-major B operand, hd/16
//       steps across the hd/64 panels of Q and K; the online softmax runs
//       on the accumulator layout; P is rounded to bf16 straight into the
//       register A operand of O += P.V (as the reference rounds p to v's
//       type), one wgmma m64n(hd)k16 a 16-key step with V read MN-major
//       across its hd/64 panels (the descriptor's leading offset is the
//       panel stride). l sums the unrounded P.
//     - Tiles past the CTA's last visible key are never loaded (exact:
//       every row sees key 0); tiles below the warpgroup's first row's
//       position take no mask.
//     - Grid (row tiles, B * KV), the row tiles in reverse: a (b, g)'s
//       tiles that see the most keys start first, and a wave holds few
//       (b, g) pairs, whose K/V stay in L2 while their tiles run.
// (c) CUDA cores (paged_attention_kernel): float32 prefill (R >= 64), and
//     any BS or group the tensor-core route does not take. One CTA owns
//     (row b, kv-head g, 64 query rows) and loops over the row's keys
//     inside the CTA: 32 keys at a time staged in shared memory as
//     float32, shared by all query rows of the CTA; a half-warp owns one
//     query row at a time (each lane 2 staged keys in the score pass,
//     hd/16 output dims in the P.V pass). It stops at the CTA's last
//     needed key, exactly.
// (d) Tensor-core decode (paged_decode_mma_kernel<RT>): bf16 at hd 256
//     with R < 64, fused or not: every Gemma-2B decode step and the
//     blocked calls of its speculative verify (S = 5: R = 40). Bound by
//     BYTES (Gemma-2B, B=8, MB 128: 3.1 MB, 0.92 us at 3.35 TB/s), but one
//     SM streams only a small share of that rate (traced on the card with
//     scripts/paged_decode_trace.py's instrumentation), by 16-byte
//     cp.async or by bulk copies (slower still at a 512-byte row each), so
//     a row's keys must be spread over many SMs, and so must its merge:
//     - Grid (nsplit, B * KV), nsplit fixed by the host from MB*BS and
//       B*KV alone (about three CTAs an SM; no device read, so decode
//       never syncs) and lowered by the launch to what the card holds at
//       once. Row (b, g) has n = min(starts[b] + S - 1, MB*BS - 1) + 1
//       keys, read on the device, and uses u = min(nsplit, ceil(n /
//       split_keys)) CTAs: CTA i < u takes keys [i*n/u, (i+1)*n/u); a CTA
//       past u exits at once and writes nothing.
//     - K/V go through the block table with cp.async 16-byte copies (a
//       warp a key row) into a ring of two 32-key stages, XOR-swizzled by
//       16-byte chunk so that ldmatrix reads eight rows without bank
//       conflicts; the block table row is read beside starts[b].
//     - Both products on mma.sync m16n8k16 (bf16 in, float32 sums),
//       swapped so that the R <= 64 query rows are the n8 side (RT n8
//       tiles, R padded to 8*RT with zero rows). S^T[16 keys x 8RT] =
//       K_tile . Q^T: each of a stage's two 16-key tiles is split over
//       four warps by hd quarter (Q^T's fragments for the quarter held in
//       registers up to RT = 4), the quarters summed through shared
//       memory by the tile's owner. The stage's maximum is shared through
//       shared memory, P = exp2(S - m) is rounded to bf16 (the reference rounds
//       p to v's type; l sums the unrounded P) and moved from the
//       accumulator layout to the B-operand layout by movmatrix.trans into
//       a shared [8RT][32] tile. Then O^T[hd x 8RT] += V^T . P^T, V^T's
//       fragments by ldmatrix.trans from V as staged: each of the eight
//       warps owns 32 rows of O^T for all keys (8*RT float32 registers a
//       thread), so no O is merged across warps. Splitting keys over
//       warps instead would hold all 256 rows of O^T in every warp: 64*RT
//       registers a thread, 320 at verify's R = 40. Fragment loads are
//       issued a step ahead of their mma.
//     - The merge is in the same launch. A row of one CTA writes out
//       directly. Otherwise each CTA writes its partial (acc[hd], m, l;
//       float32) to a workspace that persists per (device, stream) and
//       arrives on the row's counter (a release); the launch is
//       cooperative (all CTAs resident), so each CTA then waits for the
//       row's u arrivals and merges 1/u of the row's output from all u
//       partials with the -1e29 clamp (a thread folds its splits online,
//       then the split groups are folded in order: an order fixed by the
//       shapes, so deterministic). The last CTA to stop waiting resets
//       the row's counters to 0 for the next launch. A single CTA merging
//       all u partials would read them at one SM's rate.
//     - Fused write: the CTA whose range holds starts[b] takes that
//       position's K/V from new_k/new_v and writes the pool slot after its
//       reads, as in (a).
//
// C interface (bound with ctypes): each entry point launches on the given
// stream, allocates nothing (the split-K and tensor-core decode workspaces
// come from the caller) and returns cudaGetLastError(), or cudaErrorInvalidValue for arguments
// it refuses.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMaxFloor = -1e29f;
constexpr float kLog2e = 1.4426950408889634f;

// ---- the static route (mirrors models/paged_attention.py::paged_route) --------

enum Route { kSplitK = 0, kTensorCore = 1, kCudaCore = 2, kMmaDecode = 3 };

constexpr int kTcTileKeys = 64;  // tensor-core route: keys per K/V tile

int route_of(int dtype, int hd, int S, int group, int BS, bool fused) {
  if (dtype == 1 && hd == 256 && S * group < 64) return kMmaDecode;
  if (fused || S * group < 64) return kSplitK;
  if (dtype == 1 && (hd == 64 || hd == 128 || hd == 256) && BS > 0 &&
      BS % 8 == 0 && kTcTileKeys % BS == 0 && group > 0 &&
      kTcTileKeys % group == 0)
    return kTensorCore;
  return kCudaCore;
}

// ---- element helpers -----------------------------------------------------------

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

// 16 bytes global -> shared, asynchronously; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- (a) split-K -------------------------------------------------------------

constexpr int kSplitWarps = 4;
constexpr int kSplitStages = 4;

template <typename T>
struct SplitArgs {
  const T* q;
  const T* k_pool;
  const T* v_pool;
  T* k_pool_w;
  T* v_pool_w;
  const int* bt;
  const int* starts;
  const T* new_k;
  const T* new_v;
  float* ws;  // [B, KV, nsplit, R, HD + 2]: acc[HD], m, l
  T* out;
  int S, H, KV, BS, MB, group, R, nsplit, split_len;
  float scale_log2;
};

// How a warp covers keys of width HD in type T.
template <typename T, int HD>
struct SplitShape {
  static constexpr int VN = Vec<T>::n;                       // elements a vector
  static constexpr int LPK = HD / VN < 32 ? HD / VN : 32;    // lanes a key
  static constexpr int NV = HD / (LPK * VN);                 // vectors a lane
  static constexpr int EPL = NV * VN;                        // elements a lane
  static constexpr int KPP = 32 / LPK;                       // keys a warp pass
  static constexpr int TK = 4096 / (HD * (int)sizeof(T));    // keys a stage
  static constexpr int KPT = TK / (kSplitWarps * KPP);       // keys a lane group a stage
  static constexpr int CPK = HD * (int)sizeof(T) / 16;       // 16-byte chunks a key
  static_assert(KPT >= 1 && TK % (kSplitWarps * KPP) == 0, "split tile");
};

// Split lengths are multiples of this (so of every TK).
constexpr int kSplitQuantum = 32;

template <typename T, int HD, int RW>
size_t split_smem_bytes(int split_len, int BS) {
  using Sh = SplitShape<T, HD>;
  const size_t ring = 2 * (size_t)kSplitStages * Sh::TK * HD * sizeof(T);
  const size_t red = (size_t)kSplitWarps * RW * (HD + 2) * sizeof(float);
  return (ring > red ? ring : red) + sizeof(int) * (size_t)(split_len / BS + 2);
}

// CTA (b, g * row chunks + rc, split): query rows [rc*RW, rc*RW + RW) of
// kv-head g against keys [split*L, min(split*L + L, n_keys)).
template <typename T, int HD, int RW, bool FUSED>
__global__ void __launch_bounds__(kSplitWarps * 32)
    paged_split_kernel(const SplitArgs<T> a) {
  using Sh = SplitShape<T, HD>;
  constexpr int VN = Sh::VN, LPK = Sh::LPK, NV = Sh::NV, EPL = Sh::EPL;
  constexpr int KPP = Sh::KPP, TK = Sh::TK, KPT = Sh::KPT, CPK = Sh::CPK;
  constexpr int ST = kSplitStages, NT = kSplitWarps * 32;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [ST][TK][HD]
  T* sV = sK + ST * TK * HD;               // [ST][TK][HD]
  float* red = reinterpret_cast<float*>(smem_raw);  // after the loop: [warps][RW][HD + 2]
  constexpr size_t kRing = 2 * (size_t)ST * TK * HD * sizeof(T);
  constexpr size_t kRed = (size_t)kSplitWarps * RW * (HD + 2) * sizeof(float);
  int* sbt = reinterpret_cast<int*>(smem_raw + (kRing > kRed ? kRing : kRed));

  const int b = blockIdx.x;
  const int n_rc = (a.R + RW - 1) / RW;
  const int g = blockIdx.y / n_rc, rc = blockIdx.y - g * n_rc;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lg = lane / LPK, lig = lane % LPK;
  const int max_s = a.MB * a.BS;
  const int start = a.starts[b];
  const int n_keys = min(start + a.S - 1, max_s - 1) + 1;
  const int lo = split * a.split_len;
  const int hi = min(lo + a.split_len, n_keys);
  const int r0 = rc * RW;
  const int nrows = min(RW, a.R - r0);
  float* part =
      a.ws + (((size_t)(b * a.KV + g) * a.nsplit + split) * a.R + r0) * (HD + 2);

  if (hi <= lo) {  // empty range: the partial that adds exact zeros
    for (int i = tid; i < nrows * (HD + 2); i += NT)
      part[i] = i % (HD + 2) == HD ? kMaxFloor : 0.f;
    return;
  }
  const int j0 = lo / a.BS;
  const int nb = (hi - 1) / a.BS - j0 + 1;
  for (int i = tid; i < nb; i += NT) sbt[i] = a.bt[(size_t)b * a.MB + j0 + i];
  __syncthreads();

  const size_t new_off = ((size_t)b * a.KV + g) * HD;
  auto issue = [&](int kt) {
    const int t0 = lo + kt * TK;
    T* dk = sK + (kt % ST) * TK * HD;
    T* dv = sV + (kt % ST) * TK * HD;
    for (int c = tid; c < TK * CPK; c += NT) {
      const int kk = c / CPK, off = (c - kk * CPK) * VN;
      const int t = t0 + kk;
      const T* ks = a.k_pool;
      const T* vs = a.v_pool;
      int bytes = 0;
      if (t < hi) {
        bytes = 16;
        if (FUSED && t == start) {
          ks = a.new_k + new_off + off;
          vs = a.new_v + new_off + off;
        } else {
          const int blk = sbt[t / a.BS - j0];
          const size_t o = (((size_t)blk * a.BS + t % a.BS) * a.KV + g) * HD + off;
          ks = a.k_pool + o;
          vs = a.v_pool + o;
        }
      }
      cp_async16(dk + kk * HD + off, ks, bytes);
      cp_async16(dv + kk * HD + off, vs, bytes);
    }
    cp_async_commit();
  };

  const int n_t = (hi - lo + TK - 1) / TK;
#pragma unroll
  for (int kt = 0; kt < ST - 1; ++kt) {
    if (kt < n_t) issue(kt);
    else cp_async_commit();
  }

  // this lane's slice of each row's query, pre-scaled into the base-2 domain
  float qr[RW][EPL];
  int qpos[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int r = r0 + min(j, nrows - 1), s = r / a.group, u = r - s * a.group;
    qpos[j] = min(start + s, max_s - 1);
    const T* qp = a.q + (((size_t)b * a.S + s) * a.H + g * a.group + u) * HD;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      load_vec(qp + (v * LPK + lig) * VN, &qr[j][v * VN]);
#pragma unroll
      for (int e = 0; e < VN; ++e) qr[j][v * VN + e] *= a.scale_log2;
    }
  }
  float m[RW], l[RW], acc[RW][EPL];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    m[j] = kMaxFloor;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[j][e] = 0.f;
  }

  for (int kt = 0; kt < n_t; ++kt) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // tile kt landed for all; tile kt-1's stage is free
    if (kt + ST - 1 < n_t) issue(kt + ST - 1);
    else cp_async_commit();
    const T* tk = sK + (kt % ST) * TK * HD;
    const T* tv = sV + (kt % ST) * TK * HD;
    const int t0 = lo + kt * TK;
    float sc[KPT][RW];
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kk = warp * KPP + lg + i * (kSplitWarps * KPP);
      float kf[EPL];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        load_vec(tk + kk * HD + (v * LPK + lig) * VN, &kf[v * VN]);
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[j][e], kf[e], dot);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[i][j] = t0 + kk <= qpos[j] ? dot : kNegInf;
      }
    }
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      float mloc = sc[0][j];
#pragma unroll
      for (int i = 1; i < KPT; ++i) mloc = fmaxf(mloc, sc[i][j]);
      const float m_new = fmaxf(fmaxf(m[j], mloc), kMaxFloor);
      const float corr = exp2f(m[j] - m_new);
      m[j] = m_new;
      l[j] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[j][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kk = warp * KPP + lg + i * (kSplitWarps * KPP);
      float vf[EPL];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        load_vec(tv + kk * HD + (v * LPK + lig) * VN, &vf[v * VN]);
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const float p = exp2f(sc[i][j] - m[j]);
        l[j] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[j][e] = fmaf(p, vf[e], acc[j][e]);
      }
    }
  }

  // merge the warp's lane groups (lanes lig of every group hold the same dims)
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[j], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[j], o);
      const float mm = fmaxf(m[j], mo);
      const float c1 = exp2f(m[j] - mm), c2 = exp2f(mo - mm);
      l[j] = l[j] * c1 + lo_ * c2;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[j][e] = acc[j][e] * c1 + __shfl_xor_sync(0xffffffffu, acc[j][e], o) * c2;
      m[j] = mm;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the warps' states
  if (lg == 0) {
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      float* rw = red + (warp * RW + j) * (HD + 2);
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < VN; ++e) rw[(v * LPK + lig) * VN + e] = acc[j][v * VN + e];
      if (lig == 0) {
        rw[HD] = m[j];
        rw[HD + 1] = l[j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * HD; i += NT) {
    const int j = i / HD, d = i - j * HD;
    float mm = kMaxFloor;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      mm = fmaxf(mm, red[(w * RW + j) * (HD + 2) + HD]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float* rw = red + (w * RW + j) * (HD + 2);
      const float c = exp2f(rw[HD] - mm);
      ls += rw[HD + 1] * c;
      as += rw[d] * c;
    }
    float* pr = part + (size_t)j * (HD + 2);
    pr[d] = as;
    if (d == 0) {
      pr[HD] = mm;
      pr[HD + 1] = ls;
    }
  }

  if (FUSED && rc == 0 && start >= lo && start < hi) {
    // this CTA alone holds position `start`; its reads are done
    const int blk = sbt[start / a.BS - j0];
    const size_t dst = (((size_t)blk * a.BS + start % a.BS) * a.KV + g) * HD;
    for (int d = tid; d < HD; d += NT) {
      a.k_pool_w[dst + d] = a.new_k[new_off + d];
      a.v_pool_w[dst + d] = a.new_v[new_off + d];
    }
  }
}

// One warp per (b, g, r): merge the splits that row's CTAs covered (the
// rest are empty partials, exact zeros) and write out in q's type.
template <typename T, int HD>
__global__ void __launch_bounds__(128)
    paged_combine_kernel(const SplitArgs<T> a, int B) {
  constexpr int EL = HD / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + warp;  // (b * KV + g) * R + r
  if (row >= B * a.KV * a.R) return;
  const int r = row % a.R, bg = row / a.R, g = bg % a.KV, b = bg / a.KV;
  const int max_s = a.MB * a.BS;
  const int n_keys = min(a.starts[b] + a.S - 1, max_s - 1) + 1;
  const int n_used = min(a.nsplit, (n_keys + a.split_len - 1) / a.split_len);
  const size_t stride = (size_t)a.R * (HD + 2);
  const float* p = a.ws + ((size_t)bg * a.nsplit * a.R + r) * (HD + 2);
  float mm = kMaxFloor;
  for (int i = 0; i < n_used; ++i) mm = fmaxf(mm, p[i * stride + HD]);
  float ls = 0.f, acc[EL];
#pragma unroll
  for (int e = 0; e < EL; ++e) acc[e] = 0.f;
  for (int i = 0; i < n_used; ++i) {
    const float* pi = p + i * stride;
    const float c = exp2f(pi[HD] - mm);
    ls += pi[HD + 1] * c;
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[e] = fmaf(pi[lane + 32 * e], c, acc[e]);
  }
  const float lc = fmaxf(ls, 1e-30f);
  const int s = r / a.group, u = r - s * a.group;
  T* o = a.out + (((size_t)b * a.S + s) * a.H + g * a.group + u) * HD;
#pragma unroll
  for (int e = 0; e < EL; ++e) from_f(acc[e] / lc, o + lane + 32 * e);
}

template <typename T, int HD, int RW, bool FUSED>
cudaError_t launch_split_rw(const SplitArgs<T>& a, int B, cudaStream_t st) {
  const size_t smem = split_smem_bytes<T, HD, RW>(a.split_len, a.BS);
  auto kern = paged_split_kernel<T, HD, RW, FUSED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_rc = (a.R + RW - 1) / RW;
  kern<<<dim3(B, a.KV * n_rc, a.nsplit), kSplitWarps * 32, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = B * a.KV * a.R;
  paged_combine_kernel<T, HD><<<(rows + 3) / 4, 128, 0, st>>>(a, B);
  return cudaGetLastError();
}

template <typename T, int HD, bool FUSED>
cudaError_t launch_split(const SplitArgs<T>& a, int B, cudaStream_t st) {
  if (a.ws == nullptr || a.nsplit < 1 || a.split_len < kSplitQuantum ||
      a.split_len % kSplitQuantum != 0 ||
      (long long)a.nsplit * a.split_len < (long long)a.MB * a.BS ||
      a.KV * ((a.R + 7) / 8) > 65535 || a.nsplit > 65535)
    return cudaErrorInvalidValue;
  // rows per CTA: 4 for the usual GQA groups (R <= 4), else 8
  return a.R <= 4 ? launch_split_rw<T, HD, 4, FUSED>(a, B, st)
                  : launch_split_rw<T, HD, 8, FUSED>(a, B, st);
}

// ---- (b) tensor cores --------------------------------------------------------

constexpr int kPfBK = kTcTileKeys;        // keys a tile
constexpr int kPfStages = 2;              // K/V tiles in flight

// consumer warpgroups a CTA, 64 folded query rows each, and the threads
// of the CTA: the consumers and a producer warp, or at hd 256 a producer
// warpgroup that hands its registers to the consumers (see (b) above)
template <int HD>
__host__ __device__ constexpr int pf_wgs() { return HD == 256 ? 2 : 3; }
template <int HD>
__host__ __device__ constexpr int pf_threads() {
  return pf_wgs<HD>() * 128 + (HD == 256 ? 128 : 32);
}
// hd 256: registers a producer / consumer thread keeps after the handover
// (24 x 128 + 240 x 256 = 168 x 384, what the launch bounds allot)
constexpr int kPfProducerRegs = 24, kPfConsumerRegs = 240;

struct PagedMaps {
  CUtensorMap q, k, v;
};

struct TcArgs {
  const int* bt;
  const int* starts;
  __nv_bfloat16* out;
  int S, H, KV, BS, MB, group, R;
  float scale_log2;
};

template <int HD>
constexpr size_t pf_smem_bytes() {
  return 1024 + (size_t)64 * pf_wgs<HD>() * HD * 2 +
         2 * kPfStages * (size_t)kPfBK * HD * 2 + 64;
}

// CTA (reversed row tile, b * KV + g): folded rows r0 .. r0 + BQ - 1 of
// kv-head g.
template <int HD>
__global__ void __launch_bounds__(pf_threads<HD>(), 1)
    paged_prefill_tc_kernel(const __grid_constant__ PagedMaps maps, const TcArgs a) {
  constexpr int WGS = pf_wgs<HD>(), BQ = 64 * WGS, BK = kPfBK;
  constexpr int NP = HD / kPanel, ST = kPfStages;
  constexpr uint32_t kQBytes = BQ * HD * 2, kKBytes = BK * HD * 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);  // [NP panels][BQ rows][128 B]
  uint8_t* sK = sQ + kQBytes;         // [ST stages][NP][BK][128 B]
  uint8_t* sV = sK + ST * kKBytes;
  // q loaded, then per stage: K/V loaded (full), K/V consumed (empty)
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + ST * kKBytes);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + ST;
  int* sbt = reinterpret_cast<int*>(bar_q + 8);  // the reachable bt[b, :]
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  // the rows that see the most keys first, so the last wave is the short tiles
  const int n_z = (a.R + BQ - 1) / BQ;
  const int r0 = (n_z - 1 - (int)blockIdx.x) * BQ;
  const int b = blockIdx.y / a.KV, g = blockIdx.y - b * a.KV;
  const int max_s = a.MB * a.BS;
  const int start = a.starts[b];
  const int s_hi = (min(r0 + BQ, a.R) - 1) / a.group;
  const int n_keys = min(start + s_hi, max_s - 1) + 1;
  const int n_k = (n_keys + BK - 1) / BK;
  const int bpt = BK / a.BS;  // pool blocks a tile
  const int nblk = min(a.MB, n_k * bpt);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WGS * 128);
    }
    fence_barrier_init();
  }
  for (int i = tid; i < nblk; i += blockDim.x) sbt[i] = a.bt[(size_t)b * a.MB + i];
  __syncthreads();
  if (tid >= WGS * 128) {  // the producer warp (warpgroup at hd 256)
    if constexpr (HD == 256) setmaxnreg_dec<kPfProducerRegs>();
    if (tid == WGS * 128) {
      mbar_expect_tx(bar_q, kQBytes);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
        tma_load(sQ + pn * BQ * 128, &maps.q, bar_q, pn * kPanel, g * a.group,
                 r0 / a.group, b);
      for (int kt = 0; kt < n_k; ++kt) {
        const int st = kt % ST;
        if (kt >= ST) mbar_wait(&empty[st], (kt / ST - 1) & 1);
        mbar_expect_tx(&full[st], 2 * kKBytes);
        for (int jb = 0; jb < bpt; ++jb) {
          // past MB (MB*BS not a multiple of 64): any block, fully masked
          const int blk = sbt[min(kt * bpt + jb, a.MB - 1)];
#pragma unroll
          for (int pn = 0; pn < NP; ++pn) {
            const uint32_t off = st * kKBytes + pn * BK * 128 + jb * a.BS * 128;
            tma_load(sK + off, &maps.k, &full[st], pn * kPanel, g, 0, blk);
            tma_load(sV + off, &maps.v, &full[st], pn * kPanel, g, 0, blk);
          }
        }
      }
    }
    return;
  }
  if constexpr (HD == 256) setmaxnreg_inc<kPfConsumerRegs>();
  // this thread's accumulator rows (row0, row0 + 8 of its warpgroup's 64)
  // and columns (col0, col0 + 1 of every 8)
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  const int rr = r0 + 64 * wg + row0;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = min(start + (rr + 8 * i) / a.group, max_s - 1);
  const int qpos_first = min(start + (r0 + 64 * wg) / a.group, max_s - 1);
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
    const bool need_mask = k0 + BK - 1 > qpos_first;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c] * a.scale_log2;
          if (need_mask && k0 + 8 * j + col0 + c > qpos[i]) x = kNegInf;
          s[4 * j + 2 * i + c] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(fmaxf(m_r[i], quad_max(mx[i])), kMaxFloor);
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
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rr + 8 * i;
    if (r >= a.R) continue;
    const float lc = fmaxf(quad_sum(l_r[i]), 1e-30f);
    const int s = r / a.group, u = r - s * a.group;
    __nv_bfloat16* orow =
        a.out + (((size_t)b * a.S + s) * a.H + g * a.group + u) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + col0) =
          pack_bf16(o[4 * j + 2 * i] / lc, o[4 * j + 2 * i + 1] / lc);
  }
}

template <int HD>
cudaError_t launch_prefill_tc(const void* q, const void* k_pool,
                              const void* v_pool, const TcArgs& a, int B,
                              int NB, cudaStream_t st) {
  constexpr int BQ = 64 * pf_wgs<HD>();
  PagedMaps maps{};
  if (!encode_map(&maps.q, q, B, a.S, a.H, HD, BQ / a.group, a.group) ||
      !encode_map(&maps.k, k_pool, NB, a.BS, a.KV, HD, a.BS) ||
      !encode_map(&maps.v, v_pool, NB, a.BS, a.KV, HD, a.BS))
    return cudaErrorInvalidValue;
  if ((long long)B * a.KV > 65535) return cudaErrorInvalidValue;
  const size_t smem = pf_smem_bytes<HD>() + sizeof(int) * (size_t)a.MB;
  auto kern = paged_prefill_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.R + BQ - 1) / BQ, B * a.KV);
  kern<<<grid, pf_threads<HD>(), smem, st>>>(maps, a);
  return cudaGetLastError();
}

// ---- (c) CUDA cores ----------------------------------------------------------

constexpr int kTK = 32;    // keys staged per iteration
constexpr int kHalf = 16;  // lanes per half-warp (one query row at a time)
constexpr int kRowsCta = 64;
constexpr int kRph = 4;    // rows a half-warp owns
constexpr int kCcThreads = kRowsCta / kRph * kHalf;

template <typename T>
struct CcArgs {
  const T* q;
  const T* k_pool;
  const T* v_pool;
  const int* bt;
  const int* starts;
  T* out;
  int S, H, KV, BS, MB, group, R;
  float scale_log2;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kCcThreads)
    paged_attention_kernel(const CcArgs<T> a) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 4;           // padded row stride, floats
  constexpr int CPL = HD / (4 * kHalf);  // float4 output chunks per lane
  constexpr int VN = Vec<T>::n;
  constexpr int KPL = kTK / kHalf;     // keys per lane in the score pass

  const int b = blockIdx.x, g = blockIdx.y;
  const int r0 = blockIdx.z * kRowsCta;
  const int nrows = min(kRowsCta, a.R - r0);
  const int tid = threadIdx.x;
  const int lane = tid & (kHalf - 1);
  const int half = tid / kHalf;
  const int max_s = a.MB * a.BS;
  const int start = a.starts[b];
  const int* btrow = a.bt + (size_t)b * a.MB;

  float* qs = smem;                  // [kRowsCta][LD]
  float* ks = qs + kRowsCta * LD;    // [kTK][LD]
  float* vs = ks + kTK * LD;         // [kTK][LD]
  float* ps = vs + kTK * LD;         // [halves][kTK + 1]

  // this CTA's query rows, pre-scaled into the base-2 domain
  for (int i = tid; i < nrows * (HD / VN); i += kCcThreads) {
    const int rr = i / (HD / VN), d = (i % (HD / VN)) * VN;
    const int r = r0 + rr, s = r / a.group, u = r % a.group;
    float f[VN];
    load_vec(a.q + (((size_t)b * a.S + s) * a.H + g * a.group + u) * HD + d, f);
#pragma unroll
    for (int e = 0; e < VN; ++e) qs[rr * LD + d + e] = f[e] * a.scale_log2;
  }

  float m[kRph], l[kRph], acc[kRph][CPL][4];
#pragma unroll
  for (int j = 0; j < kRph; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][c][e] = 0.f;
  }

  // last key any row of this CTA can see (the early stop is exact: every
  // query sees position 0, so a fully masked tile would change nothing)
  const int s_hi = (r0 + nrows - 1) / a.group;
  const int n_keys = min(start + s_hi, max_s - 1) + 1;

  for (int t0 = 0; t0 < n_keys; t0 += kTK) {
    __syncthreads();  // previous tile fully consumed (and q staged)
    for (int i = tid; i < kTK * (HD / VN); i += kCcThreads) {
      const int kj = i / (HD / VN), d = (i % (HD / VN)) * VN;
      const int t = t0 + kj;
      float kf[VN], vf[VN];
      if (t < n_keys) {
        const int blk = btrow[t / a.BS];
        const size_t o = (((size_t)blk * a.BS + (t % a.BS)) * a.KV + g) * HD + d;
        load_vec(a.k_pool + o, kf);
        load_vec(a.v_pool + o, vf);
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

    // every half runs all kRph iterations (warp-uniform shuffles); rows
    // past nrows compute on a clamped row and never store
#pragma unroll
    for (int j = 0; j < kRph; ++j) {
      const int rr = min(half * kRph + j, nrows - 1);
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
  for (int j = 0; j < kRph; ++j) {
    const int rr = half * kRph + j;
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
}

template <typename T, int HD>
cudaError_t launch_cuda_core(const CcArgs<T>& a, int B, cudaStream_t st) {
  constexpr int LD = HD + 4;
  const size_t smem =
      sizeof(float) * ((size_t)kRowsCta * LD + 2 * kTK * LD +
                       (size_t)(kCcThreads / kHalf) * (kTK + 1));
  auto kern = paged_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, a.KV, (a.R + kRowsCta - 1) / kRowsCta);
  kern<<<grid, kCcThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// ---- (d) tensor-core decode ---------------------------------------------------

constexpr int kMdHD = 256;                   // the route's head width
constexpr int kMdBK = 32;                    // keys a stage
constexpr int kMdStages = 2;                 // stages in the ring
constexpr int kMdTiles = kMdBK / 16;         // 16-key score tiles a stage
constexpr int kMdWarps = 8;
constexpr int kMdQuarters = kMdWarps / kMdTiles;  // hd slices of a tile's scores
constexpr int kMdQStride = kMdHD + 8;        // bf16 a staged query row (528 B)
constexpr int kMdPStride = kMdBK + 8;        // bf16 a staged P row (80 B)
constexpr int kMdMaxSplits = 64;
constexpr int kMdGroups = 8;  // the merge's most split groups a pass

struct MdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k_pool;
  const __nv_bfloat16* v_pool;
  __nv_bfloat16* k_pool_w;
  __nv_bfloat16* v_pool_w;
  const int* bt;
  const int* starts;
  const __nv_bfloat16* new_k;
  const __nv_bfloat16* new_v;
  float* part_acc;  // [B*KV, nsplit, R, HD]
  float* part_ml;   // [B*KV, nsplit, R, 2]: m (base 2), l
  int* counters;    // [B*KV, 2]: arrivals, departures; 0 between launches
  __nv_bfloat16* out;
  int S, H, KV, BS, MB, group, R, nsplit, split_keys;
  bool fused;
  float scale_log2;
};

template <int RT>
size_t md_smem_bytes(int MB) {
  constexpr int RP = 8 * RT;
  return 2 * (size_t)kMdStages * kMdBK * kMdHD * 2 +        // K, V ring
         (size_t)RP * (kMdQStride + kMdPStride) * 2 +       // Q, P
         sizeof(float) * (size_t)kMdWarps * RT * 4 * 32 +    // partial scores
         sizeof(float) * (size_t)2 * kMdTiles * RP +         // maxima, l
         sizeof(int) * (size_t)MB;                           // bt[b, :]
}

// element offset of (key row kk, 16-byte chunk ch) in a staged K/V tile:
// chunks XOR-swizzled by the row's low three bits, so the eight rows an
// ldmatrix reads at one logical chunk lie in eight different bank groups
__device__ __forceinline__ int md_swz(int kk, int ch) {
  return kk * kMdHD + ((ch ^ (kk & 7)) << 3);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
// the transpose of the 8x8 b16 matrix whose row lane/4, columns
// 2*(lane%4) and +1, this thread holds (the same fragment layout out)
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// CTA (split, b * KV + g): keys [split*n/u, (split+1)*n/u) of row b,
// kv-head g, against its R query rows (see (d) above). The fragment loads
// of each product are issued one step ahead of its mma (the asm keeps
// source order), so that their latency overlaps the previous step's.
template <int RT>
__global__ void __launch_bounds__(kMdWarps * 32)
    paged_decode_mma_kernel(const MdArgs a) {
  constexpr int RP = 8 * RT, HD = kMdHD, BK = kMdBK, ST = kMdStages;
  constexpr int NW = kMdWarps, NT = NW * 32, CPK = HD / 8, D4 = HD / 4;
  constexpr int KQ = HD / 16 / kMdQuarters;  // k16 steps of a warp's hd slice
  constexpr int MT = HD / 16 / NW;           // 16-row tiles of O^T a warp
  // Q^T's fragments for the warp's hd slice held in registers up to four
  // n8 tiles; from five on loaded a step ahead with K's (or they spill)
  constexpr bool kQRegs = RT <= 4;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ST][BK][HD]
  __nv_bfloat16* sV = sK + ST * BK * HD;                            // [ST][BK][HD]
  __nv_bfloat16* sQ = sV + ST * BK * HD;       // [RP][kMdQStride]
  __nv_bfloat16* sP = sQ + RP * kMdQStride;    // [RP][kMdPStride]
  float* sS = reinterpret_cast<float*>(sP + RP * kMdPStride);  // [NW][RT*4][32]
  float* sMax = sS + NW * RT * 4 * 32;                           // [tiles][RP]
  float* sL = sMax + kMdTiles * RP;                              // [tiles][RP]
  int* sbt = reinterpret_cast<int*>(sL + kMdTiles * RP);         // bt[b, :]

  const int split = blockIdx.x, bg = blockIdx.y;
  const int b = bg / a.KV, g = bg - b * a.KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, column pair
  // this warp's score tile of a stage and its slice of hd
  const int tile = warp % kMdTiles, hq = warp / kMdTiles;
  const int max_s = a.MB * a.BS;
  const int start = a.starts[b];
  // the row's block table, loaded beside starts[b] (it does not need it)
  constexpr int kBatch = 4;
  for (int i0 = 0; i0 < a.MB; i0 += kBatch * NT) {
    int v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + tid + j * NT;
      v[j] = i < a.MB ? a.bt[(size_t)b * a.MB + i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (i0 + tid + j * NT < a.MB) sbt[i0 + tid + j * NT] = v[j];
  }
  const int n = min(start + a.S - 1, max_s - 1) + 1;
  const int used = min(a.nsplit, (n + a.split_keys - 1) / a.split_keys);
  if (split >= used) return;  // no keys: no partial, no arrival
  const int lo = (int)((long long)split * n / used);
  const int hi = (int)((long long)(split + 1) * n / used);
  const int n_t = (hi - lo + BK - 1) / BK;
  // the query rows (r = s*group + u: head g*group + u at position s),
  // zeros past R
  for (int c = tid; c < RP * CPK; c += NT) {
    const int r = c / CPK, ch = c - r * CPK;
    const int rr = min(r, a.R - 1), s = rr / a.group, u = rr - s * a.group;
    cp_async16(sQ + r * kMdQStride + ch * 8,
               a.q + (((size_t)b * a.S + s) * a.H + g * a.group + u) * HD + ch * 8,
               r < a.R ? 16 : 0);
  }
  cp_async_commit();
  __syncthreads();  // sbt

  // stage kt: a warp copies one key row (32 x 16 bytes) at a time; keys
  // past the range are zeros
  const size_t new_off = ((size_t)b * a.KV + g) * HD;
  auto issue = [&](int kt) {
    const int t0 = lo + kt * BK;
    __nv_bfloat16* dk = sK + (kt % ST) * BK * HD;
    __nv_bfloat16* dv = sV + (kt % ST) * BK * HD;
#pragma unroll
    for (int i = 0; i < BK / NW; ++i) {
      const int kk = warp + NW * i, t = t0 + kk;
      const __nv_bfloat16* ks = a.k_pool;
      const __nv_bfloat16* vs = a.v_pool;
      int bytes = 0;
      if (t < hi) {
        bytes = 16;
        if (a.fused && t == start) {
          ks = a.new_k + new_off + lane * 8;
          vs = a.new_v + new_off + lane * 8;
        } else {
          const size_t o =
              (((size_t)sbt[t / a.BS] * a.BS + t % a.BS) * a.KV + g) * HD + lane * 8;
          ks = a.k_pool + o;
          vs = a.v_pool + o;
        }
      }
      cp_async16(dk + md_swz(kk, lane), ks, bytes);
      cp_async16(dv + md_swz(kk, lane), vs, bytes);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int kt = 0; kt < ST; ++kt) {
    if (kt < n_t) issue(kt);
    else cp_async_commit();
  }

  float o[MT][RT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < RT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
  // running max and sum of this thread's columns 2tq, 2tq+1 of each tile:
  // m is the same in every warp; l sums the warp's own score tiles
  float m_r[RT][2], l_r[RT][2];
#pragma unroll
  for (int nt = 0; nt < RT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m_r[nt][j] = kMaxFloor;
      l_r[nt][j] = 0.f;
    }
  uint32_t qf[kQRegs ? KQ : 1][kQRegs ? RT : 1][2];  // Q^T's B fragments

  for (int kt = 0; kt < n_t; ++kt) {
    cp_async_wait<ST - 1>();
    __syncthreads();  // stage kt (and the queries) landed for every thread
    if (kQRegs && kt == 0)
#pragma unroll
      for (int nt = 0; nt < RT; ++nt)
#pragma unroll
        for (int j = 0; j < KQ; j += 2) {
          uint32_t t4[4];
          ldsm_x4(t4, sQ + (nt * 8 + (lane & 7)) * kMdQStride + (hq * KQ + j) * 16 +
                          (lane >> 3) * 8);
          if constexpr (kQRegs) {
            qf[j][nt][0] = t4[0];
            qf[j][nt][1] = t4[1];
            qf[j + 1][nt][0] = t4[2];
            qf[j + 1][nt][1] = t4[3];
          }
        }
    const int t0 = lo + kt * BK;
    const int n_tiles = min(kMdTiles, (hi - t0 + 15) / 16);
    const __nv_bfloat16* tk = sK + (kt % ST) * BK * HD;
    const __nv_bfloat16* tv = sV + (kt % ST) * BK * HD;
    const bool scorer = tile < n_tiles;
    float sc[RT][4];
#pragma unroll
    for (int nt = 0; nt < RT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    if (scorer) {
      // this warp's slice of S^T[16 keys][RP] = K_tile . Q^T
      const int krow = tile * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      uint32_t kf[2][4], qs[2][kQRegs ? 1 : RT][2];
      auto load_k = [&](int j, int buf) {
        const int ks = hq * KQ + j;
        ldsm_x4(kf[buf], tk + md_swz(krow, 2 * ks + (lane >> 4)));
        if constexpr (!kQRegs)
#pragma unroll
          for (int nt = 0; nt < RT; ++nt)
            ldsm_x2(qs[buf][nt], sQ + (nt * 8 + (lane & 7)) * kMdQStride + ks * 16 +
                                     ((lane >> 3) & 1) * 8);
      };
      load_k(0, 0);
#pragma unroll
      for (int j = 0; j < KQ; ++j) {
        if (j + 1 < KQ) load_k(j + 1, (j + 1) & 1);
#pragma unroll
        for (int nt = 0; nt < RT; ++nt) {
          if constexpr (kQRegs) mma_16816(sc[nt], kf[j & 1], qf[j][nt][0], qf[j][nt][1]);
          else mma_16816(sc[nt], kf[j & 1], qs[j & 1][nt][0], qs[j & 1][nt][1]);
        }
      }
      if (hq != 0)
#pragma unroll
        for (int nt = 0; nt < RT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sS[(warp * RT * 4 + nt * 4 + e) * 32 + lane] = sc[nt][e];
    }
    __syncthreads();  // the slices' partial scores
    const bool owner = scorer && hq == 0;
    if (owner) {
#pragma unroll
      for (int q = 1; q < kMdQuarters; ++q)
#pragma unroll
        for (int nt = 0; nt < RT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[nt][e] += sS[((tile + q * kMdTiles) * RT * 4 + nt * 4 + e) * 32 + lane];
      // scale into the base-2 domain; mask keys past the range and past
      // each query's position; the tile's column maxima
#pragma unroll
      for (int nt = 0; nt < RT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + tile * 16 + gq + 8 * (e >> 1);
          const int r = min(nt * 8 + 2 * tq + (e & 1), a.R - 1);
          const int qpos = min(start + r / a.group, max_s - 1);
          sc[nt][e] = key < hi && key <= qpos ? sc[nt][e] * a.scale_log2 : kNegInf;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v = fmaxf(sc[nt][j], sc[nt][2 + j]);
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
          if (gq == 0) sMax[tile * RP + nt * 8 + 2 * tq + j] = v;
        }
      }
    }
    __syncthreads();  // the tiles' maxima
    float corr[RT][2];
#pragma unroll
    for (int nt = 0; nt < RT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mm = m_r[nt][j];
        for (int w = 0; w < n_tiles; ++w) mm = fmaxf(mm, sMax[w * RP + nt * 8 + 2 * tq + j]);
        mm = fmaxf(mm, kMaxFloor);
        corr[nt][j] = exp2_approx(m_r[nt][j] - mm);
        m_r[nt][j] = mm;
        l_r[nt][j] *= corr[nt][j];
      }
    if (owner) {
      // P rounded to bf16 into the shared [RP][keys] tile (B operand of
      // P.V); l sums the unrounded P
#pragma unroll
      for (int nt = 0; nt < RT; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = sc[nt][e] <= kNegInf ? 0.f : exp2_approx(sc[nt][e] - m_r[nt][e & 1]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float rs = p[j] + p[2 + j];
          rs += __shfl_xor_sync(0xffffffffu, rs, 4);
          rs += __shfl_xor_sync(0xffffffffu, rs, 8);
          rs += __shfl_xor_sync(0xffffffffu, rs, 16);
          l_r[nt][j] += rs;
        }
        uint32_t* prow = reinterpret_cast<uint32_t*>(
            sP + (nt * 8 + gq) * kMdPStride + tile * 16 + 2 * tq);
        prow[0] = movmatrix_trans(pack_bf16(p[0], p[1]));  // keys 2tq, +1
        prow[4] = movmatrix_trans(pack_bf16(p[2], p[3]));  // keys 8 + 2tq, +1
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < RT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][nt][e] *= corr[nt][e & 1];
    __syncthreads();  // P landed
    // O^T[this warp's hd rows][RP] += V^T . P^T over the stage's tiles
    uint32_t pf[2][RT][2], vf[2][MT][4];
    auto load_pv = [&](int kk, int buf) {
#pragma unroll
      for (int nt = 0; nt < RT; ++nt)
        ldsm_x2(pf[buf][nt], sP + (nt * 8 + (lane & 7)) * kMdPStride + kk * 16 +
                                 ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_trans(vf[buf][mt], tv + md_swz(kk * 16 + (lane & 7) + ((lane >> 4) << 3),
                                               (warp * MT + mt) * 2 + ((lane >> 3) & 1)));
    };
    load_pv(0, 0);
#pragma unroll
    for (int kk = 0; kk < kMdTiles; ++kk) {
      if (kk < n_tiles) {
        if (kk + 1 < n_tiles) load_pv(kk + 1, (kk + 1) & 1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < RT; ++nt)
            mma_16816(o[mt][nt], vf[kk & 1][mt], pf[kk & 1][nt][0], pf[kk & 1][nt][1]);
      }
    }
    __syncthreads();  // stage kt consumed: its buffers may be refilled
    if (kt + ST < n_t) issue(kt + ST);
    else cp_async_commit();
  }
  cp_async_wait<0>();

  // l over the score tiles' owners
  if (warp < kMdTiles && gq == 0)
#pragma unroll
    for (int nt = 0; nt < RT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) sL[warp * RP + nt * 8 + 2 * tq + j] = l_r[nt][j];
  __syncthreads();
  float lt[RT][2];
#pragma unroll
  for (int nt = 0; nt < RT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kMdTiles; ++w) v += sL[w * RP + nt * 8 + 2 * tq + j];
      lt[nt][j] = v;
    }

  if (used == 1) {  // the row's only CTA: out = acc / max(l, 1e-30)
#pragma unroll
    for (int nt = 0; nt < RT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = nt * 8 + 2 * tq + (e & 1);
        if (r >= a.R) continue;
        const int s = r / a.group, u = r - s * a.group;
        __nv_bfloat16* orow = a.out + (((size_t)b * a.S + s) * a.H + g * a.group + u) * HD;
        const float lc = fmaxf(lt[nt][e & 1], 1e-30f);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          orow[(warp * MT + mt) * 16 + gq + 8 * (e >> 1)] = __float2bfloat16(o[mt][nt][e] / lc);
      }
  } else {  // this CTA's partial
    float* pacc = a.part_acc + ((size_t)bg * a.nsplit + split) * a.R * HD;
#pragma unroll
    for (int nt = 0; nt < RT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = nt * 8 + 2 * tq + (e & 1);
        if (r >= a.R) continue;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          pacc[(size_t)r * HD + (warp * MT + mt) * 16 + gq + 8 * (e >> 1)] = o[mt][nt][e];
      }
    if (warp == 0 && gq == 0) {
      float* pml = a.part_ml + ((size_t)bg * a.nsplit + split) * a.R * 2;
#pragma unroll
      for (int nt = 0; nt < RT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = nt * 8 + 2 * tq + j;
          if (r < a.R) {
            pml[2 * r] = m_r[nt][j];
            pml[2 * r + 1] = lt[nt][j];
          }
        }
    }
  }

  if (a.fused && start >= lo && start < hi && tid < CPK) {
    // this CTA alone holds position `start`, and read it from new_k/new_v
    const int blk = sbt[start / a.BS];
    const size_t dst = (((size_t)blk * a.BS + start % a.BS) * a.KV + g) * HD + tid * 8;
    *reinterpret_cast<uint4*>(a.k_pool_w + dst) =
        *reinterpret_cast<const uint4*>(a.new_k + new_off + tid * 8);
    *reinterpret_cast<uint4*>(a.v_pool_w + dst) =
        *reinterpret_cast<const uint4*>(a.new_v + new_off + tid * 8);
  }
  if (used == 1) return;

  // the row's CTAs wait for each other's partials (the launch is
  // cooperative: they are all resident), then each merges a slice of out
  // (arrival: a release, cumulative over the CTA's stores through the
  // barrier; departure: counted as soon as the CTA stops polling, so its
  // round trip overlaps the merge, and the last to depart resets both)
  int* cnt = a.counters + 2 * bg;
  __shared__ int s_departed;  // departures before this CTA's
  __syncthreads();
  if (tid == 0) {
    red_release_add(cnt, 1);
    while (ld_acquire(cnt) < used) __nanosleep(32);
    s_departed = atomicAdd(cnt + 1, 1);
  }
  __syncthreads();  // thread 0's acquire, for the whole CTA
  // this CTA's slice of the row's out, merged from all u partials in two
  // levels: a thread folds its splits (online, as the softmax does), then
  // the split groups are folded through shared memory in order; an order
  // fixed by the shapes (deterministic). G split groups x E elements a
  // pass: G = 1 and kEpt elements a thread a round for a wide slice of
  // few splits, up to 8 groups for a narrow slice of many; a round's loads
  // are issued together.
  constexpr int kLoads = 8, kEpt = 2;
  const int n_el = a.R * D4;  // float4 elements of the row's out
  const int per = (n_el + used - 1) / used;
  const int e_lo = split * per, e_hi = min(n_el, e_lo + per);
  if (e_lo < e_hi) {
    const float4* pacc = reinterpret_cast<const float4*>(a.part_acc) +
                         (size_t)bg * a.nsplit * a.R * D4;
    const float2* pml =
        reinterpret_cast<const float2*>(a.part_ml) + (size_t)bg * a.nsplit * a.R;
    const int G = max(1, min(kMdGroups, NT / (e_hi - e_lo))), E = NT / G;
    const int k = tid / E, el = tid - k * E;
    const int ept = (e_hi - e_lo + E - 1) / E;  // elements a thread
    float mx[kEpt] = {}, ls[kEpt] = {};
    float4 ac[kEpt] = {};
    // fold (m, l, acc) into slot j's running state
    auto fold = [&](int j, float2 ml, float4 v) {
      const float mm = fmaxf(mx[j], ml.x), c = exp2_approx(mx[j] - mm);
      const float w = exp2_approx(ml.x - mm);
      mx[j] = mm;
      ls[j] = ls[j] * c + w * ml.y;
      ac[j].x = ac[j].x * c + w * v.x;
      ac[j].y = ac[j].y * c + w * v.y;
      ac[j].z = ac[j].z * c + w * v.z;
      ac[j].w = ac[j].w * c + w * v.w;
    };
    const float2 kEmpty = make_float2(kMaxFloor, 0.f);
    const float4 kZero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < ept; j0 += kEpt) {  // kEpt elements a round
#pragma unroll
      for (int j = 0; j < kEpt; ++j) {
        mx[j] = kMaxFloor;
        ls[j] = 0.f;
        ac[j] = kZero;
      }
      if (k < G && ept == 1) {  // one element, splits k, k + G, ... batched
        const int e = min(e_lo + el, e_hi - 1), r = e / D4;
        for (int i0 = k; i0 < used; i0 += G * kLoads) {
          float2 ml[kLoads];
          float4 v[kLoads];
#pragma unroll
          for (int j = 0; j < kLoads; ++j) {
            const int i = i0 + G * j;
            ml[j] = i < used ? __ldcg(pml + (size_t)i * a.R + r) : kEmpty;
            v[j] = i < used ? __ldcg(pacc + (size_t)i * a.R * D4 + e) : kZero;
          }
#pragma unroll
          for (int j = 0; j < kLoads; ++j) fold(0, ml[j], v[j]);
        }
      } else if (k < G) {  // G = 1: up to kEpt elements batched, splits in turn
        for (int i = 0; i < used; ++i) {
          float2 ml[kEpt];
          float4 v[kEpt];
#pragma unroll
          for (int j = 0; j < kEpt; ++j) {
            const int e = e_lo + el + E * (j0 + j);
            const bool ok = j0 + j < ept && e < e_hi;
            ml[j] = ok ? __ldcg(pml + (size_t)i * a.R + e / D4) : kEmpty;
            v[j] = ok ? __ldcg(pacc + (size_t)i * a.R * D4 + e) : kZero;
          }
#pragma unroll
          for (int j = 0; j < kEpt; ++j) fold(j, ml[j], v[j]);
        }
      }
      if (G > 1) {  // the groups' states of each element, in the ring
        float* sst = reinterpret_cast<float*>(smem_raw) + (size_t)tid * 6;  // m, l, acc
        sst[0] = mx[0];
        sst[1] = ls[0];
        sst[2] = ac[0].x;
        sst[3] = ac[0].y;
        sst[4] = ac[0].z;
        sst[5] = ac[0].w;
        __syncthreads();
        if (k == 0)
          for (int q = 1; q < G; ++q) {
            const float* o2 = reinterpret_cast<const float*>(smem_raw) + (size_t)(q * E + el) * 6;
            fold(0, make_float2(o2[0], o2[1]), make_float4(o2[2], o2[3], o2[4], o2[5]));
          }
      }
      if (k == 0)
#pragma unroll
        for (int j = 0; j < kEpt; ++j) {
          const int e = e_lo + el + E * (j0 + j);
          if (j0 + j >= ept || e >= e_hi) continue;
          const int r = e / D4, d = (e - r * D4) * 4;
          const int s = r / a.group, u = r - s * a.group;
          const float lc = fmaxf(ls[j], 1e-30f);
          uint32_t* dst = reinterpret_cast<uint32_t*>(
              a.out + (((size_t)b * a.S + s) * a.H + g * a.group + u) * HD + d);
          dst[0] = pack_bf16(ac[j].x / lc, ac[j].y / lc);
          dst[1] = pack_bf16(ac[j].z / lc, ac[j].w / lc);
        }
    }
  }
  if (tid == 0 && s_departed == used - 1) {  // every CTA has stopped polling
    cnt[0] = 0;
    cnt[1] = 0;
  }
}

template <int RT>
cudaError_t launch_mma_decode_rt(MdArgs a, int B, cudaStream_t st) {
  const size_t smem = md_smem_bytes<RT>(a.MB);
  auto kern = paged_decode_mma_kernel<RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // a row's CTAs wait for each other before the merge, so all of them
  // must be resident at once: no more splits than the card holds, and a
  // cooperative launch, which refuses a grid it cannot hold
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kMdWarps * 32,
                                                           smem)) != cudaSuccess)
    return err;
  const int rows = B * a.KV;
  a.nsplit = max(1, min(a.nsplit, per_sm * sms / rows));
  const dim3 grid(a.nsplit, rows);
  if (a.nsplit == 1) {  // every row one CTA: nothing waits
    kern<<<grid, kMdWarps * 32, smem, st>>>(a);
    return cudaGetLastError();
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), grid,
                                    dim3(kMdWarps * 32), args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_mma_decode(const MdArgs& a, int B, cudaStream_t st) {
  if (a.part_acc == nullptr || a.counters == nullptr || a.nsplit < 1 ||
      a.nsplit > kMdMaxSplits || a.split_keys < 1 || a.R < 1 || a.R > 64 ||
      (long long)B * a.KV > 65535 ||
      (a.fused && (a.new_k == nullptr || a.new_v == nullptr || a.S != 1)))
    return cudaErrorInvalidValue;
  switch ((a.R + 7) / 8) {
    case 1: return launch_mma_decode_rt<1>(a, B, st);
    case 2: return launch_mma_decode_rt<2>(a, B, st);
    case 3: return launch_mma_decode_rt<3>(a, B, st);
    case 4: return launch_mma_decode_rt<4>(a, B, st);
    case 5: return launch_mma_decode_rt<5>(a, B, st);
    case 6: return launch_mma_decode_rt<6>(a, B, st);
    case 7: return launch_mma_decode_rt<7>(a, B, st);
    case 8: return launch_mma_decode_rt<8>(a, B, st);
  }
  return cudaErrorInvalidValue;
}

// ---- dispatch ----------------------------------------------------------------

struct Call {
  const void *q, *k_pool, *v_pool, *bt, *starts, *new_k, *new_v;
  void *ws, *counters, *out;
  int B, S, H, KV, hd, NB, BS, MB, nsplit, split_len;
};

template <typename T, int HD>
cudaError_t run(const Call& c, int route, bool fused, cudaStream_t st) {
  const int group = c.H / c.KV;
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  if (route == kSplitK) {
    SplitArgs<T> a{};
    a.q = static_cast<const T*>(c.q);
    a.k_pool = static_cast<const T*>(c.k_pool);
    a.v_pool = static_cast<const T*>(c.v_pool);
    a.k_pool_w = const_cast<T*>(a.k_pool);
    a.v_pool_w = const_cast<T*>(a.v_pool);
    a.bt = static_cast<const int*>(c.bt);
    a.starts = static_cast<const int*>(c.starts);
    a.new_k = static_cast<const T*>(c.new_k);
    a.new_v = static_cast<const T*>(c.new_v);
    a.ws = static_cast<float*>(c.ws);
    a.out = static_cast<T*>(c.out);
    a.S = c.S;
    a.H = c.H;
    a.KV = c.KV;
    a.BS = c.BS;
    a.MB = c.MB;
    a.group = group;
    a.R = c.S * group;
    a.nsplit = c.nsplit;
    a.split_len = c.split_len;
    a.scale_log2 = scale_log2;
    if (fused && (a.new_k == nullptr || a.new_v == nullptr || c.S != 1))
      return cudaErrorInvalidValue;
    return fused ? launch_split<T, HD, true>(a, c.B, st)
                 : launch_split<T, HD, false>(a, c.B, st);
  }
  if (route == kMmaDecode) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value && HD == kMdHD) {
      MdArgs a{};
      a.q = static_cast<const __nv_bfloat16*>(c.q);
      a.k_pool = static_cast<const __nv_bfloat16*>(c.k_pool);
      a.v_pool = static_cast<const __nv_bfloat16*>(c.v_pool);
      a.k_pool_w = const_cast<__nv_bfloat16*>(a.k_pool);
      a.v_pool_w = const_cast<__nv_bfloat16*>(a.v_pool);
      a.bt = static_cast<const int*>(c.bt);
      a.starts = static_cast<const int*>(c.starts);
      a.new_k = static_cast<const __nv_bfloat16*>(c.new_k);
      a.new_v = static_cast<const __nv_bfloat16*>(c.new_v);
      a.S = c.S;
      a.H = c.H;
      a.KV = c.KV;
      a.BS = c.BS;
      a.MB = c.MB;
      a.group = group;
      a.R = c.S * group;
      a.nsplit = c.nsplit;
      a.split_keys = c.split_len;
      a.part_acc = static_cast<float*>(c.ws);
      a.part_ml = a.part_acc == nullptr ? nullptr
                                        : a.part_acc + (size_t)c.B * c.KV * c.nsplit * a.R * HD;
      a.counters = static_cast<int*>(c.counters);
      a.out = static_cast<__nv_bfloat16*>(c.out);
      a.fused = fused;
      a.scale_log2 = scale_log2;
      return launch_mma_decode(a, c.B, st);
    }
    return cudaErrorInvalidValue;
  }
  if (route == kTensorCore) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      TcArgs a{static_cast<const int*>(c.bt), static_cast<const int*>(c.starts),
               static_cast<__nv_bfloat16*>(c.out), c.S, c.H, c.KV, c.BS, c.MB,
               group, c.S * group, scale_log2};
      return launch_prefill_tc<HD>(c.q, c.k_pool, c.v_pool, a, c.B, c.NB, st);
    }
    return cudaErrorInvalidValue;
  }
  CcArgs<T> a{static_cast<const T*>(c.q), static_cast<const T*>(c.k_pool),
              static_cast<const T*>(c.v_pool), static_cast<const int*>(c.bt),
              static_cast<const int*>(c.starts), static_cast<T*>(c.out),
              c.S, c.H, c.KV, c.BS, c.MB, group, c.S * group, scale_log2};
  return launch_cuda_core<T, HD>(a, c.B, st);
}

template <typename T>
cudaError_t run_hd(const Call& c, int route, bool fused, cudaStream_t st) {
  switch (c.hd) {
    case 64:
      return run<T, 64>(c, route, fused, st);
    case 128:
      return run<T, 128>(c, route, fused, st);
    case 256:
      return run<T, 256>(c, route, fused, st);
  }
  return cudaErrorInvalidValue;
}

int dispatch(const Call& c, int dtype, bool fused, void* stream) {
  if (c.B <= 0 || c.S <= 0) return 0;
  if (c.KV <= 0 || c.H % c.KV != 0 || c.BS <= 0 || c.MB <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int route = route_of(dtype, c.hd, c.S, c.H / c.KV, c.BS, fused);
  if (dtype == 1) return (int)run_hd<__nv_bfloat16>(c, route, fused, st);
  return (int)run_hd<float>(c, route, fused, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The route (0 split-K, 1 tensor cores,
// 2 CUDA cores, 3 tensor-core decode) of a call with these arguments.
extern "C" int kdl_paged_route(int dtype, int hd, int S, int group, int BS,
                               int fused) {
  return route_of(dtype, hd, S, group, BS, fused != 0);
}

// ws: the split-K route's float32 workspace [B, KV, nsplit, S*H/KV, hd + 2]
// (not initialised), with nsplit * split_len >= MB * BS and split_len a
// multiple of 32; or the tensor-core decode route's [B*KV*nsplit*R*(hd +
// 2)] partials (not initialised) with `counters` [B*KV, 2] int32, zero
// before the launch and zero after it, nsplit <= 64 and split_len the keys
// a split takes at least (a row of n keys uses min(nsplit, ceil(n /
// split_len)) CTAs; the launch may use fewer splits, to what the card
// holds at once); null (and nsplit, split_len 0) on the other routes.
extern "C" int kdl_paged_attention_blocked(
    const void* q, const void* k_pool, const void* v_pool, const void* bt,
    const void* starts, void* ws, void* counters, void* out, int B, int S,
    int H, int KV, int hd, int NB, int BS, int MB, int nsplit, int split_len,
    int dtype, void* stream) {
  const Call c{q, k_pool, v_pool, bt, starts, nullptr, nullptr, ws, counters,
               out, B, S, H, KV, hd, NB, BS, MB, nsplit, split_len};
  return dispatch(c, dtype, false, stream);
}

// The decode step, with the fused write: the tensor-core decode route at
// bf16 hd 256 with H/KV < 64, else split-K.
extern "C" int kdl_paged_attention_fused(
    const void* q, void* k_pool, void* v_pool, const void* bt,
    const void* starts, const void* new_k, const void* new_v, void* ws,
    void* counters, void* out, int B, int H, int KV, int hd, int NB, int BS,
    int MB, int nsplit, int split_len, int dtype, void* stream) {
  const Call c{q, k_pool, v_pool, bt, starts, new_k, new_v, ws, counters, out,
               B, 1, H, KV, hd, NB, BS, MB, nsplit, split_len};
  return dispatch(c, dtype, true, stream);
}
