// Weight-only int8 matmul (W8A16) for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's `h @ deq(w)`
// (kubedl_tpu/models/llama.py:300-304, :332-337) is fused by XLA, which
// folds the int8 convert and the per-column scale into the dot so that
// device memory reads one byte a weight. These kernels are that fusion:
//
//   W[k, n] = float(q8[k, n]) * float(s8[n])   -- exact in float32,
//             rounded once to h's type (to bf16 through the tied head)
//   y[m, n] = sum_k h[m, k] * W[k, n]           -- fp32 sums
//
// q8 is int8 [K, N] with s8 bf16 [1, N] (a layer weight), or with
// `tied` int8 [N, K] with s8 [N, 1] read as its transpose (a tied
// embedding used as the lm head). h is [M, K] row-major, bf16 or float32;
// y [M, N] has h's type. The layouts are the reference's: any reordering
// happens here, on the chip.
//
// Three kernels, chosen statically (route_of below; the Python side's
// ops/w8a16.py::w8a16_route mirrors it, and the caller may force a bf16
// route for a test):
//
// - decode (bf16, M <= kDecodeMaxM): bound by the int8 weight bytes (one
//   read of K*N bytes at 3.35 TB/s: 17.5 us for 4096 x 14336). The product
//   is computed swapped, y^T = W^T h^T, so the weight's columns are the
//   16-row side of mma.sync m16n8k16 and h's M rows its n8 side (M=8 is
//   one n8 tile, not 7/8 padding). A CTA owns 128 weight columns and one
//   K-slice; K is split so that the grid covers the SMs at every decode
//   shape (N = 1024 is 8 column strips). The weight and h stream through
//   a 3-4 stage ring of cp.async 16-byte copies (16 KB of int8 a stage).
//   The sum over k and the order of output columns are free inside an MMA
//   tile: thread t takes k 4t..4t+3 of each k16 step (h the same) and the
//   8 consecutive columns 8g..8g+7 of its warp's 64, so it reads whole
//   8-byte runs of the [K, N] layout and regroups bytes with prmt.
// - prefill (bf16, M > kDecodeMaxM): bound by the tensor cores. wgmma
//   with A from registers: A is the dequantized W^T slab (64 weight
//   columns a consumer warpgroup), built straight from the int8 bytes; B
//   is h^T, K-major, TMA-loaded with 128-byte swizzle. A CTA owns 128
//   weight columns x 128 rows of h (m64n128k16), or 256 rows past 128
//   (m64n256k16: twice the MMA work for each dequantized weight); one
//   producer warp keeps a 4-stage ring of TMA loads (the int8 tile and
//   the h tile) ahead of two consumer warpgroups. Where the tiles leave
//   SMs idle (N = 4096 at M = 512 is 64 tiles), K is split as well. B's
//   k-order is the hardware's, so only the output columns are reordered:
//   thread (warp w, g) of slab c takes the two adjacent columns
//   64c + 16w + 2g, +1.
//   Split K (either route): float32 partials in a workspace [splits, M,
//   N] that the wrapper allocates, summed by w8a16_combine_kernel in
//   split order, so the same inputs give the same bits on every call.
// - cuda_core (float32 h): 256 threads, each a 4 x 4 micro-tile of
//   float32 FMAs (TF32 would break the float32 contract), one CTA per
//   64 x 64 tile of y, register-staged one K step ahead.
//
// The bf16 routes dequantize without the conversion unit: x = q ^ 0x80
// placed in the low byte of the float 2^23 (0x4B0000xx) is 2^23 + q + 128
// exactly, so subtracting 2^23 + 128 gives float(q) exactly; its upper
// half is bf16(q) exactly (|q| <= 128 needs 8 significant bits). Two such
// halves are packed with prmt and scaled by one bf16x2 multiply by
// (s, s): bf16 * bf16 is exact before its one rounding (8 x 8 significant
// bits), so the result is bf16_rn(float(q) * float(s)), the reference's
// deq bit for bit. The scale is never folded into the epilogue.
//
// Every kernel launches on the caller's stream and allocates nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- the static route (mirrors ops/w8a16.py::w8a16_route) -------------------

constexpr int kRouteCudaCore = 0, kRouteDecode = 1, kRoutePrefill = 2;
constexpr int kDecodeMaxM = 64;  // rows of h up to which decode is taken

int route_of(int M, int dtype) {
  if (dtype != 1) return kRouteCudaCore;
  return M <= kDecodeMaxM ? kRouteDecode : kRoutePrefill;
}

// ---- the bit-level dequantization (see the header) --------------------------

constexpr uint32_t kSignFlip = 0x80808080u;  // q ^ 0x80 in every byte
constexpr uint32_t kMagic = 0x4B000000u;     // 2^23
constexpr float kMagicBias = 8388736.f;      // 2^23 + 128

// bf16x2 {deq(byte ba of xa), deq(byte bb of xb)} (low half first), where
// xa / xb hold int8 bytes already XORed with kSignFlip and s2 holds the
// column's bf16 scale in both halves.
__device__ __forceinline__ uint32_t deq2(uint32_t xa, int ba, uint32_t xb,
                                         int bb, uint32_t s2) {
  const float fa =
      __uint_as_float(__byte_perm(xa, kMagic, 0x7650 | ba)) - kMagicBias;
  const float fb =
      __uint_as_float(__byte_perm(xb, kMagic, 0x7650 | bb)) - kMagicBias;
  const uint32_t q2 =
      __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
  uint32_t out;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(out) : "r"(q2), "r"(s2));
  return out;
}

// a bf16 pair {v, v} from the low (hi = false) or high half of w
__device__ __forceinline__ uint32_t splat(uint32_t w, bool hi) {
  return __byte_perm(w, w, hi ? 0x3232 : 0x1010);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- decode: split-K, mma.sync on the swapped product ----------------------

constexpr int kDecBN = 128;       // weight columns a CTA (2 warps of 64)
constexpr int kDecBK = 128;       // k rows a stage (2 warps of 4 k16 steps)
constexpr int kDecThreads = 128;  // warps (wn, wk) in 2 x 2
constexpr int kDecRows = 64;      // rows of h a CTA (gridDim.z covers more)

// MT n8 tiles of h rows (8 MT rows); the ring holds 16 KB of int8 and
// 2 KB x MT of h a stage
template <int MT>
struct Dec {
  static constexpr int kStages = MT <= 4 ? 4 : 3;
  static constexpr int kWBytes = kDecBK * kDecBN;
  static constexpr int kHBytes = MT * 8 * kDecBK * 2;
  static constexpr int kStage = kWBytes + kHBytes;
  static constexpr int kSmem = kStages * kStage;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared layouts of a stage, each swizzled by 16-byte chunk so that the
// fragment reads below are free of bank conflicts:
//   layer W [128 k][128 B n]: chunk ^= 2 * ((k >> 2) & 3)
//   tied  W [128 n][128 B k]: chunk ^= (n >> 3) & 7
//   h       [8 MT m][256 B k]: chunk ^= 2 * (m & 3)
template <bool TIED>
__device__ __forceinline__ int w_swz(int row, int chunk) {
  return TIED ? chunk ^ ((row >> 3) & 7) : chunk ^ (2 * ((row >> 2) & 3));
}

template <int MT, bool TIED>
__device__ __forceinline__ void dec_load_stage(
    uint8_t* stage, const __nv_bfloat16* __restrict__ h,
    const int8_t* __restrict__ q8, int M, int N, int K, int m0, int n0,
    int k0, int kend, int tid) {
  const uint32_t sw = smem_u32(stage);
  const uint32_t sh = sw + Dec<MT>::kWBytes;
#pragma unroll
  for (int p = 0; p < kDecBK * kDecBN / 16 / kDecThreads; ++p) {
    const int c = tid + p * kDecThreads;
    const int r = c >> 3, cc = c & 7;
    const int8_t* src;
    bool valid;
    if (TIED) {  // row r = column n0 + r, chunk cc = k0 + 16 cc
      const int n = n0 + r, k = k0 + cc * 16;
      valid = n < N && k < kend;
      src = q8 + (size_t)n * K + k;
    } else {  // row r = k0 + r, chunk cc = columns n0 + 16 cc
      const int k = k0 + r, n = n0 + cc * 16;
      valid = k < kend && n < N;
      src = q8 + (size_t)k * N + n;
    }
    cp_async16(sw + r * 128 + (w_swz<TIED>(r, cc) << 4), valid ? src : q8,
               valid);
  }
#pragma unroll
  for (int p = 0; p < MT; ++p) {
    const int c = tid + p * kDecThreads;
    const int r = c >> 4, cc = c & 15;
    const int m = m0 + r, k = k0 + cc * 8;
    const bool valid = m < M && k < kend;
    const __nv_bfloat16* src = valid ? h + (size_t)m * K + k : h;
    cp_async16(sh + r * 256 + ((cc ^ (2 * (r & 3))) << 4), src, valid);
  }
}

// One CTA: weight columns n0 .. n0 + 127, k in [split * k_slice, +k_slice),
// h rows m0 .. m0 + 8 MT - 1. Warp (wn, wk) takes columns 64 wn .. +63 and
// k16 steps 4 wk .. 4 wk + 3 of each stage; the two wk halves are summed
// through shared memory at the end (wk 0 + wk 1: a fixed order).
template <int MT, bool TIED>
__global__ void __launch_bounds__(kDecThreads)
    w8a16_decode_kernel(const __nv_bfloat16* __restrict__ h,
                        const int8_t* __restrict__ q8,
                        const __nv_bfloat16* __restrict__ s8,
                        __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                        int M, int N, int K, int k_slice) {
  using C = Dec<MT>;
  constexpr int ST = C::kStages;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wn = warp & 1, wk = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kDecBN, split = blockIdx.y;
  const int m0 = blockIdx.z * kDecRows;
  const int kbeg = split * k_slice, kend = min(K, kbeg + k_slice);
  const int nk = kend > kbeg ? (kend - kbeg + kDecBK - 1) / kDecBK : 0;

  // this thread's 8 columns n0 + 64 wn + 8 g + c: their scales as (s, s)
  const int ncol = n0 + 64 * wn + 8 * g;
  uint32_t s2[8];
#pragma unroll
  for (int c = 0; c < 8; c += 2) {
    const uint32_t w =
        ncol < N ? *reinterpret_cast<const uint32_t*>(s8 + ncol + c) : 0u;
    s2[c] = splat(w, false);
    s2[c + 1] = splat(w, true);
  }

  float acc[4][MT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int p = 0; p < ST - 1; ++p) {
    if (p < nk)
      dec_load_stage<MT, TIED>(smem + p * C::kStage, h, q8, M, N, K, m0, n0,
                               kbeg + p * kDecBK, kend, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ST - 2>();  // this thread's copies of stage kt landed
    __syncthreads();          // everyone's; and stage kt - 1 is consumed
    const int pf = kt + ST - 1;
    if (pf < nk)
      dec_load_stage<MT, TIED>(smem + (pf % ST) * C::kStage, h, q8, M, N, K,
                               m0, n0, kbeg + pf * kDecBK, kend, tid);
    cp_async_commit();
    const uint8_t* sW = smem + (kt % ST) * C::kStage;
    const uint8_t* sH = sW + C::kWBytes;
#pragma unroll
    for (int ss = 0; ss < 4; ++ss) {
      const int s = 4 * wk + ss;  // k16 step of the stage: k 16 s + 4 t + j
      uint32_t a[4][4];
      if (TIED) {
        // column 64 wn + 8 g + c: k bytes 16 s + 4 t .. + 3, one word
        uint32_t w[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int r = 64 * wn + 8 * g + c;
          w[c] = *reinterpret_cast<const uint32_t*>(
                     sW + r * 128 + (w_swz<true>(r, s) << 4) + 4 * t) ^
                 kSignFlip;
        }
        // tile i: logical row g = column 2i, row g + 8 = column 2i + 1
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i][0] = deq2(w[2 * i], 0, w[2 * i], 1, s2[2 * i]);
          a[i][1] = deq2(w[2 * i + 1], 0, w[2 * i + 1], 1, s2[2 * i + 1]);
          a[i][2] = deq2(w[2 * i], 2, w[2 * i], 3, s2[2 * i]);
          a[i][3] = deq2(w[2 * i + 1], 2, w[2 * i + 1], 3, s2[2 * i + 1]);
        }
      } else {
        // k row 16 s + 4 t + j: the 8 bytes of columns 64 wn + 8 g .. + 7
        uint2 w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 16 * s + 4 * t + j;
          w[j] = *reinterpret_cast<const uint2*>(
              sW + r * 128 + (w_swz<false>(r, 4 * wn + (g >> 1)) << 4) +
              8 * (g & 1));
          w[j].x ^= kSignFlip;
          w[j].y ^= kSignFlip;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = 2 * (i & 1);  // column 2i's byte in its word
          const uint32_t w0 = i < 2 ? w[0].x : w[0].y;
          const uint32_t w1 = i < 2 ? w[1].x : w[1].y;
          const uint32_t w2 = i < 2 ? w[2].x : w[2].y;
          const uint32_t w3 = i < 2 ? w[3].x : w[3].y;
          a[i][0] = deq2(w0, b, w1, b, s2[2 * i]);
          a[i][1] = deq2(w0, b + 1, w1, b + 1, s2[2 * i + 1]);
          a[i][2] = deq2(w2, b, w3, b, s2[2 * i]);
          a[i][3] = deq2(w2, b + 1, w3, b + 1, s2[2 * i + 1]);
        }
      }
#pragma unroll
      for (int jm = 0; jm < MT; ++jm) {
        // h row 8 jm + g, k 16 s + 4 t .. + 3: the B fragment's two words
        const int r = 8 * jm + g;
        const uint2 b = *reinterpret_cast<const uint2*>(
            sH + r * 256 + (((2 * s + (t >> 1)) ^ (2 * (r & 3))) << 4) +
            8 * (t & 1));
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16(acc[i][jm], a[i], b.x, b.y);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the wk = 1 partial sums

  float* red = reinterpret_cast<float*>(smem) + wn * 32 + lane;
  if (wk == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[((i * MT + j) * 4 + e) * 64] = acc[i][j][e];
  }
  __syncthreads();
  if (wk == 0 && ncol < N) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] += red[((i * MT + j) * 4 + e) * 64];

    // c0, c1 at (column 2i, rows 2t, 2t + 1), c2, c3 at (column 2i + 1, ...)
#pragma unroll
    for (int jm = 0; jm < MT; ++jm)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * jm + 2 * t + e;
        if (m >= M) continue;
        float v[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[2 * i] = acc[i][jm][e];
          v[2 * i + 1] = acc[i][jm][2 + e];
        }
        if (ws == nullptr) {
          uint4 o;
          o.x = pack_bf16(v[0], v[1]);
          o.y = pack_bf16(v[2], v[3]);
          o.z = pack_bf16(v[4], v[5]);
          o.w = pack_bf16(v[6], v[7]);
          *reinterpret_cast<uint4*>(y + (size_t)m * N + ncol) = o;
        } else {
          float4* dst = reinterpret_cast<float4*>(
              ws + ((size_t)split * M + m) * N + ncol);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
  }
}

// y = bf16(sum over splits of ws[split]) in split order (4 values a
// thread). TAG names the kernel that wrote the partials (the decode
// kernel's MT, 0 for prefill), so a profile tells their sums apart.
template <int TAG>
__global__ void w8a16_combine_kernel(const float* __restrict__ ws,
                                     __nv_bfloat16* __restrict__ y,
                                     int splits, size_t mn) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= mn) return;
  float4 a = *reinterpret_cast<const float4*>(ws + i);
  for (int s = 1; s < splits; ++s) {
    const float4 b = *reinterpret_cast<const float4*>(ws + s * mn + i);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  uint2 o;
  o.x = pack_bf16(a.x, a.y);
  o.y = pack_bf16(a.z, a.w);
  *reinterpret_cast<uint2*>(y + i) = o;
}

// The dynamic shared memory a kernel needs past 48 KB, set once a device
// (a host call on every launch would cost the host-bound decode step);
// `done` is the caller's, one for each kernel: a bit a device.
template <typename Kernel>
cudaError_t smem_attr_once(Kernel kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

// A bf16 call: with splits > 1, ws is float32 [splits, M, N], summed in
// split order into y by w8a16_combine_kernel.
struct Call {
  const __nv_bfloat16* h;
  const int8_t* q;
  const __nv_bfloat16* s;
  __nv_bfloat16* y;
  float* ws;
  int M, N, K, splits, k_slice;
};

template <int TAG>
cudaError_t launch_combine(const Call& c, cudaStream_t st) {
  const size_t mn = (size_t)c.M * c.N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((mn / 4 + threads - 1) / threads);
  w8a16_combine_kernel<TAG><<<blocks, threads, 0, st>>>(c.ws, c.y, c.splits,
                                                       mn);
  return cudaGetLastError();
}

template <int MT, bool TIED>
cudaError_t launch_decode_mt(const Call& c, cudaStream_t st) {
  static unsigned attr_done = 0;
  auto kernel = w8a16_decode_kernel<MT, TIED>;
  cudaError_t err = smem_attr_once(kernel, Dec<MT>::kSmem, attr_done);
  if (err != cudaSuccess) return err;
  const dim3 grid((c.N + kDecBN - 1) / kDecBN, c.splits,
                  (c.M + kDecRows - 1) / kDecRows);
  kernel<<<grid, kDecThreads, Dec<MT>::kSmem, st>>>(
      c.h, c.q, c.s, c.y, c.splits > 1 ? c.ws : nullptr, c.M, c.N, c.K,
      c.k_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess || c.splits == 1) return err;
  return launch_combine<MT>(c, st);
}

// n8 tiles of h rows a CTA: 1 (M = 8, decode), 2, 5 (M = 40, speculative
// verify's 8 x 5) or 8 (and gridDim.z past 64 rows)
template <bool TIED>
cudaError_t launch_decode(const Call& c, cudaStream_t st) {
  if (c.M <= 8) return launch_decode_mt<1, TIED>(c, st);
  if (c.M <= 16) return launch_decode_mt<2, TIED>(c, st);
  if (c.M <= 40) return launch_decode_mt<5, TIED>(c, st);
  return launch_decode_mt<8, TIED>(c, st);
}

// ---- prefill: wgmma with A (the dequantized W^T) from registers ------------

constexpr int kPreBN = 128;  // weight columns a CTA (a 64-column slab a WG)
constexpr int kPreBK = 64;   // k a stage
constexpr int kPreStages = 4;
constexpr int kPreWGs = 2;
constexpr int kPreWideM = 128;  // rows of h past which a CTA takes 256
constexpr int kPreThreads = kPreWGs * 128 + 32;  // + the producer warp
constexpr uint32_t kPreWBytes = kPreBN * kPreBK;  // 8 KB of int8

// BM rows of h a CTA (the wgmma N: 128, or 256 past 128 rows)
template <int BM>
struct Pre {
  static constexpr uint32_t kHBytes = BM * kPreBK * 2;  // [BM m][128 B]
  static constexpr size_t kSmem =
      1024 + kPreStages * (size_t)(kHBytes + kPreWBytes) + 64;
};

struct PreMaps {
  CUtensorMap h, w;
};

// One box of a 2-D map at (inner, outer) element coordinates.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int inner,
                                            int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner),
      "r"(outer)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void pin_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ uint32_t lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// The A fragment of k16 step ks for the thread's columns c0 = 64 wg +
// 16 w + 2 g (logical row g) and c0 + 1 (row g + 8), k 2t, 2t + 1 and
// 2t + 8, 2t + 9 (the hardware's order: B's k-order is fixed).
//   layer W tile [64 k][128 B n], TMA 128-byte swizzle: chunk ^= k & 7
//   tied  W tile [128 n][64 B k], TMA 64-byte swizzle: chunk ^= (n >> 1) & 3
template <bool TIED>
__device__ __forceinline__ void pre_a(uint32_t (&a)[4], const uint8_t* sW,
                                      int c0, int ks, int t, uint32_t sa,
                                      uint32_t sb) {
  uint32_t x01, x23;
  if (TIED) {
    const int k = 16 * ks + 2 * t;
    auto at = [&](int n, int kk) {
      return lds16(sW + n * 64 + ((kk & ~15) ^ (((n >> 1) & 3) << 4)) +
                   (kk & 15));
    };
    // {c0: k, k + 1; c1: k, k + 1}, then the same at k + 8
    x01 = __byte_perm(at(c0, k), at(c0 + 1, k), 0x5410) ^ kSignFlip;
    x23 = __byte_perm(at(c0, k + 8), at(c0 + 1, k + 8), 0x5410) ^ kSignFlip;
    a[0] = deq2(x01, 0, x01, 1, sa);
    a[1] = deq2(x01, 2, x01, 3, sb);
    a[2] = deq2(x23, 0, x23, 1, sa);
    a[3] = deq2(x23, 2, x23, 3, sb);
  } else {
    const int chunk = c0 >> 4, off = c0 & 15;
    auto at = [&](int k) {
      return lds16(sW + k * 128 + ((chunk ^ (k & 7)) << 4) + off);
    };
    const int k = 16 * ks + 2 * t;
    // {k: c0, c1; k + 1: c0, c1}, then the same at k + 8
    x01 = __byte_perm(at(k), at(k + 1), 0x5410) ^ kSignFlip;
    x23 = __byte_perm(at(k + 8), at(k + 9), 0x5410) ^ kSignFlip;
    a[0] = deq2(x01, 0, x01, 2, sa);
    a[1] = deq2(x01, 1, x01, 3, sb);
    a[2] = deq2(x23, 0, x23, 2, sa);
    a[3] = deq2(x23, 1, x23, 3, sb);
  }
}

// One CTA: rows m0 .. m0 + BM - 1 of h (blockIdx.x, fastest: the CTAs
// that share a weight strip run together and read it from L2), weight
// columns n0 .. n0 + 127 (blockIdx.y) and k in [z k_slice, +k_slice)
// (blockIdx.z; with ws, float32 partials [split, M, N] for the combine
// kernel). The next k16 step's A fragment is dequantized while the
// previous wgmma runs (two register sets).
template <int BM, bool TIED>
__global__ void __launch_bounds__(kPreThreads, 1)
    w8a16_prefill_kernel(const __grid_constant__ PreMaps maps,
                         const __nv_bfloat16* __restrict__ s8,
                         __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                         int M, int N, int K, int k_slice) {
  constexpr uint32_t kPreHBytes = Pre<BM>::kHBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sH = align1024(smem_raw);            // [ST][BM m][128 B]
  uint8_t* sW = sH + kPreStages * kPreHBytes;   // [ST][8 KB]
  uint64_t* full = reinterpret_cast<uint64_t*>(sW + kPreStages * kPreWBytes);
  uint64_t* empty = full + kPreStages;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kPreBN;
  const int kbeg = blockIdx.z * k_slice, kend = min(K, kbeg + k_slice);
  const int nk = kend > kbeg ? (kend - kbeg + kPreBK - 1) / kPreBK : 0;

  if (tid == 0) {
    for (int i = 0; i < kPreStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kPreWGs * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid >= kPreWGs * 128) {  // the producer warp
    if (tid == kPreWGs * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kPreStages;
        if (kt >= kPreStages) mbar_wait(&empty[st], (kt / kPreStages - 1) & 1);
        const int k = kbeg + kt * kPreBK;  // k_slice % kPreBK == 0
        mbar_expect_tx(&full[st], kPreHBytes + kPreWBytes);
        tma_load_2d(sH + st * kPreHBytes, &maps.h, &full[st], k, m0);
        if (TIED)
          tma_load_2d(sW + st * kPreWBytes, &maps.w, &full[st], k, n0);
        else
          tma_load_2d(sW + st * kPreWBytes, &maps.w, &full[st], n0, k);
      }
    }
    return;
  }

  const int c0 = 64 * wg + 16 * warp + 2 * g;  // this thread's columns
  const int ncol = n0 + c0;
  const uint32_t sw =
      ncol < N ? *reinterpret_cast<const uint32_t*>(s8 + ncol) : 0u;
  const uint32_t sa = splat(sw, false), sb = splat(sw, true);

  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  uint32_t a0[4], a1[4];
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kPreStages;
    mbar_wait(&full[st], (kt / kPreStages) & 1);
    const uint8_t* w = sW + st * kPreWBytes;
    const uint8_t* hb = sH + st * kPreHBytes;
#pragma unroll
    for (int ks = 0; ks < kPreBK / 16; ++ks) {
      uint32_t(&a)[4] = (ks & 1) ? a1 : a0;
      pre_a<TIED>(a, w, c0, ks, t, sa, sb);
      pin_regs(a);
      wg_fence();
      wgmma_rs<0>(acc, a, sw128_desc(hb + ks * 32, 16, 1024), 1);
      wg_commit();
      wg_wait<1>();  // the wgmma before this one is done: its A set is free
      pin(acc);
      // ... and at ks = 0 it was the previous stage's last
      if (ks == 0 && kt > 0) mbar_arrive(&empty[(kt - 1) % kPreStages]);
    }
  }
  wg_wait<0>();
  pin(acc);

  if (ncol >= N) return;  // N % 16 == 0: ncol + 1 < N as well
  // acc[4j + 2i + c]: weight column c0 + i, h row 8j + 2t + c
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = m0 + 8 * j + 2 * t + c;
      if (m >= M) continue;
      if (ws == nullptr)
        *reinterpret_cast<uint32_t*>(y + (size_t)m * N + ncol) =
            pack_bf16(acc[4 * j + c], acc[4 * j + 2 + c]);
      else
        *reinterpret_cast<float2*>(
            ws + ((size_t)blockIdx.z * M + m) * N + ncol) =
            make_float2(acc[4 * j + c], acc[4 * j + 2 + c]);
    }
}

// A row-major 2-D tensor [outer, inner] of elements of `esz` bytes as a
// map whose box is box_inner x box_outer, zero filled past its edges.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int esz,
               const void* ptr, int inner, int outer, int box_inner,
               int box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr || ptr == nullptr ||
      (reinterpret_cast<uintptr_t>(ptr) & 15) != 0 ||
      ((size_t)inner * esz) % 16 != 0)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * esz};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, bool TIED>
cudaError_t launch_prefill_bm(const Call& c, cudaStream_t st) {
  PreMaps maps{};
  const bool ok =
      encode_2d(&maps.h, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, c.h, c.K, c.M,
                kPreBK, BM, CU_TENSOR_MAP_SWIZZLE_128B) &&
      (TIED ? encode_2d(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, c.q, c.K,
                        c.N, kPreBK, kPreBN, CU_TENSOR_MAP_SWIZZLE_64B)
            : encode_2d(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, c.q, c.N,
                        c.K, kPreBN, kPreBK, CU_TENSOR_MAP_SWIZZLE_128B));
  if (!ok) return cudaErrorInvalidValue;
  static unsigned attr_done = 0;
  auto kernel = w8a16_prefill_kernel<BM, TIED>;
  cudaError_t err = smem_attr_once(kernel, (int)Pre<BM>::kSmem, attr_done);
  if (err != cudaSuccess) return err;
  const dim3 grid((c.M + BM - 1) / BM, (c.N + kPreBN - 1) / kPreBN,
                  c.splits);
  kernel<<<grid, kPreThreads, Pre<BM>::kSmem, st>>>(
      maps, c.s, c.y, c.splits > 1 ? c.ws : nullptr, c.M, c.N, c.K,
      c.k_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess || c.splits == 1) return err;
  return launch_combine<0>(c, st);
}

// 128 rows of h a CTA up to kPreWideM rows, 256 above (twice the MMA work
// for each dequantized weight); ops/w8a16.py::w8a16_split_plan mirrors
// the choice
template <bool TIED>
cudaError_t launch_prefill(const Call& c, cudaStream_t st) {
  return c.M <= kPreWideM ? launch_prefill_bm<128, TIED>(c, st)
                          : launch_prefill_bm<256, TIED>(c, st);
}

// ---- float32 h: CUDA cores -------------------------------------------------

constexpr int BM = 64;   // rows of h a CTA
constexpr int BN = 64;   // columns of W a CTA
constexpr int BK = 32;   // K step
constexpr int PAD_F32 = 1;   // float padding a shared row

// float(q) * s is exact in float32 (8 x 8 significant bits). A float32
// consumer takes it unrounded, except through the tied head (ROUND),
// which the compiled reference rounds to bf16 first (see
// kubedl_tpu_torch/ops/w8a16.py)
template <bool ROUND>
__device__ __forceinline__ float deq_f32(int8_t q, float s) {
  const float w = static_cast<float>(q) * s;
  return ROUND ? __bfloat162float(__float2bfloat16_rn(w)) : w;
}

// ---- the h tile: BM x BK of float, 16-byte chunks, staged in registers ----
template <int NT>
struct ATile {
  static constexpr int EPC = 4;                // elements a chunk
  static constexpr int CPR = BK / EPC;         // chunks a row
  static constexpr int CHUNKS = BM * CPR;
  static constexpr int PER = (CHUNKS + NT - 1) / NT;
  int4 r[PER];

  __device__ __forceinline__ void load(const float* __restrict__ h, int M,
                                       int K, int m0, int k0, int tid) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = tid + p * NT;
      const int m = c / CPR, kc = (c % CPR) * EPC;
      r[p] = make_int4(0, 0, 0, 0);
      // K is a multiple of 16, so a chunk that starts inside K ends there
      if (c < CHUNKS && m0 + m < M && k0 + kc < K) {
        r[p] = __ldg(reinterpret_cast<const int4*>(
            h + static_cast<size_t>(m0 + m) * K + k0 + kc));
      }
    }
  }

  template <int LD>
  __device__ __forceinline__ void store(float* s, int tid) const {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = tid + p * NT;
      if (c >= CHUNKS) continue;
      const int m = c / CPR, kc = (c % CPR) * EPC;
      const float* v = reinterpret_cast<const float*>(&r[p]);
#pragma unroll
      for (int e = 0; e < EPC; ++e) s[m * LD + kc + e] = v[e];
    }
  }
};

// ---- the int8 weight tile: BK x BN of W, 16-byte chunks ----
// Stored to shared memory dequantized as s[n][k] (n-major).
template <bool TIED, int NT>
struct WTile {
  static constexpr int CHUNKS = BK * BN / 16;
  static constexpr int PER = (CHUNKS + NT - 1) / NT;
  int4 r[PER];

  // chunk c -> (k offset, n offset) inside the tile, and its 16 bytes run
  // along n (layer layout [K, N]) or along k (tied layout [N, K])
  static __device__ __forceinline__ void where(int c, int& kt, int& nt) {
    if (TIED) {
      nt = c / (BK / 16);
      kt = (c % (BK / 16)) * 16;
    } else {
      kt = c / (BN / 16);
      nt = (c % (BN / 16)) * 16;
    }
  }

  __device__ __forceinline__ void load(const int8_t* __restrict__ q, int N,
                                       int K, int n0, int k0, int tid) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = tid + p * NT;
      r[p] = make_int4(0, 0, 0, 0);
      if (c >= CHUNKS) continue;
      int kt, nt;
      where(c, kt, nt);
      const int k = k0 + kt, n = n0 + nt;
      // N and K are multiples of 16: a chunk starting inside ends inside
      if (k < K && n < N) {
        const int8_t* src = TIED ? q + static_cast<size_t>(n) * K + k
                                 : q + static_cast<size_t>(k) * N + n;
        r[p] = __ldg(reinterpret_cast<const int4*>(src));
      }
    }
  }

  template <int LD>
  __device__ __forceinline__ void store(float* s, const float* scale,
                                        int tid) const {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = tid + p * NT;
      if (c >= CHUNKS) continue;
      int kt, nt;
      where(c, kt, nt);
      const int8_t* b = reinterpret_cast<const int8_t*>(&r[p]);
      if (TIED) {
        const float sc = scale[nt];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          s[nt * LD + kt + j] = deq_f32<TIED>(b[j], sc);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          s[(nt + j) * LD + kt] = deq_f32<TIED>(b[j], scale[nt + j]);
      }
    }
  }
};

__device__ __forceinline__ void load_scales(float* scale,
                                            const __nv_bfloat16* s8, int N,
                                            int n0, int tid) {
  if (tid < BN) {
    const int n = n0 + tid;
    scale[tid] = n < N ? __bfloat162float(s8[n]) : 0.0f;
  }
}

constexpr int F32_THREADS = 256;

template <bool TIED>
__global__ void __launch_bounds__(F32_THREADS)
w8a16_f32_kernel(const float* __restrict__ h, const int8_t* __restrict__ q8,
                 const __nv_bfloat16* __restrict__ s8, float* __restrict__ y,
                 int M, int N, int K) {
  constexpr int LD = BK + PAD_F32;
  __shared__ float sA[BM * LD];
  __shared__ float sB[BN * LD];
  __shared__ float scale[BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tx = tid % 16, ty = tid / 16;  // 16 x 16 threads, 4 x 4 each

  ATile<F32_THREADS> at;
  WTile<TIED, F32_THREADS> wt;
  load_scales(scale, s8, N, n0, tid);
  at.load(h, M, K, m0, 0, tid);
  wt.load(q8, N, K, n0, 0, tid);
  __syncthreads();
  at.template store<LD>(sA, tid);
  wt.template store<LD>(sB, scale, tid);
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int ksteps = (K + BK - 1) / BK;
  for (int ks = 0; ks < ksteps; ++ks) {
    const bool more = ks + 1 < ksteps;
    if (more) {
      at.load(h, M, K, m0, (ks + 1) * BK, tid);
      wt.load(q8, N, K, n0, (ks + 1) * BK, tid);
    }
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[(ty + 16 * i) * LD + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[(tx + 16 * j) * LD + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      at.template store<LD>(sA, tid);
      wt.template store<LD>(sB, scale, tid);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// The route a call takes unless forced: 0 cuda_core, 1 decode, 2 prefill.
extern "C" int kdl_w8a16_route(int M, int N, int K, int dtype, int tied) {
  (void)N;
  (void)K;
  (void)tied;
  return route_of(M, dtype);
}

// dtype: 1 = bf16 h and y, 0 = float32. route: as kdl_w8a16_route (bf16
// takes decode or prefill, float32 cuda_core). A bf16 route's split plan
// (splits, k_slice) comes from ops/w8a16.py::w8a16_split_plan; with
// splits > 1, ws is float32 [splits, M, N]. Returns cudaGetLastError().
extern "C" int kdl_w8a16_matmul(const void* h, const void* q8,
                                const void* s8, void* y, void* ws, int M,
                                int N, int K, int tied, int dtype, int route,
                                int splits, int k_slice, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || K % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const int8_t*>(q8);
  const auto* s = static_cast<const __nv_bfloat16*>(s8);
  if (dtype == 0) {
    if (route != kRouteCudaCore) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const auto* a = static_cast<const float*>(h);
    auto* out = static_cast<float*>(y);
    if (tied)
      w8a16_f32_kernel<true><<<grid, F32_THREADS, 0, st>>>(a, q, s, out, M, N, K);
    else
      w8a16_f32_kernel<false><<<grid, F32_THREADS, 0, st>>>(a, q, s, out, M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  // the slices [z k_slice, (z + 1) k_slice) tile K, none empty, each a
  // whole number of the route's k-steps
  const int step = route == kRoutePrefill ? kPreBK : kDecBK;
  if ((route != kRouteDecode && route != kRoutePrefill) || splits < 1 ||
      k_slice < 1 || (k_slice % step != 0 && k_slice < K) ||
      (long long)splits * k_slice < K ||
      (long long)(splits - 1) * k_slice >= K || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{static_cast<const __nv_bfloat16*>(h), q, s,
               static_cast<__nv_bfloat16*>(y), static_cast<float*>(ws),
               M, N, K, splits, k_slice};
  if (route == kRoutePrefill)
    return static_cast<int>(tied ? launch_prefill<true>(c, st)
                                 : launch_prefill<false>(c, st));
  return static_cast<int>(tied ? launch_decode<true>(c, st)
                               : launch_decode<false>(c, st));
}
