// Weight-only int8 matmul (W8A16) for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's `h @ deq(w)`
// (kubedl_tpu/models/llama.py:300-304, :332-337) is fused by XLA, which
// folds the int8 convert and the per-column scale into the dot so that
// device memory reads one byte a weight. This kernel is that fusion:
//
//   W[k, n] = float(q8[k, n]) * float(s8[n])   -- exact in float32,
//             rounded once to h's type (to bf16 through the tied head)
//   y[m, n] = sum_k h[m, k] * W[k, n]           -- fp32 sums
//
// q8 is int8 [K, N] with s8 bf16 [1, N] (a layer weight), or with
// `tied` int8 [N, K] with s8 [N, 1] read as its transpose (a tied
// embedding used as the lm head). h is [M, K] row-major, bf16 or float32;
// y [M, N] has h's type.
//
// What bounds it on an H100: at decode (M <= 64) the int8 weight bytes
// (one read of K*N bytes at 3.35 TB/s: 17.5 us for 4096 x 14336); at
// prefill (M in the thousands) the tensor cores. The design, simple and
// right first:
//   - one CTA per 64 x 64 tile of y, looping over K in steps of 32; each
//     weight byte is read once per 64 rows of h, so at decode the weight
//     is read exactly once;
//   - the next K step's h and int8 tiles are loaded into registers with
//     16-byte loads while the current step computes from shared memory
//     (register staging: one step of overlap);
//   - the int8 tile is widened in registers, scaled (and, for bf16 h,
//     rounded to bf16), then stored to shared memory as [n][k], the
//     layout the mma B fragment reads as 32-bit pairs;
//   - bf16 h: 4 warps, each a 32 x 32 sub-tile of mma.sync m16n8k16
//     (bf16 in, fp32 accumulators), fragments read from padded shared
//     memory;
//   - float32 h: 256 threads, each a 4 x 4 micro-tile of float32 FMAs on
//     CUDA cores (TF32 would break the float32 contract).
// Split-K at small M and wgmma on TMA-staged tiles are left to a later
// change. The kernel launches on the caller's stream and allocates
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of h a CTA
constexpr int BN = 64;   // columns of W a CTA
constexpr int BK = 32;   // K step
constexpr int PAD_BF16 = 8;  // bf16 padding a shared row (keeps 16 B rows)
constexpr int PAD_F32 = 1;   // float padding a shared row

// float(q) * s is exact in float32 (8 x 8 significant bits). A bf16
// consumer takes it rounded once to nearest even (the reference's bf16
// multiply); a float32 consumer takes it unrounded, except through the
// tied head (ROUND), which the compiled reference rounds to bf16 first
// (see kubedl_tpu_torch/ops/w8a16.py)
template <typename U, bool ROUND>
struct Deq;
template <bool ROUND>
struct Deq<__nv_bfloat16, ROUND> {
  static __device__ __forceinline__ __nv_bfloat16 of(int8_t q, float s) {
    return __float2bfloat16_rn(static_cast<float>(q) * s);
  }
};
template <bool ROUND>
struct Deq<float, ROUND> {
  static __device__ __forceinline__ float of(int8_t q, float s) {
    const float w = static_cast<float>(q) * s;
    return ROUND ? __bfloat162float(__float2bfloat16_rn(w)) : w;
  }
};

// ---- the h tile: BM x BK of T, 16-byte chunks, staged in registers ----
template <typename T, int NT>
struct ATile {
  static constexpr int EPC = 16 / sizeof(T);   // elements a chunk
  static constexpr int CPR = BK / EPC;         // chunks a row
  static constexpr int CHUNKS = BM * CPR;
  static constexpr int PER = (CHUNKS + NT - 1) / NT;
  int4 r[PER];

  __device__ __forceinline__ void load(const T* __restrict__ h, int M, int K,
                                       int m0, int k0, int tid) {
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
  __device__ __forceinline__ void store(T* s, int tid) const {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = tid + p * NT;
      if (c >= CHUNKS) continue;
      const int m = c / CPR, kc = (c % CPR) * EPC;
      if constexpr ((LD * sizeof(T)) % 16 == 0) {
        *reinterpret_cast<int4*>(s + m * LD + kc) = r[p];
      } else {
        const T* v = reinterpret_cast<const T*>(&r[p]);
#pragma unroll
        for (int e = 0; e < EPC; ++e) s[m * LD + kc + e] = v[e];
      }
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

  template <typename U, int LD>
  __device__ __forceinline__ void store(U* s, const float* scale,
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
          s[nt * LD + kt + j] = Deq<U, TIED>::of(b[j], sc);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          s[(nt + j) * LD + kt] = Deq<U, TIED>::of(b[j], scale[nt + j]);
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

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- bf16 h: tensor cores ----
constexpr int TC_THREADS = 128;

template <bool TIED>
__global__ void __launch_bounds__(TC_THREADS)
w8a16_tc_kernel(const __nv_bfloat16* __restrict__ h,
                const int8_t* __restrict__ q8,
                const __nv_bfloat16* __restrict__ s8,
                __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  constexpr int LD = BK + PAD_BF16;  // 40 bf16 = 80 bytes a row
  __shared__ __align__(16) __nv_bfloat16 sA[BM * LD];
  __shared__ __align__(16) __nv_bfloat16 sB[BN * LD];
  __shared__ float scale[BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // 2 x 2 warps
  const int g = lane / 4, t2 = (lane % 4) * 2;

  ATile<__nv_bfloat16, TC_THREADS> at;
  WTile<TIED, TC_THREADS> wt;
  load_scales(scale, s8, N, n0, tid);
  at.load(h, M, K, m0, 0, tid);
  wt.load(q8, N, K, n0, 0, tid);
  __syncthreads();  // the scales
  at.template store<LD>(sA, tid);
  wt.template store<__nv_bfloat16, LD>(sB, scale, tid);
  __syncthreads();

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int ksteps = (K + BK - 1) / BK;
  for (int ks = 0; ks < ksteps; ++ks) {
    const bool more = ks + 1 < ksteps;
    if (more) {  // next step's tiles into registers, under this compute
      at.load(h, M, K, m0, (ks + 1) * BK, tid);
      wt.load(q8, N, K, n0, (ks + 1) * BK, tid);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* p = sA + (wm + i * 16 + g) * LD + kk + t2;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = sB + (wn + j * 8 + g) * LD + kk + t2;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // every warp is done reading this step's tiles
    if (more) {
      at.template store<LD>(sA, tid);
      wt.template store<__nv_bfloat16, LD>(sB, scale, tid);
      __syncthreads();
    }
  }

  // epilogue: c0,c1 at (g, t2..t2+1), c2,c3 at (g+8, t2..t2+1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + j * 8 + t2;
      if (n >= N) continue;  // N % 16 == 0: n + 1 < N as well
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + i * 16 + g + half * 8;
        if (m >= M) continue;
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[i][j][2 * half],
                                                 acc[i][j][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(
            y + static_cast<size_t>(m) * N + n) = v;
      }
    }
  }
}

// ---- float32 h: CUDA cores ----
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

  ATile<float, F32_THREADS> at;
  WTile<TIED, F32_THREADS> wt;
  load_scales(scale, s8, N, n0, tid);
  at.load(h, M, K, m0, 0, tid);
  wt.load(q8, N, K, n0, 0, tid);
  __syncthreads();
  at.template store<LD>(sA, tid);
  wt.template store<float, LD>(sB, scale, tid);
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
      wt.template store<float, LD>(sB, scale, tid);
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

// dtype: 1 = bf16 h and y, 0 = float32. Returns cudaGetLastError().
extern "C" int kdl_w8a16_matmul(const void* h, const void* q8,
                                const void* s8, void* y, int M, int N, int K,
                                int tied, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || K % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const auto* q = static_cast<const int8_t*>(q8);
  const auto* s = static_cast<const __nv_bfloat16*>(s8);
  if (dtype == 1) {
    const auto* a = static_cast<const __nv_bfloat16*>(h);
    auto* out = static_cast<__nv_bfloat16*>(y);
    if (tied)
      w8a16_tc_kernel<true><<<grid, TC_THREADS, 0, st>>>(a, q, s, out, M, N, K);
    else
      w8a16_tc_kernel<false><<<grid, TC_THREADS, 0, st>>>(a, q, s, out, M, N, K);
  } else {
    const auto* a = static_cast<const float*>(h);
    auto* out = static_cast<float*>(y);
    if (tied)
      w8a16_f32_kernel<true><<<grid, F32_THREADS, 0, st>>>(a, q, s, out, M, N, K);
    else
      w8a16_f32_kernel<false><<<grid, F32_THREADS, 0, st>>>(a, q, s, out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
