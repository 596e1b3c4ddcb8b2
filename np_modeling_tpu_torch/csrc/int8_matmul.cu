// Int8-weight matmul for Hopper (sm_90a):
//   out = round_once(x @ bf16(fp32(w_int8) * scale[col]) + bias), fp32 accumulation.
//
// Replaces the Pallas TPU kernel _int8_mm_tile of np_modeling_tpu/ops/quantization.py
// (:242, called by int8_matmul at :307). Like it, the weight leaves device memory as
// int8 and each [BK, BN] tile is dequantized on the chip with the rounding of
// dequantize_params: int8 -> fp32, times the column's fp32 scale, round to bf16. Unlike
// the TPU path (which rounds the product to the output dtype and then adds the bias in
// a second rounding, and casts fp32 x to bf16 first), the bias is added in fp32 and
// the sum rounded once, as the JAX package's off-TPU path (:290-295) and the port's
// ops.linear do; fp32 x keeps its precision.
//
// What bounds it. At decode (m = 8 rows) the int8 weight is nearly all of the bytes
// (2.36 MB for [768, 3072]) and the products are few: device-memory bytes bound it.
// At prefill (m = 1792) the bf16 products (8.5 GFLOP for the same weight) bound it.
// This first kernel is the simple one: one block per [64, 64] output tile, a loop over
// k in steps of 32 with synchronous 16-byte loads staged in shared memory, the
// dequantized tile stored as bf16 beside the x tile. bf16 x runs on the tensor cores
// (mma.sync m16n8k16, fp32 accumulators; warp w owns rows 16w..16w+15, and a warp
// whose rows all lie past m skips the products); fp32 x runs on an FMA path over the
// same bf16 weights widened to fp32. Ragged m, n and k are masked; 16-byte loads are
// used only where k or n and the pointers allow. Split-K for the decode shapes (48
// blocks for 132 SMs), cp.async/TMA pipelining and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;
constexpr int kLdX = kBK + 8;  // pitch of the x tile, elements (rows stay 16-byte aligned)
constexpr int kLdW = kBN + 8;  // pitch of the bf16 weight tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// mma.m16n8k16 fragments (g = lane / 4, t = lane % 4), as in flash_attention.cu:
//   A 16x16 row-major: a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                      a3 = (g+8, 2t+8..)
//   B 16x8 (k x n):    b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C 16x8 fp32:       c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_col2(const bf16* p, int ld) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + ld);
  return lo | (hi << 16);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage x[m0.., k0..] (row-major [m, k]) into xs[kBM][kLdX]; zeros past m and k.
template <typename TX>
__device__ __forceinline__ void load_x(TX* xs, const TX* __restrict__ x, int m, int k,
                                       int m0, int k0, bool vec) {
  constexpr int E = 16 / sizeof(TX);  // elements in 16 bytes: 8 bf16 or 4 fp32
  constexpr int kPerRow = kBK / E;
  for (int c = threadIdx.x; c < kBM * kPerRow; c += kThreads) {
    const int r = c / kPerRow, col = (c % kPerRow) * E;
    const int gr = m0 + r, gc = k0 + col;
    TX* dst = xs + r * kLdX + col;
    if (vec && gr < m && gc + E <= k) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(x + static_cast<size_t>(gr) * k + gc);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j)
        dst[j] = (gr < m && gc + j < k) ? x[static_cast<size_t>(gr) * k + gc + j]
                                        : from_f<TX>(0.f);
    }
  }
}

// Stage w[k0.., n0..] (row-major int8 [k, n]) dequantized into ws[kBK][kLdW]:
// bf16(fp32(w) * scale), zeros past k and n. One 16-byte chunk a thread.
__device__ __forceinline__ void load_w(bf16* ws, const int8_t* __restrict__ w,
                                       const float* ss, int n, int k, int k0, int n0,
                                       bool vec) {
  static_assert(kBK * kBN == kThreads * 16, "one 16-byte chunk a thread");
  const int r = threadIdx.x / (kBN / 16), col = (threadIdx.x % (kBN / 16)) * 16;
  const int gr = k0 + r, gc = n0 + col;
  const int8_t* src = w + static_cast<size_t>(gr) * n + gc;
  union {
    uint4 u;
    int8_t b[16];
  } v;
  if (vec && gr < k && gc + 16 <= n) {
    v.u = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) v.b[j] = (gr < k && gc + j < n) ? src[j] : int8_t(0);
  }
  bf16* dst = ws + r * kLdW + col;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    dst[j] = __float2bfloat16_rn(static_cast<float>(v.b[j]) * ss[col + j]);
}

template <typename TX, typename TO>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   TO* __restrict__ out, int m, int n, int k, bool vec_x, bool vec_w) {
  constexpr bool kMma = std::is_same<TX, bf16>::value;
  __shared__ __align__(16) TX xs[kBM * kLdX];
  __shared__ __align__(16) bf16 ws[kBK * kLdW];
  __shared__ float ss[kBN];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;     // mma fragment coordinates
  const int ty = tid / 16, tx = tid % 16;   // FMA path: rows ty + 8i, cols tx + 16j
  if (tid < kBN) ss[tid] = n0 + tid < n ? scale[n0 + tid] : 0.f;
  const bool rows_live = m0 + warp * 16 < m;  // warp-uniform

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();  // ss

  for (int k0 = 0; k0 < k; k0 += kBK) {
    load_x<TX>(xs, x, m, k, m0, k0, vec_x);
    load_w(ws, w, ss, n, k, k0, n0, vec_w);
    __syncthreads();
    if constexpr (kMma) {
      if (rows_live) {
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          const bf16* xr = xs + (warp * 16 + g) * kLdX + kk + 2 * t;
          const uint32_t a[4] = {ld32(xr), ld32(xr + 8 * kLdX), ld32(xr + 8),
                                 ld32(xr + 8 * kLdX + 8)};
          const bf16* wb = ws + (kk + 2 * t) * kLdW + g;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mma(acc[j], a, ld_col2(wb + 8 * j, kLdW), ld_col2(wb + 8 * kLdW + 8 * j, kLdW));
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = to_f(ws[kk * kLdW + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xv = to_f(xs[(ty + 8 * i) * kLdX + kk]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue: bias in fp32, one rounding to TO.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int row, col;
      if constexpr (kMma) {  // acc[i] is n-tile i; j = (row half, column pair)
        row = m0 + warp * 16 + g + 8 * (j / 2);
        col = n0 + 8 * i + 2 * t + (j % 2);
      } else {
        row = m0 + ty + 8 * i;
        col = n0 + tx + 16 * j;
      }
      if (row < m && col < n) {
        const float v = acc[i][j] + (bias != nullptr ? bias[col] : 0.f);
        out[static_cast<size_t>(row) * n + col] = from_f<TO>(v);
      }
    }
  }
}

template <typename TX, typename TO>
int launch(const void* x, const int8_t* w, const float* scale, const float* bias, void* out,
           int m, int n, int k, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_x = k % (16 / static_cast<int>(sizeof(TX))) == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  int8_matmul_kernel<TX, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), w, scale, bias, static_cast<TO*>(out), m, n, k, vec_x,
      vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x [m, k] and out [m, n] row-major, w [k, n]
// int8 row-major, scale [n] fp32, bias [n] fp32 or null. Returns cudaGetLastError() of
// the launch (0 on success); the caller has validated shapes, dtypes and layout.
extern "C" int np_int8_matmul(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int x_dtype, int out_dtype,
                              int m, int n, int k, void* stream) {
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bs = static_cast<const float*>(bias);
  if (x_dtype == 1 && out_dtype == 1) return launch<bf16, bf16>(x, wq, sc, bs, out, m, n, k, s);
  if (x_dtype == 1 && out_dtype == 0) return launch<bf16, float>(x, wq, sc, bs, out, m, n, k, s);
  if (x_dtype == 0 && out_dtype == 1) return launch<float, bf16>(x, wq, sc, bs, out, m, n, k, s);
  if (x_dtype == 0 && out_dtype == 0) return launch<float, float>(x, wq, sc, bs, out, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
