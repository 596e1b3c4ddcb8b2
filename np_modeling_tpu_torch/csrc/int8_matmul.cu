// Int8-weight matmul for Hopper (sm_90a):
//   out = round_once(x @ bf16(fp32(w_int8) * scale[col]) + bias), fp32 accumulation.
//
// Replaces the Pallas TPU kernel _int8_mm_tile of np_modeling_tpu/ops/quantization.py
// (:242, called by int8_matmul at :307). Like it, the weight leaves device memory as
// int8 and is dequantized on the chip with the rounding of dequantize_params: int8 ->
// fp32, times the column's fp32 scale, round to bf16, element by element (the scale
// rounds per element, so it cannot be pulled out of the k sum). Unlike the TPU path
// (which rounds the product to the output dtype and then adds the bias in a second
// rounding, and casts fp32 x to bf16 first), the bias is added in fp32 and the sum
// rounded once, as the JAX package's off-TPU path (:290-295) and the port's ops.linear
// do; fp32 x keeps its precision. Only the order of the fp32 sums differs between the
// schedules below, and each schedule sums in a fixed order: the same bits every run.
//
// Three schedules, chosen by the wrapper's plan from shapes alone
// (ops/quantization.py plan()):
//
// skinny: bf16 x with m <= 64, the decode shapes ([8, 768] x [768, 3072] and [8, 3072]
//   x [3072, 768] on GPT-2 small's quantized FFN). There the 2.36 MB int8 weight is
//   nearly all of the bytes (16 operations a byte) and it is about one memory latency's
//   worth of bytes for this card, so latency and the number of blocks in flight bound
//   it, not bandwidth. The operands are swapped: out^T [n, m] = W'^T [n, k] x^T [k, m],
//   so the weight fills the 16-row M side of mma.sync m16n8k16 and the m rows of x its
//   n8 side: at m = 8 no tensor-core work is padding (wgmma's 64-row minimum would buy
//   nothing at 16 operations a byte). A block owns an n tile of 32, 64 or 128 columns
//   and a k range of a multiple of 64 rows; it issues every byte of its weight tile at
//   once (cp.async, 16-byte chunks) before it computes, keeps the weight int8 in shared
//   memory and dequantizes it with the column's scale as it builds the A fragments. A
//   lane reads one 32-bit word (4 columns 4g..4g+3 of one k row): its bytes are rows
//   g and g + 8 of two 16-row tiles, and a lane's k rows t, t + 4, t + 8, t + 12 of a
//   16-deep step are the mma's k 2t, 2t + 1, 2t + 8, 2t + 9 (x's B fragments are read
//   in the same order), so the reads are whole words without bank conflicts. x's rows
//   come in the same cp.async round trip as the weight. Splits of k are the blocks of
//   one thread-block cluster (up to 16, the non-portable size above 8). Each block
//   leaves its fp32 partial [m, n tile] in its own shared memory; after a cluster
//   barrier each rank reads its share of the tile from every rank's shared memory
//   (distributed shared memory), sums the ranks in rank order, adds the bias and
//   rounds once: no fp32 workspace in device memory, no second launch. (Pushing each
//   partial into its owner's shared memory, one barrier fewer, measured 1.5x slower
//   on the H100: remote stores cost more than the barrier; PERF.md.)
//
// wide: bf16 x with m > 64 (the prefill shapes, m = 1792) where TMA can read x and the
//   weight. There the bf16 products bound it (8.5 GFLOP for [1792, 768] x [768, 3072]).
//   K11's consumer design (matmul.cu): a persistent block of two consumer warpgroups
//   on wgmma m64n128k16 over a [128, 128] tile, x through a TMA ring as the K-major A
//   operand, and the weight's int8 [64, 128] slices through the same ring by TMA: half
//   the bytes of a bf16 weight from memory. The consumers dequantize each slice (one
//   integer-to-float trick, one fp32 multiply and one rounding to bf16 an element)
//   into the 128-byte-swizzled MN-major B layout that K11's ragged variant writes
//   through registers, the next slice while the tensor cores run this one: the
//   dequantization needs more warps than a producer warpgroup has, and the consumers'
//   ALUs are idle while wgmma runs. Split-k only where the output tiles do not fill
//   the card (K11's rule), into an fp32 workspace that a second kernel sums in split
//   order. TMA needs both operands' rows whole 16-byte vectors: k a multiple of 8, n
//   of 16.
//
// simple: today's first kernel, for fp32 x and any shape the other two do not take:
//   one block per [64, 64] output tile, a loop over k in steps of 32 with synchronous
//   16-byte loads staged in shared memory, the dequantized tile stored as bf16 beside
//   the x tile; bf16 x on mma.sync, fp32 x on an FMA path over the same bf16 weights
//   widened to fp32. Ragged m, n and k are masked in every schedule.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

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
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte i of `u` as an exact float: 2^23 + (byte + 128) built by a byte permute, less
// 2^23 + 128 (one integer op and one add in place of a conversion).
template <int I>
__device__ __forceinline__ float int8_at(uint32_t u) {
  const uint32_t biased = __byte_perm(u ^ 0x80808080u, 0x4B000000u, 0x7650 | I);
  return __uint_as_float(biased) - 8388736.f;
}

// The four int8 values of `u`, dequantized: fp32(w) * s[i], each rounded once to fp32.
__device__ __forceinline__ void dequant4(uint32_t u, const float* s, float (&f)[4]) {
  f[0] = int8_at<0>(u) * s[0];
  f[1] = int8_at<1>(u) * s[1];
  f[2] = int8_at<2>(u) * s[2];
  f[3] = int8_at<3>(u) * s[3];
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---- simple: today's first kernel -----------------------------------------------

namespace simple {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;
constexpr int kLdX = kBK + 8;  // pitch of the x tile, elements (rows stay 16-byte aligned)
constexpr int kLdW = kBN + 8;  // pitch of the bf16 weight tile

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_col2(const bf16* p, int ld) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + ld);
  return lo | (hi << 16);
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

}  // namespace simple

// ---- skinny: m <= 64, split k across a thread-block cluster --------------------------

namespace skinny {

constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxRanks = 16;  // cluster size: k splits of one n tile

// Row pitches in bytes. The weight's: 8 (mod 32) words, so that a warp's reads of
// rows t + 4i (t = 0..3) at 8 words a row each fall on 32 banks. x's: 4 (mod 32)
// words, so that rows g = 0..7 of a warp's 16-bit reads at columns t + 4i start on 8
// bank groups and lanes t, t + 1 share a word.
__host__ __device__ constexpr int w_pitch(int nt) { return nt == 32 ? 32 : nt + 32; }
__host__ __device__ constexpr int x_pitch(int kr) { return 2 * kr + 16; }
// The block's partials: [4 / (nt / 32)][MP][nt] fp32, its warps' k quarters.
__host__ __device__ constexpr int smem_bytes(int mt, int nt, int kr) {
  return kr * w_pitch(nt) + 8 * mt * x_pitch(kr) + 4 * kThreads * 8 * mt;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The fp32 at this block's shared address `addr` in the shared memory of cluster rank r.
__device__ __forceinline__ float ld_rank(uint32_t addr, int r) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(r));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Grid (splits, n tiles), cluster (splits, 1, 1): block (s, j) owns columns [j nt, j nt
// + nt) and k rows [s kr, s kr + kr) and is rank s of its cluster. MT: 8-row groups
// of x (m <= 8 MT). Warp w owns the 32-column group w % (nt / 32) and the k quarter,
// half or whole w / (nt / 32) of the block's rows. The block sums its warps' k quarters
// in order into its partial of the m x nt tile; after a cluster barrier each rank reads
// its range of the tile (ceil(m nt / ranks) elements) from every rank's shared memory
// (distributed shared memory), sums the ranks in rank order, adds the bias and rounds
// once; a second barrier keeps every block until the others have read its partial.
template <typename TO, int MT>
__global__ void __launch_bounds__(kThreads)
int8_mm_skinny(const bf16* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               TO* __restrict__ out, int m, int n, int k, int nt, int kr, bool vec_x,
               bool vec_w) {
  constexpr int MP = 8 * MT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int wp = w_pitch(nt), xp = x_pitch(kr);
  uint8_t* ws = smem;                                     // [kr][wp] int8
  uint8_t* xs = ws + kr * wp;                             // [MP][xp] bf16
  float* ps = reinterpret_cast<float*>(xs + MP * xp);     // [128 / nt][MP][nt] fp32
  const int rank = blockIdx.x, ranks = gridDim.x;
  const int n0 = blockIdx.y * nt, k0 = rank * kr;
  const int tid = threadIdx.x;

  // Every byte of the weight tile and of x's rows [0, MP) and k [k0, k0 + kr), issued
  // at once; zeros past m, k and n.
  const int chunks_row = nt / 16;
  for (int c = tid; c < kr * chunks_row; c += kThreads) {
    const int r = c / chunks_row, col = (c % chunks_row) * 16;
    const int gr = k0 + r, gc = n0 + col;
    uint8_t* dst = ws + r * wp + col;
    const int8_t* src = w + static_cast<size_t>(gr) * n + gc;
    if (vec_w) {
      const bool in = gr < k && gc < n;  // n % 16 == 0: a chunk is all in or all out
      wg::cp_async16(wg::smem_u32(dst), in ? src : w, in ? 16 : 0);
    } else {
      union {
        uint4 u;
        int8_t b[16];
      } v;
#pragma unroll
      for (int j = 0; j < 16; ++j) v.b[j] = (gr < k && gc + j < n) ? src[j] : int8_t(0);
      *reinterpret_cast<uint4*>(dst) = v.u;
    }
  }
  if (vec_x) {  // k % 8 == 0 and x 16-byte aligned: a chunk is all in or all out
    const int vecs_row = kr / 8;
    for (int c = tid; c < MP * vecs_row; c += kThreads) {
      const int r = c / vecs_row, kk = (c % vecs_row) * 8;
      const bool in = r < m && k0 + kk < k;
      wg::cp_async16(wg::smem_u32(xs + r * xp + 2 * kk),
                     in ? x + static_cast<size_t>(r) * k + k0 + kk : x, in ? 16 : 0);
    }
  } else {
    for (int c = tid; c < MP * kr; c += kThreads) {
      const int r = c / kr, kk = c % kr;
      reinterpret_cast<bf16*>(xs + r * xp)[kk] =
          (r < m && k0 + kk < k) ? x[static_cast<size_t>(r) * k + k0 + kk]
                                 : __float2bfloat16_rn(0.f);
    }
  }
  wg::cp_async_commit();

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int groups = nt / 32;
  const int cg = warp % groups, quarter = warp / groups, kw = 4 / groups;
  float sc[4];  // the scales of this lane's columns 4g .. 4g + 3 of its group
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int col = n0 + cg * 32 + 4 * g + b;
    sc[b] = col < n ? scale[col] : 0.f;
  }
  wg::cp_async_wait<0>();
  __syncthreads();

  // acc[j][T]: the 16 x 8 tile T (columns 4g + 2T, 4g + 2T + 1) x rows 8j .. of x.
  float acc[MT][2][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][T][c] = 0.f;
  const int rows = kr / kw, r_begin = quarter * rows;
  const uint8_t* wcol = ws + cg * 32 + 4 * g;
  for (int r0 = r_begin; r0 < r_begin + rows; r0 += 16) {
    float f[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dequant4(*reinterpret_cast<const uint32_t*>(wcol + (r0 + t + 4 * i) * wp), sc, f[i]);
    uint32_t a[2][4];
#pragma unroll
    for (int T = 0; T < 2; ++T) {
      a[T][0] = wg::pack_bf16(f[0][2 * T], f[1][2 * T]);
      a[T][1] = wg::pack_bf16(f[0][2 * T + 1], f[1][2 * T + 1]);
      a[T][2] = wg::pack_bf16(f[2][2 * T], f[3][2 * T]);
      a[T][3] = wg::pack_bf16(f[2][2 * T + 1], f[3][2 * T + 1]);
    }
#pragma unroll
    for (int j = 0; j < MT; ++j) {  // x's k rows t, t + 4 | t + 8, t + 12 of this step
      const uint16_t* xr = reinterpret_cast<const uint16_t*>(xs + (8 * j + g) * xp) + r0 + t;
      const uint32_t b0 = xr[0] | (static_cast<uint32_t>(xr[4]) << 16);
      const uint32_t b1 = xr[8] | (static_cast<uint32_t>(xr[12]) << 16);
      mma(acc[j][0], a[0], b0, b1);
      mma(acc[j][1], a[1], b0, b1);
    }
  }

  // The warps' partials, then the block's: its k quarters summed in order into ps[0].
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = cg * 32 + 4 * g + 2 * T + c / 2, row = 8 * j + 2 * t + c % 2;
        ps[(quarter * MP + row) * nt + col] = acc[j][T][c];
      }
  __syncthreads();
  if (kw > 1) {
    for (int e = tid; e < MP * nt; e += kThreads) {
      float s = ps[e];
      for (int q = 1; q < kw; ++q) s += ps[q * MP * nt + e];
      ps[e] = s;
    }
  }
  cluster_sync();  // every rank's partial is in its shared memory

  // This rank's range of the tile, summed over the ranks in rank order.
  const int total = m * nt, per = (total + ranks - 1) / ranks;
  const int e_end = min(total, (rank + 1) * per);
  const uint32_t base = wg::smem_u32(ps);
  for (int e = rank * per + tid; e < e_end; e += kThreads) {
    const int row = e / nt, col = n0 + e % nt;
    if (col >= n) continue;
    float v[kMaxRanks];
#pragma unroll
    for (int r = 0; r < kMaxRanks; ++r)
      if (r < ranks) v[r] = ld_rank(base + 4 * e, r);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxRanks; ++r)
      if (r < ranks) s += v[r];
    if (bias != nullptr) s += bias[col];
    out[static_cast<size_t>(row) * n + col] = from_f<TO>(s);
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

template <typename TO, int MT>
int launch(const void* x, const int8_t* w, const float* scale, const float* bias, void* out,
           int m, int n, int k, int nt, int splits, cudaStream_t stream) {
  const int kr = ((k + splits - 1) / splits + 63) / 64 * 64;
  const int tiles = (n + nt - 1) / nt;
  if (k < 1 || (nt != 32 && nt != 64 && nt != 128) || splits < 1 || splits > kMaxRanks ||
      (splits - 1) * kr >= k || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(MT, nt, kr);
  auto kernel = int8_mm_skinny<TO, MT>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (splits > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec_x = k % 8 == 0 && aligned16(x);
  const bool vec_w = n % 16 == 0 && aligned16(w);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x), w, scale, bias,
                           static_cast<TO*>(out), m, n, k, nt, kr, vec_x, vec_w);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int launch_m(const void* x, const int8_t* w, const float* scale, const float* bias, void* out,
             int m, int n, int k, int nt, int splits, cudaStream_t s) {
  if (m <= 8) return launch<TO, 1>(x, w, scale, bias, out, m, n, k, nt, splits, s);
  if (m <= 16) return launch<TO, 2>(x, w, scale, bias, out, m, n, k, nt, splits, s);
  if (m <= 32) return launch<TO, 4>(x, w, scale, bias, out, m, n, k, nt, splits, s);
  if (m <= 64) return launch<TO, 8>(x, w, scale, bias, out, m, n, k, nt, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace skinny

// ---- wide: m > 64, wgmma with a dequantizing producer --------------------------------

namespace wide {

constexpr int kBM = wg::kTile, kBN = wg::kTile;
constexpr int kSlice = 64;                        // k depth of a stage
constexpr int kXBytes = kBM * kSlice * 2;         // x slice [128 rows][64 k], SW128
constexpr int kI8Bytes = kSlice * kBN;            // int8 weight slice [64 k][128 n]
constexpr int kStageBytes = kXBytes + kI8Bytes;   // both by TMA, on one barrier
constexpr int kStages = 4;
constexpr int kBBytes = kSlice * kBN * 2;         // dequantized slice: [64 k][64 n] x 2
constexpr int kBBufs = 3;                         // its ring: in products, in conversion,
                                                  // free
constexpr int kConsumers = 256;                   // two consumer warpgroups
constexpr int kPairBarrier = 3;                   // named barrier of the consumers
                                                  // (the epilogue's are 1 and 2)
template <typename TO>
constexpr int smem_bytes() {
  return kStages * kStageBytes + kBBufs * kBBytes + 2 * wg::kOutBytes<TO> + 2 * kStages * 8 +
         1024;
}

// Consumer thread c's share of an int8 slice that has landed in `src` ([64 k][128 n]
// row-major): rows 32 (c / 128) + (c % 128) / 8 and + 16, columns 16 (c % 8) .. + 15,
// dequantized with those columns' scales `sc` into the B buffer: two [64 k][64 n]
// SW128 blocks at +0 and +8 KB (the MN-major B layout). The 8 threads of a row write
// their two 16-byte halves in opposite orders in the two blocks, so each store's 8
// chunks fall on 8 bank groups.
__device__ __forceinline__ void convert_slice(uint8_t* b_buf, const uint8_t* src, int c,
                                              const float (&sc)[16]) {
  const int col = 16 * (c % 8);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = 32 * (c / 128) + (c % 128) / 8 + 16 * j;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + row * kBN + col);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t packed[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float f[4];
      dequant4(words[q], sc + 4 * q, f);
      packed[2 * q] = wg::pack_bf16(f[0], f[1]);
      packed[2 * q + 1] = wg::pack_bf16(f[2], f[3]);
    }
    const uint4 lo = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    const uint4 hi = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    const bool swap = col >= 64;  // selects, not an index: packed stays in registers
    uint8_t* blk = b_buf + (col / 64) * 8192;
    *reinterpret_cast<uint4*>(blk + wg::sw128_offset(row, col % 64 + (swap ? 8 : 0))) =
        swap ? hi : lo;
    *reinterpret_cast<uint4*>(blk + wg::sw128_offset(row, col % 64 + (swap ? 0 : 8))) =
        swap ? lo : hi;
  }
}

// Persistent, 384 threads: one block an SM walks the work items (output tile, split
// of k) id = blockIdx.x, + gridDim.x, ..; split id / tiles, tile id % tiles. Thread
// 256 produces: for each k slice it loads x's [128, 64] box and the weight's int8
// [64, 128] box by TMA into a ring of kStages stages (full / empty mbarriers). The two
// consumer warpgroups own 64 rows of the tile each. They dequantize each int8 slice
// into a ring of three bf16 B buffers, half the slice a warpgroup, and issue wgmma
// m64n128k16 on it: slice i + 1 is dequantized while the tensor cores work on slice
// i, with slice i - 1's products still in flight. One named barrier of the 256
// consumers a slice orders them (a B buffer complete before its products, its
// products done before it is written again). With
// splits > 1, `out` is the fp32 workspace [splits][m][n] and the bias is added by
// splitk_reduce.
template <typename TO>
__global__ void __launch_bounds__(384, 1)
int8_mm_wide(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
             const float* __restrict__ scale, const float* __restrict__ bias,
             TO* __restrict__ out, int m, int n, int k, int k_chunk, int tiles_m, int tiles_n,
             int splits) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align1024(smem_raw);
  uint8_t* b_bufs = smem + kStages * kStageBytes;
  TO* stage_out = reinterpret_cast<TO*>(b_bufs + kBBufs * kBBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(b_bufs + kBBufs * kBBytes + 2 * wg::kOutBytes<TO>);
  uint64_t* empty = full + kStages;
  const int tiles = tiles_m * tiles_n, items = tiles * splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w = threadIdx.x / 128;
  int gi = 0;  // slices through the ring so far: stage gi % kStages, round gi / kStages
  if (w == 2) {
    if (threadIdx.x != 256) return;
    for (int id = blockIdx.x; id < items; id += gridDim.x) {
      int tm, tn;
      wg::tile_of(id % tiles, tiles_m, tiles_n, tm, tn);
      const int k_begin = (id / tiles) * k_chunk;
      const int steps = max(0, (min(k, k_begin + k_chunk) - k_begin + kSlice - 1) / kSlice);
      for (int it = 0; it < steps; ++it, ++gi) {
        const int s = gi % kStages;
        if (gi >= kStages) wg::mbar_wait(&empty[s], ((gi / kStages) - 1) & 1);
        wg::mbar_expect_tx(&full[s], kStageBytes);
        uint8_t* stage = smem + s * kStageBytes;
        const int kk = k_begin + it * kSlice;
        wg::tma_load_2d(stage, &mx, &full[s], kk, tm * kBM);
        wg::tma_load_2d(stage + kXBytes, &mw, &full[s], tn * kBN, kk);
      }
    }
    return;
  }

  const int c = threadIdx.x;  // 0 .. 255
  const bool leader = threadIdx.x % 128 == 0;
  for (int id = blockIdx.x; id < items; id += gridDim.x) {
    int tm, tn;
    wg::tile_of(id % tiles, tiles_m, tiles_n, tm, tn);
    const int m0 = tm * kBM, n0 = tn * kBN, k_begin = (id / tiles) * k_chunk;
    const int steps = max(0, (min(k, k_begin + k_chunk) - k_begin + kSlice - 1) / kSlice);
    float sc[16];  // the scales of this thread's 16 columns of the tile
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int col = n0 + 16 * (c % 8) + e;
      sc[e] = col < n ? __ldg(scale + col) : 0.f;
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    if (steps > 0) {  // the first slice's B
      wg::mbar_wait(&full[gi % kStages], (gi / kStages) & 1);
      convert_slice(b_bufs + (gi % kBBufs) * kBBytes,
                    smem + (gi % kStages) * kStageBytes + kXBytes, c, sc);
      wg::fence_proxy();
      wg::bar_sync(kPairBarrier, kConsumers);
    }
    for (int it = 0; it < steps; ++it, ++gi) {
      const int s = gi % kStages;
      const uint32_t sa = wg::smem_u32(smem + s * kStageBytes);
      const uint32_t sb = wg::smem_u32(b_bufs + (gi % kBBufs) * kBBytes);
      wg::fence();
#pragma unroll
      for (int j = 0; j < kSlice / 16; ++j)
        wg::wgmma_ss<0, 1>(acc, wg::desc(sa + w * 64 * 128 + j * 32, 16, 1024),
                           wg::desc(sb + j * 2048, 8192, 1024), 1);
      wg::commit();
      if (it + 1 < steps) {  // the next slice's B, while the tensor cores run
        const int s1 = (gi + 1) % kStages;
        wg::mbar_wait(&full[s1], ((gi + 1) / kStages) & 1);
        convert_slice(b_bufs + ((gi + 1) % kBBufs) * kBBytes,
                      smem + s1 * kStageBytes + kXBytes, c, sc);
        wg::fence_proxy();
      }
      wg::wait<1>();  // the previous slice's products are done: release its stage
      if (it > 0 && leader) wg::mbar_arrive(&empty[(gi - 1) % kStages]);
      wg::bar_sync(kPairBarrier, kConsumers);
    }
    wg::wait<0>();
    wg::fence_acc(acc);
    if (steps > 0 && leader) wg::mbar_arrive(&empty[(gi - 1) % kStages]);
    wg::epilogue<TO>(acc, stage_out + w * (wg::kOutBytes<TO> / static_cast<int>(sizeof(TO))),
                     bias, out + static_cast<size_t>(id / tiles) * m * n, m, n, m0, n0, w);
  }
}

// The map of the int8 weight [k][n] (row-major) read in boxes of [64 k][128 n], no
// swizzle, zeros past its edges; n a multiple of 16, w 16-byte aligned.
bool make_weight_map(CUtensorMap* map, const void* w, int k, int n) {
  wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n)};
  const cuuint32_t box[2] = {kBN, kSlice};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TO>
int launch_kernel(const CUtensorMap& mx, const CUtensorMap& mw, const float* scale,
                  const float* bias, TO* out, int m, int n, int k, int k_chunk, int splits,
                  cudaStream_t s) {
  const int tiles_m = (m + kBM - 1) / kBM, tiles_n = (n + kBN - 1) / kBN;
  const int smem = smem_bytes<TO>();
  auto kernel = int8_mm_wide<TO>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = std::min(tiles_m * tiles_n * splits, wg::sm_count());
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, 384, smem, s>>>(mx, mw, scale, bias, out, m, n, k, k_chunk, tiles_m, tiles_n,
                                   splits);
  return static_cast<int>(cudaGetLastError());
}

// TMA reads both operands: x and w 16-byte aligned, k a multiple of 8 and n of 16
// (their row strides), k > 0.
template <typename TO>
int launch(const void* x, const int8_t* w, const float* scale, const float* bias, void* out,
           float* ws, int m, int n, int k, int splits, cudaStream_t s) {
  if (k <= 0 || k % 8 || n % 16 || !aligned16(x) || !aligned16(w) || splits < 1 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  if (!wg::make_map(&mx, x, m, k, kBM) || !make_weight_map(&mw, w, k, n))
    return static_cast<int>(cudaErrorInvalidValue);
  const int k_chunk = ((k + splits - 1) / splits + kSlice - 1) / kSlice * kSlice;
  if (splits == 1)
    return launch_kernel<TO>(mx, mw, scale, bias, static_cast<TO*>(out), m, n, k, k_chunk, 1,
                             s);
  const int rc = launch_kernel<float>(mx, mw, scale, nullptr, ws, m, n, k, k_chunk, splits, s);
  if (rc != 0) return rc;
  const long long total = static_cast<long long>(m) * n;
  const int blocks = static_cast<int>(std::min(4096LL, (total + 255) / 256));
  wg::splitk_reduce<TO><<<blocks, 256, 0, s>>>(ws, splits, bias, static_cast<TO*>(out), m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x [m, k] and out [m, n] row-major, w [k, n]
// int8 row-major, scale [n] fp32, bias [n] fp32 or null. schedule: 0 simple, 1 skinny
// (bf16 x, m <= 64; n_tile 32, 64 or 128 columns a block; splits <= 16 k ranges, the
// blocks of one cluster), 2 wide (bf16 x, k a multiple of 8 and n of 16, x and w
// 16-byte aligned; splits > 1 k ranges summed through ws, an fp32 workspace of splits
// x m x n). A schedule refuses a shape it cannot take. Returns the first nonzero
// cudaGetLastError() of the launches (0 on success); the caller has validated shapes,
// dtypes and layout.
extern "C" int np_int8_matmul(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, void* ws, int x_dtype, int out_dtype,
                              int m, int n, int k, int schedule, int n_tile, int splits,
                              void* stream) {
  if (m == 0 || n == 0) return 0;
  if (m < 0 || n < 0 || k < 0 || (x_dtype != 0 && x_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1) || (schedule != 0 && x_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bs = static_cast<const float*>(bias);
  float* wsp = static_cast<float*>(ws);
  if (schedule == 1) {
    if (out_dtype == 1)
      return skinny::launch_m<bf16>(x, wq, sc, bs, out, m, n, k, n_tile, splits, s);
    return skinny::launch_m<float>(x, wq, sc, bs, out, m, n, k, n_tile, splits, s);
  }
  if (schedule == 2) {
    if (out_dtype == 1) return wide::launch<bf16>(x, wq, sc, bs, out, wsp, m, n, k, splits, s);
    return wide::launch<float>(x, wq, sc, bs, out, wsp, m, n, k, splits, s);
  }
  if (schedule != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 1 && out_dtype == 1)
    return simple::launch<bf16, bf16>(x, wq, sc, bs, out, m, n, k, s);
  if (x_dtype == 1 && out_dtype == 0)
    return simple::launch<bf16, float>(x, wq, sc, bs, out, m, n, k, s);
  if (x_dtype == 0 && out_dtype == 1)
    return simple::launch<float, bf16>(x, wq, sc, bs, out, m, n, k, s);
  return simple::launch<float, float>(x, wq, sc, bs, out, m, n, k, s);
}
