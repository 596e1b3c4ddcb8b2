// Tiled matrix product for Hopper (sm_90a):
//   out[m, n] = round_once(op(a) @ op(b) + bias), fp32 accumulation,
// op(a) = a or a^T and op(b) = b or b^T read in their stored (row-major) layout.
//
// Replaces the Pallas TPU kernels _mm_kernel and _mm_bias_kernel of
// np_modeling_tpu/ops/matmul.py (:27, :43; launched by matmul at :146, :150). Like
// them it keeps an fp32 accumulator for each output tile over the whole k loop, reads
// a transposed operand through its index arithmetic (no transposed copy) and adds the
// bias to the fp32 accumulator before the one rounding to the output dtype. Unlike
// them it pads nothing: ragged m, n and k are masked at the loads and the stores.
//
// What bounds it. At the GPT-2 small train step's shapes (m = 8192 tokens, k and n
// 768 or 3072) a product does 2 m k n = 9.7e9..3.9e10 operations on 13..63 MB: the
// tensor cores bound it (989 TFLOP/s bf16 against 3.35 TB/s: ~295 operations a byte).
// This first kernel is the simple one. A block of 8 warps owns a [128, 128] output
// tile and walks k in steps of 32. Each step's [128, 32] tiles of op(a) and op(b) are
// loaded into registers (16-byte vectors along the stored layout's contiguous axis,
// scalars at a ragged edge) while the tensor cores work on the previous step's tiles,
// then stored to shared memory with k contiguous: a k-contiguous operand as 16-byte
// vectors, a transposed one scattered element by element. bf16 operands run on
// mma.sync m16n8k16 (fp32 accumulators; warp w owns rows 64 (w / 4).. and columns
// 32 (w % 4)..: 4 x 4 tiles of 16 x 8); fp32 operands on an FMA path (a thread owns
// an 8 x 8 grid of outputs 16 apart). One step's loads are in flight behind the
// previous step's products, no more: cp.async/TMA pipelines, wgmma, split-k for the
// short-m weight gradients and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

// Shared-memory row pitch, elements: bf16 rows of 80 bytes stay 16-byte aligned and
// the mma fragment loads hit 32 distinct banks; fp32 rows of 33 words spread the FMA
// path's column reads over the banks.
template <typename T>
constexpr int kPitch = kIsBf16<T> ? kBK + 8 : kBK + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// One operand's [128 outer][kBK] tile: element (o, kk) of the logical operand lies at
// p[o * ld + kk] when k is contiguous in memory (KC) and at p[kk * ld + o] otherwise.
// Each thread holds kChunks 16-byte chunks of it in registers between load and store.
template <typename T, bool KC>
struct Tile {
  static constexpr int E = 16 / sizeof(T);  // elements in a chunk
  static constexpr int kChunks = 128 * kBK / E / kThreads;
  static_assert(kChunks * E * kThreads == 128 * kBK, "whole chunks a thread");
  uint4 r[kChunks];

  // (outer, k) offset of chunk c within the tile; a chunk runs along the
  // contiguous axis.
  __device__ __forceinline__ static void where(int c, int& o, int& kk) {
    if constexpr (KC) {
      o = c / (kBK / E);
      kk = (c % (kBK / E)) * E;
    } else {
      kk = c / (128 / E);
      o = (c % (128 / E)) * E;
    }
  }

  // Zeros past n_outer and k. `vec`: ld is a whole number of chunks and p is 16-byte
  // aligned, so every chunk that lies inside the matrix is one aligned vector.
  __device__ __forceinline__ void load(const T* __restrict__ p, int ld, int n_outer, int k,
                                       int o0, int k0, bool vec) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      int o, kk;
      where(threadIdx.x + i * kThreads, o, kk);
      const int go = o0 + o, gk = k0 + kk;
      T* e = reinterpret_cast<T*>(&r[i]);
      if constexpr (KC) {
        const T* src = p + static_cast<size_t>(go) * ld + gk;
        if (vec && go < n_outer && gk + E <= k) {
          r[i] = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < E; ++j)
            e[j] = (go < n_outer && gk + j < k) ? src[j] : from_f<T>(0.f);
        }
      } else {
        const T* src = p + static_cast<size_t>(gk) * ld + go;
        if (vec && gk < k && go + E <= n_outer) {
          r[i] = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < E; ++j)
            e[j] = (gk < k && go + j < n_outer) ? src[j] : from_f<T>(0.f);
        }
      }
    }
  }

  // Into s[o * pitch + kk] (k contiguous in shared memory, whatever the layout).
  __device__ __forceinline__ void store(T* s) const {
    constexpr int P = kPitch<T>;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      int o, kk;
      where(threadIdx.x + i * kThreads, o, kk);
      const T* e = reinterpret_cast<const T*>(&r[i]);
      if constexpr (KC && kIsBf16<T>) {
        *reinterpret_cast<uint4*>(s + o * P + kk) = r[i];
      } else if constexpr (KC) {
#pragma unroll
        for (int j = 0; j < E; ++j) s[o * P + kk + j] = e[j];
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) s[(o + j) * P + kk] = e[j];
      }
    }
  }
};

// mma.m16n8k16 fragments (g = lane / 4, t = lane % 4), as in flash_attention.cu:
//   A 16x16 row-major: a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                      a3 = (g+8, 2t+8..)
//   B 16x8 (k x n):    b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C 16x8 fp32:       c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// With both tiles stored k-contiguous, every fragment register is one 32-bit load.
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(float* c, const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// T: operand dtype; TO: output dtype; KA / KB: k contiguous in a's / b's memory
// (KA = !trans_a, KB = trans_b). a is [m, k] (KA) or [k, m]; b is [n, k] (KB) or
// [k, n]; out [m, n] row-major; bias fp32 [n] or null.
//
// acc holds 64 fp32 sums a thread. bf16: acc[(mi * 4 + ni) * 4 + e] is element e of
// the warp's mma tile (mi, ni), rows 64 wm + 16 mi.., columns 32 wn + 8 ni... fp32:
// acc[i * 8 + j] is output (16 i + tid / 16, 16 j + tid % 16) of the block's tile.
template <typename T, typename TO, bool KA, bool KB>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ bias,
              TO* __restrict__ out, int m, int n, int k, bool vec_a, bool vec_b) {
  constexpr int P = kPitch<T>;
  __shared__ __align__(16) T as[kBM * P];
  __shared__ __align__(16) T bs[kBN * P];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;   // mma fragment coordinates
  const int wm = warp / 4, wn = warp % 4; // the warp's 64 x 32 tile (bf16)
  const int ty = tid / 16, tx = tid % 16; // the thread's outputs (fp32)
  const int lda = KA ? k : m, ldb = KB ? k : n;
  const bool rows_live = m0 + wm * 64 < m;  // warp-uniform

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  Tile<T, KA> ta;
  Tile<T, KB> tb;
  ta.load(a, lda, m, k, m0, 0, vec_a);
  tb.load(b, ldb, n, k, n0, 0, vec_b);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    ta.store(as);
    tb.store(bs);
    __syncthreads();
    if (k0 + kBK < k) {  // the next step's tiles, in flight behind the products
      ta.load(a, lda, m, k, m0, k0 + kBK, vec_a);
      tb.load(b, ldb, n, k, n0, k0 + kBK, vec_b);
    }
    if constexpr (kIsBf16<T>) {
      if (rows_live) {
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          uint32_t af[4][4], bf[4][2];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            const bf16* ar = as + (wm * 64 + mi * 16 + g) * P + kk + 2 * t;
            af[mi][0] = ld32(ar);
            af[mi][1] = ld32(ar + 8 * P);
            af[mi][2] = ld32(ar + 8);
            af[mi][3] = ld32(ar + 8 * P + 8);
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const bf16* br = bs + (wn * 32 + ni * 8 + g) * P + kk + 2 * t;
            bf[ni][0] = ld32(br);
            bf[ni][1] = ld32(br + 8);
          }
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
              mma(acc + (mi * 4 + ni) * 4, af[mi], bf[ni][0], bf[ni][1]);
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = to_f(as[(ty + 16 * i) * P + kk]);
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = to_f(bs[(tx + 16 * j) * P + kk]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
      }
    }
    __syncthreads();
  }

  // Epilogue: the bias added to the fp32 sum, one rounding to TO.
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    int row, col;
    if constexpr (kIsBf16<T>) {
      const int tile = i / 4, e = i % 4, mi = tile / 4, ni = tile % 4;
      row = m0 + wm * 64 + mi * 16 + g + 8 * (e / 2);
      col = n0 + wn * 32 + ni * 8 + 2 * t + (e % 2);
    } else {
      row = m0 + ty + 16 * (i / 8);
      col = n0 + tx + 16 * (i % 8);
    }
    if (row < m && col < n)
      out[static_cast<size_t>(row) * n + col] =
          from_f<TO>(acc[i] + (bias != nullptr ? bias[col] : 0.f));
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, typename TO, bool KA, bool KB>
int launch(const void* a, const void* b, const float* bias, void* out, int m, int n, int k,
           cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int E = 16 / sizeof(T);
  // A chunk runs along the stored row: whole vectors when the row length is a
  // multiple of E (k for a k-contiguous operand, m or n otherwise).
  const bool vec_a = aligned16(a) && (KA ? k : m) % E == 0;
  const bool vec_b = aligned16(b) && (KB ? k : n) % E == 0;
  matmul_kernel<T, TO, KA, KB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), bias, static_cast<TO*>(out), m, n,
      k, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TO>
int launch_layouts(const void* a, const void* b, const float* bias, void* out, int m, int n,
                   int k, int trans_a, int trans_b, cudaStream_t s) {
  if (!trans_a && !trans_b) return launch<T, TO, true, false>(a, b, bias, out, m, n, k, s);
  if (!trans_a && trans_b) return launch<T, TO, true, true>(a, b, bias, out, m, n, k, s);
  if (trans_a && !trans_b) return launch<T, TO, false, false>(a, b, bias, out, m, n, k, s);
  return launch<T, TO, false, true>(a, b, bias, out, m, n, k, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. a is [m, k] row-major, or [k, m] with
// trans_a; b is [k, n], or [n, k] with trans_b; both operands of op_dtype, contiguous.
// bias fp32 [n] or null; out [m, n] row-major of out_dtype. Returns cudaGetLastError()
// of the launch (0 on success); m, n > 0 (the caller launches nothing for an empty
// output), k >= 0 (k = 0 writes the bias, or zeros).
extern "C" int np_matmul(const void* a, const void* b, const float* bias, void* out,
                         int op_dtype, int out_dtype, int m, int n, int k, int trans_a,
                         int trans_b, void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op_dtype == 1 && out_dtype == 1)
    return launch_layouts<bf16, bf16>(a, b, bias, out, m, n, k, trans_a, trans_b, s);
  if (op_dtype == 1 && out_dtype == 0)
    return launch_layouts<bf16, float>(a, b, bias, out, m, n, k, trans_a, trans_b, s);
  if (op_dtype == 0 && out_dtype == 1)
    return launch_layouts<float, bf16>(a, b, bias, out, m, n, k, trans_a, trans_b, s);
  if (op_dtype == 0 && out_dtype == 0)
    return launch_layouts<float, float>(a, b, bias, out, m, n, k, trans_a, trans_b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
