// Tiled matrix product for Hopper (sm_90a):
//   out[m, n] = round_once(op(a) @ op(b) + bias), fp32 accumulation,
// op(a) = a or a^T and op(b) = b or b^T read in their stored (row-major) layout.
//
// Replaces the Pallas TPU kernels _mm_kernel and _mm_bias_kernel of
// np_modeling_tpu/ops/matmul.py (:27, :43; launched by matmul at :146, :150). Like
// them it keeps an fp32 accumulator for each output tile over the whole k loop, reads
// a transposed operand in its stored layout (no transposed copy) and adds the bias to
// the fp32 accumulator before the one rounding to the output dtype. Unlike them it
// pads nothing: ragged m, n and k are zero-filled at the loads and masked at the
// stores.
//
// What bounds it. At the GPT-2 small train step's shapes (m = 8192 tokens, k and n
// 768 or 3072) a product does 2 m k n = 9.7e9..3.9e10 operations on 13..63 MB: the
// tensor cores bound it (989 TFLOP/s bf16 against 3.35 TB/s: ~295 operations a byte).
//
// bf16 operands: warpgroup products. A block works on one [128, 128] output tile at
// a time; two consumer warpgroups each own 64 rows of it and issue wgmma
// m64n128k16 (fp32 accumulators, 64 registers a thread) on [128, 64] k slices of
// op(a) and op(b) held in shared memory in the 128-byte swizzle (wgmma.cuh). Each
// operand is read in its stored layout: a k-contiguous one as a K-major wgmma
// operand, an m- or n-contiguous one as an MN-major operand (the descriptor's
// transpose bit), so all four (trans_a, trans_b) cases are the same kernel with
// other template bits and no element is ever stored transposed. Two variants fill the slices:
//   mm_tma: a ring of kStages stages filled by TMA (one thread of a producer
//     warpgroup; full/empty mbarriers), the consumers keeping one k step of products
//     in flight; persistent (one block an SM walks the tiles), so the next tile's
//     loads overlap this one's epilogue. TMA needs 16-byte aligned bases and row
//     strides: every stored row length a multiple of 8 bf16 (the wrapper checks,
//     ops/matmul.py plan()).
//   mm_ragged: any shape. All 256 threads load the next k slice into registers
//     element by element (zeros past the edges) while the tensor cores work on the
//     current one, then store it swizzled into the other of two stages. A row of odd
//     length starts on a 2-byte boundary, below cp.async's 4-byte minimum, so this
//     variant stages through registers.
// Work walks the output tiles in groups of 8 tile rows, so the tiles that run at
// once share their operands in L2. The epilogue adds the bias, rounds once, stages
// each warpgroup's [64, 128] tile in shared memory and writes it as 16-byte vectors.
//
// Split-k. When the output tiles cannot fill the card's 132 SMs (the step's [768,
// 768] weight gradients over k 8192 are 36 tiles), each tile is `splits` work items,
// one a k range (whole 64-deep slices), each writing its fp32 sum, without bias, to
// a workspace [splits, m, n]; splitk_reduce then adds the splits in the fixed order
// 0, 1, .., the bias last, and rounds once, so the result is the same on every run.
//
// fp32 operands: a plain FMA path (exact comparisons need it; no TF32). A block of 8
// warps owns a [128, 128] tile and walks k in steps of 32 through padded shared
// memory; a thread owns an 8 x 8 grid of outputs 16 apart.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128;
constexpr int kSlice = 64;                            // k depth of a bf16 stage
constexpr int kOperandBytes = 128 * kSlice * 2;       // one operand's slice, 16 KB
constexpr int kStageBytes = 2 * kOperandBytes;
constexpr int kStages = 4;                            // mm_tma's ring

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---- bf16: the wgmma core (its tile raster and epilogue are in wgmma.cuh) -----------

// One k slice's products for warpgroup w: acc += op(a)[64 w.., slice] @ op(b)[slice, :].
// KA / KB: the operand is k-contiguous in memory (K-major). Stage layout: a K-major
// operand is one SW128 block [128 rows][64 k]; an MN-major one two blocks [64 k][64
// m or n] at +0 and +8 KB.
template <bool KA, bool KB>
__device__ __forceinline__ void slice_products(float (&acc)[64], uint32_t sa, uint32_t sb,
                                               int w) {
#pragma unroll
  for (int j = 0; j < kSlice / 16; ++j) {
    const uint64_t da = KA ? wg::desc(sa + w * 64 * 128 + j * 32, 16, 1024)
                           : wg::desc(sa + w * 8192 + j * 2048, 8192, 1024);
    const uint64_t db = KB ? wg::desc(sb + j * 32, 16, 1024)
                           : wg::desc(sb + j * 2048, 8192, 1024);
    wg::wgmma_ss<KA ? 0 : 1, KB ? 0 : 1>(acc, da, db, 1);
  }
}

// The TMA variant, persistent: one block an SM walks the work items (output tile,
// split of k) id = blockIdx.x, + gridDim.x, ..; split id / tiles, tile id % tiles.
// 384 threads: warpgroups 0 and 1 consume, warpgroup 2 produces. The ring runs on
// across items, so the producer loads the next item's first slices while the
// consumers run this one's epilogue. ma / mb: 2-D tensor maps of a and b in their
// stored layouts (inner dim first); a K-major operand's box is [64 k][128 rows], an
// MN-major one's [64 rows of k][64]. k_chunk: a split's depth, a multiple of kSlice.
template <typename TO, bool KA, bool KB>
__global__ void __launch_bounds__(384, 1)
mm_tma(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
       const float* __restrict__ bias, TO* __restrict__ out, int m, int n, int k, int k_chunk,
       int tiles_m, int tiles_n, int splits) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align1024(smem_raw);
  TO* stage_out = reinterpret_cast<TO*>(smem + kStages * kStageBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes + 2 * wg::kOutBytes<TO>);
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
      const int m0 = tm * kBM, n0 = tn * kBN, k_begin = (id / tiles) * k_chunk;
      const int steps = max(0, (min(k, k_begin + k_chunk) - k_begin + kSlice - 1) / kSlice);
      for (int it = 0; it < steps; ++it, ++gi) {
        const int s = gi % kStages;
        if (gi >= kStages) wg::mbar_wait(&empty[s], ((gi / kStages) - 1) & 1);
        wg::mbar_expect_tx(&full[s], kStageBytes);
        uint8_t* sa = smem + s * kStageBytes;
        uint8_t* sb = sa + kOperandBytes;
        const int kk = k_begin + it * kSlice;
        if (KA) {
          wg::tma_load_2d(sa, &ma, &full[s], kk, m0);
        } else {
          wg::tma_load_2d(sa, &ma, &full[s], m0, kk);
          wg::tma_load_2d(sa + 8192, &ma, &full[s], m0 + 64, kk);
        }
        if (KB) {
          wg::tma_load_2d(sb, &mb, &full[s], kk, n0);
        } else {
          wg::tma_load_2d(sb, &mb, &full[s], n0, kk);
          wg::tma_load_2d(sb + 8192, &mb, &full[s], n0 + 64, kk);
        }
      }
    }
    return;
  }

  const bool leader = threadIdx.x % 128 == 0;
  for (int id = blockIdx.x; id < items; id += gridDim.x) {
    int tm, tn;
    wg::tile_of(id % tiles, tiles_m, tiles_n, tm, tn);
    const int m0 = tm * kBM, n0 = tn * kBN, k_begin = (id / tiles) * k_chunk;
    const int steps = max(0, (min(k, k_begin + k_chunk) - k_begin + kSlice - 1) / kSlice);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int it = 0; it < steps; ++it, ++gi) {
      const int s = gi % kStages;
      wg::mbar_wait(&full[s], (gi / kStages) & 1);
      const uint32_t sa = wg::smem_u32(smem + s * kStageBytes);
      wg::fence();
      slice_products<KA, KB>(acc, sa, sa + kOperandBytes, w);
      wg::commit();
      wg::wait<1>();  // the previous slice's products are done: release its stage
      if (it > 0 && leader) wg::mbar_arrive(&empty[(gi - 1) % kStages]);
    }
    wg::wait<0>();
    wg::fence_acc(acc);
    if (steps > 0 && leader) wg::mbar_arrive(&empty[(gi - 1) % kStages]);
    // A split writes its fp32 sum, without bias, to its slice of the workspace.
    wg::epilogue<TO>(acc, stage_out + w * (wg::kOutBytes<TO> / static_cast<int>(sizeof(TO))),
                     bias, out + static_cast<size_t>(id / tiles) * m * n, m, n, m0, n0, w);
  }
}

// One k slice of an operand into registers (ragged variant): 4 chunks of 8 elements
// a thread along the stored row, zeros outside rows [0, rows) and k [k0, k_end).
// KC: k-contiguous (the slice is [128 rows][64 k] in memory order), else [64 k][128].
template <bool KC>
struct RaggedSlice {
  uint4 r[4];

  __device__ __forceinline__ void load(const bf16* __restrict__ p, int ld, int rows, int row0,
                                       int k0, int k_end) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = threadIdx.x + 256 * i;
      bf16* e = reinterpret_cast<bf16*>(&r[i]);
      if (KC) {
        const int row = row0 + id / 8, kk = k0 + (id % 8) * 8;
        const bf16* src = p + static_cast<size_t>(row) * ld + kk;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = (row < rows && kk + j < k_end) ? src[j] : __float2bfloat16_rn(0.f);
      } else {
        const int kk = k0 + id / 16, row = row0 + (id % 16) * 8;
        const bf16* src = p + static_cast<size_t>(kk) * ld + row;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = (kk < k_end && row + j < rows) ? src[j] : __float2bfloat16_rn(0.f);
      }
    }
  }

  // Into the stage's SW128 layout (see slice_products).
  __device__ __forceinline__ void store(uint8_t* s) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = threadIdx.x + 256 * i;
      uint32_t off;
      if (KC) {
        off = wg::sw128_offset(id / 8, (id % 8) * 8);
      } else {
        const int cc = id % 16;
        off = (cc / 8) * 8192 + wg::sw128_offset(id / 16, (cc % 8) * 8);
      }
      *reinterpret_cast<uint4*>(s + off) = r[i];
    }
  }
};

// The ragged variant: 256 threads, both warpgroups consume; two stages.
template <typename TO, bool KA, bool KB>
__global__ void __launch_bounds__(256, 1)
mm_ragged(const bf16* __restrict__ a, const bf16* __restrict__ b, const float* __restrict__ bias,
          TO* __restrict__ out, int m, int n, int k, int k_chunk, int tiles_m, int tiles_n) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align1024(smem_raw);
  TO* stage_out = reinterpret_cast<TO*>(smem + 2 * kStageBytes);

  int tm, tn;
  wg::tile_of(blockIdx.x, tiles_m, tiles_n, tm, tn);
  const int m0 = tm * kBM, n0 = tn * kBN;
  const int k_begin = blockIdx.y * k_chunk, k_end = min(k, k_begin + k_chunk);
  const int steps = max(0, (k_end - k_begin + kSlice - 1) / kSlice);
  out += static_cast<size_t>(blockIdx.y) * m * n;
  const int lda = KA ? k : m, ldb = KB ? k : n;
  const int w = threadIdx.x / 128;

  RaggedSlice<KA> ta;
  RaggedSlice<KB> tb;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  if (steps > 0) {
    ta.load(a, lda, m, m0, k_begin, k_end);
    tb.load(b, ldb, n, n0, k_begin, k_end);
    ta.store(smem);
    tb.store(smem + kOperandBytes);
    wg::fence_proxy();
    __syncthreads();
  }
  for (int it = 0; it < steps; ++it) {
    const bool more = it + 1 < steps;
    if (more) {  // the next slice's loads, in flight behind the products
      ta.load(a, lda, m, m0, k_begin + (it + 1) * kSlice, k_end);
      tb.load(b, ldb, n, n0, k_begin + (it + 1) * kSlice, k_end);
    }
    const uint32_t sa = wg::smem_u32(smem + (it % 2) * kStageBytes);
    wg::fence();
    slice_products<KA, KB>(acc, sa, sa + kOperandBytes, w);
    wg::commit();
    if (more) {
      uint8_t* next = smem + ((it + 1) % 2) * kStageBytes;
      ta.store(next);
      tb.store(next + kOperandBytes);
      wg::fence_proxy();
    }
    wg::wait<0>();
    __syncthreads();
  }
  wg::fence_acc(acc);
  wg::epilogue<TO>(acc, stage_out + w * (wg::kOutBytes<TO> / static_cast<int>(sizeof(TO))), bias,
                   out, m, n, m0, n0, w);
}

// ---- fp32: the FMA path ------------------------------------------------------------

constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kPitch = kBK + 1;  // fp32 rows of 33 words spread column reads over banks

// One operand's [128 outer][kBK] fp32 tile: element (o, kk) of the logical operand
// lies at p[o * ld + kk] when k is contiguous in memory (KC) and at p[kk * ld + o]
// otherwise. Each thread holds kChunks 16-byte chunks of it in registers between
// load and store.
template <bool KC>
struct Tile {
  static constexpr int E = 4;  // elements in a chunk
  static constexpr int kChunks = 128 * kBK / E / kThreads;
  uint4 r[kChunks];

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
  __device__ __forceinline__ void load(const float* __restrict__ p, int ld, int n_outer, int k,
                                       int o0, int k0, bool vec) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      int o, kk;
      where(threadIdx.x + i * kThreads, o, kk);
      const int go = o0 + o, gk = k0 + kk;
      float* e = reinterpret_cast<float*>(&r[i]);
      if constexpr (KC) {
        const float* src = p + static_cast<size_t>(go) * ld + gk;
        if (vec && go < n_outer && gk + E <= k) {
          r[i] = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < E; ++j) e[j] = (go < n_outer && gk + j < k) ? src[j] : 0.f;
        }
      } else {
        const float* src = p + static_cast<size_t>(gk) * ld + go;
        if (vec && gk < k && go + E <= n_outer) {
          r[i] = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < E; ++j) e[j] = (gk < k && go + j < n_outer) ? src[j] : 0.f;
        }
      }
    }
  }

  // Into s[o * kPitch + kk] (k contiguous in shared memory, whatever the layout).
  __device__ __forceinline__ void store(float* s) const {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      int o, kk;
      where(threadIdx.x + i * kThreads, o, kk);
      const float* e = reinterpret_cast<const float*>(&r[i]);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if constexpr (KC) s[o * kPitch + kk + j] = e[j];
        else s[(o + j) * kPitch + kk] = e[j];
      }
    }
  }
};

// TO: output dtype; KA / KB: k contiguous in a's / b's memory (KA = !trans_a, KB =
// trans_b). acc[i * 8 + j] is output (16 i + tid / 16, 16 j + tid % 16) of the tile.
template <typename TO, bool KA, bool KB>
__global__ void __launch_bounds__(kThreads)
matmul_f32(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ bias, TO* __restrict__ out, int m, int n, int k, bool vec_a,
           bool vec_b) {
  __shared__ __align__(16) float as[kBM * kPitch];
  __shared__ __align__(16) float bs[kBN * kPitch];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lda = KA ? k : m, ldb = KB ? k : n;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  Tile<KA> ta;
  Tile<KB> tb;
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
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = as[(ty + 16 * i) * kPitch + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = bs[(tx + 16 * j) * kPitch + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
    }
    __syncthreads();
  }

  // Epilogue: the bias added to the fp32 sum, one rounding to TO.
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = m0 + ty + 16 * (i / 8), col = n0 + tx + 16 * (i % 8);
    if (row < m && col < n)
      out[static_cast<size_t>(row) * n + col] =
          from_f<TO>(acc[i] + (bias != nullptr ? bias[col] : 0.f));
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TO, bool KA, bool KB>
int launch_f32(const void* a, const void* b, const float* bias, void* out, int m, int n, int k,
               cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // A chunk runs along the stored row: whole vectors when the row length is a
  // multiple of 4 (k for a k-contiguous operand, m or n otherwise).
  const bool vec_a = aligned16(a) && (KA ? k : m) % 4 == 0;
  const bool vec_b = aligned16(b) && (KB ? k : n) % 4 == 0;
  matmul_f32<TO, KA, KB><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), bias, static_cast<TO*>(out), m,
      n, k, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 launches -------------------------------------------------------------------

template <typename TO, bool KA, bool KB>
int launch_bf16(const void* a, const void* b, const float* bias, void* out, float* ws, int m,
                int n, int k, int variant, int splits, cudaStream_t s) {
  const int tiles_m = (m + kBM - 1) / kBM, tiles_n = (n + kBN - 1) / kBN;
  const int k_chunk = ((k + splits - 1) / splits + kSlice - 1) / kSlice * kSlice;
  const dim3 grid(tiles_m * tiles_n, splits);
  // A split writes its fp32 sum, without bias, to its slice of the workspace.
  const bool split = splits > 1;
  cudaError_t err;
  if (variant == 0) {
    // TMA: 16-byte aligned bases and row strides (rows a multiple of 8 bf16), k > 0.
    if (k <= 0 || !aligned16(a) || !aligned16(b) || (KA ? k : m) % 8 || (KB ? k : n) % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap ma, mb;
    if (!(KA ? wg::make_map(&ma, a, m, k, 128) : wg::make_map(&ma, a, k, m, 64)) ||
        !(KB ? wg::make_map(&mb, b, n, k, 128) : wg::make_map(&mb, b, k, n, 64)))
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = kStages * kStageBytes + 2 * wg::kOutBytes<float> + 2 * kStages * 8 + 1024;
    const int blocks = std::min(tiles_m * tiles_n * splits, wg::sm_count());
    if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (split) {
      auto kernel = mm_tma<float, KA, KB>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<blocks, 384, smem, s>>>(ma, mb, nullptr, ws, m, n, k, k_chunk, tiles_m, tiles_n,
                                       splits);
    } else {
      auto kernel = mm_tma<TO, KA, KB>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<blocks, 384, smem, s>>>(ma, mb, bias, static_cast<TO*>(out), m, n, k, k_chunk,
                                       tiles_m, tiles_n, 1);
    }
  } else {
    const int smem = 2 * kStageBytes + 2 * wg::kOutBytes<float> + 1024;
    const bf16* pa = static_cast<const bf16*>(a);
    const bf16* pb = static_cast<const bf16*>(b);
    if (split) {
      auto kernel = mm_ragged<float, KA, KB>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<grid, 256, smem, s>>>(pa, pb, nullptr, ws, m, n, k, k_chunk, tiles_m, tiles_n);
    } else {
      auto kernel = mm_ragged<TO, KA, KB>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<grid, 256, smem, s>>>(pa, pb, bias, static_cast<TO*>(out), m, n, k, k_chunk,
                                     tiles_m, tiles_n);
    }
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  const long long total = static_cast<long long>(m) * n;
  const int blocks = static_cast<int>(std::min(4096LL, (total + 255) / 256));
  wg::splitk_reduce<TO><<<blocks, 256, 0, s>>>(ws, splits, bias, static_cast<TO*>(out), m, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int launch_layouts(const void* a, const void* b, const float* bias, void* out, float* ws,
                   int op_dtype, int m, int n, int k, int trans_a, int trans_b, int variant,
                   int splits, cudaStream_t s) {
  if (op_dtype == 0) {
    if (!trans_a && !trans_b) return launch_f32<TO, true, false>(a, b, bias, out, m, n, k, s);
    if (!trans_a && trans_b) return launch_f32<TO, true, true>(a, b, bias, out, m, n, k, s);
    if (trans_a && !trans_b) return launch_f32<TO, false, false>(a, b, bias, out, m, n, k, s);
    return launch_f32<TO, false, true>(a, b, bias, out, m, n, k, s);
  }
  if (!trans_a && !trans_b)
    return launch_bf16<TO, true, false>(a, b, bias, out, ws, m, n, k, variant, splits, s);
  if (!trans_a && trans_b)
    return launch_bf16<TO, true, true>(a, b, bias, out, ws, m, n, k, variant, splits, s);
  if (trans_a && !trans_b)
    return launch_bf16<TO, false, false>(a, b, bias, out, ws, m, n, k, variant, splits, s);
  return launch_bf16<TO, false, true>(a, b, bias, out, ws, m, n, k, variant, splits, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. a is [m, k] row-major, or [k, m] with
// trans_a; b is [k, n], or [n, k] with trans_b; both operands of op_dtype, contiguous.
// bias fp32 [n] or null; out [m, n] row-major of out_dtype. bf16 operands: variant 0
// runs mm_tma (16-byte aligned a and b, stored row lengths multiples of 8, k > 0;
// anything else is refused), 1 mm_ragged; splits >= 1 k ranges, and with splits > 1
// ws is an fp32 workspace of splits x m x n. fp32 operands ignore variant, splits and
// ws. Returns the first nonzero cudaGetLastError() of the launches (0 on success);
// m, n > 0 (the caller launches nothing for an empty output), k >= 0 (k = 0 writes
// the bias, or zeros).
extern "C" int np_matmul(const void* a, const void* b, const float* bias, void* out, void* ws,
                         int op_dtype, int out_dtype, int m, int n, int k, int trans_a,
                         int trans_b, int variant, int splits, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || (op_dtype != 0 && op_dtype != 1) || splits < 1 ||
      (op_dtype == 1 && splits > 1 && ws == nullptr) || (variant != 0 && variant != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (op_dtype == 0) splits = 1;
  if ((m + kBM - 1) / kBM * static_cast<long long>((n + kBN - 1) / kBN) > 0x7fffffff ||
      splits > 65535 || (op_dtype == 0 && (m + kBM - 1) / kBM > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (out_dtype == 1)
    return launch_layouts<bf16>(a, b, bias, out, w, op_dtype, m, n, k, trans_a, trans_b,
                                variant, splits, s);
  if (out_dtype == 0)
    return launch_layouts<float>(a, b, bias, out, w, op_dtype, m, n, k, trans_a, trans_b,
                                 variant, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
