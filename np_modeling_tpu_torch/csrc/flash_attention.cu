// Flash attention for Hopper (sm_90a): the forward (K1) and its dual-kv
// schedule (K12), the fused backward (K2) and the split backward (K5).
//
// Replaces the Pallas TPU kernels of np_modeling_tpu/ops/attention.py:
//   K1  forward        _fwd_tile      (:756, launched by _flash_fwd_pallas :829, call :904)
//   K12 dual forward   _fwd_tile_dual (:693, launched by _flash_fwd_dual :929, call :941)
//   K2  fused backward _dkvq_tile     (:1100, launched by _flash_bwd_pallas :1188, call :1335)
//   K5  split backward _dq_tile (:983, call :1267) + _dkv_tile (:1045, call :1335)
//
// What they compute. q [b, hq, sq, d], k/v [b, hkv, skv, d]; q head h reads kv
// head h / (hq / hkv) (GQA). Scores s = (q . k) * scale in fp32, masked with the
// JAX package's finite mask value (never -inf, so exp never makes a NaN): keys
// past skv, query rows past sq, with causal the top-left mask col <= row in
// absolute indices, and with segment ids (int32 q_seg [b, sq], kv_seg [b, skv])
// q_seg[row] != kv_seg[col]. The forward keeps the online-softmax m, l and acc
// in fp32, rounds p to v's dtype before p.v (as the TPU kernel does), and writes
// o in q's dtype and lse = m + log(l) as fp32 [b, hq, sq] (no lane broadcast).
// The l == 0 guards of the TPU kernel's _store are kept. m starts at the finite
// mask value, so a row's kv tiles that are all masked (another document's, with
// segment ids) add p = exp(0) = 1 each until its first real key, whose
// alpha = exp(mask - m) is exactly 0 and wipes them, as on the TPU. A row with
// no key at all (non-causal, a q segment absent from kv_seg) keeps them: its o
// is the mean of v over every visited key column, the zero rows past skv of the
// last tile included, and its lse is the mask value.
//
// The backwards recompute p = exp(s - lse) and take di = rowsum(do . o) from the
// caller, with ds = p * (dp - di) * scale. K2 (one kernel, kv-major) accumulates
// dv += p^T do and dk += ds^T q per kv tile in fp32 registers and adds
// dq += ds k with fp32 atomics into a zeroed fp32 buffer (the summation order of
// dq therefore varies from run to run, by rounding only): five products a tile
// pair. K5 is two kernels: the dq kernel (q-major) owns a 64-row q tile, loops
// over its kv tiles and writes dq once, in q's dtype, with no atomics; the dk/dv
// kernel is K2 without its dq. Seven products a tile pair, and a dq that is the
// same on every run. dk and dv come out per q head; the caller sums GQA groups.
//
// K12 stages two kv tiles a loop step and issues both q.k^T products before the
// softmax work of either; it then runs K1's update (the same function) on the
// first half and then the second, so o and lse equal K1's bit for bit: with
// causal, a half above the diagonal is all masked and, m being real by then,
// adds p = 0 with alpha = 1. It needs an even number of kv tiles and takes no
// segment ids (the wrapper launches K1 otherwise, as JAX does).
//
// Segment ids are a template option (kSeg) of every kernel, so the variant
// without them carries none of their code: a run-time test of the id pointer
// inside K1's tile loop, taken the same way by every thread, still made K1
// 1.5x slower at b4 h8 s4096 d128 on an H100 without any segment ids.
//
// What bounds them on this card. At the training shape (b 4, h 8, s 4096,
// d 128, causal) attention is ~0.14 TFLOP forward and ~0.34 TFLOP backward a
// layer against ~0.1 GB of q/k/v/o traffic: far above the card's ~295 flops a
// byte, so tensor-core throughput bounds them all, and the design keeps the s
// and p tiles out of device memory entirely (registers and shared memory only).
// The bf16 kernels run every product on the tensor cores with mma.sync
// m16n8k16 (fp32 accumulate): a block of 4 warps owns a 64-row tile (q rows in
// the forwards and the dq kernel, kv rows in the dk/dv kernels), each warp 16
// rows, and loops over the other side's 64-row tiles inside the block; the
// causal band's tiles above the diagonal are never visited (K12's second half
// excepted). The s accumulator fragments are re-packed in registers as the A
// operand of p.v, ds^T q and (K5) ds.k (no shared-memory round trip); in K2 only
// ds goes through shared memory, for dq, whose rows span all 4 warps. With a
// 64-row tile the training shape has 64 x 32 = 2048 blocks for 132 SMs. The dq
// layout of the TPU's fused kernel ([b, h, n_kv, sq, d] partials, ~2 GB at that
// shape with 64-wide kv tiles) is replaced by atomics into a 67 MB buffer (K2)
// or by a kernel that owns dq (K5). fp32 inputs take a plain FMA path (exact
// comparisons need it). Loads are synchronous 16-byte vectors; cp.async/TMA
// pipelining, wgmma and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;  // rows of a q tile and of a kv tile, every kernel
// np_modeling_tpu/ops/attention.py DEFAULT_MASK_VALUE = -0.7 * float32 max.
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {  // element strides of a [b, h, s, d] tensor; d is contiguous
  long long b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* o;           // [b, sq, hq, d], q's dtype
  float* lse;        // [b, hq, sq]; null: not stored
  const float* di;   // [b, hq, sq]
  void* dq;          // [b, sq, hq, d]: K2 fp32, zeroed by the caller; K5 q's dtype
  void* dk;          // [b, skv, hq, d], k's dtype (per q head)
  void* dv;
  const int* q_seg;  // [b, sq] int32 segment ids, or null (no segments)
  const int* kv_seg; // [b, skv]
  long long seg_q_b, seg_q_s, seg_kv_b, seg_kv_s;  // their element strides
  Strides st_q, st_k, st_v, st_do;
  int b, hq, hkv, sq, skv, causal;
  float scale;
};

// Segment ids of rows [r0, r0 + 64) of a tile into shared memory. Rows past n
// get 0: masked() gives their scores the mask value by bounds anyway, so the
// -1 / -2 padding sentinels of JAX's _seg_arrays (:625-628) are not needed.
__device__ __forceinline__ void load_seg(int* dst, const int* seg, long long stride, int r0,
                                         int n) {
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    dst[i] = r0 + i < n ? __ldg(seg + (r0 + i) * stride) : 0;
}

// Whether the score of q row `row` and key `col` takes the mask value by
// bounds or causality (segment ids: mask_segments).
__device__ __forceinline__ bool masked(const Params& p, int row, int col) {
  return row >= p.sq || col >= p.skv || (p.causal && col > row);
}

// With segment ids, the scores whose row and column ids differ take the mask
// value: a 16 x 64 tile of C fragments s[8][4] (rows r0 + g and r0 + g + 8 of
// row_ids, columns 8n + 2t + (e & 1) of col_ids), or (fp32 path) one row's 32
// scores at columns 2j + h. Callers test p.q_seg first: the same for every
// thread, so a launch without segment ids never reads an id.
__device__ __forceinline__ void mask_segments(float (&s)[8][4], const int* row_ids, int r0,
                                              const int* col_ids, int g, int t) {
  const int r[2] = {row_ids[r0 + g], row_ids[r0 + g + 8]};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c[2] = {col_ids[8 * n + 2 * t], col_ids[8 * n + 2 * t + 1]};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (r[e >> 1] != c[e & 1]) s[n][e] = kMaskValue;
  }
}

__device__ __forceinline__ void mask_segments(float (&s)[32], int row_id, const int* col_ids,
                                              int h) {
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (row_id != col_ids[2 * j + h]) s[j] = kMaskValue;
}

// Copies rows [0, 64) of a tile (rows past n_valid as zeros) into shared
// memory with row pitch LD elements, 16 bytes a thread at a time.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride,
                                          int n_valid) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecs = D / E;
  for (int i = threadIdx.x; i < kTile * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * E;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) val = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
    if constexpr ((LD * sizeof(T)) % 16 == 0) {
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    } else {
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int j = 0; j < E; ++j) dst[r * LD + c + j] = e[j];
    }
  }
}

// ---- bf16 tensor-core helpers ----------------------------------------------
//
// mma.m16n8k16 fragments (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                      a3 = (g+8, 2t+8..)
//   B 16x8 (k x n):    b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C 16x8 fp32:       c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 of one column from consecutive rows, packed low/high.
__device__ __forceinline__ uint32_t ld_col2(const bf16* p, int ld) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + ld);
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows r0.., cols c0.. of a row-major bf16 tile with pitch ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld, int r0,
                                       int c0, int g, int t) {
  a[0] = ld32(s + (r0 + g) * ld + c0 + 2 * t);
  a[1] = ld32(s + (r0 + g + 8) * ld + c0 + 2 * t);
  a[2] = ld32(s + (r0 + g) * ld + c0 + 2 * t + 8);
  a[3] = ld32(s + (r0 + g + 8) * ld + c0 + 2 * t + 8);
}

// A fragment (k = 16 columns kk*16..) from two n-tiles of C accumulators.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// acc[n] += A(16 x 16) . X[k0 .. k0+16, :] for every 8-wide n-tile of a
// row-major [k][n] bf16 tile X with pitch ld (B read down columns).
template <int N8>
__device__ __forceinline__ void mma_rows(float (&acc)[N8][4], const uint32_t (&a)[4],
                                         const bf16* x, int ld, int k0, int g, int t) {
  const bf16* base = x + (k0 + 2 * t) * ld + g;
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    const uint32_t b0 = ld_col2(base + 8 * n, ld);
    const uint32_t b1 = ld_col2(base + 8 * ld + 8 * n, ld);
    mma(acc[n], a, b0, b1);
  }
}

// acc[n] += P(16 x 64) . X[0 .. 64, :], P given as the C fragments p[8][4] of
// a 16 x 64 tile (rounded to bf16 here), X a row-major [64][N8 * 8] tile.
template <int N8>
__device__ __forceinline__ void mma_frag_rows(float (&acc)[N8][4], const float (&p)[8][4],
                                              const bf16* x, int ld, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    pack_a(a, p[2 * kk], p[2 * kk + 1]);
    mma_rows<N8>(acc, a, x, ld, 16 * kk, g, t);
  }
}

// acc[n] += X[rx .. rx+16, :] . Y[8n .. 8n+8, :]^T over the head dim (KD steps
// of 16), for two row-major [rows][D] bf16 tiles with pitch ld: A read along
// X's rows, B along Y's rows.
template <int KD>
__device__ __forceinline__ void mma_rowsT(float (&acc)[8][4], const bf16* x, int rx,
                                          const bf16* y, int ld, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t a[4];
    load_a(a, x, ld, rx, 16 * kk, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const bf16* row = y + (8 * n + g) * ld + 16 * kk + 2 * t;
      mma(acc[n], a, ld32(row), ld32(row + 8));
    }
  }
}

__device__ __forceinline__ void zero8(float (&x)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
}

template <int D>
struct Bf16Smem {
  static constexpr int kLd = D + 8;         // pitch of a [64][D] tile
  static constexpr int kLdS = kTile + 8;    // pitch of the [64][64] ds tile
  static constexpr int kTileElems = kTile * kLd;
  // Segment ids of the q tile, then of the staged kv tile, end each layout.
  static constexpr size_t kSegBytes = 2 * kTile * sizeof(int);
  // q, then k and v of each of `halves` kv tiles; segment ids.
  static constexpr size_t fwd_bytes(int halves) {
    return (1 + 2 * halves) * kTileElems * sizeof(bf16) + kSegBytes;
  }
  // k, v, q, do, the ds tile, lse and di of the q tile; segment ids.
  static constexpr size_t kBwdBytes =
      (4 * kTileElems + kTile * kLdS) * sizeof(bf16) + 2 * kTile * sizeof(float) + kSegBytes;
  // q, do, k, v; segment ids.
  static constexpr size_t kDqBytes = 4 * kTileElems * sizeof(bf16) + kSegBytes;
};

// K1's work on one kv tile at kv0 for this warp's 16 q rows (bf16): s = q.k^T
// in, masked and scaled; the online-softmax update of m, l and acc; then
// acc += p (rounded to bf16) . v. K12 runs it on its two halves in turn.
template <int ND, bool kSeg>
__device__ __forceinline__ void fwd_update_bf16(const Params& p, float (&s)[8][4],
                                                float (&m)[2], float (&l)[2],
                                                float (&acc)[ND][4], const bf16* vs, int ld,
                                                const int* seg_q, const int* seg_kv, int q0,
                                                int kv0, int rw, int g, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + rw + g + (e >> 1) * 8, col = kv0 + 8 * n + 2 * t + (e & 1);
      s[n][e] = masked(p, row, col) ? kMaskValue : s[n][e] * p.scale;
    }
  }
  if (kSeg) mask_segments(s, seg_q, rw, seg_kv, g, t);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    alpha[i] = expf(m[i] - mx[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = expf(s[n][e] - m[e >> 1]);
      s[n][e] = pe;
      rs[e >> 1] += pe;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(kFull, rs[i], 1);
    rs[i] += __shfl_xor_sync(kFull, rs[i], 2);
    l[i] = alpha[i] * l[i] + rs[i];
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
  mma_frag_rows<ND>(acc, s, vs, ld, g, t);
}

// ---- K1 (kHalves 1) and K12 (kHalves 2), bf16 --------------------------------
// Grid (q tiles, b * hq); warp w owns q rows 16w .. 16w+15 of the tile. kSeg:
// segment ids (a compile-time option: K1 without them is compiled as if they
// did not exist; K12 takes none).
template <int D, int kHalves, bool kSeg>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(const Params p) {
  static_assert(kHalves == 1 || !kSeg, "K12 takes no segment ids");
  using S = Bf16Smem<D>;
  constexpr int LD = S::kLd, KD = D / 16, ND = D / 8, E = S::kTileElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + E;              // kHalves tiles
  bf16* vs = ks + kHalves * E;    // kHalves tiles
  int* seg = reinterpret_cast<int*>(vs + kHalves * E);

  const int n_q = (p.sq + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kTile;  // long rows first
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rw = warp * 16;  // this warp's first row in the tile

  const bf16* q = static_cast<const bf16*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const bf16* k = static_cast<const bf16*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const bf16* v = static_cast<const bf16*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  const int* kv_seg = p.kv_seg + bb * p.seg_kv_b;

  load_rows<bf16, D, LD>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
  if (kSeg) load_seg(seg, p.q_seg + bb * p.seg_q_b, p.seg_q_s, q0, p.sq);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};

  const int n_kv = (p.skv + kTile - 1) / kTile;
  int kv_end = p.causal ? min(n_kv, (q0 + kTile - 1) / kTile + 1) : n_kv;
  if (kHalves == 2) kv_end = min(n_kv, (kv_end + 1) & ~1);
  for (int kt = 0; kt < kv_end; kt += kHalves) {
    __syncthreads();  // the previous step's k/v reads are done
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const int kv0 = (kt + h) * kTile;
      load_rows<bf16, D, LD>(ks + h * E, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
      load_rows<bf16, D, LD>(vs + h * E, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);
      if (kSeg) load_seg(seg + kTile, kv_seg, p.seg_kv_s, kv0, p.skv);
    }
    __syncthreads();

    float s[kHalves][8][4];
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      zero8(s[h]);
      mma_rowsT<KD>(s[h], qs, rw, ks + h * E, LD, g, t);
    }
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
      fwd_update_bf16<ND, kSeg>(p, s[h], m, l, acc, vs + h * E, LD, seg, seg + kTile, q0,
                                (kt + h) * kTile, rw, g, t);
  }

  bf16* o = static_cast<bf16*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rw + g + 8 * i;
    if (row >= p.sq) continue;
    const float l_inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    bf16* dst = o + ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(acc[n][2 * i] * l_inv, acc[n][2 * i + 1] * l_inv);
    if (p.lse != nullptr && t == 0)
      p.lse[(static_cast<long long>(bb) * p.hq + hh) * p.sq + row] =
          m[i] + logf(l[i] == 0.f ? 1.f : l[i]);
  }
}

// ---- K2 (kDq) and K5's dk/dv kernel (!kDq), bf16 ----------------------------
// Grid (kv tiles, b * hq); warp w owns kv rows 16w .. 16w+15 of the tile.
// kSeg, here and below: segment ids, a compile-time option as in K1.
template <int D, bool kDq, bool kSeg>
__global__ void __launch_bounds__(kThreads) flash_bwd_bf16(const Params p) {
  using S = Bf16Smem<D>;
  constexpr int LD = S::kLd, LDS = S::kLdS, KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + S::kTileElems;
  bf16* qs = vs + S::kTileElems;
  bf16* dos = qs + S::kTileElems;
  bf16* dss = dos + S::kTileElems;  // ds of the tile pair, [q][kv], pitch LDS (K2)
  float* lse_s = reinterpret_cast<float*>(dss + kTile * LDS);
  float* di_s = lse_s + kTile;
  int* seg = reinterpret_cast<int*>(di_s + kTile);

  const int kv0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rw = warp * 16;

  const bf16* q = static_cast<const bf16*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const bf16* k = static_cast<const bf16*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const bf16* v = static_cast<const bf16*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  const bf16* dout = static_cast<const bf16*>(p.dout) + bb * p.st_do.b + hh * p.st_do.h;
  const int* q_seg = p.q_seg + bb * p.seg_q_b;
  const long long row_stats = (static_cast<long long>(bb) * p.hq + hh) * p.sq;

  load_rows<bf16, D, LD>(ks, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
  load_rows<bf16, D, LD>(vs, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);
  if (kSeg)
    load_seg(seg + kTile, p.kv_seg + bb * p.seg_kv_b, p.seg_kv_s, kv0, p.skv);
  const int* seg_kv = seg + kTile;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_q = (p.sq + kTile - 1) / kTile;
  for (int qt = p.causal ? kv0 / kTile : 0; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile pair's q/do/ds reads are done
    load_rows<bf16, D, LD>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
    load_rows<bf16, D, LD>(dos, dout + q0 * p.st_do.s, p.st_do.s, p.sq - q0);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool live = q0 + i < p.sq;
      lse_s[i] = live ? p.lse[row_stats + q0 + i] : 0.f;
      di_s[i] = live ? p.di[row_stats + q0 + i] : 0.f;
    }
    if (kSeg) load_seg(seg, q_seg, p.seg_q_s, q0, p.sq);
    __syncthreads();

    // p^T = exp(s^T - lse): rows = this warp's kv rows, cols = the q rows.
    float s[8][4];
    zero8(s);
    mma_rowsT<KD>(s, ks, rw, qs, LD, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + rw + g + (e >> 1) * 8, row = q0 + 8 * n + 2 * t + (e & 1);
        s[n][e] = masked(p, row, col) ? kMaskValue : s[n][e] * p.scale;
      }
    }
    if (kSeg) mask_segments(s, seg_kv, rw, seg, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - lse_s[8 * n + 2 * t + (e & 1)]);
    // dv += p^T (rounded to bf16) . do
    mma_frag_rows<ND>(dv, s, dos, LD, g, t);
    // dp^T = v . do^T, then ds^T = p^T * (dp^T - di) * scale
    float ds[8][4];
    zero8(ds);
    mma_rowsT<KD>(ds, vs, rw, dos, LD, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * n + 2 * t + (e & 1);
        const float x = s[n][e] * (ds[n][e] - di_s[ql]) * p.scale;
        ds[n][e] = x;
        if (kDq) dss[ql * LDS + rw + g + (e >> 1) * 8] = __float2bfloat16_rn(x);
      }
    }
    // dk += ds^T (rounded to bf16) . q
    mma_frag_rows<ND>(dk, ds, qs, LD, g, t);
    if (!kDq) continue;
    __syncthreads();  // ds of all 4 warps is in shared memory

    // dq[rows 16w ..] += ds . k over the tile's 64 keys, added atomically.
    float dq[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      load_a(a, dss, LDS, rw, 16 * kk, g, t);
      mma_rows<ND>(dq, a, ks, LD, 16 * kk, g, t);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + rw + g + 8 * i;
      if (row >= p.sq) continue;
      float* dst = static_cast<float*>(p.dq) +
                   ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        atomicAdd(dst + 8 * n, dq[n][2 * i]);
        atomicAdd(dst + 8 * n + 1, dq[n][2 * i + 1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kv0 + rw + g + 8 * i;
    if (row >= p.skv) continue;
    const long long off = ((static_cast<long long>(bb) * p.skv + row) * p.hq + hh) * D + 2 * t;
    bf16* dkd = static_cast<bf16*>(p.dk) + off;
    bf16* dvd = static_cast<bf16*>(p.dv) + off;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dkd + 8 * n) = pack_bf16(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvd + 8 * n) = pack_bf16(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// ---- K5's dq kernel, bf16 ----------------------------------------------------
// Grid (q tiles, b * hq); warp w owns q rows 16w .. 16w+15 of the tile and
// their dq, accumulated over the tile's kv band and written once.
template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(const Params p) {
  using S = Bf16Smem<D>;
  constexpr int LD = S::kLd, KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + S::kTileElems;
  bf16* ks = dos + S::kTileElems;
  bf16* vs = ks + S::kTileElems;
  int* seg = reinterpret_cast<int*>(vs + S::kTileElems);

  const int n_q = (p.sq + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kTile;  // long rows first
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rw = warp * 16;

  const bf16* q = static_cast<const bf16*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const bf16* k = static_cast<const bf16*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const bf16* v = static_cast<const bf16*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  const bf16* dout = static_cast<const bf16*>(p.dout) + bb * p.st_do.b + hh * p.st_do.h;
  const int* kv_seg = p.kv_seg + bb * p.seg_kv_b;
  const long long row_stats = (static_cast<long long>(bb) * p.hq + hh) * p.sq;

  load_rows<bf16, D, LD>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
  load_rows<bf16, D, LD>(dos, dout + q0 * p.st_do.s, p.st_do.s, p.sq - q0);
  if (kSeg) load_seg(seg, p.q_seg + bb * p.seg_q_b, p.seg_q_s, q0, p.sq);
  float lse[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rw + g + 8 * i;
    lse[i] = row < p.sq ? p.lse[row_stats + row] : 0.f;
    di[i] = row < p.sq ? p.di[row_stats + row] : 0.f;
  }

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int n_kv = (p.skv + kTile - 1) / kTile;
  const int kv_end = p.causal ? min(n_kv, (q0 + kTile - 1) / kTile + 1) : n_kv;
  for (int kt = 0; kt < kv_end; ++kt) {
    const int kv0 = kt * kTile;
    __syncthreads();  // the previous tile's k/v reads are done
    load_rows<bf16, D, LD>(ks, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
    load_rows<bf16, D, LD>(vs, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);
    if (kSeg) load_seg(seg + kTile, kv_seg, p.seg_kv_s, kv0, p.skv);
    __syncthreads();

    // p = exp(s - lse) over this warp's q rows and the tile's keys.
    float s[8][4];
    zero8(s);
    mma_rowsT<KD>(s, qs, rw, ks, LD, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + rw + g + (e >> 1) * 8, col = kv0 + 8 * n + 2 * t + (e & 1);
        s[n][e] = masked(p, row, col) ? kMaskValue : s[n][e] * p.scale;
      }
    }
    if (kSeg) mask_segments(s, seg, rw, seg + kTile, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - lse[e >> 1]);
    // dp = do . v^T, then ds = p * (dp - di) * scale
    float ds[8][4];
    zero8(ds);
    mma_rowsT<KD>(ds, dos, rw, vs, LD, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = s[n][e] * (ds[n][e] - di[e >> 1]) * p.scale;
    // dq += ds (rounded to bf16) . k
    mma_frag_rows<ND>(dq, ds, ks, LD, g, t);
  }

  bf16* out = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rw + g + 8 * i;
    if (row >= p.sq) continue;
    bf16* dst = out + ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) = pack_bf16(dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

// ---- fp32 FMA path ---------------------------------------------------------
//
// Thread i of the block owns tile row i / 2 and the columns (or head dims)
// of parity i % 2; shared-memory rows are padded to an odd pitch so that the
// 16 rows a warp reads at once fall in distinct banks.

template <int D>
struct F32Smem {
  static constexpr int kLd = D + 1;
  static constexpr int kLdP = kTile + 1;
  static constexpr int kTileElems = kTile * kLd;
  static constexpr int kPElems = kTile * kLdP;
  static constexpr size_t kSegBytes = 2 * kTile * sizeof(int);
  static constexpr size_t fwd_bytes(int halves) {
    return ((1 + 2 * halves) * kTileElems + kPElems) * sizeof(float) + kSegBytes;
  }
  static constexpr size_t kBwdBytes =
      (4 * kTileElems + 2 * kPElems + 2 * kTile) * sizeof(float) + kSegBytes;
  static constexpr size_t kDqBytes = (4 * kTileElems + kPElems) * sizeof(float) + kSegBytes;
};

// K1's work on one kv tile at kv0 for tile row r, columns of parity h (fp32):
// s = q.k^T in, masked and scaled; the online-softmax update; acc += p . v
// through the row's p in shared memory. K12 runs it on its halves in turn.
template <int D, bool kSeg>
__device__ __forceinline__ void fwd_update_f32(const Params& p, float (&s)[32], float& m,
                                               float& l, float (&acc)[D / 2], float* ps,
                                               const float* vs, const int* seg_q,
                                               const int* seg_kv, int q0, int kv0, int r,
                                               int h) {
  constexpr int LD = F32Smem<D>::kLd, LP = F32Smem<D>::kLdP, HD = D / 2;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    s[j] = masked(p, q0 + r, kv0 + 2 * j + h) ? kMaskValue : s[j] * p.scale;
  if (kSeg) mask_segments(s, seg_q[r], seg_kv, h);
  float mx = m;
#pragma unroll
  for (int j = 0; j < 32; ++j) mx = fmaxf(mx, s[j]);
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
  const float alpha = expf(m - mx);
  m = mx;
  float rs = 0.f;
  __syncwarp();  // the row's previous p reads (the other half of K12) are done
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float pe = expf(s[j] - m);
    ps[r * LP + 2 * j + h] = pe;
    rs += pe;
  }
  rs += __shfl_xor_sync(kFull, rs, 1);
  l = alpha * l + rs;
  __syncwarp();  // row r of p is written by this warp's lanes 2r', 2r'+1
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] *= alpha;
#pragma unroll 2
  for (int c = 0; c < kTile; ++c) {
    const float pc = ps[r * LP + c];
#pragma unroll
    for (int i = 0; i < HD; ++i) acc[i] = fmaf(pc, vs[c * LD + 2 * i + h], acc[i]);
  }
}

// s[j] = x[r] . y[2j + h] over the head dim, for row-major [64][D] fp32
// tiles with pitch LD.
template <int D>
__device__ __forceinline__ void dots_f32(float (&s)[32], const float* x, int r, const float* y,
                                         int h) {
  constexpr int LD = F32Smem<D>::kLd;
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float xd = x[r * LD + d];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = fmaf(xd, y[(2 * j + h) * LD + d], s[j]);
  }
}

template <int D, int kHalves, bool kSeg>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  static_assert(kHalves == 1 || !kSeg, "K12 takes no segment ids");
  using S = F32Smem<D>;
  constexpr int LD = S::kLd, HD = D / 2, E = S::kTileElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + E;
  float* vs = ks + kHalves * E;
  float* ps = vs + kHalves * E;
  int* seg = reinterpret_cast<int*>(ps + S::kPElems);

  const int n_q = (p.sq + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  const int row = q0 + r;

  const float* q = static_cast<const float*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const float* k = static_cast<const float*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const float* v = static_cast<const float*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  const int* kv_seg = p.kv_seg + bb * p.seg_kv_b;
  load_rows<float, D, LD>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
  if (kSeg) load_seg(seg, p.q_seg + bb * p.seg_q_b, p.seg_q_s, q0, p.sq);

  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;
  float m = kMaskValue, l = 0.f;

  const int n_kv = (p.skv + kTile - 1) / kTile;
  int kv_end = p.causal ? min(n_kv, (q0 + kTile - 1) / kTile + 1) : n_kv;
  if (kHalves == 2) kv_end = min(n_kv, (kv_end + 1) & ~1);
  for (int kt = 0; kt < kv_end; kt += kHalves) {
    __syncthreads();
#pragma unroll
    for (int hv = 0; hv < kHalves; ++hv) {
      const int kv0 = (kt + hv) * kTile;
      load_rows<float, D, LD>(ks + hv * E, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
      load_rows<float, D, LD>(vs + hv * E, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);
      if (kSeg) load_seg(seg + kTile, kv_seg, p.seg_kv_s, kv0, p.skv);
    }
    __syncthreads();

    float s[kHalves][32];
#pragma unroll
    for (int hv = 0; hv < kHalves; ++hv) dots_f32<D>(s[hv], qs, r, ks + hv * E, h);
#pragma unroll
    for (int hv = 0; hv < kHalves; ++hv)
      fwd_update_f32<D, kSeg>(p, s[hv], m, l, acc, ps, vs + hv * E, seg, seg + kTile, q0,
                              (kt + hv) * kTile, r, h);
  }

  if (row < p.sq) {
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
    float* dst = static_cast<float*>(p.o) +
                 ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D + h;
#pragma unroll
    for (int i = 0; i < HD; ++i) dst[2 * i] = acc[i] * l_inv;
    if (p.lse != nullptr && h == 0)
      p.lse[(static_cast<long long>(bb) * p.hq + hh) * p.sq + row] =
          m + logf(l == 0.f ? 1.f : l);
  }
}

// K2 (kDq) and K5's dk/dv kernel (!kDq), fp32: thread i owns kv row i / 2.
template <int D, bool kDq, bool kSeg>
__global__ void __launch_bounds__(kThreads) flash_bwd_f32(const Params p) {
  using S = F32Smem<D>;
  constexpr int LD = S::kLd, LP = S::kLdP, HD = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + S::kTileElems;
  float* qs = vs + S::kTileElems;
  float* dos = qs + S::kTileElems;
  float* pt = dos + S::kTileElems;  // p^T of the tile pair, [kv][q]
  float* dst_t = pt + S::kPElems;    // ds^T, [kv][q]
  float* lse_s = dst_t + S::kPElems;
  float* di_s = lse_s + kTile;
  int* seg = reinterpret_cast<int*>(di_s + kTile);

  const int kv0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int c = threadIdx.x >> 1, h = threadIdx.x & 1;  // kv row c (and q row c for dq)
  const int col = kv0 + c;

  const float* q = static_cast<const float*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const float* k = static_cast<const float*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const float* v = static_cast<const float*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  const float* dout = static_cast<const float*>(p.dout) + bb * p.st_do.b + hh * p.st_do.h;
  const int* q_seg = p.q_seg + bb * p.seg_q_b;
  const long long row_stats = (static_cast<long long>(bb) * p.hq + hh) * p.sq;
  load_rows<float, D, LD>(ks, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
  load_rows<float, D, LD>(vs, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);
  if (kSeg)
    load_seg(seg + kTile, p.kv_seg + bb * p.seg_kv_b, p.seg_kv_s, kv0, p.skv);
  const int* seg_kv = seg + kTile;

  float dk[HD], dv[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) dk[i] = dv[i] = 0.f;

  const int n_q = (p.sq + kTile - 1) / kTile;
  for (int qt = p.causal ? kv0 / kTile : 0; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_rows<float, D, LD>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
    load_rows<float, D, LD>(dos, dout + q0 * p.st_do.s, p.st_do.s, p.sq - q0);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool live = q0 + i < p.sq;
      lse_s[i] = live ? p.lse[row_stats + q0 + i] : 0.f;
      di_s[i] = live ? p.di[row_stats + q0 + i] : 0.f;
    }
    if (kSeg) load_seg(seg, q_seg, p.seg_q_s, q0, p.sq);
    __syncthreads();

    float x[32];
    dots_f32<D>(x, ks, c, qs, h);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      x[j] = masked(p, q0 + 2 * j + h, col) ? kMaskValue : x[j] * p.scale;
    if (kSeg) mask_segments(x, seg_kv[c], seg, h);
#pragma unroll
    for (int j = 0; j < 32; ++j) pt[c * LP + 2 * j + h] = expf(x[j] - lse_s[2 * j + h]);
    dots_f32<D>(x, vs, c, dos, h);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int ql = 2 * j + h;
      dst_t[c * LP + ql] = pt[c * LP + ql] * (x[j] - di_s[ql]) * p.scale;
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      const float pr = pt[c * LP + r], dsr = dst_t[c * LP + r];
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        dv[i] = fmaf(pr, dos[r * LD + 2 * i + h], dv[i]);
        dk[i] = fmaf(dsr, qs[r * LD + 2 * i + h], dk[i]);
      }
    }
    if (!kDq) continue;
    // dq row q0 + c, dims of parity h, 16 at a time, added atomically.
    const int row = q0 + c;
    float* dq = static_cast<float*>(p.dq) +
                ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D + h;
#pragma unroll 1
    for (int i0 = 0; i0 < HD; i0 += 16) {
      float a[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = 0.f;
      for (int cc = 0; cc < kTile; ++cc) {
        const float w = dst_t[cc * LP + c];
#pragma unroll
        for (int i = 0; i < 16; ++i) a[i] = fmaf(w, ks[cc * LD + 2 * (i0 + i) + h], a[i]);
      }
      if (row < p.sq) {
#pragma unroll
        for (int i = 0; i < 16; ++i) atomicAdd(dq + 2 * (i0 + i), a[i]);
      }
    }
  }

  if (col < p.skv) {
    const long long off = ((static_cast<long long>(bb) * p.skv + col) * p.hq + hh) * D + h;
    float* dkd = static_cast<float*>(p.dk) + off;
    float* dvd = static_cast<float*>(p.dv) + off;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      dkd[2 * i] = dk[i];
      dvd[2 * i] = dv[i];
    }
  }
}

// K5's dq kernel, fp32: thread i owns q row i / 2 and the head dims of
// parity i % 2 of its dq; the row's ds goes through shared memory.
template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32(const Params p) {
  using S = F32Smem<D>;
  constexpr int LD = S::kLd, LP = S::kLdP, HD = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + S::kTileElems;
  float* ks = dos + S::kTileElems;
  float* vs = ks + S::kTileElems;
  float* dss = vs + S::kTileElems;  // ds of the tile pair, [q][kv]
  int* seg = reinterpret_cast<int*>(dss + S::kPElems);

  const int n_q = (p.sq + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  const int row = q0 + r;

  const float* q = static_cast<const float*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const float* k = static_cast<const float*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const float* v = static_cast<const float*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  const float* dout = static_cast<const float*>(p.dout) + bb * p.st_do.b + hh * p.st_do.h;
  const int* kv_seg = p.kv_seg + bb * p.seg_kv_b;
  const long long row_stats = (static_cast<long long>(bb) * p.hq + hh) * p.sq;
  load_rows<float, D, LD>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
  load_rows<float, D, LD>(dos, dout + q0 * p.st_do.s, p.st_do.s, p.sq - q0);
  if (kSeg) load_seg(seg, p.q_seg + bb * p.seg_q_b, p.seg_q_s, q0, p.sq);
  const float lse = row < p.sq ? p.lse[row_stats + row] : 0.f;
  const float di = row < p.sq ? p.di[row_stats + row] : 0.f;

  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;

  const int n_kv = (p.skv + kTile - 1) / kTile;
  const int kv_end = p.causal ? min(n_kv, (q0 + kTile - 1) / kTile + 1) : n_kv;
  for (int kt = 0; kt < kv_end; ++kt) {
    const int kv0 = kt * kTile;
    __syncthreads();
    load_rows<float, D, LD>(ks, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
    load_rows<float, D, LD>(vs, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);
    if (kSeg) load_seg(seg + kTile, kv_seg, p.seg_kv_s, kv0, p.skv);
    __syncthreads();

    float pr[32], dp[32];
    dots_f32<D>(pr, qs, r, ks, h);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      pr[j] = masked(p, row, kv0 + 2 * j + h) ? kMaskValue : pr[j] * p.scale;
    if (kSeg) mask_segments(pr, seg[r], seg + kTile, h);
#pragma unroll
    for (int j = 0; j < 32; ++j) pr[j] = expf(pr[j] - lse);
    dots_f32<D>(dp, dos, r, vs, h);
    __syncwarp();  // the row's previous ds reads are done
#pragma unroll
    for (int j = 0; j < 32; ++j) dss[r * LP + 2 * j + h] = pr[j] * (dp[j] - di) * p.scale;
    __syncwarp();  // row r of ds is written by this warp's lanes 2r', 2r'+1
#pragma unroll 2
    for (int cc = 0; cc < kTile; ++cc) {
      const float w = dss[r * LP + cc];
#pragma unroll
      for (int i = 0; i < HD; ++i) acc[i] = fmaf(w, ks[cc * LD + 2 * i + h], acc[i]);
    }
  }

  if (row < p.sq) {
    float* dst = static_cast<float*>(p.dq) +
                 ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D + h;
#pragma unroll
    for (int i = 0; i < HD; ++i) dst[2 * i] = acc[i];
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const long long* strides, const int* q_seg, const int* kv_seg, int b,
                   int hq, int hkv, int sq, int skv, int causal, float scale) {
  Params p = {};
  Strides* st[4] = {&p.st_q, &p.st_k, &p.st_v, &p.st_do};
  for (int i = 0; i < 4; ++i) *st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.q_seg = q_seg;
  p.kv_seg = kv_seg;
  p.seg_q_b = strides[12];
  p.seg_q_s = strides[13];
  p.seg_kv_b = strides[14];
  p.seg_kv_s = strides[15];
  p.b = b;
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.scale = scale;
  return p;
}

template <int D>
int launch_fwd(const Params& p, int dtype, int dual, dim3 grid, cudaStream_t s) {
  const bool seg = p.q_seg != nullptr;
  if (dual && seg) return static_cast<int>(cudaErrorInvalidValue);  // K12 takes none
  if (dtype == 1) {
    if (dual) return launch(flash_fwd_bf16<D, 2, false>, grid, Bf16Smem<D>::fwd_bytes(2), s, p);
    if (seg) return launch(flash_fwd_bf16<D, 1, true>, grid, Bf16Smem<D>::fwd_bytes(1), s, p);
    return launch(flash_fwd_bf16<D, 1, false>, grid, Bf16Smem<D>::fwd_bytes(1), s, p);
  }
  if (dtype == 0) {
    if (dual) return launch(flash_fwd_f32<D, 2, false>, grid, F32Smem<D>::fwd_bytes(2), s, p);
    if (seg) return launch(flash_fwd_f32<D, 1, true>, grid, F32Smem<D>::fwd_bytes(1), s, p);
    return launch(flash_fwd_f32<D, 1, false>, grid, F32Smem<D>::fwd_bytes(1), s, p);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D, bool kSeg>
int launch_bwd(const Params& p, int dtype, int split, dim3 grid_q, dim3 grid_kv,
               cudaStream_t s) {
  using B = Bf16Smem<D>;
  using F = F32Smem<D>;
  if (dtype == 1 && !split)
    return launch(flash_bwd_bf16<D, true, kSeg>, grid_kv, B::kBwdBytes, s, p);
  if (dtype == 0 && !split)
    return launch(flash_bwd_f32<D, true, kSeg>, grid_kv, F::kBwdBytes, s, p);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    rc = launch(flash_bwd_dq_bf16<D, kSeg>, grid_q, B::kDqBytes, s, p);
    if (rc == 0) rc = launch(flash_bwd_bf16<D, false, kSeg>, grid_kv, B::kBwdBytes, s, p);
  } else if (dtype == 0) {
    rc = launch(flash_bwd_dq_f32<D, kSeg>, grid_q, F::kDqBytes, s, p);
    if (rc == 0) rc = launch(flash_bwd_f32<D, false, kSeg>, grid_kv, F::kBwdBytes, s, p);
  }
  return rc;
}

}  // namespace

// dtype codes: 0 = float32 (FMA path), 1 = bfloat16 (tensor cores); d is 64
// or 128. strides: 16 element strides, (b, h, s) of q, k, v and do, in that
// order (the forward reads the first 9), then (b, s) of q_seg and of kv_seg.
// q_seg/kv_seg: int32 segment ids, both null for none. Outputs and scratch are
// allocated by the caller: o [b, sq, hq, d] in q's dtype; lse [b, hq, sq] fp32
// or null; dk/dv [b, skv, hq, d] in k's dtype; dq [b, sq, hq, d], fp32 and
// zeroed for K2 (split 0), in q's dtype for K5 (split 1). dual 1 runs K12,
// without segment ids (the caller checks that the kv tiles are even in
// number). Both return the first nonzero cudaGetLastError() of their launches
// (0 on success).
extern "C" int np_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      float* lse, const int* q_seg, const int* kv_seg,
                                      const long long* strides, int dtype, int b, int hq,
                                      int hkv, int sq, int skv, int d, int causal, int dual,
                                      float scale, void* stream) {
  Params p = make_params(strides, q_seg, kv_seg, b, hq, hkv, sq, skv, causal, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  const dim3 grid((sq + kTile - 1) / kTile, b * hq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fwd<64>(p, dtype, dual, grid, s);
  if (d == 128) return launch_fwd<128>(p, dtype, dual, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int np_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* di,
                                      const int* q_seg, const int* kv_seg, void* dq, void* dk,
                                      void* dv, const long long* strides, int dtype, int b,
                                      int hq, int hkv, int sq, int skv, int d, int causal,
                                      int split, float scale, void* stream) {
  Params p = make_params(strides, q_seg, kv_seg, b, hq, hkv, sq, skv, causal, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.di = di;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  const dim3 grid_q((sq + kTile - 1) / kTile, b * hq), grid_kv((skv + kTile - 1) / kTile, b * hq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool seg = q_seg != nullptr;
  if (d == 64 && seg) return launch_bwd<64, true>(p, dtype, split, grid_q, grid_kv, s);
  if (d == 64) return launch_bwd<64, false>(p, dtype, split, grid_q, grid_kv, s);
  if (d == 128 && seg) return launch_bwd<128, true>(p, dtype, split, grid_q, grid_kv, s);
  if (d == 128) return launch_bwd<128, false>(p, dtype, split, grid_q, grid_kv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
