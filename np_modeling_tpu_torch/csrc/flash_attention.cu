// Flash attention for Hopper (sm_90a): the forward (K1) and its dual-kv
// schedule (K12), the fused backward (K2) and the split backward (K5).
//
// Replaces the Pallas TPU kernels of np_modeling_tpu/ops/attention.py:
//   K1  forward        _fwd_tile      (:756, launched by _flash_fwd_pallas :829, call :904)
//   K12 dual forward   _fwd_tile_dual (:693, launched by _flash_fwd_dual :929, call :941)
//   K2  fused backward _dkvq_tile     (:1100, launched by _flash_bwd_pallas :1188, call :1335)
//   K5  split backward _dq_tile (:983, call :1267) + _dkv_tile (:1045, call :1335)
//
// What they compute. q [b, hq, sq, d], k/v [b, hkv, skv, d], d 64, 128 or 256;
// q head h reads kv head h / (hq / hkv) (GQA). Scores s = (q . k) * scale in
// fp32; with a softcap (Gemma-2) s = cap * tanh(s / cap) on the scaled score,
// before the mask (:776-787). Masked scores take the JAX package's finite mask
// value (never -inf, so exp never makes a NaN): keys past skv, query rows past
// sq, with causal the top-left mask col <= row in absolute indices, with a
// sliding window W (causal only) also col > row - W (_tile_mask :479-482), and
// with segment ids (int32 q_seg [b, sq], kv_seg [b, skv]) q_seg[row] !=
// kv_seg[col]. The forward keeps the online-softmax m, l and acc in fp32,
// rounds p to v's dtype before p.v (as the TPU kernel does), and writes o in
// q's dtype and lse = m + log(l) as fp32 [b, hq, sq] (no lane broadcast). The
// l == 0 guards of the TPU kernel's _store are kept. m starts at the finite mask
// value, so a row's kv tiles that are all masked (another document's, or below
// its window) add p = exp(0) = 1 each until its first real key, whose
// alpha = exp(mask - m) is exactly 0 and wipes them, as on the TPU. A row with
// no key at all (non-causal, a q segment absent from kv_seg; or, with sq > skv,
// a window that ends below key 0) keeps them: its o is the mean of v over every
// visited key column and its lse the mask value plus their log count.
//
// The backwards recompute p = exp(s - lse) and take di = rowsum(do . o) from the
// caller, with ds = p * (dp - di) * scale, times 1 - t^2 with a softcap (t the
// tanh of the capped score, recomputed from the raw product, :1130-1149). K2
// (one kernel, kv-major) accumulates dv += p^T do and dk += ds^T q in fp32
// registers over every q head of its kv head's GQA group, writes dk and dv once
// per kv head, rounded once, and adds dq += ds k with fp32 atomics into a zeroed
// fp32 buffer (the summation order of dq therefore varies from run to run, by
// rounding only): five products a tile pair. K5 is two kernels: the dq kernel
// (q-major) owns a q tile, loops over its kv tiles and writes dq once, in q's
// dtype, with no atomics; the dk/dv kernel is K2 without its dq. Seven products
// a tile pair, and a dq that is the same on every run. The fp32 backwards write
// dk and dv per q head; the caller sums their GQA groups.
//
// K12 stages two kv tiles a loop step and issues both q.k^T products before the
// softmax work of either; it then runs K1's update (the same function) on the
// first half and then the second, so o and lse equal K1's bit for bit: with
// causal, a half above the diagonal is all masked and, m being real by then,
// adds p = 0 with alpha = 1; with a window its pairs start at the even tile at
// or below the band, a tile that every row of the q tile masks, wiped as above.
// It takes the window but no segment ids or softcap (JAX's condition :856-858;
// the wrapper launches K1 otherwise).
//
// Options. Segment ids (kOptSeg), the window (kOptWin) and the softcap
// (kOptCap) are bits of a template argument of every kernel, so a variant
// carries only the code of its options and a call without them runs the code
// it ran before they existed: a run-time test of the id pointer inside K1's
// tile loop, taken the same way by every thread, made K1 1.5x slower at b4 h8
// s4096 d128 on an H100 without any segment ids. The window bounds every tile
// loop to its band: a q tile's kv loop runs from the tile of key q0 - W + 1 to
// the diagonal (_should_run :554-561, _clamp_kv :575-591); a kv tile's q loop
// from the diagonal to the tile of row kv0 + rows - 1 + W - 1 (_clamp_q :594-605).
// Tiles outside the band are never loaded. The cap uses tanhf (the fp32 path is
// held to 1e-4 relative; tanh.approx.f32 would not keep that).
//
// What bounds them on this card. At the bench training shape (b 4, h 8, s 4096,
// d 128, causal) attention is ~0.14 TFLOP forward and ~0.34 TFLOP backward a
// layer against ~0.1 GB of q/k/v/o traffic, and at Gemma-2's (b 1, hq 8, s 8192,
// d 256, causal) ~0.28 TFLOP forward: far above the card's ~295 flops a byte, so
// tensor-core throughput bounds them all, and the design keeps the s and p tiles
// out of device memory entirely (registers and shared memory only).
//
// bf16 layout. K1, K12 and K5's dq kernel run on mma.sync m16n8k16 (fp32
// accumulate): a block of 4 warps owns a 64-row q tile, each warp 16 rows, and
// loops over the 64-row kv tiles inside the block. The s accumulator fragments
// are re-packed in registers as the A operand of p.v and ds.k (no shared-memory
// round trip). Shared memory holds [64][d + 8] bf16 tiles (the pad puts a
// fragment's 8 rows in distinct banks): 3 for K1 (101 KB at d 256), 5 for K12
// (169 KB), 4 for K5's dq kernel. Registers a lane: a warp's 16 rows x d of
// fp32 accumulator are d / 2 registers, 128 at d 256, beside the 32 of a
// 16 x 64 score tile. The dk/dv kernels (K2, K5's second) run on warpgroup
// products (wgmma) fed by a cp.async ring: see flash_bwd_bf16 below.
//
// fp32 layout (a plain FMA path; exact comparisons need it). 128 threads; a
// thread owns one row of the tile and the columns and head dims j with
// j % P == its lane's residue, P threads a row. At d 64 and 128 tiles have 64
// rows (P = 2); at d 256, 32 rows (P = 4), because a 64-row tile of 256 fp32
// would need 263 KB of shared memory in the backward, and dk + dv would be 256
// registers a thread at P = 2. Shared-memory rows are padded to an odd pitch so
// that the rows a warp reads at once fall in distinct banks. Loads are
// synchronous 16-byte vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;  // rows of a q tile and of a kv tile (bf16 kernels)
// np_modeling_tpu/ops/attention.py DEFAULT_MASK_VALUE = -0.7 * float32 max.
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr unsigned kFull = 0xffffffffu;

// Option bits of every kernel's kOpt template argument.
constexpr int kOptSeg = 1;  // segment ids
constexpr int kOptWin = 2;  // a sliding window (causal only)
constexpr int kOptCap = 4;  // a logit softcap

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
  void* dk;          // k's dtype: bf16 [b, skv, hkv, d]; fp32 [b, skv, hq, d] (per q head)
  void* dv;
  const int* q_seg;  // [b, sq] int32 segment ids, or null (no segments)
  const int* kv_seg; // [b, skv]
  long long seg_q_b, seg_q_s, seg_kv_b, seg_kv_s;  // their element strides
  Strides st_q, st_k, st_v, st_do;
  int b, hq, hkv, sq, skv, causal;
  int window;        // kOptWin: row r sees keys (r - window, r]
  float scale;
  float softcap, inv_softcap;  // kOptCap
};

// Segment ids of rows [r0, r0 + ROWS) of a tile into shared memory. Rows past
// n get 0: score() gives their scores the mask value by bounds anyway, so the
// -1 / -2 padding sentinels of JAX's _seg_arrays (:625-628) are not needed.
template <int ROWS, int NT>
__device__ __forceinline__ void load_seg(int* dst, const int* seg, long long stride, int r0,
                                         int n) {
  for (int i = threadIdx.x; i < ROWS; i += NT)
    dst[i] = r0 + i < n ? __ldg(seg + (r0 + i) * stride) : 0;
}

// The score of q row `row` and key `col` from their raw product q . k: scaled;
// with kOptCap capped (cap_grad = 1 - t^2, the cap's derivative); the mask
// value where bounds, causality, the window or (kOptSeg) the segment ids
// row_ids[ri] != col_ids[ci] mask it. The ids are read only with kOptSeg.
template <int kOpt>
__device__ __forceinline__ float score(const Params& p, float raw, int row, int col,
                                       const int* row_ids, int ri, const int* col_ids, int ci,
                                       float& cap_grad) {
  float x = raw * p.scale;
  if constexpr ((kOpt & kOptCap) != 0) {
    const float t = tanhf(x * p.inv_softcap);
    cap_grad = 1.f - t * t;
    x = p.softcap * t;
  }
  bool out = row >= p.sq || col >= p.skv || (p.causal && col > row);
  if constexpr ((kOpt & kOptWin) != 0) out = out || col <= row - p.window;
  if constexpr ((kOpt & kOptSeg) != 0) out = out || row_ids[ri] != col_ids[ci];
  return out ? kMaskValue : x;
}

// The kv tiles [x, y) of T rows that q rows [q0, q0 + T) see: all of them, or
// with causal up to the diagonal, and with a window from the tile of key
// q0 - W + 1.
template <int T, int kOpt>
__device__ __forceinline__ int2 kv_tiles(const Params& p, int q0) {
  const int n = (p.skv + T - 1) / T;
  if (!p.causal) return make_int2(0, n);
  const int first = (kOpt & kOptWin) != 0 ? max(0, q0 - p.window + 1) / T : 0;
  return make_int2(first, min(n, (q0 + T - 1) / T + 1));
}

// The q tiles [x, y) of T rows whose rows see keys [kv0, kv0 + T): with causal
// from the diagonal, and with a window up to the tile of row kv0 + T - 1 + W - 1.
template <int T, int kOpt>
__device__ __forceinline__ int2 q_tiles(const Params& p, int kv0) {
  const int n = (p.sq + T - 1) / T;
  if (!p.causal) return make_int2(0, n);
  const int end = (kOpt & kOptWin) != 0 ? min(n, (kv0 + T + p.window - 2) / T + 1) : n;
  return make_int2(kv0 / T, end);
}

// Copies rows [0, ROWS) of a tile (rows past n_valid as zeros) into shared
// memory with row pitch LD elements, 16 bytes a thread at a time.
template <typename T, int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride,
                                          int n_valid) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecs = D / E;
  for (int i = threadIdx.x; i < ROWS * kVecs; i += NT) {
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
  static constexpr int kTileElems = kTile * kLd;
  // Segment ids of the q tile, then of the staged kv tile, end each layout.
  static constexpr size_t kSegBytes = 2 * kTile * sizeof(int);
  // q, then k and v of each of `halves` kv tiles; segment ids.
  static constexpr size_t fwd_bytes(int halves) {
    return (1 + 2 * halves) * kTileElems * sizeof(bf16) + kSegBytes;
  }
  // q, do, k, v; segment ids.
  static constexpr size_t kDqBytes = 4 * kTileElems * sizeof(bf16) + kSegBytes;
};

// K1's work on one kv tile at kv0 for this warp's 16 q rows (bf16): s = q.k^T
// in, scaled, capped and masked; the online-softmax update of m, l and acc;
// then acc += p (rounded to bf16) . v. K12 runs it on its two halves in turn.
template <int ND, int kOpt>
__device__ __forceinline__ void fwd_update_bf16(const Params& p, float (&s)[8][4],
                                                float (&m)[2], float (&l)[2],
                                                float (&acc)[ND][4], const bf16* vs, int ld,
                                                const int* seg_q, const int* seg_kv, int q0,
                                                int kv0, int rw, int g, int t) {
  float cap_grad;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = rw + g + (e >> 1) * 8, cl = 8 * n + 2 * t + (e & 1);
      s[n][e] = score<kOpt>(p, s[n][e], q0 + rl, kv0 + cl, seg_q, rl, seg_kv, cl, cap_grad);
    }
  }
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
// Grid (q tiles, b * hq); warp w owns q rows 16w .. 16w+15 of the tile.
template <int D, int kHalves, int kOpt>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(const Params p) {
  static_assert(kHalves == 1 || (kOpt & (kOptSeg | kOptCap)) == 0,
                "K12 takes no segment ids or softcap");
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

  load_rows<bf16, D, LD, kTile, kThreads>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
  if (kOpt & kOptSeg)
    load_seg<kTile, kThreads>(seg, p.q_seg + bb * p.seg_q_b, p.seg_q_s, q0, p.sq);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};

  const int n_kv = (p.skv + kTile - 1) / kTile;
  int2 band = kv_tiles<kTile, kOpt>(p, q0);
  if (kHalves == 2) band = make_int2(band.x & ~1, min(n_kv, (band.y + 1) & ~1));
  for (int kt = band.x; kt < band.y; kt += kHalves) {
    __syncthreads();  // the previous step's k/v reads are done
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const int kv0 = (kt + h) * kTile;
      load_rows<bf16, D, LD, kTile, kThreads>(ks + h * E, k + kv0 * p.st_k.s, p.st_k.s,
                                              p.skv - kv0);
      load_rows<bf16, D, LD, kTile, kThreads>(vs + h * E, v + kv0 * p.st_v.s, p.st_v.s,
                                              p.skv - kv0);
      if (kOpt & kOptSeg) load_seg<kTile, kThreads>(seg + kTile, kv_seg, p.seg_kv_s, kv0, p.skv);
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
      fwd_update_bf16<ND, kOpt>(p, s[h], m, l, acc, vs + h * E, LD, seg, seg + kTile, q0,
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

// ---- K2 (kDq) and K5's dk/dv kernel (!kDq), bf16: warpgroup products -----------
// Grid (b * hkv, kv blocks of BwdSmem<D>::kKv rows): the blocks of the first kv rows,
// which see the most q tiles under causal masking, start first. 256 threads, two
// warpgroups.
// The block owns its kv rows' dk and dv for the whole GQA group: it loops over the
// group's hq / hkv q heads and, for each, over the q tiles of the rows' band, keeping
// dk and dv in fp32 registers throughout, and writes [b, skv, hkv, d] once. q, do,
// lse, di (and the q tile's segment ids) stream through a 2-stage cp.async ring: the
// next tile's copies are in flight while the tensor cores work on this one. k, v, q
// and do lie in shared memory in the 128-byte swizzle (wgmma.cuh), so one copy of
// each serves as a K-major operand (s^T = k q^T, dp^T = v do^T) and as an MN-major one
// (dv += p^T do, dk += ds^T q, dq += ds k).
// d 64 / 128: kKv = 128, warpgroup w owns kv rows 64 w..: s^T and dp^T (m64n64) for its
//   rows, committed as two groups; their accumulators, rounded to bf16, are directly
//   the register A operand of dv += p^T do and dk += ds^T q (m64nD). p^T is formed
//   while dp^T is still in flight, and dv runs while ds^T is formed. K2: ds^T of all
//   128 rows goes to shared memory, then warpgroup w computes dq[:, w D/2 ..] = ds k
//   over the 128 keys (A by ldmatrix.trans).
// d 256: kKv = 64, both warpgroups own the same 64 rows and split the head dims: dk,
//   dv (and dq) of dims 128 w... s^T (warpgroup 0) and dp^T (warpgroup 1) are computed
//   once each and meet in shared memory: warpgroup 1 hands dp^T over in fp32,
//   warpgroup 0 forms p^T and ds^T and hands them back in bf16. Five products a tile
//   pair, as at d 64 / 128.
// dq (K2) is added into the fp32 buffer with 8-byte vector atomics (float2 atomicAdd,
// compute capability 9.x): its summation order varies from run to run, by rounding.
template <int D>
struct BwdSmem {
  static constexpr int kKv = D > 128 ? 64 : 128;     // kv rows of a block
  static constexpr int kKvBytes = kKv * D * 2;       // k (or v), bf16
  static constexpr int kQBytes = kTile * D * 2;      // a q (or do) tile
  // A stage: q, do, then lse, di and the q tile's segment ids (64 each).
  static constexpr int kStageBytes = (2 * kQBytes + 3 * kTile * 4 + 1023) / 1024 * 1024;
  // Stages of the q/do ring (a third measured no faster at the bench shape).
  static constexpr int kStages = 2;
  static constexpr int kXPitch = kTile + 8;          // bf16 pitch of ds^T / p^T rows
  // Exchange: ds^T [kKv][kXPitch] bf16 (d 64/128), or at d 256 dp^T [64][kXPitch]
  // fp32, then p^T and ds^T [64][kXPitch] bf16 in the same bytes.
  static constexpr int kXBytes = 128 * kXPitch * 2;
  static constexpr int kBytes =
      2 * kKvBytes + kStages * kStageBytes + kXBytes + kKv * 4 + 1024;
};

// The q tiles [x, y) of kTile rows whose rows see keys [kv0, kv0 + KV): with causal
// from the diagonal, and with a window up to the tile of row kv0 + KV - 1 + W - 1.
template <int KV, int kOpt>
__device__ __forceinline__ int2 q_band(const Params& p, int kv0) {
  const int n = (p.sq + kTile - 1) / kTile;
  if (!p.causal) return make_int2(0, n);
  const int end = (kOpt & kOptWin) != 0 ? min(n, (kv0 + KV + p.window - 2) / kTile + 1) : n;
  return make_int2(kv0 / kTile, end);
}

// Rows [0, ROWS) of a [rows][D] bf16 tile into SW128 column blocks of ROWS rows
// (16-byte cp.async; rows past n_valid as zeros), by the block's 256 threads.
template <int D, int ROWS>
__device__ __forceinline__ void cp_tile(uint8_t* dst, const bf16* src, long long stride,
                                        int n_valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += 256) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool live = r < n_valid;
    wg::cp_async16(wg::smem_u32(dst + (c / 64) * (ROWS * 128) + wg::sw128_offset(r, c % 64)),
                   live ? static_cast<const void*>(src + r * stride + c) : src,
                   live ? 16 : 0);
  }
}

// The register A operands of 4 k steps (64 columns) from a [64 rows] x 64 accumulator
// of m64n64 (rounded to bf16).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg::pack_a(a[kk], &x[8 * kk], &x[8 * kk + 4]);
}

// The same from a [64 rows][kXPitch] bf16 array in shared memory, row r0 = this warp's.
__device__ __forceinline__ void smem_to_a(uint32_t (&a)[4][4], const bf16* x, int r0, int g,
                                          int t) {
  constexpr int P = kTile + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* b = x + (r0 + g) * P + 16 * kk + 2 * t;
    a[kk][0] = ld32(b);
    a[kk][1] = ld32(b + 8 * P);
    a[kk][2] = ld32(b + 8);
    a[kk][3] = ld32(b + 8 * P + 8);
  }
}

// The A fragment of a 16 x 16 tile from its transpose in shared memory: 8 x 8
// blocks (rows 16 bytes, 16-byte aligned), thread l addressing row l % 8 of block
// l / 8; blocks 0..3 become a[0..3].
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&a)[4], const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(wg::smem_u32(row))
               : "memory");
}

template <int R>
__device__ __forceinline__ void fence_a(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// acc (m64 x N) += A (4 k steps of 16 rows) . X[16 kk.., cols], X a stage tile (q or
// do) read MN-major from column block `cb` on: 8 KB blocks of 64 rows.
template <int R>
__device__ __forceinline__ void rs_stage(float (&acc)[R], const uint32_t (&a)[4][4],
                                         uint32_t x, int cb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg::wgmma_rs<1>(acc, a[kk], wg::desc(x + cb * 8192 + kk * 2048, 8192, 1024), 1);
}

// dq[q rows, d0 .. d0 + N) += ds . k over the block's KV keys (ds^T from the exchange,
// k read MN-major), added into the fp32 buffer with 8-byte vector atomics (float2
// atomicAdd, compute capability 9.x; a bulk reduction through shared memory and
// 16-byte atomics measured no faster at the bench shape). rw: this warp's first q
// row.
template <int D, int N, int KV>
__device__ __forceinline__ void dq_pass(const Params& p, const bf16* dst_x, uint32_t ks, int d0,
                                        float* dq_rows, int q0, int rw, int g, int t) {
  constexpr int P = kTile + 8;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  uint32_t a[KV / 16][4];
#pragma unroll
  for (int kk = 0; kk < KV / 16; ++kk) {  // ds = (ds^T)^T: 8 x 8 blocks transposed
    const int lane = threadIdx.x % 32, mi = lane / 8;
    ldsm_x4_t(a[kk], dst_x + (16 * kk + (mi >> 1) * 8 + lane % 8) * P + rw + (mi & 1) * 8);
  }
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < KV / 16; ++kk)
    wg::wgmma_rs<1>(acc, a[kk],
                    wg::desc(ks + (d0 / 64) * (KV * 128) + (d0 % 64) * 2 + kk * 2048, KV * 128,
                             1024),
                    1);
  wg::commit();
  wg::wait<0>();
  wg::fence_acc(acc);
  fence_a(a);
  const long long row_stride = static_cast<long long>(p.hq) * D;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rw + g + 8 * h;
      if (row < p.sq)
        atomicAdd(reinterpret_cast<float2*>(dq_rows + (rw + g + 8 * h) * row_stride + d0 +
                                            8 * j + 2 * t),
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    }
  }
}

template <int D, bool kDq, int kOpt>
__global__ void __launch_bounds__(256, 1) flash_bwd_bf16(const Params p) {
  using S = BwdSmem<D>;
  constexpr int KV = S::kKv, KD = D / 16, XP = S::kXPitch;
  constexpr bool kSplitD = D > 128;
  constexpr int DW = kSplitD ? D / 2 : D;  // head dims of a warpgroup's dk and dv
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = smem;
  uint8_t* vs = ks + S::kKvBytes;
  uint8_t* stages = vs + S::kKvBytes;
  uint8_t* xch = stages + S::kStages * S::kStageBytes;
  int* seg_kv = reinterpret_cast<int*>(xch + S::kXBytes);

  const int kv0 = blockIdx.y * KV;
  const int bb = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv, group = p.hq / p.hkv;
  const int w = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int wi = tw / 32, lane = tw % 32, g = lane / 4, t = lane % 4;
  const int rw = wi * 16;                     // this warp's rows in its warpgroup's 64
  const int kr = (kSplitD ? 0 : 64 * w) + rw;  // ... as kv rows of the block
  const int d0 = kSplitD ? DW * w : 0;        // this warpgroup's dk/dv head dims

  const bf16* k = static_cast<const bf16*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const bf16* v = static_cast<const bf16*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  const int* q_seg = p.q_seg + bb * p.seg_q_b;
  const int2 band = q_band<KV, kOpt>(p, kv0);
  const int n_q = max(0, band.y - band.x), steps = group * n_q;

  // Tile `it` (q head hk * group + it / n_q, q tile band.x + it % n_q) into stage
  // it % kStages, one cp.async group (an empty one past the last tile, so that
  // every iteration commits one).
  auto issue = [&](int it) {
    const int hh = hk * group + it / n_q, q0 = (band.x + it % n_q) * kTile;
    if (it >= steps) {
      wg::cp_async_commit();
      return;
    }
    uint8_t* st = stages + (it % S::kStages) * S::kStageBytes;
    const bf16* q = static_cast<const bf16*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
    const bf16* dout = static_cast<const bf16*>(p.dout) + bb * p.st_do.b + hh * p.st_do.h;
    cp_tile<D, kTile>(st, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
    cp_tile<D, kTile>(st + S::kQBytes, dout + q0 * p.st_do.s, p.st_do.s, p.sq - q0);
    float* stats = reinterpret_cast<float*>(st + 2 * S::kQBytes);
    const long long row_stats = (static_cast<long long>(bb) * p.hq + hh) * p.sq + q0;
    const int i = threadIdx.x;
    const bool live = q0 + (i % kTile) < p.sq;
    if (i < kTile)
      wg::cp_async4(wg::smem_u32(stats + i), p.lse + (live ? row_stats + i : 0), live ? 4 : 0);
    else if (i < 2 * kTile)
      wg::cp_async4(wg::smem_u32(stats + i), p.di + (live ? row_stats + i - kTile : 0),
                    live ? 4 : 0);
    else if ((kOpt & kOptSeg) != 0 && i < 3 * kTile)
      wg::cp_async4(wg::smem_u32(stats + i),
                    q_seg + (live ? static_cast<long long>(q0 + i - 2 * kTile) * p.seg_q_s : 0),
                    live ? 4 : 0);
    wg::cp_async_commit();
  };

  cp_tile<D, KV>(ks, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
  cp_tile<D, KV>(vs, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);
  if (kOpt & kOptSeg)
    load_seg<KV, 256>(seg_kv, p.kv_seg + bb * p.seg_kv_b, p.seg_kv_s, kv0, p.skv);
  for (int it = 0; it < S::kStages - 1; ++it) issue(it);

  float dk[DW / 2], dv[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t k_s = wg::smem_u32(ks), v_s = wg::smem_u32(vs);
  // Byte offsets of k step kd (16 of the head dims) in k or v (warpgroup w's 64
  // rows at d 64 / 128) and in a q or do stage.
  auto kv_off = [](int kd, int wgi) {
    return static_cast<uint32_t>((kd / 4) * (KV * 128) + (kSplitD ? 0 : wgi * 8192) +
                                 (kd % 4) * 32);
  };
  auto q_off = [](int kd) { return static_cast<uint32_t>((kd / 4) * 8192 + (kd % 4) * 32); };

  for (int it = 0; it < steps; ++it) {
    const int hh = hk * group + it / n_q, q0 = (band.x + it % n_q) * kTile;
    wg::cp_async_wait<S::kStages - 2>();
    wg::fence_proxy();
    __syncthreads();  // tile it has landed; every read of tile it - 1 is done
    issue(it + S::kStages - 1);
    uint8_t* st = stages + (it % S::kStages) * S::kStageBytes;
    const uint32_t q_s = wg::smem_u32(st), do_s = q_s + S::kQBytes;
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * S::kQBytes);
    const float* di_s = lse_s + kTile;
    const int* seg_q = reinterpret_cast<const int*>(di_s + kTile);

    bf16* xb = reinterpret_cast<bf16*>(xch);
    bf16* pt_x = xb;                                  // d 256: p^T [64][XP]
    bf16* dst_x = kSplitD ? xb + kTile * XP : xb;     // ds^T [KV][XP]
    float s[32], dp[32];
    uint32_t ap[4][4], ads[4][4];  // p^T and ds^T as the register A of dv and dk
    if constexpr (!kSplitD) {
      // s^T = k q^T and dp^T = v do^T (m64n64, K = d) for this warpgroup's rows, in
      // two groups: p^T is formed while dp^T is still in flight, and dv += p^T do
      // runs while ds^T is formed.
      wg::fence();
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        wg::wgmma_ss<0, 0>(s, wg::desc(k_s + kv_off(kd, w), 16, 1024),
                           wg::desc(q_s + q_off(kd), 16, 1024), kd > 0);
      wg::commit();
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        wg::wgmma_ss<0, 0>(dp, wg::desc(v_s + kv_off(kd, w), 16, 1024),
                           wg::desc(do_s + q_off(kd), 16, 1024), kd > 0);
      wg::commit();
      wg::wait<1>();
      wg::fence_acc(s);
      // p^T = exp(s^T - lse) into ap (bf16); s keeps p^T (* 1 - t^2) for ds^T.
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        float pe[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kl = kr + g + 8 * ((i >> 1) & 1), ql = 8 * (i >> 2) + 2 * t + e;
          float cap_grad;
          const float x =
              score<kOpt>(p, s[i + e], q0 + ql, kv0 + kl, seg_q, ql, seg_kv, kl, cap_grad);
          pe[e] = expf(x - lse_s[ql]);
          s[i + e] = (kOpt & kOptCap) != 0 ? pe[e] * cap_grad : pe[e];
        }
        ap[i / 8][(i % 8) / 2] = wg::pack_bf16(pe[0], pe[1]);
      }
      wg::fence();
      rs_stage(dv, ap, do_s, 0);
      wg::commit();
      wg::wait<1>();  // dp^T has landed (dv may still be in flight)
      wg::fence_acc(dp);
      // ds^T = p^T (dp^T - di) (* 1 - t^2) * scale
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int ql = 8 * (i >> 2) + 2 * t + (i & 1);
        dp[i] = s[i] * (dp[i] - di_s[ql]) * p.scale;
      }
      acc_to_a(ads, dp);
      wg::fence();
      rs_stage(dk, ads, q_s, 0);
      wg::commit();
      if constexpr (kDq) {  // ds^T of the block's rows for dq, while dk runs
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(dst_x + (kr + g + 8 * h) * XP + 8 * j + 2 * t) =
                wg::pack_bf16(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]);
        wg::fence_proxy();
        __syncthreads();
      }
    } else {
      // d 256: s^T by warpgroup 0, dp^T by warpgroup 1, once each (16 k steps).
      wg::fence();
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        if (w == 0)
          wg::wgmma_ss<0, 0>(s, wg::desc(k_s + kv_off(kd, 0), 16, 1024),
                             wg::desc(q_s + q_off(kd), 16, 1024), kd > 0);
        else
          wg::wgmma_ss<0, 0>(dp, wg::desc(v_s + kv_off(kd, 0), 16, 1024),
                             wg::desc(do_s + q_off(kd), 16, 1024), kd > 0);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_acc(s);
      wg::fence_acc(dp);
      // Warpgroup 1 hands dp^T over in fp32; warpgroup 0 forms p^T and ds^T and
      // hands them back in bf16, in the same bytes.
      float* dp_x = reinterpret_cast<float*>(xch);    // dp^T [64][XP] fp32
      if (w == 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(dp_x + (rw + g + 8 * h) * XP + 8 * j + 2 * t) =
                make_float2(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]);
      }
      __syncthreads();
      if (w == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 x = *reinterpret_cast<const float2*>(dp_x + (rw + g + 8 * h) * XP +
                                                              8 * j + 2 * t);
            dp[4 * j + 2 * h] = x.x;
            dp[4 * j + 2 * h + 1] = x.y;
          }
        wg::bar_sync(1, 128);  // warpgroup 0 has read dp^T: its bytes take p^T, ds^T
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const int kl = rw + g + 8 * (e >> 1), ql = 8 * j + 2 * t + (e & 1);
            float cap_grad;
            const float x =
                score<kOpt>(p, s[i], q0 + ql, kv0 + kl, seg_q, ql, seg_kv, kl, cap_grad);
            const float pe = expf(x - lse_s[ql]);
            float d = pe * (dp[i] - di_s[ql]);
            if constexpr ((kOpt & kOptCap) != 0) d *= cap_grad;
            s[i] = pe;
            dp[i] = d * p.scale;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kl = rw + g + 8 * h, c = 8 * j + 2 * t;
            *reinterpret_cast<uint32_t*>(dst_x + kl * XP + c) =
                wg::pack_bf16(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]);
            *reinterpret_cast<uint32_t*>(pt_x + kl * XP + c) =
                wg::pack_bf16(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
          }
        acc_to_a(ap, s);
        acc_to_a(ads, dp);
      }
      wg::fence_proxy();
      __syncthreads();  // p^T and ds^T of every row are in shared memory
      if (w == 1) {
        smem_to_a(ap, pt_x, rw, g, t);
        smem_to_a(ads, dst_x, rw, g, t);
      }
      // dv += p^T do, dk += ds^T q over this warpgroup's half of the head dims.
      wg::fence();
      rs_stage(dv, ap, do_s, d0 / 64);
      rs_stage(dk, ads, q_s, d0 / 64);
      wg::commit();
    }
    wg::wait<0>();
    wg::fence_acc(dv);
    wg::fence_acc(dk);
    fence_a(ap);
    fence_a(ads);

    if constexpr (kDq) {
      // dq rows q0.. of head hh, this warpgroup's half of the head dims, over the
      // block's keys.
      float* dq_rows = static_cast<float*>(p.dq) +
                       ((static_cast<long long>(bb) * p.sq + q0) * p.hq + hh) * D;
      constexpr int NQ = D / 2 > 64 ? 64 : D / 2;  // dims a pass
#pragma unroll
      for (int pass = 0; pass < D / 2 / NQ; ++pass)
        dq_pass<D, NQ, KV>(p, dst_x, k_s, w * (D / 2) + pass * NQ, dq_rows, q0, rw, g, t);
    }
  }
  wg::cp_async_wait<0>();

  // dk, dv of this warpgroup's rows and head dims, rounded once, [b, skv, hkv, d].
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kv0 + kr + g + 8 * h;
    if (row >= p.skv) continue;
    const long long off =
        ((static_cast<long long>(bb) * p.skv + row) * p.hkv + hk) * D + d0 + 2 * t;
    bf16* dkd = static_cast<bf16*>(p.dk) + off;
    bf16* dvd = static_cast<bf16*>(p.dv) + off;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dkd + 8 * j) =
          wg::pack_bf16(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvd + 8 * j) =
          wg::pack_bf16(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// ---- K5's dq kernel, bf16 ----------------------------------------------------
// Grid (q tiles, b * hq); warp w owns q rows 16w .. 16w+15 of the tile and
// their dq, accumulated over the tile's kv band and written once.
template <int D, int kOpt>
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

  load_rows<bf16, D, LD, kTile, kThreads>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
  load_rows<bf16, D, LD, kTile, kThreads>(dos, dout + q0 * p.st_do.s, p.st_do.s, p.sq - q0);
  if (kOpt & kOptSeg)
    load_seg<kTile, kThreads>(seg, p.q_seg + bb * p.seg_q_b, p.seg_q_s, q0, p.sq);
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

  const int2 band = kv_tiles<kTile, kOpt>(p, q0);
  for (int kt = band.x; kt < band.y; ++kt) {
    const int kv0 = kt * kTile;
    __syncthreads();  // the previous tile's k/v reads are done
    load_rows<bf16, D, LD, kTile, kThreads>(ks, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
    load_rows<bf16, D, LD, kTile, kThreads>(vs, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);
    if (kOpt & kOptSeg) load_seg<kTile, kThreads>(seg + kTile, kv_seg, p.seg_kv_s, kv0, p.skv);
    __syncthreads();

    // s = q . k^T and dp = do . v^T over this warp's q rows and the tile's keys.
    float s[8][4], ds[8][4];
    zero8(s);
    mma_rowsT<KD>(s, qs, rw, ks, LD, g, t);
    zero8(ds);
    mma_rowsT<KD>(ds, dos, rw, vs, LD, g, t);
    // ds = exp(s - lse) * (dp - di) (* 1 - t^2) * scale
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = rw + g + (e >> 1) * 8, cl = 8 * n + 2 * t + (e & 1);
        float cap_grad;
        const float x = score<kOpt>(p, s[n][e], q0 + rl, kv0 + cl, seg, rl, seg + kTile, cl,
                                    cap_grad);
        float d = expf(x - lse[e >> 1]) * (ds[n][e] - di[e >> 1]);
        if constexpr ((kOpt & kOptCap) != 0) d *= cap_grad;
        ds[n][e] = d * p.scale;
      }
    }
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
// Thread i of the block owns tile row i / P and the columns (or head dims) j
// with j % P == i % P; shared-memory rows are padded to an odd pitch so that
// the rows a warp reads at once fall in distinct banks.

template <int D>
struct F32Smem {
  static constexpr int kRows = D > 128 ? 32 : 64;  // rows of a q tile and of a kv tile
  static constexpr int kPar = kThreads / kRows;    // P, threads a row
  static constexpr int kCols = kRows / kPar;       // a thread's scores of a tile row
  static constexpr int kDims = D / kPar;           // a thread's head dims
  static constexpr int kLd = D + 1;
  static constexpr int kLdP = kRows + 1;
  static constexpr int kTileElems = kRows * kLd;
  static constexpr int kPElems = kRows * kLdP;
  static constexpr size_t kSegBytes = 2 * kRows * sizeof(int);
  static constexpr size_t fwd_bytes(int halves) {
    return ((1 + 2 * halves) * kTileElems + kPElems) * sizeof(float) + kSegBytes;
  }
  static constexpr size_t kBwdBytes =
      (4 * kTileElems + 2 * kPElems + 2 * kRows) * sizeof(float) + kSegBytes;
  static constexpr size_t kDqBytes = (4 * kTileElems + kPElems) * sizeof(float) + kSegBytes;
};

// Sum (kSum) or max over the P threads of a row, all of which get the result.
template <int P, bool kSum>
__device__ __forceinline__ float row_reduce(float x) {
#pragma unroll
  for (int o = 1; o < P; o <<= 1) {
    const float y = __shfl_xor_sync(kFull, x, o);
    x = kSum ? x + y : fmaxf(x, y);
  }
  return x;
}

// K1's work on one kv tile at kv0 for tile row r, columns of residue h
// (fp32): s = q.k^T in, scaled, capped and masked; the online-softmax update;
// acc += p . v through the row's p in shared memory. K12 runs it on its
// halves in turn.
template <int D, int kOpt>
__device__ __forceinline__ void fwd_update_f32(const Params& p, float (&s)[F32Smem<D>::kCols],
                                               float& m, float& l,
                                               float (&acc)[F32Smem<D>::kDims], float* ps,
                                               const float* vs, const int* seg_q,
                                               const int* seg_kv, int q0, int kv0, int r,
                                               int h) {
  using S = F32Smem<D>;
  constexpr int LD = S::kLd, LP = S::kLdP, P = S::kPar, NC = S::kCols, HD = S::kDims;
  float cap_grad;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    s[j] = score<kOpt>(p, s[j], q0 + r, kv0 + P * j + h, seg_q, r, seg_kv, P * j + h,
                       cap_grad);
  float mx = m;
#pragma unroll
  for (int j = 0; j < NC; ++j) mx = fmaxf(mx, s[j]);
  mx = row_reduce<P, false>(mx);
  const float alpha = expf(m - mx);
  m = mx;
  float rs = 0.f;
  __syncwarp();  // the row's previous p reads (the other half of K12) are done
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const float pe = expf(s[j] - m);
    ps[r * LP + P * j + h] = pe;
    rs += pe;
  }
  rs = row_reduce<P, true>(rs);
  l = alpha * l + rs;
  __syncwarp();  // row r of p is written by this warp's P lanes of the row
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] *= alpha;
#pragma unroll 2
  for (int c = 0; c < S::kRows; ++c) {
    const float pc = ps[r * LP + c];
#pragma unroll
    for (int i = 0; i < HD; ++i) acc[i] = fmaf(pc, vs[c * LD + P * i + h], acc[i]);
  }
}

// s[j] = x[r] . y[P j + h] over the head dim, for row-major [rows][D] fp32
// tiles with pitch LD.
template <int D>
__device__ __forceinline__ void dots_f32(float (&s)[F32Smem<D>::kCols], const float* x, int r,
                                         const float* y, int h) {
  using S = F32Smem<D>;
  constexpr int LD = S::kLd, P = S::kPar, NC = S::kCols;
#pragma unroll
  for (int j = 0; j < NC; ++j) s[j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float xd = x[r * LD + d];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = fmaf(xd, y[(P * j + h) * LD + d], s[j]);
  }
}

template <int D, int kHalves, int kOpt>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  static_assert(kHalves == 1 || (kOpt & (kOptSeg | kOptCap)) == 0,
                "K12 takes no segment ids or softcap");
  using S = F32Smem<D>;
  constexpr int T = S::kRows, LD = S::kLd, P = S::kPar, HD = S::kDims, E = S::kTileElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + E;
  float* vs = ks + kHalves * E;
  float* ps = vs + kHalves * E;
  int* seg = reinterpret_cast<int*>(ps + S::kPElems);

  const int n_q = (p.sq + T - 1) / T;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * T;
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int r = threadIdx.x / P, h = threadIdx.x % P;
  const int row = q0 + r;

  const float* q = static_cast<const float*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const float* k = static_cast<const float*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const float* v = static_cast<const float*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  const int* kv_seg = p.kv_seg + bb * p.seg_kv_b;
  load_rows<float, D, LD, T, kThreads>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
  if (kOpt & kOptSeg) load_seg<T, kThreads>(seg, p.q_seg + bb * p.seg_q_b, p.seg_q_s, q0, p.sq);

  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;
  float m = kMaskValue, l = 0.f;

  const int n_kv = (p.skv + T - 1) / T;
  int2 band = kv_tiles<T, kOpt>(p, q0);
  if (kHalves == 2) band = make_int2(band.x & ~1, min(n_kv, (band.y + 1) & ~1));
  for (int kt = band.x; kt < band.y; kt += kHalves) {
    __syncthreads();
#pragma unroll
    for (int hv = 0; hv < kHalves; ++hv) {
      const int kv0 = (kt + hv) * T;
      load_rows<float, D, LD, T, kThreads>(ks + hv * E, k + kv0 * p.st_k.s, p.st_k.s,
                                           p.skv - kv0);
      load_rows<float, D, LD, T, kThreads>(vs + hv * E, v + kv0 * p.st_v.s, p.st_v.s,
                                           p.skv - kv0);
      if (kOpt & kOptSeg) load_seg<T, kThreads>(seg + T, kv_seg, p.seg_kv_s, kv0, p.skv);
    }
    __syncthreads();

    float s[kHalves][S::kCols];
#pragma unroll
    for (int hv = 0; hv < kHalves; ++hv) dots_f32<D>(s[hv], qs, r, ks + hv * E, h);
#pragma unroll
    for (int hv = 0; hv < kHalves; ++hv)
      fwd_update_f32<D, kOpt>(p, s[hv], m, l, acc, ps, vs + hv * E, seg, seg + T, q0,
                              (kt + hv) * T, r, h);
  }

  if (row < p.sq) {
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
    float* dst = static_cast<float*>(p.o) +
                 ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D + h;
#pragma unroll
    for (int i = 0; i < HD; ++i) dst[P * i] = acc[i] * l_inv;
    if (p.lse != nullptr && h == 0)
      p.lse[(static_cast<long long>(bb) * p.hq + hh) * p.sq + row] =
          m + logf(l == 0.f ? 1.f : l);
  }
}

// K2 (kDq) and K5's dk/dv kernel (!kDq), fp32: thread i owns kv row i / P.
template <int D, bool kDq, int kOpt>
__global__ void __launch_bounds__(kThreads) flash_bwd_f32(const Params p) {
  using S = F32Smem<D>;
  constexpr int T = S::kRows, LD = S::kLd, LP = S::kLdP, P = S::kPar, NC = S::kCols;
  constexpr int HD = S::kDims;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + S::kTileElems;
  float* qs = vs + S::kTileElems;
  float* dos = qs + S::kTileElems;
  float* pt = dos + S::kTileElems;  // p^T of the tile pair, [kv][q]
  float* dst_t = pt + S::kPElems;    // ds^T, [kv][q]
  float* lse_s = dst_t + S::kPElems;
  float* di_s = lse_s + T;
  int* seg = reinterpret_cast<int*>(di_s + T);

  const int kv0 = blockIdx.x * T;
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int c = threadIdx.x / P, h = threadIdx.x % P;  // kv row c (and q row c for dq)
  const int col = kv0 + c;

  const float* q = static_cast<const float*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const float* k = static_cast<const float*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const float* v = static_cast<const float*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  const float* dout = static_cast<const float*>(p.dout) + bb * p.st_do.b + hh * p.st_do.h;
  const int* q_seg = p.q_seg + bb * p.seg_q_b;
  const long long row_stats = (static_cast<long long>(bb) * p.hq + hh) * p.sq;
  load_rows<float, D, LD, T, kThreads>(ks, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
  load_rows<float, D, LD, T, kThreads>(vs, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);
  if (kOpt & kOptSeg)
    load_seg<T, kThreads>(seg + T, p.kv_seg + bb * p.seg_kv_b, p.seg_kv_s, kv0, p.skv);
  const int* seg_kv = seg + T;

  float dk[HD], dv[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) dk[i] = dv[i] = 0.f;

  const int2 band = q_tiles<T, kOpt>(p, kv0);
  for (int qt = band.x; qt < band.y; ++qt) {
    const int q0 = qt * T;
    __syncthreads();
    load_rows<float, D, LD, T, kThreads>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
    load_rows<float, D, LD, T, kThreads>(dos, dout + q0 * p.st_do.s, p.st_do.s, p.sq - q0);
    for (int i = threadIdx.x; i < T; i += kThreads) {
      const bool live = q0 + i < p.sq;
      lse_s[i] = live ? p.lse[row_stats + q0 + i] : 0.f;
      di_s[i] = live ? p.di[row_stats + q0 + i] : 0.f;
    }
    if (kOpt & kOptSeg) load_seg<T, kThreads>(seg, q_seg, p.seg_q_s, q0, p.sq);
    __syncthreads();

    // p^T, and (kOptCap) the cap's derivative parked in this thread's ds^T
    // entries until ds^T is formed below.
    float x[NC];
    dots_f32<D>(x, ks, c, qs, h);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int ql = P * j + h;
      float cap_grad;
      const float sc = score<kOpt>(p, x[j], q0 + ql, col, seg, ql, seg_kv, c, cap_grad);
      pt[c * LP + ql] = expf(sc - lse_s[ql]);
      if constexpr ((kOpt & kOptCap) != 0) dst_t[c * LP + ql] = cap_grad;
    }
    dots_f32<D>(x, vs, c, dos, h);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int ql = P * j + h;
      float d = pt[c * LP + ql] * (x[j] - di_s[ql]);
      if constexpr ((kOpt & kOptCap) != 0) d *= dst_t[c * LP + ql];
      dst_t[c * LP + ql] = d * p.scale;
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < T; ++r) {
      const float pr = pt[c * LP + r], dsr = dst_t[c * LP + r];
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        dv[i] = fmaf(pr, dos[r * LD + P * i + h], dv[i]);
        dk[i] = fmaf(dsr, qs[r * LD + P * i + h], dk[i]);
      }
    }
    if (!kDq) continue;
    // dq row q0 + c, dims of residue h, 16 at a time, added atomically.
    const int row = q0 + c;
    float* dq = static_cast<float*>(p.dq) +
                ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D + h;
#pragma unroll 1
    for (int i0 = 0; i0 < HD; i0 += 16) {
      float a[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = 0.f;
      for (int cc = 0; cc < T; ++cc) {
        const float w = dst_t[cc * LP + c];
#pragma unroll
        for (int i = 0; i < 16; ++i) a[i] = fmaf(w, ks[cc * LD + P * (i0 + i) + h], a[i]);
      }
      if (row < p.sq) {
#pragma unroll
        for (int i = 0; i < 16; ++i) atomicAdd(dq + P * (i0 + i), a[i]);
      }
    }
  }

  if (col < p.skv) {
    const long long off = ((static_cast<long long>(bb) * p.skv + col) * p.hq + hh) * D + h;
    float* dkd = static_cast<float*>(p.dk) + off;
    float* dvd = static_cast<float*>(p.dv) + off;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      dkd[P * i] = dk[i];
      dvd[P * i] = dv[i];
    }
  }
}

// K5's dq kernel, fp32: thread i owns q row i / P and the head dims of residue
// i % P of its dq; the row's ds goes through shared memory.
template <int D, int kOpt>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32(const Params p) {
  using S = F32Smem<D>;
  constexpr int T = S::kRows, LD = S::kLd, LP = S::kLdP, P = S::kPar, NC = S::kCols;
  constexpr int HD = S::kDims;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + S::kTileElems;
  float* ks = dos + S::kTileElems;
  float* vs = ks + S::kTileElems;
  float* dss = vs + S::kTileElems;  // ds of the tile pair, [q][kv]
  int* seg = reinterpret_cast<int*>(dss + S::kPElems);

  const int n_q = (p.sq + T - 1) / T;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * T;
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int r = threadIdx.x / P, h = threadIdx.x % P;
  const int row = q0 + r;

  const float* q = static_cast<const float*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const float* k = static_cast<const float*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const float* v = static_cast<const float*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  const float* dout = static_cast<const float*>(p.dout) + bb * p.st_do.b + hh * p.st_do.h;
  const int* kv_seg = p.kv_seg + bb * p.seg_kv_b;
  const long long row_stats = (static_cast<long long>(bb) * p.hq + hh) * p.sq;
  load_rows<float, D, LD, T, kThreads>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
  load_rows<float, D, LD, T, kThreads>(dos, dout + q0 * p.st_do.s, p.st_do.s, p.sq - q0);
  if (kOpt & kOptSeg) load_seg<T, kThreads>(seg, p.q_seg + bb * p.seg_q_b, p.seg_q_s, q0, p.sq);
  const float lse = row < p.sq ? p.lse[row_stats + row] : 0.f;
  const float di = row < p.sq ? p.di[row_stats + row] : 0.f;

  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;

  const int2 band = kv_tiles<T, kOpt>(p, q0);
  for (int kt = band.x; kt < band.y; ++kt) {
    const int kv0 = kt * T;
    __syncthreads();
    load_rows<float, D, LD, T, kThreads>(ks, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
    load_rows<float, D, LD, T, kThreads>(vs, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);
    if (kOpt & kOptSeg) load_seg<T, kThreads>(seg + T, kv_seg, p.seg_kv_s, kv0, p.skv);
    __syncthreads();

    float pr[NC], dp[NC];
    dots_f32<D>(pr, qs, r, ks, h);
    dots_f32<D>(dp, dos, r, vs, h);
    __syncwarp();  // the row's previous ds reads are done
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int cl = P * j + h;
      float cap_grad;
      const float x = score<kOpt>(p, pr[j], row, kv0 + cl, seg, r, seg + T, cl, cap_grad);
      float d = expf(x - lse) * (dp[j] - di);
      if constexpr ((kOpt & kOptCap) != 0) d *= cap_grad;
      dss[r * LP + cl] = d * p.scale;
    }
    __syncwarp();  // row r of ds is written by this warp's P lanes of the row
#pragma unroll 2
    for (int cc = 0; cc < T; ++cc) {
      const float w = dss[r * LP + cc];
#pragma unroll
      for (int i = 0; i < HD; ++i) acc[i] = fmaf(w, ks[cc * LD + P * i + h], acc[i]);
    }
  }

  if (row < p.sq) {
    float* dst = static_cast<float*>(p.dq) +
                 ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D + h;
#pragma unroll
    for (int i = 0; i < HD; ++i) dst[P * i] = acc[i];
  }
}

// ---- launches ----------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
           const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Calls f(std::integral_constant<int, opt>()) for the run-time option bits.
template <typename F>
int with_opt(int opt, F&& f) {
  switch (opt) {
    case 0: return f(std::integral_constant<int, 0>());
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Params make_params(const long long* strides, const int* q_seg, const int* kv_seg, int b,
                   int hq, int hkv, int sq, int skv, int causal, int window, float scale,
                   float softcap) {
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
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  p.inv_softcap = softcap > 0.f ? 1.f / softcap : 0.f;
  return p;
}

// The option bits of a call.
int opts_of(const Params& p) {
  return (p.q_seg != nullptr ? kOptSeg : 0) | (p.window > 0 ? kOptWin : 0) |
         (p.softcap > 0.f ? kOptCap : 0);
}

dim3 tiles(int n, int rows, int bh) { return dim3((n + rows - 1) / rows, bh); }

template <int D>
int launch_fwd(const Params& p, int dtype, int dual, cudaStream_t s) {
  const int opt = opts_of(p), bh = p.b * p.hq;
  using B = Bf16Smem<D>;
  using F = F32Smem<D>;
  if (dual) {  // K12: the window only
    if (opt & ~kOptWin) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 1)
      return opt ? launch(flash_fwd_bf16<D, 2, kOptWin>, tiles(p.sq, kTile, bh), kThreads,
                          B::fwd_bytes(2), s, p)
                 : launch(flash_fwd_bf16<D, 2, 0>, tiles(p.sq, kTile, bh), kThreads,
                          B::fwd_bytes(2), s, p);
    return opt ? launch(flash_fwd_f32<D, 2, kOptWin>, tiles(p.sq, F::kRows, bh), kThreads,
                        F::fwd_bytes(2), s, p)
               : launch(flash_fwd_f32<D, 2, 0>, tiles(p.sq, F::kRows, bh), kThreads,
                        F::fwd_bytes(2), s, p);
  }
  return with_opt(opt, [&](auto o) {
    constexpr int kOpt = decltype(o)::value;
    if (dtype == 1)
      return launch(flash_fwd_bf16<D, 1, kOpt>, tiles(p.sq, kTile, bh), kThreads,
                    B::fwd_bytes(1), s, p);
    return launch(flash_fwd_f32<D, 1, kOpt>, tiles(p.sq, F::kRows, bh), kThreads,
                  F::fwd_bytes(1), s, p);
  });
}

template <int D>
int launch_bwd(const Params& p, int dtype, int split, cudaStream_t s) {
  const int bh = p.b * p.hq;
  using B = Bf16Smem<D>;
  using F = F32Smem<D>;
  return with_opt(opts_of(p), [&](auto o) {
    constexpr int kOpt = decltype(o)::value;
    if (dtype == 1) {
      using W = BwdSmem<D>;
      const dim3 grid_q = tiles(p.sq, kTile, bh);
      const dim3 grid_kv(p.b * p.hkv, (p.skv + W::kKv - 1) / W::kKv);
      if (!split)
        return launch(flash_bwd_bf16<D, true, kOpt>, grid_kv, 256, W::kBytes, s, p);
      int rc = launch(flash_bwd_dq_bf16<D, kOpt>, grid_q, kThreads, B::kDqBytes, s, p);
      if (rc == 0) rc = launch(flash_bwd_bf16<D, false, kOpt>, grid_kv, 256, W::kBytes, s, p);
      return rc;
    }
    const dim3 grid_q = tiles(p.sq, F::kRows, bh), grid_kv = tiles(p.skv, F::kRows, bh);
    if (!split)
      return launch(flash_bwd_f32<D, true, kOpt>, grid_kv, kThreads, F::kBwdBytes, s, p);
    int rc = launch(flash_bwd_dq_f32<D, kOpt>, grid_q, kThreads, F::kDqBytes, s, p);
    if (rc == 0) rc = launch(flash_bwd_f32<D, false, kOpt>, grid_kv, kThreads, F::kBwdBytes, s, p);
    return rc;
  });
}

}  // namespace

// dtype codes: 0 = float32 (FMA path), 1 = bfloat16 (tensor cores); d is 64,
// 128 or 256. strides: 16 element strides, (b, h, s) of q, k, v and do, in that
// order (the forward reads the first 9), then (b, s) of q_seg and of kv_seg.
// q_seg/kv_seg: int32 segment ids, both null for none. window: 0 for none, else
// W >= 1 (causal only). softcap: 0 for none, else the cap > 0. Outputs and
// scratch are allocated by the caller: o [b, sq, hq, d] in q's dtype; lse
// [b, hq, sq] fp32 or null; dk/dv in k's dtype, [b, skv, hkv, d] for bf16 (the
// GQA groups summed in the kernel), [b, skv, hq, d] for fp32; dq [b, sq, hq,
// d], fp32 and zeroed for K2 (split 0), in q's dtype for K5 (split 1). dual 1
// runs K12, without segment ids or softcap (the caller checks that the kv
// tiles are even in number). Both return the first nonzero cudaGetLastError()
// of their launches (0 on success).
extern "C" int np_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      float* lse, const int* q_seg, const int* kv_seg,
                                      const long long* strides, int dtype, int b, int hq,
                                      int hkv, int sq, int skv, int d, int causal, int dual,
                                      int window, float scale, float softcap, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(strides, q_seg, kv_seg, b, hq, hkv, sq, skv, causal, window, scale,
                         softcap);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fwd<64>(p, dtype, dual, s);
  if (d == 128) return launch_fwd<128>(p, dtype, dual, s);
  if (d == 256) return launch_fwd<256>(p, dtype, dual, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int np_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* di,
                                      const int* q_seg, const int* kv_seg, void* dq, void* dk,
                                      void* dv, const long long* strides, int dtype, int b,
                                      int hq, int hkv, int sq, int skv, int d, int causal,
                                      int split, int window, float scale, float softcap,
                                      void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(strides, q_seg, kv_seg, b, hq, hkv, sq, skv, causal, window, scale,
                         softcap);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.di = di;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_bwd<64>(p, dtype, split, s);
  if (d == 128) return launch_bwd<128>(p, dtype, split, s);
  if (d == 256) return launch_bwd<256>(p, dtype, split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
