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
// (one kernel, kv-major) accumulates dv += p^T do and dk += ds^T q per kv tile
// in fp32 registers and adds dq += ds k with fp32 atomics into a zeroed fp32
// buffer (the summation order of dq therefore varies from run to run, by
// rounding only): five products a tile pair. K5 is two kernels: the dq kernel
// (q-major) owns a q tile, loops over its kv tiles and writes dq once, in q's
// dtype, with no atomics; the dk/dv kernel is K2 without its dq. Seven products
// a tile pair, and a dq that is the same on every run. dk and dv come out per q
// head; the caller sums GQA groups.
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
// from the diagonal to the tile of row kv0 + 63 + W - 1 (_clamp_q :594-605).
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
// bf16 layout. Every product runs on the tensor cores with mma.sync m16n8k16
// (fp32 accumulate): a block of 4 warps owns a 64-row tile (q rows in the
// forwards and the dq kernel, kv rows in the dk/dv kernels), each warp 16 rows,
// and loops over the other side's 64-row tiles inside the block. The s
// accumulator fragments are re-packed in registers as the A operand of p.v,
// ds^T q and (K5) ds.k (no shared-memory round trip); in K2 only ds goes
// through shared memory, for dq, whose rows span all 4 warps. Shared memory
// holds [64][d + 8] bf16 tiles (the pad puts a fragment's 8 rows in distinct
// banks): 3 for K1 (101 KB at d 256), 5 for K12 (169 KB), 4 and the ds tile for
// K2/K5 (145 KB). Registers a lane: a warp's 16 rows x d of fp32 accumulator
// are d / 2 registers, 128 at d 256, beside the 32 of a 16 x 64 score tile: K1
// and K5's dq kernel keep them in one warp. The dk/dv kernels hold dk and dv,
// which at d 256 would be 256 registers a lane, more than a thread has. There
// the block has 8 warps: warps w and w + 4 own the same 16 kv rows, and each
// keeps dk, dv and K2's dq for one half of the head dims (FlashAttention-2 at
// d 256 splits the same way). Both warps compute their rows' s and dp over
// the whole head dim, so K2 at d 256 does 7 products a tile pair instead of 5
// (sharing them through shared memory is later work). ptxas: 242..255
// registers at d 256 bf16, Gemma-2's variants without spills.
//
// fp32 layout (a plain FMA path; exact comparisons need it). 128 threads; a
// thread owns one row of the tile and the columns and head dims j with
// j % P == its lane's residue, P threads a row. At d 64 and 128 tiles have 64
// rows (P = 2); at d 256, 32 rows (P = 4), because a 64-row tile of 256 fp32
// would need 263 KB of shared memory in the backward, and dk + dv would be 256
// registers a thread at P = 2. Shared-memory rows are padded to an odd pitch so
// that the rows a warp reads at once fall in distinct banks. Loads are
// synchronous 16-byte vectors; cp.async/TMA pipelining, wgmma and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  void* dk;          // [b, skv, hq, d], k's dtype (per q head)
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
  static constexpr int kLdS = kTile + 8;    // pitch of the [64][64] ds tile
  static constexpr int kTileElems = kTile * kLd;
  // Head-dim halves of the dk/dv kernels' warps (8 warps at d 256).
  static constexpr int kSlices = D > 128 ? 2 : 1;
  static constexpr int kBwdThreads = kThreads * kSlices;
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

// ---- K2 (kDq) and K5's dk/dv kernel (!kDq), bf16 ----------------------------
// Grid (kv tiles, b * hq). Warp w owns kv rows 16 (w % 4) .. + 15 of the tile
// and (at d 256, 8 warps) the head dims [DS (w / 4), DS (w / 4 + 1)) of their
// dk and dv and of K2's dq rows 16 (w % 4) ...
template <int D, bool kDq, int kOpt>
__global__ void __launch_bounds__(Bf16Smem<D>::kBwdThreads) flash_bwd_bf16(const Params p) {
  using S = Bf16Smem<D>;
  constexpr int LD = S::kLd, LDS = S::kLdS, KD = D / 16, NT = S::kBwdThreads;
  constexpr int DS = D / S::kSlices, NDS = DS / 8;  // a warp's slice of the head dims
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
  const int rw = (warp % kWarps) * 16, dh = (warp / kWarps) * DS;

  const bf16* q = static_cast<const bf16*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const bf16* k = static_cast<const bf16*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const bf16* v = static_cast<const bf16*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  const bf16* dout = static_cast<const bf16*>(p.dout) + bb * p.st_do.b + hh * p.st_do.h;
  const int* q_seg = p.q_seg + bb * p.seg_q_b;
  const long long row_stats = (static_cast<long long>(bb) * p.hq + hh) * p.sq;

  load_rows<bf16, D, LD, kTile, NT>(ks, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
  load_rows<bf16, D, LD, kTile, NT>(vs, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);
  if (kOpt & kOptSeg)
    load_seg<kTile, NT>(seg + kTile, p.kv_seg + bb * p.seg_kv_b, p.seg_kv_s, kv0, p.skv);
  const int* seg_kv = seg + kTile;

  float dk[NDS][4], dv[NDS][4];
#pragma unroll
  for (int n = 0; n < NDS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int2 band = q_tiles<kTile, kOpt>(p, kv0);
  for (int qt = band.x; qt < band.y; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile pair's q/do/ds reads are done
    load_rows<bf16, D, LD, kTile, NT>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
    load_rows<bf16, D, LD, kTile, NT>(dos, dout + q0 * p.st_do.s, p.st_do.s, p.sq - q0);
    for (int i = threadIdx.x; i < kTile; i += NT) {
      const bool live = q0 + i < p.sq;
      lse_s[i] = live ? p.lse[row_stats + q0 + i] : 0.f;
      di_s[i] = live ? p.di[row_stats + q0 + i] : 0.f;
    }
    if (kOpt & kOptSeg) load_seg<kTile, NT>(seg, q_seg, p.seg_q_s, q0, p.sq);
    __syncthreads();

    // s^T = k . q^T and dp^T = v . do^T over the whole head dim: rows = this
    // warp's kv rows, cols = the q rows.
    float s[8][4], ds[8][4];
    zero8(s);
    mma_rowsT<KD>(s, ks, rw, qs, LD, g, t);
    zero8(ds);
    mma_rowsT<KD>(ds, vs, rw, dos, LD, g, t);
    // p^T = exp(s^T - lse); ds^T = p^T * (dp^T - di) (* 1 - t^2) * scale
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = rw + g + (e >> 1) * 8, ql = 8 * n + 2 * t + (e & 1);
        float cap_grad;
        const float x = score<kOpt>(p, s[n][e], q0 + ql, kv0 + kl, seg, ql, seg_kv, kl,
                                    cap_grad);
        const float pe = expf(x - lse_s[ql]);
        float d = pe * (ds[n][e] - di_s[ql]);
        if constexpr ((kOpt & kOptCap) != 0) d *= cap_grad;
        d *= p.scale;
        s[n][e] = pe;
        ds[n][e] = d;
        if (kDq && dh == 0) dss[ql * LDS + kl] = __float2bfloat16_rn(d);
      }
    }
    // dv += p^T (rounded to bf16) . do, dk += ds^T (rounded to bf16) . q, over
    // this warp's head dims.
    mma_frag_rows<NDS>(dv, s, dos + dh, LD, g, t);
    mma_frag_rows<NDS>(dk, ds, qs + dh, LD, g, t);
    if (!kDq) continue;
    __syncthreads();  // ds of all 4 row blocks is in shared memory

    // dq[rows rw ..][this warp's dims] += ds . k over the tile's 64 keys,
    // added atomically.
    float dq[NDS][4];
#pragma unroll
    for (int n = 0; n < NDS; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      load_a(a, dss, LDS, rw, 16 * kk, g, t);
      mma_rows<NDS>(dq, a, ks + dh, LD, 16 * kk, g, t);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + rw + g + 8 * i;
      if (row >= p.sq) continue;
      float* dst = static_cast<float*>(p.dq) +
                   ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D + dh + 2 * t;
#pragma unroll
      for (int n = 0; n < NDS; ++n) {
        atomicAdd(dst + 8 * n, dq[n][2 * i]);
        atomicAdd(dst + 8 * n + 1, dq[n][2 * i + 1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kv0 + rw + g + 8 * i;
    if (row >= p.skv) continue;
    const long long off =
        ((static_cast<long long>(bb) * p.skv + row) * p.hq + hh) * D + dh + 2 * t;
    bf16* dkd = static_cast<bf16*>(p.dk) + off;
    bf16* dvd = static_cast<bf16*>(p.dv) + off;
#pragma unroll
    for (int n = 0; n < NDS; ++n) {
      *reinterpret_cast<uint32_t*>(dkd + 8 * n) = pack_bf16(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvd + 8 * n) = pack_bf16(dv[n][2 * i], dv[n][2 * i + 1]);
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
      const dim3 grid_q = tiles(p.sq, kTile, bh), grid_kv = tiles(p.skv, kTile, bh);
      if (!split)
        return launch(flash_bwd_bf16<D, true, kOpt>, grid_kv, B::kBwdThreads, B::kBwdBytes, s,
                      p);
      int rc = launch(flash_bwd_dq_bf16<D, kOpt>, grid_q, kThreads, B::kDqBytes, s, p);
      if (rc == 0)
        rc = launch(flash_bwd_bf16<D, false, kOpt>, grid_kv, B::kBwdThreads, B::kBwdBytes, s,
                    p);
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
// [b, hq, sq] fp32 or null; dk/dv [b, skv, hq, d] in k's dtype; dq [b, sq, hq,
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
