// Flash attention for Hopper (sm_90a): the forward (K1) and its dual-kv
// schedule (K12), the fused backward (K2) and the split backward (K5).
//
// Replaces the Pallas TPU kernels of np_modeling_tpu/ops/attention.py:
//   K1  forward        _fwd_tile      (:756, launched by _flash_fwd_pallas :829, call :904)
//   K12 dual forward   _fwd_tile_dual (:693, launched by _flash_fwd_dual :929, call :941)
//   K2  fused backward _dkvq_tile     (:1100, launched by _flash_bwd_pallas :1188, call :1335)
//   K5  split backward _dq_tile (:983, call :1267) + _dkv_tile (:1045, call :1335)
//
// What they compute. q [b, hq, sq, d], k/v [b, hkv, skv, d], d 64, 128, 192 or 256;
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
// alpha = exp(mask - m) is exactly 0 and wipes them, as on the TPU. A key column
// past skv adds p = 0 (a test on edge tiles only; the last kv tile is one when
// skv is not a multiple of the tile), so a row that no key sees (non-causal, a q
// segment absent from kv_seg) averages over the real keys it visits: with every
// kv tile visited, o is the mean of v over all skv keys and lse = mask +
// log(skv), what the plain path and the JAX package's jnp path give, at every
// tile width. The backwards recompute p from that lse and follow. One divergence
// stays (ROADMAP Queue 3): with a window and sq > skv, a causal row r >= skv +
// W - 1 sees no key, and band skipping does not visit every kv tile for it. A q
// tile all of whose rows are such visits none: the l == 0 guard stores o = 0 and
// lse = the mask value (and the backwards give such rows dq = 0), where the
// plain path gives the mean of v; a q tile that holds such rows beside rows
// with keys gives them the mean over the real keys of the tiles it visits.
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
// K12 takes two kv tiles a loop step and issues both q.k^T products before the
// softmax work of either; it then runs K1's update (the same function) on the
// first tile and then the second, so o and lse equal K1's bit for bit: with
// causal, a tile above the diagonal (or past skv) is all masked and, m being
// real by then, adds p = 0 with alpha = 1; with a window its pairs start at the
// even tile at or below the band, a tile that every row of the q tile masks,
// wiped as above.
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
// The user mask (kOptMask; JAX's mask tile, _tile_mask :454-511, in every forward
// and backward tile): a boolean [b|1, hq|1, sq, skv] (uint8 here, nonzero =
// attend; h counts q heads), applied after scale, softcap and the structural
// masks, on every kv tile (the interior shortcut is off, and causal and the window
// skip no tile). A masked score takes the mask value, so a row that the mask leaves
// without a key takes the mean of v over all skv keys with lse = mask + log(skv),
// P6's rule. Each
// thread reads its own scores' bytes by the mask's strides (plain loads, issued
// while the tile's q.k^T runs): broadcast dims are zero-stride views, which a TMA
// map cannot describe, and a decode step's mask is one row. In the forwards it is
// instantiated beside the window and the softcap only; the caller merges segment ids
// into it. Dense KV-cache decode (sq = 1 and a [1|b, 1, 1, L] mask of the written
// slots) runs here: a 128-row q tile with one real row, whose q box TMA fills with
// zeros past sq, and whose stores stop at sq.
// The backwards (K2, both of K5's kernels) take the mask alone at head dim 64 (causal
// is a run-time flag), fp32 and bf16. They recompute p = exp(s - lse) with the
// forward's lse, and on a row that no key sees that lse is the mask value (mask +
// log(skv) rounds to it in fp32), so p is 1 at every key, masked ones and those
// above the diagonal included: such a row gives dv = do at every key and a nonzero
// dq, as the plain path does. So under the mask no q tile is skipped for a kv tile
// (q_tiles, q_band) and no kv tile for a q tile (kv_tiles), every tile is an edge
// tile (edge_of), and the interior exp2 shortcut, whose lse * log2(e) would be -inf
// on such a row, never runs. The bf16 dk/dv kernel's tile is s^T = k q^T: a thread's
// consecutive scores step along q rows there, and it reads its 32 bytes by (row,
// key) while the two products run (mask_bits_t); K5's dq kernel has K1's layout and
// reads them as K1 does (mask_bits_of); the fp32 kernels read each byte beside its
// score (mask_at).
//
// The score bias (kOptBias, every kernel; JAX's bias tile, _fwd_tile :784-785,
// _dq_tile :1013-1023, _dkvq_tile :1134-1147): an fp32 [b|1, hq|1, sq, skv]
// (T5's relative-position bias, ALiBi) read by its own strides like the mask
// (broadcast dims have stride 0), added to the score after scale and softcap
// and before the masks (a masked score takes the mask value, bias or not, so a
// row without a key still takes P6's mean of v). Each thread loads its own
// scores' bias values; no tile of it is staged in shared memory. With the bias
// every tile takes the score-domain softmax (no interior shortcut), but causal
// and the window still skip tiles. The backwards add it to the recomputed
// scores; K2 and K5's dq kernel also write dbias = p (dp - di), the gradient of
// the post-bias score before the cap's factor and the scale, once per element
// of a fp32 [b, hq, sq, skv] (no atomics: each (q row, key) pair of a head is
// owned by one thread of one block, so the bits are the same on every run).
// Pairs of tiles that the band skips are not written: the caller zeroes dbias
// under causal. The caller sums dbias over the bias's broadcast dims. The bias
// is instantiated alone, with segment ids, with the mask (the forwards) at
// every head dim, and with the softcap alone at d 64: K2's bf16 d 64 / 128
// kernel keeps p beside p (1 - t^2) for dbias, 32 more registers a thread,
// which d 128 has not got to spare.
//
// What bounds them on this card. At the bench training shape (b 4, h 8, s 4096,
// d 128, causal) attention is ~0.14 TFLOP forward and ~0.34 TFLOP backward a
// layer against ~0.1 GB of q/k/v/o traffic, and at Gemma-2's (b 1, hq 8, s 8192,
// d 256, causal) ~0.28 TFLOP forward: far above the card's ~295 flops a byte, so
// tensor-core throughput bounds them all, and the design keeps the s and p tiles
// out of device memory entirely (registers and shared memory only).
//
// bf16 layout. K1 and K12 run on warpgroup products (wgmma) fed by TMA through
// a ring of k and v slots (see flash_fwd_bf16 below): a block of three
// warpgroups owns a 128-row q tile, two consume (64 rows each), one produces. The
// dk/dv kernels (K2, K5's second) run on wgmma fed by a cp.async ring (see
// flash_bwd_bf16). K5's dq kernel has K1's shape (see flash_bwd_dq_bf16): three
// warpgroups own a 128-row q tile, q and do stay in shared memory, and k and v
// tiles stream by TMA through a ring; s, dp and dq += ds.k run on wgmma. Its
// work is three products of 2 d a (q, k) pair, 3/5 of K2's, and like K2 it is
// bound by the tensor cores, so the design keeps them fed: both score products
// in flight at once, the next tile's copies under this one's products, and the
// mask work only on edge tiles.
//
// fp32 layout (a plain FMA path; exact comparisons need it). 128 threads; a
// thread owns one row of the tile and the columns and head dims j with
// j % P == its lane's residue, P threads a row. At d 64 and 128 tiles have 64
// rows (P = 2); at d 192 and 256, 32 rows (P = 4), because a 64-row tile of 256 fp32
// would need 263 KB of shared memory in the backward, and dk + dv would be 256
// registers a thread at P = 2 (192 at d 192). Shared-memory rows are padded to an odd pitch so
// that the rows a warp reads at once fall in distinct banks. Loads are
// synchronous 16-byte vectors.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
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
constexpr int kOptMask = 8; // a boolean mask (the forwards; the backwards at d 64 alone)
constexpr int kOptBias = 16; // an additive fp32 score bias (and dbias)

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
  const uint8_t* mask;  // kOptMask: [b|1, hq|1, sq, skv], nonzero = attend, or null
  long long mask_b, mask_h, mask_q, mask_k;        // its element strides (0: broadcast)
  const float* bias;    // kOptBias: [b|1, hq|1, sq, skv] fp32, or null
  long long bias_b, bias_h, bias_q, bias_k;        // its element strides (0: broadcast)
  float* dbias;         // kOptBias, K2 and K5's dq kernel: [b, hq, sq, skv] fp32, or null
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
// with kOptCap capped (cap_grad = 1 - t^2, the cap's derivative); with kOptBias
// plus `bias`; the mask value where bounds, causality, the window, (kOptSeg)
// the segment ids row_ids[ri] != col_ids[ci] or (kOptMask) the user mask
// (`masked`, read by the caller: mask_at, mask_bits_t) mask it. The ids are
// read only with kOptSeg.
template <int kOpt>
__device__ __forceinline__ float score(const Params& p, float raw, int row, int col,
                                       const int* row_ids, int ri, const int* col_ids, int ci,
                                       float& cap_grad, float bias = 0.f, bool masked = false) {
  float x = raw * p.scale;
  if constexpr ((kOpt & kOptCap) != 0) {
    const float t = tanhf(x * p.inv_softcap);
    cap_grad = 1.f - t * t;
    x = p.softcap * t;
  }
  if constexpr ((kOpt & kOptBias) != 0) x += bias;
  bool out = row >= p.sq || col >= p.skv || (p.causal && col > row);
  if constexpr ((kOpt & kOptWin) != 0) out = out || col <= row - p.window;
  if constexpr ((kOpt & kOptSeg) != 0) out = out || row_ids[ri] != col_ids[ci];
  if constexpr ((kOpt & kOptMask) != 0) out = out || masked;
  return out ? kMaskValue : x;
}

// kOptMask: the user mask of head (bb, hh) (its base), read by its strides.
__device__ __forceinline__ const uint8_t* mask_base(const Params& p, int bb, int hh) {
  return p.mask + bb * p.mask_b + hh * p.mask_h;
}

// kOptMask: does the user mask mask (row, col)? Read only for a row < sq and a key
// < skv (the bounds mask the others anyway).
template <int kOpt>
__device__ __forceinline__ bool mask_at(const Params& p, const uint8_t* base, int row, int col) {
  if constexpr ((kOpt & kOptMask) != 0)
    return row < p.sq && col < p.skv && __ldg(base + row * p.mask_q + col * p.mask_k) == 0;
  return false;
}

// kOptBias: the bias of head (bb, hh) (its base) at (row, col), read by its
// strides; 0 past sq or skv, where the bounds mask the score anyway.
__device__ __forceinline__ const float* bias_base(const Params& p, int bb, int hh) {
  return p.bias + bb * p.bias_b + hh * p.bias_h;
}

template <int kOpt>
__device__ __forceinline__ float bias_at(const Params& p, const float* base, int row, int col) {
  if constexpr ((kOpt & kOptBias) != 0)
    return row < p.sq && col < p.skv ? __ldg(base + row * p.bias_q + col * p.bias_k) : 0.f;
  return 0.f;
}

// kOptBias: dbias of head (bb, hh) (its base, or null: not asked for) at (row,
// col) = ds_raw, stored once; rows past sq and keys past skv are not stored.
__device__ __forceinline__ float* dbias_base(const Params& p, int bb, int hh) {
  return p.dbias == nullptr
             ? nullptr
             : p.dbias + (static_cast<long long>(bb) * p.hq + hh) * p.sq * p.skv;
}

template <int kOpt>
__device__ __forceinline__ void store_dbias(const Params& p, float* base, int row, int col,
                                            float ds_raw) {
  if constexpr ((kOpt & kOptBias) != 0)
    if (base != nullptr && row < p.sq && col < p.skv)
      base[static_cast<long long>(row) * p.skv + col] = ds_raw;
}

// The kv tiles [x, y) of KV rows that q rows [q0, q0 + QT) see: all of them, or with
// causal up to the diagonal, and with a window from the tile of key q0 - W + 1. With the
// user mask all of them: a row that the mask leaves without a key averages v over all
// skv keys (P6), so no tile may be skipped.
template <int QT, int KV, int kOpt>
__device__ __forceinline__ int2 kv_tiles(const Params& p, int q0) {
  const int n = (p.skv + KV - 1) / KV;
  if (!p.causal || (kOpt & kOptMask) != 0) return make_int2(0, n);
  const int first = (kOpt & kOptWin) != 0 ? max(0, q0 - p.window + 1) / KV : 0;
  return make_int2(first, min(n, (q0 + QT - 1) / KV + 1));
}

// The q tiles [x, y) of T rows whose rows see keys [kv0, kv0 + T): with causal
// from the diagonal, and with a window up to the tile of row kv0 + T - 1 + W - 1.
// With the user mask all of them: a row that the mask leaves without a key has p = 1
// at every key, those above the diagonal included.
template <int T, int kOpt>
__device__ __forceinline__ int2 q_tiles(const Params& p, int kv0) {
  const int n = (p.sq + T - 1) / T;
  if (!p.causal || (kOpt & kOptMask) != 0) return make_int2(0, n);
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

// ---- bf16 helpers -------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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
// d 192 (MLA's qk head dim): d 256's layout over three 64-wide column blocks, which do
//   not halve: warpgroup 0 owns dk and dv of blocks 0 and 1 (m64n128), warpgroup 1 of
//   block 2 (m64n64), and K2's dq the other way round (warpgroup 0 block 0, warpgroup 1
//   blocks 1 and 2), so that each warpgroup's products of a tile pair span 192 dims in
//   K2. A split at 96 would start a product inside a swizzled column block, which a
//   wgmma operand cannot. d 128's layout (each warpgroup its own 64 rows, all 192
//   dims) would hold dk and dv in 192 registers a thread, beside s and dp.
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
  // Exchange: ds^T [kKv][kXPitch] bf16 (d 64/128), or at d 192 / 256 dp^T [64][kXPitch]
  // fp32, then p^T and ds^T [64][kXPitch] bf16 in the same bytes.
  static constexpr int kXBytes = 128 * kXPitch * 2;
  static constexpr int kBytes =
      2 * kKvBytes + kStages * kStageBytes + kXBytes + kKv * 4 + 1024;
};

// The q tiles [x, y) of kTile rows whose rows see keys [kv0, kv0 + KV): with causal
// from the diagonal, and with a window up to the tile of row kv0 + KV - 1 + W - 1;
// with the user mask all of them (see q_tiles).
template <int KV, int kOpt>
__device__ __forceinline__ int2 q_band(const Params& p, int kv0) {
  const int n = (p.sq + kTile - 1) / kTile;
  if (!p.causal || (kOpt & kOptMask) != 0) return make_int2(0, n);
  const int end = (kOpt & kOptWin) != 0 ? min(n, (kv0 + KV + p.window - 2) / kTile + 1) : n;
  return make_int2(kv0 / kTile, end);
}

// kOptMask, the bf16 dk/dv kernel at d 64 / 128: the user mask of this thread's 32
// scores of s^T (an m64n64 accumulator: kv rows kv0 + kr + g (+ 8), q rows q0 + 8 j +
// 2 t (+ 1)) as bits, bit i for s[i], read while the tile's products run.
template <int kOpt>
__device__ __forceinline__ uint32_t mask_bits_t(const Params& p, const uint8_t* mbase, int q0,
                                                int kv0, int kr, int g, int t) {
  uint32_t bits = 0;
  if constexpr ((kOpt & kOptMask) != 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kl = kr + g + 8 * ((i >> 1) & 1), ql = 8 * (i >> 2) + 2 * t + (i & 1);
      if (mask_at<kOpt>(p, mbase, q0 + ql, kv0 + kl)) bits |= 1u << i;
    }
  }
  return bits;
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

// The first 32 floats of an accumulator, as the accumulator of an m64n64 product (d
// 192's warpgroup 1 keeps dk and dv of one column block in the first half of arrays
// sized for two).
template <int R>
__device__ __forceinline__ float (&first64(float (&x)[R]))[32] {
  static_assert(R >= 32, "an m64n64 accumulator is 32 floats a thread");
  return *reinterpret_cast<float(*)[32]>(&x[0]);
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
  // Head dims of warpgroup 0's dk and dv (their registers' width): all of them at d 64 /
  // 128, half at d 256, two column blocks at d 192 (warpgroup 1 uses the first 64).
  constexpr int DW = D == 192 ? 128 : kSplitD ? D / 2 : D;
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
    bf16* pt_x = xb;                                  // d 192 / 256: p^T [64][XP]
    bf16* dst_x = kSplitD ? xb + kTile * XP : xb;     // ds^T [KV][XP]
    float s[32], dp[32];
    uint32_t ap[4][4], ads[4][4];  // p^T and ds^T as the register A of dv and dk
    // kOptBias: head hh's bias, and its dbias (K2 only: K5's dq kernel writes it).
    const float* bbase = nullptr;
    float* dbase = nullptr;
    if constexpr ((kOpt & kOptBias) != 0) {
      bbase = bias_base(p, bb, hh);
      if constexpr (kDq) dbase = dbias_base(p, bb, hh);
    }
    // With the bias and the cap, p^T alone for dbias (s keeps p^T (1 - t^2)).
    constexpr bool kKeepP = (kOpt & kOptBias) != 0 && (kOpt & kOptCap) != 0 && kDq;
    float pk[32];
    // kOptMask: head hh's user mask.
    const uint8_t* mbase = nullptr;
    if constexpr ((kOpt & kOptMask) != 0) mbase = mask_base(p, bb, hh);
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
      const uint32_t mbits = mask_bits_t<kOpt>(p, mbase, q0, kv0, kr, g, t);
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
          const float x = score<kOpt>(p, s[i + e], q0 + ql, kv0 + kl, seg_q, ql, seg_kv, kl,
                                      cap_grad, bias_at<kOpt>(p, bbase, q0 + ql, kv0 + kl),
                                      ((mbits >> (i + e)) & 1u) != 0);
          pe[e] = expf(x - lse_s[ql]);
          if constexpr (kKeepP) pk[i + e] = pe[e];
          s[i + e] = (kOpt & kOptCap) != 0 ? pe[e] * cap_grad : pe[e];
        }
        ap[i / 8][(i % 8) / 2] = wg::pack_bf16(pe[0], pe[1]);
      }
      wg::fence();
      rs_stage(dv, ap, do_s, 0);
      wg::commit();
      wg::wait<1>();  // dp^T has landed (dv may still be in flight)
      wg::fence_acc(dp);
      // ds^T = p^T (dp^T - di) (* 1 - t^2) * scale; K2 with the bias stores
      // dbias = p^T (dp^T - di) on the way.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int ql = 8 * (i >> 2) + 2 * t + (i & 1);
        if constexpr ((kOpt & kOptBias) != 0 && kDq) {
          const int kl = kr + g + 8 * ((i >> 1) & 1);
          const float diff = dp[i] - di_s[ql];
          float pe = s[i];
          if constexpr (kKeepP) pe = pk[i];
          store_dbias<kOpt>(p, dbase, q0 + ql, kv0 + kl, pe * diff);
          dp[i] = s[i] * diff * p.scale;
        } else {
          dp[i] = s[i] * (dp[i] - di_s[ql]) * p.scale;
        }
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
      // d 192 / 256: s^T by warpgroup 0, dp^T by warpgroup 1, once each (D / 16 k steps).
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
            const float x = score<kOpt>(p, s[i], q0 + ql, kv0 + kl, seg_q, ql, seg_kv, kl,
                                        cap_grad, bias_at<kOpt>(p, bbase, q0 + ql, kv0 + kl),
                                        mask_at<kOpt>(p, mbase, q0 + ql, kv0 + kl));
            const float pe = expf(x - lse_s[ql]);
            float d = pe * (dp[i] - di_s[ql]);
            if constexpr (kDq) store_dbias<kOpt>(p, dbase, q0 + ql, kv0 + kl, d);
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
      // dv += p^T do, dk += ds^T q over this warpgroup's head dims.
      wg::fence();
      if constexpr (D == 192) {
        if (w == 1) {
          rs_stage(first64(dv), ap, do_s, 2);
          rs_stage(first64(dk), ads, q_s, 2);
        } else {
          rs_stage(dv, ap, do_s, 0);
          rs_stage(dk, ads, q_s, 0);
        }
      } else {
        rs_stage(dv, ap, do_s, d0 / 64);
        rs_stage(dk, ads, q_s, d0 / 64);
      }
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
      if constexpr (D == 192) {  // warpgroup 0 block 0, warpgroup 1 blocks 1 and 2
#pragma unroll
        for (int pass = 0; pass < 1 + w; ++pass)
          dq_pass<D, NQ, KV>(p, dst_x, k_s, w * 64 + pass * NQ, dq_rows, q0, rw, g, t);
      } else {
#pragma unroll
        for (int pass = 0; pass < D / 2 / NQ; ++pass)
          dq_pass<D, NQ, KV>(p, dst_x, k_s, w * (D / 2) + pass * NQ, dq_rows, q0, rw, g, t);
      }
    }
  }
  wg::cp_async_wait<0>();

  // dk, dv of this warpgroup's rows and head dims, rounded once, [b, skv, hkv, d].
  const int dims = D == 192 && w == 1 ? 64 : DW;  // this warpgroup's
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
      if (8 * j >= dims) break;
      *reinterpret_cast<uint32_t*>(dkd + 8 * j) =
          wg::pack_bf16(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvd + 8 * j) =
          wg::pack_bf16(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// ---- K1 (kHalves 1) and K12 (kHalves 2), bf16: warpgroup products -------------
// Grid (q tiles of 128 rows, b * hq), the tiles of the last rows (the most keys under
// causal masking) first. 384 threads: warpgroups 0 and 1 consume, each owning 64 q
// rows of the tile; two threads of warpgroup 2 produce, one for q and k, one for v.
// They load the q tile once and stream the band's kv tiles of FwdSmem<D>::kKv rows
// by TMA through a ring of two k slots and two v slots, each with its own full/empty
// mbarrier, so a k slot is refilled as soon as both warpgroups' q.k^T products have
// read it and a v slot once their p.v products have, neither waiting for the other
// (one thread for both held K12's next k tiles behind this pair's p.v): the next
// tiles' copies are in flight while the tensor cores work on this one. Every tile sits in shared memory in the 128-byte
// swizzle (wgmma.cuh): q and k are the K-major operands of s = q.k^T (wgmma_ss,
// m64 x kKv), v the MN-major operand of o += p.v (wgmma_rs: p is s's accumulator,
// rounded to bf16 in registers by pack_a).
// K1 issues a tile's q.k^T, runs its softmax when it lands, and issues its p.v,
// which runs on while the next tile's q.k^T is issued; the two warpgroups fill each
// other's softmax gaps on the tensor cores. K12 takes its pairs of tiles with both
// q.k^T products issued before either softmax, and the second tile's softmax runs
// while the first tile's p.v is in flight; it applies K1's update to the same tiles in
// the same order, so its o and lse are K1's bit for bit.
// The mask is evaluated only on the tiles a warpgroup's 64 rows need it on: those
// crossing the diagonal, at the window's lower edge, past skv, or every tile with
// segment ids. On the others (interior tiles) the row max is taken on the raw
// products and p = 2^(raw * scale log2(e) - m log2(e)), one FFMA and one ex2 an
// element; m stays in the score domain and the log2(e) factor is applied only to a
// difference or to a real m, because the mask value times log2(e) is -inf.
template <int D>
struct FwdSmem {
  static constexpr int kQ = 128;                  // q rows of a block
  static constexpr int kKv = D > 128 ? 64 : 128;  // kv rows of a tile
  static constexpr int kQBytes = kQ * D * 2;      // D / 64 column blocks of [128][64]
  static constexpr int kKvBytes = kKv * D * 2;    // a k (or v) slot
  // q, two k slots, two v slots, the mbarriers (q; k full, empty; v full, empty).
  static constexpr int kBarOff = kQBytes + 4 * kKvBytes;
  static constexpr int kBytes = kBarOff + 128 + 1024;  // + the 1024-byte alignment
};

// Rows of o parts: o is NO accumulators of ON floats (m64 x 2 ON each): one m64nD at d
// 64 / 128, two m64n128 at d 256, three m64n64 at d 192 (one a column block).
template <int D>
struct FwdAcc {
  static constexpr int kNO = D == 192 ? 3 : D > 128 ? 2 : 1;
  static constexpr int kON = D == 192 ? 32 : D > 128 ? 64 : D / 2;
};

// One tile's softmax for this thread's two rows (row0, row0 + 8): s (a m64 x N
// accumulator of raw products, N = 2 * R) becomes p, rounded to bf16 into the register
// A operands pa; m and l are updated and alpha (the factor of o) returned. `edge`:
// the tile needs the mask (uniform across the warpgroup). kv_ids (kOptSeg): the
// segment ids of this thread's columns col0 + 8 j + e, at 2 j + e (see kv_ids_of).
// mbits (kOptMask): bit i set where the user mask masks s[i] (see mask_bits_of).
// bbase (kOptBias): this head's bias (see bias_base), added after the cap on every
// tile, which then takes the score-domain branch.

template <int R, int kOpt>
__device__ __forceinline__ void fwd_softmax(const Params& p, float (&s)[R],
                                            uint32_t (&pa)[R / 8][4], float (&m)[2],
                                            float (&l)[2], float (&alpha)[2], bool edge,
                                            int row0, int col0, const int (&q_ids)[2],
                                            const int (&kv_ids)[R / 2], uint64_t mbits,
                                            const float* bbase) {
  constexpr float kLog2e = 1.4426950408889634f;
  float mx[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f};
  if (edge || (kOpt & (kOptCap | kOptBias)) != 0 || !(p.scale > 0.f)) {
    // Scores in the score domain: scaled, capped, biased, masked.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1), col = col0 + 8 * (i >> 2) + (i & 1);
      float x = s[i] * p.scale;
      if constexpr ((kOpt & kOptCap) != 0) x = p.softcap * tanhf(x * p.inv_softcap);
      if constexpr ((kOpt & kOptBias) != 0) x += bias_at<kOpt>(p, bbase, row, col);
      if (edge) {
        // A key column past skv takes -inf: it leaves the max alone (m starts at
        // the finite mask value and never falls) and adds p = 2^-inf = 0.
        const bool pad = col >= p.skv;
        bool out = p.causal && col > row;
        if constexpr ((kOpt & kOptWin) != 0) out = out || col <= row - p.window;
        if constexpr ((kOpt & kOptSeg) != 0)
          out = out || q_ids[(i >> 1) & 1] != kv_ids[2 * (i >> 2) + (i & 1)];
        // The user mask after the structural ones, as JAX's _tile_mask (:499-506).
        if constexpr ((kOpt & kOptMask) != 0) out = out || ((mbits >> i) & 1u) != 0;
        x = pad ? __int_as_float(0xff800000u) : out ? kMaskValue : x;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      alpha[h] = wg::exp2_approx((m[h] - mx[h]) * kLog2e);
      m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      s[i] = wg::exp2_approx((s[i] - m[(i >> 1) & 1]) * kLog2e);
      rs[(i >> 1) & 1] += s[i];
    }
  } else {
    // Interior: every score is real, so the new m is real.
    const float lowest = __int_as_float(0xff800000u);  // -inf
    float raw[2] = {lowest, lowest};
#pragma unroll
    for (int i = 0; i < R; ++i) raw[(i >> 1) & 1] = fmaxf(raw[(i >> 1) & 1], s[i]);
    const float c = p.scale * kLog2e;
    float mb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      raw[h] = fmaxf(raw[h], __shfl_xor_sync(kFull, raw[h], 1));
      raw[h] = fmaxf(raw[h], __shfl_xor_sync(kFull, raw[h], 2));
      mx[h] = fmaxf(m[h], raw[h] * p.scale);
      alpha[h] = wg::exp2_approx((m[h] - mx[h]) * kLog2e);
      m[h] = mx[h];
      mb[h] = mx[h] * kLog2e;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      s[i] = wg::exp2_approx(fmaf(s[i], c, -mb[(i >> 1) & 1]));
      rs[(i >> 1) & 1] += s[i];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(kFull, rs[h], 1);
    rs[h] += __shfl_xor_sync(kFull, rs[h], 2);
    l[h] = alpha[h] * l[h] + rs[h];
  }
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) wg::pack_a(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
}

// The segment ids of this thread's columns of tile kv0 (col0 = kv0 + 2 t), loaded
// while the tile's q.k^T runs: R / 2 loads, issued before the wait.
template <int R, int kOpt>
__device__ __forceinline__ void kv_ids_of(int (&kv_ids)[R / 2], const Params& p,
                                          const int* kv_seg, int col0) {
  if constexpr ((kOpt & kOptSeg) != 0) {
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int col = col0 + 8 * (i >> 1) + (i & 1);
      kv_ids[i] = col < p.skv ? __ldg(kv_seg + col * p.seg_kv_s) : 0;
    }
  }
}

// The user mask of this thread's scores of tile kv0 (col0 = kv0 + 2 t) as bits, bit i
// for s[i]: R byte loads by their own strides (broadcast dims have stride 0, which a
// TMA map cannot describe), issued while the tile's q.k^T runs. Rows past sq and
// columns past skv are not read (their bits stay 0: bounds mask them anyway).
template <int R, int kOpt>
__device__ __forceinline__ uint64_t mask_bits_of(const Params& p, const uint8_t* mbase,
                                                 int row0, int col0) {
  uint64_t bits = 0;
  if constexpr ((kOpt & kOptMask) != 0) {
    static_assert(R <= 64, "one bit a score");
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1), col = col0 + 8 * (i >> 2) + (i & 1);
      if (row < p.sq && col < p.skv && __ldg(mbase + row * p.mask_q + col * p.mask_k) == 0)
        bits |= uint64_t(1) << i;
    }
  }
  return bits;
}

template <int D>
__device__ __forceinline__ void scale_o(float (&o)[FwdAcc<D>::kNO][FwdAcc<D>::kON],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < FwdAcc<D>::kNO; ++c)
#pragma unroll
    for (int i = 0; i < FwdAcc<D>::kON; ++i) o[c][i] *= alpha[(i >> 1) & 1];
}

template <int D>
__device__ __forceinline__ void fence_o(float (&o)[FwdAcc<D>::kNO][FwdAcc<D>::kON]) {
#pragma unroll
  for (int c = 0; c < FwdAcc<D>::kNO; ++c) wg::fence_acc(o[c]);
}

// s = q.k^T for this warpgroup's 64 rows: q_s its rows' start in a 128-row q (or do)
// tile, k_s a k (or v) slot of 2 R rows (D / 16 k steps, both operands K-major).
template <int D, int R>
__device__ __forceinline__ void fwd_qk(float (&s)[R], uint32_t q_s, uint32_t k_s) {
  constexpr int KV = 2 * R;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    wg::wgmma_ss<0, 0>(s, wg::desc(q_s + (kd / 4) * (128 * 128) + (kd % 4) * 32, 16, 1024),
                       wg::desc(k_s + (kd / 4) * (KV * 128) + (kd % 4) * 32, 16, 1024),
                       kd > 0);
}

// o += p.v over the tile's KV keys: v_s a v slot, read MN-major (also K5's dq += ds.k
// with k's slot).
template <int D, int KV = FwdSmem<D>::kKv>
__device__ __forceinline__ void fwd_pv(float (&o)[FwdAcc<D>::kNO][FwdAcc<D>::kON],
                                       const uint32_t (&pa)[KV / 16][4], uint32_t v_s) {
  constexpr int NW = 2 * FwdAcc<D>::kON;  // head dims a part
#pragma unroll
  for (int kk = 0; kk < KV / 16; ++kk)
#pragma unroll
    for (int c = 0; c < FwdAcc<D>::kNO; ++c)
      wg::wgmma_rs<1>(o[c], pa[kk],
                      wg::desc(v_s + (c * NW / 64) * (KV * 128) + kk * 2048, KV * 128, 1024), 1);
}

template <int D, int kHalves, int kOpt>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const Params p) {
  static_assert(kHalves == 1 || (kOpt & (kOptSeg | kOptCap | kOptMask | kOptBias)) == 0,
                "K12 takes no segment ids, softcap, mask or bias");
  using S = FwdSmem<D>;
  using A = FwdAcc<D>;
  constexpr int KV = S::kKv, R = KV / 2, QT = S::kQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* ks = qs + S::kQBytes;      // two slots
  uint8_t* vs = ks + 2 * S::kKvBytes;  // two slots
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = q_full + 3;
  uint64_t* v_full = q_full + 5;
  uint64_t* v_empty = q_full + 7;

  const int n_q = (p.sq + QT - 1) / QT;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * QT;  // long rows first
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  int2 band = kv_tiles<QT, KV, kOpt>(p, q0);
  if (kHalves == 2) band.x &= ~1;  // pairs from the even tile at or below the band
  int n = max(0, band.y - band.x);
  // A pair's second tile past the band is all masked: a no-op on every row with a key.
  // (Taking the last pair's first tile alone instead made ptxas serialize K12's
  // products, C7514, and K12 1.2x slower at d 256.)
  if (kHalves == 2) n = (n + 1) & ~1;

  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int i = 0; i < 2; ++i) {
      wg::mbar_init(&k_full[i], 1);
      wg::mbar_init(&k_empty[i], 2);
      wg::mbar_init(&v_full[i], 1);
      wg::mbar_init(&v_empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w = threadIdx.x / 128;
  if (w == 2) {  // the producers: lane 0 of warp 8 loads q and k, of warp 9 v
    wg::setmaxnreg_dec<24>();
    const bool is_k = threadIdx.x == 256;
    if (!is_k && threadIdx.x != 288) return;
    uint8_t* slots = is_k ? ks : vs;
    const void* map = is_k ? static_cast<const void*>(&mk) : static_cast<const void*>(&mv);
    uint64_t* full = is_k ? k_full : v_full;
    uint64_t* empty = is_k ? k_empty : v_empty;
    if (is_k) {
      wg::mbar_expect_tx(q_full, S::kQBytes);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        wg::tma_load_4d(qs + cb * QT * 128, &mq, q_full, cb * 64, q0, hh, bb);
    }
    for (int i = 0; i < n; ++i) {
      const int slot = i & 1, kv0 = (band.x + i) * KV;
      // The slot's previous round is read by both warpgroups.
      if (i >= 2) wg::mbar_wait(&empty[slot], ((i >> 1) - 1) & 1);
      wg::mbar_expect_tx(&full[slot], S::kKvBytes);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        wg::tma_load_4d(slots + slot * S::kKvBytes + cb * KV * 128, map, &full[slot], cb * 64,
                        kv0, hk, bb);
    }
    return;
  }

  wg::setmaxnreg_inc<240>();
  const int tw = threadIdx.x % 128, wi = tw / 32, lane = tw % 32, g = lane / 4, t = lane % 4;
  const bool leader = tw == 0;
  const int r0 = q0 + 64 * w;             // this warpgroup's first row
  const int row0 = r0 + 16 * wi + g;      // this thread's rows: row0, row0 + 8
  int q_ids[2] = {0, 0};
  const int* kv_seg = nullptr;
  if constexpr ((kOpt & kOptSeg) != 0) {
    const int* q_seg = p.q_seg + bb * p.seg_q_b;
    for (int h = 0; h < 2; ++h)
      q_ids[h] = row0 + 8 * h < p.sq ? __ldg(q_seg + (row0 + 8 * h) * p.seg_q_s) : 0;
    kv_seg = p.kv_seg + bb * p.seg_kv_b;
  }
  const uint8_t* mbase = nullptr;
  if constexpr ((kOpt & kOptMask) != 0) mbase = p.mask + bb * p.mask_b + hh * p.mask_h;
  const float* bbase = nullptr;
  if constexpr ((kOpt & kOptBias) != 0) bbase = bias_base(p, bb, hh);
  // Does tile kv0 need the mask for any of this warpgroup's rows? With the user mask
  // every visited tile does.
  auto edge_of = [&](int kv0) {
    if constexpr ((kOpt & (kOptSeg | kOptMask)) != 0) return true;
    bool e = kv0 + KV > p.skv || (p.causal && kv0 + KV - 1 > r0);
    if constexpr ((kOpt & kOptWin) != 0) e = e || kv0 <= r0 + 63 - p.window;
    return e;
  };

  float o[A::kNO][A::kON];
#pragma unroll
  for (int c = 0; c < A::kNO; ++c)
#pragma unroll
    for (int i = 0; i < A::kON; ++i) o[c][i] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  uint32_t pa[KV / 16][4];
  const uint32_t q_s = wg::smem_u32(qs) + w * 8192;  // this warpgroup's rows
  const uint32_t k_s = wg::smem_u32(ks), v_s = wg::smem_u32(vs);
  wg::mbar_wait(q_full, 0);

  if constexpr (kHalves == 1) {
    for (int i = 0; i < n; ++i) {
      const int slot = i & 1, kv0 = (band.x + i) * KV;
      const uint32_t parity = (i >> 1) & 1;
      float s[R];
      wg::mbar_wait(&k_full[slot], parity);
      wg::fence();
      fwd_qk<D>(s, q_s, k_s + slot * S::kKvBytes);
      wg::commit();
      int kv_ids[R / 2];
      kv_ids_of<R, kOpt>(kv_ids, p, kv_seg, kv0 + 2 * t);
      const uint64_t mbits = mask_bits_of<R, kOpt>(p, mbase, row0, kv0 + 2 * t);
      wg::wait<0>();  // s has landed, and the previous tile's p.v is done
      wg::fence_acc(s);
      fence_o<D>(o);
      fence_a(pa);
      if (leader) {
        wg::mbar_arrive(&k_empty[slot]);
        if (i > 0) wg::mbar_arrive(&v_empty[slot ^ 1]);
      }
      float alpha[2];
      fwd_softmax<R, kOpt>(p, s, pa, m, l, alpha, edge_of(kv0), row0, kv0 + 2 * t, q_ids,
                           kv_ids, mbits, bbase);
      scale_o<D>(o, alpha);
      wg::mbar_wait(&v_full[slot], parity);
      wg::fence();
      fwd_pv<D>(o, pa, v_s + slot * S::kKvBytes);
      wg::commit();
    }
  } else {
    uint32_t pb[KV / 16][4];
    int kv_ids[R / 2];  // K12 takes no segment ids
    for (int i = 0; i < n; i += 2) {  // tile i in slot 0, tile i + 1 in slot 1
      const int kv0 = (band.x + i) * KV;
      const uint32_t parity = (i >> 1) & 1;
      float sa[R], sb[R], alpha[2];
      wg::mbar_wait(&k_full[0], parity);
      wg::fence();
      fwd_qk<D>(sa, q_s, k_s);
      wg::commit();
      wg::mbar_wait(&k_full[1], parity);
      fwd_qk<D>(sb, q_s, k_s + S::kKvBytes);
      wg::commit();
      wg::wait<1>();  // sa has landed (sb may be in flight)
      wg::fence_acc(sa);
      if (leader) wg::mbar_arrive(&k_empty[0]);
      fwd_softmax<R, kOpt>(p, sa, pa, m, l, alpha, edge_of(kv0), row0, kv0 + 2 * t, q_ids,
                           kv_ids, 0, nullptr);
      scale_o<D>(o, alpha);
      wg::mbar_wait(&v_full[0], parity);
      wg::fence();
      fwd_pv<D>(o, pa, v_s);
      wg::commit();
      wg::wait<1>();  // sb has landed (the first tile's p.v may be in flight)
      wg::fence_acc(sb);
      if (leader) wg::mbar_arrive(&k_empty[1]);
      fwd_softmax<R, kOpt>(p, sb, pb, m, l, alpha, edge_of(kv0 + KV), row0, kv0 + KV + 2 * t,
                           q_ids, kv_ids, 0, nullptr);
      wg::wait<0>();  // the first tile's p.v is done
      fence_o<D>(o);
      fence_a(pa);
      if (leader) wg::mbar_arrive(&v_empty[0]);
      scale_o<D>(o, alpha);
      wg::mbar_wait(&v_full[1], parity);
      wg::fence();
      fwd_pv<D>(o, pb, v_s + S::kKvBytes);
      wg::commit();
      wg::wait<0>();
      fence_o<D>(o);
      fence_a(pb);
      if (leader) wg::mbar_arrive(&v_empty[1]);
    }
  }
  wg::wait<0>();
  fence_o<D>(o);
  fence_a(pa);

  // Epilogue: o / l rounded once into this warpgroup's rows of the q tile (its last
  // reads of them are done), then 16-byte rows into [b, sq, hq, d]; lse = m + log(l).
  float l_inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) l_inv[h] = l[h] == 0.f ? 1.f : 1.f / l[h];
  uint8_t* stage = qs + w * 8192;
  constexpr int NW = 2 * A::kON;
#pragma unroll
  for (int c = 0; c < A::kNO; ++c)
#pragma unroll
    for (int i = 0; i < A::kON; i += 2) {
      const int r = 16 * wi + g + 8 * ((i >> 1) & 1), col = c * NW + 8 * (i >> 2) + 2 * t;
      *reinterpret_cast<uint32_t*>(stage + (col / 64) * (QT * 128) + wg::sw128_offset(r, col % 64)) =
          wg::pack_bf16(o[c][i] * l_inv[(i >> 1) & 1], o[c][i + 1] * l_inv[(i >> 1) & 1]);
    }
  if (p.lse != nullptr && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row0 + 8 * h < p.sq)
        p.lse[(static_cast<long long>(bb) * p.hq + hh) * p.sq + row0 + 8 * h] =
            m[h] + logf(l[h] == 0.f ? 1.f : l[h]);
  }
  wg::bar_sync(1 + w, 128);
  bf16* out = static_cast<bf16*>(p.o);
  for (int idx = tw; idx < 64 * (D / 8); idx += 128) {
    const int r = idx / (D / 8), col = (idx % (D / 8)) * 8, row = r0 + r;
    if (row < p.sq)
      *reinterpret_cast<uint4*>(out + ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D +
                                col) =
          *reinterpret_cast<const uint4*>(stage + (col / 64) * (QT * 128) +
                                          wg::sw128_offset(r, col % 64));
  }
}

// ---- K5's dq kernel, bf16: warpgroup products ----------------------------------
// Grid (q tiles of 128 rows, b * hq), the tiles of the last rows (the most keys under
// causal masking) first. 384 threads, K1's shape: warpgroups 0 and 1 consume, each
// owning 64 q rows and their dq; two threads of warpgroup 2 produce, one for q, do
// and k, one for v. q and do are loaded once by TMA and stay in shared memory; the
// band's kv tiles of DqSmem<D>::kKv keys stream through a ring of two k slots and two
// v slots with full/empty mbarriers, so the next tile's copies are in flight while the
// tensor cores work on this one. Per kv tile a warpgroup issues s = q.k^T and dp =
// do.v^T (wgmma, both operands K-major in shared memory, both in flight before either
// is waited on), forms p = exp(s - lse) once s lands (the mask only on edge tiles, as
// in K1), ds = p (dp - di) scale (* 1 - t^2 with the cap) once dp lands, and issues
// dq += ds.k with ds re-packed in registers as the A operand and k read MN-major from
// the same slot (K1's p.v with k in v's place). dq stays in fp32 registers and is
// written once, rounded to q's dtype, through the q tile's rows: no atomics, so the
// same bits on every run. Kv tiles of 64 keys at d 64 / 128 (s, dp 32 registers a
// thread, dq 64 at d 128, 96 at d 192, whose block takes 192 KB of shared memory) and
// 32 at d 256 (s, dp 16 each beside dq's 128).
template <int D>
struct DqSmem {
  static constexpr int kQ = 128;                  // q rows of a block
  static constexpr int kKv = D > 192 ? 32 : 64;   // kv rows of a tile
  static constexpr int kQBytes = kQ * D * 2;      // a q (or do) tile
  static constexpr int kKvBytes = kKv * D * 2;    // a k (or v) slot
  // q, do, two k slots, two v slots, the mbarriers (q; k full, empty; v full, empty).
  static constexpr int kBarOff = 2 * kQBytes + 4 * kKvBytes;
  static constexpr int kBytes = kBarOff + 128 + 1024;  // + the 1024-byte alignment
};

// p = exp(s - lse) of this thread's two rows (row0, row0 + 8) over one kv tile, in
// place, times the cap's derivative 1 - t^2 with kOptCap; the mask on edge tiles only.
// lse2: lse * log2(e), used on interior tiles only (there lse is real). kOptBias: the
// bias (bbase, see bias_base) added after the cap on every tile, and s keeps p alone,
// the cap's derivative going to cg (dbias is p (dp - di), before it). mbits
// (kOptMask): bit i set where the user mask masks s[i] (see mask_bits_of); with the
// mask every tile is an edge tile.
template <int R, int kOpt>
__device__ __forceinline__ void dq_probs(const Params& p, float (&s)[R], float (&cg)[R],
                                         bool edge, int row0, int col0,
                                         const float (&lse)[2], const float (&lse2)[2],
                                         const int (&q_ids)[2], const int (&kv_ids)[R / 2],
                                         const float* bbase, uint64_t mbits) {
  constexpr float kLog2e = 1.4426950408889634f;
  if (edge || (kOpt & (kOptCap | kOptBias)) != 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int h = (i >> 1) & 1, row = row0 + 8 * h, col = col0 + 8 * (i >> 2) + (i & 1);
      float x = s[i] * p.scale, cap_grad = 1.f;
      if constexpr ((kOpt & kOptCap) != 0) {
        const float t = tanhf(x * p.inv_softcap);
        cap_grad = 1.f - t * t;
        x = p.softcap * t;
      }
      if constexpr ((kOpt & kOptBias) != 0) {
        x += bias_at<kOpt>(p, bbase, row, col);
        cg[i] = cap_grad;
        cap_grad = 1.f;
      }
      if (edge) {
        bool out = row >= p.sq || col >= p.skv || (p.causal && col > row);
        if constexpr ((kOpt & kOptWin) != 0) out = out || col <= row - p.window;
        if constexpr ((kOpt & kOptSeg) != 0)
          out = out || q_ids[h] != kv_ids[2 * (i >> 2) + (i & 1)];
        if constexpr ((kOpt & kOptMask) != 0) out = out || ((mbits >> i) & 1u) != 0;
        x = out ? kMaskValue : x;
      }
      s[i] = wg::exp2_approx((x - lse[h]) * kLog2e) * cap_grad;
    }
  } else {
    const float c = p.scale * kLog2e;
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = wg::exp2_approx(fmaf(s[i], c, -lse2[(i >> 1) & 1]));
  }
}

template <int D, int kOpt>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                      const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                      const Params p) {
  using S = DqSmem<D>;
  using A = FwdAcc<D>;
  constexpr int KV = S::kKv, R = KV / 2, QT = S::kQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* dos = qs + S::kQBytes;
  uint8_t* ks = dos + S::kQBytes;      // two slots
  uint8_t* vs = ks + 2 * S::kKvBytes;  // two slots
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = q_full + 3;
  uint64_t* v_full = q_full + 5;
  uint64_t* v_empty = q_full + 7;

  const int n_q = (p.sq + QT - 1) / QT;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * QT;  // long rows first
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int2 band = kv_tiles<QT, KV, kOpt>(p, q0);
  const int n = max(0, band.y - band.x);

  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int i = 0; i < 2; ++i) {
      wg::mbar_init(&k_full[i], 1);
      wg::mbar_init(&k_empty[i], 2);
      wg::mbar_init(&v_full[i], 1);
      wg::mbar_init(&v_empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w = threadIdx.x / 128;
  if (w == 2) {  // the producers: lane 0 of warp 8 loads q, do and k, of warp 9 v
    wg::setmaxnreg_dec<24>();
    const bool is_k = threadIdx.x == 256;
    if (!is_k && threadIdx.x != 288) return;
    uint8_t* slots = is_k ? ks : vs;
    const void* map = is_k ? static_cast<const void*>(&mk) : static_cast<const void*>(&mv);
    uint64_t* full = is_k ? k_full : v_full;
    uint64_t* empty = is_k ? k_empty : v_empty;
    if (is_k) {
      wg::mbar_expect_tx(q_full, 2 * S::kQBytes);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        wg::tma_load_4d(qs + cb * QT * 128, &mq, q_full, cb * 64, q0, hh, bb);
        wg::tma_load_4d(dos + cb * QT * 128, &mdo, q_full, cb * 64, q0, hh, bb);
      }
    }
    for (int i = 0; i < n; ++i) {
      const int slot = i & 1, kv0 = (band.x + i) * KV;
      // The slot's previous round is read by both warpgroups.
      if (i >= 2) wg::mbar_wait(&empty[slot], ((i >> 1) - 1) & 1);
      wg::mbar_expect_tx(&full[slot], S::kKvBytes);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        wg::tma_load_4d(slots + slot * S::kKvBytes + cb * KV * 128, map, &full[slot], cb * 64,
                        kv0, hk, bb);
    }
    return;
  }

  wg::setmaxnreg_inc<240>();
  constexpr float kLog2e = 1.4426950408889634f;
  const int tw = threadIdx.x % 128, wi = tw / 32, lane = tw % 32, g = lane / 4, t = lane % 4;
  const bool leader = tw == 0;
  const int r0 = q0 + 64 * w;             // this warpgroup's first row
  const int row0 = r0 + 16 * wi + g;      // this thread's rows: row0, row0 + 8
  const long long row_stats = (static_cast<long long>(bb) * p.hq + hh) * p.sq;
  float lse[2], lse2[2], di[2];
  int q_ids[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lse[h] = row < p.sq ? p.lse[row_stats + row] : 0.f;
    di[h] = row < p.sq ? p.di[row_stats + row] : 0.f;
    lse2[h] = lse[h] * kLog2e;
  }
  const int* kv_seg = nullptr;
  if constexpr ((kOpt & kOptSeg) != 0) {
    const int* q_seg = p.q_seg + bb * p.seg_q_b;
    for (int h = 0; h < 2; ++h)
      q_ids[h] = row0 + 8 * h < p.sq ? __ldg(q_seg + (row0 + 8 * h) * p.seg_q_s) : 0;
    kv_seg = p.kv_seg + bb * p.seg_kv_b;
  }
  // Does tile kv0 need the mask for any of this warpgroup's rows? (Rows past sq read
  // q and do as zeros, lse and di as 0: their ds = p (0 - 0) is 0 unmasked too.) With
  // the user mask every tile does: a row without a key has lse = the mask value.
  auto edge_of = [&](int kv0) {
    if constexpr ((kOpt & (kOptSeg | kOptMask)) != 0) return true;
    bool e = kv0 + KV > p.skv || (p.causal && kv0 + KV - 1 > r0);
    if constexpr ((kOpt & kOptWin) != 0) e = e || kv0 <= r0 + 63 - p.window;
    return e;
  };

  const float* bbase = nullptr;
  float* dbase = nullptr;
  if constexpr ((kOpt & kOptBias) != 0) {
    bbase = bias_base(p, bb, hh);
    dbase = dbias_base(p, bb, hh);
  }
  const uint8_t* mbase = nullptr;
  if constexpr ((kOpt & kOptMask) != 0) mbase = mask_base(p, bb, hh);

  float dq[A::kNO][A::kON];
#pragma unroll
  for (int c = 0; c < A::kNO; ++c)
#pragma unroll
    for (int i = 0; i < A::kON; ++i) dq[c][i] = 0.f;
  uint32_t pa[KV / 16][4];
  const uint32_t q_s = wg::smem_u32(qs) + w * 8192, do_s = wg::smem_u32(dos) + w * 8192;
  const uint32_t k_s = wg::smem_u32(ks), v_s = wg::smem_u32(vs);
  wg::mbar_wait(q_full, 0);

  for (int i = 0; i < n; ++i) {
    const int slot = i & 1, kv0 = (band.x + i) * KV;
    const uint32_t parity = (i >> 1) & 1;
    float s[R], dp[R], cg[R];  // cg: kOptBias only
    wg::mbar_wait(&k_full[slot], parity);
    wg::fence();
    fwd_qk<D>(s, q_s, k_s + slot * S::kKvBytes);
    wg::commit();
    wg::mbar_wait(&v_full[slot], parity);
    fwd_qk<D>(dp, do_s, v_s + slot * S::kKvBytes);
    wg::commit();
    int kv_ids[R / 2];
    kv_ids_of<R, kOpt>(kv_ids, p, kv_seg, kv0 + 2 * t);
    const uint64_t mbits = mask_bits_of<R, kOpt>(p, mbase, row0, kv0 + 2 * t);
    wg::wait<1>();  // s has landed, and the previous tile's dq product is done
    wg::fence_acc(s);
    fence_o<D>(dq);
    fence_a(pa);
    if (leader && i > 0) wg::mbar_arrive(&k_empty[slot ^ 1]);
    dq_probs<R, kOpt>(p, s, cg, edge_of(kv0), row0, kv0 + 2 * t, lse, lse2, q_ids, kv_ids,
                      bbase, mbits);
    wg::wait<0>();  // dp has landed
    wg::fence_acc(dp);
    if (leader) wg::mbar_arrive(&v_empty[slot]);
    if constexpr ((kOpt & kOptBias) != 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {  // dbias = p (dp - di); ds = dbias (1 - t^2) scale
        const float d = s[j] * (dp[j] - di[(j >> 1) & 1]);
        store_dbias<kOpt>(p, dbase, row0 + 8 * ((j >> 1) & 1),
                          kv0 + 2 * t + 8 * (j >> 2) + (j & 1), d);
        dp[j] = d * cg[j] * p.scale;
      }
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) dp[j] = s[j] * (dp[j] - di[(j >> 1) & 1]) * p.scale;
    }
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk) wg::pack_a(pa[kk], &dp[8 * kk], &dp[8 * kk + 4]);
    wg::fence();
    fwd_pv<D, KV>(dq, pa, k_s + slot * S::kKvBytes);
    wg::commit();
  }
  wg::wait<0>();
  fence_o<D>(dq);
  fence_a(pa);

  // Epilogue: dq rounded once into this warpgroup's rows of the q tile (its last reads
  // of them are done), then 16-byte rows into [b, sq, hq, d].
  uint8_t* stage = qs + w * 8192;
  constexpr int NW = 2 * A::kON;
#pragma unroll
  for (int c = 0; c < A::kNO; ++c)
#pragma unroll
    for (int i = 0; i < A::kON; i += 2) {
      const int r = 16 * wi + g + 8 * ((i >> 1) & 1), col = c * NW + 8 * (i >> 2) + 2 * t;
      *reinterpret_cast<uint32_t*>(stage + (col / 64) * (QT * 128) +
                                   wg::sw128_offset(r, col % 64)) =
          wg::pack_bf16(dq[c][i], dq[c][i + 1]);
    }
  wg::bar_sync(1 + w, 128);
  bf16* out = static_cast<bf16*>(p.dq);
  for (int idx = tw; idx < 64 * (D / 8); idx += 128) {
    const int r = idx / (D / 8), col = (idx % (D / 8)) * 8, row = r0 + r;
    if (row < p.sq)
      *reinterpret_cast<uint4*>(out + ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D +
                                col) =
          *reinterpret_cast<const uint4*>(stage + (col / 64) * (QT * 128) +
                                          wg::sw128_offset(r, col % 64));
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
// halves in turn. mrow (kOptMask): the user mask's row of tile row r (read only
// for a row < sq and a key < skv), after the structural masks. bbase (kOptBias):
// the head's bias (see bias_base).
template <int D, int kOpt>
__device__ __forceinline__ void fwd_update_f32(const Params& p, float (&s)[F32Smem<D>::kCols],
                                               float& m, float& l,
                                               float (&acc)[F32Smem<D>::kDims], float* ps,
                                               const float* vs, const int* seg_q,
                                               const int* seg_kv, int q0, int kv0, int r,
                                               int h, const uint8_t* mrow, const float* bbase) {
  using S = F32Smem<D>;
  constexpr int LD = S::kLd, LP = S::kLdP, P = S::kPar, NC = S::kCols, HD = S::kDims;
  float cap_grad;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = kv0 + P * j + h;
    s[j] = score<kOpt>(p, s[j], q0 + r, col, seg_q, r, seg_kv, P * j + h, cap_grad,
                       bias_at<kOpt>(p, bbase, q0 + r, col));
    if constexpr ((kOpt & kOptMask) != 0)
      if (q0 + r < p.sq && col < p.skv && __ldg(mrow + col * p.mask_k) == 0) s[j] = kMaskValue;
  }
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
    // A key column past skv adds p = 0; a masked real key keeps exp(mask - m).
    const float pe = kv0 + P * j + h < p.skv ? expf(s[j] - m) : 0.f;
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
  static_assert(kHalves == 1 || (kOpt & (kOptSeg | kOptCap | kOptMask | kOptBias)) == 0,
                "K12 takes no segment ids, softcap, mask or bias");
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
  const uint8_t* mrow = nullptr;
  if constexpr ((kOpt & kOptMask) != 0)
    mrow = p.mask + bb * p.mask_b + hh * p.mask_h + static_cast<long long>(row) * p.mask_q;
  const float* bbase = nullptr;
  if constexpr ((kOpt & kOptBias) != 0) bbase = bias_base(p, bb, hh);
  load_rows<float, D, LD, T, kThreads>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);
  if (kOpt & kOptSeg) load_seg<T, kThreads>(seg, p.q_seg + bb * p.seg_q_b, p.seg_q_s, q0, p.sq);

  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;
  float m = kMaskValue, l = 0.f;

  const int n_kv = (p.skv + T - 1) / T;
  int2 band = kv_tiles<T, T, kOpt>(p, q0);
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
                              (kt + hv) * T, r, h, mrow, bbase);
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
  const float* bbase = nullptr;
  float* dbase = nullptr;
  if constexpr ((kOpt & kOptBias) != 0) {
    bbase = bias_base(p, bb, hh);
    if constexpr (kDq) dbase = dbias_base(p, bb, hh);
  }
  const uint8_t* mbase = nullptr;
  if constexpr ((kOpt & kOptMask) != 0) mbase = mask_base(p, bb, hh);
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
      const float sc = score<kOpt>(p, x[j], q0 + ql, col, seg, ql, seg_kv, c, cap_grad,
                                   bias_at<kOpt>(p, bbase, q0 + ql, col),
                                   mask_at<kOpt>(p, mbase, q0 + ql, col));
      pt[c * LP + ql] = expf(sc - lse_s[ql]);
      if constexpr ((kOpt & kOptCap) != 0) dst_t[c * LP + ql] = cap_grad;
    }
    dots_f32<D>(x, vs, c, dos, h);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int ql = P * j + h;
      float d = pt[c * LP + ql] * (x[j] - di_s[ql]);
      if constexpr (kDq) store_dbias<kOpt>(p, dbase, q0 + ql, col, d);
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
  const float* bbase = nullptr;
  float* dbase = nullptr;
  if constexpr ((kOpt & kOptBias) != 0) {
    bbase = bias_base(p, bb, hh);
    dbase = dbias_base(p, bb, hh);
  }
  const uint8_t* mbase = nullptr;
  if constexpr ((kOpt & kOptMask) != 0) mbase = mask_base(p, bb, hh);

  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;

  const int2 band = kv_tiles<T, T, kOpt>(p, q0);
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
      const float x = score<kOpt>(p, pr[j], row, kv0 + cl, seg, r, seg + T, cl, cap_grad,
                                  bias_at<kOpt>(p, bbase, row, kv0 + cl),
                                  mask_at<kOpt>(p, mbase, row, kv0 + cl));
      float d = expf(x - lse) * (dp[j] - di);
      store_dbias<kOpt>(p, dbase, row, kv0 + cl, d);
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

// with_opt for the forward, which also takes the mask: beside the window and the
// softcap only (the caller merges segment ids into the mask), so that the mask adds
// four instantiations a head dim and dtype, not eight.
template <typename F>
int with_fwd_opt(int opt, F&& f) {
  switch (opt) {
    case kOptMask: return f(std::integral_constant<int, kOptMask>());
    case kOptMask | kOptWin: return f(std::integral_constant<int, kOptMask | kOptWin>());
    case kOptMask | kOptCap: return f(std::integral_constant<int, kOptMask | kOptCap>());
    case kOptMask | kOptWin | kOptCap:
      return f(std::integral_constant<int, kOptMask | kOptWin | kOptCap>());
  }
  if (opt & kOptMask) return static_cast<int>(cudaErrorInvalidValue);
  return with_opt(opt, f);
}

// with_opt for the backwards, which take the mask alone at head dim 64 (BERT's heads;
// the caller merges segment ids into it): K2 and K5's two kernels, fp32 and bf16, six
// instantiations. The mask with a window, a softcap, a bias or at another head dim is
// refused here and, before any launch, by the caller.
template <int D, typename F>
int with_bwd_opt(int opt, F&& f) {
  if (opt & kOptMask) {
    if constexpr (D == 64)
      if (opt == kOptMask) return f(std::integral_constant<int, kOptMask>());
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return with_opt(opt, f);
}

// The bias's instantiations (the opt bits with kOptBias): alone and with segment
// ids at every head dim, with the mask (kFwd, the forwards) at every head dim, and
// with the softcap alone at head dim 64 (see the header). Other combinations are
// refused here and, before any launch, by the caller.
template <int D, bool kFwd, typename F>
int with_bias_opt(int opt, F&& f) {
  switch (opt) {
    case kOptBias: return f(std::integral_constant<int, kOptBias>());
    case kOptBias | kOptSeg: return f(std::integral_constant<int, kOptBias | kOptSeg>());
  }
  if constexpr (kFwd)
    if (opt == (kOptBias | kOptMask))
      return f(std::integral_constant<int, kOptBias | kOptMask>());
  if constexpr (D == 64)
    if (opt == (kOptBias | kOptCap))
      return f(std::integral_constant<int, kOptBias | kOptCap>());
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
  p.mask_b = strides[16];
  p.mask_h = strides[17];
  p.mask_q = strides[18];
  p.mask_k = strides[19];
  p.bias_b = strides[20];
  p.bias_h = strides[21];
  p.bias_q = strides[22];
  p.bias_k = strides[23];
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
         (p.softcap > 0.f ? kOptCap : 0) | (p.mask != nullptr ? kOptMask : 0) |
         (p.bias != nullptr ? kOptBias : 0);
}

dim3 tiles(int n, int rows, int bh) { return dim3((n + rows - 1) / rows, bh); }

// The map of a bf16 [b, h, s, d] view with element strides st (d contiguous), read in
// boxes of [rows][64] (one 64-wide column block of `rows` positions of one head),
// 128-byte swizzled; positions past s read as zeros. The stride of a dimension of size
// 1 is never used and is given as one that TMA accepts.
bool make_map(CUtensorMap* map, const void* ptr, const Strides& st, int b, int h, int s, int d,
              int rows) {
  wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const long long given[3] = {st.s, st.h, st.b};
  cuuint64_t strides[3];
  cuuint64_t span = static_cast<cuuint64_t>(d) * 2;  // bytes of the dimensions below
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? span : static_cast<cuuint64_t>(given[i]) * 2;
    span = strides[i] * dims[i + 1] > span ? strides[i] * dims[i + 1] : span;
  }
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K1 or K12 in bf16: the tensor maps of q, k and v, then the launch.
template <int D, int kHalves, int kOpt>
int launch_fwd_bf16(const Params& p, cudaStream_t s) {
  using S = FwdSmem<D>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, p.q, p.st_q, p.b, p.hq, p.sq, D, S::kQ) ||
      !make_map(&mk, p.k, p.st_k, p.b, p.hkv, p.skv, D, S::kKv) ||
      !make_map(&mv, p.v, p.st_v, p.b, p.hkv, p.skv, D, S::kKv))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_bf16<D, kHalves, kOpt>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tiles(p.sq, S::kQ, p.b * p.hq), 384, S::kBytes, s>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

// K5's dq kernel in bf16: the tensor maps of q, do, k and v, then the launch.
template <int D, int kOpt>
int launch_dq_bf16(const Params& p, cudaStream_t s) {
  using S = DqSmem<D>;
  CUtensorMap mq, mdo, mk, mv;
  if (!make_map(&mq, p.q, p.st_q, p.b, p.hq, p.sq, D, S::kQ) ||
      !make_map(&mdo, p.dout, p.st_do, p.b, p.hq, p.sq, D, S::kQ) ||
      !make_map(&mk, p.k, p.st_k, p.b, p.hkv, p.skv, D, S::kKv) ||
      !make_map(&mv, p.v, p.st_v, p.b, p.hkv, p.skv, D, S::kKv))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_dq_bf16<D, kOpt>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tiles(p.sq, S::kQ, p.b * p.hq), 384, S::kBytes, s>>>(mq, mdo, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

// d 192 (MLA) is built for what its callers pass: no option or segment ids (K12: no
// option). Calls with others are refused here and, before any launch, by the caller.
template <typename F>
int with_mla_opt(int opt, F&& f) {
  if (opt == 0) return f(std::integral_constant<int, 0>());
  if (opt == kOptSeg) return f(std::integral_constant<int, kOptSeg>());
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_fwd(const Params& p, int dtype, int dual, cudaStream_t s) {
  const int opt = opts_of(p), bh = p.b * p.hq;
  using F = F32Smem<D>;
  auto run_dual = [&](auto o) {  // K12
    constexpr int kOpt = decltype(o)::value;
    if (dtype == 1) return launch_fwd_bf16<D, 2, kOpt>(p, s);
    return launch(flash_fwd_f32<D, 2, kOpt>, tiles(p.sq, F::kRows, bh), kThreads,
                  F::fwd_bytes(2), s, p);
  };
  auto run = [&](auto o) {
    constexpr int kOpt = decltype(o)::value;
    if (dtype == 1) return launch_fwd_bf16<D, 1, kOpt>(p, s);
    return launch(flash_fwd_f32<D, 1, kOpt>, tiles(p.sq, F::kRows, bh), kThreads,
                  F::fwd_bytes(1), s, p);
  };
  if constexpr (D == 192) {
    if (dual)
      return opt ? static_cast<int>(cudaErrorInvalidValue)
                 : run_dual(std::integral_constant<int, 0>());
    return with_mla_opt(opt, run);
  } else {
    if (dual) {  // K12: the window only
      if (opt & ~kOptWin) return static_cast<int>(cudaErrorInvalidValue);
      return opt ? run_dual(std::integral_constant<int, kOptWin>())
                 : run_dual(std::integral_constant<int, 0>());
    }
    if (opt & kOptBias) return with_bias_opt<D, true>(opt, run);
    return with_fwd_opt(opt, run);
  }
}

template <int D>
int launch_bwd(const Params& p, int dtype, int split, cudaStream_t s) {
  const int bh = p.b * p.hq;
  using F = F32Smem<D>;
  auto run = [&](auto o) {
    constexpr int kOpt = decltype(o)::value;
    if (dtype == 1) {
      using W = BwdSmem<D>;
      const dim3 grid_kv(p.b * p.hkv, (p.skv + W::kKv - 1) / W::kKv);
      if (!split)
        return launch(flash_bwd_bf16<D, true, kOpt>, grid_kv, 256, W::kBytes, s, p);
      int rc = launch_dq_bf16<D, kOpt>(p, s);
      if (rc == 0) rc = launch(flash_bwd_bf16<D, false, kOpt>, grid_kv, 256, W::kBytes, s, p);
      return rc;
    }
    const dim3 grid_q = tiles(p.sq, F::kRows, bh), grid_kv = tiles(p.skv, F::kRows, bh);
    if (!split)
      return launch(flash_bwd_f32<D, true, kOpt>, grid_kv, kThreads, F::kBwdBytes, s, p);
    int rc = launch(flash_bwd_dq_f32<D, kOpt>, grid_q, kThreads, F::kDqBytes, s, p);
    if (rc == 0) rc = launch(flash_bwd_f32<D, false, kOpt>, grid_kv, kThreads, F::kBwdBytes, s, p);
    return rc;
  };
  const int opt = opts_of(p);
  if constexpr (D == 192) {
    return with_mla_opt(opt, run);
  } else {
    if (opt & kOptBias) return with_bias_opt<D, false>(opt, run);
    return with_bwd_opt<D>(opt, run);
  }
}

}  // namespace

// dtype codes: 0 = float32 (FMA path), 1 = bfloat16 (tensor cores); d is 64,
// 128, 192 (no option but segment ids; K12 none) or 256. strides: 24 element
// strides, (b, h, s) of q, k, v and do, in that
// order (the forward reads the first 9), then (b, s) of q_seg and of kv_seg,
// then (b, h, q, k) of the mask, then (b, h, q, k) of the bias. q_seg/kv_seg:
// int32 segment ids, both null for none. mask: uint8 [b|1, hq|1, sq, skv],
// nonzero = attend, null for none; not with segment ids (the caller merges them
// into it); in the backward alone at d 64. bias: fp32 [b|1, hq|1,
// sq, skv], null for none; with it the backward writes dbias (fp32 [b, hq, sq,
// skv], zeroed by the caller under causal; null: not stored). window: 0 for none, else
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
                                      const uint8_t* mask, const float* bias,
                                      const long long* strides, int dtype,
                                      int b, int hq, int hkv, int sq, int skv, int d, int causal,
                                      int dual,
                                      int window, float scale, float softcap, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(strides, q_seg, kv_seg, b, hq, hkv, sq, skv, causal, window, scale,
                         softcap);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.mask = mask;
  p.bias = bias;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fwd<64>(p, dtype, dual, s);
  if (d == 128) return launch_fwd<128>(p, dtype, dual, s);
  if (d == 192) return launch_fwd<192>(p, dtype, dual, s);
  if (d == 256) return launch_fwd<256>(p, dtype, dual, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int np_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* di,
                                      const int* q_seg, const int* kv_seg, const uint8_t* mask,
                                      const float* bias, void* dq, void* dk, void* dv,
                                      float* dbias,
                                      const long long* strides, int dtype, int b,
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
  p.mask = mask;
  p.bias = bias;
  p.dbias = dbias;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_bwd<64>(p, dtype, split, s);
  if (d == 128) return launch_bwd<128>(p, dtype, split, s);
  if (d == 192) return launch_bwd<192>(p, dtype, split, s);
  if (d == 256) return launch_bwd<256>(p, dtype, split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
