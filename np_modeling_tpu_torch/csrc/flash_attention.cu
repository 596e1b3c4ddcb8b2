// Flash attention forward (K1) and fused backward (K2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of np_modeling_tpu/ops/attention.py:
//   forward   _fwd_tile  (:756, launched by _flash_fwd_pallas :829, call :904)
//   backward  _dkvq_tile (:1100, launched by _flash_bwd_pallas :1188, call :1335)
//
// What they compute. q [b, hq, sq, d], k/v [b, hkv, skv, d]; q head h reads kv
// head h / (hq / hkv) (GQA). Scores s = (q . k) * scale in fp32, masked with the
// JAX package's finite mask value (never -inf, so exp never makes a NaN): keys
// past skv, query rows past sq, and with causal the top-left mask col <= row in
// absolute indices. The forward keeps the online-softmax m, l and acc in fp32,
// rounds p to v's dtype before p.v (as the TPU kernel does), and writes o in
// q's dtype and lse = m + log(l) as fp32 [b, hq, sq] (no lane broadcast). The
// l == 0 guards of the TPU kernel's _store are kept. The backward recomputes
// p = exp(s - lse), takes di = rowsum(do . o) from the caller, and per kv tile
// accumulates dv += p^T do and dk += ds^T q in fp32 registers with
// ds = p * (dp - di) * scale; dq += ds k is added with fp32 atomics into a
// zeroed fp32 buffer (the summation order of dq therefore varies from run to
// run, by rounding only). dk and dv come out per q head; the caller sums GQA
// groups.
//
// What bounds them on this card. At the training shape (b 4, h 8, s 4096,
// d 128, causal) attention is ~0.14 TFLOP forward and ~0.34 TFLOP backward a
// layer against ~0.1 GB of q/k/v/o traffic: far above the card's ~295 flops a
// byte, so tensor-core throughput bounds both, and the design keeps the s and
// p tiles out of device memory entirely (registers and shared memory only).
// The bf16 kernels run every product on the tensor cores with mma.sync
// m16n8k16 (fp32 accumulate): a block of 4 warps owns a 64-row tile (q rows in
// the forward, kv rows in the backward), each warp 16 rows, and loops over the
// other side's 64-row tiles inside the block; the causal band's tiles above
// the diagonal are never visited. The s accumulator fragments are re-packed in
// registers as the A operand of p.v and ds^T q (no shared-memory round trip);
// only ds goes through shared memory, for dq, whose rows span all 4 warps.
// With a 64-row tile the training shape has 64 x 32 = 2048 blocks for 132
// SMs. The dq layout of the TPU kernel ([b, h, n_kv, sq, d] partials, ~2 GB
// at that shape with 64-wide kv tiles) is replaced by atomics into a 67 MB
// buffer. fp32 inputs take a plain FMA path (exact comparisons need it).
// Loads are synchronous 16-byte vectors; cp.async/TMA pipelining, wgmma and
// warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;  // rows of a q tile and of a kv tile, both kernels
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
  float* dq;         // [b, sq, hq, d] fp32, zeroed by the caller
  void* dk;          // [b, skv, hq, d], k's dtype (per q head)
  void* dv;
  Strides st_q, st_k, st_v, st_do;
  int b, hq, hkv, sq, skv, causal;
  float scale;
};

__device__ __forceinline__ bool masked(const Params& p, int row, int col) {
  return row >= p.sq || col >= p.skv || (p.causal && col > row);
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

template <int D>
struct Bf16Smem {
  static constexpr int kLd = D + 8;         // pitch of a [64][D] tile
  static constexpr int kLdS = kTile + 8;    // pitch of the [64][64] ds tile
  static constexpr int kTileElems = kTile * kLd;
  static constexpr size_t kFwdBytes = 3 * kTileElems * sizeof(bf16);
  static constexpr size_t kBwdBytes =
      (4 * kTileElems + kTile * kLdS) * sizeof(bf16) + 2 * kTile * sizeof(float);
};

// ---- K1, bf16: grid (q tiles, b * hq); warp w owns q rows 16w .. 16w+15 ----
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(const Params p) {
  using S = Bf16Smem<D>;
  constexpr int LD = S::kLd, KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + S::kTileElems;
  bf16* vs = ks + S::kTileElems;

  const int n_q = (p.sq + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kTile;  // long rows first
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rw = warp * 16;  // this warp's first row in the tile

  const bf16* q = static_cast<const bf16*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const bf16* k = static_cast<const bf16*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const bf16* v = static_cast<const bf16*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;

  load_rows<bf16, D, LD>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};

  const int n_kv = (p.skv + kTile - 1) / kTile;
  const int kv_end = p.causal ? min(n_kv, (q0 + kTile - 1) / kTile + 1) : n_kv;
  for (int kt = 0; kt < kv_end; ++kt) {
    const int kv0 = kt * kTile;
    __syncthreads();  // the previous tile's k/v reads are done
    load_rows<bf16, D, LD>(ks, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
    load_rows<bf16, D, LD>(vs, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_rowsT<KD>(s, qs, rw, ks, LD, g, t);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + rw + g + (e >> 1) * 8, col = kv0 + 8 * n + 2 * t + (e & 1);
        const float x = masked(p, row, col) ? kMaskValue : s[n][e] * p.scale;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
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
    // acc += p (rounded to bf16) . v, k = the tile's 64 keys in 4 steps.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
      mma_rows<ND>(acc, a, vs, LD, 16 * kk, g, t);
    }
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

// ---- K2, bf16: grid (kv tiles, b * hq); warp w owns kv rows 16w .. 16w+15 --
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_bf16(const Params p) {
  using S = Bf16Smem<D>;
  constexpr int LD = S::kLd, LDS = S::kLdS, KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + S::kTileElems;
  bf16* qs = vs + S::kTileElems;
  bf16* dos = qs + S::kTileElems;
  bf16* dss = dos + S::kTileElems;  // ds of the tile pair, [q][kv], pitch LDS
  float* lse_s = reinterpret_cast<float*>(dss + kTile * LDS);
  float* di_s = lse_s + kTile;

  const int kv0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rw = warp * 16;

  const bf16* q = static_cast<const bf16*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const bf16* k = static_cast<const bf16*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const bf16* v = static_cast<const bf16*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  const bf16* dout = static_cast<const bf16*>(p.dout) + bb * p.st_do.b + hh * p.st_do.h;
  const long long row_stats = (static_cast<long long>(bb) * p.hq + hh) * p.sq;

  load_rows<bf16, D, LD>(ks, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
  load_rows<bf16, D, LD>(vs, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);

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
    __syncthreads();

    // p^T = exp(s^T - lse): rows = this warp's kv rows, cols = the q rows.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_rowsT<KD>(s, ks, rw, qs, LD, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + rw + g + (e >> 1) * 8, ql = 8 * n + 2 * t + (e & 1);
        const float x = masked(p, q0 + ql, col) ? kMaskValue : s[n][e] * p.scale;
        s[n][e] = expf(x - lse_s[ql]);
      }
    }
    // dv += p^T (rounded to bf16) . do
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
      mma_rows<ND>(dv, a, dos, LD, 16 * kk, g, t);
    }
    // dp^T = v . do^T, then ds^T = p^T * (dp^T - di) * scale
    float ds[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
    mma_rowsT<KD>(ds, vs, rw, dos, LD, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * n + 2 * t + (e & 1);
        const float x = s[n][e] * (ds[n][e] - di_s[ql]) * p.scale;
        ds[n][e] = x;
        dss[ql * LDS + rw + g + (e >> 1) * 8] = __float2bfloat16_rn(x);
      }
    }
    // dk += ds^T (rounded to bf16) . q
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      pack_a(a, ds[2 * kk], ds[2 * kk + 1]);
      mma_rows<ND>(dk, a, qs, LD, 16 * kk, g, t);
    }
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
      float* dst = p.dq + ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D + 2 * t;
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
  static constexpr size_t kFwdBytes = (3 * kTileElems + kPElems) * sizeof(float);
  static constexpr size_t kBwdBytes = (4 * kTileElems + 2 * kPElems + 2 * kTile) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  using S = F32Smem<D>;
  constexpr int LD = S::kLd, LP = S::kLdP, HD = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + S::kTileElems;
  float* vs = ks + S::kTileElems;
  float* ps = vs + S::kTileElems;

  const int n_q = (p.sq + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  const int row = q0 + r;

  const float* q = static_cast<const float*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const float* k = static_cast<const float*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const float* v = static_cast<const float*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  load_rows<float, D, LD>(qs, q + q0 * p.st_q.s, p.st_q.s, p.sq - q0);

  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;
  float m = kMaskValue, l = 0.f;

  const int n_kv = (p.skv + kTile - 1) / kTile;
  const int kv_end = p.causal ? min(n_kv, (q0 + kTile - 1) / kTile + 1) : n_kv;
  for (int kt = 0; kt < kv_end; ++kt) {
    const int kv0 = kt * kTile;
    __syncthreads();
    load_rows<float, D, LD>(ks, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
    load_rows<float, D, LD>(vs, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);
    __syncthreads();

    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = fmaf(qd, ks[(2 * j + h) * LD + d], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s[j] = masked(p, row, kv0 + 2 * j + h) ? kMaskValue : s[j] * p.scale;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float alpha = expf(m - mx);
    m = mx;
    float rs = 0.f;
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

template <int D>
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

  const int kv0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, bb = bh / p.hq, hh = bh % p.hq;
  const int hk = hh / (p.hq / p.hkv);
  const int c = threadIdx.x >> 1, h = threadIdx.x & 1;  // kv row c (and q row c for dq)
  const int col = kv0 + c;

  const float* q = static_cast<const float*>(p.q) + bb * p.st_q.b + hh * p.st_q.h;
  const float* k = static_cast<const float*>(p.k) + bb * p.st_k.b + hk * p.st_k.h;
  const float* v = static_cast<const float*>(p.v) + bb * p.st_v.b + hk * p.st_v.h;
  const float* dout = static_cast<const float*>(p.dout) + bb * p.st_do.b + hh * p.st_do.h;
  const long long row_stats = (static_cast<long long>(bb) * p.hq + hh) * p.sq;
  load_rows<float, D, LD>(ks, k + kv0 * p.st_k.s, p.st_k.s, p.skv - kv0);
  load_rows<float, D, LD>(vs, v + kv0 * p.st_v.s, p.st_v.s, p.skv - kv0);

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
    __syncthreads();

    float x[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) x[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = ks[c * LD + d];
#pragma unroll
      for (int j = 0; j < 32; ++j) x[j] = fmaf(kd, qs[(2 * j + h) * LD + d], x[j]);
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int ql = 2 * j + h;
      const float sv = masked(p, q0 + ql, col) ? kMaskValue : x[j] * p.scale;
      pt[c * LP + ql] = expf(sv - lse_s[ql]);
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) x[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float vd = vs[c * LD + d];
#pragma unroll
      for (int j = 0; j < 32; ++j) x[j] = fmaf(vd, dos[(2 * j + h) * LD + d], x[j]);
    }
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
    // dq row q0 + c, dims of parity h, 16 at a time, added atomically.
    const int row = q0 + c;
    float* dq = p.dq + ((static_cast<long long>(bb) * p.sq + row) * p.hq + hh) * D + h;
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

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const long long* strides, int b, int hq, int hkv, int sq, int skv,
                   int causal, float scale) {
  Params p = {};
  Strides* st[4] = {&p.st_q, &p.st_k, &p.st_v, &p.st_do};
  for (int i = 0; i < 4; ++i) *st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.b = b;
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

// dtype codes: 0 = float32 (FMA path), 1 = bfloat16 (tensor cores); d is 64
// or 128. strides: 12 element strides (b, h, s) of q, k, v and do, in that
// order (the forward reads the first 9). Outputs and scratch are allocated by
// the caller: o [b, sq, hq, d] in q's dtype; lse [b, hq, sq] fp32 or null;
// dq [b, sq, hq, d] fp32, zeroed; dk/dv [b, skv, hq, d] in k's dtype. Both
// return cudaGetLastError() of the launch (0 on success).
extern "C" int np_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      float* lse, const long long* strides, int dtype, int b,
                                      int hq, int hkv, int sq, int skv, int d, int causal,
                                      float scale, void* stream) {
  Params p = make_params(strides, b, hq, hkv, sq, skv, causal, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  const dim3 grid((sq + kTile - 1) / kTile, b * hq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 64) return launch(flash_fwd_bf16<64>, grid, Bf16Smem<64>::kFwdBytes, s, p);
  if (dtype == 1 && d == 128) return launch(flash_fwd_bf16<128>, grid, Bf16Smem<128>::kFwdBytes, s, p);
  if (dtype == 0 && d == 64) return launch(flash_fwd_f32<64>, grid, F32Smem<64>::kFwdBytes, s, p);
  if (dtype == 0 && d == 128) return launch(flash_fwd_f32<128>, grid, F32Smem<128>::kFwdBytes, s, p);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int np_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* di,
                                      float* dq, void* dk, void* dv, const long long* strides,
                                      int dtype, int b, int hq, int hkv, int sq, int skv, int d,
                                      int causal, float scale, void* stream) {
  Params p = make_params(strides, b, hq, hkv, sq, skv, causal, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.di = di;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  const dim3 grid((skv + kTile - 1) / kTile, b * hq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 64) return launch(flash_bwd_bf16<64>, grid, Bf16Smem<64>::kBwdBytes, s, p);
  if (dtype == 1 && d == 128) return launch(flash_bwd_bf16<128>, grid, Bf16Smem<128>::kBwdBytes, s, p);
  if (dtype == 0 && d == 64) return launch(flash_bwd_f32<64>, grid, F32Smem<64>::kBwdBytes, s, p);
  if (dtype == 0 && d == 128) return launch(flash_bwd_f32<128>, grid, F32Smem<128>::kBwdBytes, s, p);
  return static_cast<int>(cudaErrorInvalidValue);
}
