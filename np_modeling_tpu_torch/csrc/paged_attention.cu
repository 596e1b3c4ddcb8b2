// Paged attention for decode and chunked append, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of np_modeling_tpu/ops/paged_attention.py:
// _paged_kernel_folded (:221) and _paged_kernel (:128). They compute the same
// function; the head fold there is a TPU grid-overhead device, and on this card
// one kernel computes both.
//
// What it computes. q rows are the (query token t, group member j) pairs of one
// kv head, folded token-major: row r = t*g + j reads q head h*g + j of token t.
// Row r sits at absolute position own = lengths[b] - sq + t and attends to the
// cached positions pos <= own. Scores are fp32, scaled in-kernel, masked with the
// JAX package's finite mask value, and reduced by an online softmax (m, l, acc in
// fp32). p is rounded to the page dtype before p.v, as the TPU kernel does.
// int8 pages (the int8 KV cache) come with fp32 per-token scales [hkv, P, ps, 1]:
// each staged key and value row is dequantized in fp32 as int8 * scale[token], as
// the TPU kernel does (:272-278), and p then stays fp32 (JAX's p.astype(v.dtype)
// with v dequantized to fp32). int8 pages halve the bytes of bf16 pages.
// A sequence with length 0 stores 0 (the l == 0 guard of the TPU kernel).
// Two options are template parameters, so that a call without them runs the
// code it ran before they existed: the softcap (Gemma-2) replaces each scaled
// score s by cap * tanh(s / cap) before the mask (:286-287), and the sliding
// window keeps, for a row at position own, only pos > own - window (:297-298).
//
// What bounds it. At decode each (sequence, kv head) reads 2*ctx*d*bytes of K/V
// once and does 4*ctx*d*g flops on them: a few flops per byte, far below the
// card's ratio, so device-memory bytes bound it. The design reads each page once
// per kv head and shares it among the g grouped q heads (and the sq query
// tokens of a prefill chunk), which all sit in the rows of one tile. It walks
// only the positions the tile can see: never past ceil(length/page_size) table
// entries or past the table's width, and with a window never below the band of
// the warp's first row (the TPU kernel's should_run, :263-266), so a page
// outside [band start, last row] is never read, nor is its table entry.
//
// Layout. Grid (row tiles, kv heads, sequences); 4 warps a block. A warp owns
// up to R rows (R = 16 at head_dim 64 and 128, 8 at 256, where a lane holds 8
// accumulator columns a row). When a tile has fewer rows than 4 warps can hold
// (decode: g rows), the spare warps split the key range instead and the partial
// (m, l, acc) are merged through shared memory at the end. Each warp stages
// blocks of 32 keys (one per lane for the scores) in its own shared memory, so
// the main loop needs no block-wide barrier. At head_dim 256 the staged V
// block overwrites the K block once the scores are taken (fp32 staging of both
// would need 336 KB for 4 warps; this way 168 KB). Plain FMA loops; wgmma, TMA
// and split-KV across blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kKeys = 32;  // keys per staged block: one per lane
// np_modeling_tpu/ops/attention.py DEFAULT_MASK_VALUE = -0.7 * float32 max.
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The type p is rounded to before p.v: the page type, fp32 for int8 pages.
template <typename T> struct PType { using type = T; };
template <> struct PType<int8_t> { using type = float; };

// Load E consecutive elements of type T as floats: one 2-, 4-, 8- or 16-byte
// vector, or (past 16 bytes: fp32 rows at head_dim 256) two halves.
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  constexpr int kBytes = E * static_cast<int>(sizeof(T));
  if constexpr (kBytes > 16) {
    load_vec<T, E / 2>(src, dst);
    load_vec<T, E / 2>(src + E / 2, dst + E / 2);
  } else {
    static_assert(kBytes == 2 || kBytes == 4 || kBytes == 8 || kBytes == 16,
                  "vector width");
    using V = typename std::conditional<
        kBytes == 16, uint4,
        typename std::conditional<
            kBytes == 8, uint2,
            typename std::conditional<kBytes == 4, uint32_t, uint16_t>::type>::type>::type;
    V v = *reinterpret_cast<const V*>(src);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < E; ++i) dst[i] = to_f(e[i]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// One warp's rows and shared memory, by head_dim: R rows; q rows, the K block
// (rows padded by one float so that lane-per-key reads miss bank conflicts),
// the V block (its own buffer below head_dim 256, the K block's at 256), the p
// block.
template <int D>
struct WarpSmem {
  static constexpr int kRows = D > 128 ? 8 : 16;
  static constexpr bool kShareKV = D > 128;
  static constexpr int kVStride = kShareKV ? D + 1 : D;
  static constexpr int kQ = kRows * D;
  static constexpr int kK = kKeys * (D + 1);
  static constexpr int kV = kShareKV ? 0 : kKeys * D;
  static constexpr int kP = kRows * kKeys;
  static constexpr int kFloats = kQ + kK + kV + kP;
};

// Stage one block of 32 keys: lane kk holds key kk's element offset (my_base,
// -1 for a key the walk does not read, which stages zeros) and, for int8
// pages, its scales. Rows of a_pages go to a_dst (row stride a_stride) and,
// with kPair, rows of b_pages to b_dst, dequantized as int8 * scale.
template <typename TKV, int E, bool kInt8, bool kPair>
__device__ __forceinline__ void stage_block(const TKV* __restrict__ a_pages,
                                            const TKV* __restrict__ b_pages,
                                            long long my_base, float my_as, float my_bs,
                                            float* a_dst, int a_stride, float* b_dst,
                                            int b_stride, int lane) {
#pragma unroll 4
  for (int kk = 0; kk < kKeys; ++kk) {
    const long long base = __shfl_sync(kFull, my_base, kk);
    float av[E], bv[E];
    if (base >= 0) {
      load_vec<TKV, E>(a_pages + base + lane * E, av);
      if constexpr (kPair) load_vec<TKV, E>(b_pages + base + lane * E, bv);
      if constexpr (kInt8) {
        const float as = __shfl_sync(kFull, my_as, kk);
#pragma unroll
        for (int c = 0; c < E; ++c) av[c] *= as;
        if constexpr (kPair) {
          const float bs = __shfl_sync(kFull, my_bs, kk);
#pragma unroll
          for (int c = 0; c < E; ++c) bv[c] *= bs;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < E; ++c) av[c] = bv[c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < E; ++c) {
      a_dst[kk * a_stride + lane * E + c] = av[c];
      if constexpr (kPair) b_dst[kk * b_stride + lane * E + c] = bv[c];
    }
  }
}

template <typename TQ, typename TKV, int D, bool kWindow, bool kCap>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                       const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales, const int* __restrict__ lengths,
                       const int* __restrict__ table, TQ* __restrict__ out, int sq,
                       int hq, int hkv, int total_pages, int ps_shift, int pages_per_seq,
                       float scale, int window, float cap) {
  constexpr int E = D / 32;  // elements of a row per lane
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  using S = WarpSmem<D>;
  constexpr int R = S::kRows;
  constexpr int kTileRows = kWarps * R;
  extern __shared__ float smem[];

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = hq / hkv;
  const int rows = sq * g;
  const int r0 = tile * kTileRows;
  const int n_rows = min(kTileRows, rows - r0);
  const int row_groups = (n_rows + R - 1) / R;    // 1..4
  const int key_splits = kWarps / row_groups;     // 4, 2, 1, 1
  const int rg = warp % row_groups, ks = warp / row_groups;
  const bool idle = ks >= key_splits;  // the 4th warp when 3 row groups
  const int wr0 = r0 + rg * R;
  const int w_rows = idle ? 0 : min(R, r0 + n_rows - wr0);
  const int length = lengths[b];
  const int page_size = 1 << ps_shift;
  const float inv_cap = kCap ? 1.f / cap : 0.f;

  float* qs = smem + warp * S::kFloats;
  float* kst = qs + S::kQ;
  float* vst = S::kShareKV ? kst : kst + S::kK;
  float* pst = kst + S::kK + S::kV;

  // Positions this warp's rows can see: [kv_lo, kv_end); kv_lo is the band
  // start of its first row under a window, else 0.
  int kv_end = 0, kv_lo = 0;
  if (w_rows > 0) {
    const int own_last = length - sq + (wr0 + w_rows - 1) / g;
    kv_end = min(own_last + 1, pages_per_seq << ps_shift);
    if constexpr (kWindow) kv_lo = max(0, length - sq + wr0 / g - window + 1);
  }

  for (int i = 0; i < w_rows; ++i) {
    const int r = wr0 + i, t = r / g, j = r % g;
    const TQ* src = q + ((static_cast<size_t>(b) * sq + t) * hq + h * g + j) * D;
    load_vec<TQ, E>(src + lane * E, qs + i * D + lane * E);
  }

  float m[R], l[R], acc[R][E];
  int own[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
    own[i] = length - sq + (wr0 + i) / g;
#pragma unroll
    for (int c = 0; c < E; ++c) acc[i][c] = 0.f;
  }
  const int* row_table = table + static_cast<size_t>(b) * pages_per_seq;

  for (int kb = (kv_lo / kKeys + ks) * kKeys; kb < kv_end; kb += key_splits * kKeys) {
    // Lane kk resolves key kb+kk's page; the warp then stages row by row.
    const int my_pos = kb + lane;
    long long my_base = -1;
    float my_ks = 1.f, my_vs = 1.f;  // the key's scales (int8 pages)
    bool walked = my_pos < kv_end;
    if constexpr (kWindow) walked = walked && my_pos >= kv_lo;
    if (walked) {
      const int page = row_table[my_pos >> ps_shift];
      const long long token = (static_cast<long long>(h) * total_pages + page) * page_size +
                              (my_pos & (page_size - 1));
      my_base = token * D;
      if constexpr (kInt8) {
        my_ks = k_scales[token];
        my_vs = v_scales[token];
      }
    }
    __syncwarp();
    stage_block<TKV, E, kInt8, !S::kShareKV>(k_pages, v_pages, my_base, my_ks, my_vs, kst,
                                             D + 1, vst, S::kVStride, lane);
    __syncwarp();

    // Scores: lane = key, one accumulator per row.
    float s[R];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = 0.f;
    const float* krow = kst + lane * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (i < w_rows) s[i] = fmaf(qs[i * D + d], kd, s[i]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < w_rows) {
        bool keep = my_pos <= own[i] && my_pos < kv_end;
        if constexpr (kWindow) keep = keep && my_pos > own[i] - window;
        float si = s[i] * scale;
        if constexpr (kCap) si = cap * tanhf(si * inv_cap);
        si = keep ? si : kMaskValue;
        const float m_next = fmaxf(m[i], warp_max(si));
        const float alpha = expf(m[i] - m_next);
        const float p = expf(si - m_next);
        l[i] = alpha * l[i] + warp_sum(p);
        m[i] = m_next;
#pragma unroll
        for (int c = 0; c < E; ++c) acc[i][c] *= alpha;
        pst[i * kKeys + lane] = to_f(from_f<typename PType<TKV>::type>(p));
      }
    }
    __syncwarp();
    if constexpr (S::kShareKV) {  // V over the K block, now read
      stage_block<TKV, E, kInt8, false>(v_pages, nullptr, my_base, my_vs, 1.f, vst,
                                        S::kVStride, nullptr, 0, lane);
      __syncwarp();
    }

    // acc[i][c] (column lane + 32c) += sum_k p[i][k] * v[k][lane + 32c].
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float vcol[E];
#pragma unroll
      for (int c = 0; c < E; ++c) vcol[c] = vst[kk * S::kVStride + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (i < w_rows) {
          const float p = pst[i * kKeys + kk];
#pragma unroll
          for (int c = 0; c < E; ++c) acc[i][c] = fmaf(p, vcol[c], acc[i][c]);
        }
      }
    }
    __syncwarp();
  }

  if (key_splits > 1) {  // uniform over the block
    // Publish each split's (m, l, acc) in its own q/p staging area.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < w_rows) {
#pragma unroll
        for (int c = 0; c < E; ++c) qs[i * D + lane + 32 * c] = acc[i][c];
        if (lane == 0) {
          pst[i * kKeys] = m[i];
          pst[i * kKeys + 1] = l[i];
        }
      }
    }
    __syncthreads();
    if (ks == 0) {
      for (int sp = 1; sp < key_splits; ++sp) {
        const float* other = smem + (rg + sp * row_groups) * S::kFloats;
        const float* oacc = other;
        const float* op = other + S::kQ + S::kK + S::kV;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (i < w_rows) {
            const float m2 = op[i * kKeys], l2 = op[i * kKeys + 1];
            const float mn = fmaxf(m[i], m2);
            const float a1 = expf(m[i] - mn), a2 = expf(m2 - mn);
            l[i] = a1 * l[i] + a2 * l2;
            m[i] = mn;
#pragma unroll
            for (int c = 0; c < E; ++c)
              acc[i][c] = a1 * acc[i][c] + a2 * oacc[i * D + lane + 32 * c];
          }
        }
      }
    }
  }

  if (ks != 0) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < w_rows) {
      const int r = wr0 + i, t = r / g, j = r % g;
      TQ* dst = out + ((static_cast<size_t>(b) * sq + t) * hq + h * g + j) * D;
      const float l_inv = l[i] == 0.f ? 1.f : 1.f / l[i];
#pragma unroll
      for (int c = 0; c < E; ++c) dst[lane + 32 * c] = from_f<TQ>(acc[i][c] * l_inv);
    }
  }
}

// A call's arguments, as the wrapper passes them; window 0 and cap 0 are off.
struct Call {
  const void *q, *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  const int *lengths, *table;
  void* out;
  int b, sq, hq, hkv, total_pages, ps_shift, pages_per_seq;
  float scale;
  int window;
  float cap;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, bool kWindow, bool kCap>
int launch(const Call& c) {
  const size_t smem = kWarps * WarpSmem<D>::kFloats * sizeof(float);
  auto kernel = paged_attention_kernel<TQ, TKV, D, kWindow, kCap>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile_rows = kWarps * WarpSmem<D>::kRows;
  const int rows = c.sq * (c.hq / c.hkv);
  dim3 grid((rows + tile_rows - 1) / tile_rows, c.hkv, c.b);
  kernel<<<grid, kWarps * 32, smem, c.stream>>>(
      static_cast<const TQ*>(c.q), static_cast<const TKV*>(c.k_pages),
      static_cast<const TKV*>(c.v_pages), c.k_scales, c.v_scales, c.lengths, c.table,
      static_cast<TQ*>(c.out), c.sq, c.hq, c.hkv, c.total_pages, c.ps_shift,
      c.pages_per_seq, c.scale, c.window, c.cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int D>
int launch_opts(const Call& c) {
  if (c.window > 0)
    return c.cap > 0.f ? launch<TQ, TKV, D, true, true>(c) : launch<TQ, TKV, D, true, false>(c);
  return c.cap > 0.f ? launch<TQ, TKV, D, false, true>(c) : launch<TQ, TKV, D, false, false>(c);
}

template <typename TQ, typename TKV>
int launch_d(int d, const Call& c) {
  if (d == 64) return launch_opts<TQ, TKV, 64>(c);
  if (d == 128) return launch_opts<TQ, TKV, 128>(c);
  if (d == 256) return launch_opts<TQ, TKV, 256>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TQ>
int launch_kv(int kv_dtype, int d, const Call& c) {
  if (kv_dtype == 0 && c.k_scales == nullptr) return launch_d<TQ, float>(d, c);
  if (kv_dtype == 1 && c.k_scales == nullptr) return launch_d<TQ, __nv_bfloat16>(d, c);
  if (kv_dtype == 2 && c.k_scales != nullptr && c.v_scales != nullptr)
    return launch_d<TQ, int8_t>(d, c);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pages only, with fp32 scales
// [hkv, P, ps, 1]; null scales otherwise). window: the sliding window's width,
// 0 for none; softcap: the cap, 0 for none. Returns cudaGetLastError() of the
// launch (0 on success); the caller has validated shapes, dtypes and layout.
extern "C" int np_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scales, const void* v_scales,
                                  const int* lengths, const int* table, void* out,
                                  int q_dtype, int kv_dtype, int b, int sq, int hq,
                                  int hkv, int d, int total_pages, int ps_shift,
                                  int pages_per_seq, float scale, int window,
                                  float softcap, void* stream) {
  if (b == 0 || sq == 0) return 0;
  const Call c{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales), lengths, table, out, b, sq, hq, hkv,
               total_pages, ps_shift, pages_per_seq, scale, window, softcap,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return launch_kv<float>(kv_dtype, d, c);
  if (q_dtype == 1) return launch_kv<__nv_bfloat16>(kv_dtype, d, c);
  return static_cast<int>(cudaErrorInvalidValue);
}
