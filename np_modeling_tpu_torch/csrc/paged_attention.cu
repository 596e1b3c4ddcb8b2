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
//
// What bounds it. At decode each (sequence, kv head) reads 2*ctx*d*bytes of K/V
// once and does 4*ctx*d*g flops on them: a few flops per byte, far below the
// card's ratio, so device-memory bytes bound it. The design reads each page once
// per kv head and shares it among the g grouped q heads (and the sq query
// tokens of a prefill chunk), which all sit in the rows of one tile. It walks
// only the positions the tile can see (never past ceil(length/page_size) table
// entries or past the table's width), so a page past the tile's last row is
// never read.
//
// Layout. Grid (row tiles of <= 64 rows, kv heads, sequences); 4 warps a block.
// A warp owns up to 16 rows. When a tile has fewer rows than 4 warps can hold
// (decode: g rows), the spare warps split the key range instead and the partial
// (m, l, acc) are merged through shared memory at the end. Each warp stages
// blocks of 32 keys (one per lane for the scores) in its own shared memory, so
// the main loop needs no block-wide barrier. Plain FMA loops; wgmma, TMA and
// split-KV across blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 16;
constexpr int kTileRows = kWarps * kRowsPerWarp;
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

// Load E consecutive elements of type T (one 2-, 4-, 8- or 16-byte vector) as floats.
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  constexpr int kBytes = E * static_cast<int>(sizeof(T));
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

// Shared-memory floats of one warp: q rows, K block (rows padded by one
// float so that lane-per-key reads miss bank conflicts), V block, p block.
template <int D>
struct WarpSmem {
  static constexpr int kQ = kRowsPerWarp * D;
  static constexpr int kK = kKeys * (D + 1);
  static constexpr int kV = kKeys * D;
  static constexpr int kP = kRowsPerWarp * kKeys;
  static constexpr int kFloats = kQ + kK + kV + kP;
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                       const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales, const int* __restrict__ lengths,
                       const int* __restrict__ table, TQ* __restrict__ out, int sq,
                       int hq, int hkv, int total_pages, int ps_shift, int pages_per_seq,
                       float scale) {
  constexpr int E = D / 32;  // elements of a row per lane
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  using S = WarpSmem<D>;
  extern __shared__ float smem[];

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = hq / hkv;
  const int rows = sq * g;
  const int r0 = tile * kTileRows;
  const int n_rows = min(kTileRows, rows - r0);
  const int row_groups = (n_rows + kRowsPerWarp - 1) / kRowsPerWarp;  // 1..4
  const int key_splits = kWarps / row_groups;                          // 4, 2, 1, 1
  const int rg = warp % row_groups, ks = warp / row_groups;
  const bool idle = ks >= key_splits;  // the 4th warp when 3 row groups
  const int wr0 = r0 + rg * kRowsPerWarp;
  const int w_rows = idle ? 0 : min(kRowsPerWarp, r0 + n_rows - wr0);
  const int length = lengths[b];
  const int page_size = 1 << ps_shift;

  float* qs = smem + warp * S::kFloats;
  float* kst = qs + S::kQ;
  float* vst = kst + S::kK;
  float* pst = vst + S::kV;

  // Positions this warp's rows can see: [0, kv_end).
  int kv_end = 0;
  if (w_rows > 0) {
    const int own_last = length - sq + (wr0 + w_rows - 1) / g;
    kv_end = min(own_last + 1, pages_per_seq << ps_shift);
  }

  for (int i = 0; i < w_rows; ++i) {
    const int r = wr0 + i, t = r / g, j = r % g;
    const TQ* src = q + ((static_cast<size_t>(b) * sq + t) * hq + h * g + j) * D;
    load_vec<TQ, E>(src + lane * E, qs + i * D + lane * E);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][E];
  int own[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
    own[i] = length - sq + (wr0 + i) / g;
#pragma unroll
    for (int c = 0; c < E; ++c) acc[i][c] = 0.f;
  }
  const int* row_table = table + static_cast<size_t>(b) * pages_per_seq;

  for (int kb = ks * kKeys; kb < kv_end; kb += key_splits * kKeys) {
    // Lane kk resolves key kb+kk's page; the warp then stages row by row.
    const int my_pos = kb + lane;
    long long my_base = -1;
    float my_ks = 1.f, my_vs = 1.f;  // the key's scales (int8 pages)
    if (my_pos < kv_end) {
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
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      const long long base = __shfl_sync(kFull, my_base, kk);
      float kv[E], vv[E];
      if (base >= 0) {
        load_vec<TKV, E>(k_pages + base + lane * E, kv);
        load_vec<TKV, E>(v_pages + base + lane * E, vv);
        if constexpr (kInt8) {
          const float ks = __shfl_sync(kFull, my_ks, kk);
          const float vs = __shfl_sync(kFull, my_vs, kk);
#pragma unroll
          for (int c = 0; c < E; ++c) {
            kv[c] *= ks;
            vv[c] *= vs;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < E; ++c) kv[c] = vv[c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < E; ++c) {
        kst[kk * (D + 1) + lane * E + c] = kv[c];
        vst[kk * D + lane * E + c] = vv[c];
      }
    }
    __syncwarp();

    // Scores: lane = key, one accumulator per row.
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* krow = kst + lane * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        if (i < w_rows) s[i] = fmaf(qs[i * D + d], kd, s[i]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (i < w_rows) {
        const float si = (my_pos <= own[i] && my_pos < kv_end) ? s[i] * scale : kMaskValue;
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

    // acc[i][c] (column lane + 32c) += sum_k p[i][k] * v[k][lane + 32c].
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float vcol[E];
#pragma unroll
      for (int c = 0; c < E; ++c) vcol[c] = vst[kk * D + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
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
    for (int i = 0; i < kRowsPerWarp; ++i) {
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
        for (int i = 0; i < kRowsPerWarp; ++i) {
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
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (i < w_rows) {
      const int r = wr0 + i, t = r / g, j = r % g;
      TQ* dst = out + ((static_cast<size_t>(b) * sq + t) * hq + h * g + j) * D;
      const float l_inv = l[i] == 0.f ? 1.f : 1.f / l[i];
#pragma unroll
      for (int c = 0; c < E; ++c) dst[lane + 32 * c] = from_f<TQ>(acc[i][c] * l_inv);
    }
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k_pages, const void* v_pages, const float* k_scales,
           const float* v_scales, const int* lengths, const int* table, void* out, int b,
           int sq, int hq, int hkv, int total_pages, int ps_shift, int pages_per_seq,
           float scale, cudaStream_t stream) {
  const size_t smem = kWarps * WarpSmem<D>::kFloats * sizeof(float);
  auto kernel = paged_attention_kernel<TQ, TKV, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = sq * (hq / hkv);
  dim3 grid((rows + kTileRows - 1) / kTileRows, hkv, b);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), k_scales, v_scales, lengths, table,
      static_cast<TQ*>(out), sq, hq, hkv, total_pages, ps_shift, pages_per_seq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_d(int d, const void* q, const void* k_pages, const void* v_pages,
             const float* k_scales, const float* v_scales, const int* lengths,
             const int* table, void* out, int b, int sq, int hq, int hkv, int total_pages,
             int ps_shift, int pages_per_seq, float scale, cudaStream_t stream) {
  if (d == 64)
    return launch<TQ, TKV, 64>(q, k_pages, v_pages, k_scales, v_scales, lengths, table, out,
                               b, sq, hq, hkv, total_pages, ps_shift, pages_per_seq, scale,
                               stream);
  if (d == 128)
    return launch<TQ, TKV, 128>(q, k_pages, v_pages, k_scales, v_scales, lengths, table,
                                out, b, sq, hq, hkv, total_pages, ps_shift, pages_per_seq,
                                scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TQ>
int launch_kv(int kv_dtype, int d, const void* q, const void* k_pages, const void* v_pages,
              const float* k_scales, const float* v_scales, const int* lengths,
              const int* table, void* out, int b, int sq, int hq, int hkv, int total_pages,
              int ps_shift, int pages_per_seq, float scale, cudaStream_t stream) {
  if (kv_dtype == 0)
    return launch_d<TQ, float>(d, q, k_pages, v_pages, nullptr, nullptr, lengths, table,
                               out, b, sq, hq, hkv, total_pages, ps_shift, pages_per_seq,
                               scale, stream);
  if (kv_dtype == 1)
    return launch_d<TQ, __nv_bfloat16>(d, q, k_pages, v_pages, nullptr, nullptr, lengths,
                                       table, out, b, sq, hq, hkv, total_pages, ps_shift,
                                       pages_per_seq, scale, stream);
  if (kv_dtype == 2 && k_scales != nullptr && v_scales != nullptr)
    return launch_d<TQ, int8_t>(d, q, k_pages, v_pages, k_scales, v_scales, lengths, table,
                                out, b, sq, hq, hkv, total_pages, ps_shift, pages_per_seq,
                                scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pages only, with fp32 scales
// [hkv, P, ps, 1]; null scales otherwise). Returns cudaGetLastError() of the launch
// (0 on success); the caller has validated shapes, dtypes and layout.
extern "C" int np_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scales, const void* v_scales,
                                  const int* lengths, const int* table, void* out,
                                  int q_dtype, int kv_dtype, int b, int sq, int hq,
                                  int hkv, int d, int total_pages, int ps_shift,
                                  int pages_per_seq, float scale, void* stream) {
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  if (q_dtype == 0)
    return launch_kv<float>(kv_dtype, d, q, k_pages, v_pages, ks, vs, lengths, table, out, b,
                            sq, hq, hkv, total_pages, ps_shift, pages_per_seq, scale, s);
  if (q_dtype == 1)
    return launch_kv<__nv_bfloat16>(kv_dtype, d, q, k_pages, v_pages, ks, vs, lengths, table,
                                    out, b, sq, hq, hkv, total_pages, ps_shift,
                                    pages_per_seq, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
