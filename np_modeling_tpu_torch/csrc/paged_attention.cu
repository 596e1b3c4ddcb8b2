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
// each key and value row is dequantized in fp32 as int8 * scale[token], as the TPU
// kernel does (:272-278), and p then stays fp32 (JAX's p.astype(v.dtype) with v
// dequantized to fp32). int8 pages halve the bytes of bf16 pages.
// A sequence with length 0 stores 0 (the l == 0 guard of the TPU kernel).
// Two options are template parameters, so that a call without them runs the
// code it ran before they existed: the softcap (Gemma-2) replaces each scaled
// score s by cap * tanh(s / cap) before the mask (:286-287), and the sliding
// window keeps, for a row at position own, only pos > own - window (:297-298).
//
// What bounds it. At decode each (sequence, kv head) reads 2*ctx*d*bytes of K/V
// once and does 4*ctx*d*g flops on them: a few flops per byte, far below the
// card's ratio, so device-memory bytes bound it: Gemma-2's decode reads ~35 MB a
// layer, 0.0103 ms at 3.35 TB/s (H100 SXM, 700 W). Reaching that needs every SM
// busy and megabytes in flight. At decode one (sequence, kv head) pair has g = 1
// or 2 rows, so a grid of pairs alone gives 32 blocks for Gemma-2's 8 x 4 pairs on
// 132 SMs. The design:
// - Split-KV across blocks (flash-decoding). The grid is (splits x row tiles, kv
//   heads, sequences); block `split` walks keys [split * split_keys, + split_keys),
//   a page-aligned range. The caller sizes the splits from the table's width
//   (pages_per_seq * page_size), never from lengths (they live on the card, and
//   reading them would cost the host a sync a layer). A block whose range lies past
//   its sequence's length, or wholly below its rows' window band (the TPU kernel's
//   should_run, :263-266), exits at once without reading the table or a page, and
//   marks its partial empty (l = 0). With more than one split each block writes its
//   rows' partial (m, l, acc; fp32) to scratch and paged_attention_merge combines a
//   row's partials into o; with one split the block writes o itself.
// - Pages in flight. Keys stream in blocks of kKb (32; 16 for fp32 chunk rows at d 256)
//   through a ring of kStages = 3 stages in shared memory, each with its own K and
//   V buffers: every thread issues 16-byte cp.async copies of the rows (their table
//   entries read as the copies are issued, a ring ahead of the compute), so two
//   key blocks' copies are in flight while the warps compute on a third. Rows keep
//   the page dtype in shared memory (bf16 stays bf16).
// - Compute sized to the real rows. The scores take 8 lanes a key (a lane holds an
//   eighth of the head dims; 3 shuffles sum a score), 4 keys a warp at once, so 8
//   lanes read one key's contiguous bytes and (q stored permuted) 128 contiguous
//   bytes of the fp32 q row: no bank conflicts, no per-key shuffle loop. p.v takes
//   lanes across the head dims. A row tile of up to 2 rows (decode: g rows) has 8
//   warps split each key block (merged in shared memory at the end); larger tiles
//   (chunked prefill, 64 rows, 32 at d 256) have each of 4 warps own 16 (8) rows
//   over all of a key block's keys.
//   Loops run over the tile's row count, 2 at decode. Arithmetic is fp32 FMA for
//   every page dtype (JAX's fp32 dequantize semantics for int8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;  // of a chunk block and of the merge kernel
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;  // key blocks in the ring
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
// vector, or (past 16 bytes) two halves.
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A call's arguments; window 0 and cap 0 are off. part_acc [b, hkv, splits, rows, D]
// and part_ml [b, hkv, splits, rows, 2] (m, l) are the split partials (splits > 1).
struct Args {
  const void *q, *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  const int *lengths, *table;
  void* out;
  float *part_acc, *part_ml;
  int b, sq, hq, hkv, total_pages, ps_shift, pages_per_seq, splits, split_keys;
  float scale;
  int window;
  float cap;
};

// The shape of a variant: RW rows a warp; kRowSplit: the warps own rows (a tile of
// 4 RW rows, every warp over every key) or share them (a tile of RW rows, the warps
// splitting each key block).
template <typename TKV, int D, int RW, bool kRowSplit>
struct Shape {
  // Warps a block: 4 that own rows, or 8 that share a decode's rows (more warps to
  // hide the latency of each key block's short dependent chains).
  static constexpr int kWarps = kRowSplit ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  // Keys a ring stage: 32, or 16 for fp32 chunk rows at d 256 (shared memory).
  static constexpr int kKb = kRowSplit && D * sizeof(TKV) > 512 ? 16 : 32;
  static constexpr int kWk = kRowSplit ? kKb : kKb / kWarps;   // a warp's keys a stage
  static constexpr int kRows = kRowSplit ? kWarps * RW : RW;   // rows a block
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(TKV));
  static constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  // A stage: K rows, V rows, then (int8) the keys' K and V scales.
  static constexpr int kStageBytes = (2 * kKb * kRowBytes + (kInt8 ? 8 * kKb : 0) + 127) / 128 * 128;
  // Score loads: EV elements a lane at a time (16 bytes of the key row, or 8 for
  // int8 at d 64), J of them: the 8 lanes of a key read its row's contiguous bytes.
  // q is stored permuted (q_slot) so that their fp32 q reads are contiguous too: no
  // bank conflict on either.
  static constexpr int kEv = 16 / static_cast<int>(sizeof(TKV)) < D / 8
                                 ? 16 / static_cast<int>(sizeof(TKV)) : D / 8;
  static constexpr int kJ = D / 8 / kEv;
  // Keys a lane group scores at once (each q load serves them all): the chunk
  // variant's rows reread q for every key, so it takes 4 (d 64) or 2 (d 128).
  static constexpr int kNk = kWk < 8 ? 1 : D <= 64 ? 4 : D <= 128 ? 2 : 1;
  static constexpr int kQBytes = kRows * D * 4;         // q rows, fp32
  static constexpr int kPBytes = kWarps * RW * kWk * 4;  // each warp's p block
  // The cross-warp merge ((m, l, acc) of each warp's rows) reuses the ring.
  static constexpr int kBytes = kStages * kStageBytes + kQBytes + kPBytes;
  static_assert(kRowSplit || kWarps * RW * (D + 2) * 4 <= kStages * kStageBytes,
                "merge area");
};

// Where head dim e of a q row is stored: e = (8 j + pt) EV + 4 h + w (lane part pt,
// load j, 4-float group h) goes to ((j EV / 4 + h) 8 + pt) 4 + w, so that the 8
// lanes of a key read 128 contiguous bytes for each group.
template <int EV>
__device__ __forceinline__ int q_slot(int e) {
  const int pt = (e / EV) % 8, j = e / (8 * EV), h = (e % EV) / 4, w = e % 4;
  return ((j * (EV / 4) + h) * 8 + pt) * 4 + w;
}

template <typename TQ, typename TKV, int D, int RW, bool kRowSplit, bool kWindow, bool kCap>
__global__ void __launch_bounds__(Shape<TKV, D, RW, kRowSplit>::kThreads)
    paged_attention_kernel(const Args a) {
  using S = Shape<TKV, D, RW, kRowSplit>;
  constexpr int KB = S::kKb, WK = S::kWk, EV = S::kEv, J = S::kJ, E = D / 32;
  constexpr int NT = S::kThreads, NW = S::kWarps, NK = S::kNk;
  constexpr bool kInt8 = S::kInt8;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* stages = smem;
  float* qs = reinterpret_cast<float*>(smem + kStages * S::kStageBytes);
  float* pbuf = qs + S::kRows * D;

  const int split = blockIdx.x % a.splits, tile = blockIdx.x / a.splits;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = a.hq / a.hkv, rows = a.sq * g;
  const int r0 = tile * S::kRows, n_rows = min(S::kRows, rows - r0);
  const int length = a.lengths[b];
  const int page_size = 1 << a.ps_shift;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // The keys the tile's rows see, cut to this split's range: [lo, hi).
  const int own_first = length - a.sq + r0 / g, own_last = length - a.sq + (r0 + n_rows - 1) / g;
  const int hi = min(min(own_last + 1, a.pages_per_seq << a.ps_shift), (split + 1) * a.split_keys);
  int lo = split * a.split_keys;
  if constexpr (kWindow) lo = max(lo, own_first - a.window + 1);
  const long long part_row0 =
      ((static_cast<long long>(b) * a.hkv + h) * a.splits + split) * rows + r0;
  if (hi <= lo) {  // should_run is false: no table entry or page is read
    if (a.splits == 1) {
      for (int i = threadIdx.x; i < n_rows * D; i += NT) {
        const int r = r0 + i / D, t = r / g, j = r % g;
        static_cast<TQ*>(a.out)[((static_cast<size_t>(b) * a.sq + t) * a.hq + h * g + j) * D +
                                i % D] = from_f<TQ>(0.f);
      }
    } else {
      for (int i = threadIdx.x; i < n_rows; i += NT) {
        a.part_ml[(part_row0 + i) * 2] = kMaskValue;
        a.part_ml[(part_row0 + i) * 2 + 1] = 0.f;
      }
    }
    return;
  }

  const TKV* k_pages = static_cast<const TKV*>(a.k_pages);
  const TKV* v_pages = static_cast<const TKV*>(a.v_pages);
  const int* row_table = a.table + static_cast<size_t>(b) * a.pages_per_seq;
  const int kstart = lo & ~(KB - 1);
  const int n_kb = (hi - kstart + KB - 1) / KB;

  // Key block `it` into its stage, one cp.async group (an empty one past the last
  // block, so that every iteration commits one). Keys outside [lo, hi) are zeros.
  auto issue = [&](int it) {
    if (it < n_kb) {
      uint8_t* st = stages + (it % kStages) * S::kStageBytes;
      const int kb0 = kstart + it * KB;
      constexpr int CPR = S::kRowBytes / 16;  // 16-byte chunks a row
      for (int c = threadIdx.x; c < 2 * KB * CPR; c += NT) {
        const int which = c / (KB * CPR), kk = (c % (KB * CPR)) / CPR, ch = c % CPR;
        const int pos = kb0 + kk;
        const bool live = pos >= lo && pos < hi;
        const TKV* src = which ? v_pages : k_pages;
        if (live) {
          const long long token =
              (static_cast<long long>(h) * a.total_pages + __ldg(row_table + (pos >> a.ps_shift))) *
                  page_size + (pos & (page_size - 1));
          src += token * D + ch * (16 / static_cast<int>(sizeof(TKV)));
        }
        cp_async16(smem_u32(st + which * KB * S::kRowBytes + (kk * CPR + ch) * 16), src,
                   live ? 16 : 0);
      }
      if constexpr (kInt8) {
        float* scl = reinterpret_cast<float*>(st + 2 * KB * S::kRowBytes);
        for (int c = threadIdx.x; c < 2 * KB; c += NT) {
          const int pos = kb0 + c % KB;
          const bool live = pos >= lo && pos < hi;
          const float* src = c < KB ? a.k_scales : a.v_scales;
          if (live)
            src += (static_cast<long long>(h) * a.total_pages +
                    __ldg(row_table + (pos >> a.ps_shift))) * page_size +
                   (pos & (page_size - 1));
          cp_async4(smem_u32(scl + c), src, live ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // q rows of the tile, fp32, while the first key blocks land.
  for (int i = threadIdx.x; i < S::kRows * D; i += NT) {
    const int r = r0 + i / D;
    float x = 0.f;
    if (r < rows) {
      const int t = r / g, j = r % g;
      x = to_f(static_cast<const TQ*>(a.q)[((static_cast<size_t>(b) * a.sq + t) * a.hq + h * g + j) *
                                               D + i % D]);
    }
    qs[(i / D) * D + q_slot<EV>(i % D)] = x;
  }

  // This warp's rows: [wr0, wr0 + w_rows).
  const int wr0 = r0 + (kRowSplit ? warp * RW : 0);
  const int w_rows = kRowSplit ? max(0, min(RW, n_rows - warp * RW)) : n_rows;
  const float* qw = qs + (wr0 - r0) * D;
  float* pw = pbuf + warp * RW * WK;
  const int kg = lane >> 3, pt = lane & 7;  // scores: key group, part of the row
  const int kw0 = kRowSplit ? 0 : warp * WK;  // the warp's first key of a block
  const float inv_cap = kCap ? 1.f / a.cap : 0.f;

  float m[RW], l[RW], acc[RW][E];
  int own[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
    own[i] = length - a.sq + (wr0 + i) / g;
#pragma unroll
    for (int u = 0; u < E; ++u) acc[i][u] = 0.f;
  }

  for (int it = 0; it < n_kb; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // block it has landed (and q); every read of block it - 1 is done
    issue(it + kStages - 1);
    const uint8_t* st = stages + (it % kStages) * S::kStageBytes;
    const TKV* kst = reinterpret_cast<const TKV*>(st);
    const TKV* vst = kst + KB * D;
    const float* kscl = reinterpret_cast<const float*>(st + 2 * KB * S::kRowBytes);
    const int kb0 = kstart + it * KB;

    // Scores of the warp's WK keys, 4 NK at a time (8 lanes a key, NK keys a lane
    // group, so that each q load serves NK keys), into pw (scaled, capped, masked by
    // position). Local key kp 4 NK + 4 n + kg.
#pragma unroll
    for (int kp = 0; kp < WK / (4 * NK); ++kp) {
      float kf[NK][D / 8];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int kl = kw0 + 4 * (kp * NK + n) + kg;
#pragma unroll
        for (int j = 0; j < J; ++j)
          load_vec<TKV, EV>(kst + kl * D + (8 * j + pt) * EV, kf[n] + j * EV);
        if constexpr (kInt8) {
          const float ks = kscl[kl];
#pragma unroll
          for (int e = 0; e < D / 8; ++e) kf[n][e] *= ks;
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (i < w_rows) {
          float s[NK];
#pragma unroll
          for (int n = 0; n < NK; ++n) s[n] = 0.f;
#pragma unroll
          for (int j = 0; j < J; ++j)
#pragma unroll
            for (int h = 0; h < EV / 4; ++h) {
              const float4 qv = *reinterpret_cast<const float4*>(
                  qw + i * D + ((j * (EV / 4) + h) * 8 + pt) * 4);
#pragma unroll
              for (int n = 0; n < NK; ++n) {
                const float* kv = kf[n] + j * EV + 4 * h;
                s[n] = fmaf(qv.x, kv[0], s[n]);
                s[n] = fmaf(qv.y, kv[1], s[n]);
                s[n] = fmaf(qv.z, kv[2], s[n]);
                s[n] = fmaf(qv.w, kv[3], s[n]);
              }
            }
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            float x = s[n];
            x += __shfl_xor_sync(kFull, x, 1);
            x += __shfl_xor_sync(kFull, x, 2);
            x += __shfl_xor_sync(kFull, x, 4);
            x *= a.scale;
            if constexpr (kCap) x = a.cap * tanhf(x * inv_cap);
            const int lk = 4 * (kp * NK + n) + kg, pos = kb0 + kw0 + lk;
            bool keep = pos <= own[i];
            if constexpr (kWindow) keep = keep && pos > own[i] - a.window;
            if (pt == 0) pw[i * WK + lk] = keep ? x : kMaskValue;
          }
        }
      }
    }
    __syncwarp();
    // The online softmax over the warp's keys, lane = key; keys outside [lo, hi)
    // (zeros in the ring) add p = 0. p is rounded to the page dtype in pw.
    const int pos = kb0 + kw0 + lane;
    const bool valid = lane < WK && pos >= lo && pos < hi;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (i < w_rows) {
        const float x = valid ? pw[i * WK + lane] : kMaskValue;
        const float m_next = fmaxf(m[i], warp_max(x));
        const float alpha = expf(m[i] - m_next);
        const float pe = valid ? expf(x - m_next) : 0.f;
        l[i] = alpha * l[i] + warp_sum(pe);
        m[i] = m_next;
#pragma unroll
        for (int u = 0; u < E; ++u) acc[i][u] *= alpha;
        if (lane < WK) pw[i * WK + lane] = to_f(from_f<typename PType<TKV>::type>(pe));
      }
    }
    __syncwarp();
    // acc[i][lane E ..] += sum_k p[i][k] v[k][lane E ..], 4 keys a step (one 16-byte
    // read of a row's p).
#pragma unroll 2
    for (int k4 = 0; k4 < WK; k4 += 4) {
      float vf[4][E];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        load_vec<TKV, E>(vst + (kw0 + k4 + n) * D + lane * E, vf[n]);
        if constexpr (kInt8) {
          const float vs = kscl[KB + kw0 + k4 + n];
#pragma unroll
          for (int u = 0; u < E; ++u) vf[n][u] *= vs;
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (i < w_rows) {
          const float4 pr = *reinterpret_cast<const float4*>(pw + i * WK + k4);
#pragma unroll
          for (int u = 0; u < E; ++u) {
            acc[i][u] = fmaf(pr.x, vf[0][u], acc[i][u]);
            acc[i][u] = fmaf(pr.y, vf[1][u], acc[i][u]);
            acc[i][u] = fmaf(pr.z, vf[2][u], acc[i][u]);
            acc[i][u] = fmaf(pr.w, vf[3][u], acc[i][u]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (!kRowSplit) {
    // The warps split the keys: each publishes (m, l, acc) of the rows, warp 0 merges.
    __syncthreads();  // every read of the ring is done
    float* mrg = reinterpret_cast<float*>(stages) + warp * RW * (D + 2);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (i < w_rows) {
#pragma unroll
        for (int u = 0; u < E; ++u) mrg[i * (D + 2) + lane * E + u] = acc[i][u];
        if (lane == 0) {
          mrg[i * (D + 2) + D] = m[i];
          mrg[i * (D + 2) + D + 1] = l[i];
        }
      }
    }
    __syncthreads();
    if (warp != 0) return;
    for (int w = 1; w < NW; ++w) {
      const float* other = reinterpret_cast<const float*>(stages) + w * RW * (D + 2);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (i < w_rows) {
          const float m2 = other[i * (D + 2) + D], l2 = other[i * (D + 2) + D + 1];
          const float mn = fmaxf(m[i], m2);
          const float a1 = expf(m[i] - mn), a2 = expf(m2 - mn);
          l[i] = a1 * l[i] + a2 * l2;
          m[i] = mn;
#pragma unroll
          for (int u = 0; u < E; ++u)
            acc[i][u] = a1 * acc[i][u] + a2 * other[i * (D + 2) + lane * E + u];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (i < w_rows) {
      const int r = wr0 + i;
      if (a.splits == 1) {
        const int t = r / g, j = r % g;
        TQ* dst = static_cast<TQ*>(a.out) +
                  ((static_cast<size_t>(b) * a.sq + t) * a.hq + h * g + j) * D + lane * E;
        const float l_inv = l[i] == 0.f ? 1.f : 1.f / l[i];
#pragma unroll
        for (int u = 0; u < E; ++u) dst[u] = from_f<TQ>(acc[i][u] * l_inv);
      } else {
        const long long pr = part_row0 + (r - r0);
        float* dst = a.part_acc + pr * D + lane * E;
#pragma unroll
        for (int u = 0; u < E; ++u) dst[u] = acc[i][u];
        if (lane == 0) {
          a.part_ml[pr * 2] = m[i];
          a.part_ml[pr * 2 + 1] = l[i];
        }
      }
    }
  }
}

// A row's split partials into o: a warp a row, grid (row quads, kv heads, sequences).
// The lanes read the splits' (m, l) side by side (32 at a time) and agree on m and
// the weights by shuffles; then each non-empty split's acc is added, the loads
// independent of one another. Empty partials (l = 0) are skipped unread; a row
// with none stores 0.
template <typename TQ, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_merge(const Args a) {
  constexpr int E = D / 32;
  const int g = a.hq / a.hkv, rows = a.sq * g;
  const int r = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  if (r >= rows) return;  // uniform over the warp
  const long long base = (static_cast<long long>(b) * a.hkv + h) * a.splits * rows + r;
  float mx = kMaskValue;
  for (int s0 = 0; s0 < a.splits; s0 += 32) {
    const long long pr = base + static_cast<long long>(s0 + lane) * rows;
    if (s0 + lane < a.splits && a.part_ml[pr * 2 + 1] > 0.f) mx = fmaxf(mx, a.part_ml[pr * 2]);
  }
  mx = warp_max(mx);
  float acc[E], lsum = 0.f;
#pragma unroll
  for (int u = 0; u < E; ++u) acc[u] = 0.f;
  for (int s0 = 0; s0 < a.splits; s0 += 32) {
    const long long pr = base + static_cast<long long>(s0 + lane) * rows;
    float w = 0.f;  // this lane's split's weight, 0 where empty
    if (s0 + lane < a.splits) {
      const float ls = a.part_ml[pr * 2 + 1];
      if (ls > 0.f) {
        w = expf(a.part_ml[pr * 2] - mx);
        lsum += w * ls;
      }
    }
    const unsigned live = __ballot_sync(kFull, w > 0.f);
    for (unsigned m = live; m != 0; m &= m - 1) {
      const int sl = __ffs(m) - 1;
      const float ws = __shfl_sync(kFull, w, sl);
      float x[E];
      load_vec<float, E>(
          a.part_acc + (base + static_cast<long long>(s0 + sl) * rows) * D + lane * E, x);
#pragma unroll
      for (int u = 0; u < E; ++u) acc[u] = fmaf(ws, x[u], acc[u]);
    }
  }
  lsum = warp_sum(lsum);
  const float l_inv = lsum == 0.f ? 1.f : 1.f / lsum;
  const int t = r / g, j = r % g;
  TQ* dst = static_cast<TQ*>(a.out) + ((static_cast<size_t>(b) * a.sq + t) * a.hq + h * g + j) * D +
            lane * E;
#pragma unroll
  for (int u = 0; u < E; ++u) dst[u] = from_f<TQ>(acc[u] * l_inv);
}

template <typename TQ, typename TKV, int D, int RW, bool kRowSplit, bool kWindow, bool kCap>
int launch_variant(const Args& a, cudaStream_t stream) {
  using S = Shape<TKV, D, RW, kRowSplit>;
  auto kernel = paged_attention_kernel<TQ, TKV, D, RW, kRowSplit, kWindow, kCap>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = a.sq * (a.hq / a.hkv);
  const dim3 grid(((rows + S::kRows - 1) / S::kRows) * a.splits, a.hkv, a.b);
  kernel<<<grid, S::kThreads, S::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  paged_attention_merge<TQ, D><<<dim3((rows + kWarps - 1) / kWarps, a.hkv, a.b), kThreads, 0,
                              stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Row tiles of up to 2 rows (decode) share the rows among the warps; larger ones
// give each warp 16 rows (8 at d 256). The wrapper's split plan assumes these tiles.
template <typename TQ, typename TKV, int D, bool kWindow, bool kCap>
int launch(const Args& a, cudaStream_t stream) {
  if (a.sq * (a.hq / a.hkv) <= 2)
    return launch_variant<TQ, TKV, D, 2, false, kWindow, kCap>(a, stream);
  return launch_variant<TQ, TKV, D, (D > 128 ? 8 : 16), true, kWindow, kCap>(a, stream);
}

template <typename TQ, typename TKV, int D>
int launch_opts(const Args& a, cudaStream_t s) {
  if (a.window > 0)
    return a.cap > 0.f ? launch<TQ, TKV, D, true, true>(a, s)
                       : launch<TQ, TKV, D, true, false>(a, s);
  return a.cap > 0.f ? launch<TQ, TKV, D, false, true>(a, s)
                     : launch<TQ, TKV, D, false, false>(a, s);
}

template <typename TQ, typename TKV>
int launch_d(int d, const Args& a, cudaStream_t s) {
  if (d == 64) return launch_opts<TQ, TKV, 64>(a, s);
  if (d == 128) return launch_opts<TQ, TKV, 128>(a, s);
  if (d == 256) return launch_opts<TQ, TKV, 256>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TQ>
int launch_kv(int kv_dtype, int d, const Args& a, cudaStream_t s) {
  if (kv_dtype == 0 && a.k_scales == nullptr) return launch_d<TQ, float>(d, a, s);
  if (kv_dtype == 1 && a.k_scales == nullptr) return launch_d<TQ, __nv_bfloat16>(d, a, s);
  if (kv_dtype == 2 && a.k_scales != nullptr && a.v_scales != nullptr)
    return launch_d<TQ, int8_t>(d, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pages only, with fp32 scales
// [hkv, P, ps, 1]; null scales otherwise). window: the sliding window's width,
// 0 for none; softcap: the cap, 0 for none. splits >= 1 key ranges of split_keys
// keys each (a multiple of 32 and of the page size); with splits > 1, part_acc
// (fp32 [b, hkv, splits, sq * hq / hkv, d]) and part_ml (fp32 [..., 2]) are the
// caller's scratch. Returns the first nonzero cudaGetLastError() of the launches
// (0 on success); the caller has validated shapes, dtypes and layout.
extern "C" int np_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scales, const void* v_scales,
                                  const int* lengths, const int* table, void* out,
                                  void* part_acc, void* part_ml, int q_dtype, int kv_dtype,
                                  int b, int sq, int hq, int hkv, int d, int total_pages,
                                  int ps_shift, int pages_per_seq, int splits, int split_keys,
                                  float scale, int window, float softcap, void* stream) {
  if (b == 0 || sq == 0) return 0;
  if (splits < 1 || split_keys < 1 || (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales), lengths, table, out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml), b, sq, hq, hkv,
               total_pages, ps_shift, pages_per_seq, splits, split_keys, scale, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return launch_kv<float>(kv_dtype, d, a, s);
  if (q_dtype == 1) return launch_kv<__nv_bfloat16>(kv_dtype, d, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
