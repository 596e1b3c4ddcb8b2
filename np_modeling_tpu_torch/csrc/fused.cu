// LayerNorm forward and backward (K8), dropout with an in-kernel generator (K7) and
// softmax cross-entropy with integer labels, forward and backward (K9), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of np_modeling_tpu/ops/fused.py:
//   LayerNorm forward   _ln_fwd_kernel  (:48, launched by layer_norm_fwd_pallas, call :90)
//   LayerNorm backward  _ln_bwd_kernel  (:58, launched by layer_norm_bwd_pallas, call :120)
//   dropout             _dropout_kernel (:310, call :329, via dropout_prng :346)
//   softmax-CE forward  _sxe_fwd_kernel (:153, call :234, via softmax_cross_entropy_fused)
//   softmax-CE backward _sxe_bwd_kernel (:189, call :284)
//
// K9 is at the end of this file, with its own note.
//
// What they compute. LayerNorm over the last axis of x [n, d] (fp32 or bf16),
// gamma and beta fp32 [d]: the fp32 mean, then the fp32 variance of x - mean
// (two passes over the row held in registers, never E[x^2] - mean^2), rstd =
// 1 / sqrt(var + eps), out = gamma * yhat + beta rounded once to x's dtype.
// The backward recomputes the statistics from (x, gamma), forms dyhat = dz *
// gamma and writes dx = rstd * (dyhat - mean(dyhat) - yhat * mean(dyhat *
// yhat)) in dz's dtype, and per-block fp32 partials of dgamma = sum(dz * yhat)
// and dbeta = sum(dz) [n_blocks, d], which a second kernel sums in block order
// (as JAX sums its per-tile partials, fused.py:143-144): partials, not atomics,
// so the result is the same from run to run. Dropout keeps element i when the uint32 that
// Philox4x32-10 gives it is below the threshold (1 - rate) * (2^32 - 1) and
// writes x / keep rounded once to x's dtype there, 0 elsewhere. Its bits are a
// pure function of (seed, i): the key is the 64-bit seed, the counter i / 4
// (one draw gives four elements' words), so the backward, which is the same
// kernel on dy with the same seed, draws the same mask and nothing is stored.
// The TPU kernel seeds the TPU's own generator per row tile; its bits cannot
// be reproduced here, so the port's plain version computes these same Philox
// bits in torch integer arithmetic, and kernel and plain agree bit for bit.
//
// What bounds them on this card. Both are a few flops per byte: device-memory
// bytes bound them (LayerNorm forward at [16384, 1024] bf16 moves 64 MB, about
// 20 us at 3.35 TB/s; dropout on [8, 1024, 768] bf16 25 MB, about 8 us; ten
// Philox rounds cost about as much integer work as that). The designs read
// each element once and write it once. The forward: a row lives in registers
// (at most 16 elements a thread, a power-of-two team of 32..512 threads a row,
// 16-byte vector loads where the row allows), its sums are warp shuffles plus
// one shared-memory step when a row spans several warps. Dropout reads and
// writes 16 bytes a thread and draws its bits in registers.
//
// The backward, d <= 1024 (every LayerNorm of the main paths: d 768 and 1024),
// layer_norm_bwd_warp: one warp owns a row, at up to 32 elements a lane, so
// every row sum (mean, variance, m1 and m2) is shuffles only and the row loop
// has no block barrier. The grid is persistent (ln_bwd_plan: at most two
// blocks of 8 warps an SM); each warp walks rows at a stride and, where rows
// are whole 16-byte vectors, copies the next row's x and dz into its own
// half of a shared-memory double buffer (cp.async) before it reduces the
// current one, so a warp keeps two rows in flight. Its dgamma/dbeta sums stay
// in registers across all its rows; at the end the block's warps are summed
// through shared memory in warp order into one [d] partial a block, and
// ln_bwd_reduce sums the blocks' partials in block order: the same bits on
// every run. d > 1024 keeps the row team of the forward (layer_norm_bwd, a
// power-of-two team of 64..512 threads a row, its dgamma/dbeta partials in
// registers across the rows a block walks), into the same partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "wgmma.cuh"  // cp.async

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kPer = 16;           // row elements a thread holds
constexpr int kMaxThreads = 512;   // threads of one row; d <= kPer * kMaxThreads
constexpr int kMinBlock = 128;     // short rows share a block of 4 warps
constexpr int kRedFloats = 2 * (kMaxThreads / 32);  // two sums for each warp

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// V consecutive elements as floats: one 16-byte vector when V elements are 16
// bytes, else V scalar loads.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = to_f(src[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* dst, const float* src) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(src[i]);
    *reinterpret_cast<uint4*>(dst) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = from_f<T>(src[i]);
  }
}

// V fp32 values of gamma or beta (16-byte loads when V is a multiple of 4).
template <int V>
__device__ __forceinline__ void load_f32(const float* src, float* dst) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(src + i);
      dst[i] = f.x;
      dst[i + 1] = f.y;
      dst[i + 2] = f.z;
      dst[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = src[i];
  }
}

// Sums each of K values over the t_row threads of a row (t_row a power of two
// >= 32, so a row's warps are whole and consecutive). Every thread of the row
// gets the same bits. Called by every thread of the block (it may sync).
template <int K>
__device__ __forceinline__ void row_sum(float (&s)[K], int t_row, float* red) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
  }
  if (t_row == 32) return;  // the same for the whole block
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = s[k];
  }
  __syncthreads();
  const int first = (threadIdx.x / t_row) * (t_row / 32);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = 0.f;
    for (int w = 0; w < t_row / 32; ++w) t += red[(first + w) * K + k];
    s[k] = t;
  }
  __syncthreads();
}

// Loads a row's elements (thread `lane` of t_row holds columns (c * t_row +
// lane) * V .. + V for c < kPer / V; 0 where the row has none) and returns
// their fp32 mean and rstd, computed in two passes.
template <typename T, int V>
__device__ __forceinline__ void row_stats(const T* xr, bool live, int d, int t_row, int lane,
                                          float eps, float* red, float (&v)[kPer],
                                          float& mean, float& rstd) {
  constexpr int kChunks = kPer / V;
  float s[1] = {0.f};
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * t_row + lane) * V;
    if (live && col < d) {
      load_vec<T, V>(xr + col, v + c * V);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[c * V + i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) s[0] += v[c * V + i];
  }
  row_sum<1>(s, t_row, red);
  mean = s[0] / d;
  float q[1] = {0.f};
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * t_row + lane) * V;
    if (live && col < d) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float t = v[c * V + i] - mean;
        q[0] += t * t;
      }
    }
  }
  row_sum<1>(q, t_row, red);
  rstd = 1.f / sqrtf(q[0] / d + eps);
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    layer_norm_fwd(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ out, long long n, int d,
                   int t_row, float eps) {
  constexpr int kChunks = kPer / V;
  __shared__ float red[kRedFloats];
  const int lane = threadIdx.x % t_row;
  const long long row = (long long)blockIdx.x * (blockDim.x / t_row) + threadIdx.x / t_row;
  const bool live = row < n;
  const long long base = (live ? row : 0) * (long long)d;
  float v[kPer];
  float mean, rstd;
  row_stats<T, V>(x + base, live, d, t_row, lane, eps, red, v, mean, rstd);
  if (!live) return;  // after the last barrier
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * t_row + lane) * V;
    if (col < d) {
      float g[V], b[V], o[V];
      load_f32<V>(gamma + col, g);
      load_f32<V>(beta + col, b);
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = g[i] * ((v[c * V + i] - mean) * rstd) + b[i];
      store_vec<T, V>(out + base + col, o);
    }
  }
}

// One block walks rows blockIdx.x * rpb + group, stepping by gridDim.x * rpb
// (rpb = rows a block holds at once). The loop's bound is the same for every
// thread of the block, as row_sum's barriers need.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    layer_norm_bwd(const T* __restrict__ x, const float* __restrict__ gamma,
                   const T* __restrict__ dz, T* __restrict__ dx, float* __restrict__ dg_part,
                   float* __restrict__ db_part, long long n, int d, int t_row, float eps) {
  constexpr int kChunks = kPer / V;
  extern __shared__ float smem[];
  float* red = smem;               // kRedFloats
  float* part = smem + kRedFloats;  // [rpb][2][d], only when rpb > 1
  const int rpb = blockDim.x / t_row;
  const int group = threadIdx.x / t_row;
  const int lane = threadIdx.x % t_row;
  float dg[kPer], db[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) dg[k] = db[k] = 0.f;

  for (long long first = (long long)blockIdx.x * rpb; first < n;
       first += (long long)gridDim.x * rpb) {
    const long long row = first + group;
    const bool live = row < n;
    const long long base = (live ? row : 0) * (long long)d;
    float v[kPer], g[kPer];
    float mean, rstd;
    row_stats<T, V>(x + base, live, d, t_row, lane, eps, red, v, mean, rstd);
    float m[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * t_row + lane) * V;
      if (live && col < d) {
        float gm[V];
        load_vec<T, V>(dz + base + col, g + c * V);
        load_f32<V>(gamma + col, gm);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int k = c * V + i;
          const float yhat = (v[k] - mean) * rstd;
          v[k] = yhat;
          dg[k] += g[k] * yhat;
          db[k] += g[k];
          g[k] *= gm[i];  // dyhat
          m[0] += g[k];
          m[1] += g[k] * yhat;
        }
      }
    }
    row_sum<2>(m, t_row, red);
    const float m1 = m[0] / d, m2 = m[1] / d;
    if (live) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = (c * t_row + lane) * V;
        if (col < d) {
          float o[V];
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const int k = c * V + i;
            o[i] = rstd * (g[k] - m1 - v[k] * m2);
          }
          store_vec<T, V>(dx + base + col, o);
        }
      }
    }
  }

  // The block's partials: its row groups are summed here, in a fixed order.
  const long long out = (long long)blockIdx.x * d;
  if (rpb == 1) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * t_row + lane) * V;
      if (col < d) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          dg_part[out + col + i] = dg[c * V + i];
          db_part[out + col + i] = db[c * V + i];
        }
      }
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * t_row + lane) * V;
    if (col < d) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        part[(2 * group) * d + col + i] = dg[c * V + i];
        part[(2 * group + 1) * d + col + i] = db[c * V + i];
      }
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < rpb; ++r) {
      a += part[(2 * r) * d + col];
      b += part[(2 * r + 1) * d + col];
    }
    dg_part[out + col] = a;
    db_part[out + col] = b;
  }
}

// ---- the backward for d <= 1024: a warp a row -------------------------------------

constexpr int kBwdWarps = 8;    // warps a block; each owns one row at a time
constexpr int kWarpElems = 32;  // row elements a lane holds at most: d <= 1024

// Sums over the warp's lanes; every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The warp kernel's shared memory before gamma: the rows' double buffers, 4 d
// elements a warp (16-byte rows only), or the block's [kBwdWarps][d] fp32 partial
// sums, whichever is larger (the sums reuse the buffers after the row loop).
template <typename T, int V>
__host__ __device__ constexpr size_t bwd_front_bytes(int d) {
  const size_t buf = V * sizeof(T) == 16 ? static_cast<size_t>(kBwdWarps) * 4 * d * sizeof(T) : 0;
  const size_t red = static_cast<size_t>(kBwdWarps) * d * sizeof(float);
  return buf > red ? buf : red;
}

// Lane `lane` holds columns (c * 32 + lane) * V .. + V for c < kWarpElems / V. With
// 16-byte vectors (V * sizeof(T) == 16: x, dz and dx 16-byte aligned, d a multiple
// of V) each warp double-buffers its rows in shared memory: slot s of warp w holds
// x at smem + (4 w + 2 s) d and dz d elements after it, each lane copying (cp.async)
// and reading back its own chunks only, so no barrier orders them: the warp copies
// its next row while it reduces this one (two rows in flight a warp). Otherwise the
// rows are read from device memory as they are needed. gamma is staged once a block,
// after the buffers. The loop has no block barrier: a warp whose rows run out leaves it.
template <typename T, int V>
__global__ void __launch_bounds__(kBwdWarps * 32, sizeof(T) == 2 ? 2 : 1)
    layer_norm_bwd_warp(const T* __restrict__ x, const float* __restrict__ gamma,
                        const T* __restrict__ dz, T* __restrict__ dx, float* __restrict__ part,
                        long long n, int d, float eps) {
  constexpr int kChunks = kWarpElems / V;
  constexpr bool kAsync = V * sizeof(T) == 16;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* buf = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * 4 * d;
  float* gs = reinterpret_cast<float*>(smem_raw + bwd_front_bytes<T, V>(d));
  float dg[kWarpElems], db[kWarpElems];
#pragma unroll
  for (int k = 0; k < kWarpElems; ++k) dg[k] = db[k] = 0.f;

  const long long stride = static_cast<long long>(gridDim.x) * kBwdWarps;
  long long row = static_cast<long long>(blockIdx.x) * kBwdWarps + warp;
  auto issue = [&](long long r, int slot) {  // row r's x and dz into `slot`
    T* bx = buf + 2 * slot * d;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * 32 + lane) * V;
      if (col < d) {
        wg::cp_async16(wg::smem_u32(bx + col), x + r * d + col, 16);
        wg::cp_async16(wg::smem_u32(bx + d + col), dz + r * d + col, 16);
      }
    }
  };
  if (kAsync && row < n) issue(row, 0);
  wg::cp_async_commit();
  for (int i = threadIdx.x; i < d; i += blockDim.x) gs[i] = gamma[i];
  __syncthreads();
  for (int slot = 0; row < n; row += stride, slot ^= 1) {
    if (kAsync) {
      if (row + stride < n) issue(row + stride, slot ^ 1);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();  // this row's copies have landed
    }
    const T* xr = kAsync ? buf + 2 * slot * d : x + row * d;
    const T* zr = kAsync ? xr + d : dz + row * d;
    float v[kWarpElems];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * 32 + lane) * V;
      if (col < d) {
        load_vec<T, V>(xr + col, v + c * V);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[c * V + i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) s += v[c * V + i];
    }
    const float mean = warp_sum(s) / d;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if ((c * 32 + lane) * V < d) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float t = v[c * V + i] - mean;
          q += t * t;
        }
      }
    }
    const float rstd = 1.f / sqrtf(warp_sum(q) / d + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * 32 + lane) * V;
      if (col < d) {
        float g[V], gm[V];
        load_vec<T, V>(zr + col, g);
        load_f32<V>(gs + col, gm);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int k = c * V + i;
          const float yhat = (v[k] - mean) * rstd;
          v[k] = yhat;
          dg[k] += g[i] * yhat;
          db[k] += g[i];
          const float dy = g[i] * gm[i];
          m1 += dy;
          m2 += dy * yhat;
        }
      }
    }
    m1 = warp_sum(m1) / d;
    m2 = warp_sum(m2) / d;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * 32 + lane) * V;
      if (col < d) {
        float g[V], gm[V], o[V];
        load_vec<T, V>(zr + col, g);  // dyhat again: dz * gamma
        load_f32<V>(gs + col, gm);
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] = rstd * (g[i] * gm[i] - m1 - v[c * V + i] * m2);
        store_vec<T, V>(dx + row * d + col, o);
      }
    }
  }
  wg::cp_async_wait<0>();

  // The block's partials, its warps summed in warp order: dgamma into part[0][block],
  // dbeta into part[1][block] ([2][gridDim.x][d]).
  float* red = reinterpret_cast<float*>(smem_raw);  // [kBwdWarps][d]
  for (int which = 0; which < 2; ++which) {
    __syncthreads();  // the double buffer, or the last pass's sums, are free
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * 32 + lane) * V;
      if (col < d) {
#pragma unroll
        for (int i = 0; i < V; ++i)
          red[warp * d + col + i] = which == 0 ? dg[c * V + i] : db[c * V + i];
      }
    }
    __syncthreads();
    float* dst = part + (static_cast<size_t>(which) * gridDim.x + blockIdx.x) * d;
    for (int col = threadIdx.x; col < d; col += blockDim.x) {
      float t = 0.f;
      for (int w = 0; w < kBwdWarps; ++w) t += red[w * d + col];
      dst[col] = t;
    }
  }
}

// sums[j][col] = the sum of part[j][b][col] over the blocks b, in a fixed order: warp
// w of a block of 32 sums b = w, w + 32, .. in that order for 32 consecutive (j, col),
// and the warps' sums are added in warp order.
constexpr int kReduceWarps = 32;

__global__ void __launch_bounds__(kReduceWarps * 32)
    ln_bwd_reduce(const float* __restrict__ part, float* __restrict__ sums, int blocks, int d) {
  __shared__ float red[kReduceWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;  // j * d + col
  float t = 0.f;
  if (i < 2 * d) {
    const float* p = part + static_cast<size_t>(i / d) * blocks * d + i % d;
    for (int b = warp; b < blocks; b += kReduceWarps) t += p[static_cast<size_t>(b) * d];
  }
  red[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && i < 2 * d) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) s += red[w][lane];
    sums[i] = s;
  }
}

// Each thread takes one 16-byte vector (4 fp32 or 8 bf16 elements) a step.
template <typename T>
__global__ void dropout(const T* __restrict__ x, T* __restrict__ out, long long n, uint32_t k0,
                        uint32_t k1, uint32_t threshold, float keep) {
  constexpr int E = 16 / sizeof(T);
  const long long n_vec = (n + E - 1) / E;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += (long long)gridDim.x * blockDim.x) {
    const long long i0 = v * E;
    uint32_t bits[E];
#pragma unroll
    for (int g = 0; g < E / 4; ++g) {
      const unsigned long long ctr = (unsigned long long)(i0 / 4 + g);
      const uint4 r = philox4x32_10((uint32_t)ctr, (uint32_t)(ctr >> 32), k0, k1);
      bits[4 * g] = r.x;
      bits[4 * g + 1] = r.y;
      bits[4 * g + 2] = r.z;
      bits[4 * g + 3] = r.w;
    }
    if (i0 + E <= n) {
      float xv[E];
      load_vec<T, E>(x + i0, xv);
#pragma unroll
      for (int e = 0; e < E; ++e) xv[e] = bits[e] < threshold ? xv[e] / keep : 0.f;
      store_vec<T, E>(out + i0, xv);
    } else {
      for (int e = 0; e < E && i0 + e < n; ++e)
        out[i0 + e] = from_f<T>(bits[e] < threshold ? to_f(x[i0 + e]) / keep : 0.f);
    }
  }
}


// ---- K9: softmax cross-entropy with integer labels ---------------------------------
//
// Forward: for each row of logits [n, v] (fp32 or bf16) and its int64 label, lse =
// log(sum(exp(logits))) in fp32 and ce = lse - logit[label], where a label outside
// [0, v) picks up nothing (ce = lse), as the TPU kernel's `hit = (col == label) &
// valid` never hits. Backward: dlogits = (exp(logit - lse) - onehot) * g, rounded once
// to the logits' dtype; only lse (fp32 [n]) is kept between the two.
//
// What bounds it: bytes. At the GPT-2 step's logits, [8192, 50257] bf16, the forward
// reads 823 MB (0.25 ms at 3.35 TB/s) and the backward reads and writes 1.65 GB
// (0.49 ms); one exp an element is far below the card's rate. So each element is read
// once: one block walks one row (the TPU kernel's sequential vocab grid becomes the
// block's loop), each thread keeps an online (max, sum of exp) over 16-byte vectors
// (one exp an element plus one a vector whose max rises), and the block merges the
// threads' pairs by shuffles and one shared-memory step. The row's label logit is one
// extra scalar load. A row of 50257 is not 16-byte aligned: the first elements up to
// the row's first 16-byte boundary and the last ragged ones go as scalars.

constexpr int kSxeThreads = 256;

// Row layout for vectors: the elements before the first 16-byte boundary (head), the
// whole vectors after it, and the elements after the last whole vector (from `tail`).
template <typename T>
__device__ __forceinline__ void row_split(const T* row, int v, int& head, int& n_vec,
                                          int& tail) {
  constexpr int E = 16 / sizeof(T);
  head = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / sizeof(T));
  if (head > v) head = v;
  n_vec = (v - head) / E;
  tail = head + n_vec * E;
}

// (m, l) <- the pair of (m, l) and (m2, l2): the larger max, sums rescaled to it.
__device__ __forceinline__ void lse_merge(float& m, float& l, float m2, float l2) {
  const float mx = fmaxf(m, m2);
  l = l * expf(m - mx) + l2 * expf(m2 - mx);
  m = mx;
}

__device__ __forceinline__ void lse_add(float& m, float& l, float x) {
  if (x > m) {
    l = l * expf(m - x) + 1.f;
    m = x;
  } else {
    l += expf(x - m);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSxeThreads)
    sxe_fwd(const T* __restrict__ logits, const long long* __restrict__ labels,
            float* __restrict__ ce, float* __restrict__ lse, int v) {
  constexpr int E = 16 / sizeof(T);
  __shared__ float red[2 * (kSxeThreads / 32)];
  const long long row = blockIdx.x;
  const T* x = logits + row * v;
  int head, n_vec, tail;
  row_split(x, v, head, n_vec, tail);
  // -1e30 as the TPU kernel's running max starts: -inf logits then add exp(-inf) = 0.
  float m = -1e30f, l = 0.f;
  for (int c = threadIdx.x; c < head; c += kSxeThreads) lse_add(m, l, to_f(x[c]));
  for (int i = threadIdx.x; i < n_vec; i += kSxeThreads) {
    float xv[E];
    load_vec<T, E>(x + head + i * E, xv);
    float cm = xv[0];
#pragma unroll
    for (int e = 1; e < E; ++e) cm = fmaxf(cm, xv[e]);
    if (cm > m) {
      l *= expf(m - cm);
      m = cm;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) l += expf(xv[e] - m);
  }
  for (int c = tail + threadIdx.x; c < v; c += kSxeThreads) lse_add(m, l, to_f(x[c]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    lse_merge(m, l, m2, l2);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[2 * warp] = m;
    red[2 * warp + 1] = l;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kSxeThreads / 32; ++w) lse_merge(m, l, red[2 * w], red[2 * w + 1]);
  const float s = m + logf(l);
  const long long label = labels[row];
  const float hit = (label >= 0 && label < v) ? to_f(x[label]) : 0.f;
  lse[row] = s;
  ce[row] = s - hit;
}

template <typename T>
__global__ void __launch_bounds__(kSxeThreads)
    sxe_bwd(const T* __restrict__ logits, const long long* __restrict__ labels,
            const float* __restrict__ lse, const float* __restrict__ g, T* __restrict__ dlogits,
            int v) {
  constexpr int E = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const T* x = logits + row * v;
  T* out = dlogits + row * v;
  const float s = lse[row], gr = g[row];
  const long long label = labels[row];
  int head, n_vec, tail;
  row_split(x, v, head, n_vec, tail);  // out's rows have x's alignment (checked)
  for (int c = threadIdx.x; c < head; c += kSxeThreads)
    out[c] = from_f<T>((expf(to_f(x[c]) - s) - (c == label ? 1.f : 0.f)) * gr);
  for (int i = threadIdx.x; i < n_vec; i += kSxeThreads) {
    const int c0 = head + i * E;
    float xv[E];
    load_vec<T, E>(x + c0, xv);
#pragma unroll
    for (int e = 0; e < E; ++e)
      xv[e] = (expf(xv[e] - s) - (c0 + e == label ? 1.f : 0.f)) * gr;
    store_vec<T, E>(out + c0, xv);
  }
  for (int c = tail + threadIdx.x; c < v; c += kSxeThreads)
    out[c] = from_f<T>((expf(to_f(x[c]) - s) - (c == label ? 1.f : 0.f)) * gr);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool bad_team(long long n, int d, int t_row) {
  return n < 0 || d < 1 || t_row < 32 || t_row > kMaxThreads || (t_row & (t_row - 1)) != 0 ||
         d > kPer * t_row;
}

int block_of(int t_row) { return t_row < kMinBlock ? kMinBlock : t_row; }

template <typename T, int V>
int launch_fwd(const void* x, const float* gamma, const float* beta, void* out, long long n,
               int d, int t_row, float eps, cudaStream_t stream) {
  const int block = block_of(t_row);
  const long long rpb = block / t_row;
  const long long grid = (n + rpb - 1) / rpb;
  layer_norm_fwd<T, V><<<(unsigned)grid, block, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(out), n, d, t_row, eps);
  return static_cast<int>(cudaGetLastError());
}

// The backward into part [2][n_blocks][d] (dgamma's partials, then dbeta's), then
// their fixed-order sum into sums [2][d]. t_row 32: a warp a row (d <= 1024), else
// the row team.
template <typename T, int V>
int launch_bwd(const void* x, const float* gamma, const void* dz, void* dx, float* part,
               float* sums, long long n, int d, int t_row, int n_blocks, float eps,
               cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dzt = static_cast<const T*>(dz);
  T* dxt = static_cast<T*>(dx);
  if (t_row == 32) {
    const size_t smem = bwd_front_bytes<T, V>(d) + static_cast<size_t>(d) * sizeof(float);
    auto kernel = layer_norm_bwd_warp<T, V>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_blocks, kBwdWarps * 32, smem, stream>>>(xt, gamma, dzt, dxt, part, n, d, eps);
  } else {
    const int block = block_of(t_row);
    const int rpb = block / t_row;
    const size_t smem = sizeof(float) * (kRedFloats + (rpb > 1 ? 2 * rpb * d : 0));
    layer_norm_bwd<T, V><<<n_blocks, block, smem, stream>>>(
        xt, gamma, dzt, dxt, part, part + static_cast<size_t>(n_blocks) * d, n, d, t_row, eps);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_reduce<<<(2 * d + 31) / 32, kReduceWarps * 32, 0, stream>>>(part, sums, n_blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. t_row: threads a row (a power of two, 32..512,
// with d <= 16 * t_row); rows are contiguous, gamma and beta fp32.
extern "C" int np_layer_norm_fwd(const void* x, const float* gamma, const float* beta, void* out,
                                 int dtype, long long n, int d, int t_row, float eps,
                                 void* stream) {
  if (bad_team(n, d, t_row)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(out) && aligned16(gamma) && aligned16(beta);
  if (dtype == 0 && vec && d % 4 == 0)
    return launch_fwd<float, 4>(x, gamma, beta, out, n, d, t_row, eps, s);
  if (dtype == 0) return launch_fwd<float, 1>(x, gamma, beta, out, n, d, t_row, eps, s);
  if (dtype == 1 && vec && d % 8 == 0)
    return launch_fwd<bf16, 8>(x, gamma, beta, out, n, d, t_row, eps, s);
  if (dtype == 1) return launch_fwd<bf16, 1>(x, gamma, beta, out, n, d, t_row, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dz and dx in x's dtype. t_row 32: a warp a row (d <= 1024, layer_norm_bwd_warp);
// otherwise the row team (d <= 16 t_row). part: fp32 [2][n_blocks][d], scratch that
// every block writes (n_blocks <= the number of rows, or of row groups of a team);
// sums: fp32 [2][d], dgamma then dbeta.
extern "C" int np_layer_norm_bwd(const void* x, const float* gamma, const void* dz, void* dx,
                                 float* part, float* sums, int dtype, long long n, int d,
                                 int t_row, int n_blocks, float eps, void* stream) {
  const bool bad =
      t_row == 32 ? n < 0 || d < 1 || d > 32 * kWarpElems : bad_team(n, d, t_row);
  if (bad || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(dz) && aligned16(dx) && aligned16(gamma);
  if (dtype == 0 && vec && d % 4 == 0)
    return launch_bwd<float, 4>(x, gamma, dz, dx, part, sums, n, d, t_row, n_blocks, eps, s);
  if (dtype == 0)
    return launch_bwd<float, 1>(x, gamma, dz, dx, part, sums, n, d, t_row, n_blocks, eps, s);
  if (dtype == 1 && vec && d % 8 == 0)
    return launch_bwd<bf16, 8>(x, gamma, dz, dx, part, sums, n, d, t_row, n_blocks, eps, s);
  if (dtype == 1)
    return launch_bwd<bf16, 1>(x, gamma, dz, dx, part, sums, n, d, t_row, n_blocks, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x and out contiguous and 16-byte aligned, n elements; seed's low and high
// words are Philox's key.
extern "C" int np_dropout(const void* x, void* out, int dtype, long long n,
                          unsigned long long seed, unsigned int threshold, float keep,
                          void* stream) {
  if (n < 0 || !aligned16(x) || !aligned16(out)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  const int e = dtype == 0 ? 4 : 8;
  const long long n_vec = (n + e - 1) / e;
  const int block = 256;
  long long grid = (n_vec + block - 1) / block;
  if (grid > 65535) grid = 65535;
  if (dtype == 0)
    dropout<float><<<(unsigned)grid, block, 0, s>>>(static_cast<const float*>(x),
                                                     static_cast<float*>(out), n, k0, k1,
                                                     threshold, keep);
  else if (dtype == 1)
    dropout<bf16><<<(unsigned)grid, block, 0, s>>>(static_cast<const bf16*>(x),
                                                   static_cast<bf16*>(out), n, k0, k1,
                                                   threshold, keep);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K9 forward: logits [n, v] contiguous (dtype 0 float32, 1 bfloat16), labels int64
// [n]; writes ce and lse, fp32 [n]. One block a row.
extern "C" int np_sxe_fwd(const void* logits, const long long* labels, float* ce, float* lse,
                          int dtype, long long n, int v, void* stream) {
  if (n < 0 || v < 1 || n > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    sxe_fwd<float><<<(unsigned)n, kSxeThreads, 0, s>>>(static_cast<const float*>(logits),
                                                         labels, ce, lse, v);
  else if (dtype == 1)
    sxe_fwd<bf16><<<(unsigned)n, kSxeThreads, 0, s>>>(static_cast<const bf16*>(logits),
                                                        labels, ce, lse, v);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K9 backward: dlogits [n, v] in the logits' dtype from logits, labels, lse and the
// fp32 row cotangents g [n]. dlogits must sit at the same offset from a 16-byte
// boundary as logits (the rows are split alike).
extern "C" int np_sxe_bwd(const void* logits, const long long* labels, const float* lse,
                          const float* g, void* dlogits, int dtype, long long n, int v,
                          void* stream) {
  if (n < 0 || v < 1 || n > 2147483647LL ||
      ((reinterpret_cast<uintptr_t>(logits) ^ reinterpret_cast<uintptr_t>(dlogits)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    sxe_bwd<float><<<(unsigned)n, kSxeThreads, 0, s>>>(static_cast<const float*>(logits),
                                                         labels, lse, g,
                                                         static_cast<float*>(dlogits), v);
  else if (dtype == 1)
    sxe_bwd<bf16><<<(unsigned)n, kSxeThreads, 0, s>>>(static_cast<const bf16*>(logits),
                                                        labels, lse, g,
                                                        static_cast<bf16*>(dlogits), v);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
