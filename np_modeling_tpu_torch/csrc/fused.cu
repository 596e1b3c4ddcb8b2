// LayerNorm forward and backward (K8) and dropout with an in-kernel generator
// (K7), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of np_modeling_tpu/ops/fused.py:
//   LayerNorm forward   _ln_fwd_kernel  (:48, launched by layer_norm_fwd_pallas, call :90)
//   LayerNorm backward  _ln_bwd_kernel  (:58, launched by layer_norm_bwd_pallas, call :120)
//   dropout             _dropout_kernel (:310, call :329, via dropout_prng :346)
//
// What they compute. LayerNorm over the last axis of x [n, d] (fp32 or bf16),
// gamma and beta fp32 [d]: the fp32 mean, then the fp32 variance of x - mean
// (two passes over the row held in registers, never E[x^2] - mean^2), rstd =
// 1 / sqrt(var + eps), out = gamma * yhat + beta rounded once to x's dtype.
// The backward recomputes the statistics from (x, gamma), forms dyhat = dz *
// gamma and writes dx = rstd * (dyhat - mean(dyhat) - yhat * mean(dyhat *
// yhat)) in dz's dtype, and per-block fp32 partials of dgamma = sum(dz * yhat)
// and dbeta = sum(dz) [n_blocks, d], which the caller sums (as JAX sums its
// per-tile partials, fused.py:143-144): partials, not atomics, so the result
// is the same from run to run. Dropout keeps element i when the uint32 that
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
// each element once and write it once: a row lives in registers (at most 16
// elements a thread, a power-of-two team of 32..512 threads a row, 16-byte
// vector loads where the row allows), its sums are warp shuffles plus one
// shared-memory step when a row spans several warps, and the backward keeps
// its dgamma/dbeta partials in registers across the rows a block walks, so
// they cost one [n_blocks, d] write, not a read-modify-write per row. Dropout
// reads and writes 16 bytes a thread and draws its bits in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Philox4x32-10 (Salmon et al., SC'11) with counter (c0, c1, 0, 0) and key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t k0,
                                               uint32_t k1) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c2 = hi0 ^ c3 ^ k1;
    c1 = lo1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
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

template <typename T, int V>
int launch_bwd(const void* x, const float* gamma, const void* dz, void* dx, float* dg_part,
               float* db_part, long long n, int d, int t_row, int n_blocks, float eps,
               cudaStream_t stream) {
  const int block = block_of(t_row);
  const int rpb = block / t_row;
  const size_t smem = sizeof(float) * (kRedFloats + (rpb > 1 ? 2 * rpb * d : 0));
  layer_norm_bwd<T, V><<<n_blocks, block, smem, stream>>>(
      static_cast<const T*>(x), gamma, static_cast<const T*>(dz), static_cast<T*>(dx),
      dg_part, db_part, n, d, t_row, eps);
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

// dz and dx in x's dtype; dg_part and db_part fp32 [n_blocks, d], every entry
// written (n_blocks <= the number of row groups, so each block has a row).
extern "C" int np_layer_norm_bwd(const void* x, const float* gamma, const void* dz, void* dx,
                                 float* dg_part, float* db_part, int dtype, long long n, int d,
                                 int t_row, int n_blocks, float eps, void* stream) {
  if (bad_team(n, d, t_row) || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(dz) && aligned16(dx) && aligned16(gamma);
  if (dtype == 0 && vec && d % 4 == 0)
    return launch_bwd<float, 4>(x, gamma, dz, dx, dg_part, db_part, n, d, t_row, n_blocks, eps, s);
  if (dtype == 0)
    return launch_bwd<float, 1>(x, gamma, dz, dx, dg_part, db_part, n, d, t_row, n_blocks, eps, s);
  if (dtype == 1 && vec && d % 8 == 0)
    return launch_bwd<bf16, 8>(x, gamma, dz, dx, dg_part, db_part, n, d, t_row, n_blocks, eps, s);
  if (dtype == 1)
    return launch_bwd<bf16, 1>(x, gamma, dz, dx, dg_part, db_part, n, d, t_row, n_blocks, eps, s);
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
