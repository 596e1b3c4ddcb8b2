// Per-row absmax int8 quantization with stochastic rounding (K10), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _sq_kernel of np_modeling_tpu/ops/quantization.py
// (:47, launched by quantize_int8_stochastic at :82). For each row of x [n, d] (fp32
// or bf16), with the TPU kernel's arithmetic (:50-62), all in fp32:
//   absmax = max |x|;  scale = absmax == 0 ? 1 : absmax / 127;  s = x / scale;
//   fl = floor(s);  q = clip(fl + (u < s - fl), -127, 127)
// and writes q as int8 and scale as fp32 [n]. E[q] = s, so the rounding is unbiased.
// The TPU kernel draws u from the TPU's generator, whose bits exist nowhere else;
// here u is the top 24 bits of a Philox4x32-10 word over 2^24, the word of element i
// (its flat index in x) at counter i / 4 keyed by the 64-bit seed, as K7 draws its
// mask (philox.cuh). The plain twin in ops/quantization.py draws the same words in
// torch integer arithmetic, so kernel and plain version agree bit for bit.
//
// This is its own file, not a second kernel in int8_matmul.cu: it shares nothing with
// the int8-weight matmul but the int8 type, and it shares the generator with K7
// through philox.cuh.
//
// What bounds it: bytes. [8192, 768] fp32 reads 25.2 MB and writes 6.3 MB of int8
// (9.4 us at 3.35 TB/s); ten Philox rounds for four elements are cheap beside that.
// One block a row: the row's absmax by a block reduction (shuffles, then one
// shared-memory step), then each thread takes whole groups of four flat indices (one
// Philox draw each) and rounds the elements of the group that lie in the row. The
// second pass reads the row again from L1/L2 (a row is d elements, 3 KB at d 768).
// The loads are scalar: vectors and several rows a block for short rows are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_stochastic(const T* __restrict__ x, int8_t* __restrict__ values,
                        float* __restrict__ scales, int d, uint32_t k0, uint32_t k1) {
  __shared__ float red[kThreads / 32];
  const long long row = blockIdx.x;
  const long long base = row * d;
  float amax = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) amax = fmaxf(amax, fabsf(to_f(x[base + c])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float scale = amax == 0.f ? 1.f : amax / 127.f;
  if (threadIdx.x == 0) scales[row] = scale;

  // Groups of four flat indices [4 q, 4 q + 4) that meet this row.
  const long long q0 = base / 4, q1 = (base + d - 1) / 4;
  for (long long q = q0 + threadIdx.x; q <= q1; q += kThreads) {
    const uint4 r = philox4x32_10(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                                  k0, k1);
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long i = 4 * q + e;
      if (i < base || i >= base + d) continue;
      const float s = to_f(x[i]) / scale;
      const float fl = floorf(s);
      const float u = static_cast<float>(words[e] >> 8) * (1.f / 16777216.f);
      const float rounded = fl + (u < s - fl ? 1.f : 0.f);
      values[i] = static_cast<int8_t>(fminf(fmaxf(rounded, -127.f), 127.f));
    }
  }
}

}  // namespace

// x [n, d] contiguous (dtype 0 float32, 1 bfloat16); values int8 [n, d], scales fp32
// [n]; the seed's low and high words are Philox's key. One block a row.
extern "C" int np_quantize_int8_stochastic(const void* x, void* values, float* scales,
                                           int dtype, long long n, int d,
                                           unsigned long long seed, void* stream) {
  if (n < 0 || d < 1 || n > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
  int8_t* v = static_cast<int8_t*>(values);
  if (dtype == 0)
    quantize_stochastic<float><<<(unsigned)n, kThreads, 0, s>>>(
        static_cast<const float*>(x), v, scales, d, k0, k1);
  else if (dtype == 1)
    quantize_stochastic<bf16><<<(unsigned)n, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), v, scales, d, k0, k1);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
