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
// torch integer arithmetic, so kernel and plain version agree bit for bit. The scale
// is an IEEE division, and every q is the one the IEEE division x / scale gives (the
// fast rounding below); no fast-math flag.
//
// This is its own file, not a second kernel in int8_matmul.cu: it shares nothing with
// the int8-weight matmul but the int8 type. It shares the generator with K7: simple
// calls philox.cuh's philox4x32_10, rows and block_row run the same rounds with their
// keys added up beforehand.
//
// What bounds it: instruction issue, then bytes. [8192, 768] fp32 reads 25.2 MB and
// writes 6.3 MB of int8 (9.4 us at 3.35 TB/s), and each element costs a quarter of a
// Philox draw (ten rounds of two 32x32->64-bit products and two three-way xors), its
// rounding and, in the TPU kernel's arithmetic, an IEEE division (a reciprocal, fmas,
// a range check and its branch). exp_torch_k10.py --sass counts the instructions,
// --phases times each phase left out.
// ops.quantization.quantize_plan picks one of three schedules from the shape, the
// dtype and x's alignment:
//
//  rows (d % 4 == 0, x 16-byte aligned, a row of at most 32 elements a lane of a
//    warp): a power-of-two group of lanes owns a row (several rows a warp, several
//    warps a block, a grid that covers each row once). Each lane loads its vectors of the row once, all in flight
//    before the reduction, with 16-byte non-caching loads (8-byte for bf16 rows of
//    d % 8 != 0); the absmax is shuffles within the group, no block barrier. With
//    d % 4 == 0 a vector of 4 elements starts at a flat index 4 q, so it is exactly
//    Philox draw q (8 bf16 are draws 2 q' and 2 q' + 1): one draw a vector, no
//    per-element edge test; the draws read their round keys from kernel parameters.
//    Its 4 or 8 int8 results leave as one 4- or 8-byte store (a warp's store
//    instruction writes whole 128-byte lines), the scale once a row.
//  block_row (the same vectors, longer rows, up to 512 threads x 8 vectors: 16384
//    fp32, 32768 bf16): a block owns a row, reads it once into registers and reduces
//    the absmax with one barrier (warp shuffles, then one shared-memory step).
//  simple (ragged d, where a draw's four words straddle two rows; a misaligned x;
//    longer rows): one block of 256 threads a row, scalar loads, the row read twice,
//    each thread taking whole groups of four flat indices and rounding those that
//    lie in the row (the port's first K10 kernel, unchanged).
//
// The fast rounding (rows and block_row). Let z = x / scale in exact arithmetic. The
// TPU kernel's q = fl + (u < s - fl), s = RN(x / scale), fl = floor(s), equals
// ceil(z - u) wherever z - u lies more than 2^-17 from an integer: |s - z| <= 2^-18
// (|z| < 128), RN(s - fl) is within 2^-25 of s - fl, and for a real s,
// floor(s) + (u < s - floor(s)) = ceil(s - u). The kernel instead computes
// w = RN(RN(x * RN(1 / scale)) - u) (one product and one fma), within 2^-15 of
// z - u (relative error 2^-23 in the product, half an ulp of 128 in the difference),
// and takes q = floor(w) + 1 = ceil(z - u) where w lies at least kMargin = 2^-13
// from an integer. A vector with an element nearer (about 2.4e-4 of the elements),
// or a row whose 1 / scale is not a normal number, takes the TPU kernel's arithmetic
// with its two IEEE divisions. The clamp to +-127 follows in either case.

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

// ---- rows and block_row: whole vectors of V elements in registers ----------------

// V elements of T as 32-bit words: one 16-byte load (fp32 x 4, bf16 x 8) or one
// 8-byte load (bf16 x 4).
template <typename T, int V>
struct Vec {
  static constexpr int kWords = V * static_cast<int>(sizeof(T)) / 4;
  static_assert(kWords == 2 || kWords == 4, "a vector is 8 or 16 bytes");
  uint32_t w[kWords];
};

// Read-only data, used once: not kept in L1.
__device__ __forceinline__ void load_nc(uint32_t (&w)[4], const void* p) {
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
      : "l"(p));
}
__device__ __forceinline__ void load_nc(uint32_t (&w)[2], const void* p) {
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];" : "=r"(w[0]), "=r"(w[1]) : "l"(p));
}

// A thread's vectors of row `xr`: first, first + step, ... (at most P), zeros past
// the row's nv vectors or where the row is not live.
template <typename T, int V, int P>
__device__ __forceinline__ void load_row(Vec<T, V> (&v)[P], const T* xr, bool live, int first,
                                         int step, int nv) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = first + k * step;
    if (live && j < nv) {
      load_nc(v[k].w, xr + static_cast<long long>(j) * V);
    } else {
#pragma unroll
      for (int w = 0; w < Vec<T, V>::kWords; ++w) v[k].w[w] = 0u;
    }
  }
}

// Element e of a vector, exactly, as fp32 (a bf16 is the top half of its fp32).
template <typename T, int V>
__device__ __forceinline__ float elem(const Vec<T, V>& v, int e) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(v.w[e]);
  else return __uint_as_float(e % 2 ? v.w[e / 2] & 0xffff0000u : v.w[e / 2] << 16);
}

template <typename T, int V, int P>
__device__ __forceinline__ float vectors_absmax(const Vec<T, V> (&v)[P]) {
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(elem(v[k], e)));
  return amax;
}

// A row's scale, the reciprocal the fast rounding multiplies by, and whether that
// reciprocal is a normal number (the fast rounding's error bound needs it).
struct RowScale {
  float scale, inv;
  bool fast;
};

__device__ __forceinline__ RowScale row_scale(float amax) {
  RowScale r;
  r.scale = amax == 0.f ? 1.f : amax / 127.f;
  r.inv = 1.f / r.scale;
  r.fast = r.scale >= 0x1p-125f && r.scale <= 0x1p125f;
  return r;
}

// Where the fast rounding decides: w at least this far from an integer.
constexpr float kMargin = 0x1p-13f;

// Philox4x32-10's round keys, (k0, k1) + r (0x9E3779B9, 0xBB67AE85) for r = 0..9,
// added up once on the host and passed as kernel parameters (the constant bank), so a
// draw spends no instructions on its key schedule.
struct RoundKeys {
  uint32_t k0[10], k1[10];
};

// philox4x32_10 of philox.cuh with its keys read from `rk`: the same words.
__device__ __forceinline__ uint4 draw(unsigned long long q, const RoundKeys& rk) {
  uint32_t c0 = static_cast<uint32_t>(q), c1 = static_cast<uint32_t>(q >> 32), c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ rk.k0[r];
    c2 = hi0 ^ c3 ^ rk.k1[r];
    c1 = lo1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Two int32 as two int8, saturated, above which the low half of `hi` is kept:
// {hi[15:0], sat(a), sat(b)}.
__device__ __forceinline__ uint32_t pack_s8(int a, int b, uint32_t hi) {
  uint32_t d;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(hi));
  return d;
}

// Rounds vector v, whose first element has the flat index i0 (a multiple of 4), with
// its row's scale, and writes its V int8 values at values + i0 in one store: one
// Philox draw for 4 elements. The fast rounding, w = RN(RN(x * RN(1 / scale)) - u),
// q = floor(w) + 1, where every w of the vector lies at least kMargin from an
// integer; else the TPU kernel's arithmetic (see the header: both give the same q).
template <typename T, int V>
__device__ __forceinline__ void round_store(const Vec<T, V>& v, const RowScale& rs,
                                            long long i0, int8_t* __restrict__ values,
                                            const RoundKeys& rk) {
  uint32_t words[V];
#pragma unroll
  for (int g = 0; g < V / 4; ++g) {
    const uint4 r = draw(static_cast<unsigned long long>(i0 / 4 + g), rk);
    words[4 * g] = r.x;
    words[4 * g + 1] = r.y;
    words[4 * g + 2] = r.z;
    words[4 * g + 3] = r.w;
  }
  float q[V];
  bool exact = !rs.fast;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float w = fmaf(-static_cast<float>(words[e] >> 8), 1.f / 16777216.f,
                         __fmul_rn(elem(v, e), rs.inv));
    const float fw = floorf(w);
    const float frac = w - fw;
    exact |= !(frac >= kMargin && frac <= 1.f - kMargin);
    q[e] = fw + 1.f;
  }
  if (exact) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float s = elem(v, e) / rs.scale;
      const float fl = floorf(s);
      const float u = static_cast<float>(words[e] >> 8) * (1.f / 16777216.f);
      q[e] = fl + (u < s - fl ? 1.f : 0.f);
    }
  }
  // q lies in [-128, 128]: -128 is raised to -127 here, 128 saturates to 127.
  int qi[V];
#pragma unroll
  for (int e = 0; e < V; ++e) qi[e] = static_cast<int>(fmaxf(q[e], -127.f));
  uint32_t packed[V / 4];
#pragma unroll
  for (int g = 0; g < V / 4; ++g)
    packed[g] = pack_s8(qi[4 * g + 1], qi[4 * g], pack_s8(qi[4 * g + 3], qi[4 * g + 2], 0u));
  if constexpr (V == 4)
    *reinterpret_cast<uint32_t*>(values + i0) = packed[0];
  else
    *reinterpret_cast<uint2*>(values + i0) = make_uint2(packed[0], packed[1]);
}

// The rounding of a thread's vectors of `row` (first, first + step, ...).
template <typename T, int V, int P>
__device__ __forceinline__ void round_row(const Vec<T, V> (&v)[P], const RowScale& rs,
                                          long long row, int d, int first, int step, int nv,
                                          int8_t* __restrict__ values, const RoundKeys& rk) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = first + k * step;
    if (j < nv) round_store(v[k], rs, row * d + static_cast<long long>(j) * V, values, rk);
  }
}

// rows: a group of `lanes` lanes (a power of two, at most 32) a row, 32 / lanes rows a
// warp, the grid one row group a warp. Each lane holds the row's vectors lane,
// lane + lanes, ... (at most P). Every lane of a warp reaches the shuffles, also past
// the last row, so they see the whole warp.
template <typename T, int V, int P>
__global__ void __launch_bounds__(512)
    quantize_rows(const T* __restrict__ x, int8_t* __restrict__ values,
                  float* __restrict__ scales, long long n, int d, int lanes,
                  const __grid_constant__ RoundKeys rk) {
  const int lane = threadIdx.x % 32;
  const int shift = __ffs(lanes) - 1;
  const int gl = lane & (lanes - 1);
  const int nv = d / V;
  const long long row =
      (static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32) * (32 >> shift) +
      (lane >> shift);
  const bool live = row < n;
  Vec<T, V> v[P];
  load_row(v, x + row * d, live, gl, lanes, nv);
  float amax = vectors_absmax(v);
  for (int off = lanes >> 1; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (!live) return;
  const RowScale rs = row_scale(amax);
  if (gl == 0) scales[row] = rs.scale;
  round_row(v, rs, row, d, gl, lanes, nv, values, rk);
}

// block_row: a block a row. Thread t holds the row's vectors t, t + blockDim.x, ... (at
// most P); one barrier for the absmax.
template <typename T, int V, int P>
__global__ void __launch_bounds__(512)
    quantize_block_row(const T* __restrict__ x, int8_t* __restrict__ values,
                       float* __restrict__ scales, long long n, int d,
                       const __grid_constant__ RoundKeys rk) {
  __shared__ float red[32];
  const int nv = d / V;
  const int warps = blockDim.x / 32;
  const long long row = blockIdx.x;
  Vec<T, V> v[P];
  load_row(v, x + row * d, true, threadIdx.x, blockDim.x, nv);
  float amax = vectors_absmax(v);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = red[0];
  for (int w = 1; w < warps; ++w) amax = fmaxf(amax, red[w]);
  const RowScale rs = row_scale(amax);
  if (threadIdx.x == 0) scales[row] = rs.scale;
  round_row(v, rs, row, d, threadIdx.x, blockDim.x, nv, values, rk);
}

struct Launch {
  const void* x;
  int8_t* values;
  float* scales;
  long long n;
  int d, lanes, warps, grid;
  RoundKeys rk;
  cudaStream_t stream;
};

template <typename T, int V, int P>
void launch_rows(const Launch& a) {
  quantize_rows<T, V, P><<<a.grid, a.warps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.values, a.scales, a.n, a.d, a.lanes, a.rk);
}

template <typename T, int V, int P>
void launch_block_row(const Launch& a) {
  quantize_block_row<T, V, P><<<a.grid, a.warps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.values, a.scales, a.n, a.d, a.rk);
}

// The vectors a lane may hold, as compiled (ops.quantization.ROWS_PER_LANE and
// BLOCK_ROW_PER_LANE).
template <typename T, int V>
bool rows_by_width(const Launch& a, int per_lane) {
  switch (per_lane) {
    case 1: launch_rows<T, V, 1>(a); return true;
    case 2: launch_rows<T, V, 2>(a); return true;
    case 3: launch_rows<T, V, 3>(a); return true;
    case 4: launch_rows<T, V, 4>(a); return true;
    case 6: launch_rows<T, V, 6>(a); return true;
    case 8: launch_rows<T, V, 8>(a); return true;
    default: return false;
  }
}

template <typename T, int V>
bool block_row_by_width(const Launch& a, int per_lane) {
  switch (per_lane) {
    case 1: launch_block_row<T, V, 1>(a); return true;
    case 2: launch_block_row<T, V, 2>(a); return true;
    case 4: launch_block_row<T, V, 4>(a); return true;
    case 8: launch_block_row<T, V, 8>(a); return true;
    default: return false;
  }
}

template <typename T, int V>
bool by_width(const Launch& a, int schedule, int per_lane) {
  return schedule == 1 ? rows_by_width<T, V>(a, per_lane) : block_row_by_width<T, V>(a, per_lane);
}

}  // namespace

// x [n, d] contiguous (dtype 0 float32, 1 bfloat16); values int8 [n, d], scales fp32
// [n]; the seed's low and high words are Philox's key. The schedule and its shape are
// ops.quantization.quantize_plan's: schedule 0 simple (one block of 256 threads a row;
// the other arguments are not read), 1 rows (`vec` elements a vector, `lanes` lanes a
// row, at most `per_lane` vectors a lane, `warps` warps a block, `grid` blocks), 2
// block_row (a block of `lanes` = 32 `warps` threads a row). A shape the schedule
// cannot take, a grid that does not cover every row, or an x or values pointer not
// aligned to a vector, is refused (cudaErrorInvalidValue) before any launch.
extern "C" int np_quantize_int8_stochastic(const void* x, void* values, float* scales,
                                           int dtype, long long n, int d,
                                           unsigned long long seed, int schedule, int vec,
                                           int lanes, int per_lane, int warps, int grid,
                                           void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (n < 0 || d < 1 || n > 2147483647LL || (dtype != 0 && dtype != 1)) return invalid;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
  int8_t* v = static_cast<int8_t*>(values);
  if (schedule == 0) {
    if (dtype == 0)
      quantize_stochastic<float><<<(unsigned)n, kThreads, 0, s>>>(
          static_cast<const float*>(x), v, scales, d, k0, k1);
    else
      quantize_stochastic<bf16><<<(unsigned)n, kThreads, 0, s>>>(
          static_cast<const bf16*>(x), v, scales, d, k0, k1);
    return static_cast<int>(cudaGetLastError());
  }
  const int elem_bytes = dtype == 0 ? 4 : 2;
  const bool shape_ok =
      (vec == 4 || (vec == 8 && dtype == 1)) && d % vec == 0 && grid >= 1 &&
      reinterpret_cast<uintptr_t>(x) % (vec * elem_bytes) == 0 &&
      reinterpret_cast<uintptr_t>(values) % vec == 0 &&
      warps >= 1 && warps <= 16 &&
      (schedule == 1 ? lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0
                     : schedule == 2 && lanes == 32 * warps) &&
      static_cast<long long>(grid) * (schedule == 1 ? warps * (32 / lanes) : 1) >= n;
  if (!shape_ok) return invalid;
  const int nv = d / vec;
  if ((nv + lanes - 1) / lanes > per_lane) return invalid;
  Launch a{x, v, scales, n, d, lanes, warps, grid, {}, s};
  for (int r = 0; r < 10; ++r) {
    a.rk.k0[r] = k0 + static_cast<uint32_t>(r) * 0x9E3779B9u;
    a.rk.k1[r] = k1 + static_cast<uint32_t>(r) * 0xBB67AE85u;
  }
  const bool launched = dtype == 0  ? by_width<float, 4>(a, schedule, per_lane)
                        : vec == 8 ? by_width<bf16, 8>(a, schedule, per_lane)
                                   : by_width<bf16, 4>(a, schedule, per_lane);
  if (!launched) return invalid;
  return static_cast<int>(cudaGetLastError());
}
