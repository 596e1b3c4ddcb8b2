// Philox4x32-10 (Salmon et al., SC'11), the port's in-kernel generator: the dropout
// kernel K7 (fused.cu) and the stochastic int8 quantizer K10 (quantize.cu) draw their
// bits from it. Element i of a tensor takes word i % 4 of the draw at counter i / 4
// (low and high 32-bit words), keyed by the 64-bit seed's low and high words; the
// plain twin in ops/fused.py (philox4x32_10, philox_bits) computes the same words in
// torch integer arithmetic.
#pragma once

#include <stdint.h>

// Philox4x32-10 with counter (c0, c1, 0, 0) and key (k0, k1).
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
