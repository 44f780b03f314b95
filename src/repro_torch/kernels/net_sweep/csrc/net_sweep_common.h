// net_sweep_common.h: what a generated net_sweep body needs, on the card and
// on the host.
//
// A generated body (codegen.py) is straight-line C++ over 32-bit words.  It
// compiles in two translation units: the CUDA kernel of net_sweep_kernel.cuh,
// and a host build that checks it against the plain torch version where
// there is no card.  NS_HD marks the functions both use; ns_popc is __popc on
// the card and the compiler's popcount on the host.
#pragma once

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#define NS_HD __host__ __device__ __forceinline__
#else
#define NS_HD inline
#endif

// The counter hash of the entropy bit-planes (rng.plane_base / plane_word).
NS_HD uint32_t ns_lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

NS_HD uint32_t ns_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return (uint32_t)__popc(x);
#else
  return (uint32_t)__builtin_popcount(x);
#endif
}

// Word bound e of a launch split into n drift epochs (common.epoch_word_bounds):
// round(e * w_words / n), ties to even.
NS_HD uint32_t ns_epoch_bound(uint32_t e, uint32_t n, uint32_t w_words) {
  const uint64_t x = (uint64_t)e * w_words;
  uint64_t q = x / n;
  const uint64_t r2 = 2 * (x - q * n);
  if (r2 > n || (r2 == n && (q & 1u))) ++q;
  return (uint32_t)q;
}

// All-ones where word w lies in drift epoch e of n, else 0.
NS_HD uint32_t ns_emask(uint32_t w, uint32_t w_words, uint32_t e, uint32_t n) {
  const uint32_t lo = ns_epoch_bound(e, n, w_words);
  return 0u - (uint32_t)((w - lo) < ns_epoch_bound(e + 1, n, w_words) - lo);
}
