// sne_body.h: the per-entropy-word body of the stochastic number encoder (SNE),
// shared by sne_encode.cu and bayes_decide.cu, on the card and on the host.
//
// The same functions compile in three translation units: the two CUDA kernels,
// and a host build that tests/test_torch_sne_host.py holds against the plain
// torch versions and the JAX reference where there is no card.  SNE_HD marks
// them; the funnel shift and the popcount are the card's intrinsics there and
// their definitions below on the host.
//
// One packed output word w of stream row r carries 32 stream positions;
// position 4e + b is byte b of entropy word e (e = 0..7), at bit 4e + b.
// Entropy word e is lowbias32(lowbias32(ctr ^ kd0) ^ kd1) of its counter
// ctr = r * n_rand + 8 w + e + offset mod 2^32 (the row-major index, computed
// in 64 bits, then truncated).  Per entropy word:
//
//   * hash.  lowbias32's first step, x ^= x >> 16, distributes over the XOR
//     with kd0, so the key enters as k0 = kd0 ^ (kd0 >> 16) in the same
//     3-input XOR.  Between the rounds the first one's last step and the
//     second one's first cancel on x: with y = x ^ (x >> 16), (y ^ kd1) ^
//     ((y ^ kd1) >> 16) = x ^ kd1 ^ (kd1 >> 16), since (x >> 16) >> 16 = 0; so
//     kd1 enters as k1 = kd1 ^ (kd1 >> 16) in one XOR.  4 shifts, 5 XORs
//     (one of 3 inputs), 4 multiplies and the counter's add.  A word's 8
//     counters ctr0 .. ctr0 + 7 start at a multiple of 8 wherever the counter
//     origin is one (rows and words step by 8): then ctr0 + e = ctr0 ^ e and
//     the high halves agree, so the first step is ctr0's, XORed with e.
//   * compare.  The row's threshold t in [0, 256] is kept as two bytes: bit 7
//     of `hi` (t >= 128) and `lo` = t - 128 * hi in [0, 128], so 256 needs no
//     flag.  (a | 0x80) - lo per byte never borrows, and one logic expression
//     gives a < t for all four bytes at bit 7 of each byte (sne_below).
//   * pack.  One multiply moves the 4 result bits to bits 28..31, and a funnel
//     shift appends them to the word, last entropy word first.  bayes_decide
//     counts without packing: it ANDs each entropy word's compare over the
//     modalities, bit 7 of each byte only, and popcounts the 8 results.
//
// Levels 0 and 256 need no entropy: their words are all zero and all one
// (sne_constant), and a bayes_decide stream with a modality at 0 counts 0
// (sne_stream_kind).  The kernels store those without a hash.
#pragma once

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#define SNE_HD __host__ __device__ __forceinline__
#else
#define SNE_HD inline
#endif

constexpr uint32_t SNE_MSB = 0x80808080u;

// The seed words as the hash reads them.
struct SneKey {
  uint32_t k0;    // kd0 ^ (kd0 >> 16)
  uint32_t k1;    // kd1 ^ (kd1 >> 16)
};

SNE_HD SneKey sne_key(uint32_t kd0, uint32_t kd1) {
  return {kd0 ^ (kd0 >> 16), kd1 ^ (kd1 >> 16)};
}

// lowbias32(lowbias32(c ^ kd0) ^ kd1) of counter c after its first step, given
// x = c ^ (c >> 16) ^ k0.
SNE_HD uint32_t sne_hash_rest(uint32_t x, SneKey key) {
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= key.k1;    // the first round's last shift-XOR and the second's first, with kd1
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The hash's first step for counters ctr0 + e, e = 0 .. 7, into x.  Where ctr0
// is a multiple of 8, ctr0 + e = ctr0 ^ e and (ctr0 + e) >> 16 = ctr0 >> 16.
SNE_HD void sne_first_steps(uint32_t ctr0, SneKey key, uint32_t x[8]) {
  if ((ctr0 & 7u) == 0u) {
    const uint32_t base = ctr0 ^ (ctr0 >> 16) ^ key.k0;
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = base ^ (uint32_t)e;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t c = ctr0 + (uint32_t)e;
      x[e] = c ^ (c >> 16) ^ key.k0;
    }
  }
}

// A threshold in [0, 256] as two bytes in every byte lane: 0x80 if it is >= 128,
// and the rest.
struct SneThr {
  uint32_t hi, lo;
};

// The DAC level: round(p * 256) clipped to [0, 256] (round half to even; p * 256
// is exact).
SNE_HD uint32_t sne_level(float p) {
  return (uint32_t)fminf(fmaxf(rintf(p * 256.0f), 0.0f), 256.0f);
}

// Level 0 gives all-zero words and 256 all-one words: no entropy is needed.
SNE_HD bool sne_constant(uint32_t level) { return level == 0u || level == 256u; }

SNE_HD uint32_t sne_constant_word(uint32_t level) { return level ? 0xFFFFFFFFu : 0u; }

SNE_HD SneThr sne_threshold_of_level(uint32_t t) {
  const uint32_t h = t >= 128u ? 1u : 0u;
  return {h * SNE_MSB, (t - 128u * h) * 0x01010101u};
}

SNE_HD SneThr sne_threshold(float p) { return sne_threshold_of_level(sne_level(p)); }

// Bit 7 of byte b: byte b of a < t; the other bits arbitrary.  (a | 0x80) - lo
// never borrows, and bit 7 of s says a mod 128 >= lo; where hi's bit 7 is set
// (t >= 128), a < t is ~(a & s) there, else ~(a | s): one logic expression.
SNE_HD uint32_t sne_below_any(uint32_t a, SneThr t) {
  const uint32_t s = (a | SNE_MSB) - t.lo;
  return ~((a & s) | (~t.hi & (a ^ s)));
}

// sne_below_any with the other bits 0.
SNE_HD uint32_t sne_below(uint32_t a, SneThr t) { return sne_below_any(a, t) & SNE_MSB; }

// (word << 4) with the 4 result bits of sne_below (bits 7, 15, 23, 31) as its
// low nibble.  The multiply moves byte b's bit to bit 28 + b; no two partial
// products meet below bit 32, so nothing carries into them.
SNE_HD uint32_t sne_push(uint32_t word, uint32_t below) {
  const uint32_t m = below * 0x00204081u;
#ifdef __CUDA_ARCH__
  return __funnelshift_l(m, word, 4);
#else
  return (word << 4) | (m >> 28);
#endif
}

// Counter of entropy word 0 of output word w: (row * n_rand + 8 w) mod 2^32 + offset.
SNE_HD uint32_t sne_first_counter(unsigned long long row, unsigned long long n_rand, int w,
                                  uint32_t offset) {
  return (uint32_t)(row * n_rand + 8ull * (unsigned long long)w) + offset;
}

// One packed stream word: entropy words ctr0 .. ctr0 + 7 against the threshold.
SNE_HD uint32_t sne_word(uint32_t ctr0, SneThr t, SneKey key) {
  uint32_t x[8];
  sne_first_steps(ctr0, key, x);
  uint32_t word = 0u;
#pragma unroll
  for (int e = 7; e >= 0; --e) word = sne_push(word, sne_below(sne_hash_rest(x[e], key), t));
  return word;
}

SNE_HD int sne_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// What one (row, class) stream of bayes_decide needs, its n_mod modalities'
// probabilities at p[m * p_stride]: SNE_DEAD if a modality is at level 0 (its
// count is 0), SNE_FULL if all are at 256 (every bit counts), else SNE_HASHED.
enum SneStream { SNE_DEAD = 0, SNE_FULL = 1, SNE_HASHED = 2 };

SNE_HD int sne_stream_kind(const float* p, unsigned long long p_stride, int n_mod) {
  int kind = SNE_FULL;
  for (int m = 0; m < n_mod; ++m) {
    const uint32_t t = sne_level(p[(unsigned long long)m * p_stride]);
    if (t == 0u) return SNE_DEAD;
    if (t != 256u) kind = SNE_HASHED;
  }
  return kind;
}

// bayes_decide's work for one thread: the popcount, over its words w = w0,
// w0 + dw, .. < n_out, of the AND over the n_mod modalities of stream (m, row).
// Modality m reads its probability at p[m * p_stride] and draws the counters of
// row `row + m * plane`; one at level 256 (all ones) is not hashed.  The words
// are not packed: each entropy word's compare bits are ANDed over the
// modalities in place (bit 7 of each byte) and popcounted, the same positions.
SNE_HD int sne_stream_count(const float* p, unsigned long long p_stride, int n_mod,
                            unsigned long long row, unsigned long long plane, int n_out,
                            int w0, int dw, SneKey key, uint32_t offset) {
  const unsigned long long n_rand = 8ull * (unsigned long long)n_out;
  int cnt = 0;
  for (int w = w0; w < n_out; w += dw) {
    uint32_t joint[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) joint[e] = SNE_MSB;
    for (int m = 0; m < n_mod; ++m) {
      const float pm = p[(unsigned long long)m * p_stride];
      if (sne_level(pm) == 256u) continue;
      const SneThr t = sne_threshold(pm);
      uint32_t x[8];
      sne_first_steps(sne_first_counter(row + (unsigned long long)m * plane, n_rand, w, offset),
                      key, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) joint[e] &= sne_below_any(sne_hash_rest(x[e], key), t);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) cnt += sne_popc(joint[e]);
  }
  return cnt;
}

// The first-occurrence argmax of one row's class counts: ties go to the lowest
// class, and all-zero counts decide 0.
SNE_HD int sne_argmax(const int* counts, int n_cls) {
  int best = -1, arg = 0;
  for (int k = 0; k < n_cls; ++k) {
    if (counts[k] > best) {
      best = counts[k];
      arg = k;
    }
  }
  return arg;
}
