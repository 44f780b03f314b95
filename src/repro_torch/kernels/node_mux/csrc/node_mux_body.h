// node_mux_body.h: the per-output-word bodies of the binary node_mux kernels
// (gather and rows, m <= 6 parents), on the card and on the host.
//
// The same functions compile in two translation units: the CUDA kernels of
// node_mux.cu, and a host build that tests/test_torch_node_mux_host.py holds
// against the plain torch versions and the JAX reference where there is no
// card.  NM_HD marks them; nm_byte_perm is __byte_perm (PRMT) on the card and
// its definition below on the host.
//
// One output word w of row r carries 32 stream positions; position 4e + b is
// byte b of entropy word e (e = 0..7), at bit 4e + b of the word.  The work is
// organised per entropy word, 4 positions at once:
//
//   * selector.  Unit e (16 bits) holds in nibble b the CPT row of position
//     4e + b: bits 0..2 from the last three parents (first parent most
//     significant), and for m > 3 a second unit holds the first m - 3 parents'
//     bits, the row's 8-row group.  Both come from whole parent words:
//     (p >> b) & 0x11111111 puts the bits of positions b, 4 + b, .. at nibble
//     boundaries, the parents are OR-ed in at their row bit, and a nibble
//     transpose (two shift-and-mask steps, then one byte permute per unit)
//     regroups them by entropy word.  No nibble ever sets bit 3, so the
//     permutes below read 3 selector bits whichever way bit 3 is taken.
//   * thresholds.  A threshold t in [0, 256] is kept as two bytes: bit 7 of
//     `hi` (t >= 128) and `lo` = t - 128 * hi in [0, 128], so 256 needs no
//     flag.  Each 8-row group's bytes sit in two words, and one byte permute
//     per group fetches the 4 positions' bytes; for m > 3 a tree of permutes
//     keyed by the group unit picks the group per byte.
//   * compare and pack.  nm_below compares the 4 entropy bytes with their
//     thresholds in one SWAR step (bit 7 of each byte); one multiply gathers
//     the 4 result bits into bits 28..31, and they land at nibble e.
//
// Rows mode draws a separate entropy word per CPT row l, counter
// first_counter(r * L + l) + e.  In the selected form (m >= 2) only the word
// of the row a position selects is hashed (32 hashes per output word, the
// row index read from the same selector), and the 4 selected bytes are
// assembled with permutes; the all-rows form (m <= 1) encodes every row, 8 L
// hashes, and runs the value-select MUX over the packed words.
#pragma once

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#define NM_HD __host__ __device__ __forceinline__
#else
#define NM_HD inline
#endif

constexpr uint32_t NM_MSB = 0x80808080u;

NM_HD uint32_t nm_lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

NM_HD uint32_t nm_hash(uint32_t ctr, uint32_t kd0, uint32_t kd1) {
  return nm_lowbias32(nm_lowbias32(ctr ^ kd0) ^ kd1);
}

// Byte n of the result is byte (s >> 4n) & 7 of the 8 bytes {y, x} (x bytes
// 0..3, y bytes 4..7); the upper 16 bits of s are not read.
NM_HD uint32_t nm_byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const uint64_t in = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n) {
    r |= (uint32_t)((in >> (8 * ((s >> (4 * n)) & 7u))) & 0xFFu) << (8 * n);
  }
  return r;
#endif
}

// round(p * 256) clipped to [0, 256] (round half to even; p * 256 is exact).
NM_HD uint32_t nm_dac_threshold(float p) {
  return (uint32_t)fminf(fmaxf(rintf(p * 256.0f), 0.0f), 256.0f);
}

// Counter of entropy word 0 of output word w: (base_row * n_rand + 8 w) mod 2^32 + offset.
NM_HD uint32_t nm_first_counter(unsigned long long base_row, unsigned long long n_rand, int w,
                                uint32_t offset) {
  return (uint32_t)(base_row * n_rand + 8ull * (unsigned long long)w) + offset;
}

// Bit 7 of byte b: byte b of a < 128 * (bit 7 of byte b of th) + byte b of tl,
// for tl in [0, 128].  (a | 0x80) - tl per byte never borrows, and its bit 7
// says a mod 128 >= tl; the high bits decide where they differ.
NM_HD uint32_t nm_below(uint32_t a, uint32_t th, uint32_t tl) {
  const uint32_t s = (a | NM_MSB) - tl;
  return ((~a & th) | (~(a ^ th) & ~s)) & NM_MSB;
}

// The 4 result bits of nm_below (bits 7, 15, 23, 31) as bits 4e .. 4e+3.  The
// multiply moves byte b's bit to bit 28 + b; no two partial products meet.
NM_HD uint32_t nm_nibble(uint32_t below, int e) {
  return ((below * 0x00204081u) >> 28) << (4 * e);
}

template <int M>
struct NmThr {
  static constexpr int G = M > 3 ? 1 << (M - 3) : 1;   // 8-row groups
  uint32_t hi[2 * G];         // word i: bit 7 of byte k says row 4i + k has t >= 128
  uint32_t lo[2 * G];         // word i: byte k is t - 128 * hi of row 4i + k
};

// The two bytes of a threshold in [0, 256]: 0x80 if it is >= 128, and the rest.
NM_HD uint32_t nm_hi_byte(uint32_t thr) { return thr >= 128u ? 0x80u : 0u; }
NM_HD uint32_t nm_lo_byte(uint32_t thr) { return thr >= 128u ? thr - 128u : thr; }

// The thresholds of one CPT row table (2^M float probabilities).
template <int M>
NM_HD NmThr<M> nm_thresholds(const float* cpt) {
  NmThr<M> t;
#pragma unroll
  for (int i = 0; i < 2 * NmThr<M>::G; ++i) t.hi[i] = t.lo[i] = 0u;
#pragma unroll
  for (int l = 0; l < (1 << M); ++l) {
    const uint32_t thr = nm_dac_threshold(cpt[l]);
    t.hi[l >> 2] |= nm_hi_byte(thr) << (8 * (l & 3));
    t.lo[l >> 2] |= nm_lo_byte(thr) << (8 * (l & 3));
  }
  return t;
}

// Units of parents [J0, J1) (at most 3, the first most significant), four
// entropy words' units per word pair: a.. for even e, b.. for odd e.
struct NmSel {
  uint32_t a01, a23, b01, b23;
};

template <int J0, int J1>
NM_HD NmSel nm_selectors(const uint32_t* par) {
  uint32_t s[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    uint32_t acc = 0u;                   // nibble e: the row bits of position 4e + b
#pragma unroll
    for (int j = J0; j < J1; ++j) acc |= ((par[j] >> b) & 0x11111111u) << (J1 - 1 - j);
    s[b] = acc;
  }
  // byte k of a..: unit 2k's nibbles of positions b, b+1; of b..: unit 2k+1's
  NmSel r;
  r.a01 = (s[0] & 0x0F0F0F0Fu) | ((s[1] << 4) & 0xF0F0F0F0u);
  r.b01 = ((s[0] >> 4) & 0x0F0F0F0Fu) | (s[1] & 0xF0F0F0F0u);
  r.a23 = (s[2] & 0x0F0F0F0Fu) | ((s[3] << 4) & 0xF0F0F0F0u);
  r.b23 = ((s[2] >> 4) & 0x0F0F0F0Fu) | (s[3] & 0xF0F0F0F0u);
  return r;
}

// Unit e in the low 16 bits: nibble b is the row bits of position 4e + b.
NM_HD uint32_t nm_unit(const NmSel& s, int e) {
  const uint32_t k = (uint32_t)(e >> 1);
  const uint32_t sel = k | ((k + 4u) << 4);
  return (e & 1) ? nm_byte_perm(s.b01, s.b23, sel) : nm_byte_perm(s.a01, s.a23, sel);
}

// The selectors of an M-parent node: the low 3 row bits, and the group bits.
template <int M>
struct NmRows {
  static constexpr int LO = M < 3 ? M : 3;      // the last LO parents: row bits 0..LO-1
  static constexpr int HI = M - LO;             // the first HI parents: the 8-row group
  NmSel lo, hi;
  NM_HD explicit NmRows(const uint32_t* par)
      : lo(nm_selectors<HI, M>(par)), hi(nm_selectors<0, HI>(par)) {}
  NM_HD uint32_t lo_unit(int e) const { return M > 0 ? nm_unit(lo, e) : 0u; }
  NM_HD uint32_t hi_unit(int e) const { return HI > 0 ? nm_unit(hi, e) : 0u; }
};

// The 4 positions' threshold bytes (th, tl) of entropy word e.
template <int M>
NM_HD void nm_fetch(const NmThr<M>& t, const NmRows<M>& rows, int e, uint32_t& th,
                    uint32_t& tl) {
  constexpr int G = NmThr<M>::G;
  const uint32_t u = rows.lo_unit(e);
  uint32_t h[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    h[g] = nm_byte_perm(t.hi[2 * g], t.hi[2 * g + 1], u);
    l[g] = nm_byte_perm(t.lo[2 * g], t.lo[2 * g + 1], u);
  }
  const uint32_t v = rows.hi_unit(e);
#pragma unroll
  for (int k = 0; k < NmRows<M>::HI; ++k) {         // group bit k picks per byte
    const uint32_t sel = (((v >> k) & 0x1111u) << 2) | 0x3210u;
#pragma unroll
    for (int i = 0; i < (G >> (k + 1)); ++i) {
      h[i] = nm_byte_perm(h[2 * i], h[2 * i + 1], sel);
      l[i] = nm_byte_perm(l[2 * i], l[2 * i + 1], sel);
    }
  }
  th = h[0];
  tl = l[0];
}

template <int M>
NM_HD void nm_load_parents(uint32_t (&par)[M > 0 ? M : 1], const uint32_t* parents,
                           long long n_rows, int n_out, long long r, int w) {
#pragma unroll
  for (int i = 0; i < M; ++i) par[i] = parents[((long long)i * n_rows + r) * n_out + w];
}

// Threshold-gather word (r, w): one entropy word per 4 positions, counters
// r * n_rand + 8 w + e (+ offset).
template <int M>
NM_HD uint32_t nm_gather_item(const NmThr<M>& t, const uint32_t* parents, long long n_rows,
                              int n_out, long long r, int w, uint32_t kd0, uint32_t kd1,
                              uint32_t offset) {
  uint32_t par[M > 0 ? M : 1];
  nm_load_parents<M>(par, parents, n_rows, n_out, r, w);
  const NmRows<M> rows(par);
  const uint32_t ctr0 =
      nm_first_counter((unsigned long long)r, 8ull * (unsigned long long)n_out, w, offset);
  uint32_t word = 0u;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    uint32_t th, tl;
    nm_fetch<M>(t, rows, e, th, tl);
    word |= nm_nibble(nm_below(nm_hash(ctr0 + (uint32_t)e, kd0, kd1), th, tl), e);
  }
  return word;
}

// Row-encode word (r, w); SELECTED hashes only the selected rows' words.
template <int M, bool SELECTED>
NM_HD uint32_t nm_rows_item(const NmThr<M>& t, const uint32_t* parents, long long n_rows,
                            int n_out, long long r, int w, uint32_t kd0, uint32_t kd1,
                            uint32_t offset) {
  constexpr int L = 1 << M;
  uint32_t par[M > 0 ? M : 1];
  nm_load_parents<M>(par, parents, n_rows, n_out, r, w);
  const unsigned long long n_rand = 8ull * (unsigned long long)n_out;
  // row l's word e has counter ctr0 + l * n_rand + e (mod 2^32)
  const uint32_t ctr0 = nm_first_counter((unsigned long long)r * L, n_rand, w, offset);
  if constexpr (SELECTED) {
    const NmRows<M> rows(par);
    uint32_t word = 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t u = rows.lo_unit(e), v = rows.hi_unit(e);
      uint32_t x[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t l = ((u >> (4 * b)) & 7u) | (((v >> (4 * b)) & 7u) << 3);
        x[b] = nm_hash(ctr0 + l * (uint32_t)n_rand + (uint32_t)e, kd0, kd1);
      }
      // byte b of x[b]
      const uint32_t a = nm_byte_perm(nm_byte_perm(x[0], x[1], 0x0050u),
                                      nm_byte_perm(x[2], x[3], 0x7200u), 0x7610u);
      uint32_t th, tl;
      nm_fetch<M>(t, rows, e, th, tl);
      word |= nm_nibble(nm_below(a, th, tl), e);
    }
    return word;
  } else {
    uint32_t leaf[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const uint32_t sel = (uint32_t)(l & 3) * 0x1111u;    // row l's bytes in all 4 lanes
      const uint32_t th = nm_byte_perm(t.hi[l >> 2], 0u, sel);
      const uint32_t tl = nm_byte_perm(t.lo[l >> 2], 0u, sel);
      const uint32_t c = ctr0 + (uint32_t)l * (uint32_t)n_rand;
      uint32_t word = 0u;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        word |= nm_nibble(nm_below(nm_hash(c + (uint32_t)e, kd0, kd1), th, tl), e);
      }
      leaf[l] = word;
    }
    // value-select MUX tree over the leaf words, last parent first
#pragma unroll
    for (int j = M - 1; j >= 0; --j) {
#pragma unroll
      for (int i = 0; i < (1 << j); ++i) {
        leaf[i] = (par[j] & leaf[2 * i + 1]) | (~par[j] & leaf[2 * i]);
      }
    }
    return leaf[0];
  }
}

// The form each parent count runs in rows mode (chosen by measurement on the
// H100, PERF.md): every row's words for L <= 2, the selected rows' above.
constexpr bool nm_rows_selected(int m) { return m >= 2; }
