// node_mux: one Bayesian-network node of the unfused lowering, for sm_90a.
//
// Replaces the three TPU kernels of repro/kernels/node_mux/kernel.py together
// with the entropy their callers drew (repro/core/rng.py::counter_hash_words):
//
//   node_mux_gather  <- _node_mux_gather_kernel (wrapper node_mux_gather_pallas)
//   node_mux_cat     <- _node_mux_cat_kernel    (wrapper node_mux_cat_pallas,
//                                                body ref.py::cat_gather_body)
//   node_mux_rows    <- _node_mux_kernel        (wrapper node_mux_pallas)
//
// What they compute.  One thread owns one (row r, packed output word w).  The
// entropy word e = 0..7 of that output word is
// lowbias32(lowbias32(ctr ^ kd0) ^ kd1) of its counter ctr, the row-major flat
// index of the reference's entropy tensor plus the caller's offset, computed
// in 64 bits and truncated to 32 (the reference's uint32 iota wraps the same
// way).  Byte b of word e is the uniform draw of stream position 4e + b, which
// lands at bit 4e + b of the output word (the interleaved layout of
// rng.packed_from_bytes and the sne_encode kernel).  A parent's bit for that
// position is read from the parent's word w at the same bit.
//
//   gather  ctr = r * n_rand + 8w + e.  The parents' bits at the position pick
//           the CPT row (first parent = most significant bit); the bit is
//           byte < clip(rint(cpt * 256), 0, 256) of that row (round half to
//           even; 256 means always 1).
//   cat     ctr = r * n_rand + 8w + e.  Each parent's value digit is read from
//           its value bit-planes; a digit >= the parent's cardinality selects
//           digit 0.  The mixed-radix digits (first parent most significant)
//           pick a row of k-1 cumulative thresholds, and the sampled value is
//           the COUNT of thresholds the byte lies below, written as its
//           value_bits(k) bit-planes.  Zero parents (k-ary roots) is one row.
//   rows    ctr = (r * L + l) * n_rand + 8w + e for CPT row l.  All L rows are
//           encoded as packed words, then the value-select MUX tree keyed by
//           the parents' words picks, per bit, the row the parents' bits name.
//
// Design.  The Pallas kernels read pre-drawn entropy from HBM (n_bits / 4
// words per row, L times that in row mode).  Here the words are hashed in
// registers and never stored, so a launch reads only the tables and the
// parents' words and writes the node's words.  Every table has a row stride:
// 0 when one table serves every row (the compiled network's case), so no
// broadcast table is ever copied.  Which kernel runs follows from the node's
// shape alone:
//
//   * binary gather and rows, m <= 6 parents: templated on m, with the
//     per-word bodies in node_mux_body.h (shared with a host build that the
//     CPU tests check).  Work is done per entropy word, for its 4 byte lanes
//     at once: a nibble selector per entropy word, built from whole parent
//     words, fetches the 4 positions' thresholds with one byte permute
//     (PRMT) per 8-row group from two registers, one SWAR compare and one
//     multiply place the 4 result bits.  A shared table is rounded and split
//     into threshold bytes once per block, in shared memory.  Rows mode hashes
//     only the entropy word of the row each position selects (m >= 2; 32
//     hashes per output word against 8 L), or every row's words and a
//     word-wide MUX where L <= 2 (nm_rows_selected).
//   * cat, P <= 8 parent value bit-planes (node_mux_cat_kernel<P>): the host
//     folds the mixed-radix decode (digits past a parent's cardinality read
//     0) and the CDF rows into one pattern table of 2^P x (k-1) uint16
//     thresholds, indexed by the P parent bits at a position (plane i = bit
//     i).  The P parent words sit in registers and a block stages a shared
//     table in shared memory once, so a stream bit costs P bit gathers and
//     k-1 shared-memory compares, with no run-time loop over parents.
//     Binary gather with 7 or 8 parents runs here as k = 2.
//   * cat, P > 8 (node_mux_cat_wide_kernel): parent words are read from
//     global memory once each and the digits decoded at run time into a
//     per-position 64-bit row index; CDF rows are read through the read-only
//     cache.  Binary gather with more than 8 parents runs here as k = 2.
//   * rows, m > 6 (node_mux_rows_wide_kernel): per position only the entropy
//     word of the row the parents select is hashed, at most 32 hashes per
//     output word.
//
// Bound on H100.  Integer work: two lowbias32 rounds and the key XORs (18
// operations) for each entropy word the function needs, plus one compare per
// byte and CDF level, over the card's INT32 rate.  The bytes (parents' words
// in, the node's words out) take less time at 3.35 TB/s, so all are bound by
// operations.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "node_mux_body.h"

namespace {

constexpr int MAX_M = 6;        // templated binary kernels: parents per node (L = 2^m rows)
constexpr int MAX_PAT = 8;      // pattern-table kernel: parent value bit-planes
constexpr int MAX_VB = 8;       // categorical kernels: value bit-planes (k <= 256)
constexpr int MAX_WIDE = 64;    // wide kernels: parents (2^64 CPT rows exceed any memory)
constexpr int STAGE_BYTES = 48 * 1024;  // a shared pattern table up to this size is staged

struct WideShape {
  int n_parents;
  int card[MAX_WIDE];           // parent cardinalities, first parent first
};

__host__ __device__ constexpr int value_bits(int k) {
  int b = 0;
  while ((1 << b) < k) ++b;
  return b;
}

// The sampled values of stream positions 4e .. 4e+3, one per byte of cw:
// bit v of byte b lands at bit 4e + b of plane v.  The multiply gathers bits
// 0, 8, 16, 24 of t into bits 24..27 (no two partial products meet).  Planes
// at or above vb are skipped; with VB > 0 that bound is known at compile time.
template <int VB>
__device__ __forceinline__ void put_values(uint32_t (&acc)[MAX_VB], int vb, uint32_t cw, int e) {
#pragma unroll
  for (int v = 0; v < MAX_VB; ++v) {
    if (v < (VB > 0 ? VB : vb)) {
      const uint32_t t = (cw >> v) & 0x01010101u;
      acc[v] |= ((t * 0x01020408u) >> 24) << (4 * e);
    }
  }
}

template <int VB>
__device__ __forceinline__ void store_values(const uint32_t (&acc)[MAX_VB], int vb,
                                             uint32_t* __restrict__ out, long long n_rows,
                                             int n_out, long long r, int w) {
#pragma unroll
  for (int v = 0; v < MAX_VB; ++v) {
    if (v < (VB > 0 ? VB : vb)) out[((long long)v * n_rows + r) * n_out + w] = acc[v];
  }
}

// The thresholds of a table shared by every row, rounded and split once per
// block: thread i writes the bytes of row i (rows past 2^M read 0).
template <int M>
__device__ __forceinline__ NmThr<M> stage_thresholds(const float* __restrict__ cpt) {
  constexpr int G = NmThr<M>::G;
  __shared__ uint32_t s_thr[4 * G];     // hi words, then lo words
  uint8_t* bytes = reinterpret_cast<uint8_t*>(s_thr);
  for (int i = threadIdx.x; i < 8 * G; i += blockDim.x) {
    const uint32_t thr = i < (1 << M) ? nm_dac_threshold(cpt[i]) : 0u;
    bytes[i] = (uint8_t)nm_hi_byte(thr);
    bytes[8 * G + i] = (uint8_t)nm_lo_byte(thr);
  }
  __syncthreads();
  NmThr<M> t;
#pragma unroll
  for (int i = 0; i < 2 * G; ++i) {
    t.hi[i] = s_thr[i];
    t.lo[i] = s_thr[2 * G + i];
  }
  return t;
}

// Binary gather (ROWS false) or row encode (ROWS true; SELECTED hashes only
// the selected rows' words), one thread per output word.
template <int M, bool ROWS, bool SELECTED>
__global__ void node_mux_binary_kernel(const float* __restrict__ cpt, long long cpt_stride,
                                       const uint32_t* __restrict__ parents,
                                       uint32_t* __restrict__ out, long long n_rows,
                                       int n_out, uint32_t kd0, uint32_t kd1,
                                       uint32_t offset) {
  NmThr<M> shared{};
  if (cpt_stride == 0) shared = stage_thresholds<M>(cpt);
  const long long total = n_rows * (long long)n_out;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / n_out;
    const int w = (int)(t - r * n_out);
    const NmThr<M> thr = cpt_stride == 0 ? shared : nm_thresholds<M>(cpt + r * cpt_stride);
    if constexpr (ROWS) {
      out[t] = nm_rows_item<M, SELECTED>(thr, parents, n_rows, n_out, r, w, kd0, kd1, offset);
    } else {
      out[t] = nm_gather_item<M>(thr, parents, n_rows, n_out, r, w, kd0, kd1, offset);
    }
  }
}

// k-ary sample from a pattern table: tab[r * tab_stride + pattern * levels + v].
// KL is the level count k-1 when it is 1..3 (the compares unroll and the value
// bit-planes are known), else 0 and the run-time levels / vb hold.
template <int P, int KL>
__global__ void node_mux_cat_kernel(const uint16_t* __restrict__ tab, long long tab_stride,
                                    int levels_rt, int vb_rt, int staged,
                                    const uint32_t* __restrict__ parents,
                                    uint32_t* __restrict__ out, long long n_rows, int n_out,
                                    uint32_t kd0, uint32_t kd1, uint32_t offset) {
  constexpr int VB = KL > 0 ? value_bits(KL + 1) : 0;
  const int levels = KL > 0 ? KL : levels_rt;
  extern __shared__ uint16_t s_tab[];
  if (staged) {             // one table for every row: stage it once per block
    for (int i = threadIdx.x; i < (levels << P); i += blockDim.x) s_tab[i] = tab[i];
    __syncthreads();
  }
  const long long total = n_rows * (long long)n_out;
  const unsigned long long n_rand = 8ull * (unsigned long long)n_out;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / n_out;
    const int w = (int)(t - r * n_out);
    uint32_t par[P > 0 ? P : 1];
#pragma unroll
    for (int i = 0; i < P; ++i) par[i] = parents[((long long)i * n_rows + r) * n_out + w];
    const uint16_t* row = staged ? s_tab : tab + r * tab_stride;
    const uint32_t ctr0 = nm_first_counter((unsigned long long)r, n_rand, w, offset);
    uint32_t acc[MAX_VB];
#pragma unroll
    for (int v = 0; v < MAX_VB; ++v) acc[v] = 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t x = nm_hash(ctr0 + (uint32_t)e, kd0, kd1);
      uint32_t cw = 0;                      // the 4 positions' values, one per byte
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int pos = 4 * e + b;
        uint32_t pat = 0;
#pragma unroll
        for (int i = 0; i < P; ++i) pat |= ((par[i] >> pos) & 1u) << i;
        const uint32_t byte = (x >> (8 * b)) & 0xFFu;
        const uint16_t* lv = row + pat * levels;
        uint32_t cnt = 0;
        if (KL > 0) {
#pragma unroll
          for (int v = 0; v < KL; ++v) cnt += (uint32_t)(byte < lv[v]);
        } else {
          for (int v = 0; v < levels; ++v) cnt += (uint32_t)(byte < lv[v]);
        }
        cw |= cnt << (8 * b);
      }
      put_values<VB>(acc, vb_rt, cw, e);
    }
    store_values<VB>(acc, vb_rt, out, n_rows, n_out, r, w);
  }
}

// k-ary sample with the digits decoded at run time: cdf[r * cdf_stride + row * levels + v].
__global__ void node_mux_cat_wide_kernel(const uint32_t* __restrict__ cdf, long long cdf_stride,
                                         int levels, int vb, WideShape sh,
                                         const uint32_t* __restrict__ parents,
                                         uint32_t* __restrict__ out, long long n_rows,
                                         int n_out, uint32_t kd0, uint32_t kd1,
                                         uint32_t offset) {
  const long long total = n_rows * (long long)n_out;
  const unsigned long long n_rand = 8ull * (unsigned long long)n_out;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / n_out;
    const int w = (int)(t - r * n_out);
    unsigned long long idx[32];             // CPT row per stream position
#pragma unroll
    for (int pos = 0; pos < 32; ++pos) idx[pos] = 0ull;
    long long plane = 0;
    for (int j = 0; j < sh.n_parents; ++j) {
      const uint32_t card = (uint32_t)sh.card[j];
      uint32_t d[32];
#pragma unroll
      for (int pos = 0; pos < 32; ++pos) d[pos] = 0u;
      for (int bb = 0; (1u << bb) < card; ++bb, ++plane) {
        const uint32_t word = __ldg(parents + (plane * n_rows + r) * n_out + w);
#pragma unroll
        for (int pos = 0; pos < 32; ++pos) d[pos] |= ((word >> pos) & 1u) << bb;
      }
#pragma unroll
      for (int pos = 0; pos < 32; ++pos) idx[pos] = idx[pos] * card + (d[pos] < card ? d[pos] : 0u);
    }
    const uint32_t* row = cdf + r * cdf_stride;
    const uint32_t ctr0 = nm_first_counter((unsigned long long)r, n_rand, w, offset);
    uint32_t acc[MAX_VB];
#pragma unroll
    for (int v = 0; v < MAX_VB; ++v) acc[v] = 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t x = nm_hash(ctr0 + (uint32_t)e, kd0, kd1);
      uint32_t cw = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t byte = (x >> (8 * b)) & 0xFFu;
        const uint32_t* lv = row + idx[4 * e + b] * (unsigned long long)levels;
        uint32_t cnt = 0;
        for (int v = 0; v < levels; ++v) cnt += (uint32_t)(byte < __ldg(lv + v));
        cw |= cnt << (8 * b);
      }
      put_values<0>(acc, vb, cw, e);
    }
    store_values<0>(acc, vb, out, n_rows, n_out, r, w);
  }
}

// Row encode of only the selected rows: bit pos is byte (pos % 4) of entropy
// word pos / 4 of CPT row l(pos), the row the parents' bits name.
__global__ void node_mux_rows_wide_kernel(const float* __restrict__ cpt, long long cpt_stride,
                                          int m, const uint32_t* __restrict__ parents,
                                          uint32_t* __restrict__ out, long long n_rows,
                                          int n_out, uint32_t kd0, uint32_t kd1,
                                          uint32_t offset) {
  const long long total = n_rows * (long long)n_out;
  const unsigned long long n_rand = 8ull * (unsigned long long)n_out;
  const unsigned long long L = 1ull << m;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / n_out;
    const int w = (int)(t - r * n_out);
    unsigned long long l[32];               // CPT row per stream position
#pragma unroll
    for (int pos = 0; pos < 32; ++pos) l[pos] = 0ull;
    for (int j = 0; j < m; ++j) {           // first parent ends most significant
      const uint32_t word = __ldg(parents + ((long long)j * n_rows + r) * n_out + w);
#pragma unroll
      for (int pos = 0; pos < 32; ++pos) l[pos] = (l[pos] << 1) | ((word >> pos) & 1u);
    }
    const float* row = cpt + r * cpt_stride;
    uint32_t word = 0;
#pragma unroll
    for (int pos = 0; pos < 32; ++pos) {
      const uint32_t ctr = nm_first_counter((unsigned long long)r * L + l[pos], n_rand, w, offset)
                           + (uint32_t)(pos >> 2);
      const uint32_t x = nm_hash(ctr, kd0, kd1);
      const uint32_t thr = nm_dac_threshold(__ldg(row + l[pos]));
      word |= (uint32_t)(((x >> (8 * (pos & 3))) & 0xFFu) < thr) << pos;
    }
    out[t] = word;
  }
}

unsigned int grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1ll << 24)) blocks = 1ll << 24;  // the loop strides over the rest
  return (unsigned int)(blocks > 0 ? blocks : 1);
}

// Calls f(std::integral_constant<int, n>) for a run-time n in 0 .. N (N <= 8).
template <int N, class F>
int dispatch(int n, F&& f) {
  static_assert(N <= 8, "dispatch lists the counts 0 .. 8");
  if (n < 0 || n > N) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, (N >= 1 ? 1 : 0)>{});
    case 2: return f(std::integral_constant<int, (N >= 2 ? 2 : 0)>{});
    case 3: return f(std::integral_constant<int, (N >= 3 ? 3 : 0)>{});
    case 4: return f(std::integral_constant<int, (N >= 4 ? 4 : 0)>{});
    case 5: return f(std::integral_constant<int, (N >= 5 ? 5 : 0)>{});
    case 6: return f(std::integral_constant<int, (N >= 6 ? 6 : 0)>{});
    case 7: return f(std::integral_constant<int, (N >= 7 ? 7 : 0)>{});
    default: return f(std::integral_constant<int, (N >= 8 ? 8 : 0)>{});
  }
}

}  // namespace

// Each launcher returns the cudaError_t of its launch (0 on success).  Table
// strides count elements between rows' tables; 0 means one table for every row.

extern "C" int node_mux_gather_launch(const void* cpt, long long cpt_stride, const void* parents,
                                      void* out, long long n_rows, int n_out, int m,
                                      unsigned int kd0, unsigned int kd1, unsigned int offset,
                                      int threads, void* stream) {
  return dispatch<MAX_M>(m, [&](auto mc) {
    node_mux_binary_kernel<decltype(mc)::value, false, false>
        <<<grid_for(n_rows * n_out, threads), threads, 0, (cudaStream_t)stream>>>(
            (const float*)cpt, cpt_stride, (const uint32_t*)parents, (uint32_t*)out, n_rows,
            n_out, kd0, kd1, offset);
    return (int)cudaGetLastError();
  });
}

extern "C" int node_mux_rows_launch(const void* cpt, long long cpt_stride, const void* parents,
                                    void* out, long long n_rows, int n_out, int m,
                                    unsigned int kd0, unsigned int kd1, unsigned int offset,
                                    int threads, void* stream) {
  return dispatch<MAX_M>(m, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    node_mux_binary_kernel<M, true, nm_rows_selected(M)>
        <<<grid_for(n_rows * n_out, threads), threads, 0, (cudaStream_t)stream>>>(
            (const float*)cpt, cpt_stride, (const uint32_t*)parents, (uint32_t*)out, n_rows,
            n_out, kd0, kd1, offset);
    return (int)cudaGetLastError();
  });
}

// tab: (2^P, k-1) uint16 thresholds per row, P = n_planes.
extern "C" int node_mux_cat_launch(const void* tab, long long tab_stride, int levels, int vb,
                                   const void* parents, void* out, long long n_rows, int n_out,
                                   int n_planes, unsigned int kd0, unsigned int kd1,
                                   unsigned int offset, int threads, void* stream) {
  if (levels < 1 || vb < 1 || vb > MAX_VB) return (int)cudaErrorInvalidValue;
  const int kl = levels <= 3 ? levels : 0;
  return dispatch<MAX_PAT>(n_planes, [&](auto pc) {
    return dispatch<3>(kl, [&](auto lc) {
      constexpr int P = decltype(pc)::value;
      constexpr int KL = decltype(lc)::value;
      const long long bytes = (2ll * levels) << P;
      const int staged = tab_stride == 0 && bytes <= STAGE_BYTES;
      node_mux_cat_kernel<P, KL><<<grid_for(n_rows * n_out, threads), threads,
                                   staged ? (size_t)bytes : 0, (cudaStream_t)stream>>>(
          (const uint16_t*)tab, tab_stride, levels, vb, staged, (const uint32_t*)parents,
          (uint32_t*)out, n_rows, n_out, kd0, kd1, offset);
      return (int)cudaGetLastError();
    });
  });
}

// cdf: (prod(cards), k-1) uint32 thresholds per row; cards: the n_parents
// parent cardinalities, first parent first (host memory).
extern "C" int node_mux_cat_wide_launch(const void* cdf, long long cdf_stride, int levels,
                                        int vb, const int* cards, int n_parents,
                                        const void* parents, void* out, long long n_rows,
                                        int n_out, unsigned int kd0, unsigned int kd1,
                                        unsigned int offset, int threads, void* stream) {
  if (levels < 1 || vb < 1 || vb > MAX_VB || n_parents < 0 || n_parents > MAX_WIDE) {
    return (int)cudaErrorInvalidValue;
  }
  WideShape sh{};
  sh.n_parents = n_parents;
  for (int j = 0; j < n_parents; ++j) sh.card[j] = cards[j];
  node_mux_cat_wide_kernel<<<grid_for(n_rows * n_out, threads), threads, 0,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)cdf, cdf_stride, levels, vb, sh, (const uint32_t*)parents,
      (uint32_t*)out, n_rows, n_out, kd0, kd1, offset);
  return (int)cudaGetLastError();
}

extern "C" int node_mux_rows_wide_launch(const void* cpt, long long cpt_stride,
                                         const void* parents, void* out, long long n_rows,
                                         int n_out, int m, unsigned int kd0, unsigned int kd1,
                                         unsigned int offset, int threads, void* stream) {
  if (m < 0 || m >= MAX_WIDE) return (int)cudaErrorInvalidValue;
  node_mux_rows_wide_kernel<<<grid_for(n_rows * n_out, threads), threads, 0,
                              (cudaStream_t)stream>>>(
      (const float*)cpt, cpt_stride, m, (const uint32_t*)parents, (uint32_t*)out, n_rows,
      n_out, kd0, kd1, offset);
  return (int)cudaGetLastError();
}
