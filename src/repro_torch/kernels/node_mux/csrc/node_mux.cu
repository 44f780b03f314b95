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
//   * binary gather and rows, m <= 6 parents: templated on m, so the
//     thresholds, parent words and the L = 2^m leaf words stay in registers
//     and the select trees unroll.
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
//     output word where the templated kernel hashes 8 L.
//
// Bound on H100.  Integer work: two lowbias32 rounds and the key XORs (18
// operations) for each entropy word the function needs, plus one compare per
// byte and CDF level, over the card's INT32 rate.  The bytes (parents' words
// in, the node's words out) take less time at 3.35 TB/s, so all are bound by
// operations.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

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

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_word(uint32_t ctr, uint32_t kd0, uint32_t kd1) {
  return lowbias32(lowbias32(ctr ^ kd0) ^ kd1);
}

// round(p * 256) clipped to [0, 256]; p * 256 is exact in float32.
__device__ __forceinline__ uint32_t dac_threshold(float p) {
  return (uint32_t)fminf(fmaxf(rintf(p * 256.0f), 0.0f), 256.0f);
}

// Counter of entropy word 0 of output word w: (base_row * n_rand + 8 w) mod 2^32 + offset.
__device__ __forceinline__ uint32_t first_counter(unsigned long long base_row,
                                                  unsigned long long n_rand, int w,
                                                  uint32_t offset) {
  return (uint32_t)(base_row * n_rand + 8ull * (unsigned long long)w) + offset;
}

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

template <int M>
__global__ void node_mux_gather_kernel(const float* __restrict__ cpt, long long cpt_stride,
                                       const uint32_t* __restrict__ parents,
                                       uint32_t* __restrict__ out, long long n_rows,
                                       int n_out, uint32_t kd0, uint32_t kd1,
                                       uint32_t offset) {
  constexpr int L = 1 << M;
  const long long total = n_rows * (long long)n_out;
  const unsigned long long n_rand = 8ull * (unsigned long long)n_out;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / n_out;
    const int w = (int)(t - r * n_out);
    uint32_t thr[L];
#pragma unroll
    for (int l = 0; l < L; ++l) thr[l] = dac_threshold(cpt[r * cpt_stride + l]);
    uint32_t par[M > 0 ? M : 1];
#pragma unroll
    for (int i = 0; i < M; ++i) par[i] = parents[((long long)i * n_rows + r) * n_out + w];
    const uint32_t ctr0 = first_counter((unsigned long long)r, n_rand, w, offset);
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t x = hash_word(ctr0 + (uint32_t)e, kd0, kd1);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int pos = 4 * e + b;
        // select tree over the thresholds, last parent first
        uint32_t lv[L];
#pragma unroll
        for (int l = 0; l < L; ++l) lv[l] = thr[l];
#pragma unroll
        for (int j = M - 1; j >= 0; --j) {
          const bool bit = (par[j] >> pos) & 1u;
#pragma unroll
          for (int i = 0; i < (1 << j); ++i) lv[i] = bit ? lv[2 * i + 1] : lv[2 * i];
        }
        word |= (uint32_t)(((x >> (8 * b)) & 0xFFu) < lv[0]) << pos;
      }
    }
    out[t] = word;
  }
}

template <int M>
__global__ void node_mux_rows_kernel(const float* __restrict__ cpt, long long cpt_stride,
                                     const uint32_t* __restrict__ parents,
                                     uint32_t* __restrict__ out, long long n_rows,
                                     int n_out, uint32_t kd0, uint32_t kd1,
                                     uint32_t offset) {
  constexpr int L = 1 << M;
  const long long total = n_rows * (long long)n_out;
  const unsigned long long n_rand = 8ull * (unsigned long long)n_out;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / n_out;
    const int w = (int)(t - r * n_out);
    uint32_t leaf[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const uint32_t thr = dac_threshold(cpt[r * cpt_stride + l]);
      const uint32_t ctr0 =
          first_counter((unsigned long long)r * L + (unsigned long long)l, n_rand, w, offset);
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t x = hash_word(ctr0 + (uint32_t)e, kd0, kd1);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          word |= (uint32_t)(((x >> (8 * b)) & 0xFFu) < thr) << (4 * e + b);
        }
      }
      leaf[l] = word;
    }
    // value-select MUX tree over the leaf words, last parent first
#pragma unroll
    for (int j = M - 1; j >= 0; --j) {
      const uint32_t s = parents[((long long)j * n_rows + r) * n_out + w];
#pragma unroll
      for (int i = 0; i < (1 << j); ++i) leaf[i] = (s & leaf[2 * i + 1]) | (~s & leaf[2 * i]);
    }
    out[t] = leaf[0];
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
    const uint32_t ctr0 = first_counter((unsigned long long)r, n_rand, w, offset);
    uint32_t acc[MAX_VB];
#pragma unroll
    for (int v = 0; v < MAX_VB; ++v) acc[v] = 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t x = hash_word(ctr0 + (uint32_t)e, kd0, kd1);
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
    const uint32_t ctr0 = first_counter((unsigned long long)r, n_rand, w, offset);
    uint32_t acc[MAX_VB];
#pragma unroll
    for (int v = 0; v < MAX_VB; ++v) acc[v] = 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t x = hash_word(ctr0 + (uint32_t)e, kd0, kd1);
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
      const uint32_t ctr = first_counter((unsigned long long)r * L + l[pos], n_rand, w, offset)
                           + (uint32_t)(pos >> 2);
      const uint32_t x = hash_word(ctr, kd0, kd1);
      const uint32_t thr = dac_threshold(__ldg(row + l[pos]));
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
    node_mux_gather_kernel<decltype(mc)::value>
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
    node_mux_rows_kernel<decltype(mc)::value>
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
