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
// registers and never stored, so a launch reads only the CPT row and the
// parents' words and writes the node's words.  The binary kernels are
// templated on the parent count m <= 6, so the thresholds, parent words and
// the L = 2^m leaf words stay in registers and the select trees unroll.  The
// categorical kernel takes its cardinalities at run time and keeps the parent
// planes in a small local array.
//
// Bound on H100.  Integer work: two lowbias32 rounds and the key XORs (18
// operations) plus one compare per byte and CDF level, for each entropy word
// (8 per output word; 8 L in row mode), over the card's INT32 rate.  The
// bytes (parents' words in, the node's words out) take less time at 3.35 TB/s,
// so all three are bound by operations.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_M = 6;        // binary kernels: parents per node (L = 2^m rows)
constexpr int MAX_PARENTS = 16; // categorical kernel: parents per node
constexpr int MAX_PLANES = 32;  // categorical kernel: parent value bit-planes
constexpr int MAX_VB = 8;       // categorical kernel: value bit-planes (k <= 256)

struct CatShape {
  int n_parents;
  int levels;                   // k - 1 thresholds per CPT row
  int vb;                       // value_bits(k)
  int n_planes;                 // total parent planes
  int card[MAX_PARENTS];        // parent cardinalities, first parent first
  int vbits[MAX_PARENTS];       // value_bits of each parent
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

template <int M>
__global__ void node_mux_gather_kernel(const float* __restrict__ cpt,
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
    for (int l = 0; l < L; ++l) thr[l] = dac_threshold(cpt[r * L + l]);
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
__global__ void node_mux_rows_kernel(const float* __restrict__ cpt,
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
      const uint32_t thr = dac_threshold(cpt[r * L + l]);
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

__global__ void node_mux_cat_kernel(const uint32_t* __restrict__ cdf,
                                    const uint32_t* __restrict__ parents,
                                    uint32_t* __restrict__ out, long long n_rows,
                                    int n_out, int n_cpt_rows, CatShape sh,
                                    uint32_t kd0, uint32_t kd1, uint32_t offset) {
  const long long total = n_rows * (long long)n_out;
  const unsigned long long n_rand = 8ull * (unsigned long long)n_out;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / n_out;
    const int w = (int)(t - r * n_out);
    uint32_t par[MAX_PLANES];
    for (int i = 0; i < sh.n_planes; ++i) {
      par[i] = parents[((long long)i * n_rows + r) * n_out + w];
    }
    const uint32_t* row_cdf = cdf + (unsigned long long)r * n_cpt_rows * sh.levels;
    const uint32_t ctr0 = first_counter((unsigned long long)r, n_rand, w, offset);
    uint32_t acc[MAX_VB];
#pragma unroll
    for (int v = 0; v < MAX_VB; ++v) acc[v] = 0u;
    for (int e = 0; e < 8; ++e) {
      const uint32_t x = hash_word(ctr0 + (uint32_t)e, kd0, kd1);
      for (int b = 0; b < 4; ++b) {
        const int pos = 4 * e + b;
        int idx = 0;
        int plane = 0;
        for (int j = 0; j < sh.n_parents; ++j) {
          int d = 0;
          for (int bb = 0; bb < sh.vbits[j]; ++bb) d |= (int)((par[plane + bb] >> pos) & 1u) << bb;
          plane += sh.vbits[j];
          idx = idx * sh.card[j] + (d < sh.card[j] ? d : 0);
        }
        const uint32_t byte = (x >> (8 * b)) & 0xFFu;
        const uint32_t* lv = row_cdf + (long long)idx * sh.levels;
        uint32_t cnt = 0;
        for (int v = 0; v < sh.levels; ++v) cnt += (uint32_t)(byte < lv[v]);
#pragma unroll
        for (int v = 0; v < MAX_VB; ++v) acc[v] |= ((cnt >> v) & 1u) << pos;
      }
    }
    for (int v = 0; v < sh.vb; ++v) out[((long long)v * n_rows + r) * n_out + w] = acc[v];
  }
}

unsigned int grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1ll << 24)) blocks = 1ll << 24;  // the loop strides over the rest
  return (unsigned int)(blocks > 0 ? blocks : 1);
}

// Calls f(std::integral_constant<int, m>) for the run-time parent count m.
static_assert(MAX_M == 6, "dispatch_m lists the parent counts 0 .. MAX_M");
template <class F>
int dispatch_m(int m, F&& f) {
  switch (m) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each launcher returns the cudaError_t of its launch (0 on success).

extern "C" int node_mux_gather_launch(const void* cpt, const void* parents, void* out,
                                      long long n_rows, int n_out, int m, unsigned int kd0,
                                      unsigned int kd1, unsigned int offset, int threads,
                                      void* stream) {
  return dispatch_m(m, [&](auto mc) {
    node_mux_gather_kernel<decltype(mc)::value>
        <<<grid_for(n_rows * n_out, threads), threads, 0, (cudaStream_t)stream>>>(
            (const float*)cpt, (const uint32_t*)parents, (uint32_t*)out, n_rows, n_out, kd0,
            kd1, offset);
    return (int)cudaGetLastError();
  });
}

extern "C" int node_mux_rows_launch(const void* cpt, const void* parents, void* out,
                                    long long n_rows, int n_out, int m, unsigned int kd0,
                                    unsigned int kd1, unsigned int offset, int threads,
                                    void* stream) {
  return dispatch_m(m, [&](auto mc) {
    node_mux_rows_kernel<decltype(mc)::value>
        <<<grid_for(n_rows * n_out, threads), threads, 0, (cudaStream_t)stream>>>(
            (const float*)cpt, (const uint32_t*)parents, (uint32_t*)out, n_rows, n_out, kd0,
            kd1, offset);
    return (int)cudaGetLastError();
  });
}

// cards: k then the n_parents parent cardinalities (host memory).
extern "C" int node_mux_cat_launch(const void* cdf, const void* parents, void* out,
                                   long long n_rows, int n_out, const int* cards,
                                   int n_parents, unsigned int kd0, unsigned int kd1,
                                   unsigned int offset, int threads, void* stream) {
  if (n_parents < 0 || n_parents > MAX_PARENTS) return (int)cudaErrorInvalidValue;
  auto value_bits = [](int k) { int b = 0; while ((1 << b) < k) ++b; return b; };
  CatShape sh{};
  sh.n_parents = n_parents;
  sh.levels = cards[0] - 1;
  sh.vb = value_bits(cards[0]);
  int n_cpt_rows = 1;
  for (int j = 0; j < n_parents; ++j) {
    sh.card[j] = cards[1 + j];
    sh.vbits[j] = value_bits(cards[1 + j]);
    sh.n_planes += sh.vbits[j];
    n_cpt_rows *= cards[1 + j];
  }
  if (sh.levels < 1 || sh.vb > MAX_VB || sh.n_planes > MAX_PLANES) {
    return (int)cudaErrorInvalidValue;
  }
  node_mux_cat_kernel<<<grid_for(n_rows * n_out, threads), threads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)cdf, (const uint32_t*)parents, (uint32_t*)out, n_rows, n_out,
      n_cpt_rows, sh, kd0, kd1, offset);
  return (int)cudaGetLastError();
}
