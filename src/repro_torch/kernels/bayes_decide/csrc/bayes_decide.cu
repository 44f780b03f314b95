// bayes_decide: the fused multimodal Bayes decision, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/bayes_decide/kernel.py::_decide_kernel
// (wrapper bayes_decide_pallas) together with the entropy its caller drew
// (repro/core/rng.py::counter_hash_words over (M, R, K, n_rand)).
//
// What it computes, for every row r: for each class k, the popcount of the
// AND over the M modalities of the stream that encodes p[m, r, k] (DAC
// threshold round(p * 256), half to even; 4 comparator bytes per entropy
// word); then the first-occurrence argmax over k (ties go to the lowest
// class, all-zero counts decide 0).  Entropy word i of stream (m, r, k) is
// lowbias32(lowbias32(ctr ^ kd0) ^ kd1) with ctr = ((m * R + r) * K + k) *
// n_rand + i + offset mod 2^32: the counters of sne_encode over the flattened
// (M, R, K) rows, so the decision equals sne_encode -> pand_popcount ->
// argmax bit for bit.
//
// Design.  The Pallas kernel reads (M, R, K, n_rand) pre-drawn words from
// HBM: 136 GB at the paper-bayes-fusion size as the port's int64 carrier, too
// large for the card.  Here the entropy is hashed in registers with
// sne_encode's per-word body (../../sne_encode/csrc/sne_body.h), so neither
// entropy nor streams are stored.  A stream with a modality at level 0 counts
// 0 and one with every modality at 256 counts n_bits, with no hash; softmax
// posteriors put most streams there (69 % of the full paper-bayes-fusion
// batch).  So a block takes a tile of `rows_per_tile` rows in windows of
// streams, each in two passes: first a thread per stream (`chunk` streams
// each) loads its streams' probabilities, a modality at a time with the
// chunk's loads in flight together, classifies them by comparing p with the
// levels' edges (level 0 is p <= 1/512, NaN included; 256 is p >= 511/512),
// stores those counts and queues the others in shared memory; then
// `split` threads per queued stream (a power of two up to 32, adjacent lanes
// of one warp, packed into the block's first warps) share its words, each
// ANDing the hashed modalities of its words and popcounting them, and add
// their counts with __shfl_xor_sync; lane 0 stores counts[r, k].  A window's
// last round is partial, on the block's first warps; the H100 places a
// block's warps on all four SM sub-partitions alike, so those rounds load them
// evenly (counted per sub-partition on the full batch: within 0.4 % of the
// mean).  After the tile's last window a thread per row reads the row's K
// counts back and stores the argmax, so K is arbitrary.  The wrapper picks
// split, then chunk, from (R, K, n_out): small batches still fill the card
// (bench_latency's 4096 decisions of M = K = 2 at 128 bits run 32,768 threads
// in 256 blocks, not 4096 threads in 32), and the full batch takes one thread
// per stream and 8 streams per thread, so a tile's queued work spreads over
// all its warps.
//
// Counter.  Given a non-null `queued`, each block sums the streams it queues
// for hashing (those with no modality at 0 and some below 256) and adds the
// sum to *queued with one atomic at its end; the total stays on the device
// across launches.  With a null pointer the counting is skipped.
//
// Bound on H100.  sne_encode's integer work per entropy word, n_bits / 4
// entropy words per hashed modality of a queued stream, plus the AND over
// those modalities and one popcount per stream word and the argmax's compare
// per class.  The bytes (p in; counts and decisions out) take far less time,
// so the kernel is bound by operations.
#include <cstdint>
#include <cuda_runtime.h>

#include "../../sne_encode/csrc/sne_body.h"

namespace {

constexpr int QUEUE = 1024;   // streams one pass classifies, at most: threads * chunk / split
constexpr int MAX_CHUNK = 8;  // streams a thread classifies per pass
constexpr float LEVEL0_EDGE = 0x1p-9f;       // p * 256 <= 0.5 rounds to level 0
constexpr float LEVEL256_EDGE = 0x1.ffp-1f;  // p * 256 >= 255.5 rounds to level 256

// The count of stream `row` over this thread's words, the split lanes' sum
// left in every lane: a dead stream counts 0 and a full one n_bits, unhashed.
__device__ int stream_count(const float* __restrict__ p, unsigned long long plane, int n_mod,
                            unsigned long long row, bool valid, int n_out, int s, int split,
                            int kind, SneKey key, uint32_t offset) {
  int c = 0;
  if (valid && kind == SNE_HASHED) {
    c = sne_stream_count(p + row, plane, n_mod, row, plane, n_out, s, split, key, offset);
  } else if (valid && kind == SNE_FULL && s == 0) {
    c = 32 * n_out;
  }
  for (int o = split >> 1; o > 0; o >>= 1) c += __shfl_xor_sync(0xFFFFFFFFu, c, o);
  return c;
}

// chunk 1: the K * split threads of each row of the tile in turn, every stream
// where it lies; every lane of a warp runs every pass, so the shuffles see
// whole warps, and a stream's split lanes are adjacent and aligned in one warp.
// Returns the hashed streams whose lane 0 is this thread's, if `tally`.
__device__ unsigned int decide_streams(const float* __restrict__ p, int* counts, int n_mod,
                                       long long n_rows, int n_cls, int n_out, int log2_split,
                                       long long row0, int rows, SneKey key, uint32_t offset,
                                       bool tally) {
  const unsigned long long plane = (unsigned long long)n_rows * n_cls;
  const int split = 1 << log2_split, group = n_cls * split, items = rows * group;
  unsigned int hashed = 0;
  for (int base = 0; base < items; base += blockDim.x) {
    const int i = base + (int)threadIdx.x;
    const int j = i % group, s = j & (split - 1);
    const bool valid = i < items;
    const unsigned long long row =
        (unsigned long long)(row0 + i / group) * n_cls + (j >> log2_split);
    const int kind = valid ? sne_stream_kind(p + row, plane, n_mod) : SNE_DEAD;
    const int c = stream_count(p, plane, n_mod, row, valid, n_out, s, split, kind, key, offset);
    if (valid && s == 0) counts[row] = c;
    if (tally) hashed += valid && s == 0 && kind == SNE_HASHED;
  }
  return hashed;
}

// chunk > 1: windows of the tile's streams, each in two passes.  Pass 1, a
// thread per stream (chunk each): a dead or full stream's count is stored, one
// that needs a hash is queued.  Pass 2: split lanes per queued stream, packed
// into the block's first warps; a warp past the last stream skips the pass.
// Returns the tile's queued streams in thread 0, if `tally` (0 elsewhere).
__device__ unsigned int decide_queued(const float* __restrict__ p, int* counts, int n_mod,
                                      long long n_rows, int n_cls, int n_out, int log2_split,
                                      int chunk, long long row0, int rows, SneKey key,
                                      uint32_t offset, bool tally) {
  __shared__ int queue[QUEUE];
  __shared__ int n_queued;
  const unsigned long long plane = (unsigned long long)n_rows * n_cls;
  const int split = 1 << log2_split, threads = (int)blockDim.x;
  const int window = (threads >> log2_split) * chunk;
  const int i = (int)threadIdx.x, lane = i & 31, s = i & (split - 1);
  const int streams = rows * n_cls;
  const unsigned long long s0 = (unsigned long long)row0 * n_cls;   // the tile's first stream
  unsigned int tile_queued = 0;
  for (int first = 0; first < streams; first += window) {
    if (i == 0) n_queued = 0;
    // bit c of dead / full: stream first + c * threads + i has a modality at
    // level 0 / every modality at 256
    unsigned int dead = 0, full = (1u << MAX_CHUNK) - 1;
    const float* pm = p + s0 + first + i;
    for (int m = 0; m < n_mod; ++m, pm += plane) {
      float v[MAX_CHUNK];
#pragma unroll
      for (int c = 0; c < MAX_CHUNK; ++c) {
        const int x = c * threads + i;
        v[c] = c < chunk && x < window && first + x < streams ? pm[c * threads] : 0.5f;
      }
#pragma unroll
      for (int c = 0; c < MAX_CHUNK; ++c) {
        dead |= (unsigned int)!(v[c] > LEVEL0_EDGE) << c;
        full &= ~((unsigned int)!(v[c] >= LEVEL256_EDGE) << c);
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < MAX_CHUNK; ++c) {
      if (c >= chunk) break;
      const int x0 = c * threads, j = first + x0 + i;
      const bool in = x0 + i < window && j < streams;
      const bool hashed = in && !((dead | full) >> c & 1u);
      if (in && !hashed) counts[s0 + j] = (dead >> c & 1u) ? 0 : 32 * n_out;
      const unsigned int ballot = __ballot_sync(0xFFFFFFFFu, hashed);
      int slot = 0;
      if (lane == 0 && ballot) slot = atomicAdd(&n_queued, __popc(ballot));
      slot = __shfl_sync(0xFFFFFFFFu, slot, 0);
      if (hashed) queue[slot + __popc(ballot & ((1u << lane) - 1u))] = j;
    }
    __syncthreads();
    if (tally && i == 0) tile_queued += n_queued;
    const int units = n_queued * split;
    for (int u0 = 0; u0 < units; u0 += threads) {
      if (u0 + (i & ~31) < units) {
        const int u = u0 + i;
        const bool valid = u < units;
        const unsigned long long row = s0 + (valid ? queue[u >> log2_split] : 0);
        const int c = stream_count(p, plane, n_mod, row, valid, n_out, s, split, SNE_HASHED,
                                   key, offset);
        if (valid && s == 0) counts[row] = c;
      }
    }
    __syncthreads();   // the queue is read before the next window refills it
  }
  return tile_queued;
}

// A block takes tiles of `rows_per_tile` rows; after a tile's streams are
// counted, a thread per row reads the row's K counts back and stores the argmax.
// With `queued`, the block's queued streams are summed in shared memory and
// added to *queued once, by thread 0, at the block's end.
__global__ void bayes_decide_kernel(const float* __restrict__ p, int* __restrict__ dec,
                                    int* counts, int n_mod, long long n_rows, int n_cls,
                                    int n_out, int log2_split, int chunk, int rows_per_tile,
                                    SneKey key, uint32_t offset,
                                    unsigned long long* __restrict__ queued) {
  __shared__ unsigned int block_hashed;
  const bool tally = queued != nullptr;
  if (tally && threadIdx.x == 0) block_hashed = 0;
  unsigned int hashed = 0;
  const long long n_tiles = (n_rows + rows_per_tile - 1) / rows_per_tile;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * rows_per_tile;
    const int rows = (int)min((long long)rows_per_tile, n_rows - row0);
    if (chunk == 1) {
      hashed += decide_streams(p, counts, n_mod, n_rows, n_cls, n_out, log2_split, row0, rows,
                               key, offset, tally);
    } else {
      hashed += decide_queued(p, counts, n_mod, n_rows, n_cls, n_out, log2_split, chunk, row0,
                              rows, key, offset, tally);
    }
    __syncthreads();   // the tile's counts are stored and visible to the block
    for (int x = (int)threadIdx.x; x < rows; x += blockDim.x) {
      dec[row0 + x] = sne_argmax(counts + (unsigned long long)(row0 + x) * n_cls, n_cls);
    }
  }
  if (tally) {
    // a warp's sum by shuffles, one shared add per warp, one global add per block
    for (int o = 16; o > 0; o >>= 1) hashed += __shfl_xor_sync(0xFFFFFFFFu, hashed, o);
    __syncthreads();   // block_hashed is zeroed before any warp adds to it
    if ((threadIdx.x & 31) == 0 && hashed) atomicAdd(&block_hashed, hashed);
    __syncthreads();
    if (threadIdx.x == 0 && block_hashed) atomicAdd(queued, (unsigned long long)block_hashed);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int bayes_decide_launch(const void* p, void* dec, void* counts, int n_mod,
                                   long long n_rows, int n_cls, int n_out,
                                   unsigned int kd0, unsigned int kd1, unsigned int offset,
                                   int log2_split, int chunk, int rows_per_tile, int threads,
                                   int max_blocks, void* stream, void* queued) {
  if (threads % 32 || chunk < 1 || chunk > MAX_CHUNK || (threads >> log2_split) * chunk > QUEUE) {
    return (int)cudaErrorInvalidValue;
  }
  long long blocks = (n_rows + rows_per_tile - 1) / rows_per_tile;
  if (blocks > max_blocks) blocks = max_blocks;   // the tile loop strides over the rest
  bayes_decide_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)p, (int*)dec, (int*)counts, n_mod, n_rows, n_cls, n_out, log2_split, chunk,
      rows_per_tile, sne_key(kd0, kd1), offset, (unsigned long long*)queued);
  return (int)cudaGetLastError();
}
