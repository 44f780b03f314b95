// sne_encode: the stochastic number encoder (SNE), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/sne_encode/kernel.py::_sne_kernel
// (wrapper sne_encode_pallas) together with the entropy its caller drew
// (repro/core/rng.py::counter_hash_words).
//
// What it computes, for every row r (one probability p[r]) and packed output
// word w: the DAC threshold t = round(p * 256) (half to even: rintf, not
// roundf) clipped to [0, 256]; the 8 entropy words i = 8w .. 8w+7 of the row,
// each lowbias32(lowbias32(ctr ^ kd0) ^ kd1) of its counter ctr = r * n_rand
// + i + offset mod 2^32 (the row-major flat index, computed in 64 bits and
// then truncated, so the counters wrap exactly as the reference's uint32
// iota does); and byte b of word i compared with t, the bit landing at
// 4 * (i % 8) + b of the output word (the reference's interleaved layout).
//
// Design.  The Pallas kernel reads pre-drawn entropy from HBM: 8 bytes of
// entropy traffic per stream bit, and 68 GB of words at the paper-bayes-fusion
// size.  Here the words are hashed in registers and never stored, so the
// kernel reads 4 bytes per row and writes n_bits / 8 bytes.  One thread owns
// one output word (r, w) at a time, so neighbouring threads store
// neighbouring words and the grid has rows * n_bits / 32 items -- 131,072 at
// the unfused root shape (1024 rows of 4096 bits), 128 for a single shared
// root.  A row at level 0 or 256 needs no entropy (its words are all zero or
// all one), and softmax posteriors put many rows there (44 % of the full
// paper-bayes-fusion batch).  So a block takes a tile of 256 * chunk items in
// two passes: the first stores the constant words and queues the others in
// shared memory; the second hashes the queue a thread per item, packed into
// the block's first warps, while warps with nothing queued leave the SM to
// other blocks.  The wrapper picks chunk (1 to 8), the most that still fills
// the card: chunk 1 at the root shapes, 8 at the full batch, where a tile's
// queued work then spreads over all warps and all four SM sub-partitions.
// The per-word body (hash, SWAR compare of 4 bytes against the row's
// threshold, pack) is sne_body.h, which bayes_decide.cu and a host test
// build too.  The tile loop walks (r, w) by increments; inside a tile an item
// divides its 32-bit offset by n_out.
//
// Bound on H100.  Integer work per entropy word that needs a hash: 12 shifts
// and 3-input XORs of the hash, 2 logic operations of the compare and 1
// funnel shift of the pack on the 64 ALU lanes of an SM; 4 multiplies, the
// counter's add, the compare's subtract and the pack's multiply may also use
// the other 64.  n_bits / 4 entropy words per row whose level is not 0 or
// 256; the bytes (p in, packed words out) take less time at 3.35 TB/s, so the
// kernel is bound by operations.
#include <cstdint>
#include <cuda_runtime.h>

#include "sne_body.h"

namespace {

constexpr int THREADS = 256;   // threads per block
constexpr int MAX_CHUNK = 8;   // a tile holds up to THREADS * MAX_CHUNK words (and rows)

// chunk 1: a thread per word (r, w) in turn; a grid-stride loop walks (r, w) by
// increments, so no item divides its index
__device__ void encode_words(const float* __restrict__ p, uint32_t* __restrict__ out,
                             long long n_rows, int n_out, SneKey key, uint32_t offset) {
  const unsigned long long n_items = (unsigned long long)n_rows * (unsigned long long)n_out;
  const unsigned long long n_rand = 8ull * (unsigned long long)n_out;
  const unsigned int no = (unsigned int)n_out;
  const unsigned int first = blockIdx.x * THREADS + threadIdx.x, stride = gridDim.x * THREADS;
  unsigned long long r = first / no;
  unsigned int w = first % no;
  const unsigned long long dr = stride / no;
  const unsigned int dw = stride % no;
  for (unsigned long long i = first; i < n_items; i += stride) {
    const uint32_t t = sne_level(p[r]);
    out[i] = sne_constant(t) ? sne_constant_word(t)
                             : sne_word(sne_first_counter(r, n_rand, (int)w, offset),
                                        sne_threshold_of_level(t), key);
    r += dr;
    w += dw;
    if (w >= no) {
      w -= no;
      ++r;
    }
  }
}

// chunk > 1: a block takes tiles of `tile_rows` rows.  Pass 1, a thread per row:
// its level into shared memory, and the row into the queue if it needs a hash.
// Pass 2: the constant words of the tile, a thread per word; then the queued
// rows' words, a thread per word, packed into the block's first warps.  With
// 8 rows' worth of words per thread the queued work spreads over every warp.
__device__ void encode_tiles(const float* __restrict__ p, uint32_t* __restrict__ out,
                             long long n_rows, int n_out, int log2_out, int tile_rows,
                             SneKey key, uint32_t offset) {
  __shared__ uint16_t level[THREADS * MAX_CHUNK];
  __shared__ uint16_t queue[THREADS * MAX_CHUNK];
  __shared__ int n_queued;
  const unsigned long long n_rand = 8ull * (unsigned long long)n_out;
  const unsigned int no = (unsigned int)n_out, lane = threadIdx.x & 31u;
  const long long n_tiles = (n_rows + tile_rows - 1) / tile_rows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * tile_rows;
    const int rows = (int)min((long long)tile_rows, n_rows - r0);
    const unsigned long long base = (unsigned long long)r0 * no;   // the tile's first word
    if (threadIdx.x == 0) n_queued = 0;
    __syncthreads();
    for (int x0 = 0; x0 < rows; x0 += THREADS) {
      const int x = x0 + (int)threadIdx.x;
      bool hashed = false;
      if (x < rows) {
        const uint32_t t = sne_level(p[r0 + x]);
        level[x] = (uint16_t)t;
        hashed = !sne_constant(t);
      }
      const unsigned int ballot = __ballot_sync(0xFFFFFFFFu, hashed);
      int slot = 0;
      if (lane == 0 && ballot) slot = atomicAdd(&n_queued, __popc(ballot));
      slot = __shfl_sync(0xFFFFFFFFu, slot, 0);
      if (hashed) queue[slot + __popc(ballot & ((1u << lane) - 1u))] = (uint16_t)x;
    }
    __syncthreads();
    const unsigned int items = (unsigned int)rows * no;
    for (unsigned int c = threadIdx.x; c < items; c += THREADS) {
      const uint32_t t = level[log2_out >= 0 ? c >> log2_out : c / no];
      if (sne_constant(t)) out[base + c] = sne_constant_word(t);
    }
    const unsigned int units = (unsigned int)n_queued * no;
    for (unsigned int u = threadIdx.x; u < units; u += THREADS) {
      const unsigned int q = log2_out >= 0 ? u >> log2_out : u / no;
      const unsigned int x = queue[q], w = u - q * no;
      const unsigned long long r = (unsigned long long)r0 + x;
      out[base + (unsigned long long)x * no + w] =
          sne_word(sne_first_counter(r, n_rand, (int)w, offset),
                   sne_threshold_of_level(level[x]), key);
    }
    __syncthreads();   // shared memory is read before the next tile refills it
  }
}

__global__ void __launch_bounds__(THREADS)
sne_encode_kernel(const float* __restrict__ p, uint32_t* __restrict__ out, long long n_rows,
                  int n_out, int log2_out, int tile_rows, SneKey key, uint32_t offset) {
  if (tile_rows == 0) {
    encode_words(p, out, n_rows, n_out, key, offset);
  } else {
    encode_tiles(p, out, n_rows, n_out, log2_out, tile_rows, key, offset);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  chunk 1 runs a thread
// per word; chunk 2..8 tiles of chunk * 256 words' rows (at least one row).
extern "C" int sne_encode_launch(const void* p, void* out, long long n_rows, int n_out,
                                 unsigned int kd0, unsigned int kd1, unsigned int offset,
                                 int chunk, int max_blocks, void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  int log2_out = -1, tile_rows = 0;
  long long blocks = (n_rows * (long long)n_out + THREADS - 1) / THREADS;
  if (chunk > 1) {
    if ((n_out & (n_out - 1)) == 0) log2_out = __builtin_ctz((unsigned int)n_out);
    tile_rows = THREADS * chunk / n_out;
    if (tile_rows < 1) tile_rows = 1;
    blocks = (n_rows + tile_rows - 1) / tile_rows;
  }
  if (blocks > max_blocks) blocks = max_blocks;   // the loops stride over the rest
  sne_encode_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)p, (uint32_t*)out, n_rows, n_out, log2_out, tile_rows,
      sne_key(kd0, kd1), offset);
  return (int)cudaGetLastError();
}
