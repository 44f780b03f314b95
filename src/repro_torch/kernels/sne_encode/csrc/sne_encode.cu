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
// one row and writes its words in turn.
//
// Bound on H100.  Integer work: two lowbias32 rounds and the key XORs (18
// operations) plus 4 byte compares per entropy word, n_bits / 4 entropy words
// per row, over the card's INT32 rate.  The bytes (p in, packed words out)
// take about a tenth of that time at 3.35 TB/s, so the kernel is bound by
// operations.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// round(p * 256) clipped to [0, 256]; p * 256 is exact in float32.
__device__ __forceinline__ uint32_t dac_threshold(float p) {
  return (uint32_t)fminf(fmaxf(rintf(p * 256.0f), 0.0f), 256.0f);
}

// One packed stream word: entropy words ctr0 .. ctr0+7 against threshold t.
__device__ __forceinline__ uint32_t encode_word(uint32_t ctr0, uint32_t t,
                                                uint32_t kd0, uint32_t kd1) {
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t x = lowbias32(lowbias32((ctr0 + (uint32_t)j) ^ kd0) ^ kd1);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      word |= (uint32_t)(((x >> (8 * b)) & 0xFFu) < t) << (4 * j + b);
    }
  }
  return word;
}

__global__ void sne_encode_kernel(const float* __restrict__ p,
                                  uint32_t* __restrict__ out, long long n_rows,
                                  int n_out, uint32_t kd0, uint32_t kd1,
                                  uint32_t offset) {
  const unsigned long long n_rand = 8ull * (unsigned long long)n_out;
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < n_rows;
       r += (long long)gridDim.x * blockDim.x) {
    const uint32_t t = dac_threshold(p[r]);
    const uint32_t base = (uint32_t)((unsigned long long)r * n_rand) + offset;
    uint32_t* row = out + (unsigned long long)r * n_out;
    for (int w = 0; w < n_out; ++w) {
      row[w] = encode_word(base + 8u * (uint32_t)w, t, kd0, kd1);
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int sne_encode_launch(const void* p, void* out, long long n_rows,
                                 int n_out, unsigned int kd0, unsigned int kd1,
                                 unsigned int offset, int threads, void* stream) {
  long long blocks = (n_rows + threads - 1) / threads;
  if (blocks > (1ll << 24)) blocks = 1ll << 24;  // the loop strides over the rest
  sne_encode_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)p, (uint32_t*)out, n_rows, n_out, kd0, kd1, offset);
  return (int)cudaGetLastError();
}
