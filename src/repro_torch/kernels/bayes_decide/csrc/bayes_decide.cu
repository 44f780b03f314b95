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
// large for the card.  Here each thread owns one row, hashes its entropy in
// registers, builds each modality's packed word exactly as sne_encode does,
// ANDs them and popcounts, and keeps the running argmax, so neither entropy
// nor streams are stored.  Offsets are 64-bit and truncated to 32 only as
// counters.
//
// Bound on H100.  Integer work: 18 hash operations and 4 byte compares per
// entropy word, M * K * n_bits / 4 entropy words per row, over the card's
// INT32 rate.  The bytes (p in; counts and decisions out) take far less.
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

// One packed stream word (sne_encode's layout): entropy words ctr0 .. ctr0+7.
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

__global__ void bayes_decide_kernel(const float* __restrict__ p,
                                    int* __restrict__ dec, int* __restrict__ counts,
                                    int n_mod, long long n_rows, int n_cls,
                                    int n_out, uint32_t kd0, uint32_t kd1,
                                    uint32_t offset) {
  const unsigned long long n_rand = 8ull * (unsigned long long)n_out;
  const unsigned long long plane = (unsigned long long)n_rows * n_cls;
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < n_rows;
       r += (long long)gridDim.x * blockDim.x) {
    int best = -1, arg = 0;
    for (int k = 0; k < n_cls; ++k) {
      const unsigned long long row0 = (unsigned long long)r * n_cls + k;
      int cnt = 0;
      for (int w = 0; w < n_out; ++w) {
        uint32_t joint = 0xFFFFFFFFu;
        for (int m = 0; m < n_mod; ++m) {
          const unsigned long long row = m * plane + row0;
          const uint32_t ctr0 = (uint32_t)(row * n_rand) + offset + 8u * (uint32_t)w;
          joint &= encode_word(ctr0, dac_threshold(p[row]), kd0, kd1);
        }
        cnt += __popc(joint);
      }
      counts[row0] = cnt;
      if (cnt > best) {  // strict: the first maximum wins
        best = cnt;
        arg = k;
      }
    }
    dec[r] = arg;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int bayes_decide_launch(const void* p, void* dec, void* counts, int n_mod,
                                   long long n_rows, int n_cls, int n_out,
                                   unsigned int kd0, unsigned int kd1,
                                   unsigned int offset, int threads, void* stream) {
  long long blocks = (n_rows + threads - 1) / threads;
  if (blocks > (1ll << 24)) blocks = 1ll << 24;  // the loop strides over the rest
  bayes_decide_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)p, (int*)dec, (int*)counts, n_mod, n_rows, n_cls, n_out, kd0,
      kd1, offset);
  return (int)cudaGetLastError();
}
