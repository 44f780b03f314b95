// pand_popcount: M-way AND of packed stochastic streams, then popcount, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/pand_popcount/kernel.py::_pand_kernel
// (wrapper pand_popcount_pallas).
//
// What it computes: streams (M, R, W) packed 32-bit words -> counts (R,), the
// number of set bits of AND_m streams[m, r, :] -- the Bayes-fusion numerator
// of eq (5) counted on the streams.
//
// Design.  One thread owns one row: it ANDs the M words of each of its W
// words in registers and sums __popc over them, so the joint stream is never
// stored.  Neighbouring threads read neighbouring rows, and each row is W
// consecutive words, read 4 at a time (16-byte loads) when W % 4 == 0 -- at
// 128 bits one load per modality per row.  Sizes and offsets are 64-bit: at
// the paper-bayes-fusion size the stream tensor holds 2.1e9 words, past the
// reach of a 32-bit int.
//
// Bound on H100.  Bytes: every stream word is read once (4 * M * R * W) and
// one count written per row, over 3.35 TB/s.  The integer work is an AND per
// extra modality and a popcount per word, far below the memory time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The AND of two words and the popcount of one, for 1 and 4 words at a time.
__device__ __forceinline__ void and_in(uint32_t& a, uint32_t b) { a &= b; }
__device__ __forceinline__ void and_in(uint4& a, uint4 b) {
  a.x &= b.x;
  a.y &= b.y;
  a.z &= b.z;
  a.w &= b.w;
}
__device__ __forceinline__ int popc(uint32_t a) { return __popc(a); }
__device__ __forceinline__ int popc(uint4 a) {
  return __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
}

// Word is uint4 when W is a multiple of 4 (16-byte loads), else uint32_t;
// n_vec = W words per row in units of Word.
template <typename Word>
__global__ void pand_popcount_kernel(const Word* __restrict__ streams,
                                     int* __restrict__ out, int n_mod,
                                     long long n_rows, int n_vec) {
  const unsigned long long plane = (unsigned long long)n_rows * n_vec;
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < n_rows;
       r += (long long)gridDim.x * blockDim.x) {
    const Word* row = streams + (unsigned long long)r * n_vec;
    int total = 0;
    for (int v = 0; v < n_vec; ++v) {
      Word acc = row[v];
      for (int m = 1; m < n_mod; ++m) and_in(acc, row[m * plane + v]);
      total += popc(acc);
    }
    out[r] = total;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The 16-byte path
// needs W % 4 == 0 and a 16-byte aligned base (torch allocations are).
extern "C" int pand_popcount_launch(const void* streams, void* out, int n_mod,
                                    long long n_rows, int n_words, int threads,
                                    void* stream) {
  long long blocks = (n_rows + threads - 1) / threads;
  if (blocks > (1ll << 24)) blocks = 1ll << 24;  // the loop strides over the rest
  cudaStream_t st = (cudaStream_t)stream;
  if (n_words % 4 == 0 && (uintptr_t)streams % 16 == 0) {
    pand_popcount_kernel<uint4><<<(unsigned int)blocks, threads, 0, st>>>(
        (const uint4*)streams, (int*)out, n_mod, n_rows, n_words / 4);
  } else {
    pand_popcount_kernel<uint32_t><<<(unsigned int)blocks, threads, 0, st>>>(
        (const uint32_t*)streams, (int*)out, n_mod, n_rows, n_words);
  }
  return (int)cudaGetLastError();
}
