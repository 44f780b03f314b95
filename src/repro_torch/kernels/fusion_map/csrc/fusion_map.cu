// fusion_map: analytic Bayesian fusion over class-probability maps, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fusion_map/kernel.py::_fusion_kernel
// (wrapper fusion_map_pallas).
//
// What it computes, for every row (pixel) r: eq (5) normalised,
//   q[r, k] = softmax_k( sum_m log clip(p[m, r, k], 1e-9, 1) - logprior[k] ),
// max-shifted before the exponential.  logprior is (M - 1) * log clip(prior)
// from the wrapper, as fusion_map_pallas takes it.  logf and expf are the
// IEEE functions: the build passes no --use_fast_math.
//
// Design.  A block owns a tile of whole rows, its log-scores in shared
// memory.  Step 1 walks the tile element by element -- neighbouring threads
// on neighbouring addresses, so every global load is coalesced -- and sums
// the M logs.  Step 2 gives each thread whole rows for the max, the
// exponentials, their sum and the division; the shared row stride is odd,
// so a warp's 32 rows fall in 32 distinct banks.  Step 3 stores the tile
// element by element, coalesced.  Each input is read from HBM once and each
// output written once.  (A first version gave each thread one row straight
// from global memory: its strided loads and three passes over its own output
// ran at 11x the bound, slower than the composed torch expression.)
//
// Bound on H100.  Bytes: 4 * M * R * K read, 4 * R * K written, over
// 3.35 TB/s; the arithmetic (one log per input, one exp per output) is far
// below it.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void fusion_map_kernel(const float* __restrict__ p,
                                  const float* __restrict__ logprior,
                                  float* __restrict__ out, int n_mod,
                                  long long n_rows, int n_cls, int tile_rows) {
  extern __shared__ float tile[];          // tile_rows x stride log-scores
  const int stride = n_cls | 1;            // odd: row walks are bank-conflict free
  const unsigned long long plane = (unsigned long long)n_rows * n_cls;
  // element e = i * n_cls + k of a tile; this thread's first one and its step
  const int i0 = threadIdx.x / n_cls, k0 = threadIdx.x % n_cls;
  const int di = blockDim.x / n_cls, dk = blockDim.x % n_cls;
  for (long long r0 = (long long)blockIdx.x * tile_rows; r0 < n_rows;
       r0 += (long long)gridDim.x * tile_rows) {
    const int rows = (int)min((long long)tile_rows, n_rows - r0);
    const int n_el = rows * n_cls;
    const float* src = p + (unsigned long long)r0 * n_cls;
    int i = i0, k = k0;
    for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
      float s = 0.0f;
      for (int m = 0; m < n_mod; ++m) {
        s += logf(fminf(fmaxf(src[m * plane + e], 1e-9f), 1.0f));
      }
      tile[i * stride + k] = s - logprior[k];
      i += di;
      k += dk;
      if (k >= n_cls) { k -= n_cls; ++i; }
    }
    __syncthreads();
    for (int row = threadIdx.x; row < rows; row += blockDim.x) {
      float* q = tile + row * stride;
      float mx = -INFINITY;
      for (int c = 0; c < n_cls; ++c) mx = fmaxf(mx, q[c]);
      float total = 0.0f;
      for (int c = 0; c < n_cls; ++c) {
        const float e = expf(q[c] - mx);
        q[c] = e;
        total += e;
      }
      for (int c = 0; c < n_cls; ++c) q[c] = q[c] / total;
    }
    __syncthreads();
    float* dst = out + (unsigned long long)r0 * n_cls;
    i = i0;
    k = k0;
    for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
      dst[e] = tile[i * stride + k];
      i += di;
      k += dk;
      if (k >= n_cls) { k -= n_cls; ++i; }
    }
    __syncthreads();
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int fusion_map_launch(const void* p, const void* logprior, void* out,
                                 int n_mod, long long n_rows, int n_cls,
                                 int tile_rows, int threads, void* stream) {
  const int smem = tile_rows * (n_cls | 1) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fusion_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (n_rows + tile_rows - 1) / tile_rows;
  if (blocks > (1ll << 24)) blocks = 1ll << 24;  // the loop strides over the rest
  fusion_map_kernel<<<(unsigned int)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)p, (const float*)logprior, (float*)out, n_mod, n_rows, n_cls,
      tile_rows);
  return (int)cudaGetLastError();
}
