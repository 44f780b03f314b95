// net_sweep: the whole Bayesian network sweep in one launch, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/net_sweep/kernel.py::_net_sweep_kernel
// (wrapper net_sweep_pallas, body common.py::sweep_tile).
//
// What it computes, for every (frame f, word w) of a launch: the fused
// topological sweep of one compiled network -- counter entropy (lowbias32 of
// the global (node, frame, word) counter, one base round per node and one
// salted round per bit-plane), bit-sliced byte < CDF-threshold borrow chains,
// value planes, the evidence AND -- and the popcounts of the acceptance word
// and of each query-value bucket ANDed with it.  Counts are summed per frame;
// with decide=1 each frame's per-query argmax (ties to the lowest value,
// denom == 0 decides 0) is written beside them.
//
// Design.  As the Pallas kernel folds each plan into trace-time constants,
// this file is compiled once per gate program: codegen.py writes the plan's
// gates as straight-line code (ns_gen::body, ns_gen::decide) into a
// translation unit that includes net_sweep_common.h, the body, then this
// file.  So the live words sit in registers and no instruction is fetched or
// dispatched at run time.  One thread evaluates the body for one (frame,
// word) item at a time; a block covers whole frames, so each frame's counts
// are complete inside the block.  When frames are whole warps (w_words a
// multiple of 32) a warp reduces its counts with __reduce_add_sync and one
// lane adds them to shared memory; otherwise every thread adds its own.
// Integer atomics are exact in any order.
//
// Bound on H100.  Inputs are the evidence frames and outputs the counts: a
// few KB, so the bytes bound is negligible.  The work is integer ALU: the
// program's least 32-bit operations per word (GateProgram.int_ops_per_word,
// which counts a cone of logic gates over at most three values as one LOP3)
// times frames times words, over the card's INT32 rate (64 lanes per SM per
// clock).

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256) net_sweep_kernel(
    const int* __restrict__ ev, int n_ev, int* __restrict__ out, int n_cols,
    int decide, int n_batch, int w_words, uint32_t kd0, uint32_t kd1,
    uint32_t frame0, uint32_t n_frames, int frames_per_block) {
  using namespace ns_gen;
  extern __shared__ int counts[];                      // [frames_per_block][kNOut]
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < frames_per_block * kNOut; i += nt) counts[i] = 0;
  __syncthreads();

  const int f_first = blockIdx.x * frames_per_block;
  const int n_items = frames_per_block * w_words;
  const uint32_t node_stride = n_frames * (uint32_t)w_words;
  // every warp's 32 items lie in one frame, and the loop below stays uniform
  const bool warp_frames = (w_words & 31) == 0 && (nt & 31) == 0;
  for (int item = tid; item < n_items; item += nt) {
    const int fl = item / w_words;
    const int w = item - fl * w_words;
    const int f = f_first + fl;
    if (f >= n_batch) break;
    const uint32_t pos = (frame0 + (uint32_t)f) * (uint32_t)w_words + (uint32_t)w;
    uint32_t c[kNOut];
#pragma unroll
    for (int j = 0; j < kNOut; ++j) c[j] = 0u;
    body(pos, (uint32_t)w, (uint32_t)w_words, node_stride, kd0, kd1,
         ev + (std::size_t)f * n_ev, c);
    int* dst = counts + fl * kNOut;
    if (warp_frames) {
#pragma unroll
      for (int j = 0; j < kNOut; ++j) {
        const uint32_t s = __reduce_add_sync(0xFFFFFFFFu, c[j]);
        if ((tid & 31) == 0) atomicAdd(dst + j, (int)s);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNOut; ++j) atomicAdd(dst + j, (int)c[j]);
    }
  }
  __syncthreads();

  // out row = [numer_0 .. numer_{n_s-1}, denom, decisions ...]
  for (int fl = tid; fl < frames_per_block; fl += nt) {
    const int f = f_first + fl;
    if (f >= n_batch) break;
    const int* c = counts + fl * kNOut;
    int* o = out + (std::size_t)f * n_cols;
    for (int j = 0; j < kNOut; ++j) o[j] = c[j];
    if (decide) ns_gen::decide(c, o + kNOut);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int net_sweep_launch(
    const void* ev, int n_ev, void* out, int n_cols, int decide, int n_batch,
    int w_words, unsigned int kd0, unsigned int kd1, unsigned int frame0,
    unsigned int n_frames, int frames_per_block, int threads, int smem_bytes,
    void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        net_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_batch + frames_per_block - 1) / frames_per_block;
  net_sweep_kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const int*)ev, n_ev, (int*)out, n_cols, decide, n_batch, w_words, kd0, kd1,
      frame0, n_frames, frames_per_block);
  return (int)cudaGetLastError();
}
