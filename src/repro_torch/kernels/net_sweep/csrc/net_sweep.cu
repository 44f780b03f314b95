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
// Design.  The Pallas kernel folds each plan's threshold masks into constants
// when it is traced.  Here one build serves every plan: the host lowers the
// plan once into a straight-line gate program (program.py, recorded by the
// same walk as the plain torch version) and this kernel interprets it.  The
// program is read from device memory; every thread of a block reads the same
// instruction, so each load is a broadcast.  Each thread evaluates the
// program for its (frame, word) items with its live words in shared memory
// (slot-major, so a warp's accesses fall in 32 distinct banks).  A block
// covers whole frames, so the per-frame counts are complete inside the block
// (shared-memory integer atomics: exact in any order) and the decision is
// taken in the kernel for every n_bits.
//
// Bound on H100.  Inputs are the evidence frames and outputs the counts: a
// few KB, so the bytes bound is negligible.  The work is integer ALU: the
// program's 32-bit operations per word (GateProgram.int_ops_per_word, ~500
// to ~2000 for the scenario networks) times frames times words, over the
// card's INT32 rate (64 lanes per SM per clock).  An interpreter pays an
// instruction fetch, a dispatch branch and shared-memory traffic per gate on
// top of that; generating code per plan, so that the live words sit in
// registers, is the later performance step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Op : int {
  BASE = 0, PLANE, AND, OR, XOR, NOT, ONES, ZERO, EMASK, EVMASK, OUT
};

__constant__ uint32_t kPlaneSalts[8] = {
    0x85EBCA6Bu, 0xC2B2AE35u, 0x27D4EB2Fu, 0x165667B1u,
    0x9E3779B9u, 0xFF51AFD7u, 0xC4CEB9FEu, 0x2545F497u,
};

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__global__ void net_sweep_kernel(
    const int4* __restrict__ code, int n_ins, int n_slots,
    const int* __restrict__ ev, int n_ev,
    int* __restrict__ out, int n_cols, int n_s,
    const int* __restrict__ qcards, int n_q, int decide,
    int n_batch, int w_words, uint32_t kd0, uint32_t kd1, uint32_t frame0,
    uint32_t n_frames, int frames_per_block) {
  extern __shared__ uint32_t smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  uint32_t* slots = smem;                                   // [n_slots][nt]
  int* counts = reinterpret_cast<int*>(smem + (size_t)n_slots * nt);
  const int n_cnt = n_s + 1;                                // [fpb][n_cnt]
  for (int i = tid; i < frames_per_block * n_cnt; i += nt) counts[i] = 0;
  __syncthreads();

  const int f_first = blockIdx.x * frames_per_block;
  const int n_items = frames_per_block * w_words;
  const uint32_t node_stride = n_frames * (uint32_t)w_words;
  for (int item = tid; item < n_items; item += nt) {
    const int fl = item / w_words;
    const int w = item - fl * w_words;
    const int f = f_first + fl;
    if (f >= n_batch) break;
    const uint32_t pos = (frame0 + (uint32_t)f) * (uint32_t)w_words + (uint32_t)w;
    const int* evf = ev + (size_t)f * n_ev;
    int* cnt = counts + fl * n_cnt;
    for (int k = 0; k < n_ins; ++k) {
      const int4 in = __ldg(code + k);
      uint32_t v;
      switch (in.x) {
        case BASE:
          v = lowbias32(((uint32_t)in.z * node_stride + pos) ^ kd0);
          break;
        case PLANE:
          v = lowbias32(slots[in.z * nt + tid] ^ kPlaneSalts[in.w] ^ kd1);
          break;
        case AND: v = slots[in.z * nt + tid] & slots[in.w * nt + tid]; break;
        case OR:  v = slots[in.z * nt + tid] | slots[in.w * nt + tid]; break;
        case XOR: v = slots[in.z * nt + tid] ^ slots[in.w * nt + tid]; break;
        case NOT: v = ~slots[in.z * nt + tid]; break;
        case ONES: v = 0xFFFFFFFFu; break;
        case ZERO: v = 0u; break;
        case EMASK: v = (w >= in.z && w < in.w) ? 0xFFFFFFFFu : 0u; break;
        case EVMASK: v = ((evf[in.z] >> in.w) & 1) ? 0u : 0xFFFFFFFFu; break;
        default:  // OUT
          atomicAdd(cnt + (in.w == n_s ? 0 : in.w + 1),
                    __popc(slots[in.z * nt + tid]));
          continue;
      }
      slots[in.y * nt + tid] = v;
    }
  }
  __syncthreads();

  // counts[fl] = [denom, numer_0 .. numer_{n_s-1}];
  // out row = [numer_0 .. numer_{n_s-1}, denom, decisions...]
  for (int fl = tid; fl < frames_per_block; fl += nt) {
    const int f = f_first + fl;
    if (f >= n_batch) break;
    const int* c = counts + fl * n_cnt;
    int* o = out + (size_t)f * n_cols;
    for (int s = 0; s < n_s; ++s) o[s] = c[s + 1];
    o[n_s] = c[0];
    if (!decide) continue;
    int off = 0;
    for (int q = 0; q < n_q; ++q) {
      const int card = qcards[q];
      int sum = 0;
      for (int v = 1; v < card; ++v) sum += c[1 + off + v - 1];
      int best = c[0] - sum, arg = 0;
      for (int v = 1; v < card; ++v) {
        const int x = c[1 + off + v - 1];
        if (x > best) { best = x; arg = v; }
      }
      o[n_s + 1 + q] = arg;
      off += card - 1;
    }
  }
}

}  // namespace

extern "C" int net_sweep_max_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// Returns the cudaError_t of the launch (0 on success).
extern "C" int net_sweep_launch(
    const void* code, int n_ins, int n_slots, const void* ev, int n_ev,
    void* out, int n_cols, int n_s, const void* qcards, int n_q, int decide,
    int n_batch, int w_words, unsigned int kd0, unsigned int kd1,
    unsigned int frame0, unsigned int n_frames, int frames_per_block,
    int threads, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        net_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_batch + frames_per_block - 1) / frames_per_block;
  net_sweep_kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const int4*)code, n_ins, n_slots, (const int*)ev, n_ev, (int*)out,
      n_cols, n_s, (const int*)qcards, n_q, decide, n_batch, w_words, kd0, kd1,
      frame0, n_frames, frames_per_block);
  return (int)cudaGetLastError();
}
