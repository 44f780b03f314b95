// fusion_map: analytic Bayesian fusion over class-probability maps, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fusion_map/kernel.py::_fusion_kernel
// (wrapper fusion_map_pallas).
//
// What it computes, for every row (pixel) r: eq (5) normalised,
//   q[r, k] = softmax_k( sum_m log clip(p[m, r, k], 1e-9, 1) - lp[k] ),
//   lp[k]   = (M - 1) * log clip(prior[k], 1e-9, 1),
// max-shifted before the exponential.  The kernel computes lp itself, from
// the prior or, where none is given, from the uniform value 1/K the wrapper
// passes, so a call is one launch.  logf, expf and the division are the IEEE
// functions: the build passes no --use_fast_math.
//
// Bound on H100.  Bytes: 4 * M * R * K read and 4 * R * K written, over
// 3.35 TB/s; the arithmetic (one log per input, one exp per output) is far
// below it.  So the design is a streaming one: every byte read once with
// 16-byte loads, enough of them in flight to cover the memory's latency.
//
// What the first design lost.  A block of 128 threads owned a tile of
// 128 rows in shared memory and ran three phases separated by barriers:
// scalar 4-byte loads and the logs into the tile, one thread per row for the
// max, the K serial exps and the division, then the store.  A thread had 8
// bytes in flight (M = 2) during the loads, the loads of a block never
// overlapped its stores, and a 65,536-row call of 512 blocks ran its phases
// one after the other: 1.78x the bound on the full batch, 5.5x on the slice.
//
// This design.  No shared memory and no barrier.  Rows are owned in
// registers:
//   * K a multiple of 4 up to 128 (fusion_map_kernel_group): g = K/4 lanes
//     own a row, in a group of G lanes (the power of two >= g; lanes past g
//     idle), each lane one float4 of the row per modality, neighbouring lanes
//     on neighbouring addresses.  The row's max and its sum of exponentials
//     reduce by __shfl_xor_sync inside the group.
//   * K = 2 (Fig 4, obstacle_fusion; fusion_map_kernel_pair): a lane owns
//     whole rows, two rows per float4 (V = 4, when R is even so that every
//     modality's plane starts 16-byte aligned) or one per float2.
//   * Any other K, or a pointer not 16-byte aligned: the tile kernel of the
//     first design (fusion_map_kernel_tile), which now also computes lp itself.
// Each thread walks UNROLL (1) row slot per step and issues its loads
// before any of their logs: for M = 2, the paper's case, whose modality loop
// is unrolled, both modalities' float4s (32 bytes in flight per thread); for
// any other M a modality's (16 bytes) at a time.  At the occupancy this
// allows, that is some 64 KB per SM, above the ~25 KB per SM that Little's
// law asks at 3.35 TB/s and a microsecond of latency; on the H100 2 slots ran
// no faster on the full batch and slower on the small calls (PERF.md), whose
// time is the slot loop's latency, not bytes.  The grid is up to WAVES (16)
// times the blocks the SMs hold at once, and strides over the rest.  Plain
// vector loads were chosen over cp.async or TMA double-buffering: the rows
// carry no data between them, so independent loads in flight are all a
// stream needs.
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 1;    // row slots a thread walks per step
constexpr int WAVES = 16;    // grid = WAVES x resident blocks (then stride)

__device__ __forceinline__ float clip_log(float x) {
  return logf(fminf(fmaxf(x, 1e-9f), 1.0f));
}

// (M - 1) * log clip(prior[k]); ``uniform`` stands for every prior[k] where
// no prior is given
__device__ __forceinline__ float log_prior(const float* prior, float uniform, int k, int n_mod) {
  const float p = prior ? __ldg(prior + k) : uniform;
  return (float)(n_mod - 1) * clip_log(p);
}

template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, G));
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, G);
  return v;
}

// K a multiple of 4, K/4 <= G <= 32 lanes per row.  A warp covers 32/G rows
// per slot, UNROLL slots per tile; warps stride over the tiles.
template <int G, int MC>
__global__ void __launch_bounds__(THREADS)
fusion_map_kernel_group(const float* __restrict__ p, const float* __restrict__ prior,
                        float uniform, float* __restrict__ out, int n_mod, long long n_rows,
                        int n_cls) {
  constexpr int RPW = 32 / G;                     // rows of a warp's slot
  const int lane = threadIdx.x & 31;
  const int j = lane % G;                         // this lane's float4 of its row
  const int g = n_cls >> 2;
  const bool active = j < g;
  const long long plane = n_rows * (long long)n_cls;
  float4 lp = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) {
    lp.x = log_prior(prior, uniform, 4 * j + 0, n_mod);
    lp.y = log_prior(prior, uniform, 4 * j + 1, n_mod);
    lp.z = log_prior(prior, uniform, 4 * j + 2, n_mod);
    lp.w = log_prior(prior, uniform, 4 * j + 3, n_mod);
  }
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * THREADS) >> 5;
  const long long tiles = (n_rows + RPW * UNROLL - 1) / (RPW * UNROLL);
  for (long long t = warp; t < tiles; t += n_warps) {
    long long row[UNROLL];
    bool ok[UNROLL];
    float4 s[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      row[u] = (t * UNROLL + u) * RPW + lane / G;
      ok[u] = active && row[u] < n_rows;
      s[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    auto load = [&](int m, int u) {
      return ok[u] ? __ldcs(reinterpret_cast<const float4*>(p + m * plane) + row[u] * g + j)
                   : make_float4(1.f, 1.f, 1.f, 1.f);
    };
    auto add_logs = [](float4& acc, float4 v) {
      acc.x += clip_log(v.x);
      acc.y += clip_log(v.y);
      acc.z += clip_log(v.z);
      acc.w += clip_log(v.w);
    };
    if constexpr (MC > 0) {                     // every modality's loads before any log
      float4 v[MC][UNROLL];
#pragma unroll
      for (int m = 0; m < MC; ++m)
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[m][u] = load(m, u);
#pragma unroll
      for (int m = 0; m < MC; ++m)
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) add_logs(s[u], v[m][u]);
    } else {                                    // a modality's loads before its logs
      for (int m = 0; m < n_mod; ++m) {
        float4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = load(m, u);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) add_logs(s[u], v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float4 q = make_float4(s[u].x - lp.x, s[u].y - lp.y, s[u].z - lp.z, s[u].w - lp.w);
      float mx = active ? fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w)) : -INFINITY;
      mx = group_max<G>(mx);
      q.x = expf(q.x - mx);
      q.y = expf(q.y - mx);
      q.z = expf(q.z - mx);
      q.w = expf(q.w - mx);
      const float total = group_sum<G>(active ? (q.x + q.y) + (q.z + q.w) : 0.f);
      if (ok[u]) {
        q.x = q.x / total;
        q.y = q.y / total;
        q.z = q.z / total;
        q.w = q.w / total;
        __stcs(reinterpret_cast<float4*>(out) + row[u] * g + j, q);
      }
    }
  }
}

// K = 2: a lane owns V/2 whole rows per vector (V = 4: two rows per float4;
// V = 2: one row per float2), UNROLL vectors per step.
template <int V, int MC>
__global__ void __launch_bounds__(THREADS)
fusion_map_kernel_pair(const float* __restrict__ p, const float* __restrict__ prior,
                       float uniform, float* __restrict__ out, int n_mod, long long n_rows) {
  using vec = typename std::conditional<V == 4, float4, float2>::type;
  constexpr int RPV = V / 2;                      // rows per vector
  const float lp0 = log_prior(prior, uniform, 0, n_mod);
  const float lp1 = log_prior(prior, uniform, 1, n_mod);
  const long long n_vec = n_rows / RPV;           // V = 4 only for even R
  const long long plane = n_vec;                  // vectors per modality
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n_thr = (long long)gridDim.x * THREADS;
  for (long long base = tid; base < n_vec; base += n_thr * UNROLL) {
    long long idx[UNROLL];
    bool ok[UNROLL];
    float s[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      idx[u] = base + u * n_thr;
      ok[u] = idx[u] < n_vec;
#pragma unroll
      for (int c = 0; c < V; ++c) s[u][c] = 0.f;
    }
    auto load = [&](int m, int u) {
      vec w;
      if (ok[u]) {
        w = __ldcs(reinterpret_cast<const vec*>(p) + m * plane + idx[u]);
      } else {
        if constexpr (V == 4) w = make_float4(1.f, 1.f, 1.f, 1.f);
        else w = make_float2(1.f, 1.f);
      }
      return w;
    };
    auto add_logs = [](float* acc, vec w) {
      const float* f = reinterpret_cast<const float*>(&w);
#pragma unroll
      for (int c = 0; c < V; ++c) acc[c] += clip_log(f[c]);
    };
    if constexpr (MC > 0) {                     // every modality's loads before any log
      vec v[MC][UNROLL];
#pragma unroll
      for (int m = 0; m < MC; ++m)
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[m][u] = load(m, u);
#pragma unroll
      for (int m = 0; m < MC; ++m)
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) add_logs(s[u], v[m][u]);
    } else {                                    // a modality's loads before its logs
      for (int m = 0; m < n_mod; ++m) {
        vec v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = load(m, u);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) add_logs(s[u], v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      float r[V];
#pragma unroll
      for (int i = 0; i < RPV; ++i) {
        const float a = s[u][2 * i] - lp0, b = s[u][2 * i + 1] - lp1;
        const float mx = fmaxf(a, b);
        const float ea = expf(a - mx), eb = expf(b - mx);
        const float total = ea + eb;
        r[2 * i] = ea / total;
        r[2 * i + 1] = eb / total;
      }
      vec w;
      if constexpr (V == 4) w = make_float4(r[0], r[1], r[2], r[3]);
      else w = make_float2(r[0], r[1]);
      __stcs(reinterpret_cast<vec*>(out) + idx[u], w);
    }
  }
}

// Any other shape: a block owns a tile of whole rows, its log-scores in
// shared memory (the first design's kernel; the shared row stride is odd, so
// a warp's 32 rows fall in 32 distinct banks).
__global__ void fusion_map_kernel_tile(const float* __restrict__ p, const float* __restrict__ prior,
                                   float uniform, float* __restrict__ out, int n_mod,
                                   long long n_rows, int n_cls, int tile_rows) {
  extern __shared__ float tile[];          // tile_rows x stride log-scores
  const int stride = n_cls | 1;
  const unsigned long long plane = (unsigned long long)n_rows * n_cls;
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
      for (int m = 0; m < n_mod; ++m) s += clip_log(src[m * plane + e]);
      tile[i * stride + k] = s - log_prior(prior, uniform, k, n_mod);
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

constexpr int TILE_THREADS = 128;
constexpr int TILE_ELEMENTS = 2048;      // log-scores a tile block keeps (8 KB)

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// blocks of THREADS threads of ``kernel`` that one SM holds at once
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, 0) != cudaSuccess ||
      n <= 0)
    n = 1;
  return n;
}

// blocks for ``units`` units of work of ``per_block`` each: at most WAVES x
// the blocks every SM holds at once, the kernel striding over the rest
unsigned int grid_for(int resident, long long units, long long per_block) {
  const long long want = (units + per_block - 1) / per_block;
  const long long cap = (long long)WAVES * resident * sm_count();
  return (unsigned int)(want < 1 ? 1 : (want < cap ? want : cap));
}

// M = 2 (the paper's two sensors) has its modality loop unrolled; other M
// take the runtime loop
template <int G, int MC>
int launch_group_m(const float* p, const float* prior, float uniform, float* out, int n_mod,
                   long long n_rows, int n_cls, cudaStream_t stream) {
  const long long tiles = (n_rows + (32 / G) * UNROLL - 1) / ((32 / G) * UNROLL);
  static const int resident = resident_blocks(fusion_map_kernel_group<G, MC>);
  const unsigned int blocks = grid_for(resident, tiles, THREADS / 32);
  fusion_map_kernel_group<G, MC><<<blocks, THREADS, 0, stream>>>(p, prior, uniform, out, n_mod,
                                                                 n_rows, n_cls);
  return (int)cudaGetLastError();
}

template <int G>
int launch_group(const float* p, const float* prior, float uniform, float* out, int n_mod,
                 long long n_rows, int n_cls, cudaStream_t stream) {
  return n_mod == 2 ? launch_group_m<G, 2>(p, prior, uniform, out, n_mod, n_rows, n_cls, stream)
                    : launch_group_m<G, 0>(p, prior, uniform, out, n_mod, n_rows, n_cls, stream);
}

template <int V, int MC>
int launch_pair_m(const float* p, const float* prior, float uniform, float* out, int n_mod,
                  long long n_rows, cudaStream_t stream) {
  const long long vecs = n_rows / (V / 2);
  static const int resident = resident_blocks(fusion_map_kernel_pair<V, MC>);
  const unsigned int blocks = grid_for(resident, vecs, (long long)THREADS * UNROLL);
  fusion_map_kernel_pair<V, MC><<<blocks, THREADS, 0, stream>>>(p, prior, uniform, out, n_mod,
                                                                n_rows);
  return (int)cudaGetLastError();
}

template <int V>
int launch_pair(const float* p, const float* prior, float uniform, float* out, int n_mod,
                long long n_rows, cudaStream_t stream) {
  return n_mod == 2 ? launch_pair_m<V, 2>(p, prior, uniform, out, n_mod, n_rows, stream)
                    : launch_pair_m<V, 0>(p, prior, uniform, out, n_mod, n_rows, stream);
}

}  // namespace

// The path a shape takes: 1 the group kernel, 2 the pair kernel, 0 the tile
// kernel (the wrapper reports it; the launch picks the same).
extern "C" int fusion_map_route(const void* p, const void* out, long long n_rows, int n_cls) {
  const bool aligned = ((unsigned long long)p % 16 == 0) && ((unsigned long long)out % 16 == 0);
  if (aligned && n_cls % 4 == 0 && n_cls >= 4 && n_cls <= 128) return 1;
  if (n_cls == 2 && ((unsigned long long)p % 8 == 0) && ((unsigned long long)out % 8 == 0))
    return 2;
  return 0;
}

// Returns the cudaError_t of the launch (0 on success).  ``prior`` may be
// null: every class then has the prior ``uniform``.
extern "C" int fusion_map_launch(const void* p_, const void* prior_, float uniform, void* out_,
                                 int n_mod, long long n_rows, int n_cls, void* stream_) {
  const float* p = (const float*)p_;
  const float* prior = (const float*)prior_;
  float* out = (float*)out_;
  cudaStream_t stream = (cudaStream_t)stream_;
  switch (fusion_map_route(p_, out_, n_rows, n_cls)) {
    case 1: {
      const int g = n_cls / 4;
      if (g <= 1) return launch_group<1>(p, prior, uniform, out, n_mod, n_rows, n_cls, stream);
      if (g <= 2) return launch_group<2>(p, prior, uniform, out, n_mod, n_rows, n_cls, stream);
      if (g <= 4) return launch_group<4>(p, prior, uniform, out, n_mod, n_rows, n_cls, stream);
      if (g <= 8) return launch_group<8>(p, prior, uniform, out, n_mod, n_rows, n_cls, stream);
      if (g <= 16) return launch_group<16>(p, prior, uniform, out, n_mod, n_rows, n_cls, stream);
      return launch_group<32>(p, prior, uniform, out, n_mod, n_rows, n_cls, stream);
    }
    case 2: {
      const bool even = n_rows % 2 == 0 && (unsigned long long)p_ % 16 == 0 &&
                        (unsigned long long)out_ % 16 == 0;
      return even ? launch_pair<4>(p, prior, uniform, out, n_mod, n_rows, stream)
                  : launch_pair<2>(p, prior, uniform, out, n_mod, n_rows, stream);
    }
    default: {
      const int tile_rows = n_cls >= TILE_ELEMENTS ? 1 : TILE_ELEMENTS / n_cls;
      const int smem = tile_rows * (n_cls | 1) * (int)sizeof(float);
      if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            fusion_map_kernel_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
      }
      long long blocks = (n_rows + tile_rows - 1) / tile_rows;
      if (blocks > (1ll << 24)) blocks = 1ll << 24;  // the loop strides over the rest
      fusion_map_kernel_tile<<<(unsigned int)blocks, TILE_THREADS, smem, stream>>>(
          p, prior, uniform, out, n_mod, n_rows, n_cls, tile_rows);
      return (int)cudaGetLastError();
    }
  }
}
