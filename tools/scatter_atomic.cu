// Kernel 6 (row scatter-add) in its atomic form, as csrc/gather.cu had it
// until the fixed-order form replaced it (ROADMAP fault 4). Not
// part of the package: tools/slice_variants.py times variants of it, and
// tools/determinism_settings.py puts it back in the port's place to show
// how much of the card's run-to-run noise it caused.
//
// contrib (B, Q, 3) f32, idx (B, Q) int32 -> out (B, V, 3), the sum of the
// contributions per index; an index outside [0, V) is dropped. One launch,
// no memset: the C blocks of a thread-block cluster share batch item b
// (grid (C, B), cluster (C, 1, 1), plan() in tools/determinism_settings.py).
// Block c zeroes rows [c S, c S + S) of item b with 16-byte stores, arrives
// at the cluster barrier (release), loads its floats of contributions
// [c P, c P + P) and their indices meanwhile, waits at the barrier
// (acquire: every row of item b is zero now), and adds each float into its
// row in L2 with a reduction (atomicAdd, result unused: RED). The order of
// the additions into one row varies from run to run, so the result is not
// bitwise deterministic (it equals index_add_ to fp32 rounding of the
// summation order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCATTER_THREADS = 1024;
constexpr int SCATTER_UNROLL = 4;  // floats per thread and pass
constexpr int MAX_CLUSTER = 8;     // the portable limit
constexpr int MAX_GRID_Y = 65535;  // the batch axis

// dst[0, n) = 0 by the whole block: scalar stores up to the first 16-byte
// boundary of dst, float4 stores, then a scalar tail of at most 3.
__device__ __forceinline__ void zero_span(float* __restrict__ dst, int n) {
  const int t = threadIdx.x;
  const int head =
      min(n, (int)((4 - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3));
  const int body = (n - head) >> 2;
  if (t < head) dst[t] = 0.f;
  float4* dst4 = reinterpret_cast<float4*>(dst + head);
  for (int k = t; k < body; k += SCATTER_THREADS)
    dst4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (head + 4 * body + t < n) dst[head + 4 * body + t] = 0.f;
}

// One pass of a block over floats [p0, p0 + UNROLL * THREADS) of its run
// (up to e_hi): thread t takes float e = p0 + u THREADS + t, its index and
// the offset of its row's float in out (-1: nothing to add).
struct Pass {
  int at[SCATTER_UNROLL];
  float v[SCATTER_UNROLL];

  __device__ __forceinline__ void load(const int* __restrict__ ib,
                                       const float* __restrict__ cb, int p0,
                                       int e_hi, int V) {
#pragma unroll
    for (int u = 0; u < SCATTER_UNROLL; ++u) {
      const int e = p0 + u * SCATTER_THREADS + threadIdx.x;
      at[u] = -1;
      v[u] = 0.f;
      if (e < e_hi) {
        const int q = e / 3;
        const int i = __ldg(ib + q);
        v[u] = __ldg(cb + e);
        if ((unsigned)i < (unsigned)V) at[u] = 3 * i + (e - 3 * q);
      }
    }
  }

  __device__ __forceinline__ void add(float* __restrict__ out) const {
#pragma unroll
    for (int u = 0; u < SCATTER_UNROLL; ++u)
      if (at[u] >= 0) atomicAdd(out + at[u], v[u]);
  }
};

// Grid (C, B), cluster (C, 1, 1): block c of item b zeroes rows
// [c S, min(V, c S + S)) and adds contributions [c P, min(Q, c P + P)).
__global__ void __launch_bounds__(SCATTER_THREADS)
    scatter_add_rows_kernel(const float* __restrict__ contrib,
                            const int* __restrict__ idx,
                            float* __restrict__ out, int V, int Q, int S,
                            int P) {
  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int* ib = idx + b * Q;
  const float* cb = contrib + 3 * b * Q;
  float* ob = out + 3 * b * V;
  const int e_lo = 3 * c * P;
  const int e_hi = 3 * min(Q, c * P + P);
  const int r_lo = c * S;
  if (r_lo < V) zero_span(ob + 3 * r_lo, 3 * min(S, V - r_lo));
  // release: the zeros are visible to the cluster before it passes the
  // barrier (a MEMBAR.GPU); the first pass's loads are issued after it
  // (issued before, the MEMBAR waited for them too: slower on the card)
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  Pass pass;
  pass.load(ib, cb, e_lo, e_hi, V);
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  for (int p0 = e_lo;;) {
    pass.add(ob);
    p0 += SCATTER_UNROLL * SCATTER_THREADS;
    if (p0 >= e_hi) break;
    pass.load(ib, cb, p0, e_hi, V);
  }
}

}  // namespace

// Clusters of C blocks, S rows and P contributions per block: C S >= V and
// C P >= Q, so every row of out (B, V, 3) is written.
extern "C" int tuch_scatter_add_rows(const void* contrib, const void* idx,
                                     void* out, int B, int V, int Q, int C,
                                     int S, int P, void* stream) {
  if (B <= 0 || V <= 0 || Q <= 0 || B > MAX_GRID_Y || C < 1 ||
      C > MAX_CLUSTER || S <= 0 || P <= 0 || (int64_t)C * S < V ||
      (int64_t)C * P < Q)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(SCATTER_THREADS);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = C;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, scatter_add_rows_kernel, static_cast<const float*>(contrib),
      static_cast<const int*>(idx), static_cast<float*>(out), V, Q, S, P);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" const char* tuch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
