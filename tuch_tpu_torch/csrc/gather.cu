// Batched row gather and row scatter-add by index, for Hopper (sm_90a).
//
// Replaces the TPU kernels tuch_tpu/ops/gather_pallas.py:_gather_kernel
// (kernel 5, line 61, pallas_call at :130) and :_scatter_kernel (kernel 6,
// line 84, pallas_call at :176): the forward and the backward of
// gather_rows, the re-gather of each vertex's nearest allowed vertex in the
// SMPLify-DC contact loss.
//
//   gather:  values (B, V, 3) f32, idx (B, Q) int32 -> out (B, Q, 3);
//            an index outside [0, V) gives a zero row.
//   scatter: contrib (B, Q, 3) f32, idx (B, Q) int32 -> out (B, V, 3), the
//            sum of the contributions per index; an index outside [0, V) is
//            dropped.
//
// What bounds them on this card. Neither does arithmetic worth counting
// (the scatter adds 3 B Q floats). Counting each input read once and each
// output written once, they move 4 B (3 V + Q + 3 Q) bytes (gather) and
// 4 B (3 Q + Q + 3 V) bytes (scatter), and are bound by those bytes: 12.3
// MB, 0.0037 ms at B = 64, V = Q = 6890. At that size everything fits in
// the 50 MB L2, so what shows is a second pass over the output (a memset)
// and the rate at which L2 takes requests to scattered rows.
//
// What the design does about it. The TPU kernels build (TM, TQ) one-hot
// tiles and select rows on the MXU in three exact bf16 planes, because XLA
// serialises scatters on the TPU. Here both are direct.
// - Gather (as first ported): one thread per (b, q, c) element,
//   consecutive threads on consecutive addresses of idx, values and out. A
//   copy: bitwise equal to torch.gather. Timed by device time it reaches
//   two thirds of its bound and is faster than both library calls
//   (PERF.md), so it was left as it is when the scatter was redesigned.
// - Scatter: one launch, no memset. The C blocks of a thread-block cluster
//   share batch item b (grid (C, B), cluster (C, 1, 1), ops/gather.py
//   scatter_plan). Block c zeroes rows [c S, c S + S) of item b with 16-byte
//   stores, arrives at the cluster barrier (release), loads its floats of
//   contributions [c P, c P + P) and their indices meanwhile, waits at the
//   barrier (acquire: every row of item b is zero now), and adds each float
//   into its row in L2 with a reduction (atomicAdd, result unused: RED).
//   Lanes take consecutive floats, as the loads are coalesced, and a row's
//   three reductions leave the SM as one request. Every contribution is
//   read by one block only; every output row is zeroed by one block before
//   any addition to it. Measured on the card (tools/slice_variants.py), the
//   additions into scattered rows take most of the time, and plain stores
//   in their place take as long: the limit is L2's rate for scattered
//   requests, not the atomics. Two alternatives lost: a thread per row with
//   Hopper's float4 reductions (fewer, wider requests, but strided loads
//   and a third of the threads), and rows held in shared memory (on sm_90 a
//   float atomicAdd there is a compare-and-swap loop, ATOMS.CAST.SPIN; both
//   in tools/scatter_trials.cu). Index arithmetic is 32-bit (the wrapper
//   refuses 3 B Q or 3 B V >= 2^31). The order of the additions into one
//   row varies from run to run, so the scatter is not bitwise deterministic
//   (it equals index_add_ to fp32 rounding of the summation order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GATHER_THREADS = 256;
constexpr int SCATTER_THREADS = 1024;
constexpr int SCATTER_UNROLL = 4;  // floats per thread and pass
constexpr int MAX_CLUSTER = 8;     // the portable limit; ops/gather.py
constexpr int MAX_GRID_Y = 65535;  // the batch axis

__global__ void __launch_bounds__(GATHER_THREADS)
    gather_rows_kernel(const float* __restrict__ values,
                       const int* __restrict__ idx, float* __restrict__ out,
                       int V, int Q, int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (t >= total) return;
  const int64_t bq = t / 3;
  const int c = (int)(t - bq * 3);
  const int64_t b = bq / Q;
  const int i = idx[bq];
  out[t] = (i >= 0 && i < V) ? values[(b * V + i) * 3 + c] : 0.f;
}

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

// values, idx, out: device pointers; stream: a cudaStream_t. Allocates
// nothing and does not synchronise. Returns the cudaError_t of the launch.
extern "C" int tuch_gather_rows(const void* values, const void* idx,
                                void* out, int B, int V, int Q,
                                void* stream) {
  if (B <= 0 || V <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * Q * 3;
  gather_rows_kernel<<<(unsigned)((total + GATHER_THREADS - 1) /
                                  GATHER_THREADS),
                       GATHER_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(idx),
      static_cast<float*>(out), V, Q, total);
  return (int)cudaGetLastError();
}

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
