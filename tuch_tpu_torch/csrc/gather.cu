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
//            sum of the contributions per index, each row's taken in
//            ascending q; an index outside [0, V) is dropped.
//
// What bounds them on this card. Neither does arithmetic worth counting
// (the scatter adds 3 B Q floats). Counting each input read once and each
// output written once, they move 4 B (3 V + Q + 3 Q) bytes (gather) and
// 4 B (3 Q + Q + 3 V) bytes (scatter), and are bound by those bytes: 12.3
// MB, 0.0037 ms at B = 64, V = Q = 6890. At that size everything fits in
// the 50 MB L2.
//
// What the design does about it. The TPU kernels build (TM, TQ) one-hot
// tiles and select rows on the MXU in three exact bf16 planes, because XLA
// serialises scatters on the TPU. Here both are direct.
// - Gather (as first ported): one thread per (b, q, c) element,
//   consecutive threads on consecutive addresses of idx, values and out. A
//   copy: bitwise equal to torch.gather. Timed by device time it reaches
//   two thirds of its bound and is faster than both library calls
//   (PERF.md), so it was left as it is.
// - Scatter, in a fixed order: every output row is the sum of its
//   contributions in ascending q, added one after another from +0 (the
//   order of the plain version's index_add_ on the CPU, so the two agree
//   bit for bit), with no float atomics. The atomic form it replaces (now
//   kept in tools/scatter_atomic.cu) added in an order that changed from
//   run to run, and the card's training runs drifted apart with it
//   (ROADMAP fault 4). One block of 1024 threads per batch item b (grid
//   (1, B)) sorts item b's contributions by row in shared memory, a
//   counting sort: (1) it counts the contributions of each row with
//   integer atomics (the counts, unlike float sums, do not depend on the
//   order); (2) an exclusive scan of the counts gives each row its first
//   slot; (3) each valid q takes a slot of its row by an integer atomic
//   (in any order); (4) a thread per row sorts its row's slots by q
//   (insertion sort: rows are short, and the atomics hand out slots nearly
//   in q order, so there is little to move); (5) the same thread sums the
//   row's contributions in that order and writes the row, so every row of
//   out is written once and nothing needs a memset. Shared memory holds
//   V + Q + 32 ints (55,248 bytes at the body's V = Q = 6890); the wrapper
//   refuses what does not fit in a block's 227 KB. Index arithmetic is
//   64-bit per item base, 32-bit inside an item.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GATHER_THREADS = 256;
constexpr int SCATTER_THREADS = 1024;
constexpr int SCATTER_WARPS = SCATTER_THREADS / 32;
constexpr int MAX_SHARED = 232448;  // bytes a block may use (227 KB)
constexpr int DEFAULT_SHARED = 48 * 1024;  // without the opt-in attribute
constexpr int MAX_GRID_Y = 65535;  // the batch axis
constexpr int MAX_DEVICES = 64;

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

// a[0, n) <- its exclusive prefix sums, by the whole block; sums[0, 32) is
// scratch. Thread t scans a run of ceil(n / THREADS) consecutive entries
// (a stride coprime with the 32 banks at the body's n), the runs' totals
// are scanned by shuffles within each warp and across the warps' totals.
__device__ __forceinline__ void exclusive_scan(int* a, int n, int* sums) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (n + SCATTER_THREADS - 1) / SCATTER_THREADS;
  const int lo = min(n, t * per), hi = min(n, lo + per);
  int own = 0;
  for (int k = lo; k < hi; ++k) own += a[k];
  int x = own;  // inclusive scan of the runs' totals within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < SCATTER_WARPS ? sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    sums[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  int run = x - own + (warp ? sums[warp - 1] : 0);
  for (int k = lo; k < hi; ++k) {
    const int c = a[k];
    a[k] = run;
    run += c;
  }
}

// Grid (1, B): block b sums item b's contributions per row in ascending q
// (see the header). Dynamic shared memory: 32 + V + Q ints.
__global__ void __launch_bounds__(SCATTER_THREADS)
    scatter_add_rows_kernel(const float* __restrict__ contrib,
                            const int* __restrict__ idx,
                            float* __restrict__ out, int V, int Q) {
  extern __shared__ int smem[];
  int* sums = smem;          // the scan's scratch
  int* pos = smem + 32;      // per row: count, first slot, then end slot
  int* slot = pos + V;       // the valid q, grouped by row
  const int t = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int* ib = idx + b * Q;
  const float* cb = contrib + b * 3 * Q;
  float* ob = out + b * 3 * V;
  for (int r = t; r < V; r += SCATTER_THREADS) pos[r] = 0;
  __syncthreads();
  for (int q = t; q < Q; q += SCATTER_THREADS) {          // (1) count
    const int i = __ldg(ib + q);
    if ((unsigned)i < (unsigned)V) atomicAdd(pos + i, 1);
  }
  __syncthreads();
  exclusive_scan(pos, V, sums);                           // (2) first slots
  __syncthreads();
  for (int q = t; q < Q; q += SCATTER_THREADS) {          // (3) fill
    const int i = __ldg(ib + q);
    if ((unsigned)i < (unsigned)V) slot[atomicAdd(pos + i, 1)] = q;
  }
  __syncthreads();
  // pos[r] is now the end of row r's slots and pos[r - 1] their start
  for (int r = t; r < V; r += SCATTER_THREADS) {
    const int lo = r ? pos[r - 1] : 0, hi = pos[r];
    for (int k = lo + 1; k < hi; ++k) {                   // (4) sort by q
      const int s = slot[k];
      int j = k;
      for (; j > lo && slot[j - 1] > s; --j) slot[j] = slot[j - 1];
      slot[j] = s;
    }
    float x = 0.f, y = 0.f, z = 0.f;                      // (5) sum
    for (int k = lo; k < hi; ++k) {
      const float* c = cb + 3 * slot[k];
      x = __fadd_rn(x, __ldg(c));
      y = __fadd_rn(y, __ldg(c + 1));
      z = __fadd_rn(z, __ldg(c + 2));
    }
    ob[3 * r] = x;
    ob[3 * r + 1] = y;
    ob[3 * r + 2] = z;
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

// One block per batch item; 4 (32 + V + Q) bytes of shared memory, at most
// MAX_SHARED (ops/gather.py scatter_shared_bytes).
extern "C" int tuch_scatter_add_rows(const void* contrib, const void* idx,
                                     void* out, int B, int V, int Q,
                                     void* stream) {
  const int64_t shared = 4 * ((int64_t)32 + V + Q);
  if (B <= 0 || V <= 0 || Q <= 0 || B > MAX_GRID_Y || shared > MAX_SHARED)
    return (int)cudaErrorInvalidValue;
  if (shared > DEFAULT_SHARED) {  // the opt-in, once per device
    static bool opted[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && (dev >= MAX_DEVICES || !opted[dev]))
      err = cudaFuncSetAttribute(scatter_add_rows_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 MAX_SHARED);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) opted[dev] = true;
  }
  scatter_add_rows_kernel<<<dim3(1, B), SCATTER_THREADS, (size_t)shared,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(contrib), static_cast<const int*>(idx),
      static_cast<float*>(out), V, Q);
  return (int)cudaGetLastError();
}

extern "C" const char* tuch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
