// Kernel 6 (row scatter-add) in its first fixed-order form: kept to
// measure the package's kernel (csrc/gather.cu) against. Not part of the
// package: tools/slice_variants.py times it, and variants of it with its
// phases compiled out, beside the package's kernel on the same inputs.
//
// contrib (B, Q, 3) f32, idx (B, Q) int32 -> out (B, V, 3), each row the
// sum of its contributions in ascending q from +0; an index outside [0, V)
// is dropped. One block of 1024 threads per batch item b (grid (1, B))
// sorts item b's contributions by row in shared memory, a counting sort:
// (1) it counts the contributions of each row with integer atomics; (2) an
// exclusive scan of the counts gives each row its first slot; (3) each
// valid q takes a slot of its row by an integer atomic (in any order); (4)
// a thread per row sorts its row's slots by q (insertion sort); (5) the
// same thread sums the row's contributions in that order, reading each
// from global memory, and writes the row. Shared memory holds V + Q + 32
// ints (55,248 bytes at V = Q = 6890).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCATTER_THREADS = 1024;
constexpr int SCATTER_WARPS = SCATTER_THREADS / 32;
constexpr int MAX_SHARED = 232448;  // bytes a block may use (227 KB)
constexpr int DEFAULT_SHARED = 48 * 1024;  // without the opt-in attribute
constexpr int MAX_GRID_Y = 65535;  // the batch axis
constexpr int MAX_DEVICES = 64;

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

// One block per batch item; 4 (32 + V + Q) bytes of shared memory, at most
// MAX_SHARED.
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
