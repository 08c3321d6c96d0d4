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
//   bit for bit), with no float atomics, so the result repeats from run to
//   run (ROADMAP fault 4; the atomic form is kept in tools/scatter_atomic.cu,
//   its first fixed-order form in tools/scatter_sorted.cu). Rows run in
//   parallel; the adds within a row may not.
//   C CTAs of 1024 threads share batch item b (grid (C, B)); CTA c owns the
//   rows [c S, c S + S), S = ceil(V / C), and the wrapper picks C to fill
//   the card's SMs (ops/gather.py scatter_plan). Each CTA reads item b's
//   whole index row (coalesced, kept in shared memory) and keeps the
//   contributions that fall in its rows, so nothing crosses CTAs: no
//   cluster barrier and no second pass. Every step of a CTA is parallel
//   over its contributions or its rows; none walks them in order:
//   (1) it loads the index row and, for its own rows, the contributions
//       (coalesced, in q order, held in registers for step 4), and counts
//       each row's contributions with integer atomics (the counts do not
//       depend on the order);
//   (2) a scan of the counts gives each row its slots;
//   (3) each contribution takes a slot of its row by an integer atomic, in
//       any order, and writes its q there;
//   (4) each contribution's rank in its row is the number of the row's q
//       below its own (it reads the row's slots: O(n) for a row of n, in
//       parallel over the row's n contributions, where the first
//       fixed-order form had one thread sort the row in O(n^2) steps one
//       after another); it stages its
//       contribution at the row's first slot + its rank, so every row's
//       contributions lie in shared memory in ascending q;
//   (5) a thread per row adds its staged contributions one __fadd_rn
//       after another and writes the row, rows with none as zeros, 32
//       consecutive rows a warp, so every row of out is written once
//       (coalesced) and nothing needs a memset. A row's adds are one
//       chain, so the longest row bounds the kernel: 53 at the posed B=64
//       body, every q at worst (tests/test_torch_port_kernels.py).
//   Shared memory: 20 Q + 8 S + 132 bytes (the staged contributions, the
//   index row, the slots' q, each row's first slot and cursor, the scan's
//   scratch): 165,492 at V = Q = 6890, C = 2. The wrapper refuses what the
//   plan cannot hold. Index arithmetic is 64-bit per item base, 32-bit
//   inside an item. tools/scatter_buckets.cu keeps a draft of this design
//   that placed each row's contributions in order by warp-level
//   __match_any_sync instead of counting ranks (slower on the card,
//   tools/slice_variants.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GATHER_THREADS = 256;
constexpr int SCATTER_THREADS = 1024;
constexpr int SCATTER_WARPS = SCATTER_THREADS / 32;
constexpr int SCATTER_HELD = 8;    // q a thread holds from step 1 to 4
constexpr int MAX_SPLIT = 32;      // CTAs per batch item (ops/gather.py)
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

// The exclusive prefix sums of a[0, n), by the whole block, each handed to
// put(k, sum before k, total); sums[0, 32) is scratch. Thread t scans a
// run of ceil(n / THREADS) consecutive entries (a stride coprime with the
// 32 banks at the body's n), the runs' totals are scanned by shuffles
// within each warp and across the warps' totals.
template <class Put>
__device__ __forceinline__ void exclusive_scan(const int* a, int n,
                                               int* sums, Put put) {
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
  const int total = sums[31];
  int run = x - own + (warp ? sums[warp - 1] : 0);
  for (int k = lo; k < hi; ++k) {
    const int c = a[k];
    put(k, run, total);
    run += c;
  }
}

// Shared memory of one CTA, in bytes: the staged contributions (3 floats
// a slot), the index row, each slot's q, each row's first slot (and the
// end), each row's count / cursor, the scan's 32 ints. ops/gather.py
// scatter_shared_bytes computes the same.
__host__ __device__ constexpr int64_t scatter_shared(int64_t Q, int64_t S) {
  return 4 * (3 * Q + Q + Q + (S + 1) + S + 32);
}

// Grid (C, B): CTA (c, b) sums item b's contributions to the rows
// [c S, min(V, c S + S)), each in ascending q (see the header).
__global__ void __launch_bounds__(SCATTER_THREADS)
    scatter_add_rows_kernel(const float* __restrict__ contrib,
                            const int* __restrict__ idx,
                            float* __restrict__ out, int V, int Q, int S) {
  constexpr int T = SCATTER_THREADS;
  constexpr int H = SCATTER_HELD;
  extern __shared__ int smem[];
  float* stage = reinterpret_cast<float*>(smem);           // 3 Q
  int* ids = smem + 3 * Q;                                 // Q
  int* qs = ids + Q;                                       // Q
  int* start = qs + Q;                                     // S + 1
  int* cur = start + S + 1;                                // S
  int* sums = cur + S;                                     // 32
  const int lo = blockIdx.x * S;
  if (lo >= V) return;                    // the whole CTA: no rows
  const int rows = min(S, V - lo), hi = lo + rows;
  const int t = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int* ib = idx + b * Q;
  const float* cb = contrib + b * 3 * Q;
  // (1) the index row, q = u T + t for u < H, its loads in flight while
  // the counts are zeroed, with this CTA's contributions held for (4)
  int g[H];
  float x[H], y[H], z[H];
#pragma unroll
  for (int u = 0; u < H; ++u)
    g[u] = u * T + t < Q ? __ldg(ib + u * T + t) : -1;
  for (int r = t; r < rows; r += T) cur[r] = 0;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < H; ++u) {
    const int q = u * T + t;
    if (q < Q) ids[q] = g[u];
    if (g[u] >= lo && g[u] < hi) {
      atomicAdd(cur + (g[u] - lo), 1);
      x[u] = __ldg(cb + 3 * q);
      y[u] = __ldg(cb + 3 * q + 1);
      z[u] = __ldg(cb + 3 * q + 2);
    }
  }
  for (int q = H * T + t; q < Q; q += T) {  // beyond what threads hold
    const int i = __ldg(ib + q);
    ids[q] = i;
    if (i >= lo && i < hi) atomicAdd(cur + (i - lo), 1);
  }
  __syncthreads();
  // (2) each row's first slot; the cursors back to 0
  exclusive_scan(cur, rows, sums, [&](int r, int first, int n) {
    start[r] = first;
    cur[r] = 0;
    if (r == rows - 1) start[rows] = n;
  });
  __syncthreads();
  // (3) a slot of its row for each contribution, in any order
  for (int q = t; q < Q; q += T) {
    const int i = ids[q];
    if (i >= lo && i < hi)
      qs[start[i - lo] + atomicAdd(cur + (i - lo), 1)] = q;
  }
  __syncthreads();
  // (4) each contribution at its row's first slot + its rank in the row
  auto place = [&](int q, float cx, float cy, float cz) {
    const int r = ids[q] - lo, s0 = start[r], s1 = start[r + 1];
    int rank = 0;
#pragma unroll 4
    for (int k = s0; k < s1; ++k) rank += qs[k] < q;
    float* d = stage + 3 * (s0 + rank);
    d[0] = cx;
    d[1] = cy;
    d[2] = cz;
  };
#pragma unroll
  for (int u = 0; u < H; ++u)
    if (g[u] >= lo && g[u] < hi) place(u * T + t, x[u], y[u], z[u]);
  for (int q = H * T + t; q < Q; q += T) {
    const int i = ids[q];
    if (i >= lo && i < hi)
      place(q, __ldg(cb + 3 * q), __ldg(cb + 3 * q + 1),
            __ldg(cb + 3 * q + 2));
  }
  __syncthreads();
  // (5) a thread per row: its contributions in ascending q, one add after
  // another from +0, and the row written (zeros for a row with none)
  float* ob = out + b * 3 * V + 3 * (int64_t)lo;
  for (int r = t; r < rows; r += T) {
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll 4
    for (int k = start[r], e = start[r + 1]; k < e; ++k) {
      sx = __fadd_rn(sx, stage[3 * k]);
      sy = __fadd_rn(sy, stage[3 * k + 1]);
      sz = __fadd_rn(sz, stage[3 * k + 2]);
    }
    ob[3 * r] = sx;
    ob[3 * r + 1] = sy;
    ob[3 * r + 2] = sz;
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

// C CTAs per batch item (1 <= C <= MAX_SPLIT), each with
// scatter_shared(Q, ceil(V / C)) bytes of shared memory, at most
// MAX_SHARED (ops/gather.py scatter_plan picks C).
extern "C" int tuch_scatter_add_rows(const void* contrib, const void* idx,
                                     void* out, int B, int V, int Q, int C,
                                     void* stream) {
  if (B <= 0 || V <= 0 || Q <= 0 || C <= 0 || C > MAX_SPLIT ||
      B > MAX_GRID_Y)
    return (int)cudaErrorInvalidValue;
  const int S = (V + C - 1) / C;
  const int64_t shared = scatter_shared(Q, S);
  if (shared > MAX_SHARED) return (int)cudaErrorInvalidValue;
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
  scatter_add_rows_kernel<<<dim3(C, B), SCATTER_THREADS, (size_t)shared,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(contrib), static_cast<const int*>(idx),
      static_cast<float*>(out), V, Q, S);
  return (int)cudaGetLastError();
}

extern "C" const char* tuch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
