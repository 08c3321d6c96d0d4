// Kernel 6 (row scatter-add) in a fixed order as a draft of its present
// design had it: warp buckets placed by __match_any_sync. Not part of the
// package: tools/slice_variants.py times it, and with one ballot per key
// bit in the match's place, beside the package's kernel (csrc/gather.cu)
// on the same inputs.
//
// contrib (B, Q, 3) f32, idx (B, Q) int32 -> out (B, V, 3), each row the
// sum of its contributions in ascending q from +0; an index outside [0, V)
// is dropped. C CTAs of 1024 threads share batch item b (grid (C, B)); CTA
// c owns the rows [c S, c S + S), S = ceil(V / C), reads the item's whole
// index row and keeps its rows' contributions. In a CTA: (1) it counts its
// rows' contributions (integer atomics); (2) a scan of the counts gives
// each row its first slot, and the row goes to the warp whose 1/32 of the
// slots holds it (its owner); (3) warp w takes the w-th contiguous 1/32 of
// q and counts its contributions per owner; (4) a scan of those counts,
// owner-major, gives each (owner, chunk) its first slot, and a second walk
// over the chunk places each contribution at its rank among the step's
// lanes of its owner (__match_any_sync) after the steps before, so each
// owner's entries lie in ascending q; they are staged in shared memory
// with their row; (5) each warp walks its entries 32 at a time, the lanes
// of one row (__match_any_sync) added by the lowest of them in lane order
// onto the row's running sum; (6) the CTA writes its rows, coalesced.
// Shared memory: 20 Q + 16 S + 4356 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCATTER_THREADS = 1024;
constexpr int SCATTER_WARPS = SCATTER_THREADS / 32;  // also the owners
constexpr int SCATTER_GROUP = 8;   // index loads in flight per thread
constexpr int SCATTER_PLACE = 4;   // steps whose loads precede their slots
constexpr int MAX_SPLIT = 32;      // CTAs per batch item
constexpr int MAX_SHARED = 232448;  // bytes a block may use (227 KB)
constexpr int DEFAULT_SHARED = 48 * 1024;  // without the opt-in attribute
constexpr int MAX_GRID_Y = 65535;  // the batch axis
constexpr int MAX_DEVICES = 64;

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

// The lanes of this warp whose key equals this lane's, among the valid
// lanes; 0 for an invalid lane. (tools/slice_variants.py also builds one
// ballot per key bit below 2^bits in its place: slower on the card.)
__device__ __forceinline__ unsigned same_key(int key, bool valid,
                                             int bits) {
  const unsigned m = __match_any_sync(0xffffffffu, valid ? key : -1);
  return valid ? m : 0u;
}

// Shared memory of one CTA, in bytes: the staged entries (a float4 each,
// at the base for its alignment), the owner x chunk counts, the scan's 32
// ints, the owners' first slots, the index row, a count / owner and a
// running sum (3 floats) per row.
__host__ __device__ constexpr int64_t scatter_shared(int64_t Q, int64_t S) {
  return 4 * (4 * Q + SCATTER_WARPS * SCATTER_WARPS + 32 +
              (SCATTER_WARPS + 1) + Q + S + 3 * S);
}

// Grid (C, B): CTA (c, b) sums item b's contributions to the rows
// [c S, min(V, c S + S)), each in ascending q (see the file's head).
__global__ void __launch_bounds__(SCATTER_THREADS)
    scatter_add_rows_kernel(const float* __restrict__ contrib,
                            const int* __restrict__ idx,
                            float* __restrict__ out, int V, int Q, int S) {
  constexpr int W = SCATTER_WARPS;
  constexpr int T = SCATTER_THREADS;
  constexpr int OWNER_BITS = 5;           // W = 2^5 owners
  constexpr unsigned FULL = 0xffffffffu;
  static_assert((1 << OWNER_BITS) == W, "an owner's bits");
  extern __shared__ float4 stage[];                        // Q entries
  int* tally = reinterpret_cast<int*>(stage + Q);          // W x W
  int* sums = tally + W * W;                               // 32
  int* first = sums + 32;                                  // W + 1
  int* ids = first + W + 1;                                // Q
  int* own = ids + Q;                                      // S
  float* acc = reinterpret_cast<float*>(own + S);          // 3 S
  const int lo = blockIdx.x * S;
  if (lo >= V) return;                    // the whole CTA: no rows
  const int rows = min(S, V - lo), hi = lo + rows;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const unsigned below = (1u << lane) - 1;
  const int64_t b = blockIdx.y;
  const int* ib = idx + b * Q;
  const float* cb = contrib + b * 3 * Q;
  // (1) the index row into shared memory, its first loads in flight while
  // the counts and sums are zeroed; count this CTA's rows
  int g[SCATTER_GROUP];
#pragma unroll
  for (int u = 0; u < SCATTER_GROUP; ++u)
    g[u] = u * T + t < Q ? __ldg(ib + u * T + t) : -1;
  for (int r = t; r < rows; r += T) own[r] = 0;
  for (int f = t; f < 3 * rows; f += T) acc[f] = 0.f;
  for (int k = t; k < W * W; k += T) tally[k] = 0;
  __syncthreads();
  for (int q0 = 0;;) {
#pragma unroll
    for (int u = 0; u < SCATTER_GROUP; ++u) {
      const int q = q0 + u * T + t;
      if (q < Q) {
        ids[q] = g[u];
        if (g[u] >= lo && g[u] < hi) atomicAdd(own + (g[u] - lo), 1);
      }
    }
    q0 += SCATTER_GROUP * T;
    if (q0 >= Q) break;
#pragma unroll
    for (int u = 0; u < SCATTER_GROUP; ++u)
      g[u] = q0 + u * T + t < Q ? __ldg(ib + q0 + u * T + t) : -1;
  }
  __syncthreads();
  // (2) each row's owner: the warp of its first slot
  exclusive_scan(own, rows, sums, [&](int r, int start, int n) {
    own[r] = min(W - 1, start * W / max(n, 1));
  });
  __syncthreads();
  // (3) warp w's chunk of q: its contributions per owner (integer atomics,
  // in any order: column w is warp w's)
  const int chunk = (Q + W - 1) / W;
  const int c_lo = min(Q, w * chunk), c_hi = min(Q, c_lo + chunk);
  for (int q = c_lo + lane; q < c_hi; q += 32) {
    const int i = ids[q];
    if (i >= lo && i < hi) atomicAdd(tally + own[i - lo] * W + w, 1);
  }
  __syncthreads();
  // (4) first slots per (owner, chunk), owner-major; place and stage: the
  // loads of a group of steps first, then their slots in step order
  exclusive_scan(tally, W * W, sums, [&](int k, int start, int n) {
    tally[k] = start;
    if (k % W == 0) first[k / W] = start;
    if (k == 0) first[W] = n;
  });
  __syncthreads();
  for (int q0 = c_lo; q0 < c_hi; q0 += 32 * SCATTER_PLACE) {
    int o[SCATTER_PLACE], r[SCATTER_PLACE];
    float x[SCATTER_PLACE], y[SCATTER_PLACE], z[SCATTER_PLACE];
#pragma unroll
    for (int u = 0; u < SCATTER_PLACE; ++u) {
      const int q = q0 + 32 * u + lane;
      o[u] = -1;
      const int i = q < c_hi ? ids[q] : -1;
      if (i >= lo && i < hi) {
        const float* c = cb + 3 * q;
        r[u] = i - lo;
        o[u] = own[r[u]];
        x[u] = __ldg(c);
        y[u] = __ldg(c + 1);
        z[u] = __ldg(c + 2);
      }
    }
#pragma unroll
    for (int u = 0; u < SCATTER_PLACE; ++u) {
      const unsigned peers = same_key(o[u], o[u] >= 0, OWNER_BITS);
      const int leader = peers ? __ffs(peers) - 1 : lane;
      int slot = (o[u] >= 0 && lane == leader) ? tally[o[u] * W + w] : 0;
      slot = __shfl_sync(FULL, slot, leader);
      if (o[u] >= 0) {
        stage[slot + __popc(peers & below)] =
            make_float4(x[u], y[u], z[u], __int_as_float(r[u]));
        if (lane == leader) tally[o[u] * W + w] = slot + __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // (5) warp w's entries in ascending q onto its rows' running sums
  const int e_hi = first[w + 1];
  const int row_bits = rows > 1 ? 32 - __clz(rows - 1) : 0;
  for (int e0 = first[w]; e0 < e_hi; e0 += 32) {
    const int e = e0 + lane;
    const int r = e < e_hi ? __float_as_int(stage[e].w) : -1;
    const unsigned peers = same_key(r, r >= 0, row_bits);
    if (r >= 0 && !(peers & below)) {
      float x = acc[3 * r], y = acc[3 * r + 1], z = acc[3 * r + 2];
      for (unsigned m = peers; m; m &= m - 1) {
        const float4 v = stage[e0 + __ffs(m) - 1];
        x = __fadd_rn(x, v.x);
        y = __fadd_rn(y, v.y);
        z = __fadd_rn(z, v.z);
      }
      acc[3 * r] = x;
      acc[3 * r + 1] = y;
      acc[3 * r + 2] = z;
    }
    __syncwarp();
  }
  __syncthreads();
  // (6) every row of this CTA, coalesced
  float* ob = out + b * 3 * V + 3 * (int64_t)lo;
  for (int f = t; f < 3 * rows; f += T) ob[f] = acc[f];
}

}  // namespace

// C CTAs per batch item (1 <= C <= MAX_SPLIT), each with
// scatter_shared(Q, ceil(V / C)) bytes of shared memory, at most
// MAX_SHARED.
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
