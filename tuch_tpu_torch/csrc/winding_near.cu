// Near field of the hierarchical winding numbers, for Hopper (sm_90a).
//
// Replaces the TPU kernel tuch_tpu/ops/winding_hier.py:_near_kernel (called
// by winding_numbers_hier): for every point of a tile of TQ points, the
// exact Van Oosterom-Strackee solid angles of the C triangles of each of the
// tile's M selected clusters, summed in m order and, inside a cluster, in c
// order. The sum is in radians (the caller adds the far field and scales).
//
//   sel (B, T, M) i32 in [0, K), pts (B, 3, Qp) f32 with Qp = T * TQ,
//   tris (B, K, 9, C) f32 rows [ax ay az bx by bz cx cy cz]  ->  (B, Qp)
//
// What bounds it on this card. 67 operations per (point, triangle) pair
// (counted in solid_angle.cuh, half_angle) over B * Qp * M * C pairs; the
// bytes, 4 B (3 Qp + 9 K C + Qp + T M), are a few tens of MB at the body's
// shapes, so it is bound by operations on the fp32 CUDA cores by a wide
// margin. As for kernel 2, the unfused arithmetic the plain version's bits
// need caps it below half of the 67 TFLOP/s bound, which counts an FMA as
// two operations.
//
// What the design does about it. The TPU kernel walks the grid (b, t, m) in
// order and picks the cluster's triangle block by scalar prefetch. Here the
// pair is kernel 2's (csrc/winding.cu, tuch::half_angle: the plain version's
// numerator and denominator, the polynomial atan2), and so is the shape:
//   * a block holds BQ = NT x QPT = 512 points, a whole tile at the JAX
//     defaults, QPT per thread with their accumulators in registers; so
//     each selected cluster is read once per tile. A tile of TQ points
//     takes ceil(TQ / BQ) blocks; a point past TQ computes and is dropped;
//   * the block reads sel[b, t, m] itself (one word, the same for every
//     thread) and stages that cluster's triangles, CT at a time, into a
//     ring of STAGES slots in shared memory, three float4 per triangle as
//     kernel 2's tile: 4-byte cp.async copies, coalesced in global memory
//     and transposed on the way in, so the next stage lands while this one
//     computes and three vector loads (a broadcast) serve QPT pairs;
//   * each cluster's solid angles are summed into a partial that is then
//     added to the accumulator, as the plain version sums per cluster;
//   * at small B the blocks cannot fill 132 SMs, so the m axis is split over
//     the second grid dimension and a second pass adds the splits in order:
//     deterministic, no atomics;
//   * no FMA contraction (solid_angle.cuh): the padding faces of a cluster
//     (one vertex three times) and the faces around a point's own vertex add
//     exactly 0, as in the plain version.
// A cluster index outside [0, K) is skipped, so a bad index cannot read
// outside tris; the plain version raises on it.

#include "solid_angle.cuh"

namespace {

using tuch::add;
using tuch::mul;

constexpr int NT = 128;       // threads per block
constexpr int QPT = 4;        // points per thread
constexpr int BQ = NT * QPT;  // points per block
constexpr int CT = 256;       // triangles per shared-memory stage
constexpr int STAGES = 2;     // stages in the shared-memory ring

// Issue the copies of triangles [c0, c0 + n) of one cluster (rows of C at
// tk) into a slot: triangle j's nine corners at floats 12 j .. 12 j + 8.
__device__ __forceinline__ void stage(float4* slot, const float* tk, int C,
                                      int c0, int n) {
  float* f = reinterpret_cast<float*>(slot);
  for (int r = 0; r < 9; ++r)
    for (int j = threadIdx.x; j < n; j += NT)
      tuch::copy_async4(f + j * 12 + r, tk + (int64_t)r * C + c0 + j);
}

// Grid (T * subs, splits, B) with subs = ceil(TQ / BQ). Split s covers the
// selected clusters m in [s * mchunk, min(M, (s + 1) * mchunk)), in stages
// u = (m - s * mchunk) * per + c0 / CT with per = ceil(C / CT), and writes
// dst[(b * splits + s) * Qp + q] = its sum. Thread t of a block holds the
// points t, t + NT, ... of the block's BQ.
__global__ void __launch_bounds__(NT)
    near_kernel(const int* __restrict__ sel, const float* __restrict__ pts,
                const float* __restrict__ tris, float* __restrict__ dst,
                int T, int TQ, int M, int K, int C, int mchunk) {
  __shared__ float4 ring[STAGES][CT * 3];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int splits = gridDim.y;
  const int subs = (TQ + BQ - 1) / BQ;
  const int t = blockIdx.x / subs;
  const int i0 = (blockIdx.x - t * subs) * BQ + threadIdx.x;
  const int Qp = T * TQ;
  float qx[QPT], qy[QPT], qz[QPT], acc[QPT], part[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = i0 + k * NT;
    qx[k] = qy[k] = qz[k] = 0.f;
    if (i < TQ) {
      const float* p = pts + (int64_t)b * 3 * Qp + t * TQ + i;
      qx[k] = p[0];
      qy[k] = p[Qp];
      qz[k] = p[2 * (int64_t)Qp];
    }
    acc[k] = part[k] = 0.f;
  }
  const int* sb = sel + ((int64_t)b * T + t) * M;
  const int m_lo = s * mchunk;
  const int per = (C + CT - 1) / CT;
  const int n_stages = (min(M, m_lo + mchunk) - m_lo) * per;
  const float* tb = tris + (int64_t)b * K * 9 * C;
  auto issue = [&](int u) {
    const int k = sb[m_lo + u / per];  // the same for every thread: uniform
    const int c0 = (u % per) * CT;
    if (k >= 0 && k < K)
      stage(ring[u % STAGES], tb + (int64_t)k * 9 * C, C, c0,
            min(CT, C - c0));
  };
#pragma unroll
  for (int u = 0; u < STAGES - 1; ++u) {
    if (u < n_stages) issue(u);
    tuch::copy_commit();
  }
  for (int u = 0; u < n_stages; ++u) {
    if (u + STAGES - 1 < n_stages) issue(u + STAGES - 1);
    tuch::copy_commit();
    tuch::copy_wait<STAGES - 1>();  // this thread's copies of stage u landed
    __syncthreads();                // ... and every other thread's
    const int k = sb[m_lo + u / per];
    if (k >= 0 && k < K) {
      const int c0 = (u % per) * CT;
      const int n = min(CT, C - c0);
      const float4* tile = ring[u % STAGES];
      for (int j = 0; j < n; ++j) {
        const float4 t0 = tile[3 * j], t1 = tile[3 * j + 1],
                     t2 = tile[3 * j + 2];
#pragma unroll
        for (int q = 0; q < QPT; ++q)
          part[q] = add(part[q],
                        tuch::half_angle(qx[q], qy[q], qz[q], t0, t1, t2));
      }
      if (c0 + n == C) {  // the cluster's last stage
#pragma unroll
        for (int q = 0; q < QPT; ++q) {
          acc[q] = add(acc[q], mul(2.f, part[q]));
          part[q] = 0.f;
        }
      }
    }
    __syncthreads();  // stage u is consumed before its slot is refilled
  }
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = i0 + k * NT;
    if (i < TQ) dst[((int64_t)b * splits + s) * Qp + t * TQ + i] = acc[k];
  }
}

}  // namespace

// The kernel's shape, for the wrapper's plan: threads per block, points per
// thread, triangles per stage.
extern "C" int tuch_winding_near_shape(int* out) {
  out[0] = NT;
  out[1] = QPT;
  out[2] = CT;
  return 0;
}

// sel, points, tris, out: device pointers in the layouts above. mchunk:
// selected clusters per split, splits = ceil(M / mchunk). partial: device
// scratch of B * splits * T * TQ floats when splits > 1 (unused, may be
// null, when splits == 1). stream: a cudaStream_t. Allocates nothing and
// does not synchronise. Returns the cudaError_t of the launch.
extern "C" int tuch_winding_near(const void* sel, const void* points,
                                 const void* tris, void* out, void* partial,
                                 int B, int T, int TQ, int M, int K, int C,
                                 int mchunk, void* stream) {
  if (B <= 0 || T <= 0 || TQ <= 0 || M <= 0 || K <= 0 || C <= 0 ||
      mchunk <= 0)
    return (int)cudaErrorInvalidValue;
  const int splits = (M + mchunk - 1) / mchunk;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int subs = (TQ + BQ - 1) / BQ;
  const dim3 grid(T * subs, splits, B);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  near_kernel<<<grid, NT, 0, st>>>(
      static_cast<const int*>(sel), static_cast<const float*>(points),
      static_cast<const float*>(tris), dst, T, TQ, M, K, C, mchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return tuch::sum_partials(static_cast<const float*>(partial),
                            static_cast<float*>(out), B, T * TQ, splits, 1.f,
                            st);
}

extern "C" const char* tuch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
