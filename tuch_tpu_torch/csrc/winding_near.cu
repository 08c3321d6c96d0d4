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
// (counted in solid_angle.cuh) over B * Qp * M * C pairs; the bytes,
// 4 B (3 Qp + 9 K C + Qp + T M), are a few tens of MB at the body's shapes,
// so it is bound by operations on the fp32 CUDA cores by a wide margin.
//
// What the design does about it. The TPU kernel walks the grid (b, t, m) in
// order and picks the cluster's triangle block by scalar prefetch. Here:
//   * a block holds NT points of one tile, one thread each, with the point
//     and an fp32 accumulator in registers; a tile of TQ points takes
//     ceil(TQ / NT) blocks;
//   * the block reads sel[b, t, m] itself (one word, the same for every
//     thread) and stages that cluster's triangles, CT at a time, through
//     shared memory, coordinate-major as in HBM, so the copy is coalesced
//     and every thread reads the same word of the tile (a broadcast);
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

constexpr int NT = 128;  // points per block, one thread each
constexpr int CT = 128;  // triangles per shared-memory stage

// Grid (T * subs, splits, B) with subs = ceil(TQ / NT). Split s covers the
// selected clusters m in [s * mchunk, min(M, (s + 1) * mchunk)) and writes
// dst[(b * splits + s) * Qp + q] = its sum.
__global__ void __launch_bounds__(NT)
    near_kernel(const int* __restrict__ sel, const float* __restrict__ pts,
                const float* __restrict__ tris, float* __restrict__ dst,
                int T, int TQ, int M, int K, int C, int mchunk) {
  __shared__ float tile[9][CT];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int splits = gridDim.y;
  const int subs = (TQ + NT - 1) / NT;
  const int t = blockIdx.x / subs;
  const int i = (blockIdx.x - t * subs) * NT + threadIdx.x;
  const int Qp = T * TQ;
  const int q = t * TQ + i;
  const bool live = i < TQ;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* p = pts + (int64_t)b * 3 * Qp + q;
    qx = p[0];
    qy = p[Qp];
    qz = p[2 * (int64_t)Qp];
  }
  const int* sb = sel + ((int64_t)b * T + t) * M;
  const int m_lo = s * mchunk;
  const int m_hi = min(M, m_lo + mchunk);
  float acc = 0.f;
  for (int m = m_lo; m < m_hi; ++m) {
    const int k = sb[m];              // the same for every thread: uniform
    if (k < 0 || k >= K) continue;
    const float* tk = tris + ((int64_t)b * K + k) * 9 * C;
    float part = 0.f;
    for (int c0 = 0; c0 < C; c0 += CT) {
      const int n = min(CT, C - c0);
      __syncthreads();  // the previous stage has been consumed
      for (int r = 0; r < 9; ++r) {
        for (int j = threadIdx.x; j < n; j += NT) {
          tile[r][j] = tk[(int64_t)r * C + c0 + j];
        }
      }
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < n; ++j) {
        part = add(part, tuch::solid_angle(qx, qy, qz, &tile[0][j], CT));
      }
    }
    acc = add(acc, part);
  }
  if (live) dst[((int64_t)b * splits + s) * Qp + q] = acc;
}

}  // namespace

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
  const int subs = (TQ + NT - 1) / NT;
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
