// Generalized winding numbers of points against explicit triangles, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel tuch_tpu/ops/contact_pallas.py:_winding_kernel
// (wrapper winding_numbers_pallas_tris): for every query point, the sum over
// triangles of the Van Oosterom-Strackee solid angle
//   2 atan2(a . (b x c), |a||b||c| + (a.b)|c| + (a.c)|b| + (b.c)|a|)
// with a, b, c the corners minus the point, times 1 / (4 pi).
//
//   points (B, Q, 3) f32, tris (B, F, 3, 3) f32  ->  out (B, Q) f32
//
// What bounds it on this card. Each (point, triangle) pair costs 67
// operations as counted for the plain version (9 subtractions, 3 x 5 for
// the squared lengths and 3 square roots, 9 for the cross product, 5 for
// the triple product, 3 x 5 for the dot products, 8 for the denominator,
// the atan2, the doubling and the accumulation; a square root and an atan2
// count one each). The bytes are 4 B (3 Q + 9 F + Q), so at the body's
// shapes (Q = 6890, F = 13776) it is bound by operations on the fp32 CUDA
// cores, by a wide margin. What the card spends is instructions issued per
// pair: the IEEE atan2f alone (a full division and its fix-ups) costs a
// quarter of the pair.
//
// What the design does about it. The TPU kernel tiles (TQ, TF) pairs into
// VMEM and evaluates a minimax polynomial for atan2 behind an approximate
// reciprocal. Here:
//   * atan2 is one approximate reciprocal (__fdividef) and a degree-8
//     polynomial in t^2 for atan on [0, 1] (tuch::atan2_poly in
//     solid_angle.cuh, shared with kernels 3 and 7), minimax in relative
//     error with its leading coefficient exactly 1 (at most 1.5e-7
//     relative in fp32, so the many small far-field angles carry no bias),
//     then the octant folding. The cases that decide a face's contribution
//     at a corner or a degenerate face are IEEE's exactly: atan2(+-0, +0) =
//     +-0 and atan2(+-0, x < 0 or -0) = +-pi, the sign from y's sign bit;
//   * the numerator a . (b x c) and the denominator keep the plain
//     version's bits: every product and sum rounded on its own in its order
//     (tuch::half_angle in solid_angle.cuh), IEEE square roots. Near the
//     surface the denominator's four terms cancel, so its rounding decides
//     the angle: with FMA in the squared lengths and dot products, or
//     sqrt.approx, the kernel was 1.9e-4 (1.1e-4) from the plain version on
//     a posed body at B = 64, ten times the 2e-5 bar
//     (tools/slice_variants.py). The same
//     rounding keeps the exact zeros: the three corners of a padding face
//     are equal, so b x c is exactly 0, and at a triangle corner the
//     denominator starts from +0 and adds only zeros, so the faces around a
//     vertex add exactly 0 to its own winding number. The doubling is taken
//     out of the sum (exact: a power of two);
//   * each thread holds QPT query points and their fp32 accumulators in
//     registers; tiles of TF triangles stream through shared memory as three
//     float4 per triangle, read by every thread of the block at once (a
//     broadcast), so three vector loads serve QPT pairs;
//   * at small B the Q / (TQ QPT) query blocks cannot fill 132 SMs, so the
//     triangle axis is split over the second grid dimension; each split
//     writes its partial sum and a second kernel adds the partials in split
//     order. No atomics: the result is deterministic.

#include "solid_angle.cuh"

namespace {

using tuch::add;
using tuch::mul;

constexpr int TQ = 128;       // threads per block
constexpr int QPT = 4;        // query points per thread
constexpr int BQ = TQ * QPT;  // queries per block: contact_kernels.WINDING_TQ
constexpr int TF = 128;       // triangles per shared-memory tile

// Grid (ceil(Q / BQ), splits, B). Split s covers triangles
// [s * chunk, min(F, (s + 1) * chunk)) and writes dst[(b * splits + s) * Q
// + q] = scale * (its sum of solid angles). Thread t of a block holds the
// queries t, t + TQ, ... of the block's BQ.
__global__ void __launch_bounds__(TQ)
    winding_kernel(const float* __restrict__ pts,
                   const float* __restrict__ tris, float* __restrict__ dst,
                   int Q, int F, int chunk, float scale) {
  __shared__ float4 tile[TF * 3];  // [ax ay az bx] [by bz cx cy] [cz - - -]
  float* tile_f = reinterpret_cast<float*>(tile);
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int splits = gridDim.y;
  const int q0 = blockIdx.x * BQ + threadIdx.x;
  float qx[QPT], qy[QPT], qz[QPT], acc[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int q = q0 + k * TQ;
    qx[k] = qy[k] = qz[k] = 0.f;  // a query past Q computes and is dropped
    if (q < Q) {
      const float* p = pts + ((int64_t)b * Q + q) * 3;
      qx[k] = p[0];
      qy[k] = p[1];
      qz[k] = p[2];
    }
    acc[k] = 0.f;
  }
  const int f_lo = s * chunk;
  const int f_hi = min(F, f_lo + chunk);
  const float* tb = tris + (int64_t)b * F * 9;
  for (int f0 = f_lo; f0 < f_hi; f0 += TF) {
    const int n = min(TF, f_hi - f0);
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < n * 9; i += TQ) {
      const int j = i / 9;
      tile_f[j * 12 + (i - j * 9)] = tb[(int64_t)f0 * 9 + i];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 t0 = tile[3 * j], t1 = tile[3 * j + 1],
                   t2 = tile[3 * j + 2];
#pragma unroll
      for (int k = 0; k < QPT; ++k)
        acc[k] = add(acc[k],
                     tuch::half_angle(qx[k], qy[k], qz[k], t0, t1, t2));
    }
  }
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int q = q0 + k * TQ;
    if (q < Q)
      dst[((int64_t)b * splits + s) * Q + q] = mul(mul(2.f, acc[k]), scale);
  }
}

}  // namespace

extern "C" int tuch_winding_numbers(const void* points, const void* tris,
                                    void* out, void* partial, int B, int Q,
                                    int F, int chunk, float scale,
                                    void* stream) {
  if (B <= 0 || Q <= 0 || F <= 0 || chunk <= 0 || chunk % TF)
    return (int)cudaErrorInvalidValue;
  const int splits = (F + chunk - 1) / chunk;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Q + BQ - 1) / BQ, splits, B);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  winding_kernel<<<grid, TQ, 0, s>>>(static_cast<const float*>(points),
                                     static_cast<const float*>(tris), dst, Q,
                                     F, chunk, splits > 1 ? 1.f : scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return tuch::sum_partials(static_cast<const float*>(partial),
                            static_cast<float*>(out), B, Q, splits, scale, s);
}

extern "C" const char* tuch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
