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
// operations counted from the source below (9 subtractions, 3 x 5 for the
// squared lengths and 3 square roots, 9 for the cross product, 5 for the
// triple product, 3 x 5 for the dot products, 8 for the denominator, the
// atan2, the doubling and the accumulation; a square root and an atan2
// count one each). The bytes are 4 B (3 Q + 9 F + Q), so at the body's
// shapes (Q = 6890, F = 13776) it is bound by operations on the fp32 CUDA
// cores, by a wide margin.
//
// What the design does about it. The TPU kernel tiles (TQ, TF) pairs into
// VMEM and, lacking atan2, evaluates a minimax polynomial. Here:
//   * one thread per query keeps its point and an fp32 accumulator in
//     registers; tiles of TF triangles (9 floats each) stream through shared
//     memory, stored corner-coordinate-major so every thread of the block
//     reads the same word (a broadcast);
//   * atan2f and sqrtf are the IEEE-accurate library functions (no fast
//     math);
//   * at small B the Q / TQ query blocks cannot fill 132 SMs, so the
//     triangle axis is split over the second grid dimension; each split
//     writes its partial sum and a second kernel adds the partials in split
//     order. No atomics: the result is deterministic;
//   * every product and sum is rounded on its own (solid_angle.cuh): no FMA
//     contraction, so the arithmetic is the plain version's, and the faces
//     around a vertex add exactly 0 to its own winding number.

#include "solid_angle.cuh"

namespace {

using tuch::add;
using tuch::mul;

constexpr int TQ = 128;  // queries per block, one thread each
constexpr int TF = 128;  // triangles per shared-memory tile

// Grid (ceil(Q / TQ), splits, B). Split s covers triangles
// [s * chunk, min(F, (s + 1) * chunk)) and writes dst[(b * splits + s) * Q
// + q] = scale * (its sum of solid angles).
__global__ void __launch_bounds__(TQ)
    winding_kernel(const float* __restrict__ pts,
                   const float* __restrict__ tris, float* __restrict__ dst,
                   int Q, int F, int chunk, float scale) {
  __shared__ float tile[9][TF];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int splits = gridDim.y;
  const int q = blockIdx.x * TQ + threadIdx.x;
  const bool live = q < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* p = pts + ((int64_t)b * Q + q) * 3;
    qx = p[0];
    qy = p[1];
    qz = p[2];
  }
  const int f_lo = s * chunk;
  const int f_hi = min(F, f_lo + chunk);
  const float* tb = tris + (int64_t)b * F * 9;
  float acc = 0.f;
  for (int f0 = f_lo; f0 < f_hi; f0 += TF) {
    const int n = min(TF, f_hi - f0);
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < n * 9; i += TQ) {
      tile[i % 9][i / 9] = tb[(int64_t)f0 * 9 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      acc = add(acc, tuch::solid_angle(qx, qy, qz, &tile[0][j], TF));
    }
  }
  if (live) dst[((int64_t)b * splits + s) * Q + q] = mul(acc, scale);
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
  const dim3 grid((Q + TQ - 1) / TQ, splits, B);
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
