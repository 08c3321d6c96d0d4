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
//   * every product and sum is rounded on its own (__fmul_rn, __fadd_rn):
//     no FMA contraction, so the arithmetic is the plain version's. A
//     query on a triangle corner then gives a = 0 and a denominator that
//     starts from +0 and adds only zeros, and atan2(+-0, +0) = +-0: the
//     faces around a vertex add exactly 0 to its own winding number.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 128;  // queries per block, one thread each
constexpr int TF = 128;  // triangles per shared-memory tile

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return add(add(mul(x, x), mul(y, y)), mul(z, z));
}
__device__ __forceinline__ float dot(float ax, float ay, float az, float bx,
                                     float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

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
      const float ax = sub(tile[0][j], qx), ay = sub(tile[1][j], qy),
                  az = sub(tile[2][j], qz);
      const float bx = sub(tile[3][j], qx), by = sub(tile[4][j], qy),
                  bz = sub(tile[5][j], qz);
      const float cx = sub(tile[6][j], qx), cy = sub(tile[7][j], qy),
                  cz = sub(tile[8][j], qz);
      const float la = sqrtf(sq_norm(ax, ay, az));
      const float lb = sqrtf(sq_norm(bx, by, bz));
      const float lc = sqrtf(sq_norm(cx, cy, cz));
      const float numer =
          add(add(mul(ax, sub(mul(by, cz), mul(bz, cy))),
                  mul(ay, sub(mul(bz, cx), mul(bx, cz)))),
              mul(az, sub(mul(bx, cy), mul(by, cx))));
      const float dab = dot(ax, ay, az, bx, by, bz);
      const float dbc = dot(bx, by, bz, cx, cy, cz);
      const float dac = dot(ax, ay, az, cx, cy, cz);
      const float denom =
          add(add(add(mul(mul(la, lb), lc), mul(dab, lc)), mul(dac, lb)),
              mul(dbc, la));
      acc = add(acc, mul(2.f, atan2f(numer, denom)));
    }
  }
  if (live) dst[((int64_t)b * splits + s) * Q + q] = mul(acc, scale);
}

// out[b, q] = scale * sum over s, in order, of partial[b, s, q].
__global__ void winding_sum_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int Q,
                                   int splits, int64_t total, float scale) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t b = t / Q;
  const int64_t q = t - b * Q;
  const float* p = partial + b * splits * (int64_t)Q + q;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc = add(acc, p[(int64_t)s * Q]);
  out[t] = mul(acc, scale);
}

}  // namespace

// points, tris, out: device pointers. chunk: triangles per split, a
// multiple of 128; splits = ceil(F / chunk). partial: device scratch of
// B * splits * Q floats when splits > 1 (unused, may be null, when
// splits == 1). scale: 1 / (4 pi). stream: a cudaStream_t. Allocates
// nothing and does not synchronise. Returns the cudaError_t of the launch.
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
  const int64_t total = (int64_t)B * Q;
  winding_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), Q,
      splits, total, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* tuch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
