// Affine-form winding numbers with the 1 mm corner mask, for Hopper
// (sm_90a). Experimental, as in the JAX package: no production path calls
// it.
//
// Replaces the TPU kernel tuch_tpu/ops/contact_pallas.py:
// _winding_affine_kernel (wrapper winding_numbers_pallas_affine). Every
// per-pair quantity of the Van Oosterom-Strackee formula is affine in the
// query q, so with seven groups of triangle constants [-vec, const]
// (ops/contact_kernels.py: affine_triangle_constants) each is one dot of
// [q, 1] with a group:
//   numer = det(A, B, C) - q . n,   dab = A.B - q . (A + B) + q.q, ...
//   la2   = A.A - 2 q . A + q.q,    ...
// then la = sqrt(max(la2, 0)), the denominator, 2 atan2(numer, denom), and
// 0 for a pair within 1 mm of a corner (min(la2, lb2, lc2) < 1e-6), where
// the affine form cancels to noise. The sum is times 1 / (4 pi).
//
//   points (B, 4, Q) f32 rows [qx qy qz q.q], tc (B, 28, F) f32  ->  (B, Q)
//
// What bounds it on this card. 69 operations per (point, triangle) pair,
// counted from the source below: 7 dots of 4 (3 products and 3 sums each,
// 42), 6 additions of q.q, 3 max and 3 square roots, 8 for the
// denominator, the atan2 and the doubling, 2 min, the compare and the
// select of the mask, and the accumulation (a square root and an atan2
// count one each). The bytes are 4 B (4 Q + 28 F + Q): at the body's shapes
// it is bound by operations, by a wide margin.
//
// What the design does about it. The TPU kernel moves the seven dots onto
// its matrix unit as (TQ, 4) x (4, TF) products. Here they stay on the fp32
// CUDA cores, inside the kernel: tensor cores would mean TF32, whose 10-bit
// mantissa is far above the affine form's ~1e-7 noise floor and would move
// pairs across the 1e-6 mask threshold. So, as csrc/winding.cu:
//   * one thread per query keeps [q, q.q] and an fp32 accumulator in
//     registers; tiles of TF triangles (28 constants each) stream through
//     shared memory, constant-major as in HBM, so the copy is coalesced and
//     every thread reads the same word (a broadcast);
//   * the last tile of triangles and of queries is masked, not padded, so
//     no padding term enters the sum;
//   * at small B the triangle axis is split over the grid and a second pass
//     adds the splits in order: deterministic, no atomics;
//   * every product and sum is rounded on its own, in the plain version's
//     order (no FMA contraction): la2, lb2 and lc2 equal the plain
//     version's bit for bit, so the mask takes the same pairs on both;
//   * IEEE atan2f and sqrtf (no fast math) in place of the TPU's polynomial
//     atan2 and approximate reciprocal.

#include "solid_angle.cuh"

namespace {

using tuch::add;
using tuch::mul;

constexpr int TQ = 128;  // queries per block, one thread each
constexpr int TF = 128;  // triangles per shared-memory tile
constexpr int NC = 28;   // constants per triangle: 7 groups of 4
constexpr float CORNER_EPS2 = 1e-6f;  // (1 mm)^2

// [q, 1] . one group of a triangle's constants, c[0], c[TF], c[2 TF],
// c[3 TF] in the tile: ((qx c0 + qy c1) + qz c2) + c3
__device__ __forceinline__ float dot4(float qx, float qy, float qz,
                                      const float* c) {
  return add(add(add(mul(qx, c[0]), mul(qy, c[TF])), mul(qz, c[2 * TF])),
             c[3 * TF]);
}

// Grid (ceil(Q / TQ), splits, B). Split s covers triangles
// [s * chunk, min(F, (s + 1) * chunk)) and writes dst[(b * splits + s) * Q
// + q] = scale * (its sum of solid angles).
__global__ void __launch_bounds__(TQ)
    affine_kernel(const float* __restrict__ pts, const float* __restrict__ tc,
                  float* __restrict__ dst, int Q, int F, int chunk,
                  float scale) {
  __shared__ float tile[NC][TF];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int splits = gridDim.y;
  const int q = blockIdx.x * TQ + threadIdx.x;
  const bool live = q < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f, qq = 0.f;
  if (live) {
    const float* p = pts + (int64_t)b * 4 * Q + q;
    qx = p[0];
    qy = p[Q];
    qz = p[2 * (int64_t)Q];
    qq = p[3 * (int64_t)Q];
  }
  const int f_lo = s * chunk;
  const int f_hi = min(F, f_lo + chunk);
  const float* cb = tc + (int64_t)b * NC * F;
  float acc = 0.f;
  for (int f0 = f_lo; f0 < f_hi; f0 += TF) {
    const int n = min(TF, f_hi - f0);
    __syncthreads();  // the previous tile has been consumed
    for (int r = 0; r < NC; ++r) {
      for (int j = threadIdx.x; j < n; j += TQ) {
        tile[r][j] = cb[(int64_t)r * F + f0 + j];
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float* c = &tile[0][j];
      const float numer = dot4(qx, qy, qz, c);
      const float dab = add(dot4(qx, qy, qz, c + 4 * TF), qq);
      const float dbc = add(dot4(qx, qy, qz, c + 8 * TF), qq);
      const float dac = add(dot4(qx, qy, qz, c + 12 * TF), qq);
      const float la2 = add(dot4(qx, qy, qz, c + 16 * TF), qq);
      const float lb2 = add(dot4(qx, qy, qz, c + 20 * TF), qq);
      const float lc2 = add(dot4(qx, qy, qz, c + 24 * TF), qq);
      const float la = sqrtf(fmaxf(la2, 0.f));
      const float lb = sqrtf(fmaxf(lb2, 0.f));
      const float lc = sqrtf(fmaxf(lc2, 0.f));
      const float denom =
          add(add(add(mul(mul(la, lb), lc), mul(dab, lc)), mul(dac, lb)),
              mul(dbc, la));
      const float ang = mul(2.f, atan2f(numer, denom));
      const bool corner = fminf(fminf(la2, lb2), lc2) < CORNER_EPS2;
      acc = add(acc, corner ? 0.f : ang);
    }
  }
  if (live) dst[((int64_t)b * splits + s) * Q + q] = mul(acc, scale);
}

}  // namespace

// points, tc, out: device pointers in the layouts above. chunk: triangles
// per split, a multiple of 128; splits = ceil(F / chunk). partial: device
// scratch of B * splits * Q floats when splits > 1 (unused, may be null,
// when splits == 1). scale: 1 / (4 pi). stream: a cudaStream_t. Allocates
// nothing and does not synchronise. Returns the cudaError_t of the launch.
extern "C" int tuch_winding_affine(const void* points, const void* tc,
                                   void* out, void* partial, int B, int Q,
                                   int F, int chunk, float scale,
                                   void* stream) {
  if (B <= 0 || Q <= 0 || F <= 0 || chunk <= 0 || chunk % TF)
    return (int)cudaErrorInvalidValue;
  const int splits = (F + chunk - 1) / chunk;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Q + TQ - 1) / TQ, splits, B);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  affine_kernel<<<grid, TQ, 0, st>>>(static_cast<const float*>(points),
                                     static_cast<const float*>(tc), dst, Q,
                                     F, chunk, splits > 1 ? 1.f : scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return tuch::sum_partials(static_cast<const float*>(partial),
                            static_cast<float*>(out), B, Q, splits, scale,
                            st);
}

extern "C" const char* tuch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
