// Affine-form winding numbers with the 1 mm corner mask, for Hopper
// (sm_90a). Experimental, as in the JAX package: no production path calls
// it.
//
// Replaces the TPU kernel tuch_tpu/ops/contact_pallas.py:
// _winding_affine_kernel (wrapper winding_numbers_pallas_affine). Every
// per-pair quantity of the Van Oosterom-Strackee formula is affine in the
// query q, so with seven groups of triangle constants [-vec, const]
// (ops/contact_kernels.py: affine_constant_rows) each is one dot of [q, 1]
// with a group:
//   numer = det(A, B, C) - q . n,   dab = A.B - q . (A + B) + q.q, ...
//   la2   = A.A - 2 q . A + q.q,    ...
// then la = sqrt(max(la2, 0)), the denominator, 2 atan2(numer, denom), and
// 0 for a pair within 1 mm of a corner (min(la2, lb2, lc2) < 1e-6), where
// the affine form cancels to noise. The sum is times 1 / (4 pi).
//
//   points (B, 4, Q) f32 rows [qx qy qz q.q],
//   tc (B, F, 28) f32, triangle j's 7 groups of 4 in a row  ->  (B, Q)
//
// What bounds it on this card. 69 operations per (point, triangle) pair,
// counted from the source below: 7 dots of 4 (3 products and 3 sums each,
// 42), 6 additions of q.q, 3 max and 3 square roots, 8 for the
// denominator, the atan2 and the doubling, 2 min, the compare and the
// select of the mask, and the accumulation (a square root and an atan2
// count one each). The bytes are 4 B (4 Q + 28 F + Q): at the body's shapes
// it is bound by operations, by a wide margin. The card's 67 TFLOP/s count
// an FMA as two operations; every product and sum here is rounded on its
// own (below), so one instruction does one counted operation and the
// kernel cannot pass half of that bound even at full issue.
//
// What the design does about it. The TPU kernel moves the seven dots onto
// its matrix unit as (TQ, 4) x (4, TF) products. Here they stay on the fp32
// CUDA cores (tools/winding_route_variants.py times the tensor-core form),
// and the kernel has kernel 2's shape (csrc/winding.cu):
//   * each thread holds QPT queries [q, q.q] and their fp32 accumulators in
//     registers;
//   * tiles of TF triangles stream through shared memory as seven float4
//     per triangle, read by every thread of the block at once (a
//     broadcast), so seven vector loads serve QPT pairs. A tile is one
//     contiguous block of the (F, 28) rows, copied by 16-byte cp.async into
//     a ring of STAGES tiles: the next tile lands while this one computes;
//   * the last tile of triangles is masked, not padded, so no padding term
//     enters the sum; a query past Q computes and is dropped;
//   * at small B the triangle axis is split over the grid and a second pass
//     adds the splits in order: deterministic, no atomics;
//   * every product and sum is rounded on its own, in the plain version's
//     order (no FMA contraction): la2, lb2 and lc2 equal the plain
//     version's bit for bit, so the mask takes the same pairs on both;
//   * IEEE square roots without sqrtf's guard (tuch::sqrt_fast: sqrtf's
//     bits from 2^-20 up; a pair with la2, lb2 or lc2 below 1e-6 is
//     masked, whatever its square roots), and solid_angle.cuh's
//     polynomial atan2 (kernel 2's) in place of the TPU's polynomial
//     behind an approximate reciprocal.

#include "solid_angle.cuh"

namespace {

using tuch::add;
using tuch::mul;

constexpr int TQ = 128;       // threads per block
constexpr int QPT = 4;        // query points per thread
constexpr int BQ = TQ * QPT;  // queries per block
constexpr int TF = 128;       // triangles per shared-memory tile
constexpr int STAGES = 2;     // tiles in the shared-memory ring
constexpr int NG = 7;         // float4 groups of constants per triangle
constexpr float CORNER_EPS2 = 1e-6f;  // (1 mm)^2

// [q, 1] . one group of a triangle's constants: ((qx c.x + qy c.y) + qz
// c.z) + c.w
__device__ __forceinline__ float dot4(float qx, float qy, float qz,
                                      float4 c) {
  return add(add(add(mul(qx, c.x), mul(qy, c.y)), mul(qz, c.z)), c.w);
}

// Issue the copies of n triangles' constants (n * NG float4, contiguous)
// from src into a slot of the ring.
__device__ __forceinline__ void stage(float4* slot, const float4* src,
                                      int n) {
  for (int i = threadIdx.x; i < n * NG; i += TQ)
    tuch::copy_async16(slot + i, src + i);
}

// Grid (ceil(Q / BQ), splits, B). Split s covers triangles
// [s * chunk, min(F, (s + 1) * chunk)) and writes dst[(b * splits + s) * Q
// + q] = scale * (its sum of solid angles). Thread t of a block holds the
// queries t, t + TQ, ... of the block's BQ.
__global__ void __launch_bounds__(TQ)
    affine_kernel(const float* __restrict__ pts,
                  const float4* __restrict__ tc, float* __restrict__ dst,
                  int Q, int F, int chunk, float scale) {
  __shared__ float4 ring[STAGES][TF * NG];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int splits = gridDim.y;
  const int q0 = blockIdx.x * BQ + threadIdx.x;
  float qx[QPT], qy[QPT], qz[QPT], qq[QPT], acc[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int q = q0 + k * TQ;
    qx[k] = qy[k] = qz[k] = qq[k] = 0.f;
    if (q < Q) {
      const float* p = pts + (int64_t)b * 4 * Q + q;
      qx[k] = p[0];
      qy[k] = p[Q];
      qz[k] = p[2 * (int64_t)Q];
      qq[k] = p[3 * (int64_t)Q];
    }
    acc[k] = 0.f;
  }
  const int f_lo = s * chunk;
  const int nf = min(F, f_lo + chunk) - f_lo;  // >= 1: ceil(F / chunk) splits
  const int tiles = (nf + TF - 1) / TF;
  const float4* cb = tc + ((int64_t)b * F + f_lo) * NG;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < tiles)
      stage(ring[i], cb + (int64_t)i * TF * NG, min(TF, nf - i * TF));
    tuch::copy_commit();
  }
  for (int i = 0; i < tiles; ++i) {
    const int ahead = i + STAGES - 1;
    if (ahead < tiles)
      stage(ring[ahead % STAGES], cb + (int64_t)ahead * TF * NG,
            min(TF, nf - ahead * TF));
    tuch::copy_commit();
    tuch::copy_wait<STAGES - 1>();  // this thread's copies of tile i landed
    __syncthreads();                // ... and every other thread's
    const float4* tile = ring[i % STAGES];
    const int n = min(TF, nf - i * TF);
    for (int j = 0; j < n; ++j) {
      const float4* c = tile + j * NG;
      const float4 g0 = c[0], g1 = c[1], g2 = c[2], g3 = c[3], g4 = c[4],
                   g5 = c[5], g6 = c[6];
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        const float numer = dot4(qx[k], qy[k], qz[k], g0);
        const float dab = add(dot4(qx[k], qy[k], qz[k], g1), qq[k]);
        const float dbc = add(dot4(qx[k], qy[k], qz[k], g2), qq[k]);
        const float dac = add(dot4(qx[k], qy[k], qz[k], g3), qq[k]);
        const float la2 = add(dot4(qx[k], qy[k], qz[k], g4), qq[k]);
        const float lb2 = add(dot4(qx[k], qy[k], qz[k], g5), qq[k]);
        const float lc2 = add(dot4(qx[k], qy[k], qz[k], g6), qq[k]);
        const float la = tuch::sqrt_fast(fmaxf(la2, 0.f));
        const float lb = tuch::sqrt_fast(fmaxf(lb2, 0.f));
        const float lc = tuch::sqrt_fast(fmaxf(lc2, 0.f));
        const float denom =
            add(add(add(mul(mul(la, lb), lc), mul(dab, lc)), mul(dac, lb)),
                mul(dbc, la));
        const float ang = tuch::atan2_poly(numer, denom);
        const bool corner = fminf(fminf(la2, lb2), lc2) < CORNER_EPS2;
        acc[k] = add(acc[k], corner ? 0.f : ang);
      }
    }
    __syncthreads();  // tile i is consumed before its slot is refilled
  }
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int q = q0 + k * TQ;
    if (q < Q)
      dst[((int64_t)b * splits + s) * Q + q] = mul(mul(2.f, acc[k]), scale);
  }
}

}  // namespace

// The kernel's shape, for the wrapper's plan: threads per block, queries
// per thread, triangles per tile.
extern "C" int tuch_winding_affine_shape(int* out) {
  out[0] = TQ;
  out[1] = QPT;
  out[2] = TF;
  return 0;
}

// points, tc, out: device pointers in the layouts above, tc 16-byte
// aligned. chunk: triangles per split, a multiple of TF; splits = ceil(F /
// chunk). partial: device scratch of B * splits * Q floats when splits > 1
// (unused, may be null, when splits == 1). scale: 1 / (4 pi). stream: a
// cudaStream_t. Allocates nothing and does not synchronise. Returns the
// cudaError_t of the launch.
extern "C" int tuch_winding_affine(const void* points, const void* tc,
                                   void* out, void* partial, int B, int Q,
                                   int F, int chunk, float scale,
                                   void* stream) {
  if (B <= 0 || Q <= 0 || F <= 0 || chunk <= 0 || chunk % TF ||
      reinterpret_cast<uintptr_t>(tc) % 16)
    return (int)cudaErrorInvalidValue;
  const int splits = (F + chunk - 1) / chunk;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Q + BQ - 1) / BQ, splits, B);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  affine_kernel<<<grid, TQ, 0, st>>>(static_cast<const float*>(points),
                                     static_cast<const float4*>(tc), dst, Q,
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
