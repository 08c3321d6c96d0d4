// Designs of kernels 3 (affine winding) and 7 (near field) that lost, kept
// for tools/winding_route_variants.py to time beside the kernels in
// tuch_tpu_torch/csrc/ (built with -I tuch_tpu_torch/csrc):
//
//   trial_winding_affine_old, trial_winding_near_old: the first port's
//     kernels, one query per thread, constants or corners staged
//     coordinate-major through shared memory by plain loads between two
//     barriers, IEEE atan2f. Kernel 3's reads tc (B, 28, F), the plain
//     version's layout; both have csrc/'s plain C interface.
//   trial_winding_affine_tc: kernel 3 with numer, dab, dbc and dac on the
//     tensor cores, as the TPU kernel moves its dots onto the matrix unit.
//     A warp takes MQ tiles of 16 queries; per step of 8 triangles each
//     group is one m16n8k8 product of the queries' rows [qx qy qz 1 q.q 0 0
//     0] against the group's [-vec, const, 1] columns (q.q folded in by
//     the fifth row), in 3xTF32 (each operand split into a TF32 high part
//     and the TF32 rounding of the rest, small products first, as
//     csrc/mha.cu's fp32 path). la2, lb2 and lc2 stay on the CUDA cores in
//     the plain version's order for the same fragment positions (rows g and
//     g + 8, columns 2t and 2t + 1), so the corner mask takes the same
//     pairs; the rest of the pair is csrc/winding_affine.cu's. Reads the
//     kernel's rows (B, F, 28); trial_winding_affine_tc_shape gives its
//     (queries per block, 1, triangles per tile).
//   trial_sqrt_mismatches: the floats in a range of bit patterns where
//     tuch::sqrt_fast and the IEEE sqrtf differ in any bit.

#include "solid_angle.cuh"

namespace {

using tuch::add;
using tuch::mul;
using tuch::sub;

constexpr float CORNER_EPS2 = 1e-6f;  // (1 mm)^2

// ---------------------------------------------------------------------------
// the first port's kernel 3
// ---------------------------------------------------------------------------
namespace old_affine {

constexpr int TQ = 128;  // queries per block, one thread each
constexpr int TF = 128;  // triangles per shared-memory tile
constexpr int NC = 28;   // constants per triangle: 7 groups of 4

__device__ __forceinline__ float dot4(float qx, float qy, float qz,
                                      const float* c) {
  return add(add(add(mul(qx, c[0]), mul(qy, c[TF])), mul(qz, c[2 * TF])),
             c[3 * TF]);
}

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
    __syncthreads();
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

}  // namespace old_affine

// ---------------------------------------------------------------------------
// the first port's kernel 7
// ---------------------------------------------------------------------------
namespace old_near {

constexpr int NT = 128;  // points per block, one thread each
constexpr int CT = 128;  // triangles per shared-memory stage

// 2 atan2(a . (b x c), denominator) in the plain version's order, IEEE
// atan2f; the corners are t[0], t[stride], ..., t[8 stride]
__device__ __forceinline__ float solid_angle(float qx, float qy, float qz,
                                             const float* t, int stride) {
  const float ax = sub(t[0 * stride], qx), ay = sub(t[1 * stride], qy),
              az = sub(t[2 * stride], qz);
  const float bx = sub(t[3 * stride], qx), by = sub(t[4 * stride], qy),
              bz = sub(t[5 * stride], qz);
  const float cx = sub(t[6 * stride], qx), cy = sub(t[7 * stride], qy),
              cz = sub(t[8 * stride], qz);
  const float la = sqrtf(tuch::sq_norm(ax, ay, az));
  const float lb = sqrtf(tuch::sq_norm(bx, by, bz));
  const float lc = sqrtf(tuch::sq_norm(cx, cy, cz));
  const float numer = add(add(mul(ax, sub(mul(by, cz), mul(bz, cy))),
                              mul(ay, sub(mul(bz, cx), mul(bx, cz)))),
                          mul(az, sub(mul(bx, cy), mul(by, cx))));
  const float dab = tuch::dot(ax, ay, az, bx, by, bz);
  const float dbc = tuch::dot(bx, by, bz, cx, cy, cz);
  const float dac = tuch::dot(ax, ay, az, cx, cy, cz);
  const float denom =
      add(add(add(mul(mul(la, lb), lc), mul(dab, lc)), mul(dac, lb)),
          mul(dbc, la));
  return mul(2.f, atan2f(numer, denom));
}

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
    const int k = sb[m];
    if (k < 0 || k >= K) continue;
    const float* tk = tris + ((int64_t)b * K + k) * 9 * C;
    float part = 0.f;
    for (int c0 = 0; c0 < C; c0 += CT) {
      const int n = min(CT, C - c0);
      __syncthreads();
      for (int r = 0; r < 9; ++r) {
        for (int j = threadIdx.x; j < n; j += NT) {
          tile[r][j] = tk[(int64_t)r * C + c0 + j];
        }
      }
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < n; ++j) {
        part = add(part, solid_angle(qx, qy, qz, &tile[0][j], CT));
      }
    }
    acc = add(acc, part);
  }
  if (live) dst[((int64_t)b * splits + s) * Qp + q] = acc;
}

}  // namespace old_near

// ---------------------------------------------------------------------------
// kernel 3 with four of its dots on the tensor cores (3xTF32)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int WARPS = 4;                 // warps per block
constexpr int MQ = 2;                    // 16-query tiles per warp
constexpr int BQ = WARPS * 16 * MQ;      // queries per block
constexpr int TF = 128;                  // triangles per shared-memory tile
constexpr int STAGES = 2;
constexpr int NG = 7;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
// D += A B, m16n8k8, tf32 operands, fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float dot4(const float (&q)[4], float4 c) {
  return add(add(add(mul(q[0], c.x), mul(q[1], c.y)), mul(q[2], c.z)), c.w);
}

__global__ void __launch_bounds__(WARPS * 32)
    affine_tc_kernel(const float* __restrict__ pts,
                     const float4* __restrict__ tcr, float* __restrict__ dst,
                     int Q, int F, int chunk, float scale) {
  __shared__ float4 ring[STAGES][TF * NG];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int splits = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qbase = blockIdx.x * BQ + warp * 16 * MQ + g;
  // q[m][h]: [qx qy qz q.q] of query qbase + 16 m + 8 h (fragment rows g
  // and g + 8 of tile m)
  float q[MQ][2][4], acc[MQ][2];
  uint32_t ah[MQ][4], al[MQ][4];
#pragma unroll
  for (int m = 0; m < MQ; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = qbase + 16 * m + 8 * h;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        q[m][h][c] = qi < Q ? pts[((int64_t)b * 4 + c) * Q + qi] : 0.f;
      acc[m][h] = 0.f;
    }
    // A rows [qx qy qz 1 q.q 0 0 0]: a0 (g, t), a1 (g + 8, t), a2 (g, t +
    // 4), a3 (g + 8, t + 4)
    const float a[4] = {t < 3 ? q[m][0][t] : 1.f, t < 3 ? q[m][1][t] : 1.f,
                        t == 0 ? q[m][0][3] : 0.f,
                        t == 0 ? q[m][1][3] : 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) split(a[r], ah[m][r], al[m][r]);
  }
  const int f_lo = s * chunk;
  const int nf = min(F, f_lo + chunk) - f_lo;
  const int tiles = (nf + TF - 1) / TF;
  const float4* cb = tcr + ((int64_t)b * F + f_lo) * NG;
  auto issue = [&](int i) {
    const int n = min(TF, nf - i * TF);
    const float4* src = cb + (int64_t)i * TF * NG;
    for (int e = threadIdx.x; e < n * NG; e += WARPS * 32)
      tuch::copy_async16(ring[i % STAGES] + e, src + e);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < tiles) issue(i);
    tuch::copy_commit();
  }
  for (int i = 0; i < tiles; ++i) {
    if (i + STAGES - 1 < tiles) issue(i + STAGES - 1);
    tuch::copy_commit();
    tuch::copy_wait<STAGES - 1>();
    __syncthreads();
    const float4* tile = ring[i % STAGES];
    const float* tf = reinterpret_cast<const float*>(tile);
    const int n = min(TF, nf - i * TF);
    for (int j0 = 0; j0 < n; j0 += 8) {
      // d[G][m]: group G (numer, dab, dbc, dac) of fragment tile m
      float d[4][MQ][4];
#pragma unroll
      for (int G = 0; G < 4; ++G) {
        // B (k, n): k < 4 the group's [-vec, const] of triangle j0 + n,
        // k = 4 the weight of q.q (1 but for numer); b0 (t, g), b1 (t + 4, g)
        uint32_t bh0, bl0;
        split(tf[(j0 + g) * 28 + 4 * G + t], bh0, bl0);
        const uint32_t bh1 = to_tf32(t == 0 && G > 0 ? 1.f : 0.f);
#pragma unroll
        for (int m = 0; m < MQ; ++m) {
#pragma unroll
          for (int r = 0; r < 4; ++r) d[G][m][r] = 0.f;
          mma_tf32(d[G][m], al[m], bh0, bh1);
          mma_tf32(d[G][m], ah[m], bl0, 0u);
          mma_tf32(d[G][m], ah[m], bh0, bh1);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 2 * t + e;     // fragment columns 2t, 2t + 1
        const float4 c4 = tile[j * NG + 4], c5 = tile[j * NG + 5],
                     c6 = tile[j * NG + 6];
        const bool live = j < n;
#pragma unroll
        for (int m = 0; m < MQ; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float la2 = add(dot4(q[m][h], c4), q[m][h][3]);
            const float lb2 = add(dot4(q[m][h], c5), q[m][h][3]);
            const float lc2 = add(dot4(q[m][h], c6), q[m][h][3]);
            const float numer = d[0][m][2 * h + e];
            const float dab = d[1][m][2 * h + e];
            const float dbc = d[2][m][2 * h + e];
            const float dac = d[3][m][2 * h + e];
            const float la = sqrtf(fmaxf(la2, 0.f));
            const float lb = sqrtf(fmaxf(lb2, 0.f));
            const float lc = sqrtf(fmaxf(lc2, 0.f));
            const float denom =
                add(add(add(mul(mul(la, lb), lc), mul(dab, lc)),
                        mul(dac, lb)),
                    mul(dbc, la));
            const float ang = tuch::atan2_poly(numer, denom);
            const bool skip =
                !live || fminf(fminf(la2, lb2), lc2) < CORNER_EPS2;
            acc[m][h] = add(acc[m][h], skip ? 0.f : ang);
          }
        }
      }
    }
    __syncthreads();
  }
  // the four lanes of a row hold the same queries' sums over other
  // triangles: add them (lanes 4g .. 4g + 3), then lane t = 0 writes
#pragma unroll
  for (int m = 0; m < MQ; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = acc[m][h];
      v = add(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = add(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const int qi = qbase + 16 * m + 8 * h;
      if (t == 0 && qi < Q)
        dst[((int64_t)b * splits + s) * Q + qi] = mul(mul(2.f, v), scale);
    }
  }
}

}  // namespace tc

// count[0] += the x with bits in [lo, hi] where sqrt_fast(x) and sqrtf(x)
// differ; count[1] = the least such bits (start it at ~0)
__global__ void sqrt_check_kernel(uint32_t lo, uint32_t hi,
                                  unsigned long long* count) {
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  unsigned long long n = 0, first = ~0ull;
  for (uint64_t u = lo + (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       u <= hi; u += stride) {
    const float x = __uint_as_float((uint32_t)u);
    if (__float_as_uint(tuch::sqrt_fast(x)) != __float_as_uint(sqrtf(x))) {
      ++n;
      first = min(first, (unsigned long long)u);
    }
  }
  if (n) {
    atomicAdd(count, n);
    atomicMin(count + 1, first);
  }
}

template <typename Launch>
int launch_split(void* out, void* partial, int B, int Q, int F, int chunk,
                 int tile, float scale, cudaStream_t st, Launch launch) {
  if (B <= 0 || Q <= 0 || F <= 0 || chunk <= 0 || chunk % tile)
    return (int)cudaErrorInvalidValue;
  const int splits = (F + chunk - 1) / chunk;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  launch(splits, static_cast<float*>(splits > 1 ? partial : out),
         splits > 1 ? 1.f : scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return tuch::sum_partials(static_cast<const float*>(partial),
                            static_cast<float*>(out), B, Q, splits, scale,
                            st);
}

}  // namespace

// csrc/winding_affine.cu's interface (as it was: tc (B, 28, F)).
extern "C" int trial_winding_affine_old(const void* points, const void* tc,
                                        void* out, void* partial, int B,
                                        int Q, int F, int chunk, float scale,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_split(
      out, partial, B, Q, F, chunk, old_affine::TF, scale, st,
      [&](int splits, float* dst, float sc) {
        const dim3 grid((Q + old_affine::TQ - 1) / old_affine::TQ, splits, B);
        old_affine::affine_kernel<<<grid, old_affine::TQ, 0, st>>>(
            static_cast<const float*>(points), static_cast<const float*>(tc),
            dst, Q, F, chunk, sc);
      });
}

// csrc/winding_affine.cu's interface: rows (B, F, 28).
extern "C" int trial_winding_affine_tc(const void* points, const void* rows,
                                       void* out, void* partial, int B,
                                       int Q, int F, int chunk, float scale,
                                       void* stream) {
  if (reinterpret_cast<uintptr_t>(rows) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_split(
      out, partial, B, Q, F, chunk, tc::TF, scale, st,
      [&](int splits, float* dst, float sc) {
        const dim3 grid((Q + tc::BQ - 1) / tc::BQ, splits, B);
        tc::affine_tc_kernel<<<grid, tc::WARPS * 32, 0, st>>>(
            static_cast<const float*>(points),
            static_cast<const float4*>(rows), dst, Q, F, chunk, sc);
      });
}

extern "C" int trial_winding_affine_tc_shape(int* out) {
  out[0] = tc::BQ;
  out[1] = 1;
  out[2] = tc::TF;
  return 0;
}

// csrc/winding_near.cu's interface.
extern "C" int trial_winding_near_old(const void* sel, const void* points,
                                      const void* tris, void* out,
                                      void* partial, int B, int T, int TQ,
                                      int M, int K, int C, int mchunk,
                                      void* stream) {
  if (B <= 0 || T <= 0 || TQ <= 0 || M <= 0 || K <= 0 || C <= 0 ||
      mchunk <= 0)
    return (int)cudaErrorInvalidValue;
  const int splits = (M + mchunk - 1) / mchunk;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int subs = (TQ + old_near::NT - 1) / old_near::NT;
  const dim3 grid(T * subs, splits, B);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  old_near::near_kernel<<<grid, old_near::NT, 0, st>>>(
      static_cast<const int*>(sel), static_cast<const float*>(points),
      static_cast<const float*>(tris), dst, T, TQ, M, K, C, mchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return tuch::sum_partials(static_cast<const float*>(partial),
                            static_cast<float*>(out), B, T * TQ, splits, 1.f,
                            st);
}

// count: device memory of two unsigned 64-bit words, {0, ~0} on entry.
extern "C" int trial_sqrt_mismatches(unsigned lo, unsigned hi, void* count,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sqrt_check_kernel<<<132 * 16, 256, 0, st>>>(
      lo, hi, static_cast<unsigned long long*>(count));
  return (int)cudaGetLastError();
}
