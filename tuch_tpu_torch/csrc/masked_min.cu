// Geodesically masked nearest vertex, for Hopper (sm_90a).
//
// Replaces the TPU kernel tuch_tpu/ops/contact_pallas.py:_masked_min_kernel
// (wrapper masked_min_dist_pallas): for every vertex q of each body, the
// least squared distance to a vertex m that the (V, V) mask allows, and m.
//
//   verts (B, V, 3) f32, allowed_t (V, V) u8 read as allowed_t[m * V + q]
//   -> d2 (B, V) f32 (inf where every pair is banned), idx (B, V) int32
//      (0 there)
//
// What bounds it on this card. Counted from the source below, every
// (query, searched) pair costs the mask test, and an allowed pair 9 more
// operations (3 subtractions, 3 products, 2 sums, the 64-bit min). The
// bytes are the mask once, V^2, the vertices, 12 B V, and the outputs,
// 8 B V. At V = 6890 that is bound by operations for every B.
//
// What the design does about it. The TPU kernel packs a d2 cut to 10
// mantissa bits with a 13-bit index into one int32 key (V <= 8192) so that
// one min-reduction finds both. Here the key is 64 bits: the full fp32 bits
// of d2 (>= 0, so the bits keep the order) above the 32-bit index. The min
// of the keys is exact, has no V limit, and among exact ties gives the
// lowest index: the plain version's first minimum. Then:
//   * one thread per query keeps its point and its best key in registers;
//     tiles of TM searched vertices stream through shared memory;
//   * the mask is read transposed, allowed_t[searched, query], as the TPU
//     wrapper does: the 32 queries of a warp read 32 consecutive bytes of
//     one row, so the reads coalesce;
//   * at small B the V / TN query blocks cannot fill 132 SMs, so the
//     searched axis is split over the second grid dimension; each split
//     writes its best key and a second kernel takes the min over splits and
//     unpacks d2 and the index. The min is exact in any order, so the result
//     is deterministic, with no atomics;
//   * d2 is (dx*dx + dy*dy) + dz*dz with each operation rounded on its own
//     (no FMA contraction), the plain version's arithmetic.
// The mask is read once per batch item; reading it once for several items
// is the next step for speed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;  // queries per block, one thread each
constexpr int TM = 256;  // searched vertices per shared-memory tile
// d2 = +inf, index 0: what a query with no allowed partner reports
constexpr unsigned long long EMPTY_KEY = 0x7f800000ull << 32;

__global__ void __launch_bounds__(TN)
    masked_min_kernel(const float* __restrict__ verts,
                      const uint8_t* __restrict__ allowed_t,
                      unsigned long long* __restrict__ keys, int V,
                      int chunk) {
  __shared__ float sx[TM], sy[TM], sz[TM];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int splits = gridDim.y;
  const int q = blockIdx.x * TN + threadIdx.x;
  const bool live = q < V;
  const float* vb = verts + (int64_t)b * V * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = vb[(int64_t)q * 3 + 0];
    qy = vb[(int64_t)q * 3 + 1];
    qz = vb[(int64_t)q * 3 + 2];
  }
  unsigned long long best = EMPTY_KEY;
  const int m_lo = s * chunk;
  const int m_hi = min(V, m_lo + chunk);
  for (int m0 = m_lo; m0 < m_hi; m0 += TM) {
    const int n = min(TM, m_hi - m0);
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < n; i += TN) {
      const float* v = vb + (int64_t)(m0 + i) * 3;
      sx[i] = v[0];
      sy[i] = v[1];
      sz[i] = v[2];
    }
    __syncthreads();
    if (!live) continue;
    const uint8_t* col = allowed_t + (int64_t)m0 * V + q;
    for (int j = 0; j < n; ++j) {
      if (!col[(int64_t)j * V]) continue;
      const float dx = __fsub_rn(qx, sx[j]);
      const float dy = __fsub_rn(qy, sy[j]);
      const float dz = __fsub_rn(qz, sz[j]);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
          __fmul_rn(dz, dz));
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(d2) << 32) |
          (unsigned)(m0 + j);
      best = key < best ? key : best;
    }
  }
  if (live) keys[((int64_t)b * splits + s) * V + q] = best;
}

__global__ void masked_min_finish_kernel(
    const unsigned long long* __restrict__ keys, float* __restrict__ d2,
    int* __restrict__ idx, int V, int splits, int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t b = t / V;
  const int64_t q = t - b * V;
  const unsigned long long* k = keys + b * splits * (int64_t)V + q;
  unsigned long long best = EMPTY_KEY;
  for (int s = 0; s < splits; ++s) {
    const unsigned long long v = k[(int64_t)s * V];
    best = v < best ? v : best;
  }
  d2[t] = __uint_as_float((unsigned)(best >> 32));
  idx[t] = (int)(best & 0xffffffffull);
}

}  // namespace

// verts, allowed_t, d2, idx: device pointers; keys: device scratch of
// B * splits * V 64-bit words, splits = ceil(V / chunk); chunk: searched
// vertices per split, a multiple of 256. stream: a cudaStream_t. Allocates
// nothing and does not synchronise. Returns the cudaError_t of the launch.
extern "C" int tuch_masked_min(const void* verts, const void* allowed_t,
                               void* keys, void* d2, void* idx, int B, int V,
                               int chunk, void* stream) {
  if (B <= 0 || V <= 0 || chunk <= 0 || chunk % TM)
    return (int)cudaErrorInvalidValue;
  const int splits = (V + chunk - 1) / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((V + TN - 1) / TN, splits, B);
  masked_min_kernel<<<grid, TN, 0, s>>>(
      static_cast<const float*>(verts),
      static_cast<const uint8_t*>(allowed_t),
      static_cast<unsigned long long*>(keys), V, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)B * V;
  masked_min_finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const unsigned long long*>(keys), static_cast<float*>(d2),
      static_cast<int*>(idx), V, splits, total);
  return (int)cudaGetLastError();
}

extern "C" const char* tuch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
