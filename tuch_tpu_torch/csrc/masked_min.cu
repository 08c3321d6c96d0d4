// Geodesically masked nearest vertex, for Hopper (sm_90a).
//
// Replaces the TPU kernel tuch_tpu/ops/contact_pallas.py:_masked_min_kernel
// (wrapper masked_min_dist_pallas): for every vertex q of each body, the
// least squared distance to a vertex m that the (V, V) mask allows, and m.
//
//   verts (B, V, 3) f32; bits (V, W) u32, W = ceil(V / 32), the mask packed
//   along the searched axis: bit (m % 32) of bits[q * W + m / 32] is
//   allowed[q, m], padding bits 0 (banned)
//   -> d2 (B, V) f32 (inf where every pair is banned), idx (B, V) int32
//      (0 there): the first minimum of d2 as computed below (the lowest m
//      on an exact tie).
//
// What bounds it on this card. Every (query, searched) pair costs a mask
// test, 3 subtractions, 3 products or fused multiply-adds and a min; nothing
// is reused across pairs but the mask bit (across bodies) and the searched
// point (across queries). So the kernel is bound by instruction issue, the
// fp32 pipe first. The bytes (the mask once, 12 B per vertex in, 8 B per
// vertex out) are far below that.
//
// What the design does about it. The first port's kernel spent ~4 memory
// and ~7 integer instructions per pair beside the arithmetic: a byte load
// of the mask, three scalar shared loads, a 64-bit key and a 64-bit min.
// Here, about 8 instructions a pair (tools/masked_min_variants.py times
// each choice against its alternatives):
//   * a block takes G bodies at once, so a mask word is loaded once for G
//     bodies, and each of its bits turned into a +0 or +inf start of d2
//     (pen) once for them;
//   * each thread owns R queries of each of its G bodies; the searched
//     points of the G bodies stream through shared memory as float4, one
//     16-byte broadcast load serving R pairs;
//   * the mask is bits, 32 searched vertices a word (5.9 MB at V = 6890
//     against 47.5 MB of bytes), read once per block;
//   * the inner loop keeps only the least d2 (one min instruction a pair)
//     and, once per step of JU searched vertices, the step in which it last
//     fell. That step holds the first minimum (a later equal d2 is not
//     below it), so at the end the kernel recomputes that step's JU
//     distances with the same instructions, the same bits, and takes the
//     lowest m that equals the min: the first minimum;
//   * d2 is pen + dx*dx, then two fused multiply-adds: 6 fp32 instructions
//     with the subtractions, against 8 for the plain version's
//     (dx*dx + dy*dy) + dz*dz, and within a few ulp of it (every term is
//     >= 0, nothing cancels; the card check holds it to rtol 1e-6);
//   * at small B the query blocks cannot fill 132 SMs, so the searched axis
//     is split over the grid; each split writes (d2, index) as one 64-bit
//     key (d2's bits, >= 0, above the index) and a second kernel takes the
//     min over splits: lexicographic, exact in any order, no atomics.
//
// The range entry (tuch_masked_min_range) searches only the vertices
// [m_begin, m_end) and leaves the merged key undecoded, so that ranks that
// split the searched axis among them (parallel/contact_parallel.py) merge
// their keys with one integer MIN: the least d2, then the lowest index, as
// the JAX package's two pmins. Its splits merge into the (B, V) keys with a
// 64-bit atomicMin, which is exact in any order, so it needs no scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;       // threads per block
constexpr int R = 2;         // queries per thread, per body
constexpr int G = 4;         // bodies per block
constexpr int TM = 256;      // searched vertices per shared tile (8 words)
constexpr int JU = 16;       // searched vertices per unrolled step
constexpr int QB = T * R;    // queries per block
// d2 = +inf, index 0: what a query with no allowed partner reports
constexpr unsigned long long EMPTY_KEY = 0x7f800000ull << 32;
#define INF __int_as_float(0x7f800000)

// pen is 0 (allowed: the first FMA is then dx*dx rounded) or +inf
// (banned: d2 is +inf, never below a best).
__device__ __forceinline__ float sq_dist(float dx, float dy, float dz,
                                         float pen) {
  return fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, pen)));
}

__device__ __forceinline__ uint32_t mask_word(const uint32_t* __restrict__ row,
                                              int w) {
  return row[w];
}

// The first m in [mb, mb + JU) below m_hi whose d2 to (x, y, z) is
// `best`, by the same arithmetic as the search, so the same bits; 0 if
// best is +inf.
__device__ __forceinline__ int first_at(const float* __restrict__ vb,
                                        const uint32_t* __restrict__ row,
                                        int mb, int m_hi, float x, float y,
                                        float z, float best) {
  if (!(best < INF)) return 0;
  const uint32_t word = mask_word(row, mb >> 5) >> (mb & 31);
  int a = mb;
#pragma unroll 1
  for (int j = JU - 1; j >= 0; --j) {  // downward: the lowest equal m wins
    const int m = mb + j;
    if (m >= m_hi) continue;
    const float* v = vb + (int64_t)m * 3;
    const float d2 = sq_dist(__fsub_rn(x, v[0]), __fsub_rn(y, v[1]),
                             __fsub_rn(z, v[2]),
                             (word >> j) & 1u ? 0.f : INF);
    if (d2 == best) a = m;
  }
  return a;
}

// MERGE false: split s writes its keys into keys[b][s][q]; MERGE true: it
// takes the atomic min with keys[b][q], which starts at EMPTY_KEY.
template <bool MERGE>
__global__ void __launch_bounds__(T)
    masked_min_kernel(const float* __restrict__ verts,
                      const uint32_t* __restrict__ bits,
                      unsigned long long* __restrict__ keys, int B, int V,
                      int W, int chunk, int m_begin, int m_end) {
  __shared__ float4 pts[G][TM];
  const int s = blockIdx.y;
  const int splits = gridDim.y;
  const int b0 = blockIdx.z * G;
  const int qa = blockIdx.x * QB + threadIdx.x;

  // per (body, query): the point, the least d2 so far, and the first m of
  // the step of JU searched vertices in which it last fell
  float qx[G][R], qy[G][R], qz[G][R], best[G][R];
  int step[G][R];
  const uint32_t* row[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    // a query past V reads row V - 1 and writes nothing
    const int q = min(qa + k * T, V - 1);
    row[k] = bits + (int64_t)q * W;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // a body past B repeats body B - 1 and writes nothing
      const float* v = verts + ((int64_t)min(b0 + g, B - 1) * V + q) * 3;
      qx[g][k] = v[0];
      qy[g][k] = v[1];
      qz[g][k] = v[2];
      best[g][k] = INF;
      step[g][k] = 0;
    }
  }

  const int m_lo = m_begin + s * chunk;
  const int m_hi = min(m_end, m_lo + chunk);
  for (int m0 = m_lo; m0 < m_hi; m0 += TM) {
    const int n = min(TM, m_hi - m0);
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < G * TM; i += T) {
      const int g = i / TM, j = i - g * TM;
      float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < n) {
        const float* v =
            verts + ((int64_t)min(b0 + g, B - 1) * V + m0 + j) * 3;
        p = make_float4(v[0], v[1], v[2], 0.f);
      }
      pts[g][j] = p;
    }
    __syncthreads();
    // m0 is a multiple of 32: whole words; m_hi is V (bits past V are 0,
    // banned) or a multiple of 32
    const int nw = (n + 31) >> 5;
    for (int w = 0; w < nw; ++w) {
      uint32_t mw[R];
#pragma unroll
      for (int k = 0; k < R; ++k) mw[k] = mask_word(row[k], (m0 >> 5) + w);
      // a word in steps of JU searched vertices: JU-fold unrolled code
      // keeps the loop in the instruction cache
      for (int j0 = 0; j0 < 32; j0 += JU) {
        const int mb = m0 + (w << 5) + j0;
        float before[G][R];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int k = 0; k < R; ++k) before[g][k] = best[g][k];
#pragma unroll
        for (int j = 0; j < JU; ++j) {
          float4 p[G];
#pragma unroll
          for (int g = 0; g < G; ++g) p[g] = pts[g][mb - m0 + j];
#pragma unroll
          for (int k = 0; k < R; ++k) {
            const float pen = (mw[k] >> j) & 1u ? 0.f : INF;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float d2 = sq_dist(__fsub_rn(qx[g][k], p[g].x),
                                       __fsub_rn(qy[g][k], p[g].y),
                                       __fsub_rn(qz[g][k], p[g].z), pen);
              best[g][k] = fminf(best[g][k], d2);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int k = 0; k < R; ++k)
            if (best[g][k] < before[g][k]) step[g][k] = mb;
#pragma unroll
        for (int k = 0; k < R; ++k) mw[k] >>= JU;
      }
    }
  }

  // best fell for the last time in the step that holds its first m (a
  // later equal d2 is not below it): find that m there
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int q = qa + k * T;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (q < V && b0 + g < B) {
        const int a = first_at(verts + (int64_t)(b0 + g) * V * 3, row[k],
                               step[g][k], m_hi, qx[g][k], qy[g][k],
                               qz[g][k], best[g][k]);
        const unsigned long long key =
            ((unsigned long long)__float_as_uint(best[g][k]) << 32) |
            (unsigned)a;
        if (MERGE)
          atomicMin(keys + (int64_t)(b0 + g) * V + q, key);
        else
          keys[((int64_t)(b0 + g) * splits + s) * V + q] = key;
      }
    }
  }
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

__global__ void fill_keys_kernel(unsigned long long* __restrict__ keys,
                                 int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < total) keys[t] = EMPTY_KEY;
}

}  // namespace

// The kernel's shape, for the wrapper's plan: threads, queries per thread,
// bodies per block, searched vertices per tile.
extern "C" int tuch_masked_min_shape(int* out) {
  out[0] = T;
  out[1] = R;
  out[2] = G;
  out[3] = TM;
  return 0;
}

// verts, bits, d2, idx: device pointers; keys: device scratch of
// B * splits * V 64-bit words, splits = ceil(V / chunk); W = ceil(V / 32);
// chunk: searched vertices per split, a multiple of TM. stream: a
// cudaStream_t. Allocates nothing and does not synchronise. Returns the
// cudaError_t of the launches.
extern "C" int tuch_masked_min(const void* verts, const void* bits,
                               void* keys, void* d2, void* idx, int B, int V,
                               int W, int chunk, void* stream) {
  if (B <= 0 || V <= 0 || W != (V + 31) / 32 || chunk <= 0 || chunk % TM)
    return (int)cudaErrorInvalidValue;
  const int splits = (V + chunk - 1) / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((V + QB - 1) / QB, splits, (B + G - 1) / G);
  masked_min_kernel<false><<<grid, T, 0, s>>>(
      static_cast<const float*>(verts), static_cast<const uint32_t*>(bits),
      static_cast<unsigned long long*>(keys), B, V, W, chunk, 0, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)B * V;
  masked_min_finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const unsigned long long*>(keys), static_cast<float*>(d2),
      static_cast<int*>(idx), V, splits, total);
  return (int)cudaGetLastError();
}

// The searched range [m_begin, m_end) only, merged and not decoded:
// keys (B, V) 64-bit words, device memory the call fills, each d2's bits
// above its index, EMPTY_KEY (+inf, index 0) where the range allows
// nothing. m_begin a multiple of 32 (whole mask words) unless the range is
// empty, m_end a multiple of 32 or V; chunk: searched vertices per split, a multiple of TM.
// stream: a cudaStream_t. Allocates nothing and does not synchronise.
// Returns the cudaError_t of the launches.
extern "C" int tuch_masked_min_range(const void* verts, const void* bits,
                                     void* keys, int B, int V, int W,
                                     int chunk, int m_begin, int m_end,
                                     void* stream) {
  if (B <= 0 || V <= 0 || W != (V + 31) / 32 || chunk <= 0 || chunk % TM ||
      m_begin < 0 || m_begin > m_end || m_end > V ||
      (m_begin % 32 && m_begin != m_end) || (m_end % 32 && m_end != V))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* k = static_cast<unsigned long long*>(keys);
  const int64_t total = (int64_t)B * V;
  fill_keys_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(k, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || m_end == m_begin) return (int)err;
  const int splits = (m_end - m_begin + chunk - 1) / chunk;
  const dim3 grid((V + QB - 1) / QB, splits, (B + G - 1) / G);
  masked_min_kernel<true><<<grid, T, 0, s>>>(
      static_cast<const float*>(verts), static_cast<const uint32_t*>(bits),
      k, B, V, W, chunk, m_begin, m_end);
  return (int)cudaGetLastError();
}

extern "C" const char* tuch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
