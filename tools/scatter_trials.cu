// Earlier designs of kernel 6 (row scatter-add), kept so that
// tools/slice_variants.py can time them beside kernel 6 (csrc/gather.cu)
// and its atomic form (tools/scatter_atomic.cu) on the same inputs. Not
// part of the package: nothing else builds this file.
//
//   (default)      the first port's kernel: a cudaMemsetAsync of out, then
//                  one thread per float and one global atomicAdd each.
//   TRIAL_SLICES   block (s, b) owns S rows of batch item b in shared
//                  memory: it zeroes them, streams all Q indices of item b,
//                  adds each contribution in its slice with a shared-memory
//                  atomicAdd and writes the slice out once. On sm_90 a float
//                  atomicAdd on shared memory compiles to a compare-and-swap
//                  loop (ATOMS.CAST.SPIN).
//   TRIAL_SLICES + TRIAL_NO_ATOMICS
//                  the same with a plain += (wrong: races); only its time is
//                  read, as the cost of the slices' streaming alone.
//   TRIAL_ROW_VEC=4 or 1
//                  tools/scatter_atomic.cu's clusters (zero, cluster
//                  barrier, add) with a thread per contribution (row), not per
//                  float: float4 reductions where the row lies in one
//                  16-byte word, the fourth lane adding +0 to a neighbouring
//                  row of the same item, else a float2 and a float (1.5 per
//                  row); or three float reductions (TRIAL_ROW_VEC=1).
//
// Entry: trial_scatter(contrib, idx, out, B, V, Q, S, stream) -> cudaError_t;
// S is the slice's rows (TRIAL_SLICES) and is ignored otherwise; the row
// trials take tools/scatter_atomic.cu's plan
// (clusters of min(8, 132 / B)).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifdef TRIAL_SLICES
constexpr int THREADS = 512;
constexpr int UNROLL = 4;
constexpr int MAX_ROWS = 2048;

__global__ void __launch_bounds__(THREADS)
    slices_kernel(const float* __restrict__ contrib,
                  const int* __restrict__ idx, float* __restrict__ out, int V,
                  int Q, int S) {
  __shared__ float acc[3 * MAX_ROWS];
  const int b = blockIdx.y;
  const int lo = blockIdx.x * S;
  const int n = min(S, V - lo);
  const int t = threadIdx.x;
  for (int k = t; k < 3 * n; k += THREADS) acc[k] = 0.f;
  __syncthreads();
  const int* ib = idx + b * Q;
  const float* cb = contrib + 3 * b * Q;
  for (int q0 = t; q0 < Q; q0 += UNROLL * THREADS) {
    int i[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int q = q0 + u * THREADS;
      i[u] = q < Q ? __ldg(ib + q) : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned r = (unsigned)i[u] - (unsigned)lo;  // in the slice
      if (r < (unsigned)n) {
        const float* c = cb + 3 * (q0 + u * THREADS);
#ifdef TRIAL_NO_ATOMICS
        acc[3 * r] += __ldg(c);
        acc[3 * r + 1] += __ldg(c + 1);
        acc[3 * r + 2] += __ldg(c + 2);
#else
        atomicAdd(acc + 3 * r, __ldg(c));
        atomicAdd(acc + 3 * r + 1, __ldg(c + 1));
        atomicAdd(acc + 3 * r + 2, __ldg(c + 2));
#endif
      }
    }
  }
  __syncthreads();
  float* dst = out + 3 * (b * V + lo);
  for (int k = t; k < 3 * n; k += THREADS) dst[k] = acc[k];
}
#elif defined(TRIAL_ROW_VEC)
constexpr int THREADS = 1024;
constexpr int UNROLL = 4;

__device__ __forceinline__ void add_row(float* out, int g, bool first,
                                        bool last, float x, float y,
                                        float z) {
  if (TRIAL_ROW_VEC == 1) {
    atomicAdd(out + g, x);
    atomicAdd(out + g + 1, y);
    atomicAdd(out + g + 2, z);
    return;
  }
  if ((g & 3) == 0 && !last) {
    atomicAdd(reinterpret_cast<float4*>(out + g), make_float4(x, y, z, 0.f));
  } else if ((g & 3) == 1 && !first) {
    atomicAdd(reinterpret_cast<float4*>(out + g - 1),
              make_float4(0.f, x, y, z));
  } else if (g & 1) {
    atomicAdd(out + g, x);
    atomicAdd(reinterpret_cast<float2*>(out + g + 1), make_float2(y, z));
  } else {
    atomicAdd(reinterpret_cast<float2*>(out + g), make_float2(x, y));
    atomicAdd(out + g + 2, z);
  }
}

__global__ void __launch_bounds__(THREADS)
    rows_kernel(const float* __restrict__ contrib, const int* __restrict__ idx,
                float* __restrict__ out, int V, int Q, int S, int P) {
  const int b = blockIdx.y, c = blockIdx.x, t = threadIdx.x;
  const int r_lo = c * S;
  for (int k = 3 * r_lo + t; k < 3 * min(V, r_lo + S); k += THREADS)
    out[3 * b * V + k] = 0.f;
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  const int q_lo = c * P, q_hi = min(Q, q_lo + P);
  const int* ib = idx + b * Q;
  const float* cb = contrib + 3 * b * Q;
  for (int p0 = q_lo;; p0 += UNROLL * THREADS) {
    int i[UNROLL];
    float x[UNROLL], y[UNROLL], z[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int q = p0 + u * THREADS + t;
      i[u] = -1;
      x[u] = y[u] = z[u] = 0.f;
      if (q < q_hi) {
        i[u] = __ldg(ib + q);
        x[u] = __ldg(cb + 3 * q);
        y[u] = __ldg(cb + 3 * q + 1);
        z[u] = __ldg(cb + 3 * q + 2);
      }
    }
    if (p0 == q_lo) asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if ((unsigned)i[u] < (unsigned)V)
        add_row(out, 3 * (b * V + i[u]), i[u] == 0, i[u] == V - 1, x[u],
                y[u], z[u]);
    if (p0 + UNROLL * THREADS >= q_hi) break;
  }
}
#else
__global__ void __launch_bounds__(256)
    first_kernel(const float* __restrict__ contrib, const int* __restrict__ idx,
               float* __restrict__ out, int V, int Q, int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (t >= total) return;
  const int64_t bq = t / 3;
  const int c = (int)(t - bq * 3);
  const int64_t b = bq / Q;
  const int i = idx[bq];
  if (i >= 0 && i < V) atomicAdd(out + (b * V + i) * 3 + c, contrib[t]);
}
#endif

}  // namespace

extern "C" int trial_scatter(const void* contrib, const void* idx, void* out,
                             int B, int V, int Q, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cp = static_cast<const float*>(contrib);
  const int* ip = static_cast<const int*>(idx);
  float* op = static_cast<float*>(out);
#ifdef TRIAL_SLICES
  if (S <= 0 || S > MAX_ROWS) return (int)cudaErrorInvalidValue;
  slices_kernel<<<dim3((V + S - 1) / S, B), THREADS, 0, st>>>(cp, ip, op, V,
                                                               Q, S);
#elif defined(TRIAL_ROW_VEC)
  const int C = B >= 132 ? 1 : (132 / B < 8 ? 132 / B : 8);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = C;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, rows_kernel, cp, ip, op, V,
                                             Q, (V + C - 1) / C,
                                             (Q + C - 1) / C);
  if (err != cudaSuccess) return (int)err;
#else
  const int64_t total = (int64_t)B * Q * 3;
  cudaMemsetAsync(out, 0, sizeof(float) * 3 * (size_t)B * V, st);
  first_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(cp, ip, op, V,
                                                              Q, total);
#endif
  return (int)cudaGetLastError();
}
