// Batched row gather and row scatter-add by index, for Hopper (sm_90a).
//
// Replaces the TPU kernels tuch_tpu/ops/gather_pallas.py:_gather_kernel
// (kernel 5) and :_scatter_kernel (kernel 6): the forward and the backward
// of gather_rows, the re-gather of each vertex's nearest allowed vertex in
// the SMPLify-DC contact loss.
//
//   gather:  values (B, V, 3) f32, idx (B, Q) int32 -> out (B, Q, 3);
//            an index outside [0, V) gives a zero row.
//   scatter: contrib (B, Q, 3) f32, idx (B, Q) int32 -> out (B, V, 3), the
//            sum of the contributions per index; an index outside [0, V) is
//            dropped.
//
// What bounds them on this card. Neither does arithmetic worth counting
// (the scatter adds 3 B Q floats). Counting each input read once and each
// output written once, they move 4 B (3 V + Q + 3 Q) bytes (gather) and
// 4 B (3 Q + Q + 3 V) bytes (scatter), and are bound by those bytes.
//
// What the design does about it. The TPU kernels build (TM, TQ) one-hot
// tiles and select rows on the MXU in three exact bf16 planes, because XLA
// serialises scatters on the TPU. Hopper has fast global atomics, so both
// directions are direct: one thread per (b, q, c) element, consecutive
// threads on consecutive addresses of idx, values and out. The scatter
// zeroes its output with cudaMemsetAsync and adds with atomicAdd: the order
// of the additions into one row varies from run to run, so the scatter is
// not bitwise deterministic (it equals index_add_ to fp32 rounding of the
// summation order). The gather is a copy and bitwise equal to torch.gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    gather_rows_kernel(const float* __restrict__ values,
                       const int* __restrict__ idx, float* __restrict__ out,
                       int V, int Q, int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int64_t bq = t / 3;
  const int c = (int)(t - bq * 3);
  const int64_t b = bq / Q;
  const int i = idx[bq];
  out[t] = (i >= 0 && i < V) ? values[(b * V + i) * 3 + c] : 0.f;
}

__global__ void __launch_bounds__(THREADS)
    scatter_add_rows_kernel(const float* __restrict__ contrib,
                            const int* __restrict__ idx,
                            float* __restrict__ out, int V, int Q,
                            int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int64_t bq = t / 3;
  const int c = (int)(t - bq * 3);
  const int64_t b = bq / Q;
  const int i = idx[bq];
  if (i >= 0 && i < V) atomicAdd(out + (b * V + i) * 3 + c, contrib[t]);
}

inline unsigned blocks_for(int64_t total) {
  return (unsigned)((total + THREADS - 1) / THREADS);
}

}  // namespace

// values, idx, out: device pointers; stream: a cudaStream_t. Allocates
// nothing and does not synchronise. Returns the cudaError_t of the launch.
extern "C" int tuch_gather_rows(const void* values, const void* idx,
                                void* out, int B, int V, int Q,
                                void* stream) {
  if (B <= 0 || V <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * Q * 3;
  gather_rows_kernel<<<blocks_for(total), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(idx),
      static_cast<float*>(out), V, Q, total);
  return (int)cudaGetLastError();
}

// out (B, V, 3) is zeroed here on the stream before the additions.
extern "C" int tuch_scatter_add_rows(const void* contrib, const void* idx,
                                     void* out, int B, int V, int Q,
                                     void* stream) {
  if (B <= 0 || V <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(float) * (size_t)B * V * 3, s);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)B * Q * 3;
  scatter_add_rows_kernel<<<blocks_for(total), THREADS, 0, s>>>(
      static_cast<const float*>(contrib), static_cast<const int*>(idx),
      static_cast<float*>(out), V, Q, total);
  return (int)cudaGetLastError();
}

extern "C" const char* tuch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
