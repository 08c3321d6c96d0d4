// Fused multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel tuch_tpu/ops/attention_pallas.py:_mha_kernel
// (wrapper mha_pallas): per (batch item, head), softmax(q k^T / sqrt(hd)) v
// on the fused head-major qkv tensor of the ViT backbone, whose column
// ((i3 * H) + h) * hd + d holds component i3 (q, k, v) of head h.
//
//   qkv (B, N, 3C) row-major, float32 or bfloat16  ->  out (B, N, C)
//
// What bounds it on this card. Per launch it does 4 B H N^2 hd flops and must
// move (3C + C) N B itemsize bytes. At the ViT-S/16 serving shape (N = 196,
// C = 384, H = 6, hd = 64) that is 49 flops per fp32 byte moved, above the
// H100's 20 fp32 flops per byte (67 TFLOP/s outside the tensor cores over
// 3.35 TB/s), so the fp32 kernel is bound by operations; bf16 halves the
// bytes but the tensor cores' 989 TFLOP/s would make it bound by bytes.
//
// What the design does about it. The TPU kernel held one batch item's whole
// (N, N) logits tile in VMEM with N padded to 128; a Hopper SM has far less
// fast memory, so this kernel never forms the logits at all:
//   * grid (B * H, ceil(N / TQ)); one thread owns one query row, keeping
//     that q row and its fp32 output accumulator in registers;
//   * K and V tiles of TK rows of one (b, h) are read straight from the
//     head-major qkv tensor (no host transpose, no padding copy) into shared
//     memory as fp32, where every thread of the block reads the same key row
//     at once (a broadcast, four values per 128-bit load);
//   * the softmax is online in fp32 (running max and sum, rescaled once per
//     CH keys), so N is unbounded and nothing of size N^2 reaches device
//     memory; the ragged last key tile is masked to -inf;
//   * q rows are staged in, and output rows staged out, through shared
//     memory so that device-memory reads and writes stay coalesced.
// The arithmetic runs on the fp32 CUDA cores. Tensor-core tiles (mma.sync or
// wgmma) and TMA loads are the next step for speed, not part of this kernel.
//
// Against the plain version (mha_reference in ops/attention.py): fp32 agrees
// to rounding; for bf16 the plain version rounds the probabilities to bf16
// before the value product while this kernel keeps them in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;  // query rows per block, one thread each
constexpr int TK = 32;  // key/value rows per shared-memory tile
constexpr int CH = 16;  // keys per online-softmax rescale
static_assert(TK % CH == 0, "a tile holds whole chunks");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(TQ)
    mha_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N,
                   int H, float scale) {
  __shared__ __align__(16) float ks[TK][HD];
  __shared__ __align__(16) float vs[TK][HD];
  __shared__ float stage[TQ][HD + 1];  // odd row stride: no bank conflicts

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * TQ;
  const int C = H * HD;
  const int64_t row = 3 * (int64_t)C;
  const T* base = qkv + (int64_t)b * N * row + (int64_t)h * HD;
  const int t = threadIdx.x;

  for (int i = t; i < TQ * HD; i += TQ) {
    const int r = i / HD, d = i % HD, n = q0 + r;
    stage[r][d] = n < N ? to_float(base[n * row + d]) : 0.f;
  }
  __syncthreads();
  float q[HD], o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    q[d] = stage[t][d];
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += TK) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = t; i < TK * HD; i += TQ) {
      const int r = i / HD, d = i % HD, n = k0 + r;
      const bool ok = n < N;
      ks[r][d] = ok ? to_float(base[n * row + C + d]) : 0.f;
      vs[r][d] = ok ? to_float(base[n * row + 2 * C + d]) : 0.f;
    }
    __syncthreads();
    const int kn = min(TK, N - k0);
    for (int c0 = 0; c0 < kn; c0 += CH) {
      float s[CH];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(ks[c0 + j]);
        float acc = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 kv = kr[d4];
          acc = fmaf(q[4 * d4 + 0], kv.x, acc);
          acc = fmaf(q[4 * d4 + 1], kv.y, acc);
          acc = fmaf(q[4 * d4 + 2], kv.z, acc);
          acc = fmaf(q[4 * d4 + 3], kv.w, acc);
        }
        s[j] = (c0 + j < kn) ? acc * scale : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      // c0 < kn, so the chunk holds a real key and m_new is finite
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs[c0 + j]);
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 vv = vr[d4];
          o[4 * d4 + 0] = fmaf(p, vv.x, o[4 * d4 + 0]);
          o[4 * d4 + 1] = fmaf(p, vv.y, o[4 * d4 + 1]);
          o[4 * d4 + 2] = fmaf(p, vv.z, o[4 * d4 + 2]);
          o[4 * d4 + 3] = fmaf(p, vv.w, o[4 * d4 + 3]);
        }
      }
    }
  }

  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < HD; ++d) stage[t][d] = o[d] * inv;
  __syncthreads();
  T* dst = out + (int64_t)b * N * C + (int64_t)h * HD;
  for (int i = t; i < TQ * HD; i += TQ) {
    const int r = i / HD, d = i % HD, n = q0 + r;
    if (n < N) store(dst + (int64_t)n * C + d, stage[r][d]);
  }
}

template <typename T, int HD>
void launch(const void* qkv, void* out, int B, int N, int H, float scale,
            cudaStream_t stream) {
  const dim3 grid(B * H, (N + TQ - 1) / TQ);
  mha_fwd_kernel<T, HD><<<grid, TQ, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, H, scale);
}

}  // namespace

// qkv, out: device pointers; dtype 0 = float32, 1 = bfloat16; head_dim 32 or
// 64; stream: a cudaStream_t. Allocates nothing and does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tuch_mha_forward(const void* qkv, void* out, int B, int N,
                                int heads, int head_dim, int dtype,
                                float scale, void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) {
    launch<float, 64>(qkv, out, B, N, heads, scale, s);
  } else if (dtype == 0 && head_dim == 32) {
    launch<float, 32>(qkv, out, B, N, heads, scale, s);
  } else if (dtype == 1 && head_dim == 64) {
    launch<__nv_bfloat16, 64>(qkv, out, B, N, heads, scale, s);
  } else if (dtype == 1 && head_dim == 32) {
    launch<__nv_bfloat16, 32>(qkv, out, B, N, heads, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tuch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
