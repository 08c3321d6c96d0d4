// Fused multi-head self-attention forward for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces the TPU kernel tuch_tpu/ops/attention_pallas.py:_mha_kernel
// (wrapper mha_pallas): per (batch item, head), softmax(q k^T / sqrt(hd)) v
// on the fused head-major qkv tensor of the ViT backbone, whose column
// ((i3 * H) + h) * hd + d holds component i3 (q, k, v) of head h.
//
//   qkv (B, N, 3C) row-major, float32 or bfloat16  ->  out (B, N, C)
//   any N >= 1; head dim hd = C / H of 32, 64 or 80 (80: ViTPose-H,
//   1280 wide over 16 heads, HMR 2.0's backbone)
//
// What bounds it on this card. Per launch it does 4 B H N^2 hd flops and must
// move (3C + C) N B itemsize bytes. At the ViT-S/16 serving shape (N = 196,
// C = 384, H = 6, hd = 64) and B = 64 that is 3.78 GFLOP against 38.5 MB in
// bf16: 0.0038 ms at the tensor cores' 989 TFLOP/s but 0.0115 ms at
// 3.35 TB/s, so bf16 is bound by bytes. A design that reads qkv once and
// writes out once is bound by those bytes even at well under the tensor
// cores' peak, so the warp-level mma.sync is enough here and wgmma's
// 64-row warpgroup tiles would buy nothing. fp32 runs three TF32 products
// per product (below): 3 x 3.78 GFLOP at 495 TFLOP/s is 0.0229 ms, against
// 77.1 MB at 0.0230 ms: the two bounds meet.
//
// What the design does about it (FlashAttention-2 on mma.sync). The TPU
// kernel held one batch item's whole (N, N) logits tile in VMEM with N padded
// to 128; a Hopper SM has far less fast memory, so this kernel never forms
// the logits in memory at all:
//   * grid (B * H, ceil(N / 64)); a block of 4 warps owns 64 query rows of
//     one (b, h), each warp 16 of them. A warp whose rows all lie past N
//     helps with the copies and computes nothing.
//   * Q, K and V tiles come straight from the head-major qkv tensor (no host
//     transpose, no padding copy) into shared memory by cp.async 16-byte
//     copies; rows past N are zero-filled, never read. K and V are
//     double-buffered: the copy of key tile t + 1 runs under the products of
//     tile t. Shared-memory rows are padded (hd + 8 elements, and hd + 4
//     floats for fp32 V) so that ldmatrix and the fragment loads have no
//     bank conflicts.
//   * Each warp's Q fragments stay in registers for the whole key loop.
//     S = Q K^T and O += P V run on the tensor cores, accumulating in fp32;
//     the softmax is online in fp32 over key tiles (running max and sum per
//     row, the sum reduced over the four threads of a row only at the end).
//     The logits accumulator's register layout is reused as the A operand of
//     P V, so P never goes through shared memory.
//   * The ragged last key tile is masked (keys past N to -inf before the
//     max, their n-tiles' products skipped); query rows past N are never
//     stored. The output goes out through shared memory in 16-byte stores.
//
// bf16: mma.sync.m16n8k16 bf16 -> fp32, operands by ldmatrix (.trans for
// V). P is rounded to bf16 before the value product, as the JAX kernel
// (attention_pallas.py:97) and mha_reference do; here the unnormalised
// exp(s - m) is rounded and O is divided by the fp32 row sum at the end,
// where they round the normalised probabilities. Against the plain version
// the two agree to about one bf16 rounding of the output.
//
// fp32: 3xTF32 on mma.sync.m16n8k8. A single TF32 product keeps 10 bits of
// mantissa, too few for the fp32 bar (1e-5 against the plain version);
// each operand is split into a TF32 high part and the TF32 rounding of the
// remainder, a = a_hi + a_lo, and a_lo b_hi + a_hi b_lo + a_hi b_hi are
// summed in fp32 (the dropped a_lo b_lo is ~2^-22 relative). That keeps the
// work on the tensor cores, where a register-tiled CUDA-core kernel would be
// held to 67 TFLOP/s. No global TF32 flag is read or changed. The contraction
// index of each m16n8k8 is permuted (position t <-> element 2t, t + 4 <->
// 2t + 1), which the sum does not see: Q and K fragments load as float2,
// and the fp32 logits accumulator is the A operand of P V as it stands.
//
// hd 80 is the same template: 10 k-steps of m16n8k8 (fp32) or 5 of
// m16n8k16 (bf16) in S, 10 n-tiles of 8 dims in O (5 ldmatrix.x4.trans
// pairs in bf16). Its padded rows (88 elements, 84 floats for fp32 V) keep
// 16-byte alignment and conflict-free fragment loads as hd 64's (72, 68)
// do: fp32 Q and K row r starts at bank 24 r (mod 32), V rows 2t and
// 2t + 1 at 8 t and 8 t + 20. Shared memory per block: 66,560 B (fp32)
// and 56,320 B (bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block, 16 per warp
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int HD>
struct Tiles {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int BK = BF16 ? 64 : 32;        // keys per tile
  static constexpr int QS = HD + 8;                // row strides, elements
  static constexpr int KS = HD + 8;
  static constexpr int VS = BF16 ? HD + 8 : HD + 4;
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int CPR = HD / EPC;             // 16-byte chunks per row
  static constexpr size_t SMEM =
      sizeof(T) * (size_t)(BQ * QS + 2 * BK * KS + 2 * BK * VS);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false the destination is zero-filled
// and nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// rows [r0, r0 + ROWS) of one (b, h) slice into dst (row stride STRIDE)
template <typename T, int HD, int ROWS, int STRIDE>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0,
                                          int N, int64_t row) {
  using L = Tiles<T, HD>;
  for (int c = threadIdx.x; c < ROWS * L::CPR; c += THREADS) {
    const int r = c / L::CPR, k = c % L::CPR, n = r0 + r;
    const bool ok = n < N;
    cp_async16(dst + r * STRIDE + k * L::EPC,
               src + (int64_t)(ok ? n : 0) * row + k * L::EPC, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// D += A B, m16n8k16, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// D += A B in 3xTF32, small products first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// 2^x by the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, which the softmax's sums do not see)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    mha_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N,
                   int H, float scale_log2) {
  using L = Tiles<T, HD>;
  constexpr int BK = L::BK, QS = L::QS, KS = L::KS, VS = L::VS;
  constexpr int NT = BK / 8;   // n-tiles of 8 keys in a key tile
  constexpr int DT = HD / 8;   // n-tiles of 8 dims in the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sQ = reinterpret_cast<T*>(smem_raw);
  T* const sK = sQ + BQ * QS;       // [2][BK][KS]
  T* const sV = sK + 2 * BK * KS;   // [2][BK][VS]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const int C = H * HD;
  const int64_t row = 3 * (int64_t)C;
  const T* const base = qkv + (int64_t)b * N * row + (int64_t)h * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row group, thread in it
  const int wq = warp * 16;               // this warp's rows in the tile
  const bool active = q0 + wq < N;
  const int nkt = (N + BK - 1) / BK;

  load_rows<T, HD, BQ, QS>(sQ, base, q0, N, row);
  cp_async_commit();
  load_rows<T, HD, BK, KS>(sK, base + C, 0, N, row);
  load_rows<T, HD, BK, VS>(sV, base + 2 * C, 0, N, row);
  cp_async_commit();
  cp_async_wait<1>();   // Q has landed; key tile 0 may still be in flight
  __syncthreads();

  // Q fragments, kept for the whole key loop
  constexpr int QF = L::BF16 ? HD / 16 : HD / 8;
  uint32_t qa[QF][4], ql[QF][4];
  if (active) {
    if constexpr (L::BF16) {
#pragma unroll
      for (int kk = 0; kk < QF; ++kk)
        ldmatrix_x4(qa[kk], sQ + (wq + (lane & 15)) * QS + kk * 16 +
                                (lane >> 4) * 8);
    } else {
#pragma unroll
      for (int kk = 0; kk < QF; ++kk) {
        const float* q = reinterpret_cast<const float*>(sQ) +
                         (wq + g) * QS + kk * 8 + 2 * t;
        const float2 r0 = *reinterpret_cast<const float2*>(q);
        const float2 r8 = *reinterpret_cast<const float2*>(q + 8 * QS);
        split(r0.x, qa[kk][0], ql[kk][0]);   // (row g,     position t)
        split(r8.x, qa[kk][1], ql[kk][1]);   // (row g + 8, position t)
        split(r0.y, qa[kk][2], ql[kk][2]);   // (row g,     position t + 4)
        split(r8.y, qa[kk][3], ql[kk][3]);   // (row g + 8, position t + 4)
      }
    }
  }

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // rows g and g + 8: running max of the raw logits, and this thread's
  // part of the row sums
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      const int nb = (kt + 1) & 1;
      load_rows<T, HD, BK, KS>(sK + nb * BK * KS, base + C, (kt + 1) * BK,
                               N, row);
      load_rows<T, HD, BK, VS>(sV + nb * BK * VS, base + 2 * C,
                               (kt + 1) * BK, N, row);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const T* const k_s = sK + (kt & 1) * BK * KS;
      const T* const v_s = sV + (kt & 1) * BK * VS;
      const int k0 = kt * BK;

      // S = Q K^T for this warp's 16 rows and the tile's BK keys
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (L::BF16) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
            if (k0 + jp * 16 < N) {
              uint32_t kb[4];
              const int key = jp * 16 + (lane & 7) + (lane >> 4) * 8;
              ldmatrix_x4(kb, k_s + key * KS + kk * 16 +
                                  ((lane >> 3) & 1) * 8);
              mma_bf16(s[2 * jp], qa[kk], kb[0], kb[1]);
              mma_bf16(s[2 * jp + 1], qa[kk], kb[2], kb[3]);
            }
          }
        }
      } else {
        const float* const kf = reinterpret_cast<const float*>(k_s);
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (k0 + j * 8 < N) {
              const float2 kv = *reinterpret_cast<const float2*>(
                  kf + (j * 8 + g) * KS + kk * 8 + 2 * t);
              mma_3xtf32(s[j], qa[kk], ql[kk], kv.x, kv.y);
            }
          }
        }
      }
      if (k0 + BK > N) {   // the ragged last tile: keys past N to -inf
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + j * 8 + 2 * t + (e & 1) >= N) s[j][e] = -INFINITY;
      }

      // online softmax, rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);   // finite: the tile holds a key
        const float alpha = exp2_approx((m[r] - m_new) * scale_log2);
        m[r] = m_new;
        const float ms = m_new * scale_log2;
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          o[j][2 * r] *= alpha;
          o[j][2 * r + 1] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = exp2_approx(fmaf(s[j][e], scale_log2, -ms));
            s[j][e] = p;
            l[r] += p;
          }
        }
      }

      // O += P V
      if constexpr (L::BF16) {
#pragma unroll
        for (int kj = 0; kj < BK / 16; ++kj) {
          if (k0 + kj * 16 < N) {
            const uint32_t pa[4] = {
                pack_bf16(s[2 * kj][0], s[2 * kj][1]),
                pack_bf16(s[2 * kj][2], s[2 * kj][3]),
                pack_bf16(s[2 * kj + 1][0], s[2 * kj + 1][1]),
                pack_bf16(s[2 * kj + 1][2], s[2 * kj + 1][3])};
#pragma unroll
            for (int dp = 0; dp < DT / 2; ++dp) {
              uint32_t vb[4];
              ldmatrix_x4_trans(vb, v_s + (kj * 16 + (lane & 15)) * VS +
                                        dp * 16 + (lane >> 4) * 8);
              mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
              mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
            }
          }
        }
      } else {
        const float* const vf = reinterpret_cast<const float*>(v_s);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (k0 + j * 8 < N) {
            // position t <-> key 2t, t + 4 <-> key 2t + 1 of the n-tile
            uint32_t ph[4], pl[4];
            split(s[j][0], ph[0], pl[0]);
            split(s[j][2], ph[1], pl[1]);
            split(s[j][1], ph[2], pl[2]);
            split(s[j][3], ph[3], pl[3]);
            const float* const v0 = vf + (j * 8 + 2 * t) * VS + g;
#pragma unroll
            for (int dt = 0; dt < DT; ++dt)
              mma_3xtf32(o[dt], ph, pl, v0[dt * 8], v0[VS + dt * 8]);
          }
        }
      }
    }
    __syncthreads();   // the tile is consumed before its buffer is refilled
  }

  if (!active) return;
  // row sums over the four threads of each row; stage this warp's rows in
  // its own part of sQ, then 16-byte stores of the rows below N
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / l[r];
    T* const dst = sQ + (wq + g + 8 * r) * QS + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const float x0 = o[j][2 * r] * inv, x1 = o[j][2 * r + 1] * inv;
      if constexpr (L::BF16) {
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        *reinterpret_cast<float2*>(dst + j * 8) = make_float2(x0, x1);
      }
    }
  }
  __syncwarp();
  T* const obase = out + (int64_t)b * N * C + (int64_t)h * HD;
  for (int c = lane; c < 16 * L::CPR; c += 32) {
    const int r = c / L::CPR, k = c % L::CPR, n = q0 + wq + r;
    if (n < N)
      *reinterpret_cast<uint4*>(obase + (int64_t)n * C + k * L::EPC) =
          *reinterpret_cast<const uint4*>(sQ + (wq + r) * QS + k * L::EPC);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, void* out, int B, int N, int H,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = Tiles<T, HD>::SMEM;
  if (smem > 48 * 1024) {   // fp32 at hd 64: 53 KB, past the default cap
    const cudaError_t err = cudaFuncSetAttribute(
        mha_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * H, (N + BQ - 1) / BQ);
  mha_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, H,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// qkv, out: device pointers, 16-byte aligned; dtype 0 = float32,
// 1 = bfloat16; head_dim 32, 64 or 80; stream: a cudaStream_t. Allocates
// nothing and does not synchronise. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int tuch_mha_forward(const void* qkv, void* out, int B, int N,
                                int heads, int head_dim, int dtype,
                                float scale, void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || (int64_t)B * heads > 0x7fffffff ||
      (N + BQ - 1) / BQ > 65535 ||
      (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) &
          15)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && head_dim == 80) {
    err = launch<float, 80>(qkv, out, B, N, heads, scale, s);
  } else if (dtype == 0 && head_dim == 64) {
    err = launch<float, 64>(qkv, out, B, N, heads, scale, s);
  } else if (dtype == 0 && head_dim == 32) {
    err = launch<float, 32>(qkv, out, B, N, heads, scale, s);
  } else if (dtype == 1 && head_dim == 80) {
    err = launch<__nv_bfloat16, 80>(qkv, out, B, N, heads, scale, s);
  } else if (dtype == 1 && head_dim == 64) {
    err = launch<__nv_bfloat16, 64>(qkv, out, B, N, heads, scale, s);
  } else if (dtype == 1 && head_dim == 32) {
    err = launch<__nv_bfloat16, 32>(qkv, out, B, N, heads, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* tuch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
