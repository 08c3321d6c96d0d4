// Adam's update of every tensor of a step in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package updates with optax.adam, which XLA
// fuses per leaf. It was added because the port's plain update
// (ops/adam.py adam_plain, PyTorch's torch._foreach_* operations)
// makes 15 device passes over the parameters, ~19 reads and 15 writes of
// every float, and on HMR 2.0's 670M floats that is the EFT step's largest
// device cost. Here each element of p, g, m and v is read once and p', m'
// and v' are written once.
//
//   p' = p + ((m' r1) / (sqrt(v' r2) + eps)) (-lr)
//   m' = (g (1 - b1)) + (m b1),   v' = ((g g) (1 - b2)) + (v b2)
//
// Every operation rounds on its own, as the plain version's passes round
// it: __fmul_rn, __fadd_rn, __fdiv_rn and __fsqrt_rn (their double forms in
// float64), never contracted into an FMA, and the numbers (1 - b1, b1,
// 1 - b2, b2, r1, r2, eps, -lr) given in the tensors' type as PyTorch's CUDA
// foreach operations cast Python numbers; r1 and r2 are the reciprocals of
// the bias corrections that the plain version multiplies by on the card
// (ops/adam.py adam_scalars). So the result is the plain version's bit for
// bit.
//
// What bounds it on this card: bytes, 28 a float32 element (56 a float64)
// at 3.35 TB/s. HMR 2.0's 670M floats: 18.8 GB, 5.6 ms. Nothing is reused,
// so every load and store streams past the caches (__ldcs, __stcs).
//
// What the design does about it. One launch takes up to LEAVES tensors,
// their pointers and lengths passed by value in the kernel's 4 KB of
// parameters: no copy to the card, no allocation, no synchronisation. A
// launch is a flat range of CHUNK-element chunks over its tensors (tensor
// j owns chunks [start[j], start[j + 1]), ops/adam.py chunk_plan); a block
// takes one chunk and finds its tensor by a binary search of start. Where
// all of a tensor's pointers are 16-byte aligned, a thread loads UNROLL
// 16-byte vectors of each input before it stores any, so 64 KB of a block
// are in flight; the end of a tensor that fills no vector, and tensors at
// unaligned offsets, go element by element. It updates p, m and v in
// place; a caller that wants new tensors copies into them first.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CHUNK = 16384;      // elements a block
constexpr int THREADS = 256;
constexpr int UNROLL = 4;         // vectors a thread has in flight per input
constexpr int PARAM_BYTES = 4096; // a kernel's parameter space

template <typename T>
struct Scalars {
  T b1c, b1, b2c, b2, r1, r2, eps, neglr;
};

// tensors a launch takes: four pointers (p, g, m, v), a length and a
// chunk start each, one more start, the count, and the Scalars beside
constexpr int LEAVES =
    (PARAM_BYTES - (int)sizeof(Scalars<double>) - 8) / (4 * 8 + 12);

struct Leaves {
  void* ptr[LEAVES][4];
  long long n[LEAVES];
  int start[LEAVES + 1];
  int count;
};

static_assert(sizeof(Leaves) + sizeof(Scalars<double>) <= PARAM_BYTES,
              "the table exceeds the parameter space");
// ops/adam.py plans with these numbers: MAX_LEAVES and CHUNK
static_assert(LEAVES == 91 && CHUNK == 16384, "ops/adam.py's plan");
static_assert(CHUNK % (THREADS * UNROLL * 4) == 0, "chunk of whole rounds");

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double dvd(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

template <typename T>
__device__ __forceinline__ void update(T& p, T g, T& m, T& v,
                                       const Scalars<T>& s) {
  m = add(mul(g, s.b1c), mul(m, s.b1));
  v = add(mul(mul(g, g), s.b2c), mul(v, s.b2));
  const T den = add(root(mul(v, s.r2)), s.eps);
  p = add(p, mul(dvd(mul(m, s.r1), den), s.neglr));
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int N = 4;
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int N = 2;
};

template <typename T>
__device__ __forceinline__ void update_vec(typename Vec<T>::type& p,
                                           typename Vec<T>::type g,
                                           typename Vec<T>::type& m,
                                           typename Vec<T>::type& v,
                                           const Scalars<T>& s) {
  T* pp = reinterpret_cast<T*>(&p);
  T* gg = reinterpret_cast<T*>(&g);
  T* mm = reinterpret_cast<T*>(&m);
  T* vv = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int e = 0; e < Vec<T>::N; ++e) update(pp[e], gg[e], mm[e], vv[e], s);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tuch_adam_kernel(const Leaves t, const Scalars<T> s) {
  const int c = blockIdx.x;
  int j = 0, hi = t.count - 1;          // the last tensor starting at <= c
  while (j < hi) {
    const int mid = (j + hi + 1) >> 1;
    if (t.start[mid] <= c) j = mid; else hi = mid - 1;
  }
  const long long begin = (long long)(c - t.start[j]) * CHUNK;
  const long long rest = t.n[j] - begin;
  const int len = rest < CHUNK ? (int)rest : CHUNK;
  T* p = static_cast<T*>(t.ptr[j][0]) + begin;
  const T* g = static_cast<const T*>(t.ptr[j][1]) + begin;
  T* m = static_cast<T*>(t.ptr[j][2]) + begin;
  T* v = static_cast<T*>(t.ptr[j][3]) + begin;
  const uintptr_t bits =
      (uintptr_t)p | (uintptr_t)g | (uintptr_t)m | (uintptr_t)v;
  int i = 0;                            // first element left to the scalar loop
  if ((bits & 15) == 0) {
    using V = typename Vec<T>::type;
    constexpr int W = Vec<T>::N;
    const int nv = len / W;
    V* p4 = reinterpret_cast<V*>(p);
    const V* g4 = reinterpret_cast<const V*>(g);
    V* m4 = reinterpret_cast<V*>(m);
    V* v4 = reinterpret_cast<V*>(v);
    for (int base = threadIdx.x; base < nv; base += THREADS * UNROLL) {
      V rp[UNROLL], rg[UNROLL], rm[UNROLL], rv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = base + u * THREADS;
        if (k < nv) {
          rp[u] = __ldcs(p4 + k);
          rg[u] = __ldcs(g4 + k);
          rm[u] = __ldcs(m4 + k);
          rv[u] = __ldcs(v4 + k);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = base + u * THREADS;
        if (k < nv) {
          update_vec<T>(rp[u], rg[u], rm[u], rv[u], s);
          __stcs(p4 + k, rp[u]);
          __stcs(m4 + k, rm[u]);
          __stcs(v4 + k, rv[u]);
        }
      }
    }
    i = nv * W;
  }
  for (int k = i + threadIdx.x; k < len; k += THREADS) {
    T pk = __ldcs(p + k), mk = __ldcs(m + k), vk = __ldcs(v + k);
    update(pk, __ldcs(g + k), mk, vk, s);
    __stcs(p + k, pk);
    __stcs(m + k, mk);
    __stcs(v + k, vk);
  }
}

// Every launch of one step: launch l takes the next counts[l] tensors, and
// tensor j the next four pointers of ptrs (p, g, m, v), n[j] elements in
// chunks[j] chunks.
template <typename T>
int launch_all(int launches, const int* counts, void* const* ptrs,
               const long long* n, const int* chunks, const double* sc,
               cudaStream_t stream) {
  const Scalars<T> s{(T)sc[0], (T)sc[1], (T)sc[2], (T)sc[3],
                     (T)sc[4], (T)sc[5], (T)sc[6], (T)sc[7]};
  Leaves t;
  int j = 0;
  for (int l = 0; l < launches; ++l) {
    if (counts[l] <= 0 || counts[l] > LEAVES)
      return (int)cudaErrorInvalidValue;
    long long total = 0;
    for (int a = 0; a < counts[l]; ++a, ++j) {
      if (n[j] <= 0 || chunks[j] <= 0 ||
          (long long)chunks[j] * CHUNK < n[j] ||
          (long long)(chunks[j] - 1) * CHUNK >= n[j])
        return (int)cudaErrorInvalidValue;
      for (int q = 0; q < 4; ++q) t.ptr[a][q] = ptrs[(long long)j * 4 + q];
      t.n[a] = n[j];
      t.start[a] = (int)total;
      total += chunks[j];
    }
    if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    t.start[counts[l]] = (int)total;
    t.count = counts[l];
    tuch_adam_kernel<T><<<(unsigned)total, THREADS, 0, stream>>>(t, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// itemsize 4 (float32) or 8 (float64); scalars: 1 - b1, b1, 1 - b2, b2,
// r1, r2, eps, -lr, each already rounded to the type.
extern "C" int tuch_adam(int itemsize, int launches, const int* counts,
                         void* const* ptrs, const long long* n,
                         const int* chunks, const double* scalars,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (itemsize == 4)
    return launch_all<float>(launches, counts, ptrs, n, chunks, scalars, st);
  if (itemsize == 8)
    return launch_all<double>(launches, counts, ptrs, n, chunks, scalars,
                              st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tuch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
