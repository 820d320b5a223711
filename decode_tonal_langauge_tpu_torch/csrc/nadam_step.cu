// One NAdam step for sm_90a over every tensor of an optimizer in one
// launch: the optax update of training/optim.py (NAdam.step), elementwise,
// with each element of p, g, mu and nu read once and p, mu and nu written
// once.
//
// Replaces no Pallas kernel: the JAX package leaves optax's NAdam to XLA
// (decode_tonal_langauge_tpu/training/optim.py). It was added because the
// plain chain runs about 23 ATen passes over each tensor a step. The step
// is bound by bytes: 28 B an element at float32 (16 read, 12 written),
// 11.4 GB for SynthesisFull x 4 seeds (407.2 M elements), 3.40 ms at
// 3.35 TB/s. The design is one read and one write of each element and
// nothing intermediate in device memory.
//
// Multi-tensor launch: the host hands a table of up to kMaxTensors tensors
// (pointers, element counts, flags) by value in the kernel's arguments, as
// PyTorch's multi_tensor_apply does; nothing is copied to the device and
// nothing is kept across steps. Each tensor is cut into chunks of kChunk
// elements; block b takes the b-th (tensor, chunk) pair, found by a binary
// search of the tensors' first chunks. Within a chunk each thread moves
// kIlp 16-byte vectors of p and g (and the matching moments: 16 bytes, or
// 8 bytes of bf16) at a time where all four pointers are aligned, then a
// scalar tail; a tensor whose storage is not aligned takes scalar access.
// p, mu and nu are contiguous. A gradient may have any strides (cuDNN
// hands a channels-last weight gradient where the convolution's input is
// channels-last): the host collapses its dims to at most kMaxDims and the
// kernel reads it element by element at the offset of each element's
// coordinates, up to kMaxStrided such gradients a launch.
//
// Arithmetic: the plain chain op for op, each op rounded to the working
// type T (the parameter's, float or double) with no FMA contraction:
//   g      = g + p * wd                  (decay flag of the tensor)
//   m      = g * (1 - b1) + mu * b1
//   v      = (g * g) * (1 - b2) + nu * b2
//   mu_hat = (m * inv_bc1n) * b1 + (g * inv_bc1) * (1 - b1)
//   p      = p + (mu_hat / (sqrt(v * inv_bc2) + eps)) * (-lr)
// A division of a tensor by a Python scalar is a multiplication by its
// reciprocal formed in T on the host, as ATen's CUDA division by a CPU
// scalar does; the bias corrections, reciprocals and constants arrive
// already rounded to T. bf16 moments widen to float32 and round back
// (round to nearest even) once each, as the chain's copy_ does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxTensors = 64;
constexpr int kMaxStrided = 12;
constexpr int kMaxDims = 5;
constexpr int kBlock = 512;
constexpr int kIlp = 4;
constexpr long long kChunk = 65536;  // elements a block

// A gradient's layout: its collapsed sizes and strides, outermost first.
struct Strides {
  long long stride[kMaxDims];
  int size[kMaxDims];
  int ndim;
};

struct Table {
  void* p[kMaxTensors];
  const void* g[kMaxTensors];
  void* mu[kMaxTensors];
  void* nu[kMaxTensors];
  long long n[kMaxTensors];
  int first_chunk[kMaxTensors + 1];
  unsigned char flags[kMaxTensors];  // 1: decay, 2: 16-byte access
  signed char strided[kMaxTensors];  // the gradient's entry in layout, or -1: contiguous
  Strides layout[kMaxStrided];
  int count;
};

template <typename T>
struct Scalars {
  T b1, omb1, b2, omb2, inv_bc1n, inv_bc1, inv_bc2, eps, neg_lr, wd;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename M, typename T>
__device__ __forceinline__ M narrow(T x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, typename M>
__device__ __forceinline__ void update(T& p, T g, M& mu, M& nu, bool decay,
                                       const Scalars<T>& s) {
  if (decay) g = add(g, mul(p, s.wd));
  const T m = add(mul(g, s.omb1), mul(widen(mu), s.b1));
  const T v = add(mul(mul(g, g), s.omb2), mul(widen(nu), s.b2));
  const T mu_hat = add(mul(mul(m, s.inv_bc1n), s.b1), mul(mul(g, s.inv_bc1), s.omb1));
  const T step = quot(mu_hat, add(root(mul(v, s.inv_bc2)), s.eps));
  p = add(p, mul(step, s.neg_lr));
  mu = narrow<M>(m);
  nu = narrow<M>(v);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// The table and the double scalars fit the 4 KB of kernel arguments.
static_assert(sizeof(Table) + sizeof(Scalars<double>) <= 4096, "kernel arguments over 4 KB");

template <typename T, typename M>
__global__ void __launch_bounds__(kBlock)
    nadam_kernel(const __grid_constant__ Table t, const Scalars<T> s) {
  constexpr int N = 16 / sizeof(T);
  const int chunk = blockIdx.x;
  int k = 0, hi = t.count - 1;  // the last tensor whose first chunk is <= chunk
  while (k < hi) {
    const int mid = (k + hi + 1) / 2;
    if (t.first_chunk[mid] <= chunk) k = mid; else hi = mid - 1;
  }
  const long long start = (long long)(chunk - t.first_chunk[k]) * kChunk;
  const long long len = min(kChunk, t.n[k] - start);
  T* p = static_cast<T*>(t.p[k]) + start;
  const T* g = static_cast<const T*>(t.g[k]) + start;
  M* mu = static_cast<M*>(t.mu[k]) + start;
  M* nu = static_cast<M*>(t.nu[k]) + start;
  const bool decay = t.flags[k] & 1;

  if (t.strided[k] >= 0) {  // g at its own strides, element by element
    const Strides& l = t.layout[t.strided[k]];
    const T* g0 = static_cast<const T*>(t.g[k]);
    for (long long i = threadIdx.x; i < len; i += kBlock) {
      long long rest = start + i, off = 0;
      for (int d = l.ndim - 1; d >= 0; --d) {
        off += rest % l.size[d] * l.stride[d];
        rest /= l.size[d];
      }
      T pi = p[i];
      M mi = mu[i], vi = nu[i];
      update(pi, g0[off], mi, vi, decay, s);
      p[i] = pi;
      mu[i] = mi;
      nu[i] = vi;
    }
    return;
  }
  long long done = 0;
  if (t.flags[k] & 2) {
    using VT = Vec<T, N>;
    using VM = Vec<M, N>;
    const long long nv = len / N;
    for (long long i0 = threadIdx.x; i0 < nv; i0 += (long long)kBlock * kIlp) {
      VT pv[kIlp], gv[kIlp];
      VM mv[kIlp], vv[kIlp];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const long long i = i0 + u * kBlock;
        if (i < nv) {
          pv[u] = reinterpret_cast<const VT*>(p)[i];
          gv[u] = reinterpret_cast<const VT*>(g)[i];
          mv[u] = reinterpret_cast<const VM*>(mu)[i];
          vv[u] = reinterpret_cast<const VM*>(nu)[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const long long i = i0 + u * kBlock;
        if (i < nv) {
#pragma unroll
          for (int j = 0; j < N; ++j) update(pv[u].v[j], gv[u].v[j], mv[u].v[j], vv[u].v[j], decay, s);
          reinterpret_cast<VT*>(p)[i] = pv[u];
          reinterpret_cast<VM*>(mu)[i] = mv[u];
          reinterpret_cast<VM*>(nu)[i] = vv[u];
        }
      }
    }
    done = nv * N;
  }
  for (long long i = done + threadIdx.x; i < len; i += kBlock) {
    T pi = p[i];
    M mi = mu[i], vi = nu[i];
    update(pi, g[i], mi, vi, decay, s);
    p[i] = pi;
    mu[i] = mi;
    nu[i] = vi;
  }
}

template <typename T, typename M>
int launch(const Table& t, int chunks, const double* c, cudaStream_t stream) {
  const Scalars<T> s{(T)c[0], (T)c[1], (T)c[2], (T)c[3], (T)c[4],
                     (T)c[5], (T)c[6], (T)c[7], (T)c[8], (T)c[9]};
  nadam_kernel<T, M><<<chunks, kBlock, 0, stream>>>(t, s);
  return (int)cudaGetLastError();
}

}  // namespace

constexpr int kRow = 7 + 2 * kMaxDims;  // table entries a tensor

// One launch over `count` tensors (1..kMaxTensors). `table` holds kRow
// entries a tensor: the addresses of p, g, mu and nu, the element count
// (> 0), the flags (1: decay, 2: every address aligned for 16-byte access
// of p and g and the moments' matching width), the gradient's collapsed
// ndim (0: contiguous; at most kMaxStrided tensors with 1..kMaxDims), then
// its sizes and its strides in elements, kMaxDims slots each, outermost
// first. `scalars`: b1, 1 - b1, b2, 1 - b2, 1 / bc1_next, 1 / bc1,
// 1 / bc2, eps, -lr, wd, each already rounded to the working type. pair 0:
// float32 p and moments; 1: float32 p, bf16 moments; 2: float64 p and
// moments. Returns the launch's cudaError_t.
extern "C" int nadam_step(int pair, int count, const long long* table, const double* scalars,
                          void* stream) {
  if (count < 1 || count > kMaxTensors) return (int)cudaErrorInvalidValue;
  Table t{};
  long long chunks = 0;
  int strided = 0;
  for (int i = 0; i < count; ++i) {
    const long long* e = table + kRow * i;
    const int ndim = (int)e[6];
    if (e[4] <= 0 || ndim < 0 || ndim > kMaxDims) return (int)cudaErrorInvalidValue;
    t.p[i] = reinterpret_cast<void*>(e[0]);
    t.g[i] = reinterpret_cast<const void*>(e[1]);
    t.mu[i] = reinterpret_cast<void*>(e[2]);
    t.nu[i] = reinterpret_cast<void*>(e[3]);
    t.n[i] = e[4];
    t.flags[i] = (unsigned char)e[5];
    t.strided[i] = -1;
    if (ndim > 0) {
      if (strided == kMaxStrided) return (int)cudaErrorInvalidValue;
      Strides& l = t.layout[strided];
      l.ndim = ndim;
      for (int d = 0; d < ndim; ++d) {
        if (e[7 + d] < 1 || e[7 + d] > INT_MAX) return (int)cudaErrorInvalidValue;
        l.size[d] = (int)e[7 + d];
        l.stride[d] = e[7 + kMaxDims + d];
      }
      t.strided[i] = (signed char)strided++;
    }
    t.first_chunk[i] = (int)chunks;
    chunks += (e[4] + kChunk - 1) / kChunk;
    if (chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  t.first_chunk[count] = (int)chunks;
  t.count = count;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pair) {
    case 0: return launch<float, float>(t, (int)chunks, scalars, s);
    case 1: return launch<float, __nv_bfloat16>(t, (int)chunks, scalars, s);
    case 2: return launch<double, double>(t, (int)chunks, scalars, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The most tensors, strided gradients and collapsed gradient dims one
// launch takes.
extern "C" int nadam_step_limits(int* max_tensors, int* max_strided, int* max_dims) {
  *max_tensors = kMaxTensors;
  *max_strided = kMaxStrided;
  *max_dims = kMaxDims;
  return 0;
}
