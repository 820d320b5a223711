// Exact direct-form-II-transposed IIR recurrence (scipy.signal.lfilter with
// an initial state) for sm_90a, as a time-chunked three-pass scan.
//
// Replaces the TPU kernel built by decode_tonal_langauge_tpu/ops/
// pallas_iir.py:_build_call. There, channels rode the 128 VPU lanes and
// the state sat in VMEM scratch carried across a sequential grid of
// 4096-step time chunks, frozen through the zero-padded tail. Hopper runs
// blocks in parallel and in no order, and a serial walk of the time axis
// (one thread per row) leaves 131 of 132 SMs idle and waits on memory at
// every step. So time is cut into chunks of L samples, and the recurrence
// is linear in its state: a chunk entered with state s ends in
// A^L s + u, where u is its end state from a zero start.
//
//   pass 1 (chunk_pass<ORDER, false>): one thread per (row, chunk) runs the
//     f32 recurrence from a zero state over its chunk and writes u.
//   pass 2 (carry_*): one warp per row carries the state across chunks in
//     f64, s_in[0] = zi, s_in[j+1] = P s_in[j] + u[j], with P = A^L built
//     on the host from the f32-rounded a (ops/cuda_iir.py:carry_matrix).
//   pass 3 (chunk_pass<ORDER, true>): every thread re-runs its chunk in
//     f32 from s_in[j] rounded to f32, writes y, and the row's last
//     (ragged) chunk writes zf, the state after the last real sample.
//
// x and y stay row-major (C, T). A block owns THREADS consecutive chunks of
// one row and walks them WINDOW samples at a time: cp.async stages the
// next window of every chunk into shared memory, 16 bytes a copy (8
// threads copy one chunk's 128 contiguous bytes; 4 bytes a copy when T is
// not a multiple of 4), while the threads run the current one. A staged
// row is WINDOW + 4 floats long, so a thread reads its chunk 4 steps at a
// time with one 16-byte load and the 8 threads of each quarter-warp hit
// distinct banks. Pass 3 writes y over x in the staged window and stores
// it back just as coalesced.
//
// The state lives in registers with the order a template argument (1 to
// MAX_ORDER, no per-step predicates); higher orders run a generic instance
// that keeps the state and coefficients in shared memory, with fewer
// threads a block when the state would not fit.
//
// Rounding: every f32 product and sum in passes 1 and 3, and every f64
// product and sum in pass 2, is rounded on its own (_rn intrinsics, never
// contracted into FMAs) in the order of the plain version,
// ops/cuda_iir.py:lfilter_chunked_reference, so the two agree bit for bit.
//
// What bounds it on an H100, at the main-path shape of 128 rows x 183,120
// samples (60 s at 3052 Hz), order 8, L = 512 (ops/cuda_iir.py:CHUNK):
//   - bytes: x read once and y written once is 188 MB, 0.056 ms at
//     3.35 TB/s; passes 1 and 3 read x twice and write y once, 282 MB,
//     0.084 ms;
//   - operations: 2 + 4 x order flops a sample in each of passes 1 and 3,
//     ~1.6 GFLOP, ~24 us at the 67 TFLOP/s f32 peak (each is its own
//     instruction here, ~35 a step, so ~50 us of issue at full rate);
//   - pass 2 is a serial chain of T / L f64 8 x 8 products per row (357
//     here), one warp per row: its latency, not the card's rates, sets
//     its time. It shrinks as L grows while passes 1 and 3 lose threads
//     (128 x 358 chunks = 45,824 threads at L = 512); scripts/k1_sweep.py
//     measures the trade.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <utility>

#define MAX_ORDER 16  // keep equal to MAX_ORDER in ops/cuda_iir.py
#define WINDOW 32     // keep equal to WINDOW in ops/cuda_iir.py
#define THREADS 128   // chunks a block walks (register instances)
#define STRIDE (WINDOW + 4)  // staged row: 16-byte aligned, conflict-free
#define STAGES 2     // windows staged at once: the one run and those in flight

struct Coeffs {
  float b[MAX_ORDER + 1];
  float a[MAX_ORDER + 1];
};

struct Problem {
  const float* x;     // (C, T)
  float* y;           // (C, T), pass 3
  const float* s_in;  // (C, nc, order), pass 3
  float* u;           // (C, nc, order), pass 1; slot nc - 1 unused
  float* zf;          // (C, order), pass 3
  const float* coef;  // b then a, order + 1 each (generic instance)
  long long T;
  int L;
  int nc;
  int order;
  int vec;  // floats a copy moves: 4 when x and y rows are 16-byte aligned, else 1
};

// State of one chunk in registers. One DF2T step:
// y = b0*x + s0, s_i = (s_{i+1} + b_{i+1}*x) - a_{i+1}*y, s_order = 0.
template <int ORDER>
struct RegState {
  float s[ORDER];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < ORDER; ++i) s[i] = 0.0f;
  }
  __device__ __forceinline__ void load(const float* src) {
#pragma unroll
    for (int i = 0; i < ORDER; ++i) s[i] = src[i];
  }
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int i = 0; i < ORDER; ++i) dst[i] = s[i];
  }
  __device__ __forceinline__ float step(const Coeffs& k, float xt) {
    const float yt = __fadd_rn(__fmul_rn(k.b[0], xt), s[0]);
#pragma unroll
    for (int i = 0; i + 1 < ORDER; ++i) {
      s[i] = __fsub_rn(__fadd_rn(s[i + 1], __fmul_rn(k.b[i + 1], xt)),
                       __fmul_rn(k.a[i + 1], yt));
    }
    // 0 + b*x is b*x: the last slot skips the add of the shifted-in zero.
    s[ORDER - 1] = __fsub_rn(__fmul_rn(k.b[ORDER], xt),
                             __fmul_rn(k.a[ORDER], yt));
    return yt;
  }
};

// The same state for any order, in shared memory: slot i of this thread
// at s[i * n], coefficients b[0..m] and a[0..m] in shared memory too.
struct SmemState {
  float* s;
  int n;
  int m;
  const float* b;
  const float* a;

  __device__ __forceinline__ void zero() {
    for (int i = 0; i < m; ++i) s[i * n] = 0.0f;
  }
  __device__ __forceinline__ void load(const float* src) {
    for (int i = 0; i < m; ++i) s[i * n] = src[i];
  }
  __device__ __forceinline__ void store(float* dst) const {
    for (int i = 0; i < m; ++i) dst[i] = s[i * n];
  }
  __device__ __forceinline__ float step(const Coeffs&, float xt) {
    const float yt = __fadd_rn(__fmul_rn(b[0], xt), s[0]);
    for (int i = 0; i + 1 < m; ++i) {
      s[i * n] = __fsub_rn(__fadd_rn(s[(i + 1) * n], __fmul_rn(b[i + 1], xt)),
                           __fmul_rn(a[i + 1], yt));
    }
    s[(m - 1) * n] = __fsub_rn(__fmul_rn(b[m], xt), __fmul_rn(a[m], yt));
    return yt;
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Run chunk j = j0 + tid of `row`, with the block's other chunks, window
// by window. `last` is the first chunk the pass does not walk, `len` this
// thread's chunk length in the pass, `nwin` the windows of the block's
// longest chunk. Pass 1 starts from zero and writes u[j]; pass 3 starts
// from s_in[j], writes y and, in the row's last chunk, zf.
template <bool FINAL, class State>
__device__ __forceinline__ void walk(const Problem& p, const Coeffs& k,
                                     State& st, float* buf, int row, int j0,
                                     int last, int len, int nwin, int m) {
  const int n = blockDim.x;
  const int tid = threadIdx.x;
  const int j = j0 + tid;
  if (FINAL && j < p.nc) {
    st.load(p.s_in + ((size_t)row * p.nc + j) * m);
  } else {
    st.zero();
  }
  const float* xr = p.x + (size_t)row * p.T;
  float* yr = p.y + (size_t)row * p.T;

  // A window is n rows (chunks) of WINDOW samples, moved p.vec floats at a
  // time: PER copies a row, so a warp moves 32 / PER rows of 128
  // contiguous bytes. This thread's copies are column `col` of rows
  // row0, row0 + rstep, ...: PER copies a window, whatever n is.
  const int per = WINDOW / p.vec;
  const int col = (tid % per) * p.vec;
  const int row0 = tid / per;
  const int rstep = n / per;
  const int tail = (int)(p.T - (long long)(p.nc - 1) * p.L);
  // Copy i of window w: its row c and its sample `off` within the chunk,
  // false past the chunk's end (a vector never straddles it: the wrapper
  // takes vec 4 only when T, and so every chunk length, is a multiple of 4).
  auto slot = [&](int i, int w, int& c, int& off) {
    c = row0 + i * rstep;
    const int cj = j0 + c;
    const int lim = cj < last ? (cj < p.nc - 1 ? p.L : tail) : 0;
    off = w * WINDOW + col;
    return off < lim;
  };
  auto stage = [&](int w, float* dst) {
    for (int i = 0; i < per; ++i) {
      int c, off;
      if (!slot(i, w, c, off)) continue;
      const float* src = xr + (size_t)(j0 + c) * p.L + off;
      if (p.vec == 4) {
        cp_async16(dst + c * STRIDE + col, src);
      } else {
        cp_async4(dst + c * STRIDE + col, src);
      }
    }
    cp_async_commit();
  };

  auto window = [&](int w) { return buf + (w % STAGES) * n * STRIDE; };
#pragma unroll
  for (int w = 0; w + 1 < STAGES; ++w) {
    if (w < nwin) {
      stage(w, window(w));
    } else {
      cp_async_commit();  // empty groups keep the wait count exact
    }
  }
  for (int w = 0; w < nwin; ++w) {
    float* cur = window(w);
    if (w + STAGES - 1 < nwin) {
      stage(w + STAGES - 1, window(w + STAGES - 1));
    } else {
      cp_async_commit();
    }
    cp_async_wait<STAGES - 1>();  // window w has landed
    __syncthreads();

    float* mine = cur + tid * STRIDE;
    const int steps = min(WINDOW, max(0, len - w * WINDOW));
    if (steps == WINDOW) {
#pragma unroll
      for (int q = 0; q < WINDOW; q += 4) {
        float4* v4 = reinterpret_cast<float4*>(mine + q);
        const float4 xv = *v4;
        const float y0 = st.step(k, xv.x);
        const float y1 = st.step(k, xv.y);
        const float y2 = st.step(k, xv.z);
        const float y3 = st.step(k, xv.w);
        if (FINAL) *v4 = make_float4(y0, y1, y2, y3);
      }
    } else {
      for (int t = 0; t < steps; ++t) {
        const float yt = st.step(k, mine[t]);
        if (FINAL) mine[t] = yt;
      }
    }
    __syncthreads();

    if (FINAL) {
      for (int i = 0; i < per; ++i) {
        int c, off;
        if (!slot(i, w, c, off)) continue;
        const float* src = cur + c * STRIDE + col;
        float* dst = yr + (size_t)(j0 + c) * p.L + off;
        if (p.vec == 4) {
          *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
        } else {
          *dst = *src;
        }
      }
      __syncthreads();  // the window is read out before it is restaged
    }
  }

  if (FINAL) {
    if (j == p.nc - 1) st.store(p.zf + (size_t)row * m);
  } else if (j < last) {
    st.store(p.u + ((size_t)row * p.nc + j) * m);
  }
}

// Pass 1 (FINAL false) or pass 3 (FINAL true). ORDER 0 is the generic
// instance. Block b covers row b / bpr, chunks (b % bpr) * n onwards.
template <int ORDER, bool FINAL>
__global__ void __launch_bounds__(THREADS)
chunk_pass(Problem p, Coeffs k) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockDim.x;
  const int tid = threadIdx.x;
  const int m = ORDER > 0 ? ORDER : p.order;
  const int bpr = (p.nc + n - 1) / n;
  const int row = (int)(blockIdx.x / bpr);
  const int j0 = (int)(blockIdx.x % bpr) * n;
  // Pass 1 skips each row's last chunk: no later chunk needs its end state.
  const int last = FINAL ? p.nc : p.nc - 1;
  const long long t0 = (long long)j0 * p.L;
  const int len0 = j0 < last ? (int)min((long long)p.L, p.T - t0) : 0;
  const int nwin = (len0 + WINDOW - 1) / WINDOW;
  if (nwin == 0) return;  // the same for every thread of the block
  const int j = j0 + tid;
  const int len =
      j < last ? (int)min((long long)p.L, p.T - (long long)j * p.L) : 0;
  float* buf = smem;  // [STAGES][n][STRIDE]

  if constexpr (ORDER > 0) {
    RegState<ORDER> st;
    walk<FINAL>(p, k, st, buf, row, j0, last, len, nwin, ORDER);
  } else {
    float* cf = buf + STAGES * n * STRIDE;  // b[0..m], a[0..m]
    for (int i = tid; i < 2 * (m + 1); i += n) cf[i] = p.coef[i];
    __syncthreads();
    SmemState st{cf + 2 * (m + 1) + tid, n, m, cf, cf + m + 1};
    walk<FINAL>(p, k, st, buf, row, j0, last, len, nwin, m);
  }
}

#define RING 8   // u slots of the pass-2 prefetch ring
#define AHEAD 6  // chunks between a u copy's issue and its use (< RING)

// Pass 2 for ORDER <= MAX_ORDER: one warp per row, lane i < ORDER owns
// state entry i and row i of P. acc = sum over k in order of P[i][k] s[k],
// then s_i = acc + u_i, all in f64. The chain is serial over chunks, so u
// must never be waited on: cp.async copies u[j] into a shared ring AHEAD
// chunks before its use. (Plain loads into a ring of registers four
// chunks ahead measured ~260 ns a chunk on an H100, about one round trip
// to L2 each; this ring halved pass 2.)
template <int ORDER>
__global__ void __launch_bounds__(32)
carry_reg(const double* __restrict__ P, const float* __restrict__ zi,
          const float* __restrict__ u, float* __restrict__ s_in, int nc) {
  __shared__ double s[2][ORDER];
  __shared__ float ring[RING][ORDER];
  const int row = blockIdx.x;
  const int i = threadIdx.x;
  const bool live = i < ORDER;
  double pr[ORDER];
#pragma unroll
  for (int k = 0; k < ORDER; ++k) pr[k] = live ? P[i * ORDER + k] : 0.0;
  const size_t base = (size_t)row * nc * ORDER;
  const float* ur = u + base;
  float* sr = s_in + base;
  auto fetch = [&](int jj) {  // one group per chunk, empty past the end
    if (live && jj < nc - 1) {
      cp_async4(&ring[jj % RING][i], ur + (size_t)jj * ORDER + i);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int jj = 0; jj < AHEAD; ++jj) fetch(jj);

  double si = live ? (double)zi[(size_t)row * ORDER + i] : 0.0;
  if (live) s[0][i] = si;
  __syncwarp();
  int cur = 0;
  for (int jj = 0;; ++jj) {
    if (live) sr[(size_t)jj * ORDER + i] = __double2float_rn(si);
    if (jj == nc - 1) break;
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k < ORDER; ++k) {
      acc = __dadd_rn(acc, __dmul_rn(pr[k], s[cur][k]));
    }
    cp_async_wait<AHEAD - 1>();  // this lane's copy of u[jj] has landed
    si = __dadd_rn(acc, (double)ring[jj % RING][live ? i : 0]);
    fetch(jj + AHEAD);
    if (live) s[cur ^ 1][i] = si;
    __syncwarp();
    cur ^= 1;
  }
}

// Pass 2 for any order: the same arithmetic, lane i owning entries i,
// i + 32, ..., the state double-buffered in shared memory.
__global__ void __launch_bounds__(32)
carry_generic(const double* __restrict__ P, const float* __restrict__ zi,
              const float* __restrict__ u, float* __restrict__ s_in, int nc,
              int m) {
  extern __shared__ double sg[];  // [2][m]
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t base = (size_t)row * nc * m;
  const float* ur = u + base;
  float* sr = s_in + base;
  double* cur = sg;
  double* nxt = sg + m;
  for (int i = lane; i < m; i += 32) cur[i] = (double)zi[(size_t)row * m + i];
  __syncwarp();
  for (int jj = 0;; ++jj) {
    for (int i = lane; i < m; i += 32) {
      sr[(size_t)jj * m + i] = __double2float_rn(cur[i]);
    }
    if (jj == nc - 1) break;
    for (int i = lane; i < m; i += 32) {
      double acc = 0.0;
      for (int k = 0; k < m; ++k) {
        acc = __dadd_rn(acc, __dmul_rn(__ldg(P + (size_t)i * m + k), cur[k]));
      }
      nxt[i] = __dadd_rn(acc, (double)ur[(size_t)jj * m + i]);
    }
    __syncwarp();
    double* t = cur;
    cur = nxt;
    nxt = t;
  }
}

typedef void (*ChunkKernel)(Problem, Coeffs);
typedef void (*CarryKernel)(const double*, const float*, const float*, float*,
                            int);

template <bool FINAL, int... O>
static ChunkKernel pick_chunk(int order, std::integer_sequence<int, O...>) {
  static const ChunkKernel table[] = {chunk_pass<0, FINAL>,
                                      chunk_pass<O + 1, FINAL>...};
  return order <= MAX_ORDER ? table[order] : table[0];
}

template <int... O>
static CarryKernel pick_carry(int order, std::integer_sequence<int, O...>) {
  static const CarryKernel table[] = {carry_reg<O + 1>...};
  return table[order - 1];
}

static size_t window_bytes(int n) {
  return (size_t)STAGES * n * STRIDE * sizeof(float);
}

static size_t generic_bytes(int n, int m) {
  return window_bytes(n) + (2 * (size_t)(m + 1) + (size_t)n * m) * sizeof(float);
}

// Pass 1 (final == 0) or pass 3 (final != 0) on `stream`. b and a are host
// arrays of order + 1 normalised coefficients, coef the same on the card.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int iir_df2t_chunk_pass(int final, const float* x, float* y,
                                   const float* s_in, float* u, float* zf,
                                   const float* coef, const float* b,
                                   const float* a, int C, long long T, int L,
                                   int order, void* stream) {
  if (order < 1 || C < 1 || T < 1 || L < WINDOW || L % WINDOW != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nc = (T + L - 1) / L;
  if (nc > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool aligned =
      T % 4 == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  Problem p{x, y, s_in, u, zf, coef, T, L, (int)nc, order, aligned ? 4 : 1};
  Coeffs k{};
  for (int i = 0; i <= order && i <= MAX_ORDER; ++i) {
    k.b[i] = b[i];
    k.a[i] = a[i];
  }
  const ChunkKernel fn =
      final ? pick_chunk<true>(order, std::make_integer_sequence<int, MAX_ORDER>{})
            : pick_chunk<false>(order, std::make_integer_sequence<int, MAX_ORDER>{});
  int n = THREADS;
  size_t smem = window_bytes(n);
  if (order > MAX_ORDER) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err != cudaSuccess) return (int)err;
    while (n > 32 && generic_bytes(n, order) > (size_t)optin) n /= 2;
    smem = generic_bytes(n, order);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)C * ((nc + n - 1) / n);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  fn<<<(unsigned)blocks, n, smem, (cudaStream_t)stream>>>(p, k);
  return (int)cudaGetLastError();
}

// Pass 2 on `stream`: P is (order, order) f64 on the card, zi (C, order),
// u and s_in (C, nc, order). Returns cudaGetLastError() after the launch.
extern "C" int iir_df2t_carry_pass(const double* P, const float* zi,
                                   const float* u, float* s_in, int C, int nc,
                                   int order, void* stream) {
  if (order < 1 || C < 1 || nc < 1) return (int)cudaErrorInvalidValue;
  if (order <= MAX_ORDER) {
    const CarryKernel fn =
        pick_carry(order, std::make_integer_sequence<int, MAX_ORDER>{});
    fn<<<C, 32, 0, (cudaStream_t)stream>>>(P, zi, u, s_in, nc);
  } else {
    const size_t smem = 2 * (size_t)order * sizeof(double);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          (const void*)carry_generic,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    carry_generic<<<C, 32, smem, (cudaStream_t)stream>>>(P, zi, u, s_in, nc,
                                                         order);
  }
  return (int)cudaGetLastError();
}
