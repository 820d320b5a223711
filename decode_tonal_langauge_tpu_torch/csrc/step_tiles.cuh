// The recurrent step tiles shared by the LSTM (lstm_step.cu) and GRU
// (gru_step.cu) step kernels for sm_90a: the weight-streaming tile and the
// register-tiled GEMM tile, each of which computes one time step's
// recurrent product for a block of rows and units and hands the sums to the
// cell's epilogue, and the choice between them (pick_tile).
//
// A cell C gives
//   - C::GATES, the gate blocks of the product (LSTM 4: i, f, g, o; GRU 3:
//     r, z, n), so the weights are (S, H, GATES H);
//   - C::Args, its launch arguments, which start with the fields the tiles
//     read: a (the left operand: h[t-1] (S, B, H) forward, the deltas
//     (S, B, GATES H) reverse), w (the weights, contiguous), S, B, H and
//     mode (reverse: 2 is a step with no product);
//   - C::finish<T, REV>(p, s, r, j, sum): the epilogue of one (row r, unit
//     j) pair of seed s from its product sums, the forward's GATES gate
//     sums of unit j or the reverse's sum over the deltas (sum[0]).
// Each kernel file wraps the tiles in __global__ kernels of its own names
// (lstm_stream_kernel, gru_stream_kernel, ...), so a trace tells the cells
// apart. The product is the same FFMA chain in both: the LSTM's kernels
// are these tiles at GATES 4.
//
// Forward: a block owns UN hidden units J of one seed and BM rows and
// computes the GATES gate columns {J, H+J, ...} of h[t-1] @ w. Reverse: a
// block computes sum_k a[:, k] w[J, k] over the GATES H deltas, reading
// rows J of w (contiguous).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

// Rows a seed up to which the forward may take its wide streaming tile, and
// the blocks a multiprocessor should hold of a streaming and a GEMM tile.
constexpr int SMALL_ROWS = 8;
constexpr int STREAM_MIN_BLOCKS = 2;
constexpr int GEMM_MIN_BLOCKS = 3;
constexpr int WIDE_UNITS = 64;  // the forward's wide streaming tile's UN

// Storage type T, arithmetic type V (float for bf16), every operation
// rounded to T.
template <typename T> struct Num;

template <> struct Num<float> {
  using V = float;
  static __device__ __forceinline__ V ld(float x) { return x; }
  static __device__ __forceinline__ float st(V x) { return x; }
  static __device__ __forceinline__ V rnd(V x) { return x; }
  static __device__ __forceinline__ V add(V a, V b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ V sub(V a, V b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ V mul(V a, V b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ V sig(V x) { return 1.0f / (1.0f + expf(-x)); }
  static __device__ __forceinline__ V tnh(V x) { return tanhf(x); }
};

template <> struct Num<double> {
  using V = double;
  static __device__ __forceinline__ V ld(double x) { return x; }
  static __device__ __forceinline__ double st(V x) { return x; }
  static __device__ __forceinline__ V rnd(V x) { return x; }
  static __device__ __forceinline__ V add(V a, V b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ V sub(V a, V b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ V mul(V a, V b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ V sig(V x) { return 1.0 / (1.0 + exp(-x)); }
  static __device__ __forceinline__ V tnh(V x) { return tanh(x); }
};

template <> struct Num<__nv_bfloat16> {
  using V = float;
  static __device__ __forceinline__ V ld(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 st(V x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ V rnd(V x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  static __device__ __forceinline__ V add(V a, V b) { return rnd(__fadd_rn(a, b)); }
  static __device__ __forceinline__ V sub(V a, V b) { return rnd(__fsub_rn(a, b)); }
  static __device__ __forceinline__ V mul(V a, V b) { return rnd(__fmul_rn(a, b)); }
  static __device__ __forceinline__ V sig(V x) { return rnd(1.0f / (1.0f + expf(-x))); }
  static __device__ __forceinline__ V tnh(V x) { return rnd(tanhf(x)); }
};

template <typename T, int N> struct alignas(N * sizeof(T) >= 16 ? 16 : alignof(T)) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_span(typename Num<T>::V* dst, const T* src) {
  // N consecutive elements of shared memory, 16 (or 8) bytes a load where
  // they allow it.
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    constexpr int E = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < N / E; ++q) {
      const Vec<T, E> x = *reinterpret_cast<const Vec<T, E>*>(src + q * E);
#pragma unroll
      for (int e = 0; e < E; ++e) dst[q * E + e] = Num<T>::ld(x.v[e]);
    }
  } else if constexpr ((N * sizeof(T)) % 8 == 0 && sizeof(T) <= 8) {
    constexpr int E = 8 / sizeof(T);
    struct alignas(8) Half {
      T v[E];
    };
#pragma unroll
    for (int q = 0; q < N / E; ++q) {
      const Half x = *reinterpret_cast<const Half*>(src + q * E);
#pragma unroll
      for (int e = 0; e < E; ++e) dst[q * E + e] = Num<T>::ld(x.v[e]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = Num<T>::ld(src[q]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // 16 bytes global -> shared, or 16 zero bytes where !valid
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Weight-streaming tile, for up to 64 rows a seed with 16-byte aligned
// operands: BM rows x UN units a block, TM x TN products a thread, KG
// groups of threads splitting each K-tile of BK, ST K-tiles in flight.
// cp.async copies each K-tile into shared memory in the operands' own
// layouts (A rows along k; the forward's W row k as GATES gate runs of UN
// units, the reverse's W rows j along k), and the product reads them
// there: the forward's threads take neighbouring columns of one W row, the
// reverse's threads neighbouring k of its A and W rows. (Turning A and W
// k-major in shared memory first, for 16-byte reads, measured slower on
// an H100.)
template <typename T, bool REV, int GATES, int BM, int UN, int TM, int TN, int KG, int BK, int ST>
struct Stream {
  using V = typename Num<T>::V;
  static constexpr int CE = 16 / sizeof(T);  // elements a 16-byte copy
  static constexpr int NC = REV ? UN : GATES * UN;  // product columns: unit, or gate-major
  static constexpr int MT = BM / TM, NT = NC / TN, KK = BK / KG;
  static constexpr int BKP = BK + CE;  // a padded row of k
  static constexpr int A_ELEMS = BM * BKP;
  static constexpr int STAGE = A_ELEMS + (REV ? UN * BKP : BK * NC);
  static constexpr int A_CHUNKS = BM * (BK / CE);
  static constexpr int W_CHUNKS = REV ? UN * (BK / CE) : BK * GATES * (UN / CE);
  static constexpr size_t PIPE = (size_t)ST * STAGE * sizeof(T);
  static constexpr size_t RED = (size_t)KG * BM * NC * sizeof(V);
  static constexpr size_t SMEM = PIPE > RED ? PIPE : RED;
  static_assert(MT * NT * KG == THREADS && BM % TM == 0 && NC % TN == 0 && BK % KG == 0 &&
                    BK % CE == 0 && UN % CE == 0 && ST >= 2,
                "tile");
};

template <class C, typename T, bool REV, int BM, int UN, int TM, int TN, int KG, int BK, int ST>
__device__ __forceinline__ void stream_tile(const typename C::Args& p) {
  constexpr int GATES = C::GATES;
  using P = Stream<T, REV, GATES, BM, UN, TM, TN, KG, BK, ST>;
  using V = typename Num<T>::V;
  using N = Num<T>;
  constexpr int NC = P::NC, MT = P::MT, NT = P::NT, KK = P::KK, CE = P::CE, BKP = P::BKP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);  // ST stages of [A | W]
  V* red = reinterpret_cast<V*>(smem);  // [KG][BM][NC], after the K loop

  const int B = p.B, H = p.H, G = GATES * H;
  const int K = REV ? G : H;
  const int row_tiles = (B + BM - 1) / BM;
  const int s = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x % row_tiles) * BM;
  const int j0 = blockIdx.y * UN;
  const int tid = threadIdx.x;
  const int kg = REV ? tid % KG : tid / (NT * MT);
  const int nt = REV ? (tid / KG) % NT : tid % NT;
  const int mt = REV ? tid / (KG * NT) : (tid / NT) % MT;
  const bool product = !REV || p.mode != 2;

  if (product) {
    const T* A = static_cast<const T*>(p.a) + (long long)s * B * K;
    const T* W = static_cast<const T*>(p.w) + (long long)s * H * G;
    const int tiles = (K + BK - 1) / BK;
    auto issue = [&](int t) {
      if (t < tiles) {
        T* as = buf + (t % ST) * P::STAGE;
        T* ws = as + P::A_ELEMS;
        const int k0 = t * BK;
        for (int c = tid; c < P::A_CHUNKS; c += THREADS) {
          const int m = c / (BK / CE), k = (c % (BK / CE)) * CE;
          const bool ok = r0 + m < B && k0 + k < K;
          cp_async16(as + m * BKP + k, ok ? A + (long long)(r0 + m) * K + k0 + k : A, ok);
        }
        for (int c = tid; c < P::W_CHUNKS; c += THREADS) {
          if constexpr (REV) {
            const int u = c / (BK / CE), k = (c % (BK / CE)) * CE;
            const bool ok = j0 + u < H && k0 + k < K;
            cp_async16(ws + u * BKP + k, ok ? W + (long long)(j0 + u) * G + k0 + k : W, ok);
          } else {
            const int kk = c / (GATES * UN / CE), rem = c % (GATES * UN / CE);
            const int g = rem / (UN / CE), u = (rem % (UN / CE)) * CE;
            const bool ok = k0 + kk < K && j0 + u < H;
            cp_async16(ws + kk * NC + g * UN + u,
                       ok ? W + (long long)(k0 + kk) * G + g * H + j0 + u : W, ok);
          }
        }
      }
      cp_async_commit();  // an empty group past the last tile keeps the count
    };

    V acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = V(0);
#pragma unroll
    for (int t = 0; t < ST - 1; ++t) issue(t);
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait<ST - 2>();
      __syncthreads();  // tile t landed; tile t-1's buffer is free
      issue(t + ST - 1);
      const T* as = buf + (t % ST) * P::STAGE;
      const T* ws = as + P::A_ELEMS;
#pragma unroll
      for (int q = 0; q < KK; ++q) {
        const int kk = REV ? q * KG + kg : kg * KK + q;
        V a[TM], w[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = N::ld(as[(mt + MT * i) * BKP + kk]);
        if constexpr (REV) {
#pragma unroll
          for (int j = 0; j < TN; ++j) w[j] = N::ld(ws[(nt * TN + j) * BKP + kk]);
        } else {
          load_span<T, TN>(w, ws + kk * NC + nt * TN);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], w[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) red[(kg * BM + mt + MT * i) * NC + nt * TN + j] = acc[i][j];
    __syncthreads();
  }

  // One (row, unit) pair a thread at a time, units fastest: neighbouring
  // threads touch neighbouring addresses. The k-groups' sums are added in
  // a fixed order.
  for (int idx = tid; idx < BM * UN; idx += THREADS) {
    const int m = idx / UN, u = idx % UN;
    const int r = r0 + m, j = j0 + u;
    if (r >= B || j >= H) continue;
    V sum[GATES];
#pragma unroll
    for (int g = 0; g < GATES; ++g) sum[g] = V(0);
    if (product) {
#pragma unroll
      for (int g = 0; g < (REV ? 1 : GATES); ++g) {
        V x = V(0);
        for (int q = 0; q < KG; ++q) x += red[(q * BM + m) * NC + (REV ? u : g * UN + u)];
        sum[g] = x;
      }
    }
    C::template finish<T, REV>(p, s, r, j, sum);
  }
}

// Register-tiled GEMM tile, for more than 64 rows a seed and for operands
// the 16-byte copies cannot take: BM rows x UN units a block, TM x TN a
// thread, one BK tile ahead in registers (VW elements a load) while the
// current one is multiplied out of shared memory. A thread's TN columns
// hold whole units (the forward's column n = GATES u + g), so the epilogue
// runs from its registers.
template <typename T, bool REV, int GATES, int BM, int UN, int TM, int TN, int BK, int VW>
struct Gemm {
  static constexpr int NC = REV ? UN : GATES * UN;
  static constexpr int MT = BM / TM, NT = NC / TN;
  static constexpr int BMP = BM + 16 / sizeof(T);  // padded A row: fewer bank conflicts in the stores
  static constexpr int NA = BM * BK / VW, NW = BK * NC / VW;
  static constexpr int RA = (NA + THREADS - 1) / THREADS, RW = (NW + THREADS - 1) / THREADS;
  static constexpr size_t SMEM = 2 * (size_t)BK * (BMP + NC) * sizeof(T);
  static_assert(MT * NT == THREADS && BM % TM == 0 && NC % TN == 0 && BK % VW == 0 &&
                    UN % VW == 0 && (REV || TN % GATES == 0),
                "tile");
};

template <class C, typename T, bool REV, int BM, int UN, int TM, int TN, int BK, int VW>
__device__ __forceinline__ void gemm_tile(const typename C::Args& p) {
  constexpr int GATES = C::GATES;
  using P = Gemm<T, REV, GATES, BM, UN, TM, TN, BK, VW>;
  using V = typename Num<T>::V;
  using VecT = Vec<T, VW>;
  constexpr int NC = P::NC, NT = P::NT, BMP = P::BMP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [2][BK][BMP]
  T* Ws = As + 2 * BK * BMP;           // [2][BK][NC]

  const int B = p.B, H = p.H, G = GATES * H;
  const int K = REV ? G : H;
  const int row_tiles = (B + BM - 1) / BM;
  const int s = blockIdx.x / row_tiles;  // row tiles fastest: they share W in L2
  const int r0 = (blockIdx.x % row_tiles) * BM;
  const int j0 = blockIdx.y * UN;
  const int tid = threadIdx.x;
  const int mt = tid / NT, nt = tid % NT;

  V acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = V(0);

  if (!REV || p.mode != 2) {
    const T* A = static_cast<const T*>(p.a) + (long long)s * B * K;
    const T* W = static_cast<const T*>(p.w) + (long long)s * H * G;
    VecT ra[P::RA], rw[P::RW];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int q = 0; q < P::RA; ++q) {
        const int v = tid + q * THREADS;
        VecT x{};
        if (v < P::NA) {
          const int m = v / (BK / VW), k = k0 + (v % (BK / VW)) * VW;
          if (r0 + m < B && k < K) x = *reinterpret_cast<const VecT*>(A + (long long)(r0 + m) * K + k);
        }
        ra[q] = x;
      }
#pragma unroll
      for (int q = 0; q < P::RW; ++q) {
        const int v = tid + q * THREADS;
        VecT x{};
        if (v < P::NW) {
          if constexpr (REV) {  // rows j of w, contiguous along k
            const int u = v / (BK / VW), k = k0 + (v % (BK / VW)) * VW;
            if (j0 + u < H && k < K) x = *reinterpret_cast<const VecT*>(W + (long long)(j0 + u) * G + k);
          } else {  // row k of w, gate g's units J contiguous
            const int kk = v / (GATES * UN / VW), rem = v % (GATES * UN / VW);
            const int g = rem / (UN / VW), u = (rem % (UN / VW)) * VW;
            if (k0 + kk < K && j0 + u < H)
              x = *reinterpret_cast<const VecT*>(W + (long long)(k0 + kk) * G + g * H + j0 + u);
          }
        }
        rw[q] = x;
      }
    };
    auto stash = [&](int buf) {
      T* as = As + buf * BK * BMP;
      T* ws = Ws + buf * BK * NC;
#pragma unroll
      for (int q = 0; q < P::RA; ++q) {
        const int v = tid + q * THREADS;
        if (v < P::NA) {
          const int m = v / (BK / VW), k = (v % (BK / VW)) * VW;
#pragma unroll
          for (int e = 0; e < VW; ++e) as[(k + e) * BMP + m] = ra[q].v[e];
        }
      }
#pragma unroll
      for (int q = 0; q < P::RW; ++q) {
        const int v = tid + q * THREADS;
        if (v < P::NW) {
          if constexpr (REV) {
            const int u = v / (BK / VW), k = (v % (BK / VW)) * VW;
#pragma unroll
            for (int e = 0; e < VW; ++e) ws[(k + e) * NC + u] = rw[q].v[e];
          } else {
            const int kk = v / (GATES * UN / VW), rem = v % (GATES * UN / VW);
            const int g = rem / (UN / VW), u = (rem % (UN / VW)) * VW;
#pragma unroll
            for (int e = 0; e < VW; ++e) ws[kk * NC + (u + e) * GATES + g] = rw[q].v[e];
          }
        }
      }
    };

    const int tiles = (K + BK - 1) / BK;
    // Threads whose rows all lie past B (a ragged last row tile) skip the
    // FMAs, leaving the issue slots to the other blocks on the multiprocessor.
    const bool live = r0 + mt * TM < B;
    fetch(0);
    stash(0);
    __syncthreads();
    for (int t = 0; t < tiles; ++t) {
      const int buf = t & 1;
      if (t + 1 < tiles) fetch((t + 1) * BK);
      const T* as = As + buf * BK * BMP;
      const T* ws = Ws + buf * BK * NC;
      if (live) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          V a[TM], w[TN];
          load_span<T, TM>(a, as + kk * BMP + mt * TM);
          load_span<T, TN>(w, ws + kk * NC + nt * TN);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], w[j], acc[i][j]);
        }
      }
      if (t + 1 < tiles) stash(buf ^ 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + mt * TM + i;
    if (r >= B) continue;
    if constexpr (REV) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int u = j0 + nt * TN + j;
        if (u < H) C::template finish<T, REV>(p, s, r, u, &acc[i][j]);
      }
    } else {
#pragma unroll
      for (int uu = 0; uu < TN / GATES; ++uu) {
        const int u = j0 + nt * (TN / GATES) + uu;
        if (u < H) C::template finish<T, REV>(p, s, r, u, &acc[i][uu * GATES]);
      }
    }
  }
}

template <class P, typename Kernel, typename A>
cudaError_t launch_kernel(Kernel fn, const A& p, int bm, int un, cudaStream_t stream) {
  static bool opted = false;  // more than 48 KB of shared memory asked for once
  if (P::SMEM > 48 * 1024 && !opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const dim3 grid(p.S * ((p.B + bm - 1) / bm), (p.H + un - 1) / un);
  fn<<<grid, THREADS, P::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// The tile for B rows a seed: 0 (B <= SMALL_ROWS) and 1 (B <= 64) stream
// the weights, 2 is the GEMM tile, 3 the GEMM tile for operands that are
// not 16-byte aligned, 4 the forward's wide streaming tile for
// B <= SMALL_ROWS, taken where its blocks (S x H / WIDE_UNITS) still give
// every multiprocessor one.
inline int pick_tile(int S, int B, int H, bool aligned, bool rev) {
  if (!aligned) return 3;
  if (B > 64) return 2;
  if (B > SMALL_ROWS) return 1;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return !rev && (long long)S * ((H + WIDE_UNITS - 1) / WIDE_UNITS) >= sms ? 4 : 0;
}

template <typename T, typename A>
bool aligned(const A& p) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(p.a) | reinterpret_cast<uintptr_t>(p.w);
  return ((long long)p.H * sizeof(T)) % 16 == 0 && ptrs % 16 == 0;
}

// The checks every step entry point makes before it launches.
template <typename A>
bool launchable(const A& p) {
  return p.S >= 1 && p.B >= 1 && p.H >= 1 && (long long)p.S * ((p.B + 7) / 8) <= INT32_MAX &&
         (p.H + 7) / 8 <= 65535;
}

}  // namespace
