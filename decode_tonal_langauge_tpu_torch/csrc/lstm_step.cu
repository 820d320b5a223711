// One LSTM time step for sm_90a: the recurrent product fused with that
// step's gate arithmetic, forward and reverse, one launch a step.
//
// Replaces no Pallas kernel. It is the counterpart of the recurrence that
// the JAX package leaves to lax.scan in decode_tonal_langauge_tpu/ops/
// lstm.py (the forward scan and the reverse scan of its custom_vjp). On the
// card the plain loop (ops/lstm.py) dispatches ~11 ATen ops a forward step
// and ~26 a reverse step, each through vmap's batching layer in a
// seed-batched fit; here each step is one kernel over every seed and row.
//
// Forward step t (lstm_step_forward): a block owns UN hidden units J of one
// seed and BM rows, and computes the four gate columns {J, H+J, 2H+J, 3H+J}
// of xg[t] + h[t-1] @ wh. Its epilogue applies sigmoid / tanh and the cell
// update for those units and writes h[t], c[t] and, when a gradient is to
// be taken, i, f, g, o into the caller's time-major stacks. A unit's gates
// depend on that unit alone, so no block waits on another within a step.
//
// Reverse step t (lstm_step_reverse): a block computes
// dh_next[:, J] = da[t] @ wh^T[:, J], reading rows J of wh (contiguous),
// then forms step t-1's dh = d_h[t-1] + dh_next and
// dc = dh o (1 - tanh^2 c) + dc_next for units J, writes the pre-activation
// deltas da[t-1] of the gate columns of J and keeps dc f in dc_next for the
// next launch. Mode 2 is the first delta, da[T-1], with no product
// (dh_next = dc_next = 0); mode 0 is step 0, whose product is dh0.
//
// Tiles follow the shape (pick_tile): the rows a seed B, and S x H for one
// choice. No tile is chosen by a model's name.
//   - B <= 64, with 16-byte aligned rows: weight-streaming tiles
//     (lstm_stream_kernel). Every row of the block is held in registers
//     against each weight element, cp.async keeps several K-tiles of the
//     weights in flight, and the block's 256 threads split the depth K into
//     groups summed in shared memory in a fixed order. These steps read the
//     weights once and do 2 B FLOPs a weight element: the weight bytes bound
//     them. Up to 8 rows a seed the forward takes 64 units a block where
//     that still gives every multiprocessor a block (4 seeds of H 2640),
//     else 16.
//   - B > 64, or rows not 16-byte aligned: a register-tiled GEMM tile
//     (lstm_gemm_kernel, 128 rows x 16 units x 4 gates, 8 x 4 a thread, the
//     next K-tile staged in registers), bound by the FLOPs.
// The tile shapes (launch, below) were chosen on an H100 by timing the
// candidates PERF.md lists under K2; the card's numbers are there too.
//
// Precision: float32 products are FFMA (no TF32), float64 in double, and
// bf16 loads bf16 and sums in float32. Every epilogue operation is rounded
// to the storage type on its own (_rn intrinsics, never contracted into an
// FMA) in the order of the plain version (ops/lstm.py: _step_plain and
// _delta): the product rounded to T, then xg added; each activation;
// f c, i g and their sum; o tanh(c). The only difference left from the
// plain version is the product's summation order.
//
// What bounds a step on an H100 (3.35 TB/s, 67 TFLOP/s f32), weights read
// once (S seeds x H x 4H x 4 bytes) against 2 S B H 4H FLOPs:
//   - SynthesisFull's label LSTM, H 2640, 4 seeds x 8 rows: 446 MB, 133 us
//     (bytes; 27 us of FLOPs); 1 row (streaming): 112 MB, 33 us;
//   - the CNN-RNN's lstm1, H 800, 4 x 32 rows: 41 MB, 12.2 us (bytes;
//     9.8 us of FLOPs); lstm2, H 512, 4 x 32: 16.8 MB, 5.0 us;
//   - offline decode, 596 rows: H 2640, 33.3 GFLOP, 497 us (FLOPs); H 800,
//     45.6 us; H 512, 18.7 us.

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

struct Args {
  const void* a;  // h[t-1] (S, B, H) or da[t] (S, B, 4H), contiguous
  const void* w;  // wh (S, H, 4H), contiguous
  int S, B, H, mode;
  // forward epilogue
  const void* xg;  // xg[:, :, t]: (S, B, 4H), unit stride along 4H
  long long xg_s, xg_b;
  const void* c_prev;  // (S, B, H)
  void* h_out;
  void* c_out;
  void* ifgo;  // i, f, g, o at step t: 4 slices (S, B, H), or null
  long long ifgo_g;
  // reverse epilogue, step tau = t - 1
  const void* dh;  // d_h[tau]: (S, B, H), unit stride along H
  long long dh_s, dh_b;
  const void* c_tau;     // c[tau]
  const void* c_before;  // c[tau - 1] or c0
  const void* gates;     // i, f, g, o at tau, slice stride gates_g
  long long gates_g;
  void* dc_next;  // (S, B, H), read and written
  void* out;      // da[tau] (S, B, 4H), or dh0 (S, B, H) in mode 0
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

// The epilogue of one (row r, unit j) pair of seed s from its product
// sums: the forward's four gate sums, or the reverse's dh_next (sum[0]).
template <typename T, bool REV>
__device__ __forceinline__ void finish(const Args& p, int s, int r, int j,
                                       const typename Num<T>::V* sum) {
  using N = Num<T>;
  using V = typename Num<T>::V;
  const int B = p.B, H = p.H;
  const long long e = ((long long)s * B + r) * H + j;
  if constexpr (!REV) {
    const T* xr = static_cast<const T*>(p.xg) + s * p.xg_s + r * p.xg_b + j;
    const V gi = N::sig(N::add(N::ld(xr[0]), N::rnd(sum[0])));
    const V gf = N::sig(N::add(N::ld(xr[H]), N::rnd(sum[1])));
    const V gg = N::tnh(N::add(N::ld(xr[2 * H]), N::rnd(sum[2])));
    const V go = N::sig(N::add(N::ld(xr[3 * H]), N::rnd(sum[3])));
    const V cp = N::ld(static_cast<const T*>(p.c_prev)[e]);
    const V c = N::add(N::mul(gf, cp), N::mul(gi, gg));
    const V h = N::mul(go, N::tnh(c));
    static_cast<T*>(p.h_out)[e] = N::st(h);
    static_cast<T*>(p.c_out)[e] = N::st(c);
    if (p.ifgo != nullptr) {
      T* q = static_cast<T*>(p.ifgo) + e;
      q[0] = N::st(gi);
      q[p.ifgo_g] = N::st(gf);
      q[2 * p.ifgo_g] = N::st(gg);
      q[3 * p.ifgo_g] = N::st(go);
    }
  } else {
    const V dh_next = p.mode == 2 ? V(0) : N::rnd(sum[0]);
    if (p.mode == 0) {
      static_cast<T*>(p.out)[e] = N::st(dh_next);
      return;
    }
    const T* gt = static_cast<const T*>(p.gates) + e;
    const V gi = N::ld(gt[0]), gf = N::ld(gt[p.gates_g]);
    const V gg = N::ld(gt[2 * p.gates_g]), go = N::ld(gt[3 * p.gates_g]);
    const V dh = N::add(N::ld(static_cast<const T*>(p.dh)[s * p.dh_s + r * p.dh_b + j]), dh_next);
    const V tc = N::tnh(N::ld(static_cast<const T*>(p.c_tau)[e]));
    const V dcn = p.mode == 2 ? V(0) : N::ld(static_cast<const T*>(p.dc_next)[e]);
    const V one = V(1);
    const V dc = N::add(N::mul(N::mul(dh, go), N::sub(one, N::mul(tc, tc))), dcn);
    const V cb = N::ld(static_cast<const T*>(p.c_before)[e]);
    T* da = static_cast<T*>(p.out) + ((long long)s * B + r) * 4 * H + j;
    da[0] = N::st(N::mul(N::mul(N::mul(dc, gg), gi), N::sub(one, gi)));
    da[H] = N::st(N::mul(N::mul(N::mul(dc, cb), gf), N::sub(one, gf)));
    da[2 * H] = N::st(N::mul(N::mul(dc, gi), N::sub(one, N::mul(gg, gg))));
    da[3 * H] = N::st(N::mul(N::mul(N::mul(dh, tc), go), N::sub(one, go)));
    static_cast<T*>(p.dc_next)[e] = N::st(N::mul(dc, gf));
  }
}

// Weight-streaming tile, for up to 64 rows a seed with 16-byte aligned
// operands: BM rows x UN units a block, TM x TN products a thread, KG
// groups of threads splitting each K-tile of BK, ST K-tiles in flight.
// cp.async copies each K-tile into shared memory in the operands' own
// layouts (A rows along k; the forward's W row k as four gate runs of UN
// units, the reverse's W rows j along k), and the product reads them
// there: the forward's threads take neighbouring columns of one W row, the
// reverse's threads neighbouring k of its A and W rows. (Turning A and W
// k-major in shared memory first, for 16-byte reads, measured slower on
// an H100.)
template <typename T, bool REV, int BM, int UN, int TM, int TN, int KG, int BK, int ST>
struct Stream {
  using V = typename Num<T>::V;
  static constexpr int CE = 16 / sizeof(T);  // elements a 16-byte copy
  static constexpr int NC = REV ? UN : 4 * UN;  // product columns: unit, or gate-major
  static constexpr int MT = BM / TM, NT = NC / TN, KK = BK / KG;
  static constexpr int BKP = BK + CE;  // a padded row of k
  static constexpr int A_ELEMS = BM * BKP;
  static constexpr int STAGE = A_ELEMS + (REV ? UN * BKP : BK * NC);
  static constexpr int A_CHUNKS = BM * (BK / CE);
  static constexpr int W_CHUNKS = REV ? UN * (BK / CE) : BK * 4 * (UN / CE);
  static constexpr size_t PIPE = (size_t)ST * STAGE * sizeof(T);
  static constexpr size_t RED = (size_t)KG * BM * NC * sizeof(V);
  static constexpr size_t SMEM = PIPE > RED ? PIPE : RED;
  static_assert(MT * NT * KG == THREADS && BM % TM == 0 && NC % TN == 0 && BK % KG == 0 &&
                    BK % CE == 0 && UN % CE == 0 && ST >= 2,
                "tile");
};

template <typename T, bool REV, int BM, int UN, int TM, int TN, int KG, int BK, int ST>
__global__ void __launch_bounds__(THREADS, STREAM_MIN_BLOCKS) lstm_stream_kernel(const Args p) {
  using P = Stream<T, REV, BM, UN, TM, TN, KG, BK, ST>;
  using V = typename Num<T>::V;
  using N = Num<T>;
  constexpr int NC = P::NC, MT = P::MT, NT = P::NT, KK = P::KK, CE = P::CE, BKP = P::BKP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);  // ST stages of [A | W]
  V* red = reinterpret_cast<V*>(smem);  // [KG][BM][NC], after the K loop

  const int B = p.B, H = p.H, G = 4 * H;
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
            const int kk = c / (4 * UN / CE), rem = c % (4 * UN / CE);
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
    V sum[4] = {V(0), V(0), V(0), V(0)};
    if (product) {
#pragma unroll
      for (int g = 0; g < (REV ? 1 : 4); ++g) {
        V x = V(0);
        for (int q = 0; q < KG; ++q) x += red[(q * BM + m) * NC + (REV ? u : g * UN + u)];
        sum[g] = x;
      }
    }
    finish<T, REV>(p, s, r, j, sum);
  }
}

// Register-tiled GEMM tile, for more than 64 rows a seed and for operands
// the 16-byte copies cannot take: BM rows x UN units a block, TM x TN a
// thread, one BK tile ahead in registers (VW elements a load) while the
// current one is multiplied out of shared memory. A thread's TN columns
// hold whole units (the forward's column n = 4 u + g), so the epilogue runs
// from its registers.
template <typename T, bool REV, int BM, int UN, int TM, int TN, int BK, int VW>
struct Gemm {
  static constexpr int NC = REV ? UN : 4 * UN;
  static constexpr int MT = BM / TM, NT = NC / TN;
  static constexpr int BMP = BM + 16 / sizeof(T);  // padded A row: fewer bank conflicts in the stores
  static constexpr int NA = BM * BK / VW, NW = BK * NC / VW;
  static constexpr int RA = (NA + THREADS - 1) / THREADS, RW = (NW + THREADS - 1) / THREADS;
  static constexpr size_t SMEM = 2 * (size_t)BK * (BMP + NC) * sizeof(T);
  static_assert(MT * NT == THREADS && BM % TM == 0 && NC % TN == 0 && BK % VW == 0 &&
                    UN % VW == 0 && (REV || TN % 4 == 0),
                "tile");
};

template <typename T, bool REV, int BM, int UN, int TM, int TN, int BK, int VW>
__global__ void __launch_bounds__(THREADS, sizeof(T) > 4 ? 1 : GEMM_MIN_BLOCKS)
    lstm_gemm_kernel(const Args p) {
  using P = Gemm<T, REV, BM, UN, TM, TN, BK, VW>;
  using V = typename Num<T>::V;
  using VecT = Vec<T, VW>;
  constexpr int NC = P::NC, NT = P::NT, BMP = P::BMP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [2][BK][BMP]
  T* Ws = As + 2 * BK * BMP;           // [2][BK][NC]

  const int B = p.B, H = p.H, G = 4 * H;
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
          if constexpr (REV) {  // rows j of wh, contiguous along k
            const int u = v / (BK / VW), k = k0 + (v % (BK / VW)) * VW;
            if (j0 + u < H && k < K) x = *reinterpret_cast<const VecT*>(W + (long long)(j0 + u) * G + k);
          } else {  // row k of wh, gate g's units J contiguous
            const int kk = v / (4 * UN / VW), rem = v % (4 * UN / VW);
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
            const int kk = v / (4 * UN / VW), rem = v % (4 * UN / VW);
            const int g = rem / (UN / VW), u = (rem % (UN / VW)) * VW;
#pragma unroll
            for (int e = 0; e < VW; ++e) ws[kk * NC + (u + e) * 4 + g] = rw[q].v[e];
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
        if (u < H) finish<T, REV>(p, s, r, u, &acc[i][j]);
      }
    } else {
#pragma unroll
      for (int uu = 0; uu < TN / 4; ++uu) {
        const int u = j0 + nt * (TN / 4) + uu;
        if (u < H) finish<T, REV>(p, s, r, u, &acc[i][uu * 4]);
      }
    }
  }
}

template <class P, typename Kernel>
cudaError_t launch_kernel(Kernel fn, const Args& p, int bm, int un, cudaStream_t stream) {
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

template <typename T, bool REV, int BM, int UN, int TM, int TN, int KG, int BK, int ST>
cudaError_t launch_stream(const Args& p, cudaStream_t stream) {
  using P = Stream<T, REV, BM, UN, TM, TN, KG, BK, ST>;
  return launch_kernel<P>(lstm_stream_kernel<T, REV, BM, UN, TM, TN, KG, BK, ST>, p, BM, UN,
                          stream);
}

template <typename T, bool REV, int BM, int UN, int TM, int TN, int BK, int VW>
cudaError_t launch_gemm(const Args& p, cudaStream_t stream) {
  using P = Gemm<T, REV, BM, UN, TM, TN, BK, VW>;
  return launch_kernel<P>(lstm_gemm_kernel<T, REV, BM, UN, TM, TN, BK, VW>, p, BM, UN, stream);
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

template <typename T>
bool aligned(const Args& p) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(p.a) | reinterpret_cast<uintptr_t>(p.w);
  return ((long long)p.H * sizeof(T)) % 16 == 0 && ptrs % 16 == 0;
}

// The tiles' shapes: a streaming tile's BM, UN, TM, TN, KG, BK, stages (see
// Stream), a GEMM tile's BM, UN, TM, TN, BK and its load width (see Gemm).
template <typename T, bool REV>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  const int tile = pick_tile(p.S, p.B, p.H, aligned<T>(p), REV);
  constexpr int VW = 16 / sizeof(T);
  if constexpr (REV) {
    if (tile == 0) return launch_stream<T, REV, 8, 16, 8, 4, 64, 256, 3>(p, stream);
    if (tile == 1) return launch_stream<T, REV, 32, 16, 8, 4, 16, 128, 3>(p, stream);
    if (tile == 2) return launch_gemm<T, REV, 128, 64, 8, 4, 16, VW>(p, stream);
    return launch_gemm<T, REV, 128, 64, 8, 4, 16, 1>(p, stream);
  } else {
    if (tile == 0) return launch_stream<T, REV, 8, 16, 8, 4, 16, 64, 4>(p, stream);
    if (tile == 4) return launch_stream<T, REV, 8, WIDE_UNITS, 8, 4, 4, 16, 4>(p, stream);
    if (tile == 1) return launch_stream<T, REV, 32, 16, 8, 4, 4, 64, 3>(p, stream);
    if (tile == 2) return launch_gemm<T, REV, 128, 16, 8, 4, 16, VW>(p, stream);
    return launch_gemm<T, REV, 128, 16, 8, 4, 16, 1>(p, stream);
  }
}

template <bool REV>
int dispatch(int dtype, const Args& p, void* stream) {
  if (p.S < 1 || p.B < 1 || p.H < 1 || (long long)p.S * ((p.B + 7) / 8) > INT32_MAX ||
      (p.H + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float, REV>(p, st);
    case 1: return (int)launch<double, REV>(p, st);
    case 2: return (int)launch<__nv_bfloat16, REV>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 bfloat16. Returns a cudaError_t.
extern "C" int lstm_step_forward(int dtype, const void* h, const void* wh, int S, int B, int H,
                                 const void* xg, long long xg_s, long long xg_b,
                                 const void* c_prev, void* h_out, void* c_out, void* ifgo,
                                 long long ifgo_g, void* stream) {
  Args p{};
  p.a = h;
  p.w = wh;
  p.S = S;
  p.B = B;
  p.H = H;
  p.xg = xg;
  p.xg_s = xg_s;
  p.xg_b = xg_b;
  p.c_prev = c_prev;
  p.h_out = h_out;
  p.c_out = c_out;
  p.ifgo = ifgo;
  p.ifgo_g = ifgo_g;
  return dispatch<false>(dtype, p, stream);
}

// mode 1: product and step t-1's deltas; 0: the product alone, into out
// (dh0); 2: step T-1's deltas alone (no product; da and wh unused).
extern "C" int lstm_step_reverse(int dtype, int mode, const void* da, const void* wh, int S,
                                 int B, int H, const void* dh, long long dh_s, long long dh_b,
                                 const void* c_tau, const void* c_before, const void* gates,
                                 long long gates_g, void* dc_next, void* out, void* stream) {
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  Args p{};
  p.a = da;
  p.w = wh;
  p.S = S;
  p.B = B;
  p.H = H;
  p.mode = mode;
  p.dh = dh;
  p.dh_s = dh_s;
  p.dh_b = dh_b;
  p.c_tau = c_tau;
  p.c_before = c_before;
  p.gates = gates;
  p.gates_g = gates_g;
  p.dc_next = dc_next;
  p.out = out;
  return dispatch<true>(dtype, p, stream);
}

// The tile lstm_step_* launches for S seeds of B rows and H units of
// `itemsize` bytes, with aligned operands (see pick_tile).
extern "C" int lstm_step_tile(int S, int B, int H, int itemsize, int reverse) {
  return pick_tile(S, B, H, ((long long)H * itemsize) % 16 == 0, reverse != 0);
}
