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
// Tiles follow the shape (pick_tile, step_tiles.cuh, shared with the GRU
// step of gru_step.cu): the rows a seed B, and S x H for one choice. No
// tile is chosen by a model's name.
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

#include "step_tiles.cuh"

namespace {

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

// The epilogue of one (row r, unit j) pair of seed s from its product
// sums: the forward's four gate sums, or the reverse's dh_next (sum[0]).
struct LstmCell {
  static constexpr int GATES = 4;
  using Args = ::Args;

  template <typename T, bool REV>
  static __device__ __forceinline__ void finish(const Args& p, int s, int r, int j,
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
};

// The shared tiles (step_tiles.cuh) as this file's kernels.
template <typename T, bool REV, int BM, int UN, int TM, int TN, int KG, int BK, int ST>
__global__ void __launch_bounds__(THREADS, STREAM_MIN_BLOCKS) lstm_stream_kernel(const Args p) {
  stream_tile<LstmCell, T, REV, BM, UN, TM, TN, KG, BK, ST>(p);
}

template <typename T, bool REV, int BM, int UN, int TM, int TN, int BK, int VW>
__global__ void __launch_bounds__(THREADS, sizeof(T) > 4 ? 1 : GEMM_MIN_BLOCKS)
    lstm_gemm_kernel(const Args p) {
  gemm_tile<LstmCell, T, REV, BM, UN, TM, TN, BK, VW>(p);
}

template <typename T, bool REV, int BM, int UN, int TM, int TN, int KG, int BK, int ST>
cudaError_t launch_stream(const Args& p, cudaStream_t stream) {
  using P = Stream<T, REV, LstmCell::GATES, BM, UN, TM, TN, KG, BK, ST>;
  return launch_kernel<P>(lstm_stream_kernel<T, REV, BM, UN, TM, TN, KG, BK, ST>, p, BM, UN,
                          stream);
}

template <typename T, bool REV, int BM, int UN, int TM, int TN, int BK, int VW>
cudaError_t launch_gemm(const Args& p, cudaStream_t stream) {
  using P = Gemm<T, REV, LstmCell::GATES, BM, UN, TM, TN, BK, VW>;
  return launch_kernel<P>(lstm_gemm_kernel<T, REV, BM, UN, TM, TN, BK, VW>, p, BM, UN, stream);
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
  if (!launchable(p)) return (int)cudaErrorInvalidValue;
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
