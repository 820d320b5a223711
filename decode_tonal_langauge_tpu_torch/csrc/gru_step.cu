// One GRU time step for sm_90a: the recurrent product fused with that
// step's gate arithmetic, forward and reverse, one launch a step, on the
// weight-streaming and GEMM tiles the LSTM step shares (step_tiles.cuh).
//
// Replaces no Pallas kernel: the JAX package has no GRU. The equations are
// torch.nn.GRU's, gate order r, z, n, with both biases:
//   gh = h W_hh^T + b_hh                 (the product, 3H columns)
//   r  = sigmoid(gx_r + gh_r), z = sigmoid(gx_z + gh_z)
//   n  = tanh(gx_n + r gh_n)
//   h' = (h - n) z + n                   (ATen's GRU cell's order)
// where gx = x W_ih^T + b_ih is the time-batched input projection. The
// candidate gate needs r (h W_hn + b_hn), so the third block of the
// product cannot be folded into gx as the LSTM's can.
//
// Forward step t (gru_step_forward): a block owns UN units J of one seed
// (a direction of a bidirectional layer: the seed axis S) and BM rows, and
// computes the three gate columns {J, H+J, 2H+J} of h[t-1] @ wt, wt = W_hh^T
// (S, H, 3H). Its epilogue adds b_hh and gx[t], applies the gates and
// writes h[t] and, when a gradient is to be taken, r, z, n and
// hn = gh_n into the caller's time-major stacks.
//
// Reverse step t (gru_step_reverse, mode 1): a block computes
// dh_next[:, J] = dgh[t] @ W_hh[:, J], i.e. rows J of wt, with dgh the
// deltas of the recurrent product's pre-activations, then for step
// tau = t - 1 forms dh = d_h[tau] + dh_next + carry, where carry =
// dh[t] z[t] is the direct path through h' = (h - n) z + n kept from the
// previous launch, and writes
//   dn = dh (1 - z), dz = dh (h[tau-1] - n)
//   da_n = dn (1 - n^2), da_r = da_n hn r (1 - r), da_z = dz z (1 - z)
//   dgx[tau] = (da_r, da_z, da_n), dgh[tau] = (da_r, da_z, da_n r)
// and carry = dh z. Mode 2 is the first delta, tau = T - 1, with no
// product (dh_next = carry = 0). h0 is zero (GRUDecoder's rule), so no dh0
// is formed.
//
// Tiles: as the LSTM's (pick_tile): up to 64 rows a seed stream the
// weights, more take the GEMM tile. The forward's thread tiles take 3
// columns (TN 3: one unit's three gates in the GEMM tile) where the LSTM's
// take 4; the reverse's are the LSTM's, over K = 3H.
//
// Precision: float32 products are FFMA (no TF32), float64 in double, and
// bf16 loads bf16 and sums in float32. Every epilogue operation is rounded
// to the storage type on its own in the order of the plain version
// (ops/gru.py: _step_plain and _delta): the product rounded to T, then
// b_hh added; gx plus that; each activation; r gh_n; (h - n) z + n. The
// only difference left from the plain version is the product's summation
// order.
//
// What bounds a step on an H100 (3.35 TB/s, 67 TFLOP/s f32): the GRU-CTC
// decoder's layers, 2 directions x 64 rows x H 1024: 25.2 MB of weights
// (7.5 us) against 0.81 GFLOP (12.0 us), the FLOPs.

#include "step_tiles.cuh"

namespace {

struct Args {
  const void* a;  // h[t-1] (S, B, H) or dgh[t] (S, B, 3H), contiguous
  const void* w;  // wt = W_hh^T (S, H, 3H), contiguous
  int S, B, H, mode;
  // forward epilogue
  const void* xg;  // gx[:, :, t]: (S, B, 3H), unit stride along 3H
  long long xg_s, xg_b;
  const void* bh;  // b_hh (S, 3H), contiguous
  void* h_out;     // (S, B, H)
  void* rzn;       // r, z, n, hn at step t: 4 slices (S, B, H), or null
  long long rzn_g;
  // reverse epilogue, step tau = t - 1
  const void* dh;  // d_h[tau]: (S, B, H), unit stride along H
  long long dh_s, dh_b;
  const void* h_before;  // h[tau - 1] (S, B, H)
  const void* gates;     // r, z, n, hn at tau, slice stride gates_g
  long long gates_g;
  void* carry;  // (S, B, H), read and written
  void* dgx;    // (S, B, 3H)
  void* dgh;    // (S, B, 3H)
};

// The epilogue of one (row r, unit j) pair of seed s from its product
// sums: the forward's three gate sums, or the reverse's dh_next (sum[0]).
struct GruCell {
  static constexpr int GATES = 3;
  using Args = ::Args;

  template <typename T, bool REV>
  static __device__ __forceinline__ void finish(const Args& p, int s, int r, int j,
                                                const typename Num<T>::V* sum) {
    using N = Num<T>;
    using V = typename Num<T>::V;
    const int B = p.B, H = p.H;
    const long long e = ((long long)s * B + r) * H + j;
    const V one = V(1);
    if constexpr (!REV) {
      const T* xr = static_cast<const T*>(p.xg) + s * p.xg_s + r * p.xg_b + j;
      const T* bh = static_cast<const T*>(p.bh) + (long long)s * 3 * H + j;
      const V ghr = N::add(N::rnd(sum[0]), N::ld(bh[0]));
      const V ghz = N::add(N::rnd(sum[1]), N::ld(bh[H]));
      const V ghn = N::add(N::rnd(sum[2]), N::ld(bh[2 * H]));
      const V gr = N::sig(N::add(N::ld(xr[0]), ghr));
      const V gz = N::sig(N::add(N::ld(xr[H]), ghz));
      const V gn = N::tnh(N::add(N::ld(xr[2 * H]), N::mul(gr, ghn)));
      const V hp = N::ld(static_cast<const T*>(p.a)[e]);
      const V h = N::add(N::mul(N::sub(hp, gn), gz), gn);
      static_cast<T*>(p.h_out)[e] = N::st(h);
      if (p.rzn != nullptr) {
        T* q = static_cast<T*>(p.rzn) + e;
        q[0] = N::st(gr);
        q[p.rzn_g] = N::st(gz);
        q[2 * p.rzn_g] = N::st(gn);
        q[3 * p.rzn_g] = N::st(ghn);
      }
    } else {
      const bool first = p.mode == 2;
      const V dh_next = first ? V(0) : N::rnd(sum[0]);
      const V carry = first ? V(0) : N::ld(static_cast<const T*>(p.carry)[e]);
      const V dh = N::add(
          N::add(N::ld(static_cast<const T*>(p.dh)[s * p.dh_s + r * p.dh_b + j]), dh_next), carry);
      const T* gt = static_cast<const T*>(p.gates) + e;
      const V gr = N::ld(gt[0]), gz = N::ld(gt[p.gates_g]);
      const V gn = N::ld(gt[2 * p.gates_g]), hn = N::ld(gt[3 * p.gates_g]);
      const V hb = N::ld(static_cast<const T*>(p.h_before)[e]);
      const V dn = N::mul(dh, N::sub(one, gz));
      const V dz = N::mul(dh, N::sub(hb, gn));
      const V dan = N::mul(dn, N::sub(one, N::mul(gn, gn)));
      const V dar = N::mul(N::mul(N::mul(dan, hn), gr), N::sub(one, gr));
      const V daz = N::mul(N::mul(dz, gz), N::sub(one, gz));
      const long long row = ((long long)s * B + r) * 3 * H + j;
      T* gx = static_cast<T*>(p.dgx) + row;
      T* gh = static_cast<T*>(p.dgh) + row;
      gx[0] = gh[0] = N::st(dar);
      gx[H] = gh[H] = N::st(daz);
      gx[2 * H] = N::st(dan);
      gh[2 * H] = N::st(N::mul(dan, gr));
      static_cast<T*>(p.carry)[e] = N::st(N::mul(dh, gz));
    }
  }
};

// The shared tiles (step_tiles.cuh) as this file's kernels.
template <typename T, bool REV, int BM, int UN, int TM, int TN, int KG, int BK, int ST>
__global__ void __launch_bounds__(THREADS, STREAM_MIN_BLOCKS) gru_stream_kernel(const Args p) {
  stream_tile<GruCell, T, REV, BM, UN, TM, TN, KG, BK, ST>(p);
}

template <typename T, bool REV, int BM, int UN, int TM, int TN, int BK, int VW>
__global__ void __launch_bounds__(THREADS, sizeof(T) > 4 ? 1 : GEMM_MIN_BLOCKS)
    gru_gemm_kernel(const Args p) {
  gemm_tile<GruCell, T, REV, BM, UN, TM, TN, BK, VW>(p);
}

template <typename T, bool REV, int BM, int UN, int TM, int TN, int KG, int BK, int ST>
cudaError_t launch_stream(const Args& p, cudaStream_t stream) {
  using P = Stream<T, REV, GruCell::GATES, BM, UN, TM, TN, KG, BK, ST>;
  return launch_kernel<P>(gru_stream_kernel<T, REV, BM, UN, TM, TN, KG, BK, ST>, p, BM, UN,
                          stream);
}

template <typename T, bool REV, int BM, int UN, int TM, int TN, int BK, int VW>
cudaError_t launch_gemm(const Args& p, cudaStream_t stream) {
  using P = Gemm<T, REV, GruCell::GATES, BM, UN, TM, TN, BK, VW>;
  return launch_kernel<P>(gru_gemm_kernel<T, REV, BM, UN, TM, TN, BK, VW>, p, BM, UN, stream);
}

// The tiles' shapes, as the LSTM's (lstm_step.cu) but for the forward's TN
// (3, a unit's gates): a streaming tile's BM, UN, TM, TN, KG, BK, stages,
// a GEMM tile's BM, UN, TM, TN, BK and its load width.
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
    if (tile == 0) return launch_stream<T, REV, 8, 16, 8, 3, 16, 64, 4>(p, stream);
    if (tile == 4) return launch_stream<T, REV, 8, WIDE_UNITS, 8, 3, 4, 16, 4>(p, stream);
    if (tile == 1) return launch_stream<T, REV, 32, 16, 8, 3, 4, 64, 3>(p, stream);
    if (tile == 2) return launch_gemm<T, REV, 128, 16, 8, 3, 16, VW>(p, stream);
    return launch_gemm<T, REV, 128, 16, 8, 3, 16, 1>(p, stream);
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
extern "C" int gru_step_forward(int dtype, const void* h, const void* wt, int S, int B, int H,
                                const void* xg, long long xg_s, long long xg_b, const void* bh,
                                void* h_out, void* rzn, long long rzn_g, void* stream) {
  Args p{};
  p.a = h;
  p.w = wt;
  p.S = S;
  p.B = B;
  p.H = H;
  p.xg = xg;
  p.xg_s = xg_s;
  p.xg_b = xg_b;
  p.bh = bh;
  p.h_out = h_out;
  p.rzn = rzn;
  p.rzn_g = rzn_g;
  return dispatch<false>(dtype, p, stream);
}

// mode 1: product and step t-1's deltas; 2: step T-1's deltas alone (no
// product; dgh_t and wt unused).
extern "C" int gru_step_reverse(int dtype, int mode, const void* dgh_t, const void* wt, int S,
                                int B, int H, const void* dh, long long dh_s, long long dh_b,
                                const void* h_before, const void* gates, long long gates_g,
                                void* carry, void* dgx, void* dgh, void* stream) {
  if (mode != 1 && mode != 2) return (int)cudaErrorInvalidValue;
  Args p{};
  p.a = dgh_t;
  p.w = wt;
  p.S = S;
  p.B = B;
  p.H = H;
  p.mode = mode;
  p.dh = dh;
  p.dh_s = dh_s;
  p.dh_b = dh_b;
  p.h_before = h_before;
  p.gates = gates;
  p.gates_g = gates_g;
  p.carry = carry;
  p.dgx = dgx;
  p.dgh = dgh;
  return dispatch<true>(dtype, p, stream);
}

// The tile gru_step_* launches for S seeds of B rows and H units of
// `itemsize` bytes, with aligned operands (see pick_tile).
extern "C" int gru_step_tile(int S, int B, int H, int itemsize, int reverse) {
  return pick_tile(S, B, H, ((long long)H * itemsize) % 16 == 0, reverse != 0);
}
