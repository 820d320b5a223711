"""The LSTM's sequence and step ops (``ops/lstm.py``) and their sm_90a
kernels (``csrc/lstm_step.cu``).

On the CPU the ops run their plain versions: these are held against the
loops they replaced (copied below as they were), bit for bit; vmap over
the sequence ops against one call a seed (an unbatched weight for the
GRU's forward scan too: the rule is ``ops/recurrence.py``'s); ``gradcheck``
in float64.

On a card (tests marked ``cuda``, skipped without one) the kernels are
held against the plain versions run on the same card, over the shapes the
tile choice branches on: H in {64, 512, 800, 2640}, rows a seed in {1, 8,
32, 596}, 1 and 4 seeds, float32, float64 and bfloat16, a few steps each,
and the launch counters must equal the steps run (the first delta's, one a
reverse loop); then ragged shapes:
rows that take two tiles, H whose rows are not 16-byte aligned. Tolerances (absolute,
values O(1)): the two differ only in the recurrent products' summation
order, so float64 1e-12; float32 5e-5 (sums of up to 4H = 10,560 products
in another order, carried over 3 steps); bfloat16 2**-5, four roundings
of values up to 2 (a product on the other side of a bf16 rounding edge
moves the gates, c and h by one bf16 step each).

This file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_lstm_step.py
"""

import numpy as np
import pytest
import torch

from decode_tonal_langauge_tpu_torch import _build
from decode_tonal_langauge_tpu_torch.ops import gru, lstm, recurrence


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# -- the loops the ops replaced, as they were -------------------------------

def _replaced_scan(xg, h, c, wh):
    """The forward loop the ops replaced: xg (B, T, 4H)."""
    hs, saved = [], []
    for t in range(xg.shape[1]):
        gates = xg[:, t] + h @ wh
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        saved.append((c, i, f, g, o))
    return torch.stack(hs, dim=1), [torch.stack(s) for s in zip(*saved)]


def _replaced_reverse(d_hs, wh, h0, c0, cs, i, f, g, o):
    """The reverse loop the ops replaced: time-major (T, B, H) inputs."""
    n_t = cs.shape[0]
    wh_t = wh.t()
    das = []
    dh_next = torch.zeros_like(h0)
    dc_next = torch.zeros_like(c0)
    for t in range(n_t - 1, -1, -1):
        dh = d_hs[t] + dh_next
        tc = torch.tanh(cs[t])
        dc = dh * o[t] * (1.0 - tc * tc) + dc_next
        cp = cs[t - 1] if t else c0
        da = torch.cat([dc * g[t] * i[t] * (1.0 - i[t]),
                        dc * cp * f[t] * (1.0 - f[t]),
                        dc * i[t] * (1.0 - g[t] * g[t]),
                        dh * tc * o[t] * (1.0 - o[t])], dim=-1)
        das.append(da)
        dh_next = da @ wh_t
        dc_next = dc * f[t]
    return torch.stack(das[::-1]), dh_next, dc_next


def _inputs(seeds, rows, steps, hid, dtype, device="cpu", seed=0):
    """xg (S, B, T, 4H), h0, c0 (S, B, H), wh (S, H, 4H), d_hs (T, S, B, H):
    seeded, weights at the LSTM's init scale, O(1) gates."""
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape)).to(device, dtype)

    return (draw(seeds, rows, steps, 4 * hid, scale=0.5), draw(seeds, rows, hid, scale=0.3),
            draw(seeds, rows, hid, scale=0.3), draw(seeds, hid, 4 * hid, scale=hid ** -0.5),
            draw(steps, seeds, rows, hid))


# -- CPU: the plain versions ------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 6), (1, 4, 10), (2, 1, 3)])
def test_scan_equals_replaced_loop(dtype, shape):
    """The forward op on one seed equals the loop it replaced, bit for bit
    (in bf16 too: it rounds where that loop rounds)."""
    rows, steps, hid = shape
    xg, h0, c0, wh, _ = _inputs(1, rows, steps, hid, dtype)
    hs, cs, ifgo = lstm.lstm_scan(xg, h0, c0, wh, True)
    out, (cs_r, *gates) = _replaced_scan(xg[0], h0[0], c0[0], wh[0])
    assert torch.equal(hs[:, 0].transpose(0, 1), out)
    assert torch.equal(cs[:, 0], cs_r)
    assert torch.equal(ifgo[:, :, 0], torch.stack(gates))
    hs_plain = lstm.lstm_scan(xg, h0, c0, wh, False)[0]
    assert torch.equal(hs_plain, hs)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 6), (1, 4, 10), (2, 1, 3)])
def test_reverse_equals_replaced_loop(dtype, shape):
    """The epilogue-ordered reverse loop (delta of step t-1 formed right
    after step t's product) equals the loop it replaced, bit for bit."""
    rows, steps, hid = shape
    xg, h0, c0, wh, d_hs = _inputs(1, rows, steps, hid, dtype)
    _, cs, ifgo = lstm.lstm_scan(xg, h0, c0, wh, True)
    das, dh0, dc0 = lstm.lstm_scan_backward(d_hs, wh, c0, cs, ifgo)
    want = _replaced_reverse(d_hs[:, 0], wh[0], h0[0], c0[0], cs[:, 0], *ifgo[:, :, 0])
    assert torch.equal(das[:, 0], want[0])
    assert torch.equal(dh0[0], want[1])
    assert torch.equal(dc0[0], want[2])


@pytest.mark.parametrize("keep", [True, False])
def test_vmap_over_three_seeds_equals_three_calls(keep):
    """vmap of the sequence ops over 3 seeds (each call with its own seed
    axis of 2) equals one call a seed: the rules fold vmap's dimension
    into the seed axis."""
    dtype = torch.float64
    xg, h0, c0, wh, d_hs = _inputs(6, 3, 4, 5, dtype)
    fold = lambda x, d=0: x.unflatten(d, (3, 2))  # noqa: E731
    got = torch.func.vmap(lambda *a: lstm.lstm_scan(*a, keep))(
        fold(xg), fold(h0), fold(c0), fold(wh))
    assert got[0].shape == (3, 4, 2, 3, 5)
    for k in range(3):
        one = lstm.lstm_scan(xg[2 * k:2 * k + 2], h0[2 * k:2 * k + 2], c0[2 * k:2 * k + 2],
                             wh[2 * k:2 * k + 2], keep)
        assert torch.equal(got[0][k], one[0]) and torch.equal(got[1][k], one[1])
        if keep:
            assert torch.equal(got[2][k], one[2])
    if not keep:
        return
    _, cs, ifgo = lstm.lstm_scan(xg, h0, c0, wh, True)
    back = torch.func.vmap(lstm.lstm_scan_backward, in_dims=(1, 0, 0, 1, 2))(
        fold(d_hs, 1), fold(wh), fold(c0), fold(cs, 1), fold(ifgo, 2))
    for k in range(3):
        sl = slice(2 * k, 2 * k + 2)
        one = lstm.lstm_scan_backward(d_hs[:, sl], wh[sl], c0[sl], cs[:, sl], ifgo[:, :, sl])
        assert torch.equal(back[0][k], one[0])
        assert torch.equal(back[1][k], one[1]) and torch.equal(back[2][k], one[2])


@pytest.mark.parametrize("recurrence", ["lstm_scan", "gru_scan"])
def test_vmap_unbatched_weight_is_broadcast(recurrence):
    """A weight vmap does not batch is read by every seed: the seed-axis
    rule of ``ops/recurrence.py``, which both recurrences' scans share."""
    xg, h0, c0, wh, _ = _inputs(3, 2, 3, 4, torch.float64)
    if recurrence == "lstm_scan":
        batched, weights = (xg, h0, c0), (wh[:1],)
        scan = lambda *a: lstm.lstm_scan(*a, False)[0]  # noqa: E731
    else:  # xg (S, B, T, 3H), wt (S, H, 3H), bh (S, 3H)
        batched, weights = (xg[..., :12],), (wh[:1, :, :12], h0[:1, 0].repeat(1, 3))
        scan = lambda *a: gru.gru_scan(*a, False)[0]  # noqa: E731
    got = torch.func.vmap(lambda *b: scan(*b, *weights))(*(x[:, None] for x in batched))
    want = scan(*batched, *(w.expand(3, *w.shape[1:]) for w in weights))
    assert torch.equal(got[:, :, 0], want.transpose(0, 1))


def test_seed_batched_grad_equals_each_seed():
    """vmap(grad) of an LSTM loss over 3 seeds, as the seed stack runs it,
    equals each seed's own grad."""
    torch.manual_seed(0)
    n, b, t, i, hid = 3, 2, 4, 3, 5
    wi, wh, bias = (torch.randn(n, *s, dtype=torch.float64) * 0.4
                    for s in ((i, 4 * hid), (hid, 4 * hid), (4 * hid,)))
    x = torch.randn(n, b, t, i, dtype=torch.float64)

    def loss(wi, wh, bias, x):
        h0 = x.new_zeros((b, hid))
        return lstm.lstm_sequence(x, h0, h0, wi, wh, bias)[:, -1].square().sum()

    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(wi, wh, bias, x)
    for k in range(n):
        one = torch.func.grad(loss, argnums=(0, 1, 2))(wi[k], wh[k], bias[k], x[k])
        for got, want in zip(grads, one):
            torch.testing.assert_close(got[k], want, rtol=0, atol=1e-13)


def test_gradcheck_float64():
    torch.manual_seed(1)
    b, t, i, hid = 2, 3, 3, 4
    args = [torch.randn(*s, dtype=torch.float64) * 0.5
            for s in ((b, t, i), (b, hid), (b, hid), (i, 4 * hid), (hid, 4 * hid), (4 * hid,))]
    args = [a.requires_grad_() for a in args]
    assert torch.autograd.gradcheck(lstm.lstm_sequence, args, eps=1e-6, atol=1e-7)


def test_bf16_sequence_rounds_where_replaced_loop_does():
    """Values and gradients of a bf16 ``lstm_sequence`` equal the replaced
    forward and reverse loops' in bf16, bit for bit."""
    torch.manual_seed(2)
    b, t, i, hid = 3, 6, 4, 8
    bf = torch.bfloat16
    x = torch.randn(b, t, i).to(bf).requires_grad_()
    wi = (torch.randn(i, 4 * hid) * 0.5).to(bf).requires_grad_()
    wh = (torch.randn(hid, 4 * hid) * 0.3).to(bf).requires_grad_()
    bias = (torch.randn(4 * hid) * 0.1).to(bf).requires_grad_()
    h0 = torch.zeros(b, hid, dtype=bf)
    y = lstm.lstm_sequence(x, h0, h0, wi, wh, bias)
    d_out = torch.randn(b, t, hid).to(bf)
    grads = torch.autograd.grad(y, (x, wi, wh, bias), d_out)
    with torch.no_grad():
        xg = torch.einsum("bti,ih->bth", x, wi) + bias
        out, (cs, gi, gf, gg, go) = _replaced_scan(xg, h0, h0, wh)
        das, _, _ = _replaced_reverse(d_out.transpose(0, 1), wh, h0, h0, cs, gi, gf, gg, go)
        da_flat = das.reshape(t * b, 4 * hid)
        h_prev = torch.cat([h0[None], out.transpose(0, 1)[:-1]], dim=0)
        want = ((das @ wi.t()).transpose(0, 1), x.transpose(0, 1).reshape(t * b, -1).t() @ da_flat,
                h_prev.reshape(t * b, hid).t() @ da_flat, da_flat.sum(dim=0))
    assert torch.equal(y, out)
    for got, w in zip(grads, want):
        assert got.dtype == bf and torch.equal(got, w)


def test_step_ops_run_the_plain_steps_on_cpu():
    """On CPU tensors the step ops are the plain steps, and no kernel is
    counted."""
    xg, h0, c0, wh, d_hs = _inputs(2, 3, 1, 4, torch.float32)
    before = (lstm.FORWARD_LAUNCHES, lstm.REVERSE_LAUNCHES, lstm.DELTA_LAUNCHES)
    outs = [torch.empty_like(h0) for _ in range(4)]
    gates = [torch.empty((4,) + h0.shape) for _ in range(2)]
    torch.ops.tonal.lstm_step(h0, wh, xg[:, :, 0], c0, outs[0], outs[1], gates[0], True)
    lstm._step_plain(h0, wh, xg[:, :, 0], c0, outs[2], outs[3], gates[1], True)
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    assert torch.equal(gates[0], gates[1])
    d_h = d_hs[0]
    dcs = [torch.zeros_like(c0) for _ in range(2)]
    das = [torch.empty(h0.shape[:2] + (4 * h0.shape[2],)) for _ in range(2)]
    torch.ops.tonal.lstm_delta_init(d_h, outs[1], c0, gates[0], dcs[0], das[0])
    lstm._delta_init_plain(d_h, outs[1], c0, gates[0], dcs[1], das[1])
    assert torch.equal(das[0], das[1]) and torch.equal(dcs[0], dcs[1])
    assert (lstm.FORWARD_LAUNCHES, lstm.REVERSE_LAUNCHES, lstm.DELTA_LAUNCHES) == before


def test_kernel_boundary_raises_with_what_failed():
    """The checks every kernel's launch passes through (``_build.py``,
    ``ops/recurrence.py``): operands the kernels do not take, and a launch
    that returned a CUDA error, named with the launch and its sizes."""
    xg, h0, c0, wh, _ = _inputs(1, 2, 1, 4, torch.float32)
    with pytest.raises(ValueError, match="^lstm step kernel: every operand on one CUDA device$"):
        recurrence.kernel_dtype("lstm step kernel", h0, wh, c0)
    with pytest.raises(TypeError, match="^gru step kernel: float32, float64 or bfloat16"):
        recurrence.kernel_dtype("gru step kernel", h0, wh.half())
    _build.launched(0, "lstm_step forward", "S, B, H = {}", (1, 2, 4))
    with pytest.raises(RuntimeError, match=r"^lstm_step forward launch failed: cudaError_t 700 "
                                           r"\(S, B, H = \(1, 2, 4\)\)$"):
        _build.launched(700, "lstm_step forward", "S, B, H = {}", (1, 2, 4))


# -- the card: kernels against the plain versions ---------------------------

TOL = {torch.float64: 1e-12, torch.float32: 5e-5, torch.bfloat16: 2.0 ** -5}
STEPS = 3


def _max_gap(got, want) -> float:
    return max((g.double() - w.double()).abs().max().item() for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("seeds", [1, 4])
@pytest.mark.parametrize("rows", [1, 8, 32, 596])
@pytest.mark.parametrize("hid", [64, 512, 800, 2640])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_kernels_equal_plain_on_card(card, dtype, hid, rows, seeds):
    xg, h0, c0, wh, d_hs = _inputs(seeds, rows, STEPS, hid, dtype, card, seed=hid + rows)
    fwd, rev, first = lstm.FORWARD_LAUNCHES, lstm.REVERSE_LAUNCHES, lstm.DELTA_LAUNCHES
    got = lstm.lstm_scan(xg, h0, c0, wh, True)
    back = lstm.lstm_scan_backward(d_hs, wh, c0, got[1], got[2])
    serve = lstm.lstm_scan(xg, h0, c0, wh, False)
    torch.cuda.synchronize()
    assert lstm.FORWARD_LAUNCHES - fwd == 2 * STEPS
    assert lstm.REVERSE_LAUNCHES - rev == STEPS
    assert lstm.DELTA_LAUNCHES - first == 1
    want = lstm.lstm_scan_plain(xg, h0, c0, wh, True)
    want_back = lstm.lstm_scan_backward_plain(d_hs, wh, c0, got[1], got[2])
    tol = TOL[dtype]
    assert _max_gap(got, want) <= tol
    assert _max_gap(serve[:1], want[:1]) <= tol
    assert torch.equal(serve[0], got[0])
    assert _max_gap(back, want_back) <= tol * 4  # deltas scale with d_hs, O(1) to 4


@pytest.mark.cuda
@pytest.mark.parametrize("seeds", [1, 3])
@pytest.mark.parametrize("hid, rows", [(64, 48), (66, 8), (10, 1), (66, 100), (200, 64), (66, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_kernels_ragged_on_card(card, dtype, hid, rows, seeds):
    """Rows that take two tiles of the streaming kernel (48), and H whose
    rows are not 16-byte aligned (the GEMM tile with one-element loads)."""
    xg, h0, c0, wh, d_hs = _inputs(seeds, rows, STEPS, hid, dtype, card, seed=hid * rows)
    got = lstm.lstm_scan(xg, h0, c0, wh, True)
    back = lstm.lstm_scan_backward(d_hs, wh, c0, got[1], got[2])
    want = lstm.lstm_scan_plain(xg, h0, c0, wh, True)
    want_back = lstm.lstm_scan_backward_plain(d_hs, wh, c0, got[1], got[2])
    assert _max_gap(got, want) <= TOL[dtype]
    assert _max_gap(back, want_back) <= TOL[dtype] * 4


@pytest.mark.cuda
def test_seed_batched_grad_on_card(card):
    """vmap(grad) of an LSTM loss over 3 seeds through the kernels equals
    the same on the CPU (plain versions) in float64."""
    torch.manual_seed(3)
    n, b, t, i, hid = 3, 5, 7, 6, 64
    params = [torch.randn(n, *s, dtype=torch.float64) * 0.3
              for s in ((i, 4 * hid), (hid, 4 * hid), (4 * hid,))]
    x = torch.randn(n, b, t, i, dtype=torch.float64)

    def loss(wi, wh, bias, x):
        h0 = x.new_zeros((b, hid))
        return lstm.lstm_sequence(x, h0, h0, wi, wh, bias)[:, -1].square().sum()

    run = torch.func.vmap(torch.func.grad_and_value(loss, argnums=(0, 1, 2)))
    before = (lstm.FORWARD_LAUNCHES, lstm.REVERSE_LAUNCHES, lstm.DELTA_LAUNCHES)
    got = run(*(p.to(card) for p in params), x.to(card))
    torch.cuda.synchronize()
    after = (lstm.FORWARD_LAUNCHES, lstm.REVERSE_LAUNCHES, lstm.DELTA_LAUNCHES)
    assert tuple(a - b for a, b in zip(after, before)) == (t, t, 1)
    want = run(*params, x)
    for g, w in zip(got[0] + (got[1],), want[0] + (want[1],)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-12)


@pytest.mark.cuda
def test_kernel_refuses_float16(card):
    xg, h0, c0, wh, _ = _inputs(1, 2, 2, 8, torch.float16, card)
    with pytest.raises(TypeError):
        lstm.lstm_scan(xg, h0, c0, wh, False)
