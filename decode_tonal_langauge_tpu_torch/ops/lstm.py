"""Time-batched LSTM: one matmul for every input projection, a recurrence
of one fused step a time step, and a hand-written backward.

Counterpart of ``decode_tonal_langauge_tpu/ops/lstm.py``. Gate math is
Flax's ``OptimizedLSTMCell``: gate order i, f, g, o, sigmoid i/f/o, tanh
g, and a single bias on the hidden projection. ``torch.nn.LSTM`` carries
two biases and another gate order, hence this module.

The backward (:class:`LSTMSequence`, a ``torch.autograd.Function``) is the
JAX package's ``custom_vjp``: the forward keeps ``h``, ``c`` and the four
gates of every step; a reverse loop carries only ``(dh, dc)`` and stacks
the pre-activation gate deltas ``da``; the weight and input gradients are
then time-batched matmuls over the stacked ``(T*B, 4H)`` deltas, so no
weight-gradient accumulator runs through the loop. Without a gradient to
take (serving), the forward keeps nothing but ``h``.

The two loops are ``torch.library`` ops over a whole sequence,
``tonal::lstm_scan`` and ``tonal::lstm_scan_backward``, on tensors with an
explicit leading seed axis S: ``xg`` (S, B, T, 4H), ``wh`` (S, H, 4H),
time-major stacks (T, S, B, H), with the vmap rule, device guard and
Meta implementation of ``ops/recurrence.py`` (vmap's dimension folded
into S). Inside, each time step is one op:

- ``tonal::lstm_step(h, wh, xg_t, c, h_out, c_out, ifgo_t, keep)``:
  ``h`` (S, B, H), ``wh`` (S, H, 4H); writes ``h_t``, ``c_t`` and (with
  ``keep``) the gates i, f, g, o into the stacks;
- ``tonal::lstm_step_backward(da_t, wh_t, d_h, c, c_before, ifgo, dc_next,
  out, epilogue)``: ``da_t`` (S, B, 4H), ``wh_t`` the (S, 4H, H) view of
  ``wh``; computes ``dh_next = da_t @ wh_t`` and, with ``epilogue``, step
  t-1's deltas into ``out`` and ``dc f`` into ``dc_next``; without, writes
  ``dh_next`` (dh0) into ``out``;
- ``tonal::lstm_delta_init(d_h, c, c_before, ifgo, dc_next, out)``: the
  first delta, step T-1's, with no product.

On a CUDA tensor a step op launches the hand-written sm_90a kernel of
``csrc/lstm_step.cu`` (built and bound with ``ctypes`` by ``_build.py``) or
raises; on a CPU tensor it runs the plain version (:func:`_step_plain`,
:func:`_step_backward_plain`, :func:`_delta_init_plain`), whose
arithmetic is the kernel's, in its order. :func:`lstm_scan_plain` and
:func:`lstm_scan_backward_plain` run the plain steps on any device (the
card's tests compare the two there). ``FORWARD_LAUNCHES`` and
``REVERSE_LAUNCHES`` count the kernels of forward and reverse steps, one a
time step each; ``DELTA_LAUNCHES`` counts the first deltas' kernels, one a
reverse loop.

A compute ``dtype`` (bfloat16) runs the projections, the recurrence, the
cell state and the gates in that dtype, as JAX's ``TimeBatchedLSTM``
does: every op of a step rounds to bf16 where the plain version makes a
bf16 tensor, and the recurrent products sum in float32. The weight
gradients are bf16 matmuls and a bf16 sum, which accumulate in float32
and round once to bf16, JAX's ``preferred_element_type=float32`` rule:
ATen's reductions and oneDNN's GEMMs always do, cuBLAS does under
``runtime.device.exact_f32`` (its ``f32_accumulation``), which every
train step opens.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor, nn

from .._build import I32, I64, PTR, launched, library, stream
from ..runtime.profiling import span
from .recurrence import kernel_dtype, scan_op, step_op

FORWARD_LAUNCHES = 0  # forward step kernels launched, one a time step
REVERSE_LAUNCHES = 0  # reverse step kernels launched, one a time step
DELTA_LAUNCHES = 0  # first-delta kernels launched, one a reverse loop


# -- the plain versions: the ops' CPU implementation ------------------------

def _matmul(a, b):
    """``a @ b`` over the seed axis; one seed as a plain GEMM, the product
    an unbatched LSTM has always taken."""
    return torch.matmul(a[0], b[0])[None] if a.shape[0] == 1 else torch.matmul(a, b)


def _step_plain(h, wh, xg_t, c, h_out, c_out, ifgo_t, keep):
    """One forward step: the kernel's arithmetic in plain torch."""
    gates = xg_t + _matmul(h, wh)
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c_new = f * c + i * g
    h_out.copy_(o * torch.tanh(c_new))
    c_out.copy_(c_new)
    if keep:
        for dst, src in zip(ifgo_t, (i, f, g, o)):
            dst.copy_(src)


def _delta(dh, dc_next, c, c_before, ifgo):
    """Step tau's pre-activation gate deltas (gate order i, f, g, o) and
    ``dc f``, from ``dh`` = d_h[tau] + dh_next."""
    i, f, g, o = ifgo.unbind(0)
    tc = torch.tanh(c)
    dc = dh * o * (1.0 - tc * tc) + dc_next
    da = torch.cat([dc * g * i * (1.0 - i),
                    dc * c_before * f * (1.0 - f),
                    dc * i * (1.0 - g * g),
                    dh * tc * o * (1.0 - o)], dim=-1)
    return da, dc * f


def _delta_init_plain(d_h, c, c_before, ifgo, dc_next, out):
    zeros = torch.zeros_like(d_h)
    da, dcf = _delta(d_h + zeros, zeros, c, c_before, ifgo)
    out.copy_(da)
    dc_next.copy_(dcf)


def _step_backward_plain(da_t, wh_t, d_h, c, c_before, ifgo, dc_next, out, epilogue):
    dh_next = _matmul(da_t, wh_t)
    if not epilogue:
        out.copy_(dh_next)
        return
    da, dcf = _delta(d_h + dh_next, dc_next, c, c_before, ifgo)
    out.copy_(da)
    dc_next.copy_(dcf)


# -- the kernels' wrappers --------------------------------------------------

_library = library("lstm_step", {
    "lstm_step_forward": (I32, PTR, PTR, I32, I32, I32, PTR, I64, I64, PTR, PTR, PTR, PTR, I64,
                          PTR),
    "lstm_step_reverse": (I32, I32, PTR, PTR, I32, I32, I32, PTR, I64, I64, PTR, PTR, PTR, I64,
                          PTR, PTR, PTR),
    "lstm_step_tile": (I32,) * 5,
})


def _step_cuda(h, wh, xg_t, c, h_out, c_out, ifgo_t, keep):
    global FORWARD_LAUNCHES
    code = kernel_dtype("lstm step kernel", h, wh, xg_t, c, h_out, c_out, ifgo_t)
    s, b, hid = h.shape
    if not (h.is_contiguous() and wh.is_contiguous() and c.is_contiguous()
            and h_out.is_contiguous() and c_out.is_contiguous()
            and wh.shape == (s, hid, 4 * hid) and xg_t.shape == (s, b, 4 * hid)
            and xg_t.stride(2) == 1 and c.shape == h.shape == h_out.shape == c_out.shape):
        raise ValueError("lstm_step: h, c, h_out, c_out (S, B, H) and wh (S, H, 4H) "
                         "contiguous, xg_t (S, B, 4H) with unit stride along 4H")
    if keep and not (ifgo_t.shape == (4, s, b, hid) and ifgo_t[0].is_contiguous()):
        raise ValueError("lstm_step: ifgo_t (4, S, B, H), each gate contiguous")
    err = _library().lstm_step_forward(
        code, h.data_ptr(), wh.data_ptr(), s, b, hid,
        xg_t.data_ptr(), xg_t.stride(0), xg_t.stride(1), c.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr(),
        ifgo_t.data_ptr() if keep else None, ifgo_t.stride(0) if keep else 0, stream(h))
    launched(err, "lstm_step forward", "S, B, H = {}", (s, b, hid))
    FORWARD_LAUNCHES += 1


def _reverse_checks(d_h, c, c_before, ifgo, dc_next, out, da_shape) -> None:
    shape = c.shape
    if not (c.is_contiguous() and c_before.is_contiguous() and dc_next.is_contiguous()
            and out.is_contiguous() and c_before.shape == dc_next.shape == d_h.shape == shape
            and d_h.stride(2) == 1 and ifgo.shape == (4,) + shape and ifgo[0].is_contiguous()
            and out.shape == da_shape):
        raise ValueError("lstm_step_backward: c, c_before, dc_next contiguous (S, B, H), d_h "
                         "(S, B, H) with unit stride along H, ifgo (4, S, B, H), out "
                         f"{tuple(da_shape)} contiguous")


def _delta_init_cuda(d_h, c, c_before, ifgo, dc_next, out):
    global DELTA_LAUNCHES
    code = kernel_dtype("lstm step kernel", d_h, c, c_before, ifgo, dc_next, out)
    s, b, hid = c.shape
    _reverse_checks(d_h, c, c_before, ifgo, dc_next, out, (s, b, 4 * hid))
    err = _library().lstm_step_reverse(
        code, 2, None, None, s, b, hid, d_h.data_ptr(), d_h.stride(0), d_h.stride(1),
        c.data_ptr(), c_before.data_ptr(), ifgo.data_ptr(), ifgo.stride(0),
        dc_next.data_ptr(), out.data_ptr(), stream(c))
    launched(err, "lstm_step first delta", "S, B, H = {}", (s, b, hid))
    DELTA_LAUNCHES += 1


def _step_backward_cuda(da_t, wh_t, d_h, c, c_before, ifgo, dc_next, out, epilogue):
    global REVERSE_LAUNCHES
    code = kernel_dtype("lstm step kernel", da_t, wh_t, d_h, c, c_before, ifgo, dc_next, out)
    s, b, g4 = da_t.shape
    hid = g4 // 4
    if not (da_t.is_contiguous() and wh_t.shape == (s, g4, hid)
            and wh_t.stride() == (hid * g4, 1, g4)):
        raise ValueError("lstm_step_backward: da_t (S, B, 4H) contiguous, wh_t the "
                         "(S, 4H, H) transpose of a contiguous wh")
    if epilogue:
        _reverse_checks(d_h, c, c_before, ifgo, dc_next, out, (s, b, g4))
        args = (d_h.data_ptr(), d_h.stride(0), d_h.stride(1), c.data_ptr(),
                c_before.data_ptr(), ifgo.data_ptr(), ifgo.stride(0), dc_next.data_ptr())
    else:
        if not (out.is_contiguous() and out.shape == (s, b, hid)):
            raise ValueError("lstm_step_backward: out (S, B, H) contiguous")
        args = (None, 0, 0, None, None, None, 0, None)
    err = _library().lstm_step_reverse(
        code, 1 if epilogue else 0, da_t.data_ptr(), wh_t.data_ptr(), s, b, hid, *args,
        out.data_ptr(), stream(da_t))
    launched(err, "lstm_step reverse", "S, B, H = {}", (s, b, hid))
    REVERSE_LAUNCHES += 1


def step_tile(seeds: int, rows: int, hid: int, reverse: bool = False,
              dtype: torch.dtype = torch.float32) -> int:
    """The kernel's tile for ``seeds`` x ``rows`` rows and ``hid`` units:
    0 and 1 stream the weights (up to 8 and up to 64 rows a seed), 4 is the
    forward's wide streaming tile (up to 8 rows, where its blocks still
    fill the card), 2 the GEMM tile, 3 the GEMM tile for rows that are not
    16-byte aligned."""
    size = torch.empty((), dtype=dtype).element_size()
    return _library().lstm_step_tile(seeds, rows, hid, size, int(reverse))


step_op("lstm_step(Tensor h, Tensor wh, Tensor xg_t, Tensor c, Tensor(a!) h_out, "
        "Tensor(b!) c_out, Tensor(c!) ifgo_t, bool keep) -> ()", _step_plain, _step_cuda)
step_op("lstm_step_backward(Tensor da_t, Tensor wh_t, Tensor d_h, Tensor c, "
        "Tensor c_before, Tensor ifgo, Tensor(a!) dc_next, Tensor(b!) out, "
        "bool epilogue) -> ()", _step_backward_plain, _step_backward_cuda)
step_op("lstm_delta_init(Tensor d_h, Tensor c, Tensor c_before, Tensor ifgo, "
        "Tensor(a!) dc_next, Tensor(b!) out) -> ()", _delta_init_plain, _delta_init_cuda)


# -- the sequence loops -----------------------------------------------------

def _scan(xg, h0, c0, wh, keep, step):
    """The forward recurrence over ``xg`` (S, B, T, 4H), the input
    projections plus bias: time-major stacks of h (T, S, B, H), c (T of
    them with ``keep``, else the last two) and the gates (4, T, S, B, H;
    with ``keep``, else empty)."""
    s, b, n_t, g4 = xg.shape
    hid = g4 // 4
    h0, c0, wh = h0.contiguous(), c0.contiguous(), wh.contiguous()
    hs = xg.new_empty((n_t, s, b, hid))
    cs = xg.new_empty((n_t if keep else 2, s, b, hid))
    ifgo = xg.new_empty((4, n_t, s, b, hid) if keep else (0,))
    h, c = h0, c0
    for t in range(n_t):
        c_t = cs[t if keep else t % 2]
        step(h, wh, xg[:, :, t], c, hs[t], c_t, ifgo[:, t] if keep else ifgo, keep)
        h, c = hs[t], c_t
    return hs, cs, ifgo


def _scan_backward(d_hs, wh, c0, cs, ifgo, step, init):
    """The reverse loop: ``d_hs`` (T, S, B, H) the hidden sequence's
    gradient; returns the deltas (T, S, B, 4H), dh0 and dc0 (S, B, H)."""
    n_t, s, b, hid = cs.shape
    if d_hs.stride(-1) != 1:
        d_hs = d_hs.contiguous()
    wh_t = wh.contiguous().transpose(1, 2)
    c0 = c0.contiguous()
    das = cs.new_empty((n_t, s, b, 4 * hid))
    dc = cs.new_empty((s, b, hid))
    dh0 = cs.new_empty((s, b, hid))

    def before(t):
        return cs[t - 1] if t else c0

    last = n_t - 1
    init(d_hs[last], cs[last], before(last), ifgo[:, last], dc, das[last])
    for t in range(last, 0, -1):
        step(das[t], wh_t, d_hs[t - 1], cs[t - 1], before(t - 1), ifgo[:, t - 1], dc,
             das[t - 1], True)
    step(das[0], wh_t, d_hs[0], cs[0], c0, ifgo[:, 0], dc, dh0, False)
    return das, dh0, dc


def lstm_scan_plain(xg, h0, c0, wh, keep):
    """:func:`lstm_scan` through the plain steps, on any device."""
    return _scan(xg, h0, c0, wh, keep, _step_plain)


def lstm_scan_backward_plain(d_hs, wh, c0, cs, ifgo):
    """:func:`lstm_scan_backward` through the plain steps, on any device."""
    return _scan_backward(d_hs, wh, c0, cs, ifgo, _step_backward_plain, _delta_init_plain)


# ``tonal::lstm_scan``: the forward recurrence (:func:`_scan`), one
# ``tonal::lstm_step`` a time step; ``tonal::lstm_scan_backward``: the
# reverse loop (:func:`_scan_backward`), one ``tonal::lstm_step_backward`` a
# time step after one ``tonal::lstm_delta_init``. The seed axis: xg, h0,
# c0, wh at 0, hs and cs at 1, the gates at 2; d_hs and cs at 1, wh and c0
# at 0, the gates at 2, the deltas at 1, dh0 and dc0 at 0.
lstm_scan = scan_op("lstm_scan(Tensor xg, Tensor h0, Tensor c0, Tensor wh, bool keep) "
                    "-> (Tensor, Tensor, Tensor)", _scan, ("lstm_step",),
                    (0, 0, 0, 0), (1, 1, 2))
lstm_scan_backward = scan_op(
    "lstm_scan_backward(Tensor d_hs, Tensor wh, Tensor c0, Tensor cs, Tensor ifgo) "
    "-> (Tensor, Tensor, Tensor)", _scan_backward, ("lstm_step_backward", "lstm_delta_init"),
    (1, 0, 0, 1, 2), (1, 0, 0))


def _forward(x, h0, c0, wi, wh, b, keep):
    """The input projections of every time step as one matmul, then
    :func:`lstm_scan` on a seed axis of one."""
    with span("lstm.forward"):
        xg = torch.einsum("bti,ih->bth", x, wi) + b
        return lstm_scan(xg[None], h0[None], c0[None], wh[None], keep)


class LSTMSequence(torch.autograd.Function):
    """``lstm_sequence`` with the JAX package's backward
    (``decode_tonal_langauge_tpu/ops/lstm.py:79-141``).

    ``generate_vmap_rule``: under ``torch.func.vmap`` (a seed-batched fit,
    ``training/seed_stack.py``) forward and backward run once on the
    batched tensors; the two loops are ops whose vmap rules fold the
    seeds into their seed axis, the rest is batched op by op."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, h0, c0, wi, wh, b):
        hs, cs, ifgo = _forward(x, h0, c0, wi, wh, b, True)
        return hs[:, 0].transpose(0, 1), cs[:, 0], ifgo[:, :, 0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, h0, c0, wi, wh, _ = inputs
        out, cs, ifgo = output
        ctx.mark_non_differentiable(cs, ifgo)
        ctx.save_for_backward(x, h0, c0, wi, wh, out, cs, ifgo)

    @staticmethod
    def backward(ctx, d_out, *_):
        x, h0, c0, wi, wh, out, cs, ifgo = ctx.saved_tensors
        n_t, bsz, hid = cs.shape
        with span("lstm.reverse"), torch.no_grad():  # no double backward
            das, dh0, dc0 = lstm_scan_backward(d_out.transpose(0, 1)[:, None], wh[None],
                                               c0[None], cs[:, None], ifgo[:, :, None])
            das = das[:, 0]  # (T, B, 4H)

        with span("lstm.weight_grads"):
            hs = out.transpose(0, 1)  # (T, B, H)
            da_flat = das.reshape(n_t * bsz, 4 * hid)
            dx = dwi = dwh = db = None
            if ctx.needs_input_grad[4]:
                h_prev = torch.cat([h0[None], hs[:-1]], dim=0)
                dwh = h_prev.reshape(n_t * bsz, hid).t() @ da_flat
            if ctx.needs_input_grad[3]:
                dwi = x.transpose(0, 1).reshape(n_t * bsz, -1).t() @ da_flat
            if ctx.needs_input_grad[5]:
                db = da_flat.sum(dim=0)
            if ctx.needs_input_grad[0]:
                dx = (das @ wi.t()).transpose(0, 1)  # (T,B,4H)@(4H,I) -> (B,T,I)
        return dx, dh0[0], dc0[0], dwi, dwh, db


def lstm_sequence(
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    wi: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
) -> torch.Tensor:
    """Run an LSTM over ``x`` (B, T, I); returns the hidden sequence
    (B, T, H). ``wi`` (I, 4H), ``wh`` (H, 4H), ``b`` (4H,)."""
    inputs = (x, h0, c0, wi, wh, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return LSTMSequence.apply(*inputs)[0]
    return _forward(x, h0, c0, wi, wh, b, False)[0][:, 0].transpose(0, 1)


class TimeBatchedLSTM(nn.Module):
    """LSTM returning the full hidden sequence (B, T, features), with
    concatenated-gate parameters ``wi`` (I, 4H), ``wh`` (H, 4H), ``b``
    (4H,) — the Flax ``cell/{ii..io}`` and ``cell/{hi..ho}`` denses
    concatenated in gate order (``convert.py``). The parameters stay in
    their own dtype; ``dtype`` (None: theirs) is the compute dtype that x,
    the initial state and the weights are cast to."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.wi = nn.Parameter(torch.empty(in_features, 4 * features))
        self.wh = nn.Parameter(torch.empty(features, 4 * features))
        self.b = nn.Parameter(torch.zeros(4 * features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wi, wh, b = self.wi, self.wh, self.b
        if self.dtype is not None:
            x, wi, wh, b = (t.to(self.dtype) for t in (x, wi, wh, b))
        h0 = x.new_zeros((x.shape[0], self.features))
        return lstm_sequence(x, h0, h0, wi, wh, b)
