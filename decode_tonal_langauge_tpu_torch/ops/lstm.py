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
time-major stacks (T, S, B, H). Each has a vmap rule that folds vmap's
dimension into S, so a seed-batched fit (``training/seed_stack.py``)
crosses vmap's batching layer once a sequence, not once an op a step.
Inside, each time step is one op:

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
``csrc/lstm_step.cu`` (built by ``_build.py``, bound with ``ctypes``) or
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

import contextlib
import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from ..runtime.profiling import span

FORWARD_LAUNCHES = 0  # forward step kernels launched, one a time step
REVERSE_LAUNCHES = 0  # reverse step kernels launched, one a time step
DELTA_LAUNCHES = 0  # first-delta kernels launched, one a reverse loop
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


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

@lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """``csrc/lstm_step.cu`` built, loaded and its entry points typed."""
    from .. import _build

    lib = _build.load("lstm_step")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lstm_step_forward.argtypes = [
        i32, ptr, ptr, i32, i32, i32, ptr, i64, i64, ptr, ptr, ptr, ptr, i64, ptr,
    ]
    lib.lstm_step_forward.restype = i32
    lib.lstm_step_reverse.argtypes = [
        i32, i32, ptr, ptr, i32, i32, i32, ptr, i64, i64, ptr, ptr, ptr, i64, ptr, ptr, ptr,
    ]
    lib.lstm_step_reverse.restype = i32
    lib.lstm_step_tile.argtypes = [i32, i32, i32, i32, i32]
    lib.lstm_step_tile.restype = i32
    return lib


def _kernel_dtype(*ts: Tensor) -> int:
    """The kernel's dtype code; raises on what the kernel does not take."""
    dtype = ts[0].dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in ts):
        raise TypeError(f"lstm step kernel: float32, float64 or bfloat16 operands of one "
                        f"dtype, got {[t.dtype for t in ts]}")
    if any(not t.is_cuda or t.device != ts[0].device for t in ts):
        raise ValueError("lstm step kernel: every operand on one CUDA device")
    return _DTYPES[dtype]


def _stream(t: Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _launched(err: int, what: str, shape) -> None:
    if err != 0:
        raise RuntimeError(f"lstm_step {what} launch failed: cudaError_t {err} "
                           f"(S, B, H = {tuple(shape)})")


def _step_cuda(h, wh, xg_t, c, h_out, c_out, ifgo_t, keep):
    global FORWARD_LAUNCHES
    code = _kernel_dtype(h, wh, xg_t, c, h_out, c_out, ifgo_t)
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
        ifgo_t.data_ptr() if keep else None, ifgo_t.stride(0) if keep else 0, _stream(h))
    _launched(err, "forward", h.shape)
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
    code = _kernel_dtype(d_h, c, c_before, ifgo, dc_next, out)
    s, b, hid = c.shape
    _reverse_checks(d_h, c, c_before, ifgo, dc_next, out, (s, b, 4 * hid))
    err = _library().lstm_step_reverse(
        code, 2, None, None, s, b, hid, d_h.data_ptr(), d_h.stride(0), d_h.stride(1),
        c.data_ptr(), c_before.data_ptr(), ifgo.data_ptr(), ifgo.stride(0),
        dc_next.data_ptr(), out.data_ptr(), _stream(c))
    _launched(err, "first delta", c.shape)
    DELTA_LAUNCHES += 1


def _step_backward_cuda(da_t, wh_t, d_h, c, c_before, ifgo, dc_next, out, epilogue):
    global REVERSE_LAUNCHES
    code = _kernel_dtype(da_t, wh_t, d_h, c, c_before, ifgo, dc_next, out)
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
        out.data_ptr(), _stream(da_t))
    _launched(err, "reverse", (s, b, hid))
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


_LIB = torch.library.Library("tonal", "FRAGMENT")
_LIB.define("lstm_step(Tensor h, Tensor wh, Tensor xg_t, Tensor c, Tensor(a!) h_out, "
            "Tensor(b!) c_out, Tensor(c!) ifgo_t, bool keep) -> ()")
_LIB.define("lstm_step_backward(Tensor da_t, Tensor wh_t, Tensor d_h, Tensor c, "
            "Tensor c_before, Tensor ifgo, Tensor(a!) dc_next, Tensor(b!) out, "
            "bool epilogue) -> ()")
_LIB.define("lstm_delta_init(Tensor d_h, Tensor c, Tensor c_before, Tensor ifgo, "
            "Tensor(a!) dc_next, Tensor(b!) out) -> ()")
for _name, _plain, _cuda in (("lstm_step", _step_plain, _step_cuda),
                             ("lstm_step_backward", _step_backward_plain, _step_backward_cuda),
                             ("lstm_delta_init", _delta_init_plain, _delta_init_cuda)):
    _LIB.impl(_name, _plain, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")


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


def _on_device(t: Tensor):
    """The kernels launch on the current device: make it ``t``'s."""
    return torch.cuda.device(t.device) if t.is_cuda else contextlib.nullcontext()


def _lstm_scan_impl(xg, h0, c0, wh, keep):
    with _on_device(xg):
        return _scan(xg, h0, c0, wh, keep, torch.ops.tonal.lstm_step)


def _lstm_scan_backward_impl(d_hs, wh, c0, cs, ifgo):
    with _on_device(cs):
        return _scan_backward(d_hs, wh, c0, cs, ifgo, torch.ops.tonal.lstm_step_backward,
                              torch.ops.tonal.lstm_delta_init)


def _lstm_scan_meta(xg, h0, c0, wh, keep):  # shapes alone (the seed stack's meta forward)
    s, b, n_t, g4 = xg.shape
    hid = g4 // 4
    return (xg.new_empty((n_t, s, b, hid)), xg.new_empty((n_t if keep else 2, s, b, hid)),
            xg.new_empty((4, n_t, s, b, hid) if keep else (0,)))


def _lstm_scan_backward_meta(d_hs, wh, c0, cs, ifgo):
    n_t, s, b, hid = cs.shape
    return cs.new_empty((n_t, s, b, 4 * hid)), cs.new_empty((s, b, hid)), cs.new_empty((s, b, hid))


# The sequence ops are defined on the plain Library (its first call costs
# nothing; torch.library.custom_op's first call imports seconds of
# tracing machinery), with the CPU and CUDA implementations above, a meta
# one, and a vmap rule each (below).
_LIB.define("lstm_scan(Tensor xg, Tensor h0, Tensor c0, Tensor wh, bool keep) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.define("lstm_scan_backward(Tensor d_hs, Tensor wh, Tensor c0, Tensor cs, Tensor ifgo) "
            "-> (Tensor, Tensor, Tensor)")
for _name, _impl, _meta in (("lstm_scan", _lstm_scan_impl, _lstm_scan_meta),
                            ("lstm_scan_backward", _lstm_scan_backward_impl,
                             _lstm_scan_backward_meta)):
    _LIB.impl(_name, _impl, "CPU")
    _LIB.impl(_name, _impl, "CUDA")
    _LIB.impl(_name, _meta, "Meta")


def lstm_scan(xg: Tensor, h0: Tensor, c0: Tensor, wh: Tensor,
              keep: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """``tonal::lstm_scan``: the forward recurrence (:func:`_scan`), one
    ``tonal::lstm_step`` a time step."""
    return torch.ops.tonal.lstm_scan(xg, h0, c0, wh, keep)


def lstm_scan_backward(d_hs: Tensor, wh: Tensor, c0: Tensor, cs: Tensor,
                       ifgo: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``tonal::lstm_scan_backward``: the reverse loop
    (:func:`_scan_backward`), one ``tonal::lstm_step_backward`` a time step
    after one ``tonal::lstm_delta_init``."""
    return torch.ops.tonal.lstm_scan_backward(d_hs, wh, c0, cs, ifgo)


def _fold(x: Tensor, dim: Optional[int], pos: int, size: int) -> Tensor:
    """Move vmap's dimension ``dim`` (None: not batched, so broadcast) to
    ``pos`` and merge it into the seed axis that follows it."""
    if dim is None:
        x = x.unsqueeze(pos).expand(x.shape[:pos] + (size,) + x.shape[pos:])
    else:
        x = x.movedim(dim, pos)
    return x.reshape(x.shape[:pos] + (-1,) + x.shape[pos + 2:])


def _split(x: Tensor, pos: int, size: int) -> Tensor:
    """Undo :func:`_fold` on an output: vmap's dimension at ``pos``."""
    return x.reshape(x.shape[:pos] + (size, -1) + x.shape[pos + 1:])


@torch.library.register_vmap("tonal::lstm_scan", lib=_LIB)
def _lstm_scan_vmap(info, in_dims, xg, h0, c0, wh, keep):
    n = info.batch_size
    xd, hd, cd, wd, _ = in_dims
    hs, cs, ifgo = lstm_scan(_fold(xg, xd, 0, n), _fold(h0, hd, 0, n), _fold(c0, cd, 0, n),
                             _fold(wh, wd, 0, n), keep)
    if keep:
        return (_split(hs, 1, n), _split(cs, 1, n), _split(ifgo, 2, n)), (1, 1, 2)
    return (_split(hs, 1, n), _split(cs, 1, n), ifgo), (1, 1, None)


@torch.library.register_vmap("tonal::lstm_scan_backward", lib=_LIB)
def _lstm_scan_backward_vmap(info, in_dims, d_hs, wh, c0, cs, ifgo):
    n = info.batch_size
    dd, wd, cd, sd, gd = in_dims
    das, dh0, dc0 = lstm_scan_backward(_fold(d_hs, dd, 1, n), _fold(wh, wd, 0, n),
                                       _fold(c0, cd, 0, n), _fold(cs, sd, 1, n),
                                       _fold(ifgo, gd, 2, n))
    return (_split(das, 1, n), _split(dh0, 0, n), _split(dc0, 0, n)), (1, 0, 0)


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
        with span("lstm.forward"):
            xg = torch.einsum("bti,ih->bth", x, wi) + b  # all timesteps at once
            hs, cs, ifgo = lstm_scan(xg[None], h0[None], c0[None], wh[None], True)
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
    with span("lstm.forward"):
        xg = torch.einsum("bti,ih->bth", x, wi) + b
        hs = lstm_scan(xg[None], h0[None], c0[None], wh[None], False)[0]
        return hs[:, 0].transpose(0, 1)


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
