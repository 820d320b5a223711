"""Time-batched LSTM: one matmul for every input projection, a loop for
the recurrence, and a hand-written backward.

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

A compute ``dtype`` (bfloat16) runs the projections, the recurrence, the
cell state and the gates in that dtype, as JAX's ``TimeBatchedLSTM``
does. The weight gradients are then bf16 matmuls and a bf16 sum, which
accumulate in float32 and round once to bf16, JAX's
``preferred_element_type=float32`` rule: ATen's reductions and oneDNN's
GEMMs always do, cuBLAS does under ``runtime.device.exact_f32`` (its
``f32_accumulation``), which every train step opens.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..runtime.profiling import span


def _lstm_scan(xg: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
               wh: torch.Tensor, keep: bool):
    """Forward recurrence over ``xg`` (B, T, 4H), the input projections
    plus bias. Returns the hidden sequence (B, T, H) and, with ``keep``,
    the time-major (T, B, H) stacks of c, i, f, g, o."""
    hs, saved = [], []
    for t in range(xg.shape[1]):
        gates = xg[:, t] + h @ wh
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        if keep:
            saved.append((c, i, f, g, o))
    out = torch.stack(hs, dim=1)
    if not keep:
        return out, None
    return out, [torch.stack(s) for s in zip(*saved)]


class LSTMSequence(torch.autograd.Function):
    """``lstm_sequence`` with the JAX package's backward
    (``decode_tonal_langauge_tpu/ops/lstm.py:79-141``).

    ``generate_vmap_rule``: under ``torch.func.vmap`` (a seed-batched fit,
    ``training/seed_stack.py``) forward and backward run once on the
    batched tensors, every matmul and gate op batched over the seeds."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, h0, c0, wi, wh, b):
        with span("lstm.forward"):
            xg = torch.einsum("bti,ih->bth", x, wi) + b  # all timesteps at once
            out, (cs, i, f, g, o) = _lstm_scan(xg, h0, c0, wh, keep=True)
        return out, cs, i, f, g, o

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, h0, c0, wi, wh, _ = inputs
        out, cs, i, f, g, o = output
        ctx.mark_non_differentiable(cs, i, f, g, o)
        ctx.save_for_backward(x, h0, c0, wi, wh, out, cs, i, f, g, o)

    @staticmethod
    def backward(ctx, d_out, *_):
        x, h0, c0, wi, wh, out, cs, i, f, g, o = ctx.saved_tensors
        n_t, bsz, hid = cs.shape
        hs = out.transpose(0, 1)  # (T, B, H)
        d_hs = d_out.transpose(0, 1)
        wh_t = wh.t()
        with span("lstm.reverse"):
            das = []
            dh_next = torch.zeros_like(h0)
            dc_next = torch.zeros_like(c0)
            for t in range(n_t - 1, -1, -1):
                dh = d_hs[t] + dh_next
                tc = torch.tanh(cs[t])
                dc = dh * o[t] * (1.0 - tc * tc) + dc_next
                cp = cs[t - 1] if t else c0
                # pre-activation gate deltas, gate order i, f, g, o; no in-place
                # writes into a preallocated stack: under torch.func.grad those
                # keep the saved tensors (wh among them) alive after the step
                da = torch.cat([dc * g[t] * i[t] * (1.0 - i[t]),
                                dc * cp * f[t] * (1.0 - f[t]),
                                dc * i[t] * (1.0 - g[t] * g[t]),
                                dh * tc * o[t] * (1.0 - o[t])], dim=-1)
                das.append(da)
                dh_next = da @ wh_t
                dc_next = dc * f[t]

        with span("lstm.weight_grads"):
            das = torch.stack(das[::-1])  # (T, B, 4H)
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
        return dx, dh_next, dc_next, dwi, dwh, db


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
        return _lstm_scan(xg, h0, c0, wh, keep=False)[0]


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
