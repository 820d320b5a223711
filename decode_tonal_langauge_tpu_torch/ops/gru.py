"""Time-batched GRU: one matmul for every input projection of a layer's
directions, a recurrence of one fused step a time step, and a
hand-written backward.

The equations, biases, gate order (r, z, n) and parameter layout are
``torch.nn.GRU``'s, so its checkpoints load (``weight_ih`` (3H, I),
``weight_hh`` (3H, H), ``bias_ih``, ``bias_hh`` (3H,))::

    r  = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z  = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n  = tanh(x W_in + b_in + r (h W_hn + b_hn))
    h' = (h - n) z + n            ((1 - z) n + z h, in ATen's order)

from ``h0 = 0``. There is no sequence packing: every direction runs over
the whole (padded) length, as ``nn.GRU`` does on a padded batch.

The two directions of a bidirectional layer are independent recurrences
with their own weights; they ride the seed axis S of the sequence ops
(the reverse direction on the time-reversed sequence), so both run in one
launch a time step. The input projection of both is one GEMM.

The backward (:class:`GRUSequence`) keeps ``h`` and r, z, n and
``hn = h W_hn + b_hn`` of every step; a reverse loop carries only ``dh z``
(the direct path through ``h'``) and stacks the deltas of the input
projection's pre-activations ``dgx`` and of the recurrent product's
``dgh`` (they differ in the n block, ``dgh_n = dgx_n r``); the weight,
bias and input gradients are then time-batched matmuls over the stacks.

The loops are ``torch.library`` ops over a whole sequence,
``tonal::gru_scan`` and ``tonal::gru_scan_backward``, on tensors with an
explicit leading seed axis S: ``xg`` (S, B, T, 3H), ``wt = W_hh^T``
(S, H, 3H), ``bh`` (S, 3H), time-major stacks (T, S, B, H), with the vmap
rule, device guard and Meta implementation of ``ops/recurrence.py``, as
``ops/lstm.py``'s. Inside, each time step is one op:

- ``tonal::gru_step(h, wt, xg_t, bh, h_out, rzn_t, keep)``: writes ``h_t``
  and (with ``keep``) r, z, n, hn into the stacks;
- ``tonal::gru_step_backward(dgh_t, wt, d_h, h_before, rzn, carry, dgx,
  dgh)``: ``dh_next = dgh_t @ W_hh`` and step t-1's deltas;
- ``tonal::gru_delta_init(d_h, h_before, rzn, carry, dgx, dgh)``: the
  first delta, step T-1's, with no product.

On a CUDA tensor a step op launches the hand-written sm_90a kernel of
``csrc/gru_step.cu`` (on the tiles it shares with the LSTM's,
``csrc/step_tiles.cuh``) or raises; on a CPU tensor it runs the plain
version (:func:`_step_plain`, :func:`_step_backward_plain`,
:func:`_delta_init_plain`), whose arithmetic is the kernel's, in its
order. :func:`gru_scan_plain` and :func:`gru_scan_backward_plain` run the
plain steps on any device. ``FORWARD_LAUNCHES`` and ``REVERSE_LAUNCHES``
count the kernels of forward and reverse steps, one a time step each;
``DELTA_LAUNCHES`` the first deltas', one a reverse loop.
"""

from __future__ import annotations

import torch
from torch import Tensor, nn

from .._build import I32, I64, PTR, launched, library, stream
from ..runtime.profiling import span
from .recurrence import kernel_dtype, scan_op, step_op

FORWARD_LAUNCHES = 0  # forward step kernels launched, one a time step
REVERSE_LAUNCHES = 0  # reverse step kernels launched, one a time step but the last
DELTA_LAUNCHES = 0  # first-delta kernels launched, one a reverse loop


# -- the plain versions: the ops' CPU implementation ------------------------

def _step_plain(h, wt, xg_t, bh, h_out, rzn_t, keep):
    """One forward step: the kernel's arithmetic in plain torch."""
    gh = torch.matmul(h, wt) + bh[:, None]
    gx_r, gx_z, gx_n = xg_t.chunk(3, dim=-1)
    gh_r, gh_z, gh_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(gx_r + gh_r)
    z = torch.sigmoid(gx_z + gh_z)
    n = torch.tanh(gx_n + r * gh_n)
    h_out.copy_((h - n) * z + n)
    if keep:
        for dst, src in zip(rzn_t, (r, z, n, gh_n)):
            dst.copy_(src)


def _delta(dh, h_before, rzn):
    """Step tau's deltas of the input projection's and of the recurrent
    product's pre-activations (gate order r, z, n) and ``dh z``, from
    ``dh``, the whole gradient of h[tau]."""
    r, z, n, hn = rzn.unbind(0)
    dn = dh * (1.0 - z)
    dz = dh * (h_before - n)
    dan = dn * (1.0 - n * n)
    dar = dan * hn * r * (1.0 - r)
    daz = dz * z * (1.0 - z)
    return (torch.cat([dar, daz, dan], dim=-1), torch.cat([dar, daz, dan * r], dim=-1),
            dh * z)


def _delta_init_plain(d_h, h_before, rzn, carry, dgx, dgh):
    zeros = torch.zeros_like(d_h)
    gx, gh, c = _delta(d_h + zeros + zeros, h_before, rzn)
    dgx.copy_(gx)
    dgh.copy_(gh)
    carry.copy_(c)


def _step_backward_plain(dgh_t, wt, d_h, h_before, rzn, carry, dgx, dgh):
    dh_next = torch.matmul(dgh_t, wt.transpose(1, 2))
    gx, gh, c = _delta(d_h + dh_next + carry, h_before, rzn)
    dgx.copy_(gx)
    dgh.copy_(gh)
    carry.copy_(c)


# -- the kernels' wrappers --------------------------------------------------

_library = library("gru_step", {
    "gru_step_forward": (I32, PTR, PTR, I32, I32, I32, PTR, I64, I64, PTR, PTR, PTR, I64, PTR),
    "gru_step_reverse": (I32, I32, PTR, PTR, I32, I32, I32, PTR, I64, I64, PTR, PTR, I64, PTR,
                         PTR, PTR, PTR),
    "gru_step_tile": (I32,) * 5,
})


def _step_cuda(h, wt, xg_t, bh, h_out, rzn_t, keep):
    global FORWARD_LAUNCHES
    code = kernel_dtype("gru step kernel", h, wt, xg_t, bh, h_out, rzn_t)
    s, b, hid = h.shape
    if not (h.is_contiguous() and wt.is_contiguous() and bh.is_contiguous()
            and h_out.is_contiguous() and wt.shape == (s, hid, 3 * hid)
            and bh.shape == (s, 3 * hid) and xg_t.shape == (s, b, 3 * hid)
            and xg_t.stride(2) == 1 and h_out.shape == h.shape):
        raise ValueError("gru_step: h, h_out (S, B, H), wt (S, H, 3H), bh (S, 3H) "
                         "contiguous, xg_t (S, B, 3H) with unit stride along 3H")
    if keep and not (rzn_t.shape == (4, s, b, hid) and rzn_t[0].is_contiguous()):
        raise ValueError("gru_step: rzn_t (4, S, B, H), each slice contiguous")
    err = _library().gru_step_forward(
        code, h.data_ptr(), wt.data_ptr(), s, b, hid,
        xg_t.data_ptr(), xg_t.stride(0), xg_t.stride(1), bh.data_ptr(), h_out.data_ptr(),
        rzn_t.data_ptr() if keep else None, rzn_t.stride(0) if keep else 0, stream(h))
    launched(err, "gru_step forward", "S, B, H = {}", (s, b, hid))
    FORWARD_LAUNCHES += 1


def _reverse_checks(d_h, h_before, rzn, carry, dgx, dgh) -> None:
    shape = h_before.shape
    s, b, hid = shape
    if not (h_before.is_contiguous() and carry.is_contiguous() and dgx.is_contiguous()
            and dgh.is_contiguous() and carry.shape == d_h.shape == shape
            and d_h.stride(2) == 1 and rzn.shape == (4,) + shape and rzn[0].is_contiguous()
            and dgx.shape == dgh.shape == (s, b, 3 * hid)):
        raise ValueError("gru_step_backward: h_before, carry contiguous (S, B, H), d_h "
                         "(S, B, H) with unit stride along H, rzn (4, S, B, H), dgx and "
                         "dgh contiguous (S, B, 3H)")


def _reverse(code, mode, dgh_t, wt, d_h, h_before, rzn, carry, dgx, dgh):
    s, b, hid = h_before.shape
    return _library().gru_step_reverse(
        code, mode, dgh_t.data_ptr() if mode == 1 else None,
        wt.data_ptr() if mode == 1 else None, s, b, hid, d_h.data_ptr(), d_h.stride(0),
        d_h.stride(1), h_before.data_ptr(), rzn.data_ptr(), rzn.stride(0), carry.data_ptr(),
        dgx.data_ptr(), dgh.data_ptr(), stream(h_before))


def _delta_init_cuda(d_h, h_before, rzn, carry, dgx, dgh):
    global DELTA_LAUNCHES
    code = kernel_dtype("gru step kernel", d_h, h_before, rzn, carry, dgx, dgh)
    _reverse_checks(d_h, h_before, rzn, carry, dgx, dgh)
    launched(_reverse(code, 2, None, None, d_h, h_before, rzn, carry, dgx, dgh),
             "gru_step first delta", "S, B, H = {}", (*h_before.shape,))
    DELTA_LAUNCHES += 1


def _step_backward_cuda(dgh_t, wt, d_h, h_before, rzn, carry, dgx, dgh):
    global REVERSE_LAUNCHES
    code = kernel_dtype("gru step kernel", dgh_t, wt, d_h, h_before, rzn, carry, dgx, dgh)
    s, b, hid = h_before.shape
    if not (dgh_t.is_contiguous() and dgh_t.shape == (s, b, 3 * hid) and wt.is_contiguous()
            and wt.shape == (s, hid, 3 * hid)):
        raise ValueError("gru_step_backward: dgh_t (S, B, 3H) and wt (S, H, 3H) contiguous")
    _reverse_checks(d_h, h_before, rzn, carry, dgx, dgh)
    launched(_reverse(code, 1, dgh_t, wt, d_h, h_before, rzn, carry, dgx, dgh),
             "gru_step reverse", "S, B, H = {}", (s, b, hid))
    REVERSE_LAUNCHES += 1


def step_tile(seeds: int, rows: int, hid: int, reverse: bool = False,
              dtype: torch.dtype = torch.float32) -> int:
    """The kernel's tile for ``seeds`` x ``rows`` rows and ``hid`` units,
    by the LSTM's rule (``ops/lstm.step_tile``)."""
    size = torch.empty((), dtype=dtype).element_size()
    return _library().gru_step_tile(seeds, rows, hid, size, int(reverse))


step_op("gru_step(Tensor h, Tensor wt, Tensor xg_t, Tensor bh, Tensor(a!) h_out, "
        "Tensor(b!) rzn_t, bool keep) -> ()", _step_plain, _step_cuda)
step_op("gru_step_backward(Tensor dgh_t, Tensor wt, Tensor d_h, Tensor h_before, "
        "Tensor rzn, Tensor(a!) carry, Tensor(b!) dgx, Tensor(c!) dgh) -> ()",
        _step_backward_plain, _step_backward_cuda)
step_op("gru_delta_init(Tensor d_h, Tensor h_before, Tensor rzn, Tensor(a!) carry, "
        "Tensor(b!) dgx, Tensor(c!) dgh) -> ()", _delta_init_plain, _delta_init_cuda)


# -- the sequence loops -----------------------------------------------------

def _scan(xg, wt, bh, keep, step):
    """The forward recurrence over ``xg`` (S, B, T, 3H), the input
    projections plus ``b_ih``, from h0 = 0: time-major stacks of h
    (T, S, B, H) and r, z, n, hn (4, T, S, B, H; with ``keep``, else
    empty)."""
    s, b, n_t, g3 = xg.shape
    hid = g3 // 3
    wt, bh = wt.contiguous(), bh.contiguous()
    hs = xg.new_empty((n_t, s, b, hid))
    rzn = xg.new_empty((4, n_t, s, b, hid) if keep else (0,))
    h = xg.new_zeros((s, b, hid))
    for t in range(n_t):
        step(h, wt, xg[:, :, t], bh, hs[t], rzn[:, t] if keep else rzn, keep)
        h = hs[t]
    return hs, rzn


def _scan_backward(d_hs, wt, hs, rzn, step, init):
    """The reverse loop: ``d_hs`` (T, S, B, H) the hidden sequence's
    gradient; returns the deltas of the input projection and of the
    recurrent product, each (T, S, B, 3H)."""
    n_t, s, b, hid = hs.shape
    if d_hs.stride(-1) != 1:
        d_hs = d_hs.contiguous()
    wt = wt.contiguous()
    dgx = hs.new_empty((n_t, s, b, 3 * hid))
    dgh = hs.new_empty((n_t, s, b, 3 * hid))
    carry = hs.new_empty((s, b, hid))
    h0 = hs.new_zeros((s, b, hid))

    def before(t):
        return hs[t - 1] if t else h0

    last = n_t - 1
    init(d_hs[last], before(last), rzn[:, last], carry, dgx[last], dgh[last])
    for t in range(last, 0, -1):
        step(dgh[t], wt, d_hs[t - 1], before(t - 1), rzn[:, t - 1], carry, dgx[t - 1],
             dgh[t - 1])
    return dgx, dgh


def gru_scan_plain(xg, wt, bh, keep):
    """:func:`gru_scan` through the plain steps, on any device."""
    return _scan(xg, wt, bh, keep, _step_plain)


def gru_scan_backward_plain(d_hs, wt, hs, rzn):
    """:func:`gru_scan_backward` through the plain steps, on any device."""
    return _scan_backward(d_hs, wt, hs, rzn, _step_backward_plain, _delta_init_plain)


# ``tonal::gru_scan``: the forward recurrence (:func:`_scan`), one
# ``tonal::gru_step`` a time step; ``tonal::gru_scan_backward``: the reverse
# loop (:func:`_scan_backward`), one ``tonal::gru_step_backward`` a time
# step after one ``tonal::gru_delta_init``. The seed axis: xg, wt, bh at 0,
# hs at 1, r, z, n, hn at 2; d_hs and hs at 1, wt at 0, r, z, n, hn at 2,
# both deltas at 1.
gru_scan = scan_op("gru_scan(Tensor xg, Tensor wt, Tensor bh, bool keep) -> (Tensor, Tensor)",
                   _scan, ("gru_step",), (0, 0, 0), (1, 2))
gru_scan_backward = scan_op(
    "gru_scan_backward(Tensor d_hs, Tensor wt, Tensor hs, Tensor rzn) -> (Tensor, Tensor)",
    _scan_backward, ("gru_step_backward", "gru_delta_init"), (1, 0, 1, 2), (1, 1))


# -- one layer, every direction ---------------------------------------------

def _directions_in(g: Tensor, n_dir: int) -> Tensor:
    """(B, T, D, F) in the input's time order -> (D, B, T, F) in each
    direction's own (the reverse direction's time reversed)."""
    parts = [g[:, :, 0]] + ([g[:, :, 1].flip(1)] if n_dir == 2 else [])
    return torch.stack(parts)


def _directions_out(hs: Tensor, n_dir: int) -> Tensor:
    """(T, D, B, F) in each direction's time order -> (B, T, D F) in the
    input's, the forward direction's features first (``nn.GRU``'s)."""
    parts = [hs[:, 0]] + ([hs[:, 1].flip(0)] if n_dir == 2 else [])
    return torch.cat(parts, dim=-1).transpose(0, 1)


def _projected(x: Tensor, wi: Tensor, bi: Tensor) -> Tensor:
    """Every direction's input projection ``x W_ih^T + b_ih`` as one GEMM,
    laid out for the scan: (D, B, T, 3H), each direction in its own time
    order."""
    n_dir, g3, n_in = wi.shape
    gx = torch.nn.functional.linear(x, wi.reshape(n_dir * g3, n_in), bi.reshape(n_dir * g3))
    return _directions_in(gx.unflatten(-1, (n_dir, g3)), n_dir)


class GRUSequence(torch.autograd.Function):
    """One GRU layer over ``x`` (B, T, I), all its directions (D = 1 or 2)
    at once: ``wi`` (D, 3H, I), ``wh`` (D, 3H, H), ``bi``, ``bh`` (D, 3H).
    Returns (B, T, D H). The backward is the module docstring's.

    ``generate_vmap_rule``: the two loops are ops with vmap rules, the rest
    batches op by op, so a seed-batched fit can run it under vmap."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, wi, wh, bi, bh):
        with span("gru.forward"):
            wt = wh.transpose(1, 2).contiguous()
            hs, rzn = gru_scan(_projected(x, wi, bi), wt, bh, True)
        return _directions_out(hs, wi.shape[0]), hs, rzn, wt

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, wi, wh, _, _ = inputs
        _, hs, rzn, wt = output
        ctx.mark_non_differentiable(hs, rzn, wt)
        ctx.save_for_backward(x, wi, wt, hs, rzn)

    @staticmethod
    def backward(ctx, d_out, *_):
        x, wi, wt, hs, rzn = ctx.saved_tensors
        n_t, n_dir, bsz, hid = hs.shape
        with span("gru.reverse"), torch.no_grad():  # no double backward
            d_hs = _directions_in(d_out.unflatten(-1, (n_dir, hid)), n_dir)  # (D, B, T, H)
            dgx, dgh = gru_scan_backward(d_hs.permute(2, 0, 1, 3), wt, hs, rzn)

        with span("gru.weight_grads"):
            dx = dwi = dwh = dbi = dbh = None
            if ctx.needs_input_grad[2]:
                h_prev = torch.cat([hs.new_zeros((1, n_dir, bsz, hid)), hs[:-1]])
                # per direction: dgh^T @ h_prev over (T, B) -> (3H, H)
                dwh = torch.bmm(dgh.permute(1, 3, 0, 2).reshape(n_dir, 3 * hid, n_t * bsz),
                                h_prev.transpose(0, 1).reshape(n_dir, n_t * bsz, hid))
            if ctx.needs_input_grad[4]:
                dbh = dgh.sum(dim=(0, 2))
            # dgx in the input's time order, the directions side by side
            g = _directions_out(dgx, n_dir).reshape(bsz * n_t, n_dir * 3 * hid)
            if ctx.needs_input_grad[1]:
                dwi = (g.t() @ x.reshape(bsz * n_t, -1)).reshape(wi.shape)
            if ctx.needs_input_grad[3]:
                dbi = g.sum(dim=0).reshape(n_dir, 3 * hid)
            if ctx.needs_input_grad[0]:
                dx = (g @ wi.reshape(n_dir * 3 * hid, -1)).reshape(x.shape)
        return dx, dwi, dwh, dbi, dbh


def gru_layer(x: Tensor, wi: Tensor, wh: Tensor, bi: Tensor, bh: Tensor) -> Tensor:
    """One GRU layer over ``x`` (B, T, I) (:class:`GRUSequence`); without
    a gradient to take, the forward keeps nothing but h."""
    inputs = (x, wi, wh, bi, bh)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return GRUSequence.apply(*inputs)[0]
    with span("gru.forward"):
        hs, _ = gru_scan(_projected(x, wi, bi), wh.transpose(1, 2).contiguous(), bh, False)
        return _directions_out(hs, wi.shape[0])


class TimeBatchedGRU(nn.Module):
    """A stack of GRU layers, ``torch.nn.GRU``'s parameters and names
    (``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_ih_l{k}``,
    ``bias_hh_l{k}``, the reverse direction's with ``_reverse``), batch
    first, from h0 = 0; returns the last layer's outputs (B, T, D H).
    ``dropout`` sits on the outputs of every layer but the last, a
    module's own (``dropouts[k]``: ``ops/dropout.Dropout``, drawing from
    the generator the trainer sets), as ``nn.GRU``'s ``dropout``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dropout: float = 0.0, bidirectional: bool = False) -> None:
        super().__init__()
        from .dropout import Dropout

        self.input_size, self.hidden_size, self.num_layers = input_size, hidden_size, num_layers
        self.directions = 2 if bidirectional else 1
        for k in range(num_layers):
            n_in = input_size if k == 0 else hidden_size * self.directions
            for sfx in self._suffixes(k):
                self.register_parameter(f"weight_ih{sfx}",
                                        nn.Parameter(torch.empty(3 * hidden_size, n_in)))
                self.register_parameter(f"weight_hh{sfx}",
                                        nn.Parameter(torch.empty(3 * hidden_size, hidden_size)))
                self.register_parameter(f"bias_ih{sfx}", nn.Parameter(torch.empty(3 * hidden_size)))
                self.register_parameter(f"bias_hh{sfx}", nn.Parameter(torch.empty(3 * hidden_size)))
        self.dropouts = nn.ModuleList(Dropout(dropout) for _ in range(num_layers - 1))

    def _suffixes(self, k: int):
        return [f"_l{k}"] + ([f"_l{k}_reverse"] if self.directions == 2 else [])

    def layer_weights(self, k: int):
        """Layer ``k``'s (wi, wh, bi, bh), the directions stacked."""
        names = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
        return [torch.stack([getattr(self, f"{n}{sfx}") for sfx in self._suffixes(k)])
                for n in names]

    def forward(self, x: Tensor) -> Tensor:
        for k in range(self.num_layers):
            x = gru_layer(x, *self.layer_weights(k))
            if k < self.num_layers - 1:
                x = self.dropouts[k](x)
        return x
