"""DF2T IIR recurrence: the hand-written sm_90a kernel and its plain versions.

Counterpart of ``decode_tonal_langauge_tpu/ops/pallas_iir.py``: the exact
``scipy.signal.lfilter(b, a, x, zi)`` recurrence over the last axis, any
order, in f32, returning ``y`` and the final state ``zf`` after the last
sample. ``ops/iir.lfilter`` routes here for a long signal filtered at
order > 2 with an initial state, the one case the block-state form
cannot take.

The kernel is a time-chunked three-pass scan (``csrc/iir_df2t.cu``): time
is cut into chunks of ``CHUNK`` samples; pass 1 runs every chunk from a
zero state to its end state ``u``; pass 2 carries the state across chunks
in f64 with ``P = A^CHUNK`` (:func:`carry_matrix`); pass 3 re-runs every
chunk from its true entering state and writes ``y`` and ``zf``.

- :func:`lfilter_cuda` is the kernel's wrapper (built with ``nvcc`` for
  sm_90a at first use and loaded with ``ctypes``). On a CUDA tensor it
  launches the three passes or raises; on a CPU tensor it runs
  :func:`lfilter_chunked_reference`. ``LAUNCHES`` counts its calls that
  launched the three passes.
- :func:`lfilter_chunked_reference` is the plain torch version of the
  three passes, with the kernel's rounding, so the two agree bit for bit.
- :func:`lfilter_reference` is the plain serial recurrence, the semantic
  oracle of both; :func:`df2t_scan` is the recurrence itself on
  coefficient tensors, also the short-signal path of ``ops/iir.py`` (the
  counterpart of the JAX ``iir._lfilter_scan``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._build import I32, I64, PTR, launched, library, stream

MAX_ORDER = 16  # largest order with a register instance; = MAX_ORDER in csrc/iir_df2t.cu
WINDOW = 32  # samples staged per chunk at a time; = WINDOW in csrc/iir_df2t.cu
CHUNK = 512  # chunk length L, a multiple of WINDOW; chosen with scripts/k1_sweep.py
LAUNCHES = 0
# The kernels of the three passes, as torch.profiler names them
# ("void chunk_pass<8, false>(Problem, Coeffs)", ...).
PASS_KERNELS = (("chunk_pass<", "false>"), ("carry_",), ("chunk_pass<", "true>"))


def df2t_scan(
    b: torch.Tensor, a: torch.Tensor, x: torch.Tensor, zi: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transposed-direct-form-II recurrence over the last axis.

    ``b``, ``a``: (n,) coefficients normalised so ``a[0] == 1``, in x's
    dtype; ``x``: (..., T); ``zi``: (..., n - 1). Returns (y, zf).
    """
    xT = x.movedim(-1, 0)
    bx = xT.unsqueeze(-1) * b[1:]  # every step's input term at once
    b0x = xT * b[0]
    a1 = a[1:]
    state = zi
    ys = torch.empty_like(xT)
    for t in range(xT.shape[0]):
        yt = b0x[t] + state[..., 0]
        state = F.pad(state[..., 1:], (0, 1)) + bx[t] - a1 * yt[..., None]
        ys[t] = yt
    return ys.movedim(0, -1), state


def _normalised(b, a) -> Tuple[np.ndarray, np.ndarray]:
    """(b, a) in float64, padded to one length and divided by a[0]."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    n = max(b.size, a.size)
    return np.pad(b, (0, n - b.size)) / a[0], np.pad(a, (0, n - a.size)) / a[0]


def _flat_state(zi, x: torch.Tensor, order: int) -> torch.Tensor:
    """zi broadcast to x's rows: contiguous (C, order) f32 on x's device."""
    lead = x.shape[:-1]
    if zi is None:
        return torch.zeros(
            (int(np.prod(lead, dtype=np.int64)), order),
            dtype=torch.float32, device=x.device,
        )
    zi = torch.as_tensor(zi, dtype=torch.float32, device=x.device)
    return zi.broadcast_to(lead + (order,)).reshape(-1, order).contiguous()


@lru_cache(maxsize=64)
def carry_matrix(a: Tuple[float, ...], chunk: int) -> np.ndarray:
    """``P = A^chunk`` in f64: the ``chunk``-step zero-input map of the
    DF2T state, ``s_end = P @ s_start``, built by stepping the recurrence
    ``y = s_0``, ``s_i <- s_{i+1} - a_{i+1} y`` on the identity.

    ``a``: the normalised denominator (``a[0] == 1``), rounded to f32 here
    as the kernel rounds it. The result is read-only and shared."""
    a1 = np.asarray(a[1:], dtype=np.float32).astype(np.float64)
    m = a1.size
    state = np.eye(m)  # column k: the state reached from unit vector e_k
    for _ in range(chunk):
        y = state[0].copy()
        state = np.concatenate([state[1:], np.zeros((1, m))]) - a1[:, None] * y
    state.flags.writeable = False
    return state


def lfilter_reference(b, a, x: torch.Tensor, zi=None):
    """Plain torch DF2T in f32, one step at a time over the whole signal.

    Same contract as :func:`lfilter_cuda`: returns ``y`` (and ``zf`` when
    ``zi`` is given)."""
    bn, an = _normalised(b, a)
    order = bn.size - 1
    if order < 1:  # pure gain
        y = x * np.float32(bn[0])
        return (y, torch.as_tensor(zi)) if zi is not None else y
    x = x.to(torch.float32)
    t = x.shape[-1]
    state = _flat_state(zi, x, order)
    y, zf = df2t_scan(
        torch.as_tensor(bn, dtype=torch.float32, device=x.device),
        torch.as_tensor(an, dtype=torch.float32, device=x.device),
        x.reshape(-1, t), state,
    )
    y = y.reshape(x.shape)
    if zi is not None:
        return y, zf.reshape(x.shape[:-1] + (order,))
    return y


def lfilter_chunked_reference(b, a, x: torch.Tensor, zi=None):
    """Plain torch version of the kernel's three passes, its arithmetic in
    its order, with chunks of ``CHUNK`` samples. Same contract as
    :func:`lfilter_cuda`.

    1. every chunk but the last, from a zero state: its end state ``u``
       (f32, the rounding of :func:`df2t_scan`);
    2. in f64, ``s_in[0] = zi``, ``s_in[j+1] = P s_in[j] + u[j]``, the
       product summed over k in order, then ``u`` added;
    3. every chunk from ``s_in`` rounded to f32: ``y``, and ``zf`` from
       the last (ragged) chunk.
    """
    bn, an = _normalised(b, a)
    order = bn.size - 1
    if order < 1:  # pure gain
        y = x * np.float32(bn[0])
        return (y, torch.as_tensor(zi)) if zi is not None else y
    x = x.to(torch.float32)
    lead, t = x.shape[:-1], x.shape[-1]
    state = _flat_state(zi, x, order)
    c = state.shape[0]
    if c == 0 or t == 0:
        y = x.clone()
        return (y, state.reshape(lead + (order,))) if zi is not None else y
    dev = x.device
    chunk = CHUNK
    b32 = torch.as_tensor(bn, dtype=torch.float32, device=dev)
    a32 = torch.as_tensor(an, dtype=torch.float32, device=dev)
    xr = x.reshape(c, t)
    nc = -(-t // chunk)
    full = (nc - 1) * chunk
    chunks = xr[:, :full].reshape(c, nc - 1, chunk)

    zeros = torch.zeros((c, nc - 1, order), dtype=torch.float32, device=dev)
    _, u = df2t_scan(b32, a32, chunks, zeros)

    P = torch.as_tensor(np.array(carry_matrix(tuple(an.tolist()), chunk)), device=dev)
    s = state.to(torch.float64)
    s_in = [s]
    for j in range(nc - 1):
        acc = torch.zeros_like(s)
        for k in range(order):
            acc = acc + P[:, k] * s[:, k : k + 1]
        s = acc + u[:, j].to(torch.float64)
        s_in.append(s)
    s_in = torch.stack(s_in, dim=1).to(torch.float32)  # (C, nc, order)

    y_full, _ = df2t_scan(b32, a32, chunks, s_in[:, :-1])
    y_last, zf = df2t_scan(b32, a32, xr[:, full:], s_in[:, -1])
    y = torch.cat([y_full.reshape(c, full), y_last], dim=-1).reshape(lead + (t,))
    if zi is not None:
        return y, zf.reshape(lead + (order,))
    return y


@lru_cache(maxsize=32)
def _device_tables(bn: Tuple[float, ...], an: Tuple[float, ...], chunk: int,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The carry table P (f64) and the coefficients b then a (f32) on the
    card, uploaded once per filter, chunk length and device."""
    P = torch.as_tensor(np.array(carry_matrix(an, chunk)), device=device)
    coef = torch.tensor(bn + an, dtype=torch.float32, device=device)
    return P, coef


_F32P = ctypes.POINTER(ctypes.c_float)
_library = library("iir_df2t", {
    "iir_df2t_chunk_pass": (I32, PTR, PTR, PTR, PTR, PTR, PTR, _F32P, _F32P, I32, I64, I32, I32,
                            PTR),
    "iir_df2t_carry_pass": (PTR, PTR, PTR, PTR, I32, I32, I32, PTR),
})


def lfilter_cuda(b, a, x: torch.Tensor, zi: Optional[torch.Tensor] = None):
    """``scipy.signal.lfilter`` over the last axis, any order, with optional
    initial state: the sm_90a three-pass kernel for a CUDA tensor,
    :func:`lfilter_chunked_reference` for a CPU tensor. Returns ``y`` (and
    ``zf`` when ``zi`` is given). The chunk length is ``CHUNK``, read at
    each call."""
    global LAUNCHES
    if x.device.type == "cpu":
        return lfilter_chunked_reference(b, a, x, zi)
    if x.device.type != "cuda":
        raise ValueError(f"lfilter_cuda: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"lfilter_cuda: the kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("lfilter_cuda: x must be contiguous")
    bn, an = _normalised(b, a)
    order = bn.size - 1
    if order < 1:  # pure gain
        y = x * np.float32(bn[0])
        return (y, torch.as_tensor(zi, device=x.device)) if zi is not None else y

    lead, t = x.shape[:-1], x.shape[-1]
    state = _flat_state(zi, x, order)
    c = state.shape[0]
    if c == 0 or t == 0:
        y = x.clone()
        return (y, state.reshape(lead + (order,))) if zi is not None else y

    lib = _library()
    chunk = CHUNK
    nc = -(-t // chunk)
    P, coef = _device_tables(tuple(bn.tolist()), tuple(an.tolist()), chunk, x.device)
    y = torch.empty_like(x)
    zf = torch.empty_like(state)
    u = torch.empty((c, nc, order), dtype=torch.float32, device=x.device)
    s_in = torch.empty_like(u)
    b_c = (ctypes.c_float * (order + 1))(*bn.tolist())
    a_c = (ctypes.c_float * (order + 1))(*an.tolist())
    ptrs = [v.data_ptr() for v in (x, y, s_in, u, zf, coef)]
    with torch.cuda.device(x.device):
        cuda_stream = stream(x)
        passes = (
            ("pass 1", lambda: lib.iir_df2t_chunk_pass(
                0, *ptrs, b_c, a_c, c, t, chunk, order, cuda_stream)),
            ("pass 2", lambda: lib.iir_df2t_carry_pass(
                P.data_ptr(), state.data_ptr(), u.data_ptr(), s_in.data_ptr(),
                c, nc, order, cuda_stream)),
            ("pass 3", lambda: lib.iir_df2t_chunk_pass(
                1, *ptrs, b_c, a_c, c, t, chunk, order, cuda_stream)),
        )
        for name, launch in passes:
            launched(launch(), f"iir_df2t {name}", "order {}, {} rows x {} samples, chunk {}",
                     order, c, t, chunk)
    LAUNCHES += 1
    if zi is not None:
        return y, zf.reshape(lead + (order,))
    return y
