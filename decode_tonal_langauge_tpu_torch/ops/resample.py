"""Resampling: FFT (short signals) and polyphase FIR (long).

Counterpart of ``decode_tonal_langauge_tpu/ops/resample.py``, with the
same routing and the same host-side filter design:

- :func:`fft_resample`: ``scipy.signal.resample`` numerics as rFFT ->
  spectrum truncate/pad -> irFFT, batched over channels.
- :func:`polyphase_resample`: ``scipy.signal.resample_poly`` numerics.
  Up to ``_CONV_PHASE_LIMIT`` phases it is one strided ``conv1d`` whose
  ``up`` output channels are the phases, in full f32 (cuDNN would
  otherwise compute in TF32; the JAX op asks for ``Precision.HIGHEST``).
  Above it (odd rational rates such as TDT's 3051.7578125 Hz) it gathers
  a window of taps per output sample, in slices of the output so that
  the windows never take more than ``_GATHER_ELEMENTS`` floats at once.

:func:`resample_to_rate` picks between them by length
(``FFT_LENGTH_LIMIT``) and keeps the reference's output-length rule.
"""

from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime.device import exact_f32

# Above this many input samples resample_to_rate switches from the FFT
# method to the polyphase FIR (the JAX package's threshold, kept so that
# both packages take the same route and agree).
FFT_LENGTH_LIMIT = 16384

# Above this many phases the gather form replaces the strided conv.
_CONV_PHASE_LIMIT = 256

# Floats in one slice of the gather form's (C, slice, J) window tensor.
_GATHER_ELEMENTS = 1 << 27


def fft_resample(x: torch.Tensor, num: int) -> torch.Tensor:
    """Resample real ``x`` to ``num`` points along the last axis, as
    ``scipy.signal.resample``: copy the shared positive-frequency bins,
    fold or split the Nyquist bin, inverse transform at the new length and
    rescale by ``num / Nx``."""
    nx = x.shape[-1]
    if num == nx:
        return x

    X = torch.fft.rfft(x, dim=-1)
    n_shared = min(num, nx)
    nyq = n_shared // 2 + 1

    Y = torch.zeros(x.shape[:-1] + (num // 2 + 1,), dtype=X.dtype, device=x.device)
    Y[..., :nyq] = X[..., :nyq]
    if n_shared % 2 == 0:
        if num < nx:
            # Downsampling: fold the energy of the (now highest) Nyquist bin.
            Y[..., n_shared // 2] *= 2.0
        elif num > nx:
            # Upsampling: the old Nyquist bin splits into two half-bins.
            Y[..., n_shared // 2] *= 0.5
    if num % 2 == 0:
        # A real signal's Nyquist bin is real. pocketfft's inverse ignores
        # an imaginary part there; cuFFT's need not, so drop it here.
        Y[..., -1] = Y[..., -1].real.to(Y.dtype)

    y = torch.fft.irfft(Y, n=num, dim=-1)
    return (y * (float(num) / float(nx))).to(x.dtype)


def resample_poly_filter(up: int, down: int) -> np.ndarray:
    """Anti-aliasing FIR of ``scipy.signal.resample_poly``: Kaiser(5.0)
    windowed sinc, cutoff at the tighter Nyquist rate, 20*max(up, down)+1
    taps, gain ``up`` (host-side, float64)."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    n_taps = 2 * half_len + 1
    cutoff = 1.0 / max_rate  # in units of the upsampled Nyquist

    m = np.arange(n_taps) - half_len
    h = cutoff * np.sinc(cutoff * m)
    h *= np.kaiser(n_taps, 5.0)
    h *= up / h.sum()  # unit DC gain, then compensate the zero-stuffing
    return h.astype(np.float64)


@lru_cache(maxsize=32)
def _polyphase_tables(up: int, down: int):
    """Cached (weights, pad_left) for a rate pair."""
    return _polyphase_conv_weights(up, down, resample_poly_filter(up, down))


def _polyphase_conv_weights(up: int, down: int, h: np.ndarray):
    """Pack the polyphase decomposition of ``h`` into strided-conv weights.

    Output sample ``m = q + r*up`` of ``upfirdn(h, x, up, down)`` cropped
    at the filter center is ``y[m] = sum_j h[up*j + P_q] * x[r*down + B_q - j]``
    with ``P_q = (q*down + D) % up``, ``B_q = (q*down + D) // up`` and
    ``D = (len(h)-1)//2``. Folding ``B_q`` into the tap position makes the
    ``up`` phases output channels of one conv with stride ``down``: weight
    ``w[q, t]`` multiplies ``x[r*down + t + s0]``.

    Returns ``(w, pad_left)``: ``w`` is (up, 1, W) and ``pad_left = -s0``.
    """
    L = len(h)
    D = (L - 1) // 2
    J = -(-L // up)  # taps per phase
    q = np.arange(up)
    P = (q * down + D) % up
    B = (q * down + D) // up
    s0 = int(B.min()) - (J - 1)
    W = int(B.max()) - s0 + 1

    w = np.zeros((up, 1, W), dtype=np.float64)
    j = np.arange(J)
    for qi in range(up):
        t = B[qi] - j - s0  # position of tap j of phase qi
        k = up * j + P[qi]  # index into h
        valid = (k >= 0) & (k < L)
        w[qi, 0, t[valid]] = h[k[valid]]
    return w, -s0


def _polyphase_apply(
    x: torch.Tensor, w: np.ndarray, up: int, down: int, n_out: int, pad_left: int
) -> torch.Tensor:
    """Strided conv + phase interleave. ``x``: (C, T) -> (C, n_out)."""
    n_blocks = -(-n_out // up)  # output positions per phase
    t_in = x.shape[-1]
    w_len = w.shape[-1]
    # rightmost input index touched: (n_blocks-1)*down + w_len-1 - pad_left
    need = (n_blocks - 1) * down + w_len - pad_left
    pad_right = max(0, need - t_in)

    xp = F.pad(x[:, None, :].to(torch.float32), (pad_left, pad_right))
    weight = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    with exact_f32():
        out = F.conv1d(xp, weight, stride=down)[..., :n_blocks]  # (C, up, n_blocks)
    y = out.transpose(1, 2).reshape(x.shape[0], n_blocks * up)
    return y[:, :n_out].to(x.dtype)


@lru_cache(maxsize=32)
def _phase_tap_table(up: int, down: int):
    """(Hphase (up, J), D): per-phase tap table for the gather form,
    ``y[m] = sum_j Hphase[(m*down + D) % up, j] * x[(m*down + D)//up - j]``."""
    h = resample_poly_filter(up, down)
    L = len(h)
    D = (L - 1) // 2
    J = -(-L // up)
    Hphase = np.zeros((up, J))
    for q in range(up):
        k = up * np.arange(J) + q
        valid = k < L
        Hphase[q, valid] = h[k[valid]]
    return Hphase, D


def _polyphase_apply_gather(
    x: torch.Tensor, Hphase: np.ndarray, D: int, up: int, down: int, n_out: int
) -> torch.Tensor:
    """Gather form: a window of J input samples per output, taps selected
    by the output's phase, zero outside the signal. (C, T) -> (C, n_out).
    Runs over slices of the output so the (C, slice, J) windows stay under
    ``_GATHER_ELEMENTS`` floats."""
    J = Hphase.shape[1]
    t_in = x.shape[-1]
    dev = x.device
    table = torch.as_tensor(Hphase, dtype=torch.float32, device=dev)
    xf = x.to(torch.float32)
    step = max(1, _GATHER_ELEMENTS // max(1, x.shape[0] * J))
    pieces = []
    for m0 in range(0, n_out, step):
        m = torch.arange(m0, min(n_out, m0 + step), device=dev)
        pos = m * down + D
        idx = (pos // up)[:, None] - torch.arange(J, device=dev)[None, :]
        valid = (idx >= 0) & (idx < t_in)
        taps = torch.where(valid, table[pos % up], torch.zeros((), device=dev))
        xw = xf[:, idx.clamp(0, t_in - 1)]  # (C, slice, J)
        pieces.append((xw * taps).sum(dim=-1))
    return torch.cat(pieces, dim=-1).to(x.dtype)


def polyphase_resample(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """``scipy.signal.resample_poly(x, up, down, axis=-1)`` on ``x``'s
    device. ``x`` is (..., T) real; leading axes are flattened into the
    batch."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x

    n_out = -(-x.shape[-1] * up // down)
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    if up <= _CONV_PHASE_LIMIT:
        w, pad_left = _polyphase_tables(up, down)
        y = _polyphase_apply(flat, w, up, down, n_out, pad_left)
    else:
        Hphase, D = _phase_tap_table(up, down)
        y = _polyphase_apply_gather(flat, Hphase, D, up, down, n_out)
    return y.reshape(lead + (n_out,))


def resample_to_rate(
    x: torch.Tensor, orig_sr: float, target_sr: float, method: str = "auto"
) -> torch.Tensor:
    """Resample so the sampling rate becomes ``target_sr``, with the
    reference's sample-count rule ``int(T * target / orig)``. ``method``:
    ``"fft"``, ``"poly"``, or ``"auto"`` (FFT up to ``FFT_LENGTH_LIMIT``
    input samples, polyphase beyond)."""
    t_in = x.shape[-1]
    num = int(t_in * (target_sr / orig_sr))
    if method == "auto":
        method = "fft" if t_in <= FFT_LENGTH_LIMIT else "poly"
    if method == "fft":
        return fft_resample(x, num)
    if method != "poly":
        raise ValueError(f"method must be fft/poly/auto, got {method!r}")

    frac = (Fraction(target_sr) / Fraction(orig_sr)).limit_denominator(10_000)
    up, down = frac.numerator, frac.denominator
    # Pad the input with its last sample until the polyphase output has at
    # least num samples, so the tail is computed from signal, not zeros.
    t_need = -(-num * down // up)
    if t_need > t_in:
        edge = x[..., -1:].expand(x.shape[:-1] + (t_need - t_in,))
        x = torch.cat([x, edge], dim=-1)
    return polyphase_resample(x, up, down)[..., :num]
