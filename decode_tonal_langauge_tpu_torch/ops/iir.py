"""IIR (Butterworth) filtering in PyTorch with SciPy-parity semantics.

Counterpart of ``decode_tonal_langauge_tpu/ops/iir.py``, with the same
routing. Filter design (Butterworth coefficients, steady-state initial
conditions, block-state tables) runs on the host with SciPy in float64.
Application runs on the tensor's device:

- short signals: the transposed-direct-form-II recurrence, one timestep
  at a time (:func:`~.cuda_iir.df2t_scan`);
- signals longer than ``IIR_SCAN_LIMIT``:
  - causal filtering at up to biquad order, or with no initial state via
    a biquad cascade, uses the block-state decomposition: in-block
    zero-state response as a Toeplitz matmul, a short scan over blocks,
    the homogeneous term as one matmul, and the ragged tail through the
    recurrence;
  - order > 2 with an initial state has no blocked form; in f32 it runs
    the exact recurrence as a time-chunked scan (``ops/cuda_iir.py``): the
    hand-written CUDA kernel on a card, its plain torch version on the
    CPU; other dtypes run the serial recurrence with a warning;
  - zero-phase filtering multiplies by the exact ``|H(f)|^2`` in the
    frequency domain (pow-2 padded rFFT).

Parity targets: ``scipy.signal.lfilter``, ``filtfilt`` (default "pad"
method) and ``sosfilt``.
"""

from __future__ import annotations

import warnings
from functools import lru_cache
from typing import Optional, Tuple, Union

import numpy as np
import scipy.linalg
import scipy.signal as sps
import torch

from .cuda_iir import df2t_scan, lfilter_cuda

IIR_SCAN_LIMIT = 8192
_IIR_BLOCK = 256


# ---------------------------------------------------------------------------
# Host-side design
# ---------------------------------------------------------------------------

def butter_design(
    order: int,
    freqs: Union[float, Tuple[float, float]],
    fs: float,
    filter_type: str = "bandpass",
    output: str = "ba",
):
    """Butterworth design (host-side). ``freqs`` in Hz."""
    wn = np.asarray(freqs, dtype=float) / (0.5 * fs)
    return sps.butter(order, wn, btype=filter_type, output=output)


def lfilter_zi(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Steady-state initial conditions (host-side, static per filter)."""
    return sps.lfilter_zi(b, a)


# ---------------------------------------------------------------------------
# Block-state decomposition (long signals)
# ---------------------------------------------------------------------------

def _ba_state_space(b: np.ndarray, a: np.ndarray):
    """DF2T state-space (A, B, b0) of a normalised (b, a) filter:
    ``s[t] = A s[t-1] + B x[t]``, ``y[t] = s[t-1][0] + b0 x[t]``."""
    n = max(len(b), len(a))
    b = np.pad(np.asarray(b, dtype=np.float64), (0, n - len(b)))
    a = np.pad(np.asarray(a, dtype=np.float64), (0, n - len(a)))
    b, a = b / a[0], a / a[0]
    m = n - 1
    A = np.zeros((m, m))
    A[:, 0] = -a[1:]
    A[:-1, 1:] = np.eye(m - 1)
    return A, b[1:] - a[1:] * b[0], float(b[0])


def _block_iir_tables(b, a, block: int):
    return _block_iir_tables_cached(
        tuple(np.asarray(b, np.float64).tolist()),
        tuple(np.asarray(a, np.float64).tolist()),
        block,
    )


@lru_cache(maxsize=64)
def _block_iir_tables_cached(b, a, block: int):
    """Host float64 tables (T, M, K, P) of the block-state form:
    T (block, block) Toeplitz of the truncated impulse response,
    M (block, m) with M[i] = C A^i, K (m, block) with
    K[:, k] = A^{block-1-k} B, and P = A^block."""
    A, B, b0 = _ba_state_space(b, a)
    m = A.shape[0]
    C = np.zeros(m)
    C[0] = 1.0
    h = np.zeros(block)
    M = np.zeros((block, m))
    K = np.zeros((m, block))
    h[0] = b0
    Apow = np.eye(m)
    for i in range(block):
        M[i] = C @ Apow
        K[:, block - 1 - i] = Apow @ B
        if i + 1 < block:
            h[i + 1] = C @ Apow @ B
        Apow = Apow @ A
    T = scipy.linalg.toeplitz(h, np.zeros(block))
    return T, M, K, Apow


def _lfilter_blocked_core(T, M, K, P, x, s0, block: int):
    """``x``: (..., T) with T % block == 0; ``s0``: (..., m).
    Returns (y, s_final)."""
    lead = x.shape[:-1]
    nb = x.shape[-1] // block
    xb = x.reshape(-1, nb, block)  # (R, nb, L)
    y_zs = torch.einsum("rjl,kl->rjk", xb, T)
    u = torch.einsum("ml,rjl->rjm", K, xb)
    s = s0.reshape(xb.shape[0], -1)
    s_in = []
    Pt = P.t()
    for j in range(nb):  # short sequential scan over blocks
        s_in.append(s)
        s = s @ Pt + u[:, j]
    y_hom = torch.einsum("lm,jrm->rjl", M, torch.stack(s_in))
    y = (y_zs + y_hom).reshape(lead + (nb * block,))
    return y, s.reshape(lead + (P.shape[0],))


def lfilter_blocked(b, a, x: torch.Tensor, zi=None, block: int = _IIR_BLOCK):
    """``scipy.signal.lfilter`` over the last axis via the block-state
    decomposition. Returns ``y`` (and ``zf`` when ``zi`` is given)."""
    t = x.shape[-1]
    tables = _block_iir_tables(b, a, block)
    T, M, K, P = (
        torch.as_tensor(v, dtype=x.dtype, device=x.device) for v in tables
    )
    m = P.shape[0]
    if zi is None:
        s0 = torch.zeros(x.shape[:-1] + (m,), dtype=x.dtype, device=x.device)
    else:
        s0 = torch.as_tensor(zi, dtype=x.dtype, device=x.device).broadcast_to(
            x.shape[:-1] + (m,)
        )
    t_full = (t // block) * block
    y, zf = _lfilter_blocked_core(T, M, K, P, x[..., :t_full], s0, block)
    if t_full < t:
        # Ragged tail (< one block): the exact recurrence, seeded with the
        # blocked pass's final state.
        y_tail, zf = _lfilter_scan_path(b, a, x[..., t_full:], zf)
        y = torch.cat([y, y_tail], dim=-1)
    if zi is not None:
        return y, zf
    return y


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def lfilter(b, a, x: torch.Tensor, zi=None, axis: int = -1):
    """SciPy-compatible ``lfilter``. Returns y (and zf when zi is given).

    Long signals route to the block-state decomposition: directly up to
    biquad order, via a tf2sos biquad cascade above it with no initial
    state. Above biquad order WITH an initial state, the exact recurrence
    runs as the chunked scan of ``ops/cuda_iir.py`` (f32).
    """
    x_moved = x.movedim(axis, -1)
    order = max(len(np.atleast_1d(b)), len(np.atleast_1d(a))) - 1
    if x_moved.shape[-1] > IIR_SCAN_LIMIT and (order <= 2 or zi is None):
        if order <= 2:
            result = lfilter_blocked(np.asarray(b), np.asarray(a), x_moved, zi=zi)
            if zi is not None:
                y, zf = result
                return y.movedim(-1, axis), zf
            return result.movedim(-1, axis)
        sos_np = sps.tf2sos(np.asarray(b, np.float64), np.asarray(a, np.float64))
        y = x_moved
        for section in sos_np:
            y = lfilter_blocked(section[:3], section[3:], y)
        return y.movedim(-1, axis)
    if x_moved.shape[-1] > IIR_SCAN_LIMIT:
        # order > 2 with zi: a tf-form initial state has no per-biquad
        # decomposition, so the blocked cascade cannot honor it. In f32 the
        # exact recurrence runs as the chunked scan: the CUDA kernel on a
        # card, its plain torch version on the CPU.
        if x_moved.dtype == torch.float32:
            y, zf = lfilter_cuda(b, a, x_moved.contiguous(), zi=zi)
            return y.movedim(-1, axis), zf
        _warn_sequential(order, x_moved.shape[-1])

    y, zf = _lfilter_scan_path(b, a, x_moved, zi)
    y = y.movedim(-1, axis)
    if zi is not None:
        return y, zf
    return y


def _warn_sequential(order: int, t: int) -> None:
    warnings.warn(
        f"lfilter: order-{order} filter with zi on a {t}-sample signal runs "
        "the sequential timestep scan (no blocked path exists for tf-form "
        "initial state above biquad order, and the chunked scan takes "
        "float32 only); expect it to be slow. Split the filter "
        "into SOS sections with per-section zi, or pass zi=None to use the "
        "blocked biquad cascade.",
        stacklevel=3,
    )


def _lfilter_scan_path(b, a, x: torch.Tensor, zi):
    """Normalise/pad the coefficients in x's dtype and run the exact
    timestep recurrence over the last axis (also used directly by
    ``filtfilt``, whose odd extension must not re-enter ``lfilter``'s
    long-signal dispatch)."""
    b = torch.as_tensor(np.atleast_1d(b), dtype=x.dtype, device=x.device)
    a = torch.as_tensor(np.atleast_1d(a), dtype=x.dtype, device=x.device)
    b, a = b / a[0], a / a[0]
    n = max(b.shape[0], a.shape[0])
    b = torch.nn.functional.pad(b, (0, n - b.shape[0]))
    a = torch.nn.functional.pad(a, (0, n - a.shape[0]))
    state_shape = x.shape[:-1] + (n - 1,)
    if zi is None:
        zi_t = torch.zeros(state_shape, dtype=x.dtype, device=x.device)
    else:
        zi_t = torch.as_tensor(zi, dtype=x.dtype, device=x.device).broadcast_to(
            state_shape
        )
    return df2t_scan(b, a, x, zi_t)


def _odd_extend(x: torch.Tensor, padlen: int) -> torch.Tensor:
    left = 2 * x[..., :1] - x[..., 1 : padlen + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -padlen - 1 : -1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def filtfilt(b, a, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Zero-phase forward-backward filtering, SciPy default semantics
    (odd extension of length ``3*max(len(a), len(b))``, steady-state
    initial conditions scaled by the first padded sample). Long signals
    run through :func:`sos_filtfilt_fft`."""
    b_np = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a_np = np.atleast_1d(np.asarray(a, dtype=np.float64))
    padlen = 3 * max(len(a_np), len(b_np))
    x = x.movedim(axis, -1)
    if x.shape[-1] <= padlen:
        raise ValueError(
            f"The length of the input vector x must be greater than padlen={padlen}."
        )
    if x.shape[-1] > IIR_SCAN_LIMIT:
        return sos_filtfilt_fft(sps.tf2sos(b_np, a_np), x).movedim(-1, axis)

    ext = _odd_extend(x, padlen)
    zi = torch.as_tensor(lfilter_zi(b_np, a_np), dtype=x.dtype, device=x.device)
    y, _ = _lfilter_scan_path(b_np, a_np, ext, zi * ext[..., :1])
    y = y.flip(-1)
    y, _ = _lfilter_scan_path(b_np, a_np, y, zi * y[..., :1])
    y = y.flip(-1)
    return y[..., padlen:-padlen].movedim(-1, axis)


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def sos_filtfilt_fft(sos_np: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase SOS filtering by the exact squared magnitude response.

    ``filtfilt`` is multiplication by |H(f)|^2; applied in the frequency
    domain it has no recursion, so it stays accurate in f32 even for
    near-DC bands. |H|^2 is evaluated on the host in f64 at the padded FFT
    bins; the pow-2 zero padding, at least the dominant pole's 60 dB decay
    length, absorbs the circular-convolution wrap. Edges use the odd
    extension of SciPy's ``sosfiltfilt``.
    """
    t = x.shape[-1]
    padlen = min(3 * (2 * len(sos_np) + 1), t - 1)
    ext = _odd_extend(x, padlen)
    t_ext = ext.shape[-1]
    _, poles, _ = sps.sos2zpk(sos_np)
    r_max = float(np.max(np.abs(poles))) if len(poles) else 0.0
    if 0.0 < r_max < 1.0:
        n_decay = int(np.log(1e-3) / np.log(r_max)) + 1
    else:
        n_decay = 4096
    n_decay = min(n_decay, 1 << 22)
    nfft = _next_pow2(t_ext + max(t_ext // 4, n_decay, 4096))

    w = 2.0 * np.pi * np.fft.rfftfreq(nfft)
    _, h = sps.sosfreqz(sos_np, worN=w)
    h2 = torch.as_tensor((h * np.conj(h)).real, dtype=torch.float32,
                         device=x.device)
    X = torch.fft.rfft(ext, n=nfft, dim=-1)
    y = torch.fft.irfft(X * h2, n=nfft, dim=-1)
    return y[..., padlen : padlen + t].to(x.dtype)


def sosfilt(sos, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Causal second-order-section filtering (zero initial conditions).
    Long signals apply each biquad by the block-state decomposition."""
    x = x.movedim(axis, -1)
    sos_np = np.asarray(sos, dtype=np.float64)
    y = x
    for section in sos_np:
        if x.shape[-1] > IIR_SCAN_LIMIT:
            y = lfilter_blocked(section[:3], section[3:], y)
        else:
            y, _ = _lfilter_scan_path(section[:3], section[3:], y, None)
    return y.movedim(-1, axis)


def butter_filter(
    data: torch.Tensor,
    freqs: Union[float, Tuple[float, float]],
    fs: float,
    order: int = 4,
    causal: bool = False,
    filter_type: str = "bandpass",
) -> torch.Tensor:
    """Butterworth band/low/high-pass with the reference's dispatch:
    ``causal=False`` -> zero-phase, ``causal=True`` -> ``sosfilt``. Long
    recordings run zero-phase through an SOS design directly (the
    order-2N ``(b, a)`` polynomial of an extreme band is too
    ill-conditioned to factor)."""
    if causal:
        sos = butter_design(order, freqs, fs, filter_type, output="sos")
        return sosfilt(sos, data)
    if data.shape[-1] > IIR_SCAN_LIMIT:
        sos = butter_design(order, freqs, fs, filter_type, output="sos")
        return sos_filtfilt_fft(sos, data)
    b, a = butter_design(order, freqs, fs, filter_type, output="ba")
    return filtfilt(b, a, data)
