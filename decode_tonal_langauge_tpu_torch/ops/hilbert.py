"""Gaussian Hilbert filter-bank analytic amplitude (the high-gamma
envelope).

Counterpart of ``decode_tonal_langauge_tpu/ops/hilbert.py``:

    X = fft(data)                       # once, batched over channels
    for each bank b:                    # memory stays O(C*T)
        acc += |ifft(X * K_b)|          # K_b = gaussian(f; fc_b, sigma_b) * hilbert_mult
    envelope = acc / n_banks

The bank design (log-spaced centers, log-linear sigma model) is host-side
numpy from static config; the banks are summed in the same order as the
JAX scan. :func:`hilbert_filter_blocked` applies the bank by
overlap-discard over fixed-length chunks, all chunks in one batched FFT.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

FreqRange = Union[Tuple[float, float], Sequence[float]]


def gaussian_bank_params(
    freq_ranges: Union[List[FreqRange], FreqRange],
    f0: float = 0.018,
    octspace: float = 1.0 / 7.0,
    filterbank_bias: float = math.log10(0.39),
    filterbank_slope: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Center frequencies and (sqrt(2)-scaled) sigmas of the Gaussian bank:
    start at ``f0``, multiply by ``2**octspace`` until ``log2(f/f0)``
    reaches the range's max octave, keep frequencies at or above the
    range minimum."""
    if isinstance(freq_ranges, tuple):
        freq_ranges = [freq_ranges]
    if len(freq_ranges) > 0 and isinstance(freq_ranges[0], (int, float)):
        freq_ranges = [tuple(freq_ranges)]

    center_freqs: List[float] = []
    sigma_fs: List[float] = []
    for freq_range in freq_ranges:
        if len(freq_range) != 2:
            raise ValueError(
                "Each frequency range must be a (min_freq, max_freq) pair."
            )
        min_freq, max_freq = float(freq_range[0]), float(freq_range[1])
        max_oct = math.log2(max_freq / f0)

        f = f0
        while math.log2(f / f0) < max_oct:
            if f >= min_freq:
                center_freqs.append(f)
                sigma_fs.append(
                    10 ** (filterbank_bias + filterbank_slope * math.log10(f))
                )
            f = f * (2 ** octspace)

    centers = np.asarray(center_freqs, dtype=np.float64)
    sigmas = np.asarray(sigma_fs, dtype=np.float64) * np.sqrt(2.0)
    return centers, sigmas


def hilbert_multiplier(n: int) -> np.ndarray:
    """One-sided spectrum multiplier of the analytic signal (length ``n``)."""
    mult = np.zeros(n, dtype=np.float64)
    if n % 2 == 0:
        mult[0] = 1.0
        mult[1 : n // 2] = 2.0
        mult[n // 2] = 1.0
    else:
        mult[0] = 1.0
        mult[1 : (n + 1) // 2] = 2.0
    return mult


def bank_kernels(
    n: int, sampling_rate: float, centers: np.ndarray, sigmas: np.ndarray
) -> np.ndarray:
    """Frequency-domain kernels ``K[b, f] = gaussian * hilbert_mult`` (host)."""
    freqs = np.fft.fftfreq(n, d=1.0 / sampling_rate)
    H = np.exp(-0.5 * ((freqs[None, :] - centers[:, None]) / sigmas[:, None]) ** 2)
    H[:, 0] = 0.0  # remove DC
    return H * hilbert_multiplier(n)[None, :]


def _bank_sum(X: torch.Tensor, kernels: torch.Tensor, envelope: bool) -> torch.Tensor:
    """Mean over banks of ``|ifft(X * K_b)|`` (or its real part), summed
    in f32 in bank order. ``X``: (..., n) complex; ``kernels``: (B, n)."""
    acc = torch.zeros(X.shape, dtype=torch.float32, device=X.device)
    for kernel in kernels:
        sig = torch.fft.ifft(X * kernel, dim=-1)
        acc = acc + (sig.abs() if envelope else sig.real)
    return acc / kernels.shape[0]


def _bank(freq_ranges, n, sampling_rate, device, **bank_kwargs) -> torch.Tensor:
    centers, sigmas = gaussian_bank_params(freq_ranges, **bank_kwargs)
    if centers.size == 0:
        raise ValueError("Filter bank is empty for the given frequency ranges.")
    kernels = bank_kernels(n, sampling_rate, centers, sigmas)
    return torch.as_tensor(kernels, dtype=torch.float32, device=device)


def hilbert_filter(
    data: torch.Tensor,
    sampling_rate: float,
    freq_ranges: Union[List[FreqRange], FreqRange],
    f0: float = 0.018,
    octspace: float = 1.0 / 7.0,
    filterbank_bias: float = math.log10(0.39),
    filterbank_slope: float = 0.5,
    envelope: bool = True,
) -> torch.Tensor:
    """Gaussian Hilbert filter-bank envelope of (..., T) data, one
    full-length FFT."""
    kernels = _bank(
        freq_ranges, data.shape[-1], sampling_rate, data.device, f0=f0,
        octspace=octspace, filterbank_bias=filterbank_bias,
        filterbank_slope=filterbank_slope,
    )
    X = torch.fft.fft(data, dim=-1)
    return _bank_sum(X, kernels, envelope).to(data.dtype)


def hilbert_filter_blocked(
    data: torch.Tensor,
    sampling_rate: float,
    freq_ranges: Union[List[FreqRange], FreqRange],
    chunk: int = 8192,
    overlap: int = 1024,
    envelope: bool = True,
    **bank_kwargs,
) -> torch.Tensor:
    """Overlap-discard bank application for long recordings: chunks of
    ``chunk`` samples every ``chunk - 2*overlap``, each chunk's first and
    last ``overlap`` outputs discarded. The kernels are built for length
    ``chunk``; every chunk goes through one batched FFT."""
    kernels = _bank(freq_ranges, chunk, sampling_rate, data.device, **bank_kwargs)
    t = data.shape[-1]
    step = chunk - 2 * overlap
    n_steps = -(-t // step)
    # The JAX op's padding, so that the chunks see the same zeros.
    pad_total = overlap + (n_steps * step + overlap + chunk) - t
    xp = F.pad(data, (overlap, pad_total))
    segs = xp.unfold(-1, chunk, step)[..., :n_steps, :]  # (..., n_steps, chunk)
    out = _bank_sum(torch.fft.fft(segs, dim=-1), kernels, envelope)
    out = out[..., overlap : chunk - overlap].reshape(data.shape[:-1] + (n_steps * step,))
    return out[..., :t].to(data.dtype)
