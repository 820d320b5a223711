"""STFT / iSTFT and mel filterbank with librosa conventions.

Counterpart of ``decode_tonal_langauge_tpu/ops/stft.py``: periodic Hann
window, ``center=True`` zero padding, frame count
``1 + (len(padded) - n_fft) // hop``; Slaney mel scale with Slaney area
normalisation; ``power_to_db(ref=max, amin=1e-10, top_db=80)`` and
``db_to_power``. The transforms take leading batch dimensions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (``fftbins=True``)."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def hz_to_mel(f) -> np.ndarray:
    """Slaney mel scale (htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    safe = np.maximum(f, 1e-10)
    return np.where(
        f >= min_log_hz, min_log_mel + np.log(safe / min_log_hz) / logstep,
        f / f_sp,
    )


def mel_to_hz(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
        m * f_sp,
    )


def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank (n_mels, 1 + n_fft//2)."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    return weights * enorm[:, None]


def hann(n_fft: int, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """:func:`hann_window` as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(hann_window(n_fft), dtype=dtype, device=device)


def _window(n_fft: int, like: torch.Tensor) -> torch.Tensor:
    dtype = like.real.dtype if like.is_complex() else like.dtype
    return hann(n_fft, dtype, like.device)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(N, n_frames, n_fft) -> (N, n_fft + hop_length * (n_frames - 1))."""
    n, n_frames, n_fft = frames.shape
    total = n_fft + hop_length * (n_frames - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, total),
                 kernel_size=(1, n_fft), stride=(1, hop_length))
    return out.reshape(n, total)


def nola_sum(window: torch.Tensor, hop_length: int, n_frames: int) -> torch.Tensor:
    """What :func:`istft` divides by: the squared window overlap-added
    over ``n_frames`` frames, clamped at 1e-10."""
    n_fft = window.shape[-1]
    wsum = _overlap_add((window ** 2).expand(1, n_frames, n_fft), hop_length)[0]
    return torch.clamp(wsum, min=1e-10)


def stft(
    y: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
    center: bool = True,
) -> torch.Tensor:
    """Complex STFT (..., T) -> (..., 1 + n_fft//2, n_frames)."""
    return windowed_stft(y, _window(n_fft, y), hop_length, center)


def windowed_stft(
    y: torch.Tensor, window: torch.Tensor, hop_length: int = 512, center: bool = True,
) -> torch.Tensor:
    """:func:`stft` with its window given (``n_fft`` is its length)."""
    n_fft = window.shape[-1]
    if center:
        y = F.pad(y, (n_fft // 2, n_fft // 2))  # zero pad, as stft.py:101
    frames = y.unfold(-1, n_fft, hop_length) * window
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def stft_magsq(
    y: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
    center: bool = True,
) -> torch.Tensor:
    """|STFT|^2 -> (..., 1 + n_fft//2, n_frames), float32."""
    X = stft(y, n_fft, hop_length, center)
    return (X.real ** 2 + X.imag ** 2).to(torch.float32)


def istft(
    X: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT (center=True) with Hann-window NOLA normalisation:
    (..., 1 + n_fft//2, n_frames) -> (..., n_samples)."""
    window = _window(n_fft, X)
    return windowed_istft(X, window, nola_sum(window, hop_length, X.shape[-1]),
                          hop_length, length)


def windowed_istft(
    X: torch.Tensor, window: torch.Tensor, wsum: torch.Tensor, hop_length: int = 512,
    length: Optional[int] = None,
) -> torch.Tensor:
    """:func:`istft` with its window and its :func:`nola_sum` given."""
    n_fft = window.shape[-1]
    frames = torch.fft.irfft(X.transpose(-1, -2), n=n_fft, dim=-1) * window
    lead, n_frames = frames.shape[:-2], frames.shape[-2]
    y = _overlap_add(frames.reshape(-1, n_frames, n_fft), hop_length)
    y = y.reshape(lead + y.shape[-1:]) / wsum
    y = y[..., n_fft // 2 : y.shape[-1] - n_fft // 2]
    if length is not None:
        if y.shape[-1] < length:
            # The analysis dropped a partial tail frame; zero-fill it.
            y = F.pad(y, (0, length - y.shape[-1]))
        y = y[..., :length]
    return y


def power_to_db(
    S: torch.Tensor,
    ref: Optional[float] = None,
    amin: float = 1e-10,
    top_db: Optional[float] = 80.0,
) -> torch.Tensor:
    """librosa ``power_to_db``; ``ref=None`` means ``ref=max(S)``."""
    ref_value = torch.max(S) if ref is None else torch.as_tensor(abs(ref))
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref_value, min=amin))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, torch.max(log_spec) - top_db)
    return log_spec


def db_to_power(S_db: torch.Tensor, ref: float = 1.0) -> torch.Tensor:
    return ref * torch.pow(10.0, 0.1 * S_db)
