"""Griffin-Lim phase reconstruction and mel-spectrogram inversion.

Counterpart of ``decode_tonal_langauge_tpu/ops/griffinlim.py``: mel ->
power spectrogram by an accelerated projected-gradient NNLS solve, then
Griffin-Lim with momentum (librosa defaults: 32 iterations, momentum
0.99). Both take leading batch dimensions; the mel basis is shared.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..runtime.profiling import span
from .stft import hann, nola_sum, windowed_istft, windowed_stft


class NNLSConstants(NamedTuple):
    """What :func:`nnls_project` needs of ``A`` alone: ``A^T A``, the
    step 1/||A^T A||_2 (a 0-d tensor) and the pseudo-inverse that gives
    the first iterate."""

    AtA: torch.Tensor
    step: torch.Tensor
    pinv: torch.Tensor


def nnls_constants(A: torch.Tensor) -> NNLSConstants:
    """:class:`NNLSConstants` of ``A`` (m, n); the step from 30 steps of
    power iteration."""
    AtA = A.T @ A
    v = torch.ones(AtA.shape[0], dtype=A.dtype, device=A.device)
    v = v / np.sqrt(AtA.shape[0])
    for _ in range(30):
        v = AtA @ v
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
    step = 1.0 / torch.clamp(v @ (AtA @ v), min=1e-12)
    # JAX's pinv default cutoff: 10 * max(m, n) * eps of the largest
    # singular value.
    rtol = 10.0 * max(A.shape) * torch.finfo(A.dtype).eps
    return NNLSConstants(AtA, step, torch.linalg.pinv(A, rtol=rtol))


def nnls_project(A: torch.Tensor, B: torch.Tensor, n_iter: int = 100) -> torch.Tensor:
    """Nonnegative least squares ``min ||A X - B||`` by Nesterov projected
    gradient with step 1/||A^T A||_2 (power-iteration estimate).
    ``A``: (m, n); ``B``: (..., m, k) -> (..., n, k)."""
    with span("audio.nnls_setup"):
        constants = nnls_constants(A)
    return nnls_solve(A, B, constants, n_iter)


def nnls_solve(
    A: torch.Tensor, B: torch.Tensor, c: NNLSConstants, n_iter: int = 100
) -> torch.Tensor:
    """:func:`nnls_project` given ``A``'s :func:`nnls_constants`: fixed
    shapes and trip count, no host read of the device."""
    AtB = A.T @ B
    X = torch.clamp(c.pinv @ B, min=0.0)
    Y = X
    t = np.float32(1.0)  # the momentum sequence in f32, as in JAX
    for _ in range(n_iter):
        X_new = torch.clamp(Y - c.step * (c.AtA @ Y - AtB), min=0.0)
        t_new = np.float32(0.5) * (
            np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t)
        )
        Y = X_new + float((t - 1.0) / t_new) * (X_new - X)
        X, t = X_new, t_new
    return X


def mel_to_stft_mag(
    mel_spec: torch.Tensor, mel_basis: torch.Tensor, power: float = 2.0
) -> torch.Tensor:
    """Invert a mel power spectrogram to an STFT magnitude spectrogram."""
    return stft_magnitude(nnls_project(mel_basis, mel_spec), power)


def stft_magnitude(S: torch.Tensor, power: float = 2.0) -> torch.Tensor:
    """The STFT magnitude of NNLS's solution ``S`` (power ``power``)."""
    return torch.pow(torch.clamp(S, min=0.0), 1.0 / power)


def random_phase(shape, seed: int = 0, device=None) -> torch.Tensor:
    """Uniform phase in [-pi, pi) from a seeded CPU ``torch.Generator``."""
    g = torch.Generator().manual_seed(seed)
    phase = torch.rand(tuple(shape), generator=g) * (2 * np.pi) - np.pi
    return phase.to(device)


def griffinlim(
    S_mag: torch.Tensor,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_iter: int = 32,
    momentum: float = 0.99,
    length: Optional[int] = None,
    init_phase: Optional[torch.Tensor] = None,
    seed: int = 0,
) -> torch.Tensor:
    """Griffin-Lim with momentum. ``S_mag``: (..., 1 + n_fft//2, n_frames).

    ``init_phase`` (broadcast over the batch) sets the first phase; without
    it one phase of shape (1 + n_fft//2, n_frames) is drawn from ``seed``
    and shared by every trial, as the JAX version shares its key-0 draw.
    """
    if init_phase is None:
        init_phase = random_phase(S_mag.shape[-2:], seed, S_mag.device)
    window = hann(n_fft, torch.float32, S_mag.device)
    return griffinlim_windowed(S_mag, init_phase, window,
                               nola_sum(window, hop_length, S_mag.shape[-1]), hop_length,
                               n_iter, momentum, length)


def griffinlim_windowed(
    S_mag: torch.Tensor,
    init_phase: torch.Tensor,
    window: torch.Tensor,
    wsum: torch.Tensor,
    hop_length: int = 512,
    n_iter: int = 32,
    momentum: float = 0.99,
    length: Optional[int] = None,
) -> torch.Tensor:
    """:func:`griffinlim` given its first phase, its float32 window and
    the window's :func:`~.stft.nola_sum` over ``S_mag``'s frames: fixed
    shapes and trip count, no host read of the device."""
    angles = torch.exp(1j * init_phase.to(device=S_mag.device, dtype=torch.float32))
    S = S_mag.to(torch.complex64)
    angles = angles.expand(S.shape)
    tprev = torch.zeros_like(S)
    for _ in range(n_iter):
        rebuilt = windowed_stft(windowed_istft(S * angles, window, wsum, hop_length), window,
                                hop_length)
        new_angles = rebuilt - (momentum / (1.0 + momentum)) * tprev
        angles = new_angles / torch.clamp(new_angles.abs(), min=1e-16)
        tprev = rebuilt
    return windowed_istft(S * angles, window, wsum, hop_length, length=length)
