"""Mel -> waveform, plainly: dB to power, NNLS onto the STFT magnitude,
Griffin-Lim with momentum (librosa's conventions and defaults).

- The mel basis is Slaney's: triangular filters between Slaney-mel-spaced
  edges, area-normalised (librosa ``filters.mel``, htk=False).
- dB to power with the reference's ref of 1e-4: ``1e-4 * 10**(mel / 10)``.
- NNLS ``min ||A X - B||, X >= 0`` by Nesterov's projected gradient,
  step 1 / ||A^T A|| (30 power iterations from a flat vector), started
  from the pseudo-inverse solution clipped at 0 (singular values cut at
  10 * max(m, n) float32 epsilons of the largest: the float32
  configuration's cut), 100 iterations; the magnitude is its square root.
- Griffin-Lim: 32 iterations, momentum 0.99, a given first phase,
  periodic Hann window, centred frames padded with zeros; torch's own
  ``stft`` and ``istft``.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import Precision


def mel_basis(sr: float, n_fft: int, n_mels: int) -> np.ndarray:
    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                        m * (200.0 / 3))

    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    edges = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2))
    widths = np.diff(edges)
    ramps = edges[:, None] - freqs[None, :]
    lower = -ramps[:-2] / widths[:-1, None]
    upper = ramps[2:] / widths[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (edges[2:] - edges[:-2]))[:, None]


def nnls(a: torch.Tensor, b: torch.Tensor, prec: Precision, n_iter: int = 100) -> torch.Tensor:
    """(m, n) and (..., m, k) -> (..., n, k)."""
    ata = prec.operand(a.T) @ prec.operand(a)
    atb = prec.operand(a.T) @ prec.operand(b)
    v = torch.ones(ata.shape[0], dtype=a.dtype, device=a.device) / np.sqrt(ata.shape[0])
    for _ in range(30):
        v = ata @ v
        v = v / v.norm().clamp_min(1e-12)
    step = 1.0 / (v @ (ata @ v)).clamp_min(1e-12)
    rtol = 10.0 * max(a.shape) * float(np.finfo(np.float32).eps)
    x = (torch.linalg.pinv(a, rtol=rtol) @ prec.operand(b)).clamp_min(0.0)
    y, t = x, 1.0
    for _ in range(n_iter):
        x_new = (y - step * (prec.operand(ata) @ prec.operand(y) - atb)).clamp_min(0.0)
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        y = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


def waveform(mels_db: torch.Tensor, n_mels: int, sr: float, n_fft: int, hop: int,
             init_phase: torch.Tensor, prec: Precision, n_iter: int = 32,
             momentum: float = 0.99) -> torch.Tensor:
    """(B, n_mels * n_frames) dB mels -> (B, hop * (n_frames - 1)) waves."""
    dt = prec.dtype
    cdt = torch.complex128 if dt == torch.float64 else torch.complex64
    mel = 1e-4 * torch.pow(10.0, 0.1 * mels_db.to(dt).reshape(mels_db.shape[0], n_mels, -1))
    a = torch.as_tensor(mel_basis(sr, n_fft, n_mels), dtype=dt, device=mels_db.device)
    mag = nnls(a, mel, prec).clamp_min(0.0).sqrt().to(cdt)
    window = torch.hann_window(n_fft, periodic=True, dtype=dt, device=mels_db.device)

    def istft(spec):
        return torch.istft(spec, n_fft, hop, window=window, center=True)

    def stft(y):
        return torch.stft(y, n_fft, hop, window=window, center=True, pad_mode="constant",
                          return_complex=True)

    angles = torch.exp(1j * init_phase.to(device=mels_db.device, dtype=dt)).to(cdt)
    angles = angles.expand(mag.shape)
    prev = torch.zeros_like(mag)
    for _ in range(n_iter):
        rebuilt = stft(istft(mag * angles))
        new = rebuilt - (momentum / (1.0 + momentum)) * prev
        angles = new / new.abs().clamp_min(1e-16)
        prev = rebuilt
    return istft(mag * angles)
