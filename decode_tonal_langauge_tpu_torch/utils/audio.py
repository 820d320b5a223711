"""Audio codec: waveform <-> mel spectrogram (+ Griffin-Lim inverse).

Counterpart of ``decode_tonal_langauge_tpu/utils/audio.py``:
``audio_to_mel`` returns the flattened dB mel with ``power_to_db(ref=max)``;
the inverse uses ``db_to_power(ref=1e-4)`` (the reference's deliberately
asymmetric ref) -> NNLS mel inversion -> Griffin-Lim. Numpy in, numpy out;
the DSP runs on ``device`` (``None`` means CUDA). The mel figures import
matplotlib when they draw, so the port imports without it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.griffinlim import griffinlim, mel_to_stft_mag
from ..ops.stft import db_to_power, mel_filterbank, power_to_db, stft_magsq
from ..runtime.device import DeviceLike, resolve_device
from ..runtime.profiling import span


def melspectrogram(
    audio: np.ndarray,
    sr: float,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    power: float = 2.0,
    device: DeviceLike = None,
) -> np.ndarray:
    """Mel power spectrogram (n_mels, n_frames), librosa conventions."""
    dev = resolve_device(device)
    y = torch.tensor(np.asarray(audio, dtype=np.float32), device=dev)
    S = stft_magsq(y, n_fft, hop_length)
    if power != 2.0:
        S = S ** (power / 2.0)
    basis = torch.as_tensor(
        mel_filterbank(sr, n_fft, n_mels, fmin, fmax), dtype=torch.float32,
        device=dev,
    )
    return (basis @ S).cpu().numpy()


def audio_to_mel(
    audio: np.ndarray,
    audio_sampling_rate: float,
    mel_in_db: bool = True,
    mel_kwargs: Optional[dict] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Audio (n_samples,) -> flattened mel vector (n_mels * n_frames,)."""
    if np.ndim(audio) > 1:
        raise ValueError("Audio input must be a 1D array.")
    mel = melspectrogram(
        audio, audio_sampling_rate, device=device, **(mel_kwargs or {})
    )
    if mel_in_db:
        mel = power_to_db(torch.from_numpy(mel), ref=None).numpy()
    return mel.reshape(-1)


def mels_to_audio(
    mels: np.ndarray,
    n_mels: int,
    audio_sampling_rate: float = 24414,
    mel_in_db: bool = True,
    n_fft: int = 2048,
    hop_length: int = 512,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    power: float = 2.0,
    n_iter: int = 32,
    length: Optional[int] = None,
    init_phase: Optional[torch.Tensor] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> np.ndarray:
    """(B, n_mels * n_frames) flattened mel vectors -> (B, n_samples)
    waveforms: NNLS + Griffin-Lim batched over trials, one shared first
    phase (``init_phase``, else drawn once from ``seed``)."""
    dev = resolve_device(device)
    mels = np.asarray(mels, dtype=np.float32)
    if mels.ndim != 2:
        raise ValueError(
            f"mels_to_audio expects (batch, n_mels * n_frames); got "
            f"shape {mels.shape}"
        )
    with span("audio.mels_to_audio"):
        with span("audio.basis"):
            mel = torch.tensor(mels.reshape(mels.shape[0], n_mels, -1), device=dev)
            if mel_in_db:
                mel = db_to_power(mel, ref=0.0001)
            basis = torch.as_tensor(
                mel_filterbank(audio_sampling_rate, n_fft, n_mels, fmin, fmax),
                dtype=torch.float32, device=dev,
            )
        with span("audio.nnls"):
            S_mag = mel_to_stft_mag(mel, basis, power=power)
        with span("audio.griffinlim"):
            waves = griffinlim(
                S_mag, n_fft=n_fft, hop_length=hop_length, n_iter=n_iter,
                length=length, init_phase=init_phase, seed=seed,
            )
        with span("audio.fetch"):
            return waves.cpu().numpy()


def mel_to_audio(mel: np.ndarray, n_mels: int, **kwargs) -> np.ndarray:
    """Flattened mel vector -> waveform (one trial of
    :func:`mels_to_audio`, same keyword arguments)."""
    mel = np.asarray(mel, dtype=np.float32).reshape(1, -1)
    return mels_to_audio(mel, n_mels, **kwargs)[0]


def visualise_mel(
    mel: np.ndarray,
    audio_sampling_rate: float = 24414,
    mel_in_db: bool = True,
    file_path: Optional[str] = None,
    show: bool = True,
    ax=None,
) -> None:
    """Heatmap of a (n_mels, n_frames) mel spectrogram."""
    import matplotlib

    if file_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    own_figure = ax is None
    if own_figure:
        fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(mel, aspect="auto", origin="lower", cmap="coolwarm")
    ax.set_xlabel("Frame")
    ax.set_ylabel("Mel bin")
    plt.colorbar(im, ax=ax, format="%+2.0f dB" if mel_in_db else "%+2.0f")
    if own_figure:
        ax.set_title("Mel Spectrogram")
        fig.tight_layout()
        if file_path:
            fig.savefig(file_path, dpi=150)
            plt.close(fig)
        elif show:
            plt.show()


def compare_mels(
    mel1: np.ndarray,
    mel2: np.ndarray,
    audio_sampling_rate: float = 24414,
    title1: str = "Mel Spectrogram 1",
    title2: str = "Mel Spectrogram 2",
    mel_in_db: bool = True,
    file_path: Optional[str] = None,
) -> None:
    """Side-by-side mel figure (origin vs reconstruction)."""
    import matplotlib

    if file_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(15, 6))
    for ax, mel, title in ((axes[0], mel1, title1), (axes[1], mel2, title2)):
        visualise_mel(mel, audio_sampling_rate, mel_in_db, ax=ax, show=False)
        ax.set_title(title)
    fig.tight_layout()
    if file_path:
        fig.savefig(file_path, dpi=150)
        plt.close(fig)
    else:
        plt.show()


def write_wav(path: str, wave: np.ndarray, sr: int) -> None:
    """16-bit PCM WAV writer (scipy backend)."""
    from scipy.io.wavfile import write as write_wave

    wave = np.asarray(wave, dtype=np.float32)
    peak = np.max(np.abs(wave)) or 1.0
    write_wave(path, int(sr), (wave / peak * 32767).astype(np.int16))
