"""Audio codec: waveform <-> mel spectrogram (+ Griffin-Lim inverse).

Counterpart of ``decode_tonal_langauge_tpu/utils/audio.py``:
``audio_to_mel`` returns the flattened dB mel with ``power_to_db(ref=max)``;
the inverse uses ``db_to_power(ref=1e-4)`` (the reference's deliberately
asymmetric ref) -> NNLS mel inversion -> Griffin-Lim. Numpy in, numpy out;
the DSP runs on ``device`` (``None`` means CUDA). The mel figures import
matplotlib when they draw, so the port imports without it.

``mels_to_audio`` on a CUDA card keeps a plan per call shape. What depends
on the mel basis alone (the basis, its NNLS constants, the Hann window) is
built once per (device, rate, ``n_fft``, ``n_mels``, ``fmin``, ``fmax``).
The first call of a shape runs eagerly, on the stream its graphs will be
captured on, which warms cuFFT's plans and cuBLAS there. The second
captures two CUDA graphs: ``db_to_power`` and the NNLS solve, then
Griffin-Lim. It and every later call copy the mel (through a pinned buffer)
and the first phase into the graphs' inputs and replay them. The ops are
the eager ones, so a replay gives the eager call's bits. The last
:data:`PLAN_SLOTS` shapes keep their plans; an evicted plan frees its
graphs and their memory pool. On the CPU every call runs the eager ops.
``EAGER_CALLS``, ``GRAPH_CAPTURES`` and ``GRAPH_REPLAYS`` count the calls
that ran eagerly, captured and replayed (a capturing call replays too).
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.griffinlim import (NNLSConstants, griffinlim, griffinlim_windowed, mel_to_stft_mag,
                              nnls_constants, nnls_solve, random_phase, stft_magnitude)
from ..ops.stft import db_to_power, hann, mel_filterbank, nola_sum, power_to_db, stft_magsq
from ..runtime.device import DeviceLike, resolve_device
from ..runtime.profiling import span

EAGER_CALLS = 0  # mels_to_audio calls that ran the eager ops
GRAPH_CAPTURES = 0  # calls that captured a plan's graphs
GRAPH_REPLAYS = 0  # calls that replayed them
PLAN_SLOTS = 4  # call shapes that keep a plan on the card, the most recent


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
    global EAGER_CALLS
    dev = resolve_device(device)
    mels = np.asarray(mels, dtype=np.float32)
    if mels.ndim != 2:
        raise ValueError(
            f"mels_to_audio expects (batch, n_mels * n_frames); got "
            f"shape {mels.shape}"
        )
    mels = mels.reshape(mels.shape[0], n_mels, -1)
    if dev.type == "cuda":
        if init_phase is None:
            init_phase = random_phase((1 + n_fft // 2, mels.shape[-1]), seed)
        key = plan_key(dev, mels.shape, audio_sampling_rate, mel_in_db, n_fft, hop_length,
                       fmin, fmax, power, n_iter, length, init_phase.shape)
        return _on_card(key, mels, init_phase)
    EAGER_CALLS += 1
    with span("audio.mels_to_audio"):
        with span("audio.basis"):
            mel = torch.tensor(mels, device=dev)
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


class PlanKey(NamedTuple):
    """What a plan is built for: :func:`mels_to_audio`'s device, the
    mels' (batch, n_mels, n_frames), the first phase's shape and every
    setting that changes the ops. ``constants`` is the part the mel basis
    depends on."""

    device: torch.device
    shape: tuple
    phase_shape: tuple
    mel_in_db: bool
    hop_length: int
    power: float
    n_iter: int
    length: Optional[int]
    constants: tuple  # (device, rate, n_fft, n_mels, fmin, fmax)


def plan_key(device, shape, audio_sampling_rate, mel_in_db, n_fft, hop_length, fmin, fmax,
             power, n_iter, length, phase_shape) -> PlanKey:
    """The :class:`PlanKey` of a :func:`mels_to_audio` call."""
    device = torch.device(device)
    shape = tuple(int(n) for n in shape)
    return PlanKey(device, shape, tuple(int(n) for n in phase_shape), bool(mel_in_db),
                   int(hop_length), float(power), int(n_iter), length,
                   (device, float(audio_sampling_rate), int(n_fft), shape[1], float(fmin),
                    None if fmax is None else float(fmax)))


class Constants(NamedTuple):
    """What the mel basis alone determines, built by the eager ops."""

    basis: torch.Tensor  # (n_mels, 1 + n_fft // 2) float32
    nnls: NNLSConstants
    window: torch.Tensor  # the periodic Hann window, float32


@functools.lru_cache(maxsize=PLAN_SLOTS)
def constants(device: torch.device, audio_sampling_rate: float, n_fft: int, n_mels: int,
              fmin: float, fmax: Optional[float]) -> Constants:
    """The :class:`Constants` of a ``PlanKey.constants``, built once."""
    with span("audio.nnls_setup"):
        basis = torch.as_tensor(
            mel_filterbank(audio_sampling_rate, n_fft, n_mels, fmin, fmax),
            dtype=torch.float32, device=device,
        )
        return Constants(basis, nnls_constants(basis), hann(n_fft, torch.float32, device))


def _nnls(key: PlanKey, c: Constants, mel: torch.Tensor) -> torch.Tensor:
    """The NNLS part of a call: the mel in power, then the STFT magnitude."""
    if key.mel_in_db:
        mel = db_to_power(mel, ref=0.0001)
    return stft_magnitude(nnls_solve(c.basis, mel, c.nnls), key.power)


def _griffinlim(key: PlanKey, c: Constants, wsum: torch.Tensor, S_mag: torch.Tensor,
                phase: torch.Tensor) -> torch.Tensor:
    return griffinlim_windowed(S_mag, phase, c.window, wsum, key.hop_length, key.n_iter,
                               length=key.length)


class _Graphs(NamedTuple):
    """A plan's two graphs, the pool they share and what they read and
    write: the mel (filled from a pinned staging buffer) and the first
    phase in, the STFT magnitude between them, the waveform out."""

    nnls: torch.cuda.CUDAGraph
    griffinlim: torch.cuda.CUDAGraph
    pool: tuple
    staging: torch.Tensor
    mel: torch.Tensor
    phase: torch.Tensor
    S_mag: torch.Tensor
    wave: torch.Tensor


class _Plan:
    """One call shape on the card: its constants, the NOLA sum, the side
    stream its graphs are captured on and, once captured, the graphs."""

    def __init__(self, key: PlanKey) -> None:
        self.key, self.calls, self.graphs = key, 0, None
        self.c = constants(*key.constants)
        self.wsum = nola_sum(self.c.window, key.hop_length, key.shape[-1])
        self.stream = torch.cuda.Stream(key.device)

    def eager(self, mels: np.ndarray, init_phase: torch.Tensor) -> np.ndarray:
        """The call by the eager ops, on the capture stream."""
        key = self.key
        self.stream.wait_stream(torch.cuda.current_stream(key.device))
        with torch.cuda.stream(self.stream):
            with span("audio.basis"):
                mel = torch.tensor(mels, device=key.device)
            with span("audio.nnls"):
                S_mag = _nnls(key, self.c, mel)
            with span("audio.griffinlim"):
                wave = _griffinlim(key, self.c, self.wsum, S_mag, init_phase)
            with span("audio.fetch"):
                return wave.cpu().numpy()

    def capture(self) -> None:
        key, pool = self.key, torch.cuda.graph_pool_handle()
        staging = torch.empty(key.shape, dtype=torch.float32, pin_memory=True)
        mel = torch.empty(key.shape, dtype=torch.float32, device=key.device)
        phase = torch.empty(key.phase_shape, dtype=torch.float32, device=key.device)
        nnls, gl = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(nnls, pool=pool, stream=self.stream):
            S_mag = _nnls(key, self.c, mel)
        with torch.cuda.graph(gl, pool=pool, stream=self.stream):
            wave = _griffinlim(key, self.c, self.wsum, S_mag, phase)
        self.graphs = _Graphs(nnls, gl, pool, staging, mel, phase, S_mag, wave)
        _GRAPHS.update((id(g), g) for g in (nnls, gl))

    def replay(self, mels: np.ndarray, init_phase: torch.Tensor) -> np.ndarray:
        """The call by the graphs: the inputs copied in, both replayed."""
        g = self.graphs
        with span("audio.basis"):
            np.copyto(g.staging.numpy(), mels)
            g.mel.copy_(g.staging, non_blocking=True)
            g.phase.copy_(init_phase)
        with span("audio.nnls"):
            torch.ops.tonal.graph_replay(g.S_mag, id(g.nnls))
        with span("audio.griffinlim"):
            torch.ops.tonal.graph_replay(g.wave, id(g.griffinlim))
        with span("audio.fetch"):
            return g.wave.cpu().numpy()

    def release(self) -> None:
        """Free the graphs, their pool and the buffers."""
        if self.graphs is not None:
            for g in self.graphs[:2]:
                del _GRAPHS[id(g)]
                g.reset()
            self.graphs = None


_PLANS: "OrderedDict[PlanKey, _Plan]" = OrderedDict()  # least recently called first
_GRAPHS: dict = {}  # id -> a captured graph of a live plan


def release_plans() -> None:
    """Free every plan's graphs, pool and buffers."""
    while _PLANS:
        _PLANS.popitem(last=False)[1].release()


def _on_card(key: PlanKey, mels: np.ndarray, init_phase: torch.Tensor) -> np.ndarray:
    global EAGER_CALLS, GRAPH_CAPTURES, GRAPH_REPLAYS
    with span("audio.mels_to_audio"):
        plan = _PLANS.get(key)
        if plan is None:
            while len(_PLANS) >= PLAN_SLOTS:
                _PLANS.popitem(last=False)[1].release()
            with span("audio.basis"):
                plan = _PLANS[key] = _Plan(key)
        _PLANS.move_to_end(key)
        plan.calls += 1
        if plan.calls == 1:
            EAGER_CALLS += 1
            return plan.eager(mels, init_phase)
        if plan.graphs is None:
            GRAPH_CAPTURES += 1
            with span("audio.capture"):
                plan.capture()
        GRAPH_REPLAYS += 1
        return plan.replay(mels, init_phase)


# ``tonal::graph_replay``: replays a plan's graph, which writes ``out``.
# An op, so that a profiler's trace holds the host op under which the
# graph's kernels are launched, and so the span around it.
_LIB = torch.library.Library("tonal", "FRAGMENT")
_LIB.define("graph_replay(Tensor(a!) out, int graph) -> ()")
_LIB.impl("graph_replay", lambda out, graph: _GRAPHS[graph].replay(), "CUDA")


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
