"""Seeded inputs: trials, splits, scalers, recordings, label dynamics.

Everything here is drawn from the run's seed on the host with numpy (a
few MB), and is handed alike to the port and to the reference. Each
draw takes its own stream, ``rng(seed, tag)``, so that adding a draw
leaves the others as they were. Traffic is the same for every seed in
size and shape; only the values differ.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, zlib.crc32(tag.encode())])


def sub_seeds(seed: int, tag: str, n: int) -> List[int]:
    """``n`` distinct seeds below 2**31 for the port's own generators."""
    out = rng(seed, tag).choice(2**31 - 1, size=n, replace=False) + 1
    return [int(s) for s in out]


def trials(r: np.random.Generator, n: int, n_channels: int, length: int,
           n_tones: int, n_sylls: int, tone_channels: int, syll_channels: int
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(n, C, T) float32 ECoG of unit noise, a tone-shaped sinusoid on the
    first ``tone_channels`` channels and a syllable-shaped one on the next
    ``syll_channels``, and the tone and syllable ids."""
    tone = r.integers(0, n_tones, n)
    syll = r.integers(0, n_sylls, n)
    t = np.linspace(0.0, 1.0, length)
    x = r.standard_normal((n, n_channels, length)).astype(np.float32)
    x[:, :tone_channels] += np.sin(np.pi * (tone[:, None] + 1) * t)[:, None, :]
    x[:, tone_channels:tone_channels + syll_channels] += \
        np.cos(np.pi * (syll[:, None] + 1) * t)[:, None, :]
    return x, tone, syll


def split(r: np.random.Generator, n: int, ratios) -> List[np.ndarray]:
    """A random partition of range(n): ``int(n * ratio)`` rows to each
    part but the last, which takes the rest."""
    perm = r.permutation(n)
    sizes = [int(n * q) for q in ratios[:-1]]
    bounds = np.cumsum([0] + sizes + [n - sum(sizes)])
    return [perm[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def scaler(r: np.random.Generator, n_channels: int, length: int) -> Tuple[np.ndarray, np.ndarray]:
    """A train split's (mu, sd), shaped as the classifiers' checkpoints
    keep them: (1, C, T)."""
    mu = (0.1 * r.standard_normal((1, n_channels, length))).astype(np.float32)
    sd = (r.random((1, n_channels, length)) + 0.5).astype(np.float32)
    return mu, sd


def mels(r: np.random.Generator, n: int, dim: int) -> np.ndarray:
    """(n, dim) float32 dB mel targets in [-80, 0]."""
    return np.clip(-40.0 + 15.0 * r.standard_normal((n, dim)), -80.0, 0.0).astype(np.float32)


def recording(r: np.random.Generator, n_channels: int, n_samples: int) -> np.ndarray:
    """(C, T) float32 continuous ECoG: unit noise with a slow rhythm."""
    t = np.arange(n_samples) / 400.0
    x = r.standard_normal((n_channels, n_samples)).astype(np.float32)
    x += np.sin(2 * np.pi * 3.0 * t + r.uniform(0, 2 * np.pi, (n_channels, 1))).astype(np.float32)
    return x


def tone_mapping(n_tones: int, n_dynamics: int) -> Dict[str, List[float]]:
    """Each tone's pitch contour: tone k rises from k/4 to 1 - k/4."""
    return {str(k): [float(v) for v in np.linspace(k / 4, 1 - k / 4, n_dynamics)]
            for k in range(n_tones)}


def dynamics_table(mapping: Dict[str, List[float]]) -> np.ndarray:
    keys = sorted(int(k) for k in mapping)
    table = np.zeros((max(keys) + 1, len(mapping[str(keys[0])])))
    for k in keys:
        table[k] = mapping[str(k)]
    return table


def channel_selection(cfg: Dict) -> Dict[str, List[int]]:
    """The decode's channels: tone first, syllable next, the rest
    non-discriminative."""
    ch = cfg["channels"]
    n = ch["tone"] + ch["syllable"] + ch["non_discriminative"]
    return {"active_channels": list(range(n)),
            "tone_discriminative": list(range(ch["tone"])),
            "syllable_discriminative": list(range(ch["tone"], ch["tone"] + ch["syllable"]))}


def channel_groups(cfg: Dict) -> Dict[str, List[int]]:
    """The same selection as the reference takes it: tone, syllable, non."""
    sel = channel_selection(cfg)
    used = set(sel["tone_discriminative"]) | set(sel["syllable_discriminative"])
    return {"tone": sel["tone_discriminative"], "syllable": sel["syllable_discriminative"],
            "non": [c for c in sel["active_channels"] if c not in used]}
