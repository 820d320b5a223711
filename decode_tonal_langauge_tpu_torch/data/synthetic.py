"""Synthetic subject generator for tests, benchmarks and demos.

A copy of ``decode_tonal_langauge_tpu/data/synthetic.py`` (host numpy,
the same draws, so both packages write byte-equal subjects from one
seed): raw multichannel ECoG with event-locked high-gamma bursts whose
amplitude encodes tone and syllable in designated channels, a
tone-pitched speech-like audio track, and Praat TextGrid annotations,
laid out as the preprocess stage expects
(``<root>/<subject_dir>/HS<subject>-B<block>/raw.npz`` + TextGrids).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .textgrid import Interval, IntervalTier, TextGrid, write_textgrid

SYLLABLE_FORMANTS = {"i": (300.0, 2300.0), "a": (700.0, 1200.0), "u": (350.0, 800.0)}
# Per-tone f0 contours as (start_hz, end_hz) ramps: flat high / rising /
# dipping (down then up, approximated by a shallow fall) / falling.
TONE_F0 = {1: (220.0, 220.0), 2: (160.0, 230.0), 3: (150.0, 120.0), 4: (250.0, 150.0)}


@dataclass
class SyntheticSpec:
    n_channels: int = 32
    ecog_sf: float = 1000.0
    audio_sf: float = 8000.0
    n_blocks: int = 2
    trials_per_block: int = 24
    event_duration: float = 0.4
    inter_trial: float = 1.5
    rest_duration: float = 6.0
    syllables: Tuple[str, ...] = ("i", "a")
    tones: Tuple[int, ...] = (1, 2, 3, 4)
    # Channel roles: indices into the channel axis.
    active_channels: Tuple[int, ...] = tuple(range(0, 16))
    tone_channels: Tuple[int, ...] = (0, 1, 2, 3)
    syllable_channels: Tuple[int, ...] = (4, 5, 6, 7)
    noise_scale: float = 1.0
    seed: int = 0

    def __post_init__(self):
        # Clamp channel roles to the available channel count so small test
        # specs stay valid.
        c = self.n_channels
        self.active_channels = tuple(ch for ch in self.active_channels if ch < c)
        self.tone_channels = tuple(ch for ch in self.tone_channels if ch < c)
        self.syllable_channels = tuple(ch for ch in self.syllable_channels if ch < c)


@dataclass
class SyntheticBlock:
    ecog: np.ndarray  # (C, T)
    audio: np.ndarray  # (1, T_a)
    events: List[dict] = field(default_factory=list)  # start, end, tone, syllable


def _event_schedule(spec: SyntheticSpec, rng: np.random.Generator) -> List[dict]:
    events = []
    t = spec.rest_duration + 1.0
    labels = [
        (tone, syll)
        for tone in spec.tones
        for syll in spec.syllables
    ]
    for i in range(spec.trials_per_block):
        tone, syll = labels[i % len(labels)]
        events.append(
            {
                "start": round(t, 1),
                "end": round(t + spec.event_duration, 1),
                "tone": tone,
                "syllable": syll,
            }
        )
        t += spec.inter_trial
    return events


def generate_block(spec: SyntheticSpec, block_seed: int) -> SyntheticBlock:
    rng = np.random.default_rng(block_seed)
    events = _event_schedule(spec, rng)
    total_time = events[-1]["end"] + 1.0

    t_e = int(total_time * spec.ecog_sf)
    t_a = int(total_time * spec.audio_sf)
    time_e = np.arange(t_e) / spec.ecog_sf
    time_a = np.arange(t_a) / spec.audio_sf

    # Base ECoG: 1/f-ish noise (sum of filtered white noise scales).
    ecog = rng.standard_normal((spec.n_channels, t_e)) * spec.noise_scale
    # Drawn and left unused, as in the JAX package: it keeps the stream
    # (and so the audio noise below) equal to that package's.
    rng.standard_normal((spec.n_channels, t_e // 50 + 2))
    carrier = np.sin(2 * np.pi * 95.0 * time_e)  # high-gamma carrier

    audio = np.zeros(t_a)

    syll_index = {s: k for k, s in enumerate(spec.syllables)}

    for ev in events:
        s_e = int(ev["start"] * spec.ecog_sf)
        e_e = int(ev["end"] * spec.ecog_sf)
        n = e_e - s_e
        window = np.hanning(n)

        tone_gain = 0.8 + 0.9 * (ev["tone"] - 1)  # tone-coded amplitude
        syll_gain = 1.0 + 2.0 * syll_index[ev["syllable"]]

        for ch in spec.active_channels:
            gain = 2.5
            if ch in spec.tone_channels:
                gain = 1.0 + tone_gain
            elif ch in spec.syllable_channels:
                gain = 1.0 + syll_gain
            ecog[ch, s_e:e_e] += gain * window * carrier[s_e:e_e]

        # Audio: two formants + f0 contour of the tone.
        s_a = int(ev["start"] * spec.audio_sf)
        e_a = s_a + int(spec.event_duration * spec.audio_sf)
        ta = time_a[s_a:e_a] - time_a[s_a]
        f0_start, f0_end = TONE_F0[ev["tone"]]
        f0 = f0_start + (f0_end - f0_start) * ta / max(ta[-1], 1e-6)
        phase = 2 * np.pi * np.cumsum(f0) / spec.audio_sf
        f1, f2 = SYLLABLE_FORMANTS[ev["syllable"]]
        wave = (
            np.sin(phase)
            + 0.4 * np.sin(2 * np.pi * f1 * ta)
            + 0.2 * np.sin(2 * np.pi * f2 * ta)
        )
        audio[s_a:e_a] += np.hanning(len(ta)) * wave

    audio += 0.01 * rng.standard_normal(t_a)

    return SyntheticBlock(
        ecog=ecog.astype(np.float32),
        audio=audio[None, :].astype(np.float32),
        events=events,
    )


def write_subject(
    root: str,
    subject_id: int,
    spec: SyntheticSpec,
    subject_dir: str | None = None,
) -> Dict[int, SyntheticBlock]:
    """Write raw block dirs + TextGrids for one subject.

    Layout:
      <root>/<subject_dir>/HS<subject>-B<block>/raw.npz
      <root>/annotations/subject_<id>/B<block>.TextGrid
    """
    subject_dir = subject_dir or f"Sub{subject_id}"
    blocks: Dict[int, SyntheticBlock] = {}
    tg_dir = os.path.join(root, "annotations", f"subject_{subject_id}")
    os.makedirs(tg_dir, exist_ok=True)

    for block_id in range(1, spec.n_blocks + 1):
        block = generate_block(spec, spec.seed * 1000 + subject_id * 100 + block_id)
        blocks[block_id] = block

        block_path = os.path.join(root, subject_dir, f"HS{subject_id}-B{block_id}")
        os.makedirs(block_path, exist_ok=True)
        np.savez(
            os.path.join(block_path, "raw.npz"),
            ecog=block.ecog,
            audio=block.audio,
            ecog_sf=spec.ecog_sf,
            audio_sf=spec.audio_sf,
        )

        total = block.ecog.shape[1] / spec.ecog_sf
        tier = IntervalTier(name="success", minTime=0.0, maxTime=total)
        cursor = 0.0
        for ev in block.events:
            if ev["start"] > cursor:
                tier.intervals.append(Interval(cursor, ev["start"], ""))
            tier.intervals.append(
                Interval(ev["start"], ev["end"], f"{ev['tone']}{ev['syllable']}")
            )
            cursor = ev["end"]
        if cursor < total:
            tier.intervals.append(Interval(cursor, total, ""))

        grid = TextGrid(minTime=0.0, maxTime=total, tiers=[tier])
        write_textgrid(grid, os.path.join(tg_dir, f"B{block_id}.TextGrid"))

    return blocks
