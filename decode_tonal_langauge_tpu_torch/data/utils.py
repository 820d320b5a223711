"""Data-layer helpers: filename matching, label dynamics, channel-set
algebra.

A copy of ``decode_tonal_langauge_tpu/data/utils.py`` (host numpy; the
port keeps its own so it never imports the JAX package): the block id of
a file name, extension and keyword matching, the per-sample (syllable,
tone contour) dynamics and their dense lookup table, and the
non-discriminative channel set.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np


def extract_block_id(filename: str) -> int:
    """The integer block id of a file name containing ``B<digits>``."""
    match = re.search(r"B(\d+)", filename)
    if match:
        return int(match.group(1))
    raise ValueError(f"No block ID found in filename: {filename}")


def match_filename(file: str, file_format: str, kwords: Optional[List[str]] = None) -> bool:
    """True if ``file`` has the extension and contains every keyword."""
    if not file.endswith(file_format):
        return False
    if kwords:
        return all(word in file for word in kwords)
    return True


def prepare_tone_dynamics(
    tone_dynamic_mapping: Dict[str, List[float]],
    tone_labels: np.ndarray,
    syllable_labels: np.ndarray,
) -> np.ndarray:
    """Per-sample (syllable, tone) dynamics, shape (N, 2, n_dynamics): row
    0 the constant syllable sequence, row 1 the tone's contour."""
    if len(tone_labels) != len(syllable_labels):
        raise ValueError("Length of tone labels and syllable labels must match.")
    table, n_dynamics = tone_dynamics_table(tone_dynamic_mapping)
    tones = np.asarray(tone_labels).astype(int)
    sylls = np.asarray(syllable_labels).astype(int)
    known = sorted(int(k) for k in tone_dynamic_mapping.keys())
    for tone in np.unique(tones):
        if int(tone) not in known:
            raise ValueError(
                f"Tone {tone} not found in tone_dynamic_mapping."
                "Available tones in mapping: "
                f"{list(tone_dynamic_mapping.keys())}"
            )
    out = np.empty((len(tones), 2, n_dynamics), dtype=np.float64)
    out[:, 0, :] = sylls[:, None]
    out[:, 1, :] = table[tones]
    return out


def tone_dynamics_table(
    tone_dynamic_mapping: Dict[str, List[float]]
) -> Tuple[np.ndarray, int]:
    """Dense lookup ``table[tone] -> contour`` for on-device gathering.
    Rows for unmapped ids are zero. Returns (table, n_dynamics)."""
    keys = [int(k) for k in tone_dynamic_mapping.keys()]
    lengths = {len(v) for v in tone_dynamic_mapping.values()}
    if len(lengths) != 1:
        raise ValueError("All tone dynamic sequences must have the same length.")
    n_dynamics = lengths.pop()
    table = np.zeros((max(keys) + 1, n_dynamics), dtype=np.float64)
    for k, v in tone_dynamic_mapping.items():
        table[int(k)] = np.asarray(v, dtype=np.float64)
    return table, n_dynamics


def select_non_discriminative_channels(
    channel_selections: dict, discriminative_keys: List[str]
) -> list:
    """active_channels minus the union of discriminative sets, sorted."""
    discriminative: set = set()
    for label in discriminative_keys:
        discriminative.update(channel_selections[label])
    return sorted(set(channel_selections["active_channels"]) - discriminative)
