"""Channel-selection helpers: Bonferroni + consecutive-run-length filtering.

Counterpart of ``decode_tonal_langauge_tpu/channel_selection/utils.py``
(host numpy), with its repair of the reference kept:
``find_significant_channels`` fills ``max_lengths``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..ops.runlength import max_consecutive_true


def get_max_length(indices: np.ndarray) -> int:
    """Longest run of consecutive integers in a sorted index array."""
    if len(indices) == 0:
        return 0
    mask = np.zeros(int(indices[-1]) + 1, dtype=bool)
    mask[np.asarray(indices, dtype=int)] = True
    return int(max_consecutive_true(mask))


def significant_runs(
    p_values: np.ndarray, corrected_threshold: float, length_threshold: int
) -> Tuple[List[int], List[int]]:
    """Channels (rows of a (C, T) p-value array) whose longest run of
    ``p < corrected_threshold`` is longer than ``length_threshold``
    samples, and those run lengths."""
    sig = np.asarray(p_values) < corrected_threshold
    runs = max_consecutive_true(sig).numpy()
    channels: List[int] = []
    max_lengths: List[int] = []
    for ch in range(sig.shape[0]):
        if sig[ch].any() and runs[ch] > length_threshold:
            channels.append(ch)
            max_lengths.append(int(runs[ch]))
    return channels, max_lengths


def find_significant_channels(
    p_values: np.ndarray,
    pvalue_threshold: float = 0.05,
    length_threshold: int = 10,
) -> Tuple[List[int], List[int]]:
    """Channels whose longest consecutively-significant run exceeds the
    threshold, with Bonferroni correction over timepoints.

    ``p_values``: (n_channels, n_timepoints). Returns (channels, max_lengths).
    """
    return significant_runs(
        p_values, pvalue_threshold / p_values.shape[1], length_threshold
    )
