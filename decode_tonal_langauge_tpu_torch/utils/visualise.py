"""Preprocessing figures (matplotlib, headless).

Counterpart of ``plot_preprocessing_step`` in
``decode_tonal_langauge_tpu/utils/visualise.py``. matplotlib is imported
when a figure is drawn, so the port imports without it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def plot_preprocessing_step(
    before_data: np.ndarray,
    before_freq: float,
    after_data: np.ndarray,
    after_freq: float,
    figure_dir: str,
    step_index: int,
    module_name: str,
    num_channels: int = 5,
    duration: float = 1.0,
    rng: Optional[np.random.Generator] = None,
) -> str:
    """Overlay before/after traces for a few random channels; returns the
    PNG's path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = rng or np.random.default_rng(0)

    max_time = min(
        before_data.shape[1] / before_freq, after_data.shape[1] / after_freq
    )
    duration = min(duration, max_time)
    start_time = float(rng.uniform(0, max_time - duration)) if max_time > duration else 0.0
    end_time = start_time + duration

    num_channels = min(num_channels, before_data.shape[0])
    fig, ax = plt.subplots(
        num_channels, 1, figsize=(10, 3 * num_channels), sharex=True
    )
    if num_channels == 1:
        ax = [ax]

    for i in range(num_channels):
        ch = int(rng.integers(0, before_data.shape[0]))
        b = before_data[ch, int(start_time * before_freq) : int(end_time * before_freq)]
        a = after_data[ch, int(start_time * after_freq) : int(end_time * after_freq)]
        tb = np.linspace(start_time, end_time, b.shape[0], endpoint=False)
        ta = np.linspace(start_time, end_time, a.shape[0], endpoint=False)
        ax[i].plot(tb, b, label="before", alpha=0.7)
        ax[i].plot(ta, a, label="after", alpha=0.7)
        ax[i].set_title(f"Channel {ch}")
        ax[i].set_ylabel("Amplitude")
        ax[i].legend()

    ax[-1].set_xlabel("Time (s)")
    short = module_name.split(".")[-1]
    fig.suptitle(f"{short} - Preprocessing Step {step_index + 1}")
    fig.tight_layout()

    path = os.path.join(figure_dir, f"step{step_index + 1}_{short}.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path
