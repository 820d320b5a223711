"""Preprocessing, confusion and loss-curve figures (matplotlib, headless).

Counterparts of ``plot_preprocessing_step``, ``plot_confusion_matrix`` and
``plot_training_losses`` in ``decode_tonal_langauge_tpu/utils/visualise.py``.
matplotlib is imported when a figure is drawn, so the port imports
without it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

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


def plot_confusion_matrix(
    confusion_matrix: np.ndarray,
    add_numbers: bool = True,
    label_names: Optional[Sequence[str]] = None,
    figure_path: Optional[str] = None,
    title: str = "Confusion Matrix",
) -> None:
    """Heatmap of a confusion matrix, counts in the cells; saved to
    ``figure_path`` (or shown when it is None)."""
    import matplotlib

    if figure_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = np.asarray(confusion_matrix, dtype=float)
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(cm, cmap="Blues")
    fig.colorbar(im, ax=ax)
    n = cm.shape[0]
    if label_names is not None and len(label_names) == n:
        ax.set_xticks(range(n), labels=list(label_names), rotation=45, ha="right")
        ax.set_yticks(range(n), labels=list(label_names))
    if add_numbers:
        thresh = cm.max() / 2.0 if cm.size else 0
        for i in range(n):
            for j in range(cm.shape[1]):
                ax.text(j, i, f"{cm[i, j]:.0f}", ha="center", va="center",
                        color="white" if cm[i, j] > thresh else "black")
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title(title)
    fig.tight_layout()
    if figure_path:
        fig.savefig(figure_path, dpi=150, bbox_inches="tight")
    else:
        plt.show()
    plt.close(fig)


def plot_training_losses(
    history: List[Tuple[float, float]],
    labels: Tuple[str, str] = ("loss", "mcd"),
    figure_path: Optional[str] = None,
) -> None:
    """Per-epoch curves of a (loss, second metric) history, the second on
    its own axis; saved to ``figure_path`` (or shown when it is None)."""
    import matplotlib

    if figure_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    hist = np.asarray(history, dtype=float)
    fig, ax1 = plt.subplots(figsize=(10, 5))
    ax1.plot(hist[:, 0], color="tab:blue", label=labels[0])
    ax1.set_xlabel("Epoch")
    ax1.set_ylabel(labels[0], color="tab:blue")
    if hist.shape[1] > 1:
        ax2 = ax1.twinx()
        ax2.plot(hist[:, 1], color="tab:orange", label=labels[1])
        ax2.set_ylabel(labels[1], color="tab:orange")
    fig.tight_layout()
    if figure_path:
        fig.savefig(figure_path, dpi=150, bbox_inches="tight")
    else:
        plt.show()
    plt.close(fig)
