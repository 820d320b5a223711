"""Figures (matplotlib, headless): preprocessing steps, confusion
matrices and their differences, PSDs, per-second channel statistics,
channel-set Venn diagrams, per-subject metrics and loss curves.

Counterpart of ``decode_tonal_langauge_tpu/utils/visualise.py``.
matplotlib is imported when a figure is drawn, so the port imports
without it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _pyplot(figure_path: Optional[str]):
    """``matplotlib.pyplot``, headless when the figure goes to a file."""
    import matplotlib

    if figure_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save_or_show(plt, fig, figure_path: Optional[str]) -> None:
    if figure_path:
        fig.savefig(figure_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    else:  # pragma: no cover - interactive path
        plt.show()


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
    plt = _pyplot(figure_path)
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
    _save_or_show(plt, fig, figure_path)


def plot_training_losses(
    history: List[Tuple[float, float]],
    labels: Tuple[str, str] = ("loss", "mcd"),
    figure_path: Optional[str] = None,
) -> None:
    """Per-epoch curves of a (loss, second metric) history, the second on
    its own axis; saved to ``figure_path`` (or shown when it is None)."""
    plt = _pyplot(figure_path)
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
    _save_or_show(plt, fig, figure_path)


def compare_confusion_matrices(
    cm: np.ndarray,
    cm_baseline: np.ndarray,
    label_names: Optional[Sequence[str]] = None,
    figure_path: Optional[str] = None,
) -> None:
    """Signed difference (cm - baseline) heatmap."""
    plt = _pyplot(figure_path)
    diff = np.asarray(cm, float) - np.asarray(cm_baseline, float)
    fig, ax = plt.subplots(figsize=(8, 7))
    vmax = np.abs(diff).max() or 1.0
    im = ax.imshow(diff, cmap="coolwarm", vmin=-vmax, vmax=vmax)
    fig.colorbar(im, ax=ax)
    n = diff.shape[0]
    if label_names is not None and len(label_names) == n:
        ax.set_xticks(range(n), labels=list(label_names), rotation=45, ha="right")
        ax.set_yticks(range(n), labels=list(label_names))
    for i in range(n):
        for j in range(diff.shape[1]):
            ax.text(j, i, f"{diff[i, j]:+.0f}", ha="center", va="center")
    ax.set_title("Confusion Matrix Difference")
    fig.tight_layout()
    _save_or_show(plt, fig, figure_path)


def plot_psd(
    data: np.ndarray,
    sampling_rate: float,
    channels: Optional[Sequence[int]] = None,
    figure_path: Optional[str] = None,
    fmax: Optional[float] = None,
) -> None:
    """Welch power spectral density per channel of a (C, T) recording."""
    import scipy.signal as sps

    plt = _pyplot(figure_path)
    channels = list(channels) if channels is not None else list(range(min(8, data.shape[0])))
    fig, ax = plt.subplots(figsize=(10, 6))
    for ch in channels:
        freqs, psd = sps.welch(data[ch], fs=sampling_rate, nperseg=min(1024, data.shape[1]))
        ax.semilogy(freqs, psd, label=f"ch {ch}", alpha=0.7)
    if fmax:
        ax.set_xlim(0, fmax)
    ax.set_xlabel("Frequency (Hz)")
    ax.set_ylabel("PSD")
    ax.legend()
    ax.set_title("Power Spectral Density")
    fig.tight_layout()
    _save_or_show(plt, fig, figure_path)


def plot_channel_mean_std(
    data: np.ndarray,
    sampling_rate: float,
    figure_path: Optional[str] = None,
) -> None:
    """Per-second channel mean and std heatmaps of a (C, T) recording."""
    plt = _pyplot(figure_path)
    c, t = data.shape
    sec = int(sampling_rate)
    n_sec = t // sec
    trimmed = data[:, : n_sec * sec].reshape(c, n_sec, sec)
    means = trimmed.mean(axis=2)
    stds = trimmed.std(axis=2)

    fig, axes = plt.subplots(1, 2, figsize=(16, 6))
    for ax, mat, title in ((axes[0], means, "Mean"), (axes[1], stds, "Std")):
        im = ax.imshow(mat, aspect="auto", cmap="viridis")
        fig.colorbar(im, ax=ax)
        ax.set_xlabel("Time (s)")
        ax.set_ylabel("Channel")
        ax.set_title(f"Per-second channel {title}")
    fig.tight_layout()
    _save_or_show(plt, fig, figure_path)


def plot_channel_venn_diagram(
    sets: Dict[str, set],
    figure_path: Optional[str] = None,
) -> None:
    """Three-set Venn diagram of channel selections with region counts
    (three drawn circles; no Venn package)."""
    names = list(sets.keys())
    if len(names) != 3:
        raise ValueError("plot_channel_venn_diagram expects exactly 3 sets.")
    a, b, c = (set(sets[n]) for n in names)

    regions = {
        "100": len(a - b - c),
        "010": len(b - a - c),
        "001": len(c - a - b),
        "110": len((a & b) - c),
        "101": len((a & c) - b),
        "011": len((b & c) - a),
        "111": len(a & b & c),
    }

    plt = _pyplot(figure_path)
    fig, ax = plt.subplots(figsize=(8, 8))
    centers = [(-0.5, 0.3), (0.5, 0.3), (0.0, -0.55)]
    colors = ["tab:blue", "tab:orange", "tab:green"]
    for (x, y), color, name in zip(centers, colors, names):
        ax.add_patch(plt.Circle((x, y), 1.0, alpha=0.3, color=color, label=name))

    positions = {
        "100": (-1.0, 0.5),
        "010": (1.0, 0.5),
        "001": (0.0, -1.1),
        "110": (0.0, 0.55),
        "101": (-0.55, -0.25),
        "011": (0.55, -0.25),
        "111": (0.0, 0.0),
    }
    for key, (x, y) in positions.items():
        ax.text(x, y, str(regions[key]), ha="center", va="center", fontsize=14)

    ax.set_xlim(-2.2, 2.2)
    ax.set_ylim(-2.2, 2.2)
    ax.set_aspect("equal")
    ax.axis("off")
    ax.legend(loc="upper right")
    ax.set_title("Channel set overlap")
    _save_or_show(plt, fig, figure_path)


def plot_metric(
    results: "list[dict]",
    metric: str,
    chance_level=None,
    figure_path: Optional[str] = None,
) -> None:
    """Per-subject metric scatter, marker size by model size, with error bars.

    ``results`` rows need keys: subject, ``<metric>_mean``, ``<metric>_std``,
    model_size, model_name. ``chance_level`` is one level or a
    ``{target label: level}`` mapping (a dashed line each).
    """
    plt = _pyplot(figure_path)
    fig, ax = plt.subplots(figsize=(10, 6))

    # Series are (model, target) pairs: separate-model runs write joint
    # and per-target rows with different chance levels.
    def series_key(r):
        key = str(r.get("model_name", "model"))
        if r.get("target"):
            key += f" [{r['target']}]"
        return key

    series = sorted({series_key(r) for r in results})
    cmap = plt.get_cmap("tab10")
    for mi, name in enumerate(series):
        rows = [r for r in results if series_key(r) == name]
        xs = [r["subject"] for r in rows]
        ys = [r[f"{metric}_mean"] for r in rows]
        errs = [r.get(f"{metric}_std", 0.0) or 0.0 for r in rows]
        sizes = [20 + 30 * np.log10(max(r.get("model_size", 10), 10)) for r in rows]
        ax.errorbar(
            xs, ys, yerr=errs, fmt="none", ecolor=cmap(mi), alpha=0.5, capsize=3
        )
        ax.scatter(xs, ys, s=sizes, color=cmap(mi), label=name, alpha=0.8)
    if isinstance(chance_level, dict):
        # Grey shades and distinct dashes: the series colours stay the
        # scatter's.
        styles = ["--", ":", "-.", (0, (5, 1))]
        for ci, (target, level) in enumerate(sorted(chance_level.items())):
            ax.axhline(
                float(level),
                color=str(0.25 + 0.15 * (ci % 4)),
                linestyle=styles[ci % len(styles)],
                alpha=0.8,
                label=f"chance ({target})",
            )
    elif chance_level is not None:
        ax.axhline(chance_level, color="grey", linestyle="--", label="chance")
    ax.set_xlabel("Subject")
    ax.set_ylabel(metric)
    ax.legend()
    fig.tight_layout()
    _save_or_show(plt, fig, figure_path)
