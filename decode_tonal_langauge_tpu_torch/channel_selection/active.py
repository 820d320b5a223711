"""Active-channel selection: event vs rest one-way ANOVA per timepoint.

Counterpart of ``decode_tonal_langauge_tpu/channel_selection/active.py``.
Plugin contract ``run(data, params, device=None) -> {selected_channels,
max_lengths, p_values}`` plus ``generate_figures``. The (C, T) ANOVA runs
on ``device`` (``None``: the card); the Bonferroni threshold, the run
lengths and the channel lists run on the host. ``p_values`` is the full
(C, T) array (the JAX package's repair of the reference, which returned
the last channel's vector).
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
import torch

from ..ops.anova import f_oneway_two_groups
from ..runtime.device import DeviceLike, resolve_device
from ..utils.visualise import _pyplot, _save_or_show
from .utils import significant_runs


def run(data: dict, params: dict, device: DeviceLike = None) -> dict:
    """Identify channels whose ERP activity differs from rest."""
    device = resolve_device(device)
    erp_name = params.get("erp_name", "ecog")
    rest_name = params.get("rest_name", "ecog_rest")

    if "ecog_sf" not in data:
        raise ValueError("ECoG sampling frequency (ecog_sf) not found in the data.")
    ecog_sf = float(data["ecog_sf"])
    length_threshold = int(params["active_time_threshold"] * ecog_sf)

    for name in (rest_name, erp_name):
        if name not in data:
            raise KeyError(
                f"Recording '{name}' not found in data."
                f"Available keys: {list(data.keys())}"
            )

    rest_samples = np.asarray(data[rest_name])  # (Nr, C, T)
    erp_samples = np.asarray(data[erp_name])  # (Ne, C, T)

    if erp_samples.shape[1] != rest_samples.shape[1]:
        raise ValueError(
            f"Shape mismatch between '{erp_name}' and '{rest_name}': "
            f"{erp_samples.shape[1:]} vs {rest_samples.shape[1:]}."
        )

    n_timepoints = rest_samples.shape[2]
    corrected_p_threshold = params["p_threshold"] / n_timepoints

    put = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    _, p_vals = f_oneway_two_groups(put(rest_samples), put(erp_samples))  # (C, T)
    p_vals = p_vals.cpu().numpy()

    active_channels, max_lengths = significant_runs(
        p_vals, corrected_p_threshold, length_threshold
    )
    print(f"{len(active_channels)} channels pass the activity test.")

    return {
        "selected_channels": active_channels,
        "max_lengths": max_lengths,
        "p_values": p_vals,
    }


def generate_figures(
    data: dict, results: dict, params: dict, figure_dir: str
) -> None:
    """Run-length histogram + rest-vs-ERP traces for sampled channels
    (matplotlib is imported here)."""
    plt = _pyplot(figure_dir)
    ecog_sf = float(data["ecog_sf"])
    lengths = results["max_lengths"]
    channels = results["selected_channels"]
    p_vals = np.asarray(results["p_values"])

    os.makedirs(figure_dir, exist_ok=True)
    figure_path = os.path.join(figure_dir, "active_lengths.png")
    fig = plt.figure(figsize=(10, 6))
    plt.hist(np.array(lengths) / ecog_sf, bins=30, alpha=0.7, color="blue")
    plt.title("Distribution of Active Length of Significant Channels")
    plt.xlabel("Active length (s)")
    plt.ylabel("Frequency")
    fig.savefig(figure_path, dpi=150)
    plt.close(fig)

    n_channels_plot = min(10, len(channels))
    for ch in random.sample(list(channels), n_channels_plot):
        plot_rest_erp(
            np.asarray(data["ecog_rest"])[:, ch, :],
            np.asarray(data["ecog"])[:, ch, :],
            p_vals=p_vals[ch],
            p_val_threshold=params["p_threshold"],
            sampling_rate=ecog_sf,
            figure_path=os.path.join(figure_dir, f"channel_{ch}_erp_rest.png"),
        )


def plot_rest_erp(
    rest_data: np.ndarray,
    erp_data: np.ndarray,
    p_vals: np.ndarray,
    p_val_threshold: float = 0.05,
    sampling_rate: float = 400,
    figure_path: Optional[str] = None,
) -> None:
    """Mean +/- SEM of rest vs ERP activity, with the p-value trace."""
    plt = _pyplot(figure_path)
    if rest_data.shape[1] != erp_data.shape[1]:
        raise ValueError("Rest and ERP data must have the same number of timepoints.")

    n_timepoints = rest_data.shape[1]
    time = np.linspace(0, n_timepoints / sampling_rate, n_timepoints)

    fig, axes = plt.subplots(1, 2, figsize=(16, 6))
    for arr, label, color in (
        (rest_data, "Rest", "blue"),
        (erp_data, "ERP", "orange"),
    ):
        mean = arr.mean(axis=0)
        sem = arr.std(axis=0) / np.sqrt(arr.shape[0])
        axes[0].plot(time, mean, label=f"{label} Mean ± SEM", color=color)
        axes[0].fill_between(time, mean - sem, mean + sem, color=color, alpha=0.2)
    axes[0].set_title("Rest vs ERP mean activity")
    axes[0].set_xlabel("Time (s)")
    axes[0].set_ylabel("Amplitude")
    axes[0].legend()
    axes[0].grid(True)

    axes[1].plot(time, p_vals, label="P-values", color="red")
    axes[1].axhline(
        y=p_val_threshold, color="black", linestyle="--", label="Significance Threshold"
    )
    axes[1].set_title("P-values Over Time")
    axes[1].set_xlabel("Time (s)")
    axes[1].set_ylabel("P-value")
    axes[1].legend()
    axes[1].grid(True)

    _save_or_show(plt, fig, figure_path)
