"""Discriminative-channel selection: label-grouped ANOVA per timepoint.

Counterpart of
``decode_tonal_langauge_tpu/channel_selection/discriminative.py``. The
(C, T) ANOVA runs on ``device`` (``None``: the card), the thresholding on
the host. Both ``label`` (the key the shipped ``example_config.yaml``
writes) and ``target`` (the key the reference code reads) name the label
array.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Mapping

import numpy as np
import torch

from ..ops.anova import f_oneway_labeled
from ..runtime.device import DeviceLike, resolve_device
from ..utils.visualise import _pyplot, _save_or_show
from .utils import find_significant_channels


def _target_key(params: dict) -> str:
    target = params.get("target", params.get("label"))
    if target is None:
        raise KeyError("discriminative selection requires a 'target' (or 'label') key")
    return target


def run(data: dict, params: dict, device: DeviceLike = None) -> dict:
    """Identify channels discriminative for a label (tone or syllable)."""
    device = resolve_device(device)
    p_threshold = params.get("p_threshold", 0.05)
    target = _target_key(params)

    recording_name = params.get("recording_name", "ecog")
    sf_key = f"{recording_name}_sf"
    if sf_key not in data:
        raise ValueError(f"Sampling frequency ({sf_key}) not found in the data.")
    sf = float(data[sf_key])

    test_results = test_discriminative_power(data, params, device=device)

    significant_channels, max_lengths = find_significant_channels(
        test_results["p_value"],
        pvalue_threshold=p_threshold,
        length_threshold=int(params["active_time_threshold"] * sf),
    )

    print(
        f"Found {len(significant_channels)} discriminative channels"
        f' for target "{target}"'
    )

    return {
        "selected_channels": significant_channels,
        "max_lengths": max_lengths,
        "p_values": test_results["p_value"],
    }


def test_discriminative_power(
    data: Mapping[str, np.ndarray], params: dict, device: DeviceLike = None
) -> Dict[str, np.ndarray]:
    """F statistic + p-value of label-grouped ANOVA at every (channel, time).

    Returns ``{'f_stat': (C, T), 'p_value': (C, T)}`` as host arrays,
    matching ``scipy.stats.f_oneway`` over the same label partition.
    """
    device = resolve_device(device)
    recording_name = params.get("recording_name", "ecog")
    target = _target_key(params)

    if recording_name not in data:
        raise KeyError(
            f"No '{recording_name}' array in the sample data; "
            f"Available keys: {list(data.keys())}"
        )
    series = np.asarray(data[recording_name])
    if series.ndim != 3:
        raise ValueError(
            f"Recording '{recording_name}' must be a 3D array "
            "(n_samples, n_channels, n_timepoints)."
        )

    if target not in data:
        raise KeyError(
            f"No '{target}' label array in the sample data; "
            f"Available keys: {list(data.keys())}"
        )
    labels = np.asarray(data[target]).squeeze()
    if labels.ndim != 1:
        raise ValueError(f"Labels '{target}' must be a 1D array (n_samples,).")
    if labels.shape[0] != series.shape[0]:
        raise ValueError(
            f"Number of samples in '{target}' ({labels.shape[0]}) does not "
            f"match number of samples in '{recording_name}' ({series.shape[0]})."
        )

    # Map labels to a dense [0, k) range on the host.
    uniq, dense = np.unique(labels, return_inverse=True)
    f, p = f_oneway_labeled(
        torch.as_tensor(series, dtype=torch.float32, device=device), dense, len(uniq)
    )
    return {"f_stat": f.cpu().numpy(), "p_value": p.cpu().numpy()}


def generate_figures(
    data: dict, results: dict, params: dict, figure_dir: str
) -> None:
    """Per-class mean +/- SEM traces for sampled discriminative channels."""
    os.makedirs(figure_dir, exist_ok=True)
    label_name = _target_key(params)

    for file in os.listdir(figure_dir):
        if file.endswith(".png"):
            os.remove(os.path.join(figure_dir, file))

    recording_name = params.get("recording_name", "ecog")
    sf = float(data[f"{recording_name}_sf"])

    n_plot = min(10, len(results["selected_channels"]))
    for ch in random.sample(list(results["selected_channels"]), n_plot):
        plot_discriminative_channel(
            data,
            ch,
            sampling_rate=sf,
            p_vals=np.asarray(results["p_values"])[ch, :],
            label_name=label_name,
            p_threshold=params.get("p_threshold", 0.05),
            recording_name=recording_name,
            figure_path=os.path.join(figure_dir, f"{label_name}_channel_{ch}.png"),
        )


def plot_discriminative_channel(
    data: dict,
    channel: int,
    sampling_rate: float,
    p_vals: np.ndarray,
    label_name: str,
    p_threshold: float = 0.05,
    recording_name: str = "ecog",
    figure_path=None,
) -> None:
    plt = _pyplot(figure_path)
    series = np.asarray(data[recording_name])[:, channel, :]
    labels = np.asarray(data[label_name]).squeeze()
    n_timepoints = series.shape[1]
    time = np.linspace(0, n_timepoints / sampling_rate, n_timepoints)

    fig, axes = plt.subplots(1, 2, figsize=(16, 6))
    for value in np.unique(labels):
        grp = series[labels == value]
        mean = grp.mean(axis=0)
        sem = grp.std(axis=0) / np.sqrt(grp.shape[0])
        axes[0].plot(time, mean, label=f"{label_name}={value}")
        axes[0].fill_between(time, mean - sem, mean + sem, alpha=0.2)
    axes[0].set_title(f"Channel {channel} activity by {label_name}")
    axes[0].set_xlabel("Time (s)")
    axes[0].set_ylabel("Amplitude")
    axes[0].legend()

    axes[1].plot(time, p_vals, color="red")
    axes[1].axhline(y=p_threshold, color="black", linestyle="--")
    axes[1].set_title("P-values Over Time")
    axes[1].set_xlabel("Time (s)")
    axes[1].set_ylabel("P-value")

    _save_or_show(plt, fig, figure_path)
