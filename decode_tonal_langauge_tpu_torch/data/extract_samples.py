"""Sample-collection stage: TextGrid alignment -> per-subject sample npz.

Counterpart of ``decode_tonal_langauge_tpu/data/extract_samples.py``.
``run(config, device=None) -> output_dir`` reads the
``sample_collection`` section: for each configured subject it parses the
TextGrids, cuts the epochs (``text_align.extract_ecog_audio``, on
``device``: ``None`` means the card, and it raises without one) and
writes ``subject_<id>.npz`` into ``<recording base>__<md5[:6]>``, the
JAX stage's directory name for the same config. A subject whose file
exists is skipped unless ``overwrite``; ``config.yaml`` chains the
upstream stage's provenance. Event snapshot figures are drawn where
matplotlib imports. Several processes split the subjects
(``parallel.distributed.host_shard``); each writes its subjects' files,
and rank 0 the ``config.yaml``.
"""

from __future__ import annotations

import hashlib
import os
from typing import List

import numpy as np

from ..config import dict_to_namespace, update_configuration
from ..parallel.distributed import host_shard, process_index
from ..runtime.device import DeviceLike, resolve_device
from .text_align import extract_ecog_audio, handle_textgrids


def run(config: dict, device: DeviceLike = None) -> str:
    """Extract the samples of every configured subject; returns the
    output directory."""
    device = resolve_device(device)
    collection_cfg = config.get("sample_collection", {})
    params_config = collection_cfg.get("params", {})
    params_dict = {}
    for section in ("io", "settings"):
        params_dict.update(params_config.get(section, {}) or {})
    params = dict_to_namespace(params_dict)
    overwrite = getattr(params, "overwrite", False)
    figures = getattr(params, "figures", True)

    output_dir = os.path.join(params.output_dir, _generate_output_dir_name(
        os.path.basename(os.path.normpath(params.recording_dir)), collection_cfg))
    os.makedirs(output_dir, exist_ok=True)
    figure_root = os.path.join(output_dir, "figures")
    if figures:
        os.makedirs(figure_root, exist_ok=True)
    if process_index() == 0:
        update_configuration(
            output_path=os.path.join(output_dir, "config.yaml"),
            previous_config_path=os.path.join(params.recording_dir, "config.yaml"),
            new_module="sample_collection",
            new_module_cfg=collection_cfg,
        )

    subjects = host_shard(list((params_config.get("subjects", {}) or {}).items()))
    for subject_id, subject_params in subjects:
        subject_path = os.path.join(params.recording_dir, f"subject_{subject_id}")
        if not os.path.exists(subject_path):
            print(f"No recording directory at {subject_path}; subject skipped.")
            continue
        subject_output_path = os.path.join(output_dir, f"subject_{subject_id}.npz")
        if os.path.exists(subject_output_path) and not overwrite:
            print(f"Reusing cached samples at {subject_output_path} (pass overwrite to redo).")
            continue
        textgrid_dir = os.path.join(params.textgrid_root, subject_params["textgrid_dir"])
        if not os.path.exists(textgrid_dir):
            print(f"No TextGrid directory at {textgrid_dir}; subject skipped.")
            continue

        intervals = handle_textgrids(
            textgrid_dir,
            start_offset=subject_params.get("start_offset", 0.0),
            tier_list=subject_params.get("tier_list", None),
            blocks=subject_params.get("blocks", None),
        )
        if len(intervals) == 0:
            raise ValueError(
                "No intervals found in the TextGrid files. "
                "Check the directory and file naming conventions. "
                f"Target blocks: {subject_params.get('blocks', 'all')}"
            )
        if figures:
            _plot_event_snapshots(intervals, subject_path, figure_root, subject_id)

        rest = subject_params.get("rest_period")
        extract_ecog_audio(
            intervals,
            subject_path,
            syllables=params.syllable_identifiers,
            length=subject_params["sample_length"],
            output_path=subject_output_path,
            rest_period=tuple(rest) if rest is not None else None,
            device=device,
        )
    return output_dir


def _sample_consecutive_events(events: List[dict], num_events: int,
                               rng: np.random.Generator) -> List[dict]:
    """A random run of ``num_events`` consecutive events (for figures)."""
    events = sorted(events, key=lambda x: x["start"])
    if len(events) > num_events:
        start_idx = int(rng.integers(0, len(events) - num_events + 1))
        return events[start_idx : start_idx + num_events]
    return events


def _plot_event_snapshots(intervals, subject_path, figure_root, subject_id) -> None:
    """A figure per block of a few consecutive events on random channels,
    where matplotlib imports (the draws come from a generator seeded 0)."""
    try:
        import matplotlib
    except ImportError as e:
        print(f"no event snapshot figures ({e})")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(0)
    for block_id, records in intervals.items():
        ecog_path = os.path.join(subject_path, f"B{block_id}_ecog.npz")
        if not records or not os.path.exists(ecog_path):
            continue
        ecog = np.load(ecog_path)
        signal, sf = ecog["data"], int(ecog["sf"])
        events = _sample_consecutive_events(records, 3, rng)
        channels = rng.choice(signal.shape[0], size=min(5, signal.shape[0]), replace=False)
        fig_dir = os.path.join(figure_root, f"subject_{subject_id}")
        os.makedirs(fig_dir, exist_ok=True)

        start_time = max(min(e["start"] for e in events) - 0.5, 0)
        end_time = max(e["end"] for e in events) + 0.5
        s_idx, e_idx = int(start_time * sf), int(end_time * sf)
        time = np.arange(s_idx, e_idx) / sf
        fig, axes = plt.subplots(len(channels), 1, figsize=(12, 3 * len(channels)),
                                 sharex=True)
        axes = np.atleast_1d(axes)
        for ax, ch in zip(axes, channels):
            ax.plot(time, signal[ch, s_idx:e_idx], color="blue", alpha=0.7)
            for event in events:
                es, ee = int(event["start"] * sf), int(event["end"] * sf)
                ax.plot(np.arange(es, ee) / sf, signal[ch, es:ee], color="orange")
                ax.axvline(event["start"], color="g", linestyle="--", alpha=0.7)
                ax.axvline(event["end"], color="r", linestyle="--", alpha=0.7)
            ax.set_title(f"Channel {ch}")
            ax.set_ylabel("Amplitude")
        axes[-1].set_xlabel("Time (s)")
        fig.suptitle(f"Subject {subject_id} Block {block_id}")
        fig.tight_layout()
        fig.savefig(os.path.join(fig_dir, f"block_{block_id}_events.png"), dpi=150,
                    bbox_inches="tight")
        plt.close(fig)


def _generate_output_dir_name(base_name: str, collection_cfg: dict) -> str:
    """``<base>__<md5[:6]>`` of the section with only the inputs that
    change the samples: subjects, settings and ``textgrid_root`` (the other
    ``io`` keys, such as ``overwrite`` and the output paths, stay out)."""
    import yaml

    params = dict(collection_cfg.get("params", {}) or {})
    io_cfg = params.pop("io", None) or {}
    if io_cfg.get("textgrid_root") is not None:
        params["textgrid_root"] = io_cfg["textgrid_root"]
    hash_input = yaml.dump({**collection_cfg, "params": params}, sort_keys=True)
    return f"{base_name}__{hashlib.md5(hash_input.encode()).hexdigest()[:6]}"
