"""Visualisation stage: figures from upstream stage artifacts.

Counterpart of ``decode_tonal_langauge_tpu/visualisation/main.py``.
Consumes the training stage's ``results.csv`` (a metric scatter per
subject, read with the ``csv`` module) and the channel-selection JSONs
(a three-set Venn diagram per subject), writing PNGs into a ``figures/``
directory. Where matplotlib does not import, it says so in one line and
returns None, as it does when there is nothing to plot.

Config::

    visualisation:
      module: visualisation_main
      params:
        io:
          output_dir: figures          # default: <results_dir>/figures
          # results_dir / channel_selection_dir are threaded from the
          # upstream stages automatically
        metrics: [accuracy]            # one scatter per metric
        chance_levels: {accuracy: 0.25}
        venn_sets: [active_channels, tone_discriminative,
                    syllable_discriminative]
"""

from __future__ import annotations

import csv
import json
import os
from typing import List, Optional, Tuple

from ..utils.visualise import plot_channel_venn_diagram, plot_metric


def run(config: dict) -> Optional[str]:
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        print(f"Visualisation stage made no figures: matplotlib does not import ({e}).")
        return None

    stage_cfg = config.get("visualisation", {}) or {}
    params = stage_cfg.get("params", {}) or {}
    io_cfg = params.get("io", {}) or {}

    results_dir = io_cfg.get("results_dir")
    selection_dir = io_cfg.get("channel_selection_dir")
    output_dir = io_cfg.get("output_dir") or (
        os.path.join(results_dir, "figures") if results_dir else "figures"
    )
    os.makedirs(output_dir, exist_ok=True)

    made_any = False

    # ---- metric scatter(s) from results.csv ----
    results_file = (
        os.path.join(results_dir, "results.csv") if results_dir else None
    )
    if results_file and os.path.exists(results_file):
        columns, rows = read_results(results_file)
        metrics = params.get("metrics") or _metrics_in(columns)
        chance = params.get("chance_levels", {}) or {}
        for metric in metrics:
            if f"{metric}_mean" not in columns:
                print(f"No '{metric}_mean' column in {results_file}; skipped.")
                continue
            path = os.path.join(output_dir, f"{metric}_by_subject.png")
            plot_metric(
                rows, metric, chance_level=chance.get(metric), figure_path=path
            )
            made_any = True

    # ---- channel-set Venn diagrams per subject ----
    venn_sets = params.get(
        "venn_sets",
        ["active_channels", "tone_discriminative", "syllable_discriminative"],
    )
    if selection_dir and os.path.isdir(selection_dir) and len(venn_sets) != 3:
        print(
            f"Venn diagrams need exactly 3 channel sets, got {len(venn_sets)} "
            f"({venn_sets}); skipping venn figures."
        )
    if selection_dir and os.path.isdir(selection_dir) and len(venn_sets) == 3:
        for fname in sorted(os.listdir(selection_dir)):
            if not (fname.startswith("subject_") and fname.endswith(".json")):
                continue
            with open(os.path.join(selection_dir, fname)) as f:
                selections = json.load(f)
            if not all(k in selections for k in venn_sets):
                continue
            subject = fname.replace(".json", "")
            path = os.path.join(output_dir, f"{subject}_channel_venn.png")
            plot_channel_venn_diagram(
                {k: set(selections[k]) for k in venn_sets}, figure_path=path
            )
            made_any = True

    if not made_any:
        print("Visualisation stage found nothing to plot.")
        return None
    print(f"Figures written to {output_dir}")
    return output_dir


def _cell(text: str):
    """A CSV cell as pandas reads it: an int, a float (empty: NaN) or the
    text."""
    if text == "":
        return float("nan")
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def read_results(path: str) -> Tuple[List[str], List[dict]]:
    """``results.csv`` -> (columns, rows as dicts of converted cells)."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        rows = [{k: _cell(v) for k, v in row.items()} for row in reader]
        return list(reader.fieldnames or []), rows


def _metrics_in(columns: List[str]) -> list:
    return sorted(
        {
            c[: -len("_mean")]
            for c in columns
            if c.endswith("_mean") and c != "model_mean"
        }
    )
