#!/usr/bin/env python
"""Quality parity of the PyTorch port: decode accuracy and mel fidelity of
the paper models trained end to end through the port, held against the
JAX package's recorded distributions (``PARITY.json``).

The counterpart of ``scripts/measure_parity.py``, step for step, with
``decode_tonal_langauge_tpu_torch`` in place of the JAX package:

1. plant a synthetic subject (32 channels, 4 blocks x 40 trials, tone
   channels 0-5, syllable channels 6-11, ``--noise-scale``: 1.0 is the
   easy subject, 4.5 the hard one);
2. run the production pipeline (preprocess -> samples -> channel
   selection) through ``pipeline.run_pipeline``;
3. train the classifier cells through ``training.train_classifier.run``
   (70/10/20, batch 16, lr 5e-4, patience = epochs, standardised, seed
   42, all repeat seeds as one batched fit): ``cnn`` (the paper CNN,
   syllable), ``cnn_bf16`` (``dtype: bfloat16``), ``cnn_bf16_opt`` (bf16
   compute and bf16 NAdam moments) and ``cnnrnn`` (the paper CNN-RNN,
   tone);
4. train frozen logistic tone and syllable classifiers with checkpoints
   and decode every trial through ``serving.load_decoder``;
5. train the synthesizer cells through ``train_synthesizer``:
   ``synth_lite`` (SynthesisLite, 60 epochs), ``synth_cnn``
   (SynthesisFull, the paper's SynthesisModelCNN, ``--epochs``) and
   ``synth_lite_bf16`` (``--dtype bfloat16``).

The JAX harness's hand-written torch columns are not here: the port is
now the torch side. Each cell is compared (:func:`compare_cell`) with the
same cell of ``PARITY.json``'s subject of the same noise scale.

State is resumable per workdir (``parity_state.json``); the results, with
each cell's comparison, go to ``parity_results.json`` there, or with
``--out PATH`` into the two-subject document at PATH (``meta``,
``easy_subject``, ``hard_subject``), merged with what it holds. The meta
names the device (the card's name and power limit from ``nvidia-smi``),
the torch and CUDA versions, the commit (``git rev-parse HEAD``, or the
``PARITY_COMMIT`` environment variable where the checkout has no git
metadata) and a digest of the port's sources and this script. It runs on
the CUDA card unless ``--device`` names another device; without a card
and without ``--device`` it raises.

    python scripts/measure_parity_torch.py --workdir /tmp/pe --only cnn --device cpu
    python scripts/measure_parity_torch.py --workdir /tmp/ph --noise-scale 4.5 \\
        --seeds 48 --only cnn,cnn_bf16,cnn_bf16_opt --out PARITY_TORCH.json
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from decode_tonal_langauge_tpu_torch.config import append_data_json  # noqa: E402
from decode_tonal_langauge_tpu_torch.runtime.device import resolve_device  # noqa: E402
from decode_tonal_langauge_tpu_torch.utils.seeding import seed_stream  # noqa: E402

N_SEEDS = 12
EPOCHS = 30
SYNTH_LITE_EPOCHS = 60
_CNN = "models.deep_classifiers.CNNClassifier"
# key: (model path, target, model_kwargs, training-section extras)
CLASSIFIER_CELLS = {
    "cnn": (_CNN, "syllable", None, None),
    "cnn_bf16": (_CNN, "syllable", {"dtype": "bfloat16"}, None),
    "cnn_bf16_opt": (_CNN, "syllable", {"dtype": "bfloat16"}, {"moment_dtype": "bfloat16"}),
    "cnnrnn": ("models.deep_classifiers.CNNRNNClassifier", "tone", None, None),
}
# key: (train_synthesizer model name, --dtype); SynthesisLite trains
# SYNTH_LITE_EPOCHS, "SynthesisFull" (the CLI's name for SynthesisModelCNN)
# the classifiers' --epochs.
SYNTH_CELLS = {
    "synth_lite": ("SynthesisLite", None),
    "synth_cnn": ("SynthesisFull", None),
    "synth_lite_bf16": ("SynthesisLite", "bfloat16"),
}
SUBJECTS = {1.0: "easy_subject", 4.5: "hard_subject"}
JAX_PARITY = os.path.join(REPO, "PARITY.json")
# The commit PARITY.json was measured at. No commit since has changed the
# JAX package's training numerics: ``git log 0e39a68..HEAD --
# decode_tonal_langauge_tpu/{training,models,ops}`` lists platform
# handling, seed_chunk (per-seed results bit-equal), the recorded label
# space, the seed-stream helper (the same draw) and model.per_target.
JAX_PARITY_COMMIT = "0e39a68"

# The comparison's bands (compare_cell).
ESCAPE = 0.68  # PARITY.md: seeds that escape collapse score 0.69-1.0
SATURATED_MIN = 0.96  # at most one of 32 test trials wrong
FISHER_ALPHA = 0.05
SYNTH_R_BAND = 0.02
SYNTH_MCD_REL = 0.10

SYNTH_CONFIG = {
    "mel_kwargs": {"n_fft": 512, "hop_length": 256, "n_mels": 40},
    "tone_dynamic_mapping": {
        "0": [5, 5, 5], "1": [3, 4, 5], "2": [3, 2, 3], "3": [5, 3, 1]
    },
    "n_syllables": 2,
    "n_tones": 4,
}


# ---------------------------------------------------------------------------
def build_subject(workdir: str, noise_scale: float = 1.0):
    from decode_tonal_langauge_tpu_torch.data.synthetic import (
        SyntheticSpec,
        write_subject,
    )

    spec = SyntheticSpec(
        n_channels=32,
        n_blocks=4,
        trials_per_block=40,
        ecog_sf=1000.0,
        audio_sf=8000.0,
        active_channels=tuple(range(16)),
        tone_channels=(0, 1, 2, 3, 4, 5),
        syllable_channels=(6, 7, 8, 9, 10, 11),
        noise_scale=noise_scale,
    )
    write_subject(os.path.join(workdir, "raw"), 1, spec)
    return spec


def pipeline_config(workdir: str) -> dict:
    """``scripts/measure_parity.py:run_pipeline_stages``'s config."""
    def discriminative(label: str) -> dict:
        return {
            "module": "channel_selection.discriminative",
            "selection_name": f"{label}_discriminative",
            "params": {"p_threshold": 0.05, "active_time_threshold": 0.05,
                       "label": label, "recording_name": "ecog"},
        }

    return {
        "preprocess": {
            "module": "preprocess_main",
            "params": {
                "pipeline": {
                    "module": "preprocess.pipelines.subject_block",
                    "params": {"subject_dirs": ["Sub1"], "subject_ids": [1],
                               "figures": False},
                },
                "io": {
                    "module": "preprocess.io.npz_blocks",
                    "params": {"root_dir": os.path.join(workdir, "raw"),
                               "output_dir": os.path.join(workdir, "processed")},
                },
                "preprocessor": {"module": "preprocess.preprocessor"},
                "modalities": {
                    "ecog": {
                        "type": "signal",
                        "preprocessing": {"steps": [
                            {"module": "preprocess.downsample",
                             "params": {"downsample_freq": 400}},
                            {"module": "preprocess.frequency_filter",
                             "params": {"bands": [{
                                 "method": "hilbert",
                                 "params": {"freq_ranges": [70, 150], "envelope": True},
                             }]}},
                            {"module": "preprocess.zscore_rereference",
                             "params": {"rereference_interval": [0.0, 5.0]}},
                        ]},
                    },
                    "audio": {"type": "signal"},
                },
            },
        },
        "sample_collection": {
            "module": "extract_samples",
            "params": {
                "io": {"output_dir": os.path.join(workdir, "samples"),
                       "textgrid_root": os.path.join(workdir, "raw"),
                       "figures": False},
                "subjects": {1: {"start_offset": 0.1, "sample_length": 0.4,
                                 "rest_period": [0.0, 5.0],
                                 "textgrid_dir": "annotations/subject_1",
                                 "tier_list": ["success"]}},
                "settings": {"syllable_identifiers": ["i", "a"]},
            },
        },
        "channel_selection": {
            "module": "channel_selection_main",
            "params": {
                "io": {"output_dir": os.path.join(workdir, "selection"),
                       "figures": False},
                "selections": [
                    {"module": "channel_selection.active",
                     "selection_name": "active_channels",
                     "params": {"p_threshold": 0.05, "active_time_threshold": 0.05,
                                "rest_name": "ecog_rest", "erp_name": "ecog"}},
                    discriminative("tone"),
                    discriminative("syllable"),
                ],
            },
        },
    }


def run_pipeline_stages(workdir: str, device=None) -> dict:
    """Preprocess -> samples -> channel selection (production path)."""
    from decode_tonal_langauge_tpu_torch.pipeline import run_pipeline

    return run_pipeline(pipeline_config(workdir), device=device)


# ---------------------------------------------------------------------------
def read_csv(path: str) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


def train_ours(workdir: str, outputs: dict, model_path: str, model_name: str,
               target: str, n_seeds: int, epochs: int, device=None,
               model_kwargs=None, training_extra=None) -> dict:
    """One target through the production training stage, all seeds as
    one batched fit; each seed's test accuracy, the seeds and the wall."""
    from decode_tonal_langauge_tpu_torch.training import train_classifier

    config = {  # scripts/measure_parity.py:train_ours's
        "model": {"model": model_path, "model_name": model_name,
                  "model_kwargs": model_kwargs or {}},
        "training": {
            "module": "train_classifier",
            "params": {
                "io": {"log_dir": os.path.join(workdir, f"logs_{model_name}_{target}"),
                       "sample_dir": outputs["sample_collection"],
                       "channel_selection_dir": outputs["channel_selection"]},
                "experiment": {"targets": [target], "features": "ecog",
                               "separate_models": False, "seed": 42,
                               "repeat": n_seeds, "verbose": 0},
                "training": {"train_ratio": 0.7, "vali_ratio": 0.1, "test_ratio": 0.2,
                             "batch_size": 16, "epochs": epochs, "lr": 0.0005,
                             "patience": epochs, "standardize": True,
                             **(training_extra or {})},
            },
        },
        "evaluation": {"metrics": ["accuracy"]},
    }
    t0 = time.perf_counter()
    out_dir = train_classifier.run(config, device=device)
    wall = time.perf_counter() - t0
    row = read_csv(os.path.join(out_dir, "results.csv"))[-1]  # a rerun appends
    return {"accuracy_all": json.loads(row["accuracy_all"]),
            "seeds": [int(s) for s in seed_stream(42, n_seeds)],
            "epochs": epochs, "wall_s": wall}


# ---------------------------------------------------------------------------
def synth_config_path(workdir: str) -> str:
    path = os.path.join(workdir, "synth_config.json")
    with open(path, "w") as f:
        json.dump(SYNTH_CONFIG, f)
    return path


def train_label_classifiers(workdir: str, outputs: dict, epochs: int, device=None) -> dict:
    """Logistic tone and syllable classifiers with checkpoints: the frozen
    models whose predicted label dynamics the synthesizers consume. Returns
    the checkpoint paths, the test accuracies and the predicted labels of
    every trial, decoded through ``serving.load_decoder``."""
    from decode_tonal_langauge_tpu_torch.serving import load_decoder
    from decode_tonal_langauge_tpu_torch.training import train_classifier

    config = {
        "model": {"model": "models.simple_classifiers.LogisticRegressionClassifier",
                  "model_name": "logistic", "model_kwargs": {}},
        "training": {
            "module": "train_classifier",
            "params": {
                "io": {"log_dir": os.path.join(workdir, "logs_synth_classifiers"),
                       "sample_dir": outputs["sample_collection"],
                       "channel_selection_dir": outputs["channel_selection"]},
                "experiment": {"targets": ["tone", "syllable"], "features": "ecog",
                               "separate_models": True, "seed": 42, "repeat": 1,
                               "verbose": 0},
                "training": {"train_ratio": 0.7, "vali_ratio": 0.1, "test_ratio": 0.2,
                             "batch_size": 16, "epochs": epochs, "lr": 0.001,
                             "patience": epochs, "standardize": True,
                             "save_checkpoints": True},
            },
        },
        "evaluation": {"metrics": ["accuracy"]},
    }
    out_dir = train_classifier.run(config, device=device)
    ckpt_dir = os.path.join(out_dir, "model_checkpoints")
    ckpts = {
        target: os.path.join(ckpt_dir, next(c for c in sorted(os.listdir(ckpt_dir))
                                            if c.startswith(target)))
        for target in ("tone", "syllable")
    }
    accs = {row["target"]: float(row["accuracy_mean"])
            for row in read_csv(os.path.join(out_dir, "results.csv"))}

    with open(os.path.join(outputs["channel_selection"], "subject_1.json")) as f:
        selections = json.load(f)
    data = np.load(os.path.join(outputs["sample_collection"], "subject_1.npz"))
    decoder = load_decoder(selections, SYNTH_CONFIG, data["ecog"].shape[2],
                           "logistic", ckpts["tone"], "logistic", ckpts["syllable"],
                           device=device)
    out = decoder.decode(data["ecog"], selections)
    pred_path = os.path.join(workdir, "predicted_labels.npz")
    np.savez(pred_path, tone=out["tone"], syllable=out["syllable"])
    return {"checkpoints": ckpts, "accuracy": accs, "predicted_labels": pred_path}


def train_synth_ours(workdir: str, outputs: dict, model: str, epochs: int, n_seeds: int,
                     classifier_ckpts: dict, device=None, dtype=None) -> dict:
    """One synthesizer cell through ``train_synthesizer``, with the argv
    of ``scripts/measure_parity.py:train_synth_ours``."""
    from decode_tonal_langauge_tpu_torch.training import train_synthesizer

    argv = [
        "--sample_path", os.path.join(outputs["sample_collection"], "subject_1.npz"),
        "--subject_id", "1",
        "--result_file", os.path.join(workdir, f"synth_{model}.csv"),
        "--channel_file", os.path.join(outputs["channel_selection"], "subject_1.json"),
        "--config_file", synth_config_path(workdir),
        "--model_name", f"parity_{model}",
        "--synthesis_model_name", model,
        "--syllable_model_name", "logistic",
        "--tone_model_name", "logistic",
        "--epochs", str(epochs),
        "--batch_size", "16",
        "--repeat", str(n_seeds),
        "--verbose", "0",
        "--audio_sampling_rate", "8000",
        "--tone_model_path", classifier_ckpts["tone"],
        "--syllable_model_path", classifier_ckpts["syllable"],
    ]
    if dtype:
        argv += ["--dtype", dtype]
    if device is not None:
        argv += ["--device", str(device)]
    params = train_synthesizer.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    summary = train_synthesizer.run(params)
    return {
        "mcd_mean": summary["mcd_mean"],
        "mel_pearson_r_mean": summary["mel_pearson_r_mean"],
        "mcd_all": json.loads(summary["mcd_all"]),
        "mel_pearson_r_std": summary["mel_pearson_r_std"],
        "seeds": json.loads(summary["seeds"]),
        "epochs": epochs,
        "wall_s": time.perf_counter() - t0,
    }


# ---------------------------------------------------------------------------
def _fisher_two_sided(a: int, b: int, c: int, d: int) -> float:
    """Two-sided Fisher exact p of the 2x2 table [[a, b], [c, d]]: the sum
    of the hypergeometric probabilities no larger than the observed one."""
    row, col, n = a + b, a + c, a + b + c + d

    def prob(x: int) -> float:
        return math.comb(col, x) * math.comb(n - col, row - x) / math.comb(n, row)

    observed = prob(a)
    lo, hi = max(0, row + col - n), min(row, col)
    return min(1.0, sum(p for p in map(prob, range(lo, hi + 1))
                        if p <= observed * (1 + 1e-7)))


def _summary(values) -> dict:
    v = np.asarray(values, dtype=np.float64)
    return {"mean": float(v.mean()), "sd": float(v.std(ddof=1)) if v.size > 1 else 0.0,
            "n": int(v.size), "min": float(v.min()), "escapes": int((v > ESCAPE).sum())}


def compare_cell(port: dict, jax: dict) -> dict:
    """The port's cell against the same cell of ``PARITY.json``.

    Per-seed accuracy cells: mean, sd (ddof 1) and n on both sides, the
    difference of means against ``2 sqrt(s_p^2/n_p + s_j^2/n_j)``, and the
    count of seeds above ``ESCAPE`` on both sides under a two-sided Fisher
    exact test (outside at p < ``FISHER_ALPHA``). A cell whose JAX seeds
    all score 1.0 is saturated: the port's worst seed must reach
    ``SATURATED_MIN``, and that is its only rule. Synthesis cells (JAX kept
    means only): outside when |delta r| > ``SYNTH_R_BAND`` or |delta MCD|
    > ``SYNTH_MCD_REL`` of JAX's MCD. Returns the numbers, the reasons a
    cell is outside, and ``verdict`` ("within" or "outside")."""
    reasons = []
    if "accuracy_all" in jax:
        p, j = _summary(port["accuracy_all"]), _summary(jax["accuracy_all"])
        diff = p["mean"] - j["mean"]
        band = 2.0 * math.sqrt(p["sd"] ** 2 / p["n"] + j["sd"] ** 2 / j["n"])
        fisher = _fisher_two_sided(p["escapes"], p["n"] - p["escapes"],
                                   j["escapes"], j["n"] - j["escapes"])
        out = {"kind": "accuracy", "port": p, "jax": j, "mean_diff": diff,
               "mean_band": band, "escape_fisher_p": fisher,
               "saturated": bool(j["min"] == 1.0)}
        if out["saturated"]:
            if p["min"] < SATURATED_MIN:
                reasons.append(f"saturated cell: port min {p['min']} < {SATURATED_MIN}")
        else:
            if abs(diff) > band:
                reasons.append(f"|mean diff| {abs(diff):.4f} > band {band:.4f}")
            if fisher < FISHER_ALPHA:
                reasons.append(f"escapes {p['escapes']}/{p['n']} vs {j['escapes']}/"
                               f"{j['n']}: Fisher p {fisher:.3g} < {FISHER_ALPHA}")
    else:
        d_r = port["mel_pearson_r_mean"] - jax["mel_pearson_r_mean"]
        d_mcd = port["mcd_mean"] - jax["mcd_mean"]
        out = {"kind": "synthesis",
               "port": {"mcd_mean": port["mcd_mean"], "mel_pearson_r_mean":
                        port["mel_pearson_r_mean"], "n": len(port.get("mcd_all", []))},
               "jax": {"mcd_mean": jax["mcd_mean"],
                       "mel_pearson_r_mean": jax["mel_pearson_r_mean"]},
               "r_diff": d_r, "mcd_diff": d_mcd, "mcd_rel_diff": d_mcd / jax["mcd_mean"]}
        if abs(d_r) > SYNTH_R_BAND:
            reasons.append(f"|delta r| {abs(d_r):.4f} > {SYNTH_R_BAND}")
        if abs(d_mcd) > SYNTH_MCD_REL * jax["mcd_mean"]:
            reasons.append(f"|delta MCD| {abs(d_mcd):.1f} > {SYNTH_MCD_REL:.0%} of "
                           f"{jax['mcd_mean']:.1f}")
    out["reasons"] = reasons
    out["verdict"] = "outside" if reasons else "within"
    return out


def compare_subject(results: dict, jax_subject: dict) -> dict:
    """:func:`compare_cell` for every cell the port ran and JAX recorded."""
    return {key: compare_cell(results[key], jax_subject[key])
            for key in {**CLASSIFIER_CELLS, **SYNTH_CELLS}
            if key in results and key in jax_subject}


# ---------------------------------------------------------------------------
def sources_sha256() -> str:
    """A digest of the port's sources and this script: the tree a run
    measured, checkable against any checkout."""
    digest = hashlib.sha256()
    paths = [os.path.abspath(__file__)]
    for root, dirs, files in os.walk(os.path.join(REPO, "decode_tonal_langauge_tpu_torch")):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        paths += [os.path.join(root, f) for f in sorted(files)
                  if f.endswith((".py", ".cu"))]
    for path in paths:
        digest.update(os.path.relpath(path, REPO).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()


def run_meta(device) -> dict:
    import torch

    card = None
    if torch.device(device).type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    commit = os.environ.get("PARITY_COMMIT")
    if commit is None:
        git = subprocess.run(["git", "-C", REPO, "rev-parse", "HEAD"],
                             capture_output=True, text=True)
        commit = git.stdout.strip() if git.returncode == 0 else None
    return {
        "device": str(device),
        "card": card,
        "commit": commit,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "sources_sha256": sources_sha256(),
        "jax_reference": f"PARITY.json (commit {JAX_PARITY_COMMIT})",
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="parity_work")
    ap.add_argument("--only", default=None,
                    help="comma list: pipeline,cnn,cnn_bf16,cnn_bf16_opt,cnnrnn,synth "
                         "(synth_lite and synth_cnn),synth_lite,synth_cnn,synth_lite_bf16")
    ap.add_argument("--out", default=None,
                    help="the two-subject JSON document to merge this subject into")
    ap.add_argument("--noise-scale", type=float, default=1.0,
                    help="synthetic-subject noise amplitude: 1.0 the easy subject, "
                         "4.5 the hard one (use a fresh --workdir)")
    ap.add_argument("--epochs", type=int, default=None,
                    help=f"override the classifier and SynthesisFull epochs ({EPOCHS})")
    ap.add_argument("--seeds", type=int, default=None,
                    help=f"override the seed count ({N_SEEDS}); the seed stream is "
                         "the prefix-stable np.random.seed(42) draw")
    ap.add_argument("--seed-chunk", type=int, default=None,
                    help="bound the CNN-RNN cell's batched seed width "
                         "(training seed_chunk)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return ap


def main(argv=None, synth_lite_epochs: int = SYNTH_LITE_EPOCHS) -> dict:
    """Run the selected cells in ``--workdir`` and return its results, each
    run cell's comparison under ``comparison``. ``synth_lite_epochs`` sets
    the SynthesisLite cells' epochs (60 as in the JAX harness)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # no card and no --device: raise here
    epochs = args.epochs or EPOCHS
    n_seeds = args.seeds or N_SEEDS
    only = set(args.only.split(",")) if args.only else None
    if only and "synth" in only:
        only |= {"synth_lite", "synth_cnn"}

    os.makedirs(args.workdir, exist_ok=True)
    workdir = os.path.abspath(args.workdir)
    state_path = os.path.join(workdir, "parity_state.json")
    results = {}
    if os.path.exists(state_path):
        with open(state_path) as f:
            results = json.load(f)

    def save():
        with open(state_path, "w") as f:
            json.dump(results, f, indent=2)

    def wanted(key):
        return (only is None or key in only) and key not in results

    if "outputs" not in results:
        t0 = time.perf_counter()
        build_subject(workdir, noise_scale=args.noise_scale)
        results["outputs"] = run_pipeline_stages(workdir, device)
        results["noise_scale"] = args.noise_scale
        results["pipeline_wall_s"] = time.perf_counter() - t0
        save()
    outputs = results["outputs"]

    for key, (model_path, target, model_kwargs, extra) in CLASSIFIER_CELLS.items():
        if key == "cnnrnn" and args.seed_chunk:
            extra = {"seed_chunk": args.seed_chunk}
        if wanted(key):
            results[key] = train_ours(workdir, outputs, model_path, key, target, n_seeds,
                                      epochs, device, model_kwargs, extra)
            print(f"{key}: accuracy {results[key]['accuracy_all']} "
                  f"({results[key]['wall_s']:.1f} s)", flush=True)
            save()

    for key, (model, dtype) in SYNTH_CELLS.items():
        if not wanted(key):
            continue
        if "label_classifiers" not in results:
            results["label_classifiers"] = train_label_classifiers(
                workdir, outputs, epochs, device)
            save()
        cell_epochs = synth_lite_epochs if model == "SynthesisLite" else epochs
        results[key] = train_synth_ours(
            workdir, outputs, model, cell_epochs, n_seeds,
            results["label_classifiers"]["checkpoints"], device, dtype)
        print(f"{key}: MCD {results[key]['mcd_mean']:.1f}, r "
              f"{results[key]['mel_pearson_r_mean']:.4f} "
              f"({results[key]['wall_s']:.1f} s)", flush=True)
        save()

    subject = SUBJECTS.get(results["noise_scale"])
    if subject:
        with open(JAX_PARITY) as f:
            results["comparison"] = compare_subject(results, json.load(f)[subject])
    results["meta"] = run_meta(device)
    save()

    if args.out:
        if subject is None:
            raise SystemExit(f"--out needs noise scale 1.0 or 4.5, not {results['noise_scale']}")
        cells = {k: v for k, v in results.items() if k not in ("outputs", "meta")}
        if "label_classifiers" in cells:  # its paths are the workdir's
            cells["label_classifiers"] = {"accuracy": cells["label_classifiers"]["accuracy"]}
        append_data_json(args.out, {"meta": results["meta"], subject: cells})
    else:
        with open(os.path.join(workdir, "parity_results.json"), "w") as f:
            json.dump(results, f, indent=2)
    for key, cmp in results.get("comparison", {}).items():
        print(f"{key}: {cmp['verdict']} {'; '.join(cmp['reasons'])}".rstrip(), flush=True)
    return results


if __name__ == "__main__":
    main()
