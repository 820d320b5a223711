"""Evaluation stage: checkpoints + samples -> test metrics, no retraining.

Counterpart of ``decode_tonal_langauge_tpu/evaluation/main.py``. Point it
at a finished training run (``save_checkpoints: true``) and it reproduces
every (target, seed) test split, loads the port's torch checkpoints,
re-applies the checkpointed train-split scaler, predicts the held-out
trials with the frozen models and writes the training stage's
``results.csv`` schema and confusion artifacts, without a gradient step.

Config::

    evaluation:
      module: evaluation_main
      metrics: [accuracy, f1_score, confusion_matrix]
      metric_aggregates: [mean, std]
      params:
        io:
          training_dir: <training stage output>   # threaded by the runner
          sample_dir: <sample_collection output>  # threaded
          channel_selection_dir: <...>            # threaded
          output_dir: <explicit override>         # default training_dir/evaluation

Model class and kwargs (``model.per_target`` included), targets, split
ratios, base seed, repeat count and batch size come from the training
run's provenance ``config.yaml``, flattened exactly as training flattens
its config (``config.flatten_training_provenance``). Predictions go
through ``ClassifierTrainer.predict``, in padded batches of the run's
``batch_size``, in eval mode and full f32: the trainer's own test
predictions, so the rows equal the training stage's on the CPU and on the
card. ``run(config, device=None)`` predicts on ``device`` (``None``: the
card; it raises without one). One process evaluates every subject (the
JAX stage's ``host_shard`` and per-process result merge are not ported).
"""

from __future__ import annotations

import json
import os
from argparse import Namespace
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import (
    flatten_training_provenance,
    load_config,
    namespace_training_params,
)
from ..data.sample_loading import ClassificationSampleHandler
from ..data.splits import split_indices
from ..models.factory import get_classifier_by_name
from ..runtime.checkpoint import load_checkpoint
from ..runtime.device import DeviceLike, resolve_device
from ..training.classifier_pipeline import (
    checkpoint_name,
    save_and_plot_results,
    target_model_params,
)
from ..training.trainer import ClassifierTrainer
from ..utils.metrics import (
    compute_classification_metrics,
    compute_classification_metrics_joint,
)
from ..utils.seeding import seed_stream

# Heads whose bias length is the class count, in the port's classifiers.
_HEADS = ("linear", "output", "fc2", "head")


def _load_training_provenance(training_dir: str) -> Dict[str, Any]:
    cfg_path = os.path.join(training_dir, "config.yaml")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"No config.yaml in {training_dir} — evaluation needs the "
            "training stage's provenance config to reproduce its splits."
        )
    return load_config(cfg_path) or {}


def _checkpoint_path(params: Namespace, target_str: str, seed: int) -> str:
    return os.path.join(params.training_dir, "model_checkpoints",
                        checkpoint_name(params, target_str, seed))


def _predict_target_seed(
    params: Namespace,
    features: np.ndarray,
    labels: np.ndarray,
    n_classes: int,
    target_str: str,
    seed: int,
    restored_cache: Optional[Dict[str, tuple]] = None,
):
    """Reproduce one (target, seed) test split and predict it frozen:
    (true labels, predictions, parameter count)."""
    ckpt = _checkpoint_path(params, target_str, seed)
    if not os.path.exists(ckpt):
        raise FileNotFoundError(
            f"Checkpoint {ckpt} not found — run the training stage with "
            "save_checkpoints: true before the evaluation stage."
        )
    # the head-size probe may have loaded this checkpoint already
    restored = restored_cache.pop(ckpt, None) if restored_cache else None
    state, scaler = restored if restored is not None else load_checkpoint(ckpt)
    if scaler is not None:
        features = (features - scaler[0].numpy()) / scaler[1].numpy()

    _, _, te_idx = split_indices(
        features.shape[0],
        [params.train_ratio, params.vali_ratio, params.test_ratio],
        seed=seed,
    )
    model = get_classifier_by_name(
        params.model,
        n_classes=n_classes,
        n_channels=features.shape[1],
        seq_length=features.shape[2],
        classifier_kwargs=getattr(params, "model_kwargs", {}) or {},
    )
    model.load_state_dict(state)
    predictor = ClassifierTrainer(model, n_classes, batch_size=params.batch_size,
                                  device=params.device)
    model.to(predictor.device)
    preds = predictor.predict(features[te_idx].astype(np.float32))
    return labels[te_idx], preds, predictor.n_params()


def _n_classes_from_checkpoint(
    params: Namespace,
    target_str: str,
    seed: int,
    restored_cache: Optional[Dict[str, tuple]] = None,
) -> Optional[int]:
    """Class-head size from the trained checkpoint's own bias: every port
    classifier ends in a head (``linear`` / ``output`` / ``fc2`` /
    ``head``) whose bias length is ``n_classes``. None for a missing
    checkpoint or a model without a known head name. The loaded
    checkpoint is parked in ``restored_cache`` for the seed loop."""
    ckpt = _checkpoint_path(params, target_str, seed)
    if not os.path.exists(ckpt):
        return None
    restored = load_checkpoint(ckpt)
    if restored_cache is not None:
        restored_cache[ckpt] = restored
    state = restored[0]
    for head in _HEADS:
        if f"{head}.bias" in state:
            return int(state[f"{head}.bias"].shape[0])
    return None


def _evaluate_subject(params: Namespace, seeds: np.ndarray) -> None:
    """All (target, seed) evaluations of one subject -> results.csv rows."""
    metrics = getattr(params, "metrics", ["accuracy"])
    separate = bool(getattr(params, "separate_models", False))

    # Pin the label space to the training run's recorded per-target
    # counts (classifier_pipeline.record_label_space).
    label_space_path = os.path.join(
        params.training_dir, f"n_classes_subject_{params.subject_id}.json"
    )
    if os.path.exists(label_space_path):
        with open(label_space_path) as f:
            params.expected_n_classes = json.load(f)

    if separate:
        per_target: Dict[str, dict] = {}
        channels: Dict[str, List[int]] = {}
        n_classes_dict: Dict[str, int] = {}
        individual_class_labels: Dict[str, List[str]] = {}
        for target in params.targets:
            tp = Namespace(**vars(params))
            tp.targets = [target]
            handler = ClassificationSampleHandler(tp)
            data = handler.load_data()
            per_target[target] = data
            channels[target] = [int(c) for c in data["selected_channels"]]
            n_classes_dict[target] = data["n_classes_dict"][target]
            individual_class_labels[target] = handler.prepare_class_labels(
                {target: data["n_classes_dict"][target]}
            )
        class_labels = ClassificationSampleHandler(params).prepare_class_labels(
            n_classes_dict
        )
        n_classes = int(np.prod(list(n_classes_dict.values())))
    else:
        handler = ClassificationSampleHandler(params)
        data = handler.load_data()
        # The joint head size comes from the checkpoint: the evaluated
        # data undercounts whenever a combined class is absent from it.
        joint_name = (
            "_".join(params.targets)
            if len(params.targets) > 1
            else params.targets[0]
        )
        restored_cache: Dict[str, tuple] = {}
        n_classes = _n_classes_from_checkpoint(
            params, joint_name, int(seeds[0]), restored_cache
        ) or len(np.unique(data["labels"]))
        class_labels = handler.prepare_class_labels(data["n_classes_dict"])

    metric_values: Dict[str, List[float]] = {
        m: [] for m in metrics if m != "confusion_matrix"
    }
    confusion_mat = (
        np.zeros((n_classes, n_classes))
        if "confusion_matrix" in metrics
        else None
    )
    individual_metrics = (
        {
            t: {m: [] for m in metrics if m != "confusion_matrix"}
            for t in params.targets
        }
        if separate
        else {}
    )
    individual_confusion_mat = (
        {
            t: np.zeros((n_classes_dict[t], n_classes_dict[t]))
            for t in params.targets
        }
        if separate and "confusion_matrix" in metrics
        else None
    )
    model_size = 0

    for seed in seeds:
        if separate:
            all_true: Dict[str, np.ndarray] = {}
            all_preds: Dict[str, np.ndarray] = {}
            for target in params.targets:
                data = per_target[target]
                # model.per_target: the override the training stage
                # applied, recovered from provenance.
                true, preds, n_params = _predict_target_seed(
                    target_model_params(params, target),
                    data["features"].astype(np.float32),
                    data["labels"].astype(np.int32),
                    n_classes_dict[target],
                    target,
                    int(seed),
                )
                all_true[target] = true
                all_preds[target] = preds
                model_size += n_params
                tm = compute_classification_metrics(true, preds, metrics=metrics)
                for m in metric_values:
                    individual_metrics[target][m].append(tm[m])
                if (
                    individual_confusion_mat is not None
                    and "confusion_matrix" in tm
                ):
                    cm = tm["confusion_matrix"]
                    full = individual_confusion_mat[target]
                    full[: cm.shape[0], : cm.shape[1]] += cm
            jm = compute_classification_metrics_joint(
                all_true, all_preds, metrics=metrics
            )
        else:
            true, preds, n_params = _predict_target_seed(
                params,
                data["features"].astype(np.float32),
                data["labels"].astype(np.int32),
                n_classes,
                joint_name,
                int(seed),
                restored_cache,
            )
            model_size = n_params
            jm = compute_classification_metrics(true, preds, metrics=metrics)
        for m in metric_values:
            metric_values[m].append(jm[m])
        if confusion_mat is not None and "confusion_matrix" in jm:
            cm = jm["confusion_matrix"]
            confusion_mat[: cm.shape[0], : cm.shape[1]] += cm

    result_info = {
        **metric_values,
        "model_size": model_size,
        "channels": channels if separate else
        [int(c) for c in data["selected_channels"]],
        "seeds": np.asarray(seeds).tolist(),
        "class_labels": class_labels,
    }
    if separate:
        result_info["individual_metrics"] = individual_metrics
        result_info["individual_confusion_matrix"] = individual_confusion_mat
        result_info["individual_class_labels"] = individual_class_labels
        result_info["individual_model_names"] = {
            t: target_model_params(params, t).model_name
            for t in params.targets
        }

    save_and_plot_results(params, result_info, confusion_mat, class_labels)


def run(config: dict, device: DeviceLike = None) -> str:
    device = resolve_device(device)
    print("Running evaluation ...")
    eval_section = config.get("evaluation", {}) or {}
    eval_params = eval_section.get("params", {}) or {}
    io_cfg = dict(eval_params.get("io", {}) or {})

    training_dir = io_cfg.get("training_dir")
    if not training_dir:
        raise ValueError(
            "evaluation.params.io.training_dir is required (the pipeline "
            "runner threads it from the training stage automatically)."
        )
    provenance = _load_training_provenance(training_dir)

    flat = flatten_training_provenance(provenance)
    # metrics/aggregates: the evaluation stage's own section wins over the
    # training-time values, so extra metrics can be evaluated post hoc.
    flat.update(provenance.get("evaluation", {}) or {})
    for key in ("metrics", "metric_aggregates", "aggregates"):
        if key in eval_section:
            flat[key] = eval_section[key]
    if "metric_aggregates" in flat and "aggregates" not in flat:
        flat["aggregates"] = flat.pop("metric_aggregates")

    params = namespace_training_params(flat)
    params.training_dir = training_dir
    params.device = device

    # Explicit evaluation io wins; else the dirs the training run recorded.
    sample_dir = io_cfg.get("sample_dir") or getattr(params, "sample_dir", None)
    channel_dir = io_cfg.get("channel_selection_dir") or getattr(
        params, "channel_selection_dir", None
    )
    if not sample_dir or not os.path.exists(sample_dir):
        raise FileNotFoundError(
            f"Sample directory {sample_dir!r} does not exist — set "
            "evaluation.params.io.sample_dir or run sample_collection first."
        )
    params.log_dir = io_cfg.get("output_dir") or os.path.join(
        training_dir, "evaluation"
    )
    os.makedirs(params.log_dir, exist_ok=True)

    # The training stage's per-repeat seed stream.
    seeds = seed_stream(getattr(params, "seed", 42), getattr(params, "repeat", 1))

    subject_files = [
        f
        for f in sorted(os.listdir(sample_dir))
        if f.endswith(".npz") and f.startswith("subject_")
    ]
    subject_ids = getattr(params, "subject_ids", None)
    allowed = {str(s) for s in subject_ids} if subject_ids else None

    for subject_file in subject_files:
        subject_id = subject_file.split("_")[1].split(".")[0]
        if allowed is not None and subject_id not in allowed:
            continue
        print(f"--------- Evaluating subject: {subject_id} ---------")
        sp = Namespace(**vars(params))
        sp.subject_id = subject_id
        sp.sample_path = os.path.join(sample_dir, subject_file)
        if channel_dir:
            sp.channel_file = os.path.join(
                channel_dir, f"subject_{subject_id}.json"
            )
        _evaluate_subject(sp, seeds)
    return params.log_dir
