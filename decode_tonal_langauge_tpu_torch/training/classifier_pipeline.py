"""High-level classifier training regimes: separate / joint targets.

Counterpart of ``decode_tonal_langauge_tpu/training/classifier_pipeline.py``:

- **separate**: one model per target on its own discriminative-channel
  subset (each target may carry its own architecture, ``model.per_target``);
  per-seed split/train/test/predict; joint metrics by combining the
  per-target predictions;
- **joint**: a single model on the mixed-radix combined label;
- ``save_and_plot_results``: appended ``results.csv`` rows with
  ``<metric>_<agg>`` and ``<metric>_all`` columns, confusion-matrix CSVs
  and, where matplotlib imports, figures.

The results CSV has the JAX package's columns and row order, written with
the ``csv`` module. With more than one process each writes its own shard,
``results.process<k>.csv`` (concurrent appends to one file can interleave
mid-row), which ``train_classifier.merge_process_results`` folds into
``results.csv`` at the end of the stage.
"""

from __future__ import annotations

import csv
import math
import os
from argparse import Namespace
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.sample_loading import ClassificationSampleHandler
from ..data.splits import split_indices
from ..models.factory import get_classifier_by_name
from ..parallel.distributed import process_count, process_index
from ..utils.metrics import (
    compute_classification_metrics,
    compute_classification_metrics_joint,
)
from ..utils.visualise import plot_confusion_matrix
from .seed_parallel import SeedFitResult, SeedParallelTrainer, fit_seed
from .trainer import ClassifierTrainer


def _make_trainer(params: Namespace, model, n_classes: int, seed: int, log_dir):
    return ClassifierTrainer(
        model,
        n_classes=n_classes,
        learning_rate=params.lr,
        weight_decay=float(getattr(params, "weight_decay", 0.0)),
        batch_size=params.batch_size,
        max_epochs=params.epochs,
        patience=params.patience,
        seed=seed,
        log_dir=log_dir,
        verbose=getattr(params, "verbose", 1) > 1,
        moment_dtype=getattr(params, "moment_dtype", None),
        device=getattr(params, "device", None),
        mesh=getattr(params, "mesh", None),
    )


def target_model_params(params: Namespace, target: str) -> Namespace:
    """Per-target model override (``model.per_target`` in the YAML).

    The paper pairs different architectures per target (CNN for
    syllables, CNN-RNN for tones). In the separate-models regime::

        model:
          model: models.deep_classifiers.CNNClassifier   # default
          per_target:
            tone:
              model: models.deep_classifiers.CNNRNNClassifier
              model_kwargs: {lstm_dim: 800}

    Targets absent from ``per_target`` use the base section. The
    evaluation stage applies the SAME helper to the provenance config,
    so checkpoint names and frozen re-evaluation stay consistent.
    Ignored (with a warning, in the caller) in joint mode — a single
    model decodes the combined label there."""
    overrides = getattr(params, "per_target", None) or {}
    override = overrides.get(str(target))
    if not override:
        return params
    tp = Namespace(**vars(params))
    tp.model = override.get("model", params.model)
    if override.get("model_name"):
        tp.model_name = override["model_name"]
    elif "model" in override:
        tp.model_name = tp.model.split(".")[-1]
    if "model_kwargs" in override:
        tp.model_kwargs = override["model_kwargs"]
    return tp


def checkpoint_name(params: Namespace, target_str: str, seed: int) -> str:
    """Canonical per-(subject, target, model, seed) checkpoint name.

    Single source of truth for the training stage's saves AND the
    evaluation stage's loads — multi-subject runs would otherwise
    overwrite each other in the shared ``model_checkpoints``/
    ``train_state`` directories. The subject component is omitted when
    ``params`` carries no ``subject_id`` (direct library use)."""
    sid = getattr(params, "subject_id", None)
    subject = f"subject_{sid}_" if sid is not None else ""
    return f"{target_str}_{params.model_name}_{subject}seed_{seed}"


def _seed_split(params: Namespace, features: np.ndarray, labels: np.ndarray, seed: int):
    """One seed's (train x, train y, val x, val y, test x, test y) and
    the optional per-feature standardisation fit on its train split
    (stabilises adaptive optimizers on positive-mean envelope features):
    the scaler ``(mu, sd)``, or None."""
    tr_idx, va_idx, te_idx = split_indices(
        features.shape[0],
        [params.train_ratio, params.vali_ratio, params.test_ratio],
        seed=seed,
    )
    scaler = None
    if getattr(params, "standardize", False):
        mu = features[tr_idx].mean(axis=0, keepdims=True)
        sd = features[tr_idx].std(axis=0, keepdims=True) + 1e-6
        features = (features - mu) / sd
        scaler = (mu, sd)
    split = (features[tr_idx], labels[tr_idx], features[va_idx], labels[va_idx],
             features[te_idx], labels[te_idx])
    return split, scaler


def _model(params: Namespace, features: np.ndarray, n_classes: int):
    return get_classifier_by_name(
        params.model,
        n_classes=n_classes,
        n_channels=features.shape[1],
        seq_length=features.shape[2],
        classifier_kwargs=getattr(params, "model_kwargs", {}) or {},
    )


def _fit_and_eval(
    params: Namespace,
    features: np.ndarray,
    labels: np.ndarray,
    n_classes: int,
    seed: int,
    log_dir: str,
    target_str: Optional[str] = None,
) -> SeedFitResult:
    """Split, standardise, train with early stopping, test and predict
    one seed."""
    split, scaler = _seed_split(params, features, labels, seed)
    model = _model(params, features, n_classes)
    trainer = _make_trainer(params, model, n_classes, seed, log_dir)
    # Full train-state checkpointing: training.params.training keys
    # train_state_dir / resume / checkpoint_every.
    ts_dir = getattr(params, "train_state_dir", None)
    if target_str is None:
        target_str = "_".join(getattr(params, "targets", []) or ["target"])
    return fit_seed(
        trainer,
        *split,
        scaler=scaler,
        checkpoint_dir=(
            # checkpoint_name keys the state by (subject, target, model,
            # seed): in separate_models mode each target's fit must NOT
            # share a train-state path (resume would restore the other
            # target's params into the wrong head).
            os.path.join(ts_dir, checkpoint_name(params, target_str, seed))
            if ts_dir
            else None
        ),
        resume=bool(getattr(params, "resume", False)),
        checkpoint_every=getattr(params, "checkpoint_every", None),
    )


def _maybe_save_checkpoint(
    params: Namespace, variables: dict, target_str: str, seed: int,
    scaler=None,
) -> None:
    if not getattr(params, "save_checkpoints", False):
        return
    from ..runtime.checkpoint import save_checkpoint

    model_dir = os.path.join(params.log_dir, "model_checkpoints")
    os.makedirs(model_dir, exist_ok=True)
    # The scaler rides along: inference must reproduce the train-split
    # feature scaling (standardize: true).
    save_checkpoint(
        os.path.join(model_dir, checkpoint_name(params, target_str, seed)),
        variables["params"], scaler,
    )


def _fit_eval_all_seeds(
    params: Namespace,
    features: np.ndarray,
    labels: np.ndarray,
    n_classes: int,
    seeds,
    log_dir_fn,
    target_str: Optional[str] = None,
) -> List[SeedFitResult]:
    """All repeat seeds of one experiment, in seed order.

    With ``seed_parallel`` (default on) and more than one seed, every
    seed's split, standardisation, fit and test run as ONE batched fit
    (:class:`SeedParallelTrainer`, in chunks of ``seed_chunk`` seeds,
    its seed axis sharded over a ``parallel:`` mesh), as in the JAX
    stage. Otherwise, and with ``train_state_dir`` (per-seed
    checkpoint/resume), the seeds run one at a time through
    :func:`_fit_and_eval`.
    """
    features = features.astype(np.float32)
    labels = labels.astype(np.int32)
    seeds = [int(s) for s in seeds]

    # train_state_dir (full-state checkpoint/resume) forces the
    # sequential per-seed path: the batched multi-seed fit has no
    # per-seed resume granularity.
    use_seed_parallel = (
        getattr(params, "seed_parallel", True)
        and len(seeds) > 1
        and not getattr(params, "train_state_dir", None)
    )
    if (
        not use_seed_parallel
        and getattr(params, "seed_parallel", True)
        and len(seeds) > 1
        and getattr(params, "train_state_dir", None)
    ):
        print(
            "train_state_dir set: per-seed checkpoint/resume requires the "
            "sequential trainer, so seed_parallel is disabled for this run"
        )
    if not use_seed_parallel:
        return [_fit_and_eval(params, features, labels, n_classes, seed, log_dir_fn(seed),
                              target_str=target_str)
                for seed in seeds]

    # --- seed-parallel path: per-seed split gathers stacked on axis 0 ---
    splits, scalers = zip(*(_seed_split(params, features, labels, seed) for seed in seeds))
    spt = SeedParallelTrainer(
        _model(params, features, n_classes),
        n_classes=n_classes,
        seeds=seeds,
        learning_rate=params.lr,
        weight_decay=float(getattr(params, "weight_decay", 0.0)),
        batch_size=params.batch_size,
        max_epochs=params.epochs,
        patience=params.patience,
        verbose=getattr(params, "verbose", 1) > 1,
        moment_dtype=getattr(params, "moment_dtype", None),
        device=getattr(params, "device", None),
        mesh=getattr(params, "mesh", None),
        seed_chunk=getattr(params, "seed_chunk", None),
    )
    results = spt.fit_eval(*(np.stack(part) for part in zip(*splits)))
    for res, scaler in zip(results, scalers):
        res.scaler = scaler
        spt.write_logs(res, log_dir_fn(res.seed))
    return results


def record_label_space(params: Namespace, n_classes_dict: Dict[str, int]) -> None:
    """Persist the per-target class counts this subject was TRAINED with.

    The evaluation stage reads this to pin its mixed-radix encoding and
    per-target head sizes to the training run's label space — deriving
    them from the evaluated data silently re-encodes the labels whenever
    a class is absent from the evaluated subset."""
    import json

    path = os.path.join(
        params.log_dir, f"n_classes_subject_{params.subject_id}.json"
    )
    with open(path, "w") as f:
        json.dump({k: int(v) for k, v in n_classes_dict.items()}, f)


def train_separate_targets(
    params: Namespace, seeds: np.ndarray
) -> Tuple[Dict, np.ndarray, List[str]]:
    """Train one classifier per target; combine per-target predictions."""
    verbose = getattr(params, "verbose", 1)

    all_data: Dict[str, dict] = {}
    channels: Dict[str, List[int]] = {}
    n_classes_dict: Dict[str, int] = {}
    individual_class_labels: Dict[str, List[str]] = {}

    for target in params.targets:
        target_params = Namespace(**vars(params))
        target_params.targets = [target]
        handler = ClassificationSampleHandler(target_params)
        data = handler.load_data()
        all_data[target] = data
        n_classes_dict[target] = data["n_classes_dict"][target]
        channels[target] = [int(c) for c in data["selected_channels"]]
        individual_class_labels[target] = handler.prepare_class_labels(
            {target: data["n_classes_dict"][target]}
        )
        if verbose > 0:
            print(
                f"Prepared {data['features'].shape[0]} samples with shape "
                f"{data['features'].shape} for target {target}"
            )

    class_labels = ClassificationSampleHandler(params).prepare_class_labels(
        n_classes_dict
    )
    record_label_space(params, n_classes_dict)

    n_classes = int(np.prod(list(n_classes_dict.values())))
    metrics = getattr(params, "metrics", ["accuracy"])
    metric_values: Dict[str, List[float]] = {
        m: [] for m in metrics if m != "confusion_matrix"
    }
    confusion_mat = (
        np.zeros((n_classes, n_classes)) if "confusion_matrix" in metrics else None
    )
    model_size = 0

    individual_metrics = {
        t: {m: [] for m in metrics if m != "confusion_matrix"}
        for t in params.targets
    }
    individual_confusion_mat = (
        {
            t: np.zeros((n_classes_dict[t], n_classes_dict[t]))
            for t in params.targets
        }
        if "confusion_matrix" in metrics
        else None
    )

    # All seeds of each target fitted up front. Each target may carry its
    # own architecture (model.per_target: e.g. the paper's CNN syllable +
    # CNN-RNN tone pairing in one run).
    fits: Dict[str, List[SeedFitResult]] = {}
    tparams_by_target = {
        t: target_model_params(params, t) for t in params.targets
    }
    for target in params.targets:
        data = all_data[target]
        fits[target] = _fit_eval_all_seeds(
            tparams_by_target[target],
            data["features"],
            data["labels"],
            n_classes_dict[target],
            seeds,
            log_dir_fn=lambda seed, target=target: os.path.join(
                params.log_dir,
                f"{target}_csv",
                f"subject_{params.subject_id}",
                f"seed_{seed}",
            ),
            target_str=target,
        )

    for i, seed in enumerate(seeds):
        all_preds: Dict[str, np.ndarray] = {}
        all_true: Dict[str, np.ndarray] = {}

        for target in params.targets:
            res = fits[target][i]
            true, preds = res.test_true, res.test_preds
            all_true[target] = true
            all_preds[target] = preds
            model_size += res.n_params
            _maybe_save_checkpoint(
                tparams_by_target[target],
                {"params": res.params},
                target,
                int(seed),
                scaler=res.scaler,
            )

            target_metrics = compute_classification_metrics(
                true, preds, metrics=metrics
            )
            for m in metrics:
                if m == "confusion_matrix":
                    continue
                individual_metrics[target][m].append(target_metrics[m])
            if (
                individual_confusion_mat is not None
                and "confusion_matrix" in target_metrics
            ):
                cm = target_metrics["confusion_matrix"]
                full = individual_confusion_mat[target]
                full[: cm.shape[0], : cm.shape[1]] += cm

        joint_metrics = compute_classification_metrics_joint(
            all_true, all_preds, metrics=metrics, verbose=verbose > 1
        )
        for m in metrics:
            if m == "confusion_matrix":
                continue
            metric_values[m].append(joint_metrics[m])
        if confusion_mat is not None and "confusion_matrix" in joint_metrics:
            cm = joint_metrics["confusion_matrix"]
            confusion_mat[: cm.shape[0], : cm.shape[1]] += cm

    result_info = {
        **metric_values,
        "model_size": model_size,
        "channels": channels,
        "seeds": np.asarray(seeds).tolist(),
        "class_labels": class_labels,
        "individual_metrics": individual_metrics,
        "individual_confusion_matrix": individual_confusion_mat,
        "individual_class_labels": individual_class_labels,
        "individual_model_names": {
            t: tp.model_name for t, tp in tparams_by_target.items()
        },
    }
    return result_info, confusion_mat, class_labels


def train_joint_targets(
    params: Namespace, seeds: np.ndarray
) -> Tuple[Dict, np.ndarray, List[str]]:
    """Train a single model on the mixed-radix combined label."""
    verbose = getattr(params, "verbose", 1)
    if getattr(params, "per_target", None):
        import warnings

        warnings.warn(
            "model.per_target is ignored in joint mode (separate_models: "
            "false) — a single model decodes the combined label."
        )

    handler = ClassificationSampleHandler(params)
    data = handler.load_data()
    features = data["features"].astype(np.float32)
    labels = data["labels"].astype(np.int32)

    if verbose > 0:
        print(
            f"Prepared {features.shape[0]} samples with shape {features.shape} "
            f"and labels with shape {labels.shape}"
        )

    n_classes = len(np.unique(labels))
    class_labels = handler.prepare_class_labels(data["n_classes_dict"])
    record_label_space(params, data["n_classes_dict"])

    metrics = getattr(params, "metrics", ["accuracy"])
    metric_values: Dict[str, List[float]] = {
        m: [] for m in metrics if m != "confusion_matrix"
    }
    confusion_mat = (
        np.zeros((n_classes, n_classes)) if "confusion_matrix" in metrics else None
    )
    model_size = 0

    target_name = (
        "_".join(params.targets) if len(params.targets) > 1 else params.targets[0]
    )

    joint_fits = _fit_eval_all_seeds(
        params,
        features,
        labels,
        n_classes,
        seeds,
        log_dir_fn=lambda seed: os.path.join(
            params.log_dir,
            f"{target_name}_csv",
            f"subject_{params.subject_id}",
            f"seed_{seed}",
        ),
        target_str=target_name,
    )

    for i, seed in enumerate(seeds):
        res = joint_fits[i]
        true, preds = res.test_true, res.test_preds
        model_size = res.n_params
        _maybe_save_checkpoint(
            params,
            {"params": res.params},
            target_name,
            int(seed),
            scaler=res.scaler,
        )

        joint_metrics = compute_classification_metrics(
            true, preds, metrics=metrics, verbose=verbose > 1
        )
        if confusion_mat is not None and "confusion_matrix" in joint_metrics:
            cm = joint_metrics["confusion_matrix"]
            confusion_mat[: cm.shape[0], : cm.shape[1]] += cm
        for m in metrics:
            if m == "confusion_matrix":
                continue
            metric_values[m].append(joint_metrics[m])

    result_info = {
        **metric_values,
        "model_size": model_size,
        "channels": [int(c) for c in data["selected_channels"]],
        "class_labels": class_labels,
        "seeds": np.asarray(seeds).tolist(),
    }
    return result_info, confusion_mat, class_labels


def save_and_plot_results(
    params: Namespace,
    result_info: Dict,
    confusion_matrix: np.ndarray,
    class_labels: List[str],
) -> None:
    """Append result rows to results.csv and write confusion figures."""
    metrics = getattr(params, "metrics", ["accuracy"])
    aggregates = getattr(params, "aggregates", ["mean", "std"])
    if isinstance(aggregates, str):
        aggregates = [aggregates]

    joint_label = ", ".join(getattr(params, "targets", []))

    def _norm_channel_list(chs) -> List[int]:
        if chs is None:
            return []
        return sorted({int(c) for c in chs})

    def _channels_for(target_label: str) -> str:
        chs_info = result_info.get("channels", [])
        if isinstance(chs_info, (list, tuple, np.ndarray)):
            return ",".join(map(str, _norm_channel_list(chs_info)))
        if isinstance(chs_info, dict):
            if target_label == joint_label:
                union: set = set()
                for t in getattr(params, "targets", []):
                    union.update(int(c) for c in chs_info.get(str(t), []))
                return ",".join(map(str, sorted(union)))
            return ",".join(map(str, _norm_channel_list(chs_info.get(str(target_label), []))))
        return ""

    def _build_row(metric_dict: Dict[str, list], target_label: str) -> dict:
        row = {
            # per-target rows carry their own architecture's name when
            # model.per_target overrides it; the joint row keeps the
            # base section's name
            "model_name": result_info.get("individual_model_names", {}).get(
                target_label, params.model_name
            ),
            "model_size": result_info.get("model_size"),
            "subject": params.subject_id,
            "target": target_label,
            "channels": _channels_for(target_label),
            "seeds": str(result_info.get("seeds")),
        }
        for m in metrics:
            if m == "confusion_matrix":
                continue
            values = metric_dict.get(m, [])
            for agg in aggregates:
                agg_func = getattr(np, agg, None)
                if agg_func is None:
                    raise ValueError(
                        f"Aggregate function '{agg}' is not recognized in numpy. "
                        "Please change evaluation.aggregates parameter."
                    )
                row[f"{m}_{agg}"] = float(agg_func(values)) if len(values) else np.nan
            row[f"{m}_all"] = str(list(values))
        return row

    rows = [_build_row(
        {m: result_info[m] for m in metrics if m != "confusion_matrix"},
        joint_label,
    )]
    for target, metrics_dict in result_info.get("individual_metrics", {}).items():
        rows.append(_build_row(metrics_dict, str(target)))

    name = (f"results.process{process_index()}.csv" if process_count() > 1
            else "results.csv")
    result_path = os.path.join(params.log_dir, name)
    _append_rows(result_path, rows)
    print(f"Results saved to {result_path}")

    figure_dir = os.path.join(params.log_dir, f"figures/subject_{params.subject_id}")
    os.makedirs(figure_dir, exist_ok=True)
    cm_dir = os.path.join(
        params.log_dir, f"confusion_matrices/subject_{params.subject_id}"
    )
    os.makedirs(cm_dir, exist_ok=True)

    if confusion_matrix is not None and "confusion_matrix" in metrics:
        _plot(
            confusion_matrix, class_labels,
            os.path.join(figure_dir, "confusion_matrix.png"),
        )
        _write_matrix(os.path.join(cm_dir, "confusion_matrix.csv"), confusion_matrix)

    for target, cm in (result_info.get("individual_confusion_matrix") or {}).items():
        if cm is None:
            continue
        target_class_labels = result_info.get("individual_class_labels", {}).get(
            target, class_labels
        )
        _plot(
            cm, target_class_labels,
            os.path.join(figure_dir, f"confusion_matrix_{target}.png"),
        )
        _write_matrix(os.path.join(cm_dir, f"confusion_matrix_{target}.csv"), cm)


def _csv_cell(value):
    """A cell as pandas' ``to_csv`` writes it: None and NaN empty."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    return value


def _append_rows(path: str, rows: List[dict]) -> None:
    """Append dict rows to a CSV, with the header when the file is new;
    the columns are the rows' keys in order of first appearance."""
    columns: List[str] = []
    for row in rows:
        columns += [k for k in row if k not in columns]
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        if new:
            writer.writerow(columns)
        writer.writerows([[_csv_cell(row.get(c)) for c in columns] for row in rows])


def _write_matrix(path: str, matrix: np.ndarray) -> None:
    """A matrix as CSV with a header of column indices (pandas' layout)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(range(matrix.shape[1]))
        writer.writerows(np.asarray(matrix).tolist())


def _plot(cm: np.ndarray, labels, path: str) -> None:
    """The confusion figure where matplotlib imports; otherwise a note."""
    try:
        plot_confusion_matrix(cm, add_numbers=cm.shape[0] <= 10,
                              label_names=labels, figure_path=path)
    except ImportError as e:
        print(f"no confusion figure ({e}); the CSV is written")
