"""Classification metrics in numpy, with sklearn's definitions.

Counterpart of ``decode_tonal_langauge_tpu/utils/metrics.py``, which
calls ``sklearn.metrics``. The named metrics are computed here from the
confusion matrix over the labels present in ``true`` or ``preds`` (as
sklearn orders them): accuracy, weighted F1 / precision / recall (a class
with no predicted or no true sample scores 0, sklearn's zero-division
rule), Cohen's kappa and the confusion matrix; ``balanced_accuracy`` and
``macro_f1`` serve the trainer's test metrics. Any other name falls back
to the ``sklearn.metrics`` function of that name, and only that branch
imports sklearn. Joint metrics over several targets combine the labels
with a mixed-radix code, first target major.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def confusion_matrix(true, preds, labels: Optional[Sequence[int]] = None) -> np.ndarray:
    """Counts ``C[i, j]`` of samples of class ``labels[i]`` predicted as
    ``labels[j]``; ``labels`` defaults to the sorted union of both."""
    true, preds = np.asarray(true), np.asarray(preds)
    labels = np.union1d(true, preds) if labels is None else np.asarray(labels)
    n = len(labels)
    ti = np.searchsorted(labels, true)
    pi = np.searchsorted(labels, preds)
    ok = (ti < n) & (pi < n)
    ok[ok] &= (labels[ti[ok]] == true[ok]) & (labels[pi[ok]] == preds[ok])
    cm = np.zeros((n, n), dtype=np.int64)
    np.add.at(cm, (ti[ok], pi[ok]), 1)
    return cm


def _per_class(true, preds):
    """(tp, predicted, support) per label of the union."""
    cm = confusion_matrix(true, preds)
    return np.diag(cm).astype(float), cm.sum(axis=0).astype(float), cm.sum(axis=1).astype(float)


def _ratio(num, den):
    return np.divide(num, den, out=np.zeros_like(num), where=den > 0)


def _weighted(score, support) -> float:
    return float(np.average(score, weights=support)) if support.sum() > 0 else 0.0


def accuracy(true, preds) -> float:
    return float(np.mean(np.asarray(true) == np.asarray(preds)))


def f1_weighted(true, preds) -> float:
    tp, pred, support = _per_class(true, preds)
    return _weighted(_ratio(2 * tp, pred + support), support)


def precision_weighted(true, preds) -> float:
    tp, pred, support = _per_class(true, preds)
    return _weighted(_ratio(tp, pred), support)


def recall_weighted(true, preds) -> float:
    tp, _, support = _per_class(true, preds)
    return _weighted(_ratio(tp, support), support)


def macro_f1(true, preds) -> float:
    tp, pred, support = _per_class(true, preds)
    return float(np.mean(_ratio(2 * tp, pred + support)))


def balanced_accuracy(true, preds) -> float:
    """Mean recall over the classes present in ``true``."""
    tp, _, support = _per_class(true, preds)
    return float(np.mean(tp[support > 0] / support[support > 0]))


def cohen_kappa(true, preds) -> float:
    cm = confusion_matrix(true, preds).astype(float)
    expected = np.outer(cm.sum(axis=1), cm.sum(axis=0)) / cm.sum()
    off = 1.0 - np.eye(len(cm))
    return float(1.0 - (off * cm).sum() / (off * expected).sum())


_NAMED = {
    "accuracy": accuracy,
    "f1_score": f1_weighted,
    "precision": precision_weighted,
    "recall": recall_weighted,
    "cohen_kappa": cohen_kappa,
    "confusion_matrix": confusion_matrix,
}


def compute_classification_metrics(
    true: np.ndarray,
    preds: np.ndarray,
    metrics: Sequence[str] = ("accuracy",),
    verbose: bool = False,
) -> dict:
    """Compute the named metrics for one classification task."""
    if verbose:
        print("Unique labels in true: {}".format(set(np.asarray(true).tolist())))
        print("Unique predictions in preds: {}".format(set(np.asarray(preds).tolist())))
    results = {}
    for m in metrics:
        if m in _NAMED:
            results[m] = _NAMED[m](true, preds)
            continue
        from sklearn import metrics as skmetrics

        metric_func = getattr(skmetrics, m, None)
        if metric_func is None:
            raise ValueError(
                f"'{m}' is neither a built-in metric "
                f"not part of the supported metrics: {list(_NAMED)}."
            )
        if "average" in metric_func.__code__.co_varnames:
            results[m] = metric_func(true, preds, average="weighted")
        else:
            results[m] = metric_func(true, preds)
    return results


def compute_classification_metrics_joint(
    all_true: Dict[str, np.ndarray],
    all_preds: Dict[str, np.ndarray],
    metrics: Sequence[str] = ("accuracy",),
    verbose: bool = False,
) -> dict:
    """Joint metrics over multiple targets via the mixed-radix combine
    ``joint = sum_i label_i * prod(n_classes[i+1:])``, where each target's
    class count is the number of distinct true labels."""
    if set(all_true.keys()) != set(all_preds.keys()):
        raise ValueError("all_true and all_preds must cover the same targets.")

    targets = list(all_true.keys())
    all_true = {t: np.asarray(all_true[t]).astype(int) for t in targets}
    all_preds = {t: np.asarray(all_preds[t]).astype(int) for t in targets}

    if verbose:
        for target in targets:
            print(f"Unique labels in {target}: {set(all_true[target].tolist())}")
            print(f"Unique predictions in {target}: {set(all_preds[target].tolist())}")

    n_classes = [len(np.unique(all_true[t])) for t in targets]
    multipliers = [int(np.prod(n_classes[i + 1:])) for i in range(len(n_classes))]
    joint_true = sum(all_true[t] * m for t, m in zip(targets, multipliers))
    joint_preds = sum(all_preds[t] * m for t, m in zip(targets, multipliers))
    return compute_classification_metrics(joint_true, joint_preds, metrics)
