"""All repeat seeds of one experiment, with the JAX package's API.

Counterpart of ``decode_tonal_langauge_tpu/training/seed_parallel.py``,
which fits every seed inside one ``jit(vmap(...))``. Here
:class:`SeedParallelTrainer` is a loop over the seeds through
:func:`fit_seed`, the per-seed step the training stage runs too: each
seed's result is exactly that of a :class:`ClassifierTrainer` with that
seed. ``seed_chunk`` (the JAX bound on how many seeds one vmapped fit
holds) is met by construction, since one seed is on the device at a
time. Fitting the seeds as one batched computation
(``torch.func.vmap`` over ``functional_call`` and the LSTM's
``autograd.Function``) is not done yet.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from torch import nn

from ..runtime.device import DeviceLike
from .trainer import ClassifierTrainer, accept_jax_only


@dataclass
class SeedFitResult:
    """Per-seed outcome of a fit (what the sequential path extracts from
    one ``ClassifierTrainer``)."""

    seed: int
    history: List[Dict[str, float]]
    best_epoch: int
    stopped_early: bool
    test_true: np.ndarray
    test_preds: np.ndarray
    n_params: int
    # The state dict on the host (BatchNorm running statistics included,
    # which the JAX package keeps apart as batch_stats).
    params: Any = field(repr=False, default=None)
    # (mu, sd) of the per-seed train-split standardisation, when
    # params.standardize is on: checkpointed so inference can reproduce
    # the feature scaling the classifier was trained under.
    scaler: Any = field(repr=False, default=None)


def fit_seed(
    trainer: ClassifierTrainer,
    train_x: np.ndarray,
    train_y: np.ndarray,
    val_x: np.ndarray,
    val_y: np.ndarray,
    test_x: np.ndarray,
    test_y: np.ndarray,
    scaler: Any = None,
    **fit_kwargs,
) -> SeedFitResult:
    """One seed: ``trainer.fit`` (``fit_kwargs`` go to it), the test
    metrics (written where the trainer has a log dir) and the test
    predictions."""
    res = trainer.fit(train_x, train_y, val_x, val_y, **fit_kwargs)
    trainer.test(test_x, test_y)
    return SeedFitResult(
        seed=trainer.seed,
        history=res.history,
        best_epoch=res.best_epoch,
        stopped_early=res.stopped_early,
        test_true=test_y,
        test_preds=trainer.predict(test_x),
        n_params=trainer.n_params(),
        params=trainer.params,
        scaler=scaler,
    )


class SeedParallelTrainer:
    """Fits ``len(seeds)`` independent classifiers of one architecture.

    ``model`` is copied for each seed, and the copy is initialised from
    that seed (``ClassifierTrainer.init``). The keys of
    :data:`~.trainer.JAX_ONLY_KEYS` (``seed_chunk`` among them) are
    accepted and change nothing."""

    def __init__(
        self,
        model: nn.Module,
        n_classes: int,
        seeds: Sequence[int],
        learning_rate: float = 5e-4,
        weight_decay: float = 0.0,
        batch_size: int = 64,
        max_epochs: int = 10,
        patience: int = 5,
        verbose: bool = False,
        moment_dtype: Optional[str] = None,
        device: DeviceLike = None,
        **jax_only,
    ):
        accept_jax_only(jax_only)
        self.model = model
        self.n_classes = n_classes
        self.seeds = [int(s) for s in seeds]
        self._kwargs = dict(
            n_classes=n_classes, learning_rate=learning_rate,
            weight_decay=weight_decay, batch_size=batch_size,
            max_epochs=max_epochs, patience=patience, verbose=verbose,
            moment_dtype=moment_dtype, device=device,
        )

    def fit_eval(
        self,
        train_x: np.ndarray,  # (S, Ntr, ...)
        train_y: np.ndarray,  # (S, Ntr)
        val_x: np.ndarray,
        val_y: np.ndarray,
        test_x: np.ndarray,
        test_y: np.ndarray,
    ) -> List[SeedFitResult]:
        """Fit every seed; returns per-seed results in seed order. All
        arrays carry a leading seed axis (per-seed split gathers)."""
        if train_x.shape[0] != len(self.seeds):
            raise ValueError(f"{train_x.shape[0]} seed slices for {len(self.seeds)} seeds")
        return [fit_seed(ClassifierTrainer(copy.deepcopy(self.model), seed=seed, **self._kwargs),
                         train_x[i], train_y[i], val_x[i], val_y[i], test_x[i], test_y[i])
                for i, seed in enumerate(self.seeds)]
