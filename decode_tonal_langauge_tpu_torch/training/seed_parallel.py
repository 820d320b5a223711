"""All repeat seeds of one experiment as one batched fit.

Counterpart of ``decode_tonal_langauge_tpu/training/seed_parallel.py``,
which fits every seed inside one ``jit(vmap(init_and_fit))``. Here
:class:`SeedParallelTrainer` stacks the seeds' models, NAdam moments and
split data on a leading seed axis (``seed_stack.py``, ``optim.SeedNAdam``)
and runs one forward and one backward a step for all of them:

- seed s starts from the weights ``ClassifierTrainer.init`` gives seed s,
  draws its epoch permutations from its own CPU generator and its dropout
  masks from its own device generator, as :class:`ClassifierTrainer.fit`
  does; a test can feed permutations in (``fit_eval(perms=...)``,
  :meth:`SeedParallelTrainer._epoch`);
- each step's metrics stay on the device; an epoch ends with the
  validation pass of every seed (batched too) and one read, after which
  each seed takes the JAX package's early-stopping rule
  (``trainer.early_stopping_update``). A seed that stops is **dropped**
  from the stacks: its history ends at that epoch and its weights, moments
  and batch-norm statistics stay as they were;
- the test predictions of each seed run through ``ClassifierTrainer.
  predict`` on that seed's final weights: the evaluation stage and serving
  recompute them from the checkpoint that way, and a batched forward could
  flip an argmax near a tie, so the rows would no longer agree.

Per-seed results equal the loop's (``_fit_and_eval`` for each seed) up
to the float32 order of batched sums: a grouped convolution or a batched
matmul sums in another order than one seed's, which can move a max-pool or
leaky-ReLU near a tie to its other side.

``seed_chunk`` bounds how many seeds one batched fit holds: the seeds run
in sequential chunks, each one batched fit. Under a ``data`` mesh of N
ranks the seed axis is padded to a multiple of N (repeating the last
seed), each rank fits its contiguous block of seeds as one batched fit
with no collective per step, and the results are gathered to every rank
(``parallel/mesh.all_gather``); padded seeds are dropped, and rank 0
writes the files.

:func:`fit_seed` is one seed of the loop, which the training stage runs
when ``seed_parallel`` is off or ``train_state_dir`` is set
(``classifier_pipeline._fit_eval_all_seeds``).
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import vmap

from ..models.base import init_params
from ..parallel.mesh import DataParallelLayout, all_gather
from ..runtime.device import DeviceLike, exact_f32, resolve_device
from ..runtime.profiling import span
from ..utils import metrics as M
from .optim import SeedNAdam
from .seed_stack import SeedStack
from .trainer import (
    ES_START,
    HISTORY_KEYS,
    ClassifierTrainer,
    _batch_loss,
    _class_counts,
    _macro_from_counts,
    _stack_batches,
    accept_jax_only,
    early_stopping_update,
    write_confusion_csv,
    write_history,
)


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


@dataclass
class _SeedData:
    x: torch.Tensor  # (S, N_pad, ...) each seed's padded train set
    y: torch.Tensor
    w: torch.Tensor
    vxb: torch.Tensor  # (S, n_batches, B, ...) each seed's validation batches
    vyb: torch.Tensor
    vwb: torch.Tensor
    vtot: torch.Tensor  # (S, n_batches) each validation batch's sum(w)

    def select(self, keep: torch.Tensor) -> "_SeedData":
        return _SeedData(*(getattr(self, f.name)[keep] for f in fields(self)))


def _pad_seeds(seq, n: int):
    """``seq`` (a list or an array over seeds) padded to ``n`` entries by
    repeating its last."""
    extra = n - len(seq)
    if isinstance(seq, np.ndarray):
        return np.concatenate([seq, np.repeat(seq[-1:], extra, axis=0)]) if extra else seq
    return list(seq) + [seq[-1]] * extra


class SeedParallelTrainer:
    """Fits ``len(seeds)`` independent classifiers of one architecture as
    one batched fit (module docstring).

    ``model`` is the prototype: each seed's copy is initialised from that
    seed (``ClassifierTrainer.init``). ``device=None`` means the CUDA card.
    ``mesh`` shards the seed axis over its ``data`` ranks; ``seed_chunk``
    bounds the seeds of one batched fit. The JAX trainer's
    ``scan_unroll`` is accepted and changes nothing."""

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
        mesh=None,
        seed_chunk: Optional[int] = None,
        **jax_only,
    ):
        accept_jax_only(jax_only)
        self.model = model
        self.n_classes = n_classes
        self.seeds = [int(s) for s in seeds]
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.batch_size = batch_size
        self.max_epochs = max_epochs
        self.patience = patience
        self.verbose = verbose
        self.moment_dtype = moment_dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        self._layout = DataParallelLayout(mesh)
        self.seed_chunk = int(seed_chunk) if seed_chunk else None
        self.stack: Optional[SeedStack] = None
        self.optimizer: Optional[SeedNAdam] = None
        self._perm_gens: List[torch.Generator] = []
        self._dropout_gens: List[torch.Generator] = []

    # ------------------------------------------------------------------
    def init(self, seeds: Optional[Sequence[int]] = None) -> None:
        """The seeds' models (``seeds``, default all) stacked on the
        device, each initialised as ``ClassifierTrainer.init`` initialises
        that seed, fresh NAdam moments and each seed's generators."""
        seeds = self.seeds if seeds is None else [int(s) for s in seeds]
        self.stack = SeedStack([init_params(copy.deepcopy(self.model), s) for s in seeds],
                               self.device)
        self.optimizer = SeedNAdam(list(self.stack.params.values()), self.learning_rate,
                                   self.weight_decay, moment_dtype=self.moment_dtype)
        self._perm_gens = [torch.Generator().manual_seed(s) for s in seeds]
        self._dropout_gens = [torch.Generator(device=self.device).manual_seed(s)
                              for s in seeds]

    def _device_data(self, train_x, train_y, val_x, val_y) -> _SeedData:
        """Each seed's train set padded to whole batches (flat: the
        shuffle happens per epoch on the device) and its validation
        batches, stacked on the seed axis and placed on the device once."""
        train = [_stack_batches(x, y, self.batch_size) for x, y in zip(train_x, train_y)]
        val = [_stack_batches(x, y, self.batch_size) for x, y in zip(val_x, val_y)]

        def put(arrays, dtype):
            return torch.as_tensor(np.ascontiguousarray(np.stack(arrays), dtype=dtype),
                                   device=self.device)

        x, y, w = (put([a[i].reshape((-1,) + a[i].shape[2:]) for a in train], dtype)
                   for i, dtype in enumerate((np.float32, np.int64, np.float32)))
        vxb, vyb, vwb = (put([a[i] for a in val], dtype)
                         for i, dtype in enumerate((np.float32, np.int64, np.float32)))
        return _SeedData(x, y, w, vxb, vyb, vwb, vwb.sum(dim=2))

    def train_step(self, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   w_total: torch.Tensor):
        """One NAdam step of every seed on its batch (x (S, B, ...), y and
        w (S, B), w_total (S,)); returns each seed's (loss, macro
        accuracy) as (S,) device tensors."""
        with span("trainer.step"), exact_f32():
            grads, loss, out = self.stack.grad_step((x,), _batch_loss, (y, w, w_total),
                                                    self._dropout_gens)
            with torch.no_grad():
                counts = _class_counts(out.argmax(dim=-1), y, w, self.n_classes)
            self.optimizer.step([grads[k] for k in self.stack.params])
        return loss, _macro_from_counts(*counts)

    @torch.no_grad()
    def _validate(self, data: _SeedData):
        """Each seed's mean per-batch validation loss and macro accuracy."""
        losses, supports, corrects = [], [], []
        with exact_f32():
            for b in range(data.vxb.shape[1]):
                y, w = data.vyb[:, b], data.vwb[:, b]
                out = self.stack.forward(data.vxb[:, b])
                losses.append(vmap(_batch_loss)(out, y, w, data.vtot[:, b]))
                support, correct = _class_counts(out.argmax(dim=-1), y, w, self.n_classes)
                supports.append(support)
                corrects.append(correct)
        macro = _macro_from_counts(torch.stack(supports, 1), torch.stack(corrects, 1))
        return torch.stack(losses, 1).mean(1), macro.mean(1)

    def _epoch(self, perms: torch.Tensor, data: _SeedData) -> torch.Tensor:
        """One epoch of every seed in the stacks, seed s in the order
        ``perms[s]`` (a permutation of its padded train set, on the
        device): the batch steps, then the validation pass. Returns the
        (S, 5) device tensor of (train loss, train accuracy, weight norm,
        val loss, val accuracy), as ``ClassifierTrainer._epoch`` per seed."""
        n_seeds, n = perms.shape
        idx = perms.reshape(n_seeds, n // self.batch_size, self.batch_size)
        rows = torch.arange(n_seeds, device=perms.device)[:, None, None]
        xb, yb, wb = data.x[rows, idx], data.y[rows, idx], data.w[rows, idx]
        totals = wb.sum(dim=2)
        losses, accs = zip(*(self.train_step(xb[:, b], yb[:, b], wb[:, b], totals[:, b])
                             for b in range(idx.shape[1])))
        val_loss, val_acc = self._validate(data)
        with torch.no_grad():
            w_norm = torch.sqrt(sum((p * p).flatten(1).sum(1)
                                    for p in self.stack.params.values()))
        return torch.stack([torch.stack(losses, 1).mean(1), torch.stack(accs, 1).mean(1),
                            w_norm, val_loss, val_acc], dim=1)

    def _select(self, keep: List[int], data: _SeedData) -> _SeedData:
        """Keep the seeds at stack positions ``keep``."""
        idx = torch.as_tensor(keep, device=self.device)
        self.stack.select(idx)
        self.optimizer.select(list(self.stack.params.values()), idx)
        self._perm_gens = [self._perm_gens[k] for k in keep]
        self._dropout_gens = [self._dropout_gens[k] for k in keep]
        return data.select(idx)

    # ------------------------------------------------------------------
    def _fit_block(self, seeds: List[int], arrays, perms=None) -> List[SeedFitResult]:
        """One batched fit of ``seeds`` and their test predictions."""
        train_x, train_y, val_x, val_y, test_x, test_y = arrays
        self.init(seeds)
        data = self._device_data(train_x, train_y, val_x, val_y)
        n = data.x.shape[1]
        live = list(range(len(seeds)))  # block positions of the seeds in the stacks
        es = [ES_START] * len(seeds)
        rows: List[List[Dict[str, float]]] = [[] for _ in seeds]
        states: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(seeds)
        for epoch in range(self.max_epochs):
            if perms is None:
                perm = torch.stack([torch.randperm(n, generator=g) for g in self._perm_gens])
            else:
                perm = torch.as_tensor(np.stack([perms[j][epoch] for j in live]),
                                       dtype=torch.long)
            metrics = self._epoch(perm.to(self.device), data).tolist()  # the epoch's one read
            keep = []
            for k, (j, m) in enumerate(zip(live, metrics)):
                es[j] = early_stopping_update(es[j], m[3], epoch, self.patience)
                rows[j].append({"epoch": epoch, **dict(zip(HISTORY_KEYS, m))})
                if self.verbose:
                    print(f"seed {seeds[j]} epoch {epoch}: train/loss={m[0]:.4f} "
                          f"val/loss={m[3]:.4f} val/acc={m[4]:.4f}")
                if es[j][3]:
                    states[j] = self.stack.state_dict(k)
                else:
                    keep.append(k)
            if len(keep) < len(live):
                live = [live[k] for k in keep]
                if not live:
                    break
                data = self._select(keep, data)
        for k, j in enumerate(live):
            states[j] = self.stack.state_dict(k)

        n_params = self.stack.n_params()
        self.stack = self.optimizer = None  # free the stacks before the next block
        model = copy.deepcopy(self.model)
        predictor = ClassifierTrainer(model, self.n_classes, batch_size=self.batch_size,
                                      device=self.device)
        model.to(predictor.device)
        results = []
        for j, seed in enumerate(seeds):
            model.load_state_dict(states[j])
            results.append(SeedFitResult(
                seed=seed, history=rows[j], best_epoch=int(es[j][1]),
                stopped_early=bool(es[j][3]), test_true=test_y[j],
                test_preds=predictor.predict(test_x[j]), n_params=n_params,
                params=states[j]))
        return results

    def _gather(self, local: List[SeedFitResult], seeds: List[int],
                test_y: np.ndarray) -> List[SeedFitResult]:
        """Every rank's block of results, in seed order, on every rank."""
        n_cols = len(HISTORY_KEYS) + 1  # the metrics and an "executed" flag
        hist = torch.full((len(local), self.max_epochs, n_cols), float("nan"),
                          dtype=torch.float64)
        for i, r in enumerate(local):
            for row in r.history:
                hist[i, row["epoch"]] = torch.tensor([row[k] for k in HISTORY_KEYS] + [1.0])
        es = torch.tensor([[r.best_epoch, r.stopped_early] for r in local], dtype=torch.float64)
        preds = torch.as_tensor(np.stack([r.test_preds for r in local]))
        states = {k: torch.stack([r.params[k] for r in local]) for k in local[0].params}

        def gather(t: torch.Tensor) -> torch.Tensor:
            return all_gather(self.mesh, t.to(self.device)).cpu()

        hist, es, preds = gather(hist), gather(es), gather(preds).numpy()
        states = {k: gather(v) for k, v in states.items()}
        return [SeedFitResult(
            seed=seed,
            history=[{"epoch": e, **dict(zip(HISTORY_KEYS, row[:-1]))}
                     for e, row in enumerate(hist[i].tolist()) if row[-1] == 1.0],
            best_epoch=int(es[i, 0]), stopped_early=bool(es[i, 1]), test_true=test_y[i],
            test_preds=preds[i], n_params=local[0].n_params,
            params={k: v[i].clone() for k, v in states.items()},
        ) for i, seed in enumerate(seeds)]

    def _fit_sharded(self, seeds: List[int], arrays, perms=None) -> List[SeedFitResult]:
        """``seeds`` as one batched fit, or under a mesh one block a rank."""
        if self.mesh is None:
            return self._fit_block(seeds, arrays, perms)
        dp, rank = self._layout.dp, self._layout.rank
        per = -(-len(seeds) // dp)
        padded = _pad_seeds(seeds, per * dp)
        arrays = [_pad_seeds(a, per * dp) for a in arrays]
        perms = None if perms is None else _pad_seeds(perms, per * dp)
        mine = slice(rank * per, (rank + 1) * per)
        local = self._fit_block(padded[mine], [a[mine] for a in arrays],
                                None if perms is None else perms[mine])
        return self._gather(local, padded, arrays[5])[:len(seeds)]

    def fit_eval(
        self,
        train_x: np.ndarray,  # (S, Ntr, ...)
        train_y: np.ndarray,  # (S, Ntr)
        val_x: np.ndarray,
        val_y: np.ndarray,
        test_x: np.ndarray,
        test_y: np.ndarray,
        perms: Optional[Sequence[Sequence[np.ndarray]]] = None,
    ) -> List[SeedFitResult]:
        """Fit every seed; returns per-seed results in seed order. All
        arrays carry a leading seed axis (per-seed split gathers, equal in
        size). ``perms[s][e]``, when given, is seed s's permutation of its
        padded train set in epoch e, in place of its generator's."""
        n = len(self.seeds)
        if train_x.shape[0] != n:
            raise ValueError(f"{train_x.shape[0]} seed slices for {n} seeds")
        arrays = (train_x, train_y, val_x, val_y, test_x, test_y)
        chunk = self.seed_chunk or n
        out: List[SeedFitResult] = []
        for i in range(0, n, chunk):
            part = slice(i, i + chunk)
            out += self._fit_sharded(self.seeds[part], [a[part] for a in arrays],
                                     None if perms is None else perms[part])
        return out

    def write_logs(self, result: SeedFitResult, log_dir: Optional[str]) -> None:
        """The seed's ``metrics.csv`` and ``confusion_matrix_test.csv``, as
        the loop's trainer writes them (rank 0 under a mesh)."""
        if not log_dir or not self._layout.writer:
            return
        write_history(log_dir, result.history)
        write_confusion_csv(
            os.path.join(log_dir, "confusion_matrix_test.csv"),
            M.confusion_matrix(result.test_true, result.test_preds,
                               labels=np.arange(self.n_classes)))
