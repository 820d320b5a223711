"""Classifier trainer with early stopping and scalar logging.

Counterpart of ``decode_tonal_langauge_tpu/training/trainer.py``: softmax
cross-entropy over the model's outputs (the deep classifiers' sigmoid
probabilities, taken as logits, as the JAX trainer takes them), NAdam
with decay groups (``optim.py``), train/val loss, macro accuracy and
weight norm per epoch, early stopping on the validation loss, test-time
metrics and argmax prediction.

Structure on the device:

- the train set is padded to whole batches (padding samples weigh 0 and
  stay in the shuffle) and placed on the device once, the validation set
  likewise as stacked batches;
- each epoch's permutation is drawn from a CPU ``torch.Generator`` seeded
  from ``seed`` and copied to the device, so the card and the CPU see the
  same batch order; dropout draws from a generator on the device, also
  seeded from ``seed`` (``ops/dropout.py``);
- the epoch's metrics stay device tensors and are read once per epoch,
  for early stopping;
- the epoch routine (:meth:`ClassifierTrainer._epoch`) takes the
  permutation as an argument.

The JAX trainer draws its permutations and dropout keys from one
``jax.random`` key chain and initialises Flax weights from
``jax.random.key(seed)``; torch cannot reproduce either stream, so the two
packages agree step for step only given the same weights and batch order
(the tests feed both).

With a ``mesh`` (``parallel/mesh.py``) the fit is data-parallel over its
``data`` axis, one rank per card: the batch rounds up to a multiple of
the axis, every rank holds the whole padded train set and draws the same
permutation, and each takes its contiguous slice of every batch. A step
computes its slice's ``sum(w * ce)`` over the global batch's ``sum(w)``
(known on the host, so no collective is needed for it), then one
all-reduce (SUM) adds the gradients, the loss and the class counts of the
macro accuracy (``DataParallelLayout.reduce_sum``); the validation pass
reduces its sums and gathers its predictions alike, so every rank takes
the same early-stopping branch. Dropout draws the global batch's masks
(``ops/dropout.py``), so a data-parallel fit follows the one-device fit.
Rank 0 writes the history, the train state and the confusion matrix; the
others wait at a barrier.
"""

from __future__ import annotations

import csv
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.base import init_params
from ..ops.dropout import set_dropout_generator
from ..parallel.mesh import DataParallelLayout
from ..runtime.device import DeviceLike, exact_f32, resolve_device
from ..utils import metrics as M
from .optim import NAdam

HISTORY_KEYS = ("train/loss", "train/accuracy", "train/weight_norm",
                "val/loss", "val/accuracy")


def _stack_batches(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Pad to a multiple of batch_size and reshape to (n_batches, B, ...).

    Returns (xb, yb, wb) where ``wb`` masks out padding samples.
    """
    n = x.shape[0]
    n_batches = max(1, -(-n // batch_size))
    pad = n_batches * batch_size - n
    w = np.ones(n, dtype=np.float32)
    if pad:
        x = np.concatenate([x, np.repeat(x[:1], pad, axis=0)], axis=0)
        y = np.concatenate([y, np.repeat(y[:1], pad, axis=0)], axis=0)
        w = np.concatenate([w, np.zeros(pad, dtype=np.float32)])
    xb = x.reshape((n_batches, batch_size) + x.shape[1:])
    yb = y.reshape((n_batches, batch_size))
    wb = w.reshape((n_batches, batch_size))
    return xb, yb, wb


def _class_counts(preds: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                  n_classes: int):
    """(support, correct): the weighted count of each class in the batch
    and of its correct predictions."""
    onehot = F.one_hot(y, n_classes).to(w.dtype) * w[:, None]
    support = onehot.sum(dim=0)
    correct = (onehot * (preds == y).to(w.dtype)[:, None]).sum(dim=0)
    return support, correct


def _macro_from_counts(support: torch.Tensor, correct: torch.Tensor) -> torch.Tensor:
    """Macro-averaged per-class accuracy over the classes present (over
    the last axis, so stacked batches give one value each)."""
    per_class = torch.where(support > 0, correct / support.clamp_min(1.0),
                            torch.zeros_like(support))
    n_present = (support > 0).sum(dim=-1).clamp_min(1)
    return per_class.sum(dim=-1) / n_present


def _macro_accuracy(preds: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    n_classes: int) -> torch.Tensor:
    """Macro-averaged per-class accuracy over the classes present in the
    (weighted) batch."""
    return _macro_from_counts(*_class_counts(preds, y, w, n_classes))


def _batch_loss(out: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                w_total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sum(w * ce) / max(w_total, 1)``; ``w_total`` is the global
    batch's ``sum(w)`` when ``out`` is one rank's slice (default: this
    batch's)."""
    ce = F.cross_entropy(out, y, reduction="none")
    total = w.sum() if w_total is None else w_total
    return (ce * w).sum() / total.clamp_min(1.0)


EarlyStop = Tuple[float, int, int, bool]  # best_val, best_epoch, bad, stopped
ES_START: EarlyStop = (math.inf, -1, 0, False)


def early_stopping_update(es: EarlyStop, val_loss: float, epoch: int,
                          patience: int) -> EarlyStop:
    """One epoch of the JAX trainer's bookkeeping: an epoch improves when
    its validation loss is below the best so far; ``bad`` counts epochs
    since the last improvement, and training stops once ``bad >
    patience``."""
    best_val, best_epoch, bad, stopped = es
    if stopped:
        return es
    if val_loss < best_val:
        best_val, best_epoch, bad = val_loss, epoch, 0
    else:
        bad += 1
    return best_val, best_epoch, bad, bad > patience


@dataclass
class FitResult:
    history: List[Dict[str, float]]
    best_epoch: int
    stopped_early: bool


@dataclass
class _DeviceData:
    x: torch.Tensor  # (N_pad, ...) padded train set, whole on every rank
    y: torch.Tensor
    w: torch.Tensor
    vxb: torch.Tensor  # (n_batches, B / dp, ...) this rank's validation rows
    vyb: torch.Tensor
    vwb: torch.Tensor
    vtot: torch.Tensor  # (n_batches,) each global validation batch's sum(w)


def write_history(log_dir: str, history: List[Dict[str, float]]) -> None:
    """``metrics.csv`` (one row per executed epoch) and, where
    ``tensorboardX`` imports, its scalars."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "metrics.csv"), "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        if history:
            writer.writerow(list(history[0]))
            writer.writerows([list(row.values()) for row in history])
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return
    writer = SummaryWriter(log_dir)
    for row in history:
        for key, value in row.items():
            if key != "epoch":
                writer.add_scalar(key, value, row["epoch"])
    writer.close()


def write_confusion_csv(path: str, cm: np.ndarray) -> None:
    """The matrix as CSV rows without header or index."""
    with open(path, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(np.asarray(cm).tolist())


# Keys of the JAX trainers' constructors that change nothing here:
# ``scan_unroll`` unrolls the JAX batch scan, a compiler knob whose
# histories are identical by design (batches run in a Python loop here);
# ``seed_chunk`` bounds the seeds of one vmapped fit (seeds run one at a
# time here).
JAX_ONLY_KEYS = frozenset({"scan_unroll", "seed_chunk"})


def accept_jax_only(keys: Dict[str, Any]) -> None:
    """Refuse any key but :data:`JAX_ONLY_KEYS`."""
    unknown = sorted(set(keys) - JAX_ONLY_KEYS)
    if unknown:
        raise TypeError(f"unexpected keyword arguments {unknown}")


class ClassifierTrainer:
    """Trains a port classifier on a device-resident dataset.

    ``device=None`` means the CUDA card (it raises without one); the CPU
    runs only when asked for (``device="cpu"``). ``mesh`` makes the fit
    data-parallel (module docstring); ``batch_size`` then rounds up to a
    multiple of its ``data`` axis, as in JAX. The JAX trainer's
    ``scan_unroll`` is accepted and changes nothing (:data:`JAX_ONLY_KEYS`).
    """

    def __init__(
        self,
        model: nn.Module,
        n_classes: int,
        learning_rate: float = 5e-4,
        weight_decay: float = 0.0,
        batch_size: int = 64,
        max_epochs: int = 10,
        patience: int = 5,
        seed: int = 0,
        log_dir: Optional[str] = None,
        verbose: bool = False,
        moment_dtype: Optional[str] = None,
        device: DeviceLike = None,
        mesh=None,
        **jax_only,
    ):
        accept_jax_only(jax_only)
        self.device = resolve_device(device)
        self.model = model
        self.n_classes = n_classes
        self.mesh = mesh
        self._layout = DataParallelLayout(mesh)
        self.batch_size = self._layout.round_batch(batch_size)
        self.max_epochs = max_epochs
        self.patience = patience
        self.seed = seed
        self.log_dir = log_dir
        self.verbose = verbose
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay
        self._moment_dtype = moment_dtype
        self.optimizer = None
        self._weights: List[torch.Tensor] = []
        self._perm_gen: Optional[torch.Generator] = None
        self._dropout_gen: Optional[torch.Generator] = None

    # ------------------------------------------------------------------
    def init(self, sample_x: Optional[np.ndarray] = None) -> None:
        """Seeded weights (``models.base.init_params``), the model on the
        device, fresh optimizer moments and generators. ``sample_x`` is
        accepted for the JAX trainer's signature: a port module knows its
        shapes from its constructor."""
        init_params(self.model, self.seed)
        self.model.to(self.device)
        self._weights = list(self.model.parameters())
        self.optimizer = NAdam(self._weights, self._learning_rate, self._weight_decay,
                               moment_dtype=self._moment_dtype)
        self._reset_generators()

    def _reset_generators(self) -> None:
        self._perm_gen = torch.Generator().manual_seed(self.seed)
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(self.seed)
        set_dropout_generator(self.model, self._dropout_gen)
        self._layout.attach(self.model)

    @property
    def params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The model's state dict on the host, or None before :meth:`init`."""
        if self.optimizer is None:
            return None
        return {k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()}

    @params.setter
    def params(self, state: Dict[str, torch.Tensor]) -> None:
        self.model.load_state_dict(state)

    def n_params(self) -> int:
        return int(sum(p.numel() for p in self.model.parameters()))

    # ------------------------------------------------------------------
    def _tensors(self, x, y, w=None):
        x = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=self.device)
        y = torch.as_tensor(np.asarray(y, dtype=np.int64), device=self.device)
        if w is None:
            return x, y
        return x, y, torch.as_tensor(np.asarray(w, dtype=np.float32), device=self.device)

    def _local_stacks(self, xb, yb, wb):
        """(n_batches, B, ...) host stacks -> this rank's rows on the
        device, and each global batch's ``sum(w)``."""
        totals = torch.as_tensor(np.asarray(wb, np.float32).sum(axis=1), device=self.device)
        return (*self._tensors(*self._layout.place_stacks(xb, yb, wb)), totals)

    def _device_data(self, train_x, train_y, val_x, val_y) -> _DeviceData:
        """Both sets padded to whole batches and placed on the device once;
        the train set flat (the shuffle happens per epoch on the device),
        the validation set as this rank's rows of each batch."""
        xb, yb, wb = _stack_batches(train_x, train_y, self.batch_size)
        x, y, w = self._tensors(
            xb.reshape((-1,) + xb.shape[2:]), yb.reshape(-1), wb.reshape(-1))
        return _DeviceData(x, y, w, *self._local_stacks(
            *_stack_batches(val_x, val_y, self.batch_size)))

    def train_step(self, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   w_total: Optional[torch.Tensor] = None):
        """One NAdam step on a weighted batch (this rank's rows of it under
        a mesh, with the global batch's ``sum(w)`` as ``w_total``) on the
        device; returns the global batch's (loss, macro accuracy)
        tensors."""
        self.model.train()
        with exact_f32():
            out = self.model(x)
            loss = _batch_loss(out, y, w, w_total)
            grads = torch.autograd.grad(loss, self._weights)
            with torch.no_grad():
                counts = _class_counts(out.argmax(dim=-1), y, w, self.n_classes)
            *grads, loss, support, correct = self._layout.reduce_sum(
                [*grads, loss.detach(), *counts])
            self.optimizer.step(grads)
        return loss, _macro_from_counts(support, correct)

    @torch.no_grad()
    def _eval_batches(self, xb, yb, wb, totals):
        """Mean per-batch loss and macro accuracy, and the predictions of
        every rank's rows in batch order."""
        self.model.eval()
        losses, supports, corrects, preds = [], [], [], []
        with exact_f32():
            for x, y, w, total in zip(xb, yb, wb, totals):
                out = self.model(x)
                pred = out.argmax(dim=-1)
                losses.append(_batch_loss(out, y, w, total))
                support, correct = _class_counts(pred, y, w, self.n_classes)
                supports.append(support)
                corrects.append(correct)
                preds.append(pred)
        losses, supports, corrects = self._layout.reduce_sum(
            [torch.stack(losses), torch.stack(supports), torch.stack(corrects)])
        # (n_batches, B / dp) per rank -> (n_batches, B) -> flat
        preds = self._layout.gather(torch.stack(preds).T.contiguous()).T.reshape(-1)
        return losses.mean(), _macro_from_counts(supports, corrects).mean(), preds

    def _epoch(self, perm: torch.Tensor, data: _DeviceData) -> torch.Tensor:
        """One epoch in the order ``perm`` (a permutation of the padded
        train set, on the device): the batch steps, then the validation
        pass. Returns the device tensor (train loss, train accuracy,
        weight norm, val loss, val accuracy); the losses and accuracies
        are means of per-batch means."""
        n_batches = data.x.shape[0] // self.batch_size
        idx = perm.reshape(n_batches, self.batch_size)
        totals = data.w[idx].sum(dim=1)
        (idx,) = self._layout.place_stacks(idx)
        xb, yb, wb = data.x[idx], data.y[idx], data.w[idx]
        losses, accs = zip(*(self.train_step(xb[b], yb[b], wb[b], totals[b])
                             for b in range(n_batches)))
        val_loss, val_acc, _ = self._eval_batches(data.vxb, data.vyb, data.vwb, data.vtot)
        with torch.no_grad():
            w_norm = torch.sqrt(sum((p * p).sum() for p in self._weights))
        return torch.stack([torch.stack(losses).mean(), torch.stack(accs).mean(),
                            w_norm, val_loss, val_acc])

    # ------------------------------------------------------------------
    def _save_train_state(self, path, es: EarlyStop, epochs_done: int,
                          history: np.ndarray) -> None:
        from ..runtime.checkpoint import save_train_state

        save_train_state(path, {
            "params": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "perm_rng": self._perm_gen.get_state(),
            "dropout_rng": self._dropout_gen.get_state(),
            "es": {"best_val": float(es[0]), "best_epoch": int(es[1]),
                   "bad": int(es[2]), "stopped": bool(es[3])},
            "epochs_done": int(epochs_done),
            "history": torch.from_numpy(np.asarray(history, np.float32)),
        })

    def _restore_train_state(self, path):
        """Returns (es, epochs_done, history) and restores the weights,
        optimizer and generators, or None when no state exists at
        ``path``. Call after :meth:`init`."""
        from ..runtime.checkpoint import load_train_state, train_state_exists

        if not train_state_exists(path):
            return None
        state = load_train_state(path)
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])
        self._perm_gen.set_state(state["perm_rng"])
        self._dropout_gen.set_state(state["dropout_rng"])
        e = state["es"]
        es = (float(e["best_val"]), int(e["best_epoch"]), int(e["bad"]), bool(e["stopped"]))
        history = state["history"].numpy().reshape(-1, len(HISTORY_KEYS) + 1)
        return es, int(state["epochs_done"]), history

    def fit(
        self,
        train_x: np.ndarray,
        train_y: np.ndarray,
        val_x: np.ndarray,
        val_y: np.ndarray,
        checkpoint_dir: Optional[str] = None,
        resume: bool = False,
        checkpoint_every: Optional[int] = None,
    ) -> FitResult:
        """Fit with early stopping.

        ``checkpoint_dir``: save the full train state there (after every
        ``checkpoint_every`` epochs; default: once at the end). With
        ``resume=True`` an existing state at that path continues exactly
        where it left off (``max_epochs`` counts the total epochs across
        the original fit and the resume). As in the JAX trainer, epochs
        after an early stop within a segment are recorded as not executed,
        and the final weights are the last trained epoch's, not the best.
        """
        if self.optimizer is None:
            self.init(train_x)
        self._reset_generators()
        es, epochs_done = ES_START, 0
        history_arr = np.zeros((0, len(HISTORY_KEYS) + 1), dtype=np.float32)
        if checkpoint_dir and resume:
            restored = self._restore_train_state(checkpoint_dir)
            if restored is not None:
                es, epochs_done, history_arr = restored
        self._layout.replicate_tree(self.model)

        data = self._device_data(train_x, train_y, val_x, val_y)
        n = data.x.shape[0]
        seg_size = (int(checkpoint_every) if (checkpoint_dir and checkpoint_every)
                    else self.max_epochs)
        while epochs_done < self.max_epochs and not es[3]:
            seg = min(seg_size, self.max_epochs - epochs_done)
            rows = []
            for epoch in range(epochs_done, epochs_done + seg):
                if es[3]:  # stopped earlier in this segment
                    rows.append([math.nan] * len(HISTORY_KEYS) + [0.0])
                    continue
                perm = torch.randperm(n, generator=self._perm_gen).to(self.device)
                metrics = self._epoch(perm, data).tolist()  # the epoch's one read
                es = early_stopping_update(es, metrics[3], epoch, self.patience)
                rows.append(metrics + [1.0])
            history_arr = np.concatenate([history_arr, np.asarray(rows, np.float32)])
            epochs_done += seg
            if checkpoint_dir and self._layout.writer:
                self._save_train_state(checkpoint_dir, es, epochs_done, history_arr)
            self._layout.barrier("fit:train_state")

        history: List[Dict[str, float]] = []
        for epoch, row in enumerate(history_arr):
            if not row[-1]:
                break  # epochs after the stop
            history.append({"epoch": epoch,
                            **{k: float(v) for k, v in zip(HISTORY_KEYS, row)}})
            if self.verbose:
                h = history[-1]
                print(f"epoch {epoch}: train/loss={h['train/loss']:.4f} "
                      f"val/loss={h['val/loss']:.4f} val/acc={h['val/accuracy']:.4f}")
        if self.log_dir and self._layout.writer:
            write_history(self.log_dir, history)
        return FitResult(history, int(es[1]), bool(es[3]))

    # ------------------------------------------------------------------
    def predict(self, x: np.ndarray) -> np.ndarray:
        """Argmax class predictions."""
        stacks = _stack_batches(x, np.zeros(x.shape[0], dtype=np.int64), self.batch_size)
        _, _, preds = self._eval_batches(*self._local_stacks(*stacks))
        return preds.cpu().numpy()[: x.shape[0]]

    def test(self, x: np.ndarray, y: np.ndarray,
             log_confusion: bool = True) -> Dict[str, Any]:
        """Test metrics: balanced accuracy, macro F1 and the confusion
        matrix over all classes (numpy, ``utils/metrics.py``)."""
        preds = self.predict(x)
        out = {
            "accuracy_macro": M.balanced_accuracy(y, preds),
            "f1_macro": M.macro_f1(y, preds),
            "confusion_matrix": M.confusion_matrix(y, preds, labels=np.arange(self.n_classes)),
        }
        if self.log_dir and log_confusion and self._layout.writer:
            os.makedirs(self.log_dir, exist_ok=True)
            write_confusion_csv(os.path.join(self.log_dir, "confusion_matrix_test.csv"),
                                out["confusion_matrix"])
        return out
