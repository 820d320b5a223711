"""A trainer for sequence decoders under CTC: the GRU-CTC phoneme decoder
(``models/sequence.GRUDecoder``) on padded variable-length sentences, as
``neural_seq_decoder``'s ``scripts/train_model.py`` trains it.

A trial is a sentence: binned features (T_b, C) of its own length, its
phoneme ids (1..n_classes; 0 is the CTC blank) and the recording day
whose input layer it takes. The set is padded to whole batches (padding
rows weigh 0, ``trainer.padded_rows``) and placed on the device once,
every sentence zero-padded to the longest; each batch is cut to its own
longest sentence (``batch``). A step:

1. adds the augmentation to the batch, white noise of sd
   ``white_noise_sd`` on every bin and feature and a constant offset of sd
   ``constant_offset_sd`` per trial and feature (padding included, as the
   source adds them to the padded batch);
2. runs the model in train mode (dropout between the GRU layers);
3. takes the CTC loss of each trial over its first
   ``(T_b - kernel_len) // stride_len`` frames (the source's rule,
   ``model.output_lengths``) divided by its phoneme count, and their
   weighted mean over the batch (``training/ctc.py``);
4. steps ``Adam`` with L2 (``training/optim.py``).

Every step runs under ``runtime.device.exact_f32``.

Generators (``trainer.seeded_generators``, both seeded with ``seed``):
each epoch's permutation is drawn on the host by ``torch.randperm``; the
device generator draws, in each step and in this order, the white noise
(B, T_b, C), the offset (B, 1, C), then each between-layer dropout's
keep-mask (B, L, D H) in layer order (``ops/dropout.py``). The weights
are the source's initialisation (``GRUDecoder.reset_parameters``) from a
host generator seeded with ``seed``. The train state (weights, Adam's
moments, both generators, epochs and history) saves and restores with
``trainer.save_state`` / ``restore_state``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..runtime.device import DeviceLike, exact_f32, resolve_device
from ..runtime.profiling import span
from .ctc import ctc_loss, edit_distance, greedy_decode
from .optim import Adam
from .trainer import padded_rows, restore_state, save_state, seeded_generators

HISTORY_KEYS = ("train/loss", "val/loss", "val/per")


@dataclass
class SequenceSet:
    """A padded, device-resident set of sentences: features, day and
    phoneme ids on the device; the lengths (which decide shapes and the
    CTC's lengths) on the host."""

    x: torch.Tensor  # (N_pad, T_max, C)
    targets: torch.Tensor  # (N_pad, S_max) long, 0 past each target length
    day: torch.Tensor  # (N_pad,) long
    w: torch.Tensor  # (N_pad,) 1 for a sentence, 0 for padding
    lengths: torch.Tensor  # (N_pad,) long, host
    target_lengths: torch.Tensor  # (N_pad,) long, host

    def __len__(self) -> int:
        return int(self.lengths.shape[0])


class SequenceTrainer:
    """Trains a sequence decoder with CTC (module docstring) on one device
    (``None``: the CUDA card; the CPU only when asked for)."""

    def __init__(self, model: nn.Module, learning_rate: float = 0.02,
                 weight_decay: float = 1e-5, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 0.1, batch_size: int = 64, white_noise_sd: float = 0.8,
                 constant_offset_sd: float = 0.2, max_epochs: int = 10, seed: int = 0,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.model = model
        self.batch_size = batch_size
        self.white_noise_sd, self.constant_offset_sd = white_noise_sd, constant_offset_sd
        self.max_epochs, self.seed = max_epochs, seed
        self._adam = {"learning_rate": learning_rate, "weight_decay": weight_decay,
                      "b1": b1, "b2": b2, "eps": eps}
        self.optimizer: Optional[Adam] = None
        self._weights: List[torch.Tensor] = []
        self._perm_gen: Optional[torch.Generator] = None
        self._dev_gen: Optional[torch.Generator] = None

    # ------------------------------------------------------------------
    def init(self) -> None:
        """The source's initial weights from ``seed``, the model on the
        device, fresh Adam moments and generators."""
        self.model.reset_parameters(torch.Generator().manual_seed(self.seed))
        self.model.to(self.device)
        self._weights = list(self.model.parameters())
        self.optimizer = Adam(self._weights, **self._adam)
        self._reset_generators()

    def _reset_generators(self) -> None:
        self._perm_gen, self._dev_gen = seeded_generators(self.seed, self.device, self.model)

    def n_params(self) -> int:
        return int(sum(p.numel() for p in self.model.parameters()))

    # ------------------------------------------------------------------
    def device_data(self, x, lengths, targets, target_lengths, day) -> SequenceSet:
        """A set padded to whole batches and placed on the device once:
        ``x`` (N, T_max, C) zero past each length (numpy or a tensor),
        ``lengths`` (N,), ``targets`` (N, S_max), ``target_lengths`` (N,),
        ``day`` (N,)."""
        n = len(lengths)
        rows, w = padded_rows(n, self.batch_size)
        idx = torch.as_tensor(rows, device=self.device)

        def put(a, dtype):
            a = torch.as_tensor(a, dtype=dtype, device=self.device)
            return a if len(rows) == n else a[idx]

        host = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long)[rows]  # noqa: E731
        return SequenceSet(put(x, torch.float32), put(targets, torch.long), put(day, torch.long),
                           torch.as_tensor(w, device=self.device), host(lengths),
                           host(target_lengths))

    def epoch_order(self, data: SequenceSet) -> torch.Tensor:
        """The next epoch's permutation of ``data``'s padded rows (host)."""
        return torch.randperm(len(data), generator=self._perm_gen)

    def batch(self, data: SequenceSet, rows: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """:meth:`train_step`'s arguments for ``rows`` (host indices) of
        ``data``: the batch cut to its longest sentence."""
        lengths = data.lengths[rows]
        idx = rows.to(self.device, non_blocking=True)
        x = data.x[idx, :int(lengths.max())]
        w = data.w[idx]
        return (x, lengths, data.targets[idx], data.target_lengths[rows], data.day[idx], w,
                w.sum())

    def augment(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` plus the white noise and the constant offset, drawn from
        the device generator in that order."""
        g = self._dev_gen
        if self.white_noise_sd > 0:
            x = x + torch.randn(x.shape, generator=g, device=x.device) * self.white_noise_sd
        if self.constant_offset_sd > 0:
            offset = torch.randn((x.shape[0], 1, x.shape[2]), generator=g, device=x.device)
            x = x + offset * self.constant_offset_sd
        return x

    def _loss(self, x, lengths, targets, target_lengths, day, w, total):
        """(the batch's weighted mean CTC loss, the logits, the CTC's input
        lengths)."""
        logits = self.model(x, day)
        input_lengths = self.model.output_lengths(lengths).tolist()
        per = ctc_loss(logits, targets, input_lengths, target_lengths.tolist())
        return (per * w).sum() / total.clamp_min(1.0), logits, input_lengths

    def train_step(self, x: torch.Tensor, lengths: torch.Tensor, targets: torch.Tensor,
                   target_lengths: torch.Tensor, day: torch.Tensor, w: torch.Tensor,
                   total: torch.Tensor) -> torch.Tensor:
        """One Adam step on a batch (:meth:`batch`'s arguments; ``lengths``
        and ``target_lengths`` on the host, ``total`` the batch's
        ``sum(w)``); returns the loss, a device tensor."""
        self.model.train()
        with span("trainer.step"), exact_f32():
            x = self.augment(x)
            loss, _, _ = self._loss(x, lengths, targets, target_lengths, day, w, total)
            grads = torch.autograd.grad(loss, self._weights)
            self.optimizer.step(grads)
        return loss.detach()

    @torch.no_grad()
    def evaluate(self, data: SequenceSet) -> Tuple[float, float]:
        """(the mean over batches of the CTC loss, the phoneme error rate:
        greedy decoding's edit distance over the phonemes, summed over the
        set's sentences)."""
        self.model.eval()
        losses, errors, phonemes = [], 0, 0
        rows = torch.arange(len(data))
        with exact_f32():
            for b in range(0, len(data), self.batch_size):
                args = self.batch(data, rows[b:b + self.batch_size])
                loss, logits, input_lengths = self._loss(*args)
                losses.append(float(loss))
                targets, tl, w = args[2].cpu().numpy(), args[3].numpy(), args[5].cpu().numpy()
                for pred, t, n, keep in zip(greedy_decode(logits, input_lengths), targets, tl, w):
                    if keep:
                        errors += edit_distance(pred, t[:n].tolist())
                        phonemes += int(n)
        return float(np.mean(losses)), errors / max(phonemes, 1)

    def _epoch(self, data: SequenceSet) -> float:
        perm = self.epoch_order(data)
        n_batches = len(data) // self.batch_size
        losses = [self.train_step(*self.batch(data, perm[b * self.batch_size:
                                                          (b + 1) * self.batch_size]))
                  for b in range(n_batches)]
        return float(torch.stack(losses).mean())

    # ------------------------------------------------------------------
    def save(self, path: str, epochs_done: int, history: Sequence[Dict[str, float]]) -> None:
        save_state(path, self.model, self.optimizer, self._perm_gen, self._dev_gen,
                   epochs_done=int(epochs_done),
                   history=torch.tensor([[row[k] for k in HISTORY_KEYS] for row in history],
                                        dtype=torch.float64).reshape(-1, len(HISTORY_KEYS)))

    def restore(self, path: str) -> Optional[Tuple[int, List[Dict[str, float]]]]:
        """(epochs done, history) of the state at ``path``, with the
        weights, Adam's state and the generators restored; None where there
        is none. Call after :meth:`init`."""
        state = restore_state(path, self.model, self.optimizer, self._perm_gen, self._dev_gen)
        if state is None:
            return None
        history = [{"epoch": i, **dict(zip(HISTORY_KEYS, map(float, row)))}
                   for i, row in enumerate(state["history"].tolist())]
        return int(state["epochs_done"]), history

    def fit(self, train: Dict[str, np.ndarray], val: Dict[str, np.ndarray],
            checkpoint_dir: Optional[str] = None, resume: bool = False
            ) -> List[Dict[str, float]]:
        """``max_epochs`` epochs over ``train`` (keys ``x``, ``lengths``,
        ``targets``, ``target_lengths``, ``day``), each followed by the
        validation CTC loss and phoneme error rate on ``val``; returns one
        history row an epoch. With ``checkpoint_dir`` the train state is
        saved after every epoch, and ``resume`` continues from it."""
        if self.optimizer is None:
            self.init()
        self._reset_generators()
        epochs_done, history = 0, []
        if checkpoint_dir and resume:
            restored = self.restore(checkpoint_dir)
            if restored is not None:
                epochs_done, history = restored
        keys = ("x", "lengths", "targets", "target_lengths", "day")
        train_set = self.device_data(*(train[k] for k in keys))
        val_set = self.device_data(*(val[k] for k in keys))
        for epoch in range(epochs_done, self.max_epochs):
            train_loss = self._epoch(train_set)
            val_loss, per = self.evaluate(val_set)
            history.append({"epoch": epoch, "train/loss": train_loss, "val/loss": val_loss,
                            "val/per": per})
            if checkpoint_dir:
                self.save(checkpoint_dir, epoch + 1, history)
        return history
