"""Synthesis trainer: frozen-classifier label dynamics + ECoG -> mel.

Counterpart of ``decode_tonal_langauge_tpu/training/synthesis_trainer.py``:
NAdam with ``schedule_decay`` as an L2 decay on every parameter, a
weighted L1 loss on the mel vectors, the batch MCD, and ``evaluate``
returning ``(mcd, recon_mels, origin_mels)``.

Structure on the device:

- the frozen tone and syllable classifiers (eval mode, no gradient) run
  once per fit over the padded train set; the argmax of each head, the
  dynamics-table gather and ``stack([syllable, contour])`` give the
  (N, 2, n_dynamics) label dynamics, a constant of the fit;
- the train set is padded to whole batches by repeating sample 0 (weight
  0, so the loss and MCD ignore it, but SynthesisLite's batch norm sees
  it, as in JAX) and placed on the device once;
- each epoch permutes the padded set (the weights travel with their
  rows) with a permutation drawn from a CPU ``torch.Generator`` seeded
  from ``seed``; dropout draws from a device generator seeded alike
  (``ops/dropout.py``); both are checkpointed with the train state;
- an epoch's loss and MCD are the means of the per-batch values, padded
  batch included, and stay on the device until a checkpoint segment
  ends;
- the steps run cuDNN's deterministic algorithms (``exact_f32``), so a
  fit, and a resume, repeat exactly on the card.

The JAX trainer draws its permutations and dropout keys from one
``jax.random`` key chain and its weights from ``jax.random.key(seed)``;
torch draws neither, so the two agree step for step given the same
weights and batch order (the tests feed both). The classifiers are port
modules with their weights loaded, so the JAX constructor's
``tone_variables`` / ``syllable_variables`` have no counterpart here.

With a ``mesh`` the fit is data-parallel over its ``data`` axis, as the
classifier trainer's (``trainer.py``, ``parallel/mesh.py``): the batch
rounds up to a multiple of the axis, every rank computes the frozen
dynamics of the whole padded set once per fit and takes its slice of each
batch, the L1 loss and the MCD are the slice's sums over the global
batch's weight, and one all-reduce adds them with the gradients.
SynthesisLite's batch norm uses the global batch's statistics and dropout
the global batch's masks. :meth:`SynthesisTrainer.evaluate` runs the whole
test set on every rank (no cross-sample operation in eval mode), and rank
0 writes the train state.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import vmap

from ..data.utils import tone_dynamics_table
from ..models.base import init_params
from ..parallel.mesh import DataParallelLayout
from ..runtime.device import DeviceLike, exact_f32, resolve_device, scaler_on
from ..runtime.profiling import span
from .optim import NAdam, SeedNAdam
from .seed_stack import SeedStack
from .trainer import (accept_jax_only, padded_rows, restore_state, save_state,
                      seeded_generators)

_DB = 10.0 / math.log(10.0)


def compute_mcd(true_mcc: np.ndarray, pred_mcc: np.ndarray) -> float:
    """Mel-cepstral distortion (dB), batch mean:
    ``mean(10/ln10 * sqrt(2 * sum((t-p)^2, -1)))``."""
    true_mcc = np.asarray(true_mcc, dtype=np.float32)
    pred_mcc = np.asarray(pred_mcc, dtype=np.float32)
    sq = ((true_mcc - pred_mcc) ** 2).sum(axis=1)
    return float(np.mean(10.0 / np.log(10.0) * np.sqrt(2.0 * sq)))


def _mcd(true_mcc: torch.Tensor, pred_mcc: torch.Tensor, w: torch.Tensor,
         w_total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The weighted MCD of one batch (padding rows weigh 0); ``w_total``
    is the global batch's ``sum(w)`` when the rows are one rank's slice."""
    vals = _DB * torch.sqrt(2.0 * ((true_mcc - pred_mcc) ** 2).sum(dim=1))
    total = w.sum() if w_total is None else w_total
    return (vals * w).sum() / total.clamp_min(1.0)


def _with_output_bias(model: nn.Module, target_mean) -> nn.Module:
    """Set the output head's bias to ``target_mean`` (no-op when None):
    ``output_layer`` (SynthesisModelCNN) or ``fc2`` (SynthesisLite)."""
    if target_mean is None:
        return model
    for head in ("output_layer", "fc2"):
        layer = getattr(model, head, None)
        if isinstance(layer, nn.Linear):
            with torch.no_grad():
                layer.bias.copy_(torch.as_tensor(np.asarray(target_mean), dtype=layer.bias.dtype))
            return model
    raise ValueError(
        "target_mean init: no known output head (output_layer/fc2) in "
        f"{type(model).__name__}"
    )


def _l1_loss(out: torch.Tensor, targets: torch.Tensor, w: torch.Tensor,
             total: torch.Tensor) -> torch.Tensor:
    """The weighted mean over samples of ``mean |out - target|`` over the
    mel axis; ``total`` is the (global) batch's ``sum(w)``."""
    l1 = (out - targets).abs().mean(dim=1)
    return (l1 * w).sum() / total.clamp_min(1.0)


@dataclass
class _DeviceData:
    x: torch.Tensor  # (N_pad, C, T) non-discriminative ECoG
    labels: torch.Tensor  # (N_pad, 2, n_dynamics) frozen-classifier dynamics
    y: torch.Tensor  # (N_pad, mel_dim) targets
    w: torch.Tensor  # (N_pad,) 1 for real rows, 0 for padding


class SynthesisTrainer:
    """Trains a synthesis model from frozen tone and syllable classifiers.

    ``synthesis_model``, ``tone_model`` and ``syllable_model`` are port
    modules; the classifiers carry their trained weights, and
    ``tone_scaler`` / ``syllable_scaler`` are the optional ``(mu, sd)``
    their inputs were standardised with. ``device=None`` means the CUDA
    card (it raises without one); the CPU runs only when asked for.
    ``mesh`` makes the fit data-parallel (module docstring)."""

    def __init__(
        self,
        synthesis_model: nn.Module,
        tone_model: nn.Module,
        syllable_model: nn.Module,
        tone_dynamic_mapping: Dict[str, List[float]],
        learning_rate: float = 5e-4,
        beta_1: float = 0.9,
        beta_2: float = 0.999,
        epsilon: float = 1e-8,
        schedule_decay: float = 0.004,
        seed: int = 0,
        verbose: bool = True,
        tone_scaler=None,
        syllable_scaler=None,
        moment_dtype: Optional[str] = None,
        device: DeviceLike = None,
        mesh=None,
        **jax_only,
    ) -> None:
        accept_jax_only(jax_only)
        self.device = resolve_device(device)
        self.mesh = mesh
        self._layout = DataParallelLayout(mesh)
        self.model = synthesis_model
        self.tone_model = tone_model.to(self.device).eval()
        self.syllable_model = syllable_model.to(self.device).eval()
        self.tone_dynamic_mapping = tone_dynamic_mapping
        self.tone_scaler = scaler_on(tone_scaler, self.device)
        self.syllable_scaler = scaler_on(syllable_scaler, self.device)
        self.seed = seed
        table, _ = tone_dynamics_table(tone_dynamic_mapping)
        self.dynamics_table = torch.as_tensor(table, dtype=torch.float32, device=self.device)
        # What a copy for another seed needs (seed_parallel_fit_eval).
        self._config = dict(
            learning_rate=learning_rate, beta_1=beta_1, beta_2=beta_2, epsilon=epsilon,
            schedule_decay=schedule_decay, verbose=verbose, tone_scaler=tone_scaler,
            syllable_scaler=syllable_scaler, moment_dtype=moment_dtype, device=self.device,
            mesh=mesh,
        )
        self.optimizer: Optional[NAdam] = None
        self._weights: List[torch.Tensor] = []
        self._perm_gen: Optional[torch.Generator] = None
        self._dropout_gen: Optional[torch.Generator] = None

    def for_seed(self, seed: int) -> "SynthesisTrainer":
        """A new trainer of the same configuration with its own copy of
        the synthesis model, sharing the frozen classifiers."""
        return SynthesisTrainer(copy.deepcopy(self.model), self.tone_model,
                                self.syllable_model, self.tone_dynamic_mapping,
                                seed=seed, **self._config)

    # ------------------------------------------------------------------
    def init(self, ecog_non: Optional[np.ndarray] = None, n_dynamics: Optional[int] = None,
             target_mean=None) -> None:
        """Seeded weights (``models.base.init_params``), the output bias
        set to ``target_mean`` when given, fresh optimizer moments and
        generators. ``ecog_non`` and ``n_dynamics`` are accepted for the
        JAX trainer's signature: a port module knows its shapes."""
        init_params(self.model, self.seed)
        _with_output_bias(self.model, target_mean)
        self._attach()

    def _attach(self) -> None:
        """The model on the device, a fresh optimizer over every
        parameter (decay unmasked) and fresh generators."""
        self.model.to(self.device)
        self._weights = list(self.model.parameters())
        self.optimizer = self._new_optimizer(self._weights)
        self._reset_generators()

    def _new_optimizer(self, params, kind=NAdam) -> NAdam:
        c = self._config
        return kind(params, c["learning_rate"], c["schedule_decay"], b1=c["beta_1"],
                    b2=c["beta_2"], eps=c["epsilon"], moment_dtype=c["moment_dtype"],
                    decay_all=True)

    def _reset_generators(self) -> None:
        self._perm_gen, self._dropout_gen = seeded_generators(self.seed, self.device, self.model)
        self._layout.attach(self.model)

    @property
    def params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The model's state dict on the host (batch-norm running
        statistics included), or None before :meth:`init`."""
        if self.optimizer is None:
            return None
        return {k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()}

    def n_params(self) -> int:
        return int(sum(p.numel() for p in self.model.parameters()))

    # ------------------------------------------------------------------
    def _tensor(self, arr) -> torch.Tensor:
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device, torch.float32)
        return torch.as_tensor(np.ascontiguousarray(arr, dtype=np.float32), device=self.device)

    @torch.no_grad()
    def _predict_labels(self, x_tone: torch.Tensor, x_syll: torch.Tensor) -> torch.Tensor:
        """Frozen classifier predictions -> label dynamics (B, 2,
        n_dynamics) on the device."""
        with exact_f32():
            if self.tone_scaler is not None:
                x_tone = (x_tone - self.tone_scaler[0]) / self.tone_scaler[1]
            if self.syllable_scaler is not None:
                x_syll = (x_syll - self.syllable_scaler[0]) / self.syllable_scaler[1]
            tones = torch.argmax(self.tone_model.eval()(x_tone), dim=1)
            sylls = torch.argmax(self.syllable_model.eval()(x_syll), dim=1)
        contour = self.dynamics_table[tones]
        syll_seq = sylls[:, None].to(torch.float32).expand(contour.shape)
        return torch.stack([syll_seq, contour], dim=1)

    def _predict_flat(self, x_tone, x_syll) -> torch.Tensor:
        """Label dynamics of a flat (N, C, T) set, in one pass."""
        return self._predict_labels(self._tensor(x_tone), self._tensor(x_syll))

    def _device_data(self, data, batch_size: int) -> _DeviceData:
        """``(ecog_non, ecog_syll, ecog_tone, mels)`` padded to whole
        batches and placed on the device, with the frozen classifiers'
        dynamics of the padded set."""
        x_non, x_syll, x_tone, mels = (self._tensor(a) for a in data)
        rows, w = padded_rows(x_non.shape[0], batch_size)
        if len(rows) > x_non.shape[0]:
            idx = torch.as_tensor(rows, device=self.device)
            x_non, x_syll, x_tone, mels = (t[idx] for t in (x_non, x_syll, x_tone, mels))
        return _DeviceData(x_non, self._predict_labels(x_tone, x_syll), mels,
                           torch.as_tensor(w, device=self.device))

    def train_step(self, x_non: torch.Tensor, labels: torch.Tensor, targets: torch.Tensor,
                   w: torch.Tensor, w_total: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One NAdam step on a weighted batch (this rank's rows of it under
        a mesh, with the global batch's ``sum(w)`` as ``w_total``) on the
        device; returns the global batch's (loss, MCD) tensors. The loss
        is the weighted mean over samples of ``mean |out - target|`` over
        the mel axis. cuDNN runs its deterministic algorithms, so that a
        resumed fit equals the uninterrupted one on the card too."""
        self.model.train()
        with span("trainer.step"), exact_f32(deterministic=True):
            out = self.model(x_non, labels)
            total = w.sum() if w_total is None else w_total
            loss = _l1_loss(out, targets, w, total)
            grads = torch.autograd.grad(loss, self._weights)
            with torch.no_grad():
                mcd = _mcd(targets, out, w, total)
            *grads, loss, mcd = self._layout.reduce_sum([*grads, loss.detach(), mcd])
            self.optimizer.step(grads)
        return loss, mcd

    def _epoch(self, perm: torch.Tensor, data: _DeviceData, batch_size: int) -> torch.Tensor:
        """One epoch in the order ``perm`` (a permutation of the padded
        set, on the device); returns the device tensor (mean batch loss,
        mean batch MCD)."""
        n_batches = data.x.shape[0] // batch_size
        idx = perm.reshape(n_batches, batch_size)
        totals = data.w[idx].sum(dim=1)
        (idx,) = self._layout.place_stacks(idx)
        batches = [t[idx] for t in (data.x, data.labels, data.y, data.w)]
        steps = [self.train_step(*(t[b] for t in batches), totals[b])
                 for b in range(n_batches)]
        losses, mcds = zip(*steps)
        return torch.stack([torch.stack(losses).mean(), torch.stack(mcds).mean()])

    # ------------------------------------------------------------------
    def _save_train_state(self, path: str, epochs_done: int, history: np.ndarray) -> None:
        save_state(path, self.model, self.optimizer, self._perm_gen, self._dropout_gen,
                   epochs_done=int(epochs_done),
                   history=torch.from_numpy(np.asarray(history, np.float32)))

    def _restore_train_state(self, path: str):
        """Returns (epochs_done, history) and restores the weights,
        optimizer and generators, or None when no state exists at
        ``path``. Call after :meth:`init`."""
        state = restore_state(path, self.model, self.optimizer, self._perm_gen,
                              self._dropout_gen)
        if state is None:
            return None
        return int(state["epochs_done"]), state["history"].numpy().reshape(-1, 2)

    def load_checkpoint(self, path: str) -> None:
        """Frozen evaluation from a model checkpoint (the
        ``--checkpoint_dir`` files saved after a fit): the weights and
        batch-norm statistics, then a fresh optimizer and generators, so
        :meth:`evaluate` (or a fine-tuning :meth:`train`) works without
        :meth:`init`."""
        from ..runtime.checkpoint import load_checkpoint

        params, _ = load_checkpoint(path)
        self.model.load_state_dict(params)
        self._attach()

    def train(
        self,
        train_data: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
        epochs: int,
        batch_size: int = 8,
        verbose: bool = True,
        target_mean=None,
        checkpoint_dir: Optional[str] = None,
        resume: bool = False,
        checkpoint_every: Optional[int] = None,
    ) -> List[Tuple[float, float]]:
        """Fit on ``(ecog_non, ecog_syll, ecog_tone, mels)``; returns the
        history of (epoch loss, epoch MCD). ``target_mean`` goes to
        :meth:`init` when the trainer is not initialised yet.

        ``checkpoint_dir``: save the full train state there after every
        ``checkpoint_every`` epochs (default: once at the end); with
        ``resume`` an existing state continues exactly where it left off
        (``epochs`` counts the total across the fit and the resume)."""
        if self.optimizer is None:
            self.init(train_data[0], self.dynamics_table.shape[1], target_mean=target_mean)
        self._reset_generators()
        batch_size = self._layout.round_batch(batch_size)
        epochs_done = 0
        history_arr = np.zeros((0, 2), dtype=np.float32)
        if checkpoint_dir and resume:
            restored = self._restore_train_state(checkpoint_dir)
            if restored is not None:
                epochs_done, history_arr = restored
        self._layout.replicate_tree(self.model)

        data = self._device_data(train_data, batch_size)
        n = data.x.shape[0]
        seg_size = int(checkpoint_every) if (checkpoint_dir and checkpoint_every) else epochs
        while epochs_done < epochs:
            seg = min(seg_size, epochs - epochs_done)
            rows = [self._epoch(torch.randperm(n, generator=self._perm_gen).to(self.device),
                                data, batch_size)
                    for _ in range(seg)]
            chunk = torch.stack(rows).cpu().numpy().astype(np.float32)  # the segment's one read
            history_arr = np.concatenate([history_arr, chunk])
            epochs_done += seg
            if checkpoint_dir and self._layout.writer:
                self._save_train_state(checkpoint_dir, epochs_done, history_arr)
            self._layout.barrier("train:train_state")

        history = [(float(loss), float(mcd)) for loss, mcd in history_arr]
        if verbose:
            for epoch, (loss, mcd) in enumerate(history):
                print(f"Epoch {epoch + 1}/{epochs}, Loss: {loss:.4f}, Mean MCD: {mcd:.4f}")
        return history

    @torch.no_grad()
    def evaluate(
        self,
        test_data: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
        batch_size: int = 8,
    ) -> Tuple[float, np.ndarray, np.ndarray]:
        """Returns (mcd, recon_mels, origin_mels). The MCD is the mean of
        the per-batch weighted MCDs, padded batch included, as JAX's (whose
        batch rounds up to the ``data`` axis here too)."""
        batch_size = self._layout.round_batch(batch_size)
        data = self._device_data(test_data, batch_size)
        n_batches = data.x.shape[0] // batch_size
        self.model.eval()
        mcds, outs = [], []
        with exact_f32():
            for b in range(n_batches):
                rows = slice(b * batch_size, (b + 1) * batch_size)
                out = self.model(data.x[rows], data.labels[rows])
                mcds.append(_mcd(data.y[rows], out, data.w[rows]))
                outs.append(out)
        n = test_data[0].shape[0]
        recon = torch.cat(outs)[:n].cpu().numpy()
        return float(torch.stack(mcds).mean()), recon, np.asarray(test_data[3])


def fit_eval_seed(
    trainer: SynthesisTrainer,
    train_data: Sequence[np.ndarray],
    test_data: Sequence[np.ndarray],
    epochs: int,
    batch_size: int = 8,
    target_mean=None,
    **train_kwargs,
):
    """One seed: ``trainer.train`` (``train_kwargs`` go to it) then
    ``evaluate`` on the test set; returns (history, mcd, recon, origin)."""
    history = trainer.train(tuple(train_data), epochs=epochs, batch_size=batch_size,
                            target_mean=target_mean, **train_kwargs)
    mcd, recon, origin = trainer.evaluate(tuple(test_data), batch_size=batch_size)
    return history, mcd, recon, origin


def seed_loop_fit_eval(
    proto: SynthesisTrainer,
    seeds,
    train_stacks: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    test_stacks: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    epochs: int,
    batch_size: int = 8,
    target_means=None,
    train_state_dirs: Optional[Sequence[str]] = None,
    **train_kwargs,
):
    """The seeds one at a time, each a :meth:`SynthesisTrainer.for_seed`
    copy of ``proto`` through :func:`fit_eval_seed`, so each seed's result
    is exactly a sequential trainer's: :func:`seed_parallel_fit_eval`'s
    arguments and return value, and ``proto.seed_params``. This is the
    path for a mesh (each seed's fit data-parallel) and for per-seed train
    states (``train_state_dirs[s]`` as the seed's ``checkpoint_dir``;
    ``train_kwargs`` go to :meth:`SynthesisTrainer.train`)."""
    seeds = [int(s) for s in seeds]
    if train_stacks[0].shape[0] != len(seeds):
        raise ValueError(f"{train_stacks[0].shape[0]} seed slices for {len(seeds)} seeds")
    results, proto.seed_params = [], []
    for i, seed in enumerate(seeds):
        trainer = proto.for_seed(seed)
        results.append(fit_eval_seed(
            trainer, [a[i] for a in train_stacks], [a[i] for a in test_stacks],
            epochs, batch_size, None if target_means is None else target_means[i],
            checkpoint_dir=None if train_state_dirs is None else train_state_dirs[i],
            **train_kwargs,
        ))
        proto.seed_params.append(trainer.params)
    return results


class SeedSynthesisStack:
    """The seeds of one synthesis experiment as one stack: each seed's
    synthesis model (initialised as :meth:`SynthesisTrainer.init`
    initialises that seed, its output bias from ``target_means[s]``), its
    NAdam moments and its generators, on ``proto``'s device; ``proto``
    holds the configuration and the frozen classifiers."""

    def __init__(self, proto: SynthesisTrainer, seeds, target_means=None) -> None:
        if proto.mesh is not None:
            raise ValueError("a batched fit of the seeds runs on one device: build the "
                             "trainer with mesh=None")
        self.proto = proto
        self.seeds = [int(s) for s in seeds]
        self.stack = SeedStack(
            [_with_output_bias(init_params(copy.deepcopy(proto.model), s),
                               None if target_means is None else target_means[i])
             for i, s in enumerate(self.seeds)], proto.device)
        self.optimizer = proto._new_optimizer(list(self.stack.params.values()), kind=SeedNAdam)
        self.perm_gens = [torch.Generator().manual_seed(s) for s in self.seeds]
        self.dropout_gens = [torch.Generator(device=proto.device).manual_seed(s)
                             for s in self.seeds]

    def device_data(self, train_stacks, batch_size: int) -> List[torch.Tensor]:
        """Each seed's padded train set and its frozen-classifier label
        dynamics (computed once per seed), stacked: (x, labels, y, w)."""
        per_seed = [self.proto._device_data(tuple(a[i] for a in train_stacks), batch_size)
                    for i in range(len(self.seeds))]
        return [torch.stack([getattr(d, f) for d in per_seed]) for f in ("x", "labels", "y", "w")]

    def train_step(self, x_non: torch.Tensor, labels: torch.Tensor, targets: torch.Tensor,
                   w: torch.Tensor, w_total: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One NAdam step of every seed on its batch (each argument with a
        leading seed axis), under deterministic cuDNN; returns the (S,)
        losses and MCDs, as :meth:`SynthesisTrainer.train_step` per seed."""
        with span("trainer.step"), exact_f32(deterministic=True):
            grads, loss, out = self.stack.grad_step((x_non, labels), _l1_loss,
                                                    (targets, w, w_total), self.dropout_gens)
            with torch.no_grad():
                mcd = vmap(_mcd)(targets, out, w, w_total)
            self.optimizer.step([grads[k] for k in self.stack.params])
        return loss, mcd

    def epoch(self, perms: torch.Tensor, data: List[torch.Tensor],
              batch_size: int) -> torch.Tensor:
        """One epoch of every seed, seed s in the order ``perms[s]``;
        returns the (S, 2) device tensor of (mean batch loss, mean batch
        MCD)."""
        n_seeds, n = perms.shape
        idx = perms.reshape(n_seeds, n // batch_size, batch_size)
        rows = torch.arange(n_seeds, device=perms.device)[:, None, None]
        batches = [t[rows, idx] for t in data]
        totals = batches[3].sum(dim=2)
        losses, mcds = zip(*(self.train_step(*(t[:, b] for t in batches), totals[:, b])
                             for b in range(idx.shape[1])))
        return torch.stack([torch.stack(losses, 1).mean(1), torch.stack(mcds, 1).mean(1)], 1)


def seed_parallel_fit_eval(
    proto: SynthesisTrainer,
    seeds,
    train_stacks: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    test_stacks: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    epochs: int,
    batch_size: int = 8,
    target_means=None,  # (S, output_dim) per-seed train-mel means, or None
):
    """All repeat seeds of one synthesis experiment as ONE batched fit,
    the JAX package's ``seed_parallel_fit_eval``: a
    :class:`SeedSynthesisStack` of the seeds, one forward and one backward
    of every seed a step, each seed's permutations and dropout masks from
    its own generators as :meth:`SynthesisTrainer.train` draws them.
    ``proto`` (built with ``mesh=None``: the seed axis is the parallel
    axis here) holds the configuration and the frozen classifiers; the
    stacks carry a leading seed axis (``(ecog_non, ecog_syll, ecog_tone,
    mels)``, equal sizes across seeds).

    After the fit each seed's test set runs through
    :meth:`SynthesisTrainer.evaluate` on its trained weights, as
    ``train_synthesizer --evaluate_only`` and serving recompute it from the
    checkpoint, so their rows agree exactly (a batched forward sums in
    another order). Returns a list over seeds of (history, mcd,
    recon_mels, origin_mels); each seed's trained state dict is left in
    ``proto.seed_params``."""
    seeds = [int(s) for s in seeds]
    if train_stacks[0].shape[0] != len(seeds):
        raise ValueError(f"{train_stacks[0].shape[0]} seed slices for {len(seeds)} seeds")
    fit = SeedSynthesisStack(proto, seeds, target_means)
    data = fit.device_data(train_stacks, batch_size)
    n = data[0].shape[1]
    history = [fit.epoch(torch.stack([torch.randperm(n, generator=g) for g in fit.perm_gens])
                         .to(proto.device), data, batch_size)
               for _ in range(epochs)]
    history = (torch.stack(history, 1).cpu().numpy() if history  # the fit's one read
               else np.zeros((len(seeds), 0, 2), np.float32))

    proto.seed_params, results = [], []
    evaluator = proto.for_seed(seeds[0])
    evaluator.model.to(proto.device)
    for i in range(len(seeds)):
        proto.seed_params.append(fit.stack.state_dict(i))
        evaluator.model.load_state_dict(proto.seed_params[i])
        mcd, recon, origin = evaluator.evaluate(tuple(a[i] for a in test_stacks), batch_size)
        results.append(([(float(loss), float(m)) for loss, m in history[i]], mcd, recon, origin))
    return results
