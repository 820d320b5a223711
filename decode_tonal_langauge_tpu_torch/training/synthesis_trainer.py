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

from ..data.utils import tone_dynamics_table
from ..models.base import init_params
from ..ops.dropout import set_dropout_generator
from ..parallel.mesh import DataParallelLayout
from ..runtime.device import DeviceLike, exact_f32, resolve_device
from .optim import NAdam
from .trainer import accept_jax_only

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


def _padded_weights(n: int, batch_size: int) -> np.ndarray:
    """Per-row weights of ``n`` rows padded to whole batches: 1, then 0."""
    n_pad = max(1, -(-n // batch_size)) * batch_size
    return np.concatenate([np.ones(n, np.float32), np.zeros(n_pad - n, np.float32)])


def _pad_rows(t: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Pad to ``n_pad`` rows by repeating row 0."""
    pad = n_pad - t.shape[0]
    if not pad:
        return t
    return torch.cat([t, t[:1].expand((pad,) + t.shape[1:])])


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
        self.tone_scaler = self._scaler(tone_scaler)
        self.syllable_scaler = self._scaler(syllable_scaler)
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

    def _scaler(self, scaler):
        if scaler is None:
            return None
        return tuple(torch.as_tensor(np.array(v, dtype=np.float32), device=self.device)
                     for v in scaler)

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
        c = self._config
        self.optimizer = NAdam(self._weights, c["learning_rate"], c["schedule_decay"],
                               b1=c["beta_1"], b2=c["beta_2"], eps=c["epsilon"],
                               moment_dtype=c["moment_dtype"], decay_all=True)
        self._reset_generators()

    def _reset_generators(self) -> None:
        self._perm_gen = torch.Generator().manual_seed(self.seed)
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(self.seed)
        set_dropout_generator(self.model, self._dropout_gen)
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
        w = _padded_weights(x_non.shape[0], batch_size)
        x_non, x_syll, x_tone, mels = (_pad_rows(t, w.size)
                                       for t in (x_non, x_syll, x_tone, mels))
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
        with exact_f32(deterministic=True):
            out = self.model(x_non, labels)
            l1 = (out - targets).abs().mean(dim=1)
            total = w.sum() if w_total is None else w_total
            loss = (l1 * w).sum() / total.clamp_min(1.0)
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
        from ..runtime.checkpoint import save_train_state

        save_train_state(path, {
            "params": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "perm_rng": self._perm_gen.get_state(),
            "dropout_rng": self._dropout_gen.get_state(),
            "epochs_done": int(epochs_done),
            "history": torch.from_numpy(np.asarray(history, np.float32)),
        })

    def _restore_train_state(self, path: str):
        """Returns (epochs_done, history) and restores the weights,
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


def seed_parallel_fit_eval(
    proto: SynthesisTrainer,
    seeds,
    train_stacks: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    test_stacks: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    epochs: int,
    batch_size: int = 8,
    target_means=None,  # (S, output_dim) per-seed train-mel means, or None
):
    """All repeat seeds of one experiment, with the JAX package's API.

    JAX fits the seeds as one vmapped computation; here they run one at a
    time (``proto.for_seed``, then :func:`fit_eval_seed`), so each seed's
    result is exactly that of a sequential trainer with that seed. The
    stacks carry a leading seed axis. Returns a list over seeds of
    (history, mcd, recon_mels, origin_mels); each seed's trained state
    dict is left in ``proto.seed_params``."""
    seeds = [int(s) for s in seeds]
    if train_stacks[0].shape[0] != len(seeds):
        raise ValueError(f"{train_stacks[0].shape[0]} seed slices for {len(seeds)} seeds")
    results, proto.seed_params = [], []
    for i, seed in enumerate(seeds):
        trainer = proto.for_seed(seed)
        results.append(fit_eval_seed(
            trainer, [a[i] for a in train_stacks], [a[i] for a in test_stacks],
            epochs, batch_size, None if target_means is None else target_means[i],
            verbose=False,
        ))
        proto.seed_params.append(trainer.params)
    return results
