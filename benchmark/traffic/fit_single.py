"""Traffic ``fit_single``: one seed of a classifier fit through the port's
``ClassifierTrainer``, stepped for the window: the path of a fit with
``repeat: 1`` (``configs/example_config.yaml``) or ``seed_parallel:
false``, with no seed stack, no ``vmap`` and no layout passes.

Set-up builds the trainer once, seeded with the fit's seed, loads the
harness's seeded weights into its model and runs the first epoch through
the window's own call and feed. The feed is the trainer's rule
(``ClassifierTrainer.fit``): every epoch a permutation of the padded,
device-resident train set, drawn on the host by ``torch.randperm`` from a
generator seeded with the trainer's seed, copied to the device and cut
into batches. The data, the initial weights, the first epoch's readings
(``fit_steps.first_epoch``: the trainer's tensors are handed to it with
a seed axis of one), the window, the traced steps, the reference and the
numbers compared are ``fit_steps``'s (``traffic/fit_steps.py``) with one
seed, and one number more (:func:`gaps`).

Mix parameters: ``seeds`` (1), ``batch``, ``check_steps``,
``trace_steps``.

``FAULTS``, ``TRAINERS``, ``BATCH_AXIS``: as in ``fit_steps``; here a
batch tensor has no seed axis.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List

import torch

from benchmark.harness import cells, program

FAULTS = ("state_unchanged", "half_batch")
TRAINERS = ("decode_tonal_langauge_tpu_torch.training.trainer.ClassifierTrainer",)
BATCH_AXIS = 0

_steps = cells.module("traffic", "fit_steps")
make_data, fit_weights = _steps.make_data, _steps.fit_weights
window, traced, release = _steps.window, _steps.traced, _steps.release


def epoch_order(gen: torch.Generator, n: int) -> torch.Tensor:
    """The trainer's next epoch: a permutation of its ``n`` padded rows."""
    return torch.randperm(n, generator=gen)


class Feed:
    """Each epoch, the trainer's permutation of the padded train set cut
    into batches of (x, y, w) and each batch's ``sum(w)``."""

    def __init__(self, ctx, seed: int, tensors: List[torch.Tensor]) -> None:
        self.tensors, self.batch = tensors, ctx.mix["batch"]
        self.gen = torch.Generator().manual_seed(seed)
        self.n_pad = tensors[-1].shape[0]
        self.n_batches = self.n_pad // self.batch
        self.next = self.n_batches

    def epoch(self) -> torch.Tensor:
        """The epoch's permutation, with a seed axis of one."""
        perm = epoch_order(self.gen, self.n_pad).to(self.tensors[0].device)
        idx = perm.reshape(self.n_batches, self.batch)
        self.batches = [t[idx] for t in self.tensors]
        self.totals = self.batches[-1].sum(dim=1)
        self.next = 0
        return perm[None]

    def step_args(self):
        if self.next == self.n_batches:
            self.epoch()
        b, self.next = self.next, self.next + 1
        return [t[b] for t in self.batches] + [self.totals[b]]


def _check_mix(ctx) -> None:
    if ctx.mix["seeds"] != 1 or ctx.cfg["fit"]["kind"] != "classifier":
        raise ValueError("fit_single steps one seed of a classifier fit")


def setup(ctx) -> SimpleNamespace:
    from decode_tonal_langauge_tpu_torch.training.trainer import ClassifierTrainer

    _check_mix(ctx)
    fit = ctx.cfg["fit"]
    m = ctx.cfg["models"][fit["model"]]
    data = make_data(ctx)
    seed = data.seeds[0]
    trainer = ClassifierTrainer(program.build(m), m["n_classes"],
                                learning_rate=fit["learning_rate"],
                                weight_decay=fit["weight_decay"], batch_size=ctx.mix["batch"],
                                seed=seed, device=ctx.device)
    trainer.init()
    # the trainer's tensors with a seed axis of one, as fit_steps reads them
    names = [k for k, _ in trainer.model.named_parameters()]
    prog = SimpleNamespace(
        params={k: p.detach()[None] for k, p in trainer.model.named_parameters()},
        step=lambda *a: trainer.train_step(*a)[0][None],
        first_moment=lambda: {k: mu[None]
                              for k, mu in zip(names, trainer.optimizer.state_dict()["mu"])},
        owner=trainer)
    w0 = fit_weights(ctx, data, ctx.device)
    put = lambda a, dt: torch.as_tensor(a, dtype=dt, device=ctx.device)  # noqa: E731
    rows = data.rows[0]
    feed = Feed(ctx, seed, [put(data.arrays["x"][rows], torch.float32),
                            put(data.arrays["y"][rows], torch.long), put(data.w[0], torch.float32)])
    readings = _steps.first_epoch(ctx, prog, feed, w0)
    del w0
    _steps._sync(ctx.device)
    return SimpleNamespace(data=data, prog=prog, feed=feed, readings=readings)


def gaps(r: Dict, ref: Dict) -> Dict[str, float]:
    """``fit_steps.gaps``, and ``grad_norm_gap_median``: the median leaf's
    gap of the first gradient's norm (``compare.median_leaf_gap``), the
    worst over the seeds. One seed's first loss is a single number, whose
    error under TF32 comes out near nought on some seeds; the median of the
    leaves' gaps is steadier from seed to seed."""
    from benchmark.harness.compare import median_leaf_gap

    out = _steps.gaps(r, ref)
    out["grad_norm_gap_median"] = max(
        median_leaf_gap({k: float(v[i]) for k, v in r["grad_eff"].items()}, res["grad_eff"])
        for i, res in enumerate(ref["seeds"]))
    return out


def judge(ctx, r: Dict) -> Dict[str, float]:
    return gaps(r, _steps.reference(ctx, r, ctx.device))


def control(ctx, mode: str) -> Dict[str, float]:
    """``fit_steps.control`` on the rows of the trainer's first epoch."""
    _check_mix(ctx)
    data = make_data(ctx)
    first = epoch_order(torch.Generator().manual_seed(data.seeds[0]), data.rows.shape[1])
    k = ctx.mix["check_steps"] * ctx.mix["batch"]
    return _steps.stand_in(ctx, data, first[None, :k].numpy(), mode, gaps_of=gaps)
