"""Traffic ``fit_ctc``: one seed of a sequence decoder trained with CTC
through the port's ``SequenceTrainer``, stepped for the window: a speech
BCI lab training its phoneme decoder on a participant's sentences, as
``neural_seq_decoder``'s ``scripts/train_model.py`` does.

The data (:func:`make_data`) is the configuration's ``data``: sentences
whose lengths are fixed by it (spread evenly over ``min_bins`` to
``max_bins``), so every seed has the same shapes, and whose order, values,
phonemes and days the seed draws. The features are drawn on the device
(``sentences`` x ``max_bins`` x ``features``, the set a deployment keeps
there) from a generator seeded from the seed; the rest on the host. The
set is the trainer's padded device-resident one (``device_data``), every
batch cut to its longest sentence by the trainer (``batch``), every epoch
the trainer's permutation (``epoch_order``).

Set-up builds the trainer once, seeded with the fit's seed, loads the
harness's seeded weights into its model and runs the first epoch through
the window's own call and feed (``fit_steps.first_epoch``: the trainer's
tensors are handed to it with a seed axis of one). The window, the
numbers compared (``fit_steps.gaps``) and their reading are
``fit_steps``'s; the reference is ``reference/gru_ctc.py``, which draws the
augmentation and dropout again by the trainer's rule. The traced unit is
a step; the step traced with the host's ops is traced without input
shapes (the GRU's metrics find its kernels by span and name).

Mix parameters: ``seeds`` (1), ``batch``, ``check_steps``,
``trace_steps``.

``FAULTS``: the half-batch fault (``TRAINERS``, cut along ``BATCH_AXIS``
0). A step that leaves the state unchanged reads a change gap of 1, but
``tests/test_bench_faults.py`` makes that fault by patching ``NAdam.step``,
which this fit's ``Adam`` overrides, so it is not declared here.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from benchmark.harness import cells, inputs, program
from benchmark.reference import module_of
from benchmark.reference.layers import cast
from benchmark.reference.precision import BY_NAME, no_tf32

FAULTS = ("half_batch",)
TRAINERS = ("decode_tonal_langauge_tpu_torch.training.sequence_trainer.SequenceTrainer",)
BATCH_AXIS = 0

_steps = cells.module("traffic", "fit_steps")
window, release, gaps = _steps.window, _steps.release, _steps.gaps


def _check_mix(ctx) -> None:
    if ctx.mix["seeds"] != 1 or ctx.cfg["fit"]["kind"] != "ctc":
        raise ValueError("fit_ctc steps one seed of a CTC fit")
    if ctx.cfg["data"]["sentences"] % ctx.mix["batch"]:
        raise ValueError("fit_ctc takes a set of whole batches (the reference reads its rows)")


def make_data(ctx, device) -> SimpleNamespace:
    """The fit's sentences: ``x`` (N, max_bins, C) on ``device``, zero
    past each length; ``lengths``, ``targets`` (N, S) (0 past each target
    length), ``target_lengths`` and ``day`` on the host; the fit's seed
    and its weights' seed."""
    d = ctx.cfg["data"]
    m = ctx.cfg["models"][ctx.cfg["fit"]["model"]]
    n, t_max, c = d["sentences"], d["max_bins"], d["features"]
    r = inputs.rng(ctx.seed, "sentences")
    lengths = np.linspace(d["min_bins"], t_max, n).round().astype(np.int64)[r.permutation(n)]
    target_lengths = lengths // d["bins_per_phoneme"]
    targets = r.integers(1, m["n_classes"] + 1, (n, int(target_lengths.max())))
    targets[np.arange(targets.shape[1])[None] >= target_lengths[:, None]] = 0
    day = r.integers(0, d["n_days"], n)
    means = (d["phoneme_sd"] * r.standard_normal((m["n_classes"] + 1, c))).astype(np.float32)
    # bin b of sentence i shows its target floor(b * S_i / T_i), and nothing past T_i
    bins = np.arange(t_max)[None]
    pos = np.minimum(bins * target_lengths[:, None] // lengths[:, None], targets.shape[1] - 1)
    ids = np.where(bins < lengths[:, None], np.take_along_axis(targets, pos, 1), -1)
    g = torch.Generator(device=device).manual_seed(inputs.sub_seeds(ctx.seed, "features", 1)[0])
    x = torch.randn((n, t_max, c), generator=g, device=device)
    ids = torch.as_tensor(ids, device=device)
    x.add_(torch.as_tensor(means, device=device)[ids.clamp_min(0)])
    x.mul_((ids >= 0)[..., None])
    return SimpleNamespace(x=x, lengths=lengths, targets=targets, target_lengths=target_lengths,
                           day=day, seeds=inputs.sub_seeds(ctx.seed, "fit", 1),
                           weight_seeds=inputs.sub_seeds(ctx.seed, "weights/fit", 1))


class Feed:
    """Each epoch, the trainer's permutation of its padded set, cut into
    the trainer's batches."""

    def __init__(self, trainer, data, batch: int) -> None:
        self.trainer, self.data, self.batch = trainer, data, batch
        self.n_batches = len(data) // batch
        self.next = self.n_batches

    def epoch(self) -> torch.Tensor:
        """The epoch's permutation, with a seed axis of one."""
        self.perm = self.trainer.epoch_order(self.data)
        self.next = 0
        return self.perm[None]

    def step_args(self):
        if self.next == self.n_batches:
            self.epoch()
        b, self.next = self.next, self.next + 1
        return list(self.trainer.batch(self.data, self.perm[b * self.batch:(b + 1) * self.batch]))


def _trainer(ctx, seed: int):
    from decode_tonal_langauge_tpu_torch.training.sequence_trainer import SequenceTrainer

    fit = ctx.cfg["fit"]
    return SequenceTrainer(program.build(ctx.cfg["models"][fit["model"]]),
                           learning_rate=fit["learning_rate"], weight_decay=fit["weight_decay"],
                           b1=fit["b1"], b2=fit["b2"], eps=fit["eps"],
                           batch_size=ctx.mix["batch"], white_noise_sd=fit["white_noise_sd"],
                           constant_offset_sd=fit["constant_offset_sd"], seed=seed,
                           device=ctx.device)


def setup(ctx) -> SimpleNamespace:
    _check_mix(ctx)
    seed = inputs.sub_seeds(ctx.seed, "fit", 1)[0]
    trainer = _trainer(ctx, seed)  # the port's objects first: a port without them fails here
    trainer.init()
    data = make_data(ctx, ctx.device)
    dset = trainer.device_data(data.x, data.lengths, data.targets, data.target_lengths, data.day)
    data.x = None  # the trainer holds the set
    names = [k for k, _ in trainer.model.named_parameters()]
    prog = SimpleNamespace(
        params={k: p.detach()[None] for k, p in trainer.model.named_parameters()},
        step=lambda *a: trainer.train_step(*a)[None],
        first_moment=lambda: {k: mu[None]
                              for k, mu in zip(names, trainer.optimizer.state_dict()["mu"])},
        owner=trainer)
    w0 = _steps.fit_weights(ctx, data, ctx.device)
    feed = Feed(trainer, dset, ctx.mix["batch"])
    readings = _steps.first_epoch(ctx, prog, feed, w0)
    del w0
    _steps._sync(ctx.device)
    return SimpleNamespace(data=data, prog=prog, feed=feed, readings=readings)


def traced(ctx, st, profile) -> int:
    """``trace_steps`` steps traced, then one more with the host's ops."""
    n = ctx.mix["trace_steps"]
    steps = [st.feed.step_args() for _ in range(n + 1)]
    _steps._sync(ctx.device)
    with profile():
        for args in steps[:n]:
            st.prog.step(*args)
    with profile(host_ops=True):
        st.prog.step(*steps[n])
    return n


def reference(ctx, r: Dict, device, precision: str = "f64", half_batch: bool = False) -> Dict:
    """The first ``check_steps`` steps followed by the reference in
    ``precision`` from the rows the port took (``r["rows"]``); with
    ``half_batch`` each step sees only the first half of its rows. Returns
    the losses and the norms by tensor, as ``fit_steps.reference`` does."""
    cfg, mix, fit = ctx.cfg, ctx.mix, ctx.cfg["fit"]
    prec = BY_NAME[precision]
    m = cfg["models"][fit["model"]]
    arch = module_of(m)
    b, k_check = mix["batch"], mix["check_steps"]
    data = make_data(ctx, device)
    w0 = _steps.fit_weights(ctx, data, device)
    for k, v in w0.items():
        if not np.array_equal(v.double().flatten(1).sum(1).cpu().numpy(), r["w0_sum"][k]):
            raise RuntimeError(f"the seeded weights {k} did not draw again alike")
    steps = []
    for step in range(k_check):
        rows = np.asarray(r["rows"][0, step * b:(step + 1) * b])
        if half_batch:
            rows = rows[:b // 2]
        steps.append((rows, int(data.lengths[rows].max())))
    draws = arch.draws(data.seeds[0],
                       [arch.dropout_shapes(m, len(rows), t) for rows, t in steps],
                       [(len(rows), t, cfg["data"]["features"]) for rows, t in steps],
                       m.get("dropout", 0.0), device)
    batches = []
    for (rows, t), dr in zip(steps, draws):
        idx = torch.as_tensor(rows, device=device)
        x = data.x[idx, :t] + dr["noise"] * fit["white_noise_sd"]
        x = x + dr["offset"] * fit["constant_offset_sd"]
        masks = {k: v for k, v in dr.items() if k.startswith("gru.")}
        batches.append((x, torch.as_tensor(data.day[rows]),
                        torch.as_tensor(data.targets[rows]),
                        arch.input_lengths(m, data.lengths[rows]),
                        [int(n) for n in data.target_lengths[rows]],
                        torch.ones(len(rows), dtype=torch.float64), masks))
    del data
    hyper = {k: fit[k] for k in ("learning_rate", "weight_decay", "b1", "b2", "eps")}
    forward = lambda p, x, day, masks: arch.forward(p, x, day, m, prec, masks=masks)  # noqa: E731
    with no_tf32():
        res = arch.follow_steps(forward, cast({k: v[0] for k, v in w0.items()}, prec), batches,
                                hyper, prec, device)
    return {"seeds": [res]}


def judge(ctx, r: Dict) -> Dict[str, float]:
    return gaps(r, reference(ctx, r, ctx.device))


def control(ctx, mode: str) -> Dict[str, float]:
    """The numbers compared when the reference in ``mode`` (a precision,
    or ``half_batch``: float32 on half of each batch) stands in the port's
    place, against the float64 reference, on the rows of the trainer's
    first epoch."""
    _check_mix(ctx)
    data = make_data(ctx, ctx.device)
    n_pad = -(-len(data.lengths) // ctx.mix["batch"]) * ctx.mix["batch"]
    first = torch.randperm(n_pad, generator=torch.Generator().manual_seed(data.seeds[0]))
    w0 = _steps.fit_weights(ctx, data, ctx.device)
    r = {"w0_sum": {k: v.double().flatten(1).sum(1).cpu().numpy() for k, v in w0.items()},
         "rows": first[None, :ctx.mix["check_steps"] * ctx.mix["batch"]].numpy()}
    del w0, data
    half = mode == "half_batch"
    ran = reference(ctx, r, ctx.device, "f32" if half else mode, half_batch=half)["seeds"]
    r.update(loss=np.array([s["loss"] for s in ran]),
             grad_eff={k: np.array([s["grad_eff"][k] for s in ran]) for k in ran[0]["grad_eff"]},
             change={k: np.array([s["change"][k] for s in ran]) for k in ran[0]["change"]})
    return gaps(r, reference(ctx, r, ctx.device))
