"""Traffic ``fit_steps``: the repeat seeds of one fit as one batched fit,
stepped for the window.

Set-up builds the port's seed-batched trainer once (``SeedParallelTrainer``
for a classifier, ``SeedSynthesisStack`` for a synthesizer, whose frozen
classifiers' label dynamics are computed here, once, as a fit computes
them), loads the harness's seeded weights into its stacks and runs the
first epoch through the window's own call and feed. The feed is the
trainer's: every epoch a fresh permutation of each seed's padded,
device-resident train set, cut into batches. The first ``check_steps``
steps (rows that all differ) are the ones the reference follows; what
they left (each step's loss, the first gradient as the optimizer's first
moment holds it, the change of every tensor after them) is read as they
run. The window then steps the same object on.

Mix parameters: ``seeds``, ``batch`` (a seed), ``check_steps``,
``trace_steps``.

What the benchmark's tests break underneath (``tests/test_bench_faults.py``):
``FAULTS``, the faults a fit can have; ``TRAINERS``, the port's classes
whose ``train_step(*batch, total)`` the half-batch fault cuts along
``BATCH_AXIS`` of each batch tensor (the seeds lead).
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import inputs, program, weights
from benchmark.reference import module_of
from benchmark.reference import train as ref_train
from benchmark.reference.decode import dynamics
from benchmark.reference.decode import classify as ref_classify
from benchmark.reference.layers import cast
from benchmark.reference.precision import BY_NAME, no_tf32

FAULTS = ("state_unchanged", "half_batch")
TRAINERS = ("decode_tonal_langauge_tpu_torch.training.seed_parallel.SeedParallelTrainer",
            "decode_tonal_langauge_tpu_torch.training.synthesis_trainer.SeedSynthesisStack")
BATCH_AXIS = 1


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _padded(rows: np.ndarray, batch: int) -> np.ndarray:
    """Row indices padded to whole batches by repeating the first."""
    n_pad = -(-len(rows) // batch) * batch
    return np.concatenate([rows, np.repeat(rows[:1], n_pad - len(rows))])


def make_data(ctx) -> SimpleNamespace:
    """The fit's host data: trials, each seed's padded train rows and
    their weights, the fit's seeds and its weights' seeds."""
    cfg, mix, fit = ctx.cfg, ctx.mix, ctx.cfg["fit"]
    d = cfg["data"]
    model = cfg["models"][fit["model"]]
    n, s, b = fit["trials"], mix["seeds"], mix["batch"]
    if fit["kind"] == "classifier":
        c, t = model["input_channels"], model["input_length"]
        x, tone, syll = inputs.trials(inputs.rng(ctx.seed, "trials"), n, c, t, d["n_tones"],
                                      d["n_syllables"], d["planted_channels"], 0)
        arrays = {"x": x, "y": tone}
    else:
        ch = cfg["channels"]
        total = ch["tone"] + ch["syllable"] + ch["non_discriminative"]
        x, tone, syll = inputs.trials(inputs.rng(ctx.seed, "trials"), n, total,
                                      model["n_timepoints"], d["n_tones"], d["n_syllables"],
                                      ch["tone"], ch["syllable"])
        arrays = {"x": x, "mels": inputs.mels(inputs.rng(ctx.seed, "mels"), n,
                                              model["output_dim"])}
    train = [inputs.split(inputs.rng(ctx.seed, f"split/{i}"), n, fit["split"])[0]
             for i in range(s)]
    rows = np.stack([_padded(r, b) for r in train])
    w = np.zeros(rows.shape, np.float32)
    for i, r in enumerate(train):
        w[i, :len(r)] = 1.0
    return SimpleNamespace(arrays=arrays, train=train, rows=rows, w=w,
                           seeds=inputs.sub_seeds(ctx.seed, "fit", s),
                           weight_seeds=inputs.sub_seeds(ctx.seed, "weights/fit", s))


def _classifier(ctx, data) -> SimpleNamespace:
    from decode_tonal_langauge_tpu_torch.training.seed_parallel import SeedParallelTrainer

    fit = ctx.cfg["fit"]
    m = ctx.cfg["models"][fit["model"]]
    trainer = SeedParallelTrainer(program.build(m), m["n_classes"], data.seeds,
                                  learning_rate=fit["learning_rate"],
                                  weight_decay=fit["weight_decay"], batch_size=ctx.mix["batch"],
                                  device=ctx.device)
    trainer.init()
    put = lambda a, dt: torch.as_tensor(a, dtype=dt, device=ctx.device)  # noqa: E731
    tensors = [put(data.arrays["x"][data.rows], torch.float32),
               put(data.arrays["y"][data.rows], torch.long), put(data.w, torch.float32)]
    return SimpleNamespace(
        params=trainer.stack.params, tensors=tensors,
        step=lambda *a: trainer.train_step(*a)[0],
        first_moment=lambda: dict(zip(trainer.stack.params, trainer.optimizer.state_dict()["mu"])),
        owner=trainer)


def _synthesis(ctx, data) -> SimpleNamespace:
    from decode_tonal_langauge_tpu_torch.training.synthesis_trainer import (SeedSynthesisStack,
                                                                            SynthesisTrainer)

    cfg, fit = ctx.cfg, ctx.cfg["fit"]
    groups = inputs.channel_groups(cfg)
    w = program.decode_weights(cfg, ctx.seed, ctx.device, keys=("tone", "syllable"))
    sc = program.scalers(cfg, ctx.seed)
    proto = SynthesisTrainer(
        program.build(cfg["models"][fit["model"]]),
        program.frozen(cfg["models"]["tone"], w["tone"], ctx.device),
        program.frozen(cfg["models"]["syllable"], w["syllable"], ctx.device),
        program.mapping(cfg), learning_rate=fit["learning_rate"],
        schedule_decay=fit["weight_decay"], seed=data.seeds[0], verbose=False,
        tone_scaler=sc["tone"], syllable_scaler=sc["syllable"], device=ctx.device)
    stack = SeedSynthesisStack(proto, data.seeds)
    x, mels = data.arrays["x"], data.arrays["mels"]
    train = tuple(np.stack([a[r] for r in data.train])
                  for a in (x[:, groups["non"]], x[:, groups["syllable"]], x[:, groups["tone"]],
                            mels))
    tensors = stack.device_data(train, ctx.mix["batch"])  # x, label dynamics, mels, w
    return SimpleNamespace(
        params=stack.stack.params, tensors=tensors,
        step=lambda *a: stack.train_step(*a)[0],
        first_moment=lambda: dict(zip(stack.stack.params, stack.optimizer.state_dict()["mu"])),
        owner=stack)


def fit_weights(ctx, data, device) -> Dict[str, torch.Tensor]:
    """The trained model's initial weights, seed-stacked; the tensor its
    reference module names ``MEAN_MEL_BIAS`` (a synthesizer's output bias)
    starts at its seed's train-mel mean."""
    m = ctx.cfg["models"][ctx.cfg["fit"]["model"]]
    w = weights.stacked(program.spec(m), data.weight_seeds, device)
    bias = getattr(module_of(m), "MEAN_MEL_BIAS", None)
    if bias is not None:
        means = np.stack([data.arrays["mels"][r].mean(0) for r in data.train])
        w[bias] = torch.as_tensor(means, device=device)
    return w


def feed_generator(ctx) -> torch.Generator:
    return torch.Generator(device=ctx.device).manual_seed(inputs.sub_seeds(ctx.seed, "feed", 1)[0])


def permutation(gen: torch.Generator, n_seeds: int, n: int) -> torch.Tensor:
    """Each seed's permutation of its ``n`` padded rows, on the device."""
    return torch.argsort(torch.rand((n_seeds, n), generator=gen, device=gen.device), dim=1)


class Feed:
    """Each epoch, a fresh permutation of every seed's padded train set
    (drawn on the device from the run's seed), cut into batches."""

    def __init__(self, ctx, tensors: List[torch.Tensor]) -> None:
        self.tensors, self.batch = tensors, ctx.mix["batch"]
        self.gen = feed_generator(ctx)
        self.n_seeds, self.n_pad = tensors[-1].shape
        self.n_batches = self.n_pad // self.batch
        self.next = self.n_batches

    def epoch(self) -> torch.Tensor:
        perm = permutation(self.gen, self.n_seeds, self.n_pad)
        idx = perm.reshape(self.n_seeds, self.n_batches, self.batch)
        rows = torch.arange(self.n_seeds, device=perm.device)[:, None, None]
        self.batches = [t[rows, idx] for t in self.tensors]
        self.totals = self.batches[-1].sum(dim=2)
        self.next = 0
        return perm

    def step_args(self):
        if self.next == self.n_batches:
            self.epoch()
        b, self.next = self.next, self.next + 1
        return [t[:, b] for t in self.batches] + [self.totals[:, b]]


def first_epoch(ctx, prog, feed, w0: Dict[str, torch.Tensor]) -> Dict:
    """Loads ``w0`` into ``prog.params`` and runs the first epoch through
    the window's own call (``prog.step``) and ``feed``, reading what the
    reference follows: each of the first ``check_steps`` losses, the first
    gradient as the optimizer's first moment holds it
    (``prog.first_moment()``), every tensor's change after those steps,
    the initial weights' sums and the rows the steps took. Every tensor,
    ``feed.epoch()``'s permutation and each step's loss too, leads with a
    seed axis."""
    fit, k_check = ctx.cfg["fit"], ctx.mix["check_steps"]
    if set(w0) != set(prog.params):
        raise KeyError(f"weights {sorted(set(w0) ^ set(prog.params))} do not match the model")
    with torch.no_grad():
        for k, v in prog.params.items():
            v.copy_(w0[k])
    perm = feed.epoch()
    losses, first, change = [], {}, {}
    for b in range(feed.n_batches):
        loss = prog.step(*feed.step_args())
        if b < k_check:
            losses.append(loss.clone())  # a copy: what the port returned is let go
        if b == 0:
            first = {k: mu.flatten(1).norm(dim=1) / (1 - fit["b1"])
                     for k, mu in prog.first_moment().items()}
        if b == k_check - 1:
            change = {k: (p - w0[k]).flatten(1).norm(dim=1) for k, p in prog.params.items()}
    return {"loss": torch.stack(losses, 1), "grad_eff": first, "change": change,
            "w0_sum": {k: v.double().flatten(1).sum(1) for k, v in w0.items()},
            "rows": perm[:, :k_check * feed.batch]}


def setup(ctx) -> SimpleNamespace:
    data = make_data(ctx)
    prog = (_classifier if ctx.cfg["fit"]["kind"] == "classifier" else _synthesis)(ctx, data)
    w0 = fit_weights(ctx, data, ctx.device)
    feed = Feed(ctx, prog.tensors)
    readings = first_epoch(ctx, prog, feed, w0)
    del w0
    _sync(ctx.device)
    return SimpleNamespace(data=data, prog=prog, feed=feed, readings=readings)


def window(ctx, st, seconds: float) -> Dict:
    _sync(ctx.device)
    t0 = time.perf_counter()
    steps, trials, failed = 0, 0.0, 0
    while True:
        args = st.feed.step_args()
        loss = st.prog.step(*args)
        # running sums on the device: nothing the port returns is held
        trials = trials + args[-1].sum()
        failed = failed + (~torch.isfinite(loss)).any().int()
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(ctx.device)
    wall = time.perf_counter() - t0
    trials, failed = float(trials), int(failed)
    print(f"fit window: {steps} steps, {trials:.0f} real trials x seeds in {wall:.4f} s",
          file=ctx.log)
    return {"metrics": {"train_trials_per_s": trials / wall}, "attempted": steps,
            "failed": failed, "rate": trials / wall}


def traced(ctx, st, profile) -> int:
    """``trace_steps`` steps traced, then one more with the host's ops and
    their input shapes (the LSTMs' products are found by them)."""
    n = ctx.mix["trace_steps"]
    steps = [st.feed.step_args() for _ in range(n + 1)]
    _sync(ctx.device)
    with profile():
        for args in steps[:n]:
            st.prog.step(*args)
    with profile(host_ops=True, record_shapes=True):
        st.prog.step(*steps[n])
    return n


def release(ctx, st) -> Dict:
    """The readings on the host; the port's trainer and data dropped."""
    r = st.readings
    host = lambda d: {k: v.cpu().numpy() for k, v in d.items()}  # noqa: E731
    out = {"data": st.data, "loss": r["loss"].cpu().numpy(), "grad_eff": host(r["grad_eff"]),
           "change": host(r["change"]), "w0_sum": host(r["w0_sum"]),
           "rows": r["rows"].cpu().numpy()}
    st.prog = st.feed = st.readings = None
    return out


def _labels(ctx, data, rows: np.ndarray, prec, device) -> torch.Tensor:
    """The frozen classifiers' label dynamics of ``rows``, worked out
    again: scalers, both classifiers, argmax, the dynamics table."""
    cfg = ctx.cfg
    groups = inputs.channel_groups(cfg)
    w = program.decode_weights(cfg, ctx.seed, device, keys=("tone", "syllable"))
    sc = {k: tuple(torch.as_tensor(a, device=device) for a in v)
          for k, v in program.scalers(cfg, ctx.seed).items()}
    x = torch.as_tensor(data.arrays["x"][rows], device=device, dtype=prec.dtype)
    ids = [ref_classify(w, cfg["models"], key, x[:, groups[key]], sc[key], prec).argmax(1)
           for key in ("tone", "syllable")]
    table = torch.as_tensor(inputs.dynamics_table(program.mapping(cfg)), device=device)
    return dynamics(ids[0], ids[1], table.to(prec.dtype))


def reference(ctx, r: Dict, device, precision: str = "f64", half_batch: bool = False) -> Dict:
    """The first ``check_steps`` steps of every seed, followed by the
    reference in ``precision``; with ``half_batch`` each step sees only the
    first half of its rows (a fault to be caught). Returns per seed the
    losses and the norms by tensor."""
    cfg, mix, fit = ctx.cfg, ctx.mix, ctx.cfg["fit"]
    prec = BY_NAME[precision]
    data = r["data"]
    m = cfg["models"][fit["model"]]
    arch = module_of(m)
    b, k_check = mix["batch"], mix["check_steps"]
    hyper = {k: fit[k] for k in ("learning_rate", "weight_decay", "b1", "b2", "eps")}
    decay_all = fit["kind"] == "synthesis"
    decayed = lambda name, p: decay_all or p.ndim >= 2  # noqa: E731
    w0 = fit_weights(ctx, data, device)
    for k, v in w0.items():
        if not np.allclose(v.double().flatten(1).sum(1).cpu().numpy(), r["w0_sum"][k],
                           rtol=0, atol=0):
            raise RuntimeError(f"the seeded weights {k} did not draw again alike")
    labels = None
    if fit["kind"] == "synthesis":
        groups = inputs.channel_groups(cfg)
        labels = _labels(ctx, data, np.arange(fit["trials"]), prec, device)
    out = []
    with no_tf32():
        for i, seed in enumerate(data.seeds):
            masks = ref_train.keep_masks(seed, arch.dropout_shapes(m, b), k_check,
                                         m.get("dropout", 0.5), device)
            batches = []
            for step in range(k_check):
                pos = r["rows"][i, step * b:(step + 1) * b]
                rows, w = data.rows[i][pos], data.w[i][pos]
                if half_batch:
                    rows, w = rows[:b // 2], w[:b // 2]
                w = torch.as_tensor(w)
                if fit["kind"] == "classifier":
                    batches.append(((torch.as_tensor(data.arrays["x"][rows]),),
                                    torch.as_tensor(data.arrays["y"][rows]), w))
                else:
                    x = torch.as_tensor(data.arrays["x"][rows][:, groups["non"]])
                    batches.append(((x, labels[torch.as_tensor(rows, device=device)]),
                                    torch.as_tensor(data.arrays["mels"][rows]), w))
            if half_batch:
                masks = [{k: v[:b // 2] for k, v in mk.items()} for mk in masks]
            forward = lambda p, *xs, masks: arch.forward(p, *xs, m, prec, masks=masks)  # noqa: E731
            loss_fn = ref_train.mel_l1_loss if decay_all else ref_train.class_loss
            w_i = cast({k: v[i] for k, v in w0.items()}, prec)
            out.append(ref_train.follow_steps(forward, w_i, batches, masks, loss_fn, hyper,
                                              decayed, prec, device))
    return {"seeds": out}


def gaps(r: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared, each the worst over the seeds: the relative
    gap of the first step's loss (a forward from the given weights) and of
    the later steps' losses, and the worst leaf's gap of the first
    gradient's norm and of the change's norm after the steps (leaves whose
    reference gradient is under a thousandth of the median leaf's left out
    of the change)."""
    from benchmark.harness.compare import rel_gap, worst_leaf_gap

    out = dict.fromkeys(("loss_gap_first", "loss_gap_later", "grad_norm_gap",
                         "change_norm_gap"), 0.0)
    for i, res in enumerate(ref["seeds"]):
        worst = {"loss_gap_first": rel_gap(r["loss"][i][:1], res["loss"][:1]),
                 "loss_gap_later": rel_gap(r["loss"][i][1:], res["loss"][1:]),
                 "grad_norm_gap": worst_leaf_gap(
                     {k: float(v[i]) for k, v in r["grad_eff"].items()}, res["grad_eff"])}
        median = float(np.median(list(res["grad"].values())))
        moved = [k for k, g in res["grad"].items() if g >= 1e-3 * median]
        worst["change_norm_gap"] = worst_leaf_gap(
            {k: float(v[i]) for k, v in r["change"].items()}, res["change"], moved)
        out = {k: max(out[k], v) for k, v in worst.items()}
    return out


def judge(ctx, r: Dict) -> Dict[str, float]:
    return gaps(r, reference(ctx, r, ctx.device))


def control(ctx, mode: str) -> Dict[str, float]:
    """The numbers compared when the reference in ``mode`` (a precision,
    or ``half_batch``: float32 on half of each batch) stands in the
    port's place, against the float64 reference, from the inputs a run
    with this seed makes."""
    data = make_data(ctx)
    rows = permutation(feed_generator(ctx), len(data.seeds), data.rows.shape[1])
    return stand_in(ctx, data, rows[:, :ctx.mix["check_steps"] * ctx.mix["batch"]].cpu().numpy(),
                    mode)


def stand_in(ctx, data, rows: np.ndarray, mode: str, gaps_of=gaps) -> Dict[str, float]:
    """:func:`control` on the fit's ``data`` whose first steps take the
    positions ``rows`` (seeds, check_steps x batch) of each seed's padded
    train rows, read by ``gaps_of`` (the driver's numbers)."""
    w0 = fit_weights(ctx, data, ctx.device)
    r = {"data": data, "w0_sum": {k: v.double().flatten(1).sum(1).cpu().numpy()
                                  for k, v in w0.items()},
         "rows": rows}
    del w0
    half = mode == "half_batch"
    ran = reference(ctx, r, ctx.device, "f32" if half else mode, half_batch=half)["seeds"]
    r.update(loss=np.array([s["loss"] for s in ran]),
             grad_eff={k: np.array([s["grad_eff"][k] for s in ran]) for k in ran[0]["grad_eff"]},
             change={k: np.array([s["change"][k] for s in ran]) for k in ran[0]["change"]})
    return gaps_of(r, reference(ctx, r, ctx.device))
