"""The batched multi-seed fit (``training/seed_parallel.py``,
``training/seed_stack.py``) against the seed loop it replaces and against
the JAX package's ``SeedParallelTrainer``.

- The batched fit of 3 seeds against each seed's ``ClassifierTrainer``
  fit (logistic, shallow, ``CNNClassifier(3, 128, 4)``, a CNN-RNN of input
  length 40 and lstm_dim 80; dropout on in the deep models), one seed's
  validation labels scrambled so that it stops early while another runs
  to the end: JAX's own tolerances (``tests/test_seed_parallel.py``),
  history rows within rel 2e-3 / abs 2e-4, best epoch and early stop
  equal, at most 2 test predictions flipped. A grouped convolution or a
  batched matmul sums in another float32 order than one seed's, so the
  rows cannot be held bit for bit, and NAdam's first steps turn a
  reordered, nearly cancelling gradient element into a step of the other
  sign (``tests/test_torch_fit.py``'s docstring): the fits run 6 steps (3
  epochs of 2 batches of 16) at the paper's lr 5e-4 for the deep models,
  within which the rows stay within 5e-4 of the loop's. Over more steps
  they drift further (measured: the CNN over 9 steps at batch 8, 2.0e-3;
  the CNN-RNN at lr 2e-3, up to 9%), so the batched step itself is held
  in float64, where no such flip happens:
- two NAdam steps of the stacked seeds (dropout on; the CNN, the CNN-RNN
  and SynthesisLite with its batch norm) against each seed's own steps in
  float64: every weight and running statistic within 1e-9 of the
  tensor's largest.
- The batched epochs against JAX's vmapped fit (logistic, shallow),
  given JAX's initial weights and its per-seed permutations: rows within
  rel 1e-4 / abs 1e-5, and the logistic model's final weights within rtol
  1e-4 / atol 1e-6 (``tests/test_torch_fit.py``'s rules for the
  sequential fit).
- The per-seed decay mask: a stacked bias is not decayed; one step of
  ``SeedNAdam`` equals each seed's ``NAdam`` step exactly.
- ``seed_chunk`` 2 over 5 seeds against the unchunked fit: rtol 1e-6,
  predictions equal (JAX's ``test_seed_chunk_matches_unchunked``); the
  generators' permutations handed in give the same histories.
- The synthesizer's batched fit (SynthesisLite with batch norm and
  dropout, a narrow SynthesisFull), 2 seeds x 2 epochs, against the
  seed loop: losses, train and test MCDs within rule 1's rel 2e-3 / abs
  2e-4; SynthesisLite's running statistics within 1% of each tensor's
  largest element (measured: 0.2%; they average conv outputs of weights
  that float32 NAdam moves by single steps either way, and the float64
  test below holds them within 1e-9).
- Two gloo ranks sharding 3 seeds (padded to 4) against one process's
  batched fit (one torch thread each): rows, predictions and weights
  equal; rank 0 alone writes the logs. In the same launch,
  ``train_synthesizer --parallel_data 2`` runs the seed loop.
- The dispatch rules, JAX's: the batched fit with ``seed_parallel`` (the
  default) and more than one seed, per ``seed_chunk``; the loop with
  ``train_state_dir`` (and JAX's message), one seed or ``seed_parallel:
  false``; the synthesizer's loop also for ``--evaluate_only``.
- A bf16 model under the stack: float32 outputs off the bf16 grid within
  four bf16 roundings of each seed's own forward, float32 gradients.
- The LSTM's custom backward runs once, batched, under ``vmap(grad)``,
  each seed's float64 gradient within 1e-10 of its own (relative to the
  tensor's largest element), and a layer without a batching rule raises
  and names the layer.
"""

import argparse
import copy
import json
import os

import numpy as np
import pytest
import torch
from torch import nn

import test_torch_distributed as td
from decode_tonal_langauge_tpu_torch.data.splits import split_indices
from decode_tonal_langauge_tpu_torch.models import deep, simple, synthesis
from decode_tonal_langauge_tpu_torch.models.base import init_params
from decode_tonal_langauge_tpu_torch.ops import lstm as port_lstm
from decode_tonal_langauge_tpu_torch.ops.dropout import Dropout, set_dropout_generator
from decode_tonal_langauge_tpu_torch.parallel.mesh import make_mesh
from decode_tonal_langauge_tpu_torch.training import classifier_pipeline, train_synthesizer
from decode_tonal_langauge_tpu_torch.training.optim import NAdam, SeedNAdam
from decode_tonal_langauge_tpu_torch.training.seed_parallel import SeedParallelTrainer
from decode_tonal_langauge_tpu_torch.training.seed_stack import SeedStack
from decode_tonal_langauge_tpu_torch.training.synthesis_trainer import (
    SynthesisTrainer,
    seed_loop_fit_eval,
    seed_parallel_fit_eval,
)
from decode_tonal_langauge_tpu_torch.training.trainer import HISTORY_KEYS, ClassifierTrainer

SEEDS = [3, 17, 42]
ROW_TOL = dict(rel=2e-3, abs=2e-4)  # tests/test_seed_parallel.py:65-85
MAPPING = {"0": [5, 5, 5], "1": [3, 4, 5], "2": [3, 2, 3], "3": [5, 3, 1]}


def _separable(rng, n, c, t, n_classes):
    y = rng.integers(0, n_classes, n).astype(np.int32)
    x = rng.standard_normal((n, c, t)).astype(np.float32)
    for k in range(n_classes):
        x[y == k, k % c, :] += 2.0
    return x, y


def _stacks(x, y, seeds, scramble=()):
    """Per-seed 60/20/20 splits stacked on the seed axis; the validation
    labels of the seeds at positions ``scramble`` are shifted by one class
    (their validation loss rises: they stop early)."""
    parts = []
    for i, seed in enumerate(seeds):
        tr, va, te = split_indices(x.shape[0], [0.6, 0.2, 0.2], seed=seed)
        vy = (y[va] + 1) % (y.max() + 1) if i in scramble else y[va]
        parts.append((x[tr], y[tr], x[va], vy, x[te], y[te]))
    return tuple(np.stack(p) for p in zip(*parts))


def _assert_rows_close(got, want):
    """A batched seed's result against its loop fit (a FitResult)."""
    assert len(got.history) == len(want.history), (got.seed, got.history, want.history)
    assert (got.best_epoch, got.stopped_early) == (want.best_epoch, want.stopped_early)
    for g, w in zip(got.history, want.history):
        assert g["epoch"] == w["epoch"]
        for k in HISTORY_KEYS:
            assert g[k] == pytest.approx(w[k], **ROW_TOL), (got.seed, g["epoch"], k)


_MODELS = {  # port model, (C, T), classes, lr
    "logistic": (lambda: simple.LogisticRegressionClassifier(4 * 12, 3), (4, 12), 3, 2e-2),
    "shallow": (lambda: simple.ShallowNNClassifier(4 * 12, 3, hidden_dim=16), (4, 12), 3,
                1e-2),
    "cnn": (lambda: deep.CNNClassifier(3, 128, 4), (3, 128), 4, 5e-4),
    "cnnrnn": (lambda: deep.CNNRNNClassifier(2, 40, 3, lstm_dim=80), (2, 40), 3, 5e-4),
}


# ----------------------------------------------------------------------
# (a) the batched fit against the loop
@pytest.mark.parametrize("name", list(_MODELS))
def test_batched_fit_equals_the_seed_loop(name):
    model_fn, (c, t), n_classes, lr = _MODELS[name]
    x, y = _separable(np.random.default_rng(0), 40, c, t, n_classes)
    stacks = _stacks(x, y, SEEDS, scramble=(0,))  # 24 train rows: 2 batches of 16
    kw = dict(n_classes=n_classes, learning_rate=lr, weight_decay=0.01, batch_size=16,
              max_epochs=3, patience=0, device="cpu")
    got = SeedParallelTrainer(model_fn(), seeds=SEEDS, **kw).fit_eval(*stacks)
    for i, (seed, res) in enumerate(zip(SEEDS, got)):
        t = ClassifierTrainer(model_fn(), seed=seed, **kw)
        _assert_rows_close(res, t.fit(*(a[i] for a in stacks[:4])))
        assert (res.test_preds != t.predict(stacks[4][i])).sum() <= 2
        np.testing.assert_array_equal(res.test_true, stacks[5][i])
        assert res.n_params == t.n_params() and list(res.params) == list(t.params)
    assert got[0].stopped_early and not got[-1].stopped_early


def test_batched_fit_starts_from_the_loop_weights_and_masks():
    """Seed s of the stack starts from ClassifierTrainer.init's weights for
    seed s, and its dropout masks are the ones its own forward draws."""
    model_fn = lambda: deep.CNNRNNClassifier(2, 40, 3, lstm_dim=80)  # noqa: E731
    spt = SeedParallelTrainer(model_fn(), 3, SEEDS, device="cpu")
    spt.init()
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((3, 8, 2, 40)),
                        dtype=torch.float32)
    masks = spt.stack.draw_masks((x,), spt._dropout_gens)
    for i, seed in enumerate(SEEDS):
        t = ClassifierTrainer(model_fn(), 3, seed=seed, device="cpu")
        t.init()
        for k, v in t.params.items():
            assert torch.equal(v, spt.stack.state_dict(i)[k]), k
        seen = []
        t.model.drop.register_forward_hook(lambda m, a, out: seen.append(out))
        t.model.train()(x[i])
        keep = 1.0 - t.model.drop.p
        expect = torch.where(masks["drop"][i].bool(), seen[0].new_ones(()) / keep, 0.0)
        assert torch.equal(seen[0] != 0, expect != 0)


_F64 = {  # model, inputs of one seed's batch, loss
    "cnn": (lambda: deep.CNNClassifier(3, 128, 4), ((8, 3, 128),),
            lambda out, y: nn.functional.cross_entropy(out, y % 4)),
    "cnnrnn": (lambda: deep.CNNRNNClassifier(2, 40, 3, lstm_dim=80), ((8, 2, 40),),
               lambda out, y: nn.functional.cross_entropy(out, y)),
    "lite": (lambda: synthesis.SynthesisLite(6, 4, 40, conv_channels=8, lstm_hidden=16),
             ((8, 4, 40), (8, 2, 5)), lambda out, y: (out - y[:, None]).abs().mean()),
}


@pytest.mark.parametrize("name", list(_F64))
def test_batched_steps_equal_each_seeds_steps_in_float64(name):
    model_fn, shapes, loss_fn = _F64[name]
    models = [init_params(model_fn(), s).double() for s in SEEDS]
    loops = [copy.deepcopy(m) for m in models]
    stack = SeedStack(models, torch.device("cpu"))
    opt = SeedNAdam(list(stack.params.values()), 2e-3, weight_decay=0.01)
    gens = [torch.Generator().manual_seed(s) for s in SEEDS]
    loop_opts = [NAdam(list(m.parameters()), 2e-3, weight_decay=0.01) for m in loops]
    for seed, m in zip(SEEDS, loops):
        set_dropout_generator(m, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(10)
    for _ in range(2):
        inputs = [torch.as_tensor(rng.standard_normal((3,) + s)) for s in shapes]
        y = torch.as_tensor(rng.integers(0, 3, (3, 8)))
        grads, _, _ = stack.grad_step(inputs, loss_fn, (y,), gens)
        opt.step([grads[k] for k in stack.params])
        for i, (m, o) in enumerate(zip(loops, loop_opts)):
            loss = loss_fn(m.train()(*(x[i] for x in inputs)), y[i])
            o.step(torch.autograd.grad(loss, list(m.parameters())))
    for i, m in enumerate(loops):
        got = stack.state_dict(i)
        for k, v in m.state_dict().items():
            scale = max(float(v.abs().max()), 1.0)
            assert float((got[k] - v).abs().max()) <= 1e-9 * scale, k


# ----------------------------------------------------------------------
# (b) against the JAX package's batched fit
def _jax_perms(seed, n, n_batches, epochs):
    import jax

    rng = jax.random.key(seed)
    perms = []
    for _ in range(epochs):
        rng, perm_rng = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(perm_rng, n)))
        for _ in range(n_batches):
            rng, _ = jax.random.split(rng)
    return perms


@pytest.mark.parametrize("name", ["logistic", "shallow"])
def test_batched_epochs_match_jax_seed_parallel(name):
    import jax

    from decode_tonal_langauge_tpu.models import simple as jsimple
    from decode_tonal_langauge_tpu.training.seed_parallel import (
        SeedParallelTrainer as JSeedParallel,
    )
    from decode_tonal_langauge_tpu_torch.convert import flax_to_state_dict

    jmodel = {"logistic": lambda: jsimple.LogisticRegressionClassifier(input_dim=48,
                                                                         n_classes=3),
              "shallow": lambda: jsimple.ShallowNNClassifier(input_dim=48, n_classes=3,
                                                             hidden_dim=16)}[name]()
    model_fn, (c, t), n_classes, lr = _MODELS[name]
    x, y = _separable(np.random.default_rng(2), 40, c, t, n_classes)
    stacks = _stacks(x, y, SEEDS)
    epochs, bsz = 3, 8
    kw = dict(n_classes=n_classes, learning_rate=lr, weight_decay=0.01, batch_size=bsz,
              max_epochs=epochs, patience=100)
    jres = JSeedParallel(jmodel, seeds=SEEDS, **kw).fit_eval(*stacks)

    spt = SeedParallelTrainer(model_fn(), seeds=SEEDS, device="cpu", **kw)
    spt.init()
    inits = []
    for i, seed in enumerate(SEEDS):
        v = jmodel.init({"params": jax.random.key(seed), "dropout": jax.random.key(0)},
                        stacks[0][i, :1], train=False)
        inits.append(flax_to_state_dict({"params": jax.tree.map(np.asarray, v["params"])},
                                        model_fn()))
        for k, p in spt.stack.params.items():
            p[i].copy_(inits[i][k])
    data = spt._device_data(*stacks[:4])
    n = data.x.shape[1]
    perms = [_jax_perms(seed, n, n // bsz, epochs) for seed in SEEDS]
    for epoch in range(epochs):
        rows = spt._epoch(torch.as_tensor(np.stack([p[epoch] for p in perms])), data)
        for i, r in enumerate(jres):
            want = [r.history[epoch][k] for k in HISTORY_KEYS]
            np.testing.assert_allclose(rows[i].tolist(), want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"seed {SEEDS[i]} epoch {epoch}")
    if name == "logistic":
        for i, r in enumerate(jres):
            want = flax_to_state_dict({"params": jax.tree.map(np.asarray, r.params)},
                                      model_fn())
            for k, v in want.items():
                np.testing.assert_allclose(spt.stack.state_dict(i)[k].numpy(), v.numpy(),
                                           rtol=1e-4, atol=1e-6, err_msg=k)


# ----------------------------------------------------------------------
# (c) the per-seed decay mask
def test_seed_nadam_decays_by_the_per_seed_shape():
    rng = np.random.default_rng(3)
    w = torch.as_tensor(rng.standard_normal((2, 3, 5)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((2, 3)), dtype=torch.float32)
    gw = torch.as_tensor(rng.standard_normal((2, 3, 5)), dtype=torch.float32)
    gb = torch.as_tensor(rng.standard_normal((2, 3)), dtype=torch.float32)
    stacked = [w.clone(), b.clone()]
    opt = SeedNAdam(stacked, 1e-2, weight_decay=0.5)
    assert opt.decay == [True, False]
    opt.step([gw, gb])
    for i in range(2):
        loop = [w[i].clone(), b[i].clone()]
        NAdam(loop, 1e-2, weight_decay=0.5).step([gw[i], gb[i]])
        assert torch.equal(stacked[0][i], loop[0]) and torch.equal(stacked[1][i], loop[1])
    # With zero gradients only the decayed weight moves; the bias stays.
    still = [w.clone(), b.clone()]
    SeedNAdam(still, 1e-2, weight_decay=0.5).step([torch.zeros_like(w), torch.zeros_like(b)])
    assert torch.equal(still[1], b) and not torch.equal(still[0], w)


# ----------------------------------------------------------------------
# (d) seed_chunk
def test_seed_chunk_matches_unchunked():
    seeds = [3, 17, 42, 101, 7]
    model_fn, (c, t), n_classes, lr = _MODELS["logistic"]
    x, y = _separable(np.random.default_rng(4), 40, c, t, n_classes)
    stacks = _stacks(x, y, seeds, scramble=(1,))
    kw = dict(n_classes=n_classes, learning_rate=lr, batch_size=8, max_epochs=6,
              patience=0, device="cpu")
    full = SeedParallelTrainer(model_fn(), seeds=seeds, **kw).fit_eval(*stacks)
    chunked = SeedParallelTrainer(model_fn(), seeds=seeds, seed_chunk=2, **kw).fit_eval(*stacks)
    assert [r.seed for r in chunked] == [r.seed for r in full] == seeds
    # Permutations handed in replace the generators' draws: the same ones
    # give the same fit.
    n = stacks[0].shape[1]  # 24 train rows: whole batches of 8
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    given = SeedParallelTrainer(model_fn(), seeds=seeds, **kw).fit_eval(
        *stacks, perms=[[torch.randperm(n, generator=g).numpy() for _ in range(6)]
                        for g in gens])
    assert [r.history for r in given] == [r.history for r in full]
    for rf, rc in zip(full, chunked):
        assert len(rf.history) == len(rc.history)
        for hf, hc in zip(rf.history, rc.history):
            for k in hf:
                np.testing.assert_allclose(hf[k], hc[k], rtol=1e-6)
        np.testing.assert_array_equal(rf.test_preds, rc.test_preds)
        for k in rf.params:
            np.testing.assert_allclose(rf.params[k].numpy(), rc.params[k].numpy(), rtol=1e-6)


# ----------------------------------------------------------------------
# (e) the synthesizer
T_SYN, C_NON, C_CLS, MEL = 40, 4, 3, 24


def _synthesis_world(seeds, n=26):
    rng = np.random.default_rng(5)
    data = (rng.standard_normal((n, C_NON, T_SYN)).astype(np.float32),
            rng.standard_normal((n, C_CLS, T_SYN)).astype(np.float32),
            rng.standard_normal((n, C_CLS, T_SYN)).astype(np.float32),
            rng.standard_normal((n, MEL)).astype(np.float32) + 3.0)
    splits = [split_indices(n, [0.8, 0.2], seed=s) for s in seeds]
    train = tuple(np.stack([a[s[0]] for s in splits]) for a in data)
    test = tuple(np.stack([a[s[1]] for s in splits]) for a in data)
    return train, test, train[3].mean(axis=1)


_SYNTH = {
    "lite": lambda: synthesis.SynthesisLite(MEL, C_NON, T_SYN, conv_channels=8, lstm_hidden=16),
    "full": lambda: synthesis.SynthesisModelCNN(MEL, C_NON, T_SYN, lstm_channels=2,
                                                conv_channels=8),
}


def _synthesis_proto(name):
    tone = init_params(simple.LogisticRegressionClassifier(C_CLS * T_SYN, 4), 0)
    syll = init_params(simple.LogisticRegressionClassifier(C_CLS * T_SYN, 2), 1)
    return SynthesisTrainer(_SYNTH[name](), tone, syll, MAPPING, learning_rate=2e-3,
                            verbose=False, device="cpu")


@pytest.mark.parametrize("name", list(_SYNTH))
def test_batched_synthesis_fit_equals_the_seed_loop(name):
    seeds = [3, 5]
    train, test, target_means = _synthesis_world(seeds)
    batched, loop = _synthesis_proto(name), _synthesis_proto(name)
    got = seed_parallel_fit_eval(batched, seeds, train, test, epochs=2, batch_size=8,
                                 target_means=target_means)
    want = seed_loop_fit_eval(loop, seeds, train, test, epochs=2, batch_size=8,
                              target_means=target_means, verbose=False)
    for (gh, gmcd, grecon, gorigin), (wh, wmcd, wrecon, _) in zip(got, want):
        assert len(gh) == len(wh) == 2
        for g, w in zip(gh, wh):
            assert g == pytest.approx(w, **ROW_TOL)
        assert gmcd == pytest.approx(wmcd, **ROW_TOL)
        assert grecon.shape == wrecon.shape and np.isfinite(grecon).all()
    for g, w in zip(batched.seed_params, loop.seed_params):
        assert list(g) == list(w)
        for k in (k for k in g if "running" in k):
            assert float((g[k] - w[k]).abs().max()) <= 1e-2 * float(w[k].abs().max()), k
        if name == "lite":
            assert int(g["bn1.num_batches_tracked"]) == int(w["bn1.num_batches_tracked"]) == 6


# ----------------------------------------------------------------------
# (f) the seed axis over two ranks
def _dropout_mlp():
    return nn.Sequential(nn.Flatten(), nn.Linear(48, 16), nn.ReLU(), Dropout(0.5),
                         nn.Linear(16, 3))


_SHARD_KW = dict(n_classes=3, learning_rate=2e-2, batch_size=8, max_epochs=5, patience=0,
                 device="cpu")


def _shard_stacks():
    x, y = _separable(np.random.default_rng(6), 40, 4, 12, 3)
    return _stacks(x, y, SEEDS, scramble=(1,))


def _case_seed_shard(rank, world, case):
    spt = SeedParallelTrainer(_dropout_mlp(), seeds=SEEDS, mesh=make_mesh(world), **_SHARD_KW)
    results = spt.fit_eval(*_shard_stacks())
    for r in results:
        spt.write_logs(r, os.path.join(case["logs"], f"rank{rank}", f"seed_{r.seed}"))
    return [(r.seed, r.history, r.best_epoch, r.stopped_early, r.test_preds, r.params)
            for r in results]


def _case_synthesizer_mesh(rank, world, case):
    calls = []
    for name in ("seed_loop_fit_eval", "seed_parallel_fit_eval"):
        real = getattr(train_synthesizer, name)
        setattr(train_synthesizer, name,
                lambda *a, _real=real, _name=name, **k: calls.append(_name) or _real(*a, **k))
    train_synthesizer.main(case["args"] + ["--parallel_data", str(world)])
    return calls


_CASES = {"seed_shard": _case_seed_shard, "synthesizer_mesh": _case_synthesizer_mesh}


def _worker(rank, world, tmp):
    td._worker(rank, world, tmp, _CASES)


def test_two_ranks_shard_the_seed_axis(tmp_path):
    world_args = _synthesizer_world(tmp_path / "world")
    logs = str(tmp_path / "logs")
    outs = td._spawn(str(tmp_path / "launch"), 2, {"cases": {
        "seed_shard": {"logs": logs},
        "synthesizer_mesh": {"args": world_args + ["--result_file",
                                                   str(tmp_path / "mesh.csv")]},
    }}, module="test_torch_seed_parallel")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    try:
        one = SeedParallelTrainer(_dropout_mlp(), seeds=SEEDS, **_SHARD_KW).fit_eval(
            *_shard_stacks())
    finally:
        torch.set_num_threads(threads)
    assert any(r.stopped_early for r in one) and not all(r.stopped_early for r in one)
    for out in outs:
        got = out["seed_shard"]
        assert [g[0] for g in got] == SEEDS
        for (seed, history, best, stopped, preds, params), r in zip(got, one):
            assert (history, best, stopped) == (r.history, r.best_epoch, r.stopped_early)
            np.testing.assert_array_equal(preds, r.test_preds)
            for k, v in r.params.items():
                assert torch.equal(params[k], v), k
        assert out["synthesizer_mesh"] == ["seed_loop_fit_eval"]
    assert sorted(os.listdir(logs)) == ["rank0"]
    assert sorted(os.listdir(os.path.join(logs, "rank0"))) == sorted(f"seed_{s}" for s in SEEDS)


# ----------------------------------------------------------------------
# (g) the dispatch rules
def _spy(monkeypatch, owner, name, calls):
    real = getattr(owner, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(owner, name, spy)


def test_classifier_dispatch_follows_jax(monkeypatch, tmp_path, capsys):
    x, y = _separable(np.random.default_rng(7), 40, 4, 12, 3)
    calls = []
    _spy(monkeypatch, classifier_pipeline, "_fit_and_eval", calls)
    _spy(monkeypatch, SeedParallelTrainer, "_fit_block", calls)
    base = dict(model="models.simple_classifiers.LogisticRegressionClassifier",
                model_name="logistic", model_kwargs={}, lr=1e-2, batch_size=8, epochs=2, patience=2,
                train_ratio=0.6, vali_ratio=0.2, test_ratio=0.2, verbose=0, device="cpu")

    def run(seeds, **extra):
        calls.clear()
        res = classifier_pipeline._fit_eval_all_seeds(
            argparse.Namespace(**base, **extra), x, y, 3, seeds,
            log_dir_fn=lambda seed: str(tmp_path / f"seed_{seed}"))
        assert [r.seed for r in res] == list(seeds)
        return list(calls)

    assert run(SEEDS) == ["_fit_block"]
    assert all((tmp_path / f"seed_{s}" / n).exists() for s in SEEDS
               for n in ("metrics.csv", "confusion_matrix_test.csv"))
    assert run(SEEDS, seed_chunk=2) == ["_fit_block"] * 2
    assert run(SEEDS, seed_parallel=False) == ["_fit_and_eval"] * 3
    assert run(SEEDS[:1]) == ["_fit_and_eval"]
    capsys.readouterr()
    assert run(SEEDS, train_state_dir=str(tmp_path / "states")) == ["_fit_and_eval"] * 3
    assert "seed_parallel is disabled for this run" in capsys.readouterr().out


def _synthesizer_world(root):
    """A sample file with audio and the channel and config JSON; the
    stage's arguments without --result_file."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(8)
    n, sr = 20, 2000
    ecog = rng.standard_normal((n, 10, T_SYN)).astype(np.float32)
    audio = rng.standard_normal((n, 1024)).astype(np.float32)
    np.savez(os.path.join(root, "s.npz"), ecog=ecog, audio=audio,
             tone=rng.integers(0, 4, n), syllable=rng.integers(0, 2, n))
    with open(os.path.join(root, "ch.json"), "w") as f:
        json.dump({"active_channels": list(range(10)), "tone_discriminative": [0, 1],
                   "syllable_discriminative": [2, 3]}, f)
    with open(os.path.join(root, "cfg.json"), "w") as f:
        json.dump({"mel_kwargs": {"n_fft": 256, "hop_length": 128, "n_mels": 8},
                   "tone_dynamic_mapping": MAPPING, "n_syllables": 2, "n_tones": 4}, f)
    return ["--sample_path", os.path.join(root, "s.npz"), "--subject_id", "1",
            "--channel_file", os.path.join(root, "ch.json"),
            "--config_file", os.path.join(root, "cfg.json"), "--model_name", "m",
            "--synthesis_model_name", "SynthesisLite", "--syllable_model_name", "logistic",
            "--tone_model_name", "logistic", "--epochs", "1", "--batch_size", "8",
            "--repeat", "2", "--verbose", "0", "--audio_sampling_rate", str(sr),
            "--device", "cpu", "--checkpoint_dir", os.path.join(root, "ckpts")]


def test_synthesizer_dispatch_follows_jax(monkeypatch, tmp_path):
    args = _synthesizer_world(tmp_path) + ["--result_file", str(tmp_path / "r.csv")]
    calls = []
    for name in ("seed_parallel_fit_eval", "seed_loop_fit_eval"):
        _spy(monkeypatch, train_synthesizer, name, calls)

    def run(*extra):
        calls.clear()
        train_synthesizer.main(args + list(extra))
        return list(calls)

    assert run() == ["seed_parallel_fit_eval"]
    assert run("--seed_parallel", "0") == ["seed_loop_fit_eval"]
    assert run("--repeat", "1") == ["seed_loop_fit_eval"]
    assert run("--train_state_dir", str(tmp_path / "states")) == ["seed_loop_fit_eval"]
    assert run("--evaluate_only") == []


# ----------------------------------------------------------------------
# The LSTM under vmap(grad), and a layer without a batching rule
def test_lstm_backward_runs_once_batched(monkeypatch):
    calls = []
    real = port_lstm.LSTMSequence.backward
    monkeypatch.setattr(port_lstm.LSTMSequence, "backward",
                        staticmethod(lambda ctx, *g: calls.append(1) or real(ctx, *g)))
    model_fn = lambda: deep.CNNRNNClassifier(2, 40, 3, lstm_dim=80, dropout=0.0)  # noqa: E731
    models = [init_params(model_fn(), s).double() for s in SEEDS]
    stack = SeedStack(models, torch.device("cpu"))
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.standard_normal((3, 8, 2, 40)))
    y = torch.as_tensor(rng.integers(0, 3, (3, 8)))
    loss_fn = lambda out, y: nn.functional.cross_entropy(out, y)  # noqa: E731
    grads, loss, _ = stack.grad_step((x,), loss_fn, (y,), [None] * 3)
    assert len(calls) == 2  # lstm1 and lstm2, each once for all seeds
    for i, m in enumerate(models):
        want = torch.autograd.grad(loss_fn(m.train()(x[i]), y[i]), list(m.parameters()))
        for (k, _), w in zip(m.named_parameters(), want):
            assert float((grads[k][i] - w).abs().max()) <= 1e-10 * float(w.abs().max()), k


def test_bf16_models_cast_per_seed_and_keep_float32_heads():
    """A bf16 model under the stack casts its float32 weights inside
    forward, seed by seed, and its head computes in float32: outputs are
    float32 and off the bf16 grid, within four bf16 roundings of each
    seed's own forward (tests/test_torch_bf16.py's rule), and the
    gradients of the float32 parameters are float32."""
    model_fn = lambda: deep.CNNRNNClassifier(2, 40, 3, lstm_dim=80, dropout=0.0,  # noqa: E731
                                             dtype="bfloat16")
    models = [init_params(model_fn(), s) for s in SEEDS]
    stack = SeedStack(models, torch.device("cpu"))
    x = torch.as_tensor(np.random.default_rng(11).standard_normal((3, 8, 2, 40)),
                        dtype=torch.float32)
    out = stack.forward(x)
    assert out.dtype == torch.float32
    assert not torch.equal(out, out.to(torch.bfloat16).float())
    for i, m in enumerate(models):
        with torch.no_grad():
            want = m.eval()(x[i])
        assert float((out[i] - want).abs().max()) <= 2**-6 * float(want.abs().max())
    y = torch.as_tensor(np.random.default_rng(12).integers(0, 3, (3, 8)))
    grads, _, _ = stack.grad_step((x,), lambda o, t: nn.functional.cross_entropy(o, t), (y,),
                                  [None] * 3)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads.values())


class _Unbatchable(nn.Module):
    def forward(self, x):
        return torch.as_tensor(x.tolist())  # data-dependent: no batching rule


def test_a_layer_without_a_batching_rule_raises_with_its_name():
    models = [init_params(nn.Sequential(nn.Linear(4, 4), _Unbatchable()), s) for s in (0, 1)]
    stack = SeedStack(models, torch.device("cpu"))
    with pytest.raises(RuntimeError, match=r"layer 1 \(_Unbatchable\)"):
        stack.forward(torch.zeros(2, 3, 4))
    with pytest.raises(RuntimeError, match="_Unbatchable"):
        stack.grad_step((torch.zeros(2, 3, 4),), lambda out: out.sum(), (), [None] * 2)


def test_dropout_draws_follow_the_modules_forward():
    """The mask a seed's forward draws is Dropout.draw's from the same
    generator state."""
    d = Dropout(0.3)
    set_dropout_generator(d, torch.Generator().manual_seed(4))
    x = torch.ones(5, 7)
    out = d.train()(x)
    mask = d.draw(x.shape, x.dtype, x.device, torch.Generator().manual_seed(4))
    assert torch.equal(out != 0, mask.bool())
