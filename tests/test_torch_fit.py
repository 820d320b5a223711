"""The port's fits: a 3-epoch fit against the JAX trainer with the JAX
permutations fed in, early stopping, full train-state resume and the seed
loop.

A JAX fit draws its batch order from a ``jax.random`` key chain that torch
cannot reproduce, so the test replays that chain with ``jax.random``
(``decode_tonal_langauge_tpu/training/trainer.py:199,264-265``) and feeds
each epoch's permutation to the port's epoch routine; with the JAX initial
weights carried across and dropout 0, the two fits must agree. The
history is held at the tolerance of ``tests/test_resume.py`` (rel 1e-4,
abs 1e-5) and so are the logistic model's final parameters (rtol 1e-4,
atol 1e-6).

The CNN-RNN's final parameters are held by the relative L2 error of each
tensor's total update (final minus initial) within 2e-2, for this reason:
NAdam divides each gradient element by its own running RMS, so an element
whose gradient is a nearly cancelling sum (biases, the wide convolutions)
takes a step whose size follows the last digits of that sum, and XLA and
ATen order those float32 sums differently. Over its 6 steps single
elements drift apart by up to ~2 steps (largest relative update error
0.9%, in ``conv3a.bias``), while the loss, accuracy, weight norm and
validation metrics of every epoch still agree within 1e-4. Port-only tests
(resume, the seed loop) hold the port to itself, where results must be
equal.
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from decode_tonal_langauge_tpu.models import deep as jdeep
from decode_tonal_langauge_tpu.models import simple as jsimple
from decode_tonal_langauge_tpu.training.trainer import ClassifierTrainer as JTrainer
from decode_tonal_langauge_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from decode_tonal_langauge_tpu_torch.models import deep, simple
from decode_tonal_langauge_tpu_torch.ops.dropout import Dropout
from decode_tonal_langauge_tpu_torch.training.seed_parallel import SeedParallelTrainer
from decode_tonal_langauge_tpu_torch.training.trainer import (
    ES_START,
    HISTORY_KEYS,
    ClassifierTrainer,
    early_stopping_update,
)


def _separable_data(rng, n=96, c=4, t=16, n_classes=3):
    y = rng.integers(0, n_classes, n).astype(np.int32)
    x = rng.standard_normal((n, c, t)).astype(np.float32)
    for k in range(n_classes):
        x[y == k, k % c, :] += 2.0
    return x, y


def _jax_perms(seed, n, n_batches, epochs):
    """Each epoch's permutation from the JAX fit's key chain: per epoch
    one split for the permutation, then one per batch for dropout."""
    rng = jax.random.key(seed)
    perms = []
    for _ in range(epochs):
        rng, perm_rng = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(perm_rng, n)))
        for _ in range(n_batches):
            rng, _ = jax.random.split(rng)
    return perms


_FITS = {  # JAX model, port model, (C, T), classes, lr, strict final params
    "logistic": (lambda: jsimple.LogisticRegressionClassifier(input_dim=4 * 16, n_classes=3),
                 lambda: simple.LogisticRegressionClassifier(4 * 16, 3), (4, 16), 3, 2e-3,
                 True),
    "cnnrnn": (lambda: jdeep.CNNRNNClassifier(input_channels=2, input_length=40, n_classes=3,
                                              lstm_dim=80, dropout=0.0),
               lambda: deep.CNNRNNClassifier(2, 40, 3, lstm_dim=80, dropout=0.0),
               (2, 40), 3, 5e-4, False),
}


@pytest.mark.parametrize("name", list(_FITS))
def test_three_epoch_fit_matches_jax_given_its_permutations(name):
    jmodel_fn, tmodel_fn, (c, t), n_classes, lr, strict = _FITS[name]
    x, y = _separable_data(np.random.default_rng(0), n=24, c=c, t=t, n_classes=n_classes)
    tr, va = slice(0, 14), slice(14, 24)  # 14 train samples pad to 16: 2 batches
    bsz, epochs = 8, 3
    kw = dict(learning_rate=lr, weight_decay=0.01, batch_size=bsz, max_epochs=epochs,
              patience=100, seed=0)

    jt = JTrainer(jmodel_fn(), n_classes, **kw)
    jt.init(x[tr])
    variables = {"params": jax.tree.map(np.array, jt.params)}
    res = jt.fit(x[tr], y[tr], x[va], y[va])

    tt = ClassifierTrainer(tmodel_fn(), n_classes, device="cpu", **kw)
    tt.init(x[tr])
    load_flax_variables(tt.model, variables)
    data = tt._device_data(x[tr], y[tr], x[va], y[va])
    n = data.x.shape[0]
    for epoch, perm in enumerate(_jax_perms(0, n, n // bsz, epochs)):
        got = tt._epoch(torch.tensor(perm, dtype=torch.long), data).tolist()
        want = [res.history[epoch][k] for k in HISTORY_KEYS]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"epoch {epoch}")

    as_state = lambda tree: flax_to_state_dict(  # noqa: E731
        {"params": jax.tree.map(np.asarray, tree)}, tt.model)
    want, init, got = as_state(jt.params), as_state(variables["params"]), tt.params
    for k in want:
        g, w, i0 = got[k].numpy(), want[k].numpy(), init[k].numpy()
        if strict:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=k)
        else:
            err = np.linalg.norm((g - i0) - (w - i0)) / np.linalg.norm(w - i0)
            assert err <= 2e-2, (k, err)


# ----------------------------------------------------------------------
def test_early_stopping_bookkeeping():
    es = ES_START
    # improve, improve, worse, equal (not an improvement), worse -> stop
    for epoch, loss in enumerate([1.0, 0.5, 0.7, 0.5, 0.9]):
        es = early_stopping_update(es, loss, epoch, patience=2)
    assert es == (0.5, 1, 3, True)
    assert early_stopping_update(es, 0.1, 5, 2) == es  # frozen once stopped
    nan = early_stopping_update(ES_START, float("nan"), 0, 0)
    assert nan == (float("inf"), -1, 1, True)  # NaN never improves


def _trainer(model, max_epochs, patience=100, **kw):
    return ClassifierTrainer(model, n_classes=3, learning_rate=2e-3, batch_size=16,
                             max_epochs=max_epochs, patience=patience, seed=0,
                             device="cpu", **kw)


def test_fit_stops_early_by_the_jax_rules():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((80, 4, 16)).astype(np.float32)
    y = rng.integers(0, 3, 80).astype(np.int32)  # random labels: val loss rises
    t = ClassifierTrainer(simple.LogisticRegressionClassifier(64, 3), n_classes=3,
                          learning_rate=0.05, batch_size=16, max_epochs=40, patience=1,
                          seed=0, device="cpu")
    res = t.fit(x[:64], y[:64], x[64:], y[64:])
    assert res.stopped_early and len(res.history) < 40
    es = ES_START
    for row in res.history:
        es = early_stopping_update(es, np.float32(row["val/loss"]), row["epoch"], 1)
    assert es[3] and es[1] == res.best_epoch
    assert [r["epoch"] for r in res.history] == list(range(len(res.history)))


def _dropout_mlp():
    """A small model with the port's dropout, so that a resumed fit must
    also continue the dropout generator."""
    return nn.Sequential(nn.Flatten(), nn.Linear(64, 32), nn.ReLU(), Dropout(0.5),
                         nn.Linear(32, 3))


def _equal_fits(a, b):
    assert len(a.history) == len(b.history)
    for r1, r2 in zip(a.history, b.history):
        assert r1 == r2
    assert (a.best_epoch, a.stopped_early) == (b.best_epoch, b.stopped_early)


@pytest.mark.parametrize("model_fn,kw", [
    (lambda: simple.LogisticRegressionClassifier(64, 3), {}),
    (_dropout_mlp, {}),
    (lambda: simple.LogisticRegressionClassifier(64, 3), {"moment_dtype": "bfloat16"}),
], ids=["logistic", "dropout_mlp", "bf16_moments"])
def test_resume_matches_uninterrupted(model_fn, kw, tmp_path):
    x, y = _separable_data(np.random.default_rng(0))
    tr, va = slice(0, 64), slice(64, 96)
    full = _trainer(model_fn(), 10, **kw)
    res_full = full.fit(x[tr], y[tr], x[va], y[va])

    ckpt = str(tmp_path / "state")
    _trainer(model_fn(), 5, **kw).fit(x[tr], y[tr], x[va], y[va], checkpoint_dir=ckpt)
    second = _trainer(model_fn(), 10, **kw)
    res = second.fit(x[tr], y[tr], x[va], y[va], checkpoint_dir=ckpt, resume=True)

    _equal_fits(res_full, res)
    for k, v in full.params.items():
        assert torch.equal(v, second.params[k]), k
    if kw:
        assert all(m.dtype == torch.bfloat16 for m in second.optimizer.mu)


def test_checkpoint_every_segments_match_plain_fit(tmp_path):
    x, y = _separable_data(np.random.default_rng(0))
    tr, va = slice(0, 64), slice(64, 96)
    model = lambda: simple.LogisticRegressionClassifier(64, 3)  # noqa: E731
    plain = _trainer(model(), 9).fit(x[tr], y[tr], x[va], y[va])
    seg = _trainer(model(), 9).fit(x[tr], y[tr], x[va], y[va],
                                   checkpoint_dir=str(tmp_path / "seg"), checkpoint_every=3)
    _equal_fits(plain, seg)


def test_optimizer_moments_actually_resume(tmp_path):
    """A params-only restart (fresh moments and generators) takes another
    trajectory than the full resume."""
    x, y = _separable_data(np.random.default_rng(0))
    tr, va = slice(0, 64), slice(64, 96)
    model = lambda: simple.ShallowNNClassifier(64, 3, hidden_dim=16)  # noqa: E731
    ckpt = str(tmp_path / "state")
    first = _trainer(model(), 5)
    first.fit(x[tr], y[tr], x[va], y[va], checkpoint_dir=ckpt)
    full = _trainer(model(), 10).fit(x[tr], y[tr], x[va], y[va], checkpoint_dir=ckpt,
                                     resume=True)
    broken = _trainer(model(), 5)
    broken.init()
    broken.params = first.params
    res_broken = broken.fit(x[tr], y[tr], x[va], y[va])
    full_tail = [r["train/loss"] for r in full.history[5:]]
    broken_tail = [r["train/loss"] for r in res_broken.history]
    assert not np.allclose(full_tail, broken_tail, rtol=1e-6)


def test_early_stop_state_rides_checkpoint(tmp_path):
    x, y = _separable_data(np.random.default_rng(2))
    y[64:] = (y[64:] + 1) % 3  # validation labels disagree: it stops
    tr, va = slice(0, 64), slice(64, 96)
    model = lambda: simple.LogisticRegressionClassifier(64, 3)  # noqa: E731
    full = _trainer(model(), 14, patience=1).fit(x[tr], y[tr], x[va], y[va])
    ckpt = str(tmp_path / "es_state")
    _trainer(model(), 7, patience=1).fit(x[tr], y[tr], x[va], y[va], checkpoint_dir=ckpt)
    res = _trainer(model(), 14, patience=1).fit(x[tr], y[tr], x[va], y[va],
                                                checkpoint_dir=ckpt, resume=True)
    assert full.stopped_early
    _equal_fits(full, res)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed_chunk", [None, 2])
def test_seed_loop_equals_sequential_trainer(seed_chunk):
    rng = np.random.default_rng(3)
    seeds = [3, 5, 8]
    x, y = _separable_data(rng, n=60)
    splits = [rng.permutation(60) for _ in seeds]
    parts = [(s[:40], s[40:50], s[50:]) for s in splits]
    stack = lambda a, i: np.stack([a[p[i]] for p in parts])  # noqa: E731
    kw = dict(n_classes=3, learning_rate=2e-3, batch_size=16, max_epochs=4, patience=100,
              device="cpu")
    spt = SeedParallelTrainer(_dropout_mlp(), seeds=seeds, seed_chunk=seed_chunk, **kw)
    results = spt.fit_eval(stack(x, 0), stack(y, 0), stack(x, 1), stack(y, 1),
                           stack(x, 2), stack(y, 2))
    assert [r.seed for r in results] == seeds
    for seed, (tr, va, te), r in zip(seeds, parts, results):
        t = ClassifierTrainer(_dropout_mlp(), seed=seed, **kw)
        fit = t.fit(x[tr], y[tr], x[va], y[va])
        assert r.history == fit.history and r.best_epoch == fit.best_epoch
        np.testing.assert_array_equal(r.test_preds, t.predict(x[te]))
        np.testing.assert_array_equal(r.test_true, y[te])
        assert r.n_params == t.n_params()
        for k, v in t.params.items():
            assert torch.equal(v, r.params[k]), k


def test_jax_only_keys_change_nothing(capsys):
    """The JAX trainer's scan_unroll is accepted and changes no result, as
    does mesh=None (the one-device layout; a mesh makes the fit
    data-parallel, tests/test_torch_distributed.py); any other key is
    refused, seed_chunk too: as in JAX it is SeedParallelTrainer's, where
    it bounds a batched fit (tests/test_torch_seed_parallel.py)."""
    x, y = _separable_data(np.random.default_rng(4), n=64)
    plain = _trainer(_dropout_mlp(), 3).fit(x[:48], y[:48], x[48:], y[48:])
    keyed = _trainer(_dropout_mlp(), 3, mesh=None, scan_unroll=4)
    assert capsys.readouterr().out == ""
    _equal_fits(plain, keyed.fit(x[:48], y[:48], x[48:], y[48:]))
    for key in ("no_such_key", "seed_chunk"):
        with pytest.raises(TypeError, match=key):
            _trainer(_dropout_mlp(), 3, **{key: 1})
