"""The port's multi-device layer across processes: gloo ranks on the CPU,
joined through a file store (``init_method="file://..."``, so no port is
chosen), one torch thread each, each spawn bounded by a timeout.

- A 2-rank ``ClassifierTrainer`` fit (a padded last batch: 14 rows in
  batches of 8) fed the JAX fit's replayed permutations, held against
  JAX's trainer on ``make_mesh(2)`` (8 virtual CPU devices,
  ``tests/conftest.py``) at ``tests/test_parallel.py``'s tolerance, loss
  curves rel 1e-4 (abs 1e-5), and the logistic model's final parameters at
  rtol 1e-4, atol 1e-6 (``tests/test_torch_fit.py``).
- The same fit against the port's one-rank fit, and a 2-rank fit with
  dropout 0.5 against the one-rank fit: each rank draws the global
  batch's masks, so only the f32 order of the gradient sums differs
  (two half-batch sums added vs one sum), held at rel 1e-5 (abs 1e-6)
  per epoch metric and at rtol 1e-4, atol 1e-6 per parameter.
- A SynthesisLite step with the global batch's batch-norm statistics
  against the JAX synthesis trainer's step on a ``make_mesh(2)``-sharded
  batch: loss and MCD rel 1e-5, running statistics rtol 1e-5, parameters
  under ``tests/test_torch_synthesis.py``'s rule (within rtol 1e-4 /
  atol 1e-6, except elements whose gradient is below 1e-6, where NAdam's
  first step follows the last digits of the sum; those stay within 1.5
  learning rates).
- A 2-rank ``SynthesisTrainer.train`` of SynthesisLite (dropout 0.3,
  batch norm, 21 rows padded to 24) and its ``evaluate`` against the
  one-rank fit: per-epoch loss and MCD and the test MCD at rel 1e-4 (abs
  1e-5), the test mels at rel 2e-4 (measured: 5e-5; float32 NAdam turns
  the summation order of near-zero gradients, such as those of the biases
  before the batch norms, into steps either way, and nine steps carry
  that into the weights).
- On 4 ranks, the 2x2 ("data", "model") column-parallel steps of the CNN
  and of SynthesisLite (dropout on, the same masks) against the replicated
  step: two NAdam steps, losses rel 1e-5; every parameter within two
  steps' bound (3 learning rates) of the replicated one, and each tensor's
  total update within a relative L2 error of 1e-3, except tensors whose
  gradient is zero up to rounding (below 1e-6 everywhere: the biases
  before SynthesisLite's batch norm), whose steps follow the rounding.
- Both packages' ``train_classifier.run`` and ``evaluation`` over 2
  subjects: the port on 2 ranks (each one subject) and JAX in one
  process. The merged ``results.csv`` rows equal the port's one-process
  rows exactly (any order), and JAX's in every column that does not depend
  on the initial weights (JAX and torch draw them differently); the
  evaluation rows equal training's. Under ``parallel: {data: 2}`` (every
  subject in lockstep, data-parallel fits) the rows name the same runs and
  the accuracies stay within 0.05 of the one-process run's.
- A 2-rank ``TonalDecoder.decode`` of an odd batch equal to one rank's:
  ids equal, probabilities and mels within 1e-5.
- ``initialize`` from the JAX package's environment variables.
"""

import copy
import csv
import datetime
import functools
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from decode_tonal_langauge_tpu_torch.models.base import init_params
from decode_tonal_langauge_tpu_torch.models.deep import CNNClassifier
from decode_tonal_langauge_tpu_torch.models.simple import LogisticRegressionClassifier
from decode_tonal_langauge_tpu_torch.models.synthesis import SynthesisLite
from decode_tonal_langauge_tpu_torch.ops.dropout import Dropout, set_dropout_generator
from decode_tonal_langauge_tpu_torch.parallel import distributed
from decode_tonal_langauge_tpu_torch.parallel.mesh import all_gather, make_mesh
from decode_tonal_langauge_tpu_torch.parallel.train_step import (
    build_sharded_classifier_step,
    build_sharded_synthesis_step,
    dense_head_sharding,
)
from decode_tonal_langauge_tpu_torch.serving import TonalDecoder
from decode_tonal_langauge_tpu_torch.training.optim import NAdam
from decode_tonal_langauge_tpu_torch.training.synthesis_trainer import SynthesisTrainer
from decode_tonal_langauge_tpu_torch.training.trainer import HISTORY_KEYS, ClassifierTrainer

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
SPAWN_TIMEOUT_S = 300
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")

MAPPING = {"0": [5, 5, 5], "1": [3, 4, 5], "2": [3, 2, 3], "3": [5, 3, 1]}
C_NON, C_CLS, T_SYN, MEL = 5, 3, 64, 32
NEAR_ZERO_GRAD, MAX_STEP = 1e-6, 1.5


# ----------------------------------------------------------------------
# Spawning ranks.
def _spawn(tmp, world, inputs, env=None):
    """Run :func:`_worker` in ``world`` processes (rank r runs every case
    of ``inputs``); returns each rank's outputs. A non-zero exit or a
    timeout fails the test."""
    os.makedirs(tmp, exist_ok=True)
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    base = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    base.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([TESTS, ROOT]))
    procs = []
    for rank in range(world):
        code = ("import test_torch_distributed as t; "
                f"t._worker({rank}, {world}, {str(tmp)!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=tmp,
            env=dict(base, **env(rank)) if env else base,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of {world} did not finish in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    timeout = datetime.timedelta(seconds=SPAWN_TIMEOUT_S)
    if inputs.get("init") == "env":
        distributed.initialize(device="cpu", timeout=timeout)
    else:
        distributed.initialize(f"file://{tmp}/store", world, rank, device="cpu",
                               timeout=timeout)
    out = {name: _CASES[name](rank, world, case) for name, case in inputs["cases"].items()}
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    dist.destroy_process_group()


# ----------------------------------------------------------------------
# What the ranks run.
def _dropout_mlp(n_in=64, n_classes=3):
    return nn.Sequential(nn.Flatten(), nn.Linear(n_in, 32), nn.ReLU(), Dropout(0.5),
                         nn.Linear(32, n_classes))


def _replayed_fit(model, state, case, mesh):
    """The fit's epochs in the given permutations from the given weights;
    returns (history rows, final state dict)."""
    t = ClassifierTrainer(model, case["n_classes"], device="cpu", mesh=mesh, **case["kw"])
    t.init()
    t.model.load_state_dict(state)
    data = t._device_data(*case["data"])
    rows = [t._epoch(torch.tensor(p, dtype=torch.long), data).tolist()
            for p in case["perms"]]
    return rows, t.params


def _case_fit_jax(rank, world, case):
    return _replayed_fit(LogisticRegressionClassifier(64, 3), case["state"], case,
                         make_mesh(world))


def _case_fit_dropout(rank, world, case):
    t = ClassifierTrainer(_dropout_mlp(), 3, device="cpu", mesh=make_mesh(world),
                          **case["kw"])
    res = t.fit(*case["data"])
    return res.history, t.params, t.batch_size


def _synthesis_trainer(mesh, state, dropout=0.0):
    tone = init_params(LogisticRegressionClassifier(C_CLS * T_SYN, 4), 1)
    syll = init_params(LogisticRegressionClassifier(C_CLS * T_SYN, 2), 2)
    t = SynthesisTrainer(SynthesisLite(MEL, C_NON, T_SYN, dropout=dropout), tone, syll,
                         MAPPING, learning_rate=1e-3, verbose=False, device="cpu", mesh=mesh)
    t.init()
    t.model.load_state_dict(state)
    return t


def _synthesis_fit(mesh, case):
    """Three epochs of SynthesisLite from the case's weights, then the
    test set: (history, test MCD, test mels)."""
    t = _synthesis_trainer(mesh, case["state"], dropout=0.3)
    history = t.train(case["train"], epochs=3, batch_size=8, verbose=False)
    mcd, recon, _ = t.evaluate(case["test"], batch_size=8)
    return history, mcd, recon


def _case_synthesis_fit(rank, world, case):
    return _synthesis_fit(make_mesh(world), case)


def _case_synthesis_step(rank, world, case):
    t = _synthesis_trainer(make_mesh(world), case["state"])
    batch = [torch.as_tensor(a) for a in case["batch"]]
    rows = t._layout.rows(batch[0].shape[0])
    loss, mcd = t.train_step(*(a[rows] for a in batch), batch[3].sum())
    return loss.item(), mcd.item(), t.params


def _sharded_steps(model, build, batch, mesh, n_steps=2):
    """``n_steps`` steps of ``build``'s step from a dropout generator
    seeded 1; returns the losses and the whole parameters (the sharded
    ones gathered over the ``model`` axis)."""
    set_dropout_generator(model, torch.Generator().manual_seed(1))
    step = build(model, functools.partial(NAdam, learning_rate=1e-3), mesh)
    losses = [step(*batch).item() for _ in range(n_steps)]
    placements = dense_head_sharding(mesh, model) if mesh is not None else {}
    params = {}
    for name, p in model.named_parameters():
        sharded = placements.get(name) is not None and placements[name].is_shard()
        params[name] = (all_gather(mesh, p.detach(), "model") if sharded else p.detach()).clone()
    return losses, params


def _case_head_2x2(rank, world, case):
    mesh = make_mesh(world, ("data", "model"), (2, 2))
    out = {}
    for name, make, build, arrays in (
        ("cnn", lambda: CNNClassifier(2, 128, 4), build_sharded_classifier_step, case["cnn"]),
        ("lite", lambda: SynthesisLite(MEL, C_NON, T_SYN, dropout=0.3),
         build_sharded_synthesis_step, case["lite"]),
    ):
        batch = [torch.as_tensor(a) for a in arrays]
        model = init_params(make(), 0)
        ref = copy.deepcopy(model)
        init = {k: v.detach().clone() for k, v in ref.named_parameters()}
        probe = copy.deepcopy(ref).train()
        set_dropout_generator(probe, torch.Generator().manual_seed(1))
        if name == "cnn":
            loss = nn.functional.cross_entropy(probe(batch[0]), batch[1])
        else:
            loss = (probe(batch[0], batch[1]) - batch[2]).abs().mean()
        grads = dict(zip([k for k, _ in probe.named_parameters()],
                         torch.autograd.grad(loss, list(probe.parameters()))))
        out[name] = {"sharded": _sharded_steps(model, build, batch, mesh),
                     "plain": _sharded_steps(ref, build, batch, None),
                     "grads": grads, "init": init}
    return out


def _case_stage(rank, world, case):
    from decode_tonal_langauge_tpu_torch.evaluation import main as evaluation
    from decode_tonal_langauge_tpu_torch.training import train_classifier

    training_dir = train_classifier.run(case["config"], device="cpu")
    distributed.barrier("test:training")
    eval_dir = evaluation.run({"evaluation": {"module": "evaluation_main", "params": {
        "io": {"training_dir": training_dir, "sample_dir": case["sample_dir"]}}}},
        device="cpu")
    return training_dir, eval_dir


def _case_decode(rank, world, case):
    decoder = _decoder(case["states"], make_mesh(world))
    return decoder.decode(case["ecog"], case["channels"])


def _case_env(rank, world, case):
    t = torch.ones(3)
    dist.all_reduce(t)
    return (distributed.process_index(), distributed.process_count(), t.tolist(),
            distributed.host_shard(["s0", "s1", "s2", "s3", "s4"]))


_CASES = {"fit_jax": _case_fit_jax, "fit_dropout": _case_fit_dropout,
          "synthesis_fit": _case_synthesis_fit,
          "synthesis_step": _case_synthesis_step, "head_2x2": _case_head_2x2,
          "stage": _case_stage, "decode": _case_decode, "env": _case_env}


# ----------------------------------------------------------------------
# Inputs and references in the test process.
def _separable(rng, n, c=4, t=16, n_classes=3):
    y = rng.integers(0, n_classes, n).astype(np.int64)
    x = rng.standard_normal((n, c, t)).astype(np.float32)
    for k in range(n_classes):
        x[y == k, k % c, :] += 2.0
    return x, y


def _jax_perms(seed, n, n_batches, epochs):
    """Each epoch's permutation from the JAX fit's key chain: per epoch one
    split for the permutation, then one per batch for dropout."""
    import jax

    rng = jax.random.key(seed)
    perms = []
    for _ in range(epochs):
        rng, perm_rng = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(perm_rng, n)))
        for _ in range(n_batches):
            rng, _ = jax.random.split(rng)
    return perms


def _fit_jax_case():
    """JAX's meshed fit of the logistic model and the port's inputs for
    replaying it."""
    import jax

    from decode_tonal_langauge_tpu.models import simple as jsimple
    from decode_tonal_langauge_tpu.parallel.mesh import make_mesh as jmake_mesh
    from decode_tonal_langauge_tpu.training.trainer import ClassifierTrainer as JTrainer
    from decode_tonal_langauge_tpu_torch.convert import load_flax_variables

    x, y = _separable(np.random.default_rng(0), 24)
    tr, va = slice(0, 14), slice(14, 24)  # 14 train rows pad to 16: 2 batches of 8
    kw = dict(learning_rate=2e-3, weight_decay=0.01, batch_size=8, max_epochs=3,
              patience=100, seed=0)
    jt = JTrainer(jsimple.LogisticRegressionClassifier(input_dim=64, n_classes=3), 3,
                  mesh=jmake_mesh(2), **kw)
    jt.init(x[tr])
    model = load_flax_variables(LogisticRegressionClassifier(64, 3),
                                {"params": jax.tree.map(np.array, jt.params)})
    state = {k: v.clone() for k, v in model.state_dict().items()}
    res = jt.fit(x[tr], y[tr], x[va], y[va])
    want = [[r[k] for k in HISTORY_KEYS] for r in res.history]
    final = {"params": jax.tree.map(np.asarray, jt.params)}
    final_state = load_flax_variables(LogisticRegressionClassifier(64, 3), final).state_dict()
    case = {"state": state, "n_classes": 3, "kw": kw,
            "data": (x[tr], y[tr], x[va], y[va]), "perms": _jax_perms(0, 16, 2, 3)}
    return case, want, final_state


def _synthesis_case():
    """One SynthesisLite step of the JAX synthesis trainer on a batch
    sharded over ``make_mesh(2)``: (inputs, loss, mcd, state after)."""
    import jax
    import jax.numpy as jnp

    from decode_tonal_langauge_tpu.models import synthesis as jsyn
    from decode_tonal_langauge_tpu.models.simple import LogisticRegressionClassifier as JLog
    from decode_tonal_langauge_tpu.parallel.mesh import make_mesh as jmake_mesh
    from decode_tonal_langauge_tpu.training import synthesis_trainer as jst
    from decode_tonal_langauge_tpu_torch.convert import flax_to_state_dict, load_flax_variables

    rng = np.random.default_rng(5)
    n = 8
    ecog = rng.standard_normal((n, C_NON, T_SYN)).astype(np.float32)
    labels = np.stack([rng.integers(0, 2, (n, 3)), rng.integers(1, 6, (n, 3))],
                      axis=1).astype(np.float32)
    mels = (ecog.mean(axis=(1, 2))[:, None] - 30.0
            + 0.05 * rng.standard_normal((n, MEL))).astype(np.float32)
    ecog[5:], mels[5:] = ecog[0], mels[0]  # three padding rows, split 4 + 1 between ranks
    w = np.array([1] * 5 + [0] * 3, np.float32)
    xc = np.zeros((1, C_CLS, T_SYN), np.float32)
    jt, js = JLog(input_dim=C_CLS * T_SYN, n_classes=4), JLog(input_dim=C_CLS * T_SYN,
                                                               n_classes=2)
    tv = jax.tree.map(np.asarray, jt.init({"params": jax.random.key(0)}, xc, train=False))
    sv = jax.tree.map(np.asarray, js.init({"params": jax.random.key(1)}, xc, train=False))
    mesh = jmake_mesh(2)
    jtrainer = jst.SynthesisTrainer(
        jsyn.SynthesisLite(output_dim=MEL, n_channels=C_NON, n_timepoints=T_SYN, dropout=0.0),
        jt, tv, js, sv, MAPPING, learning_rate=1e-3, seed=0, verbose=False, mesh=mesh)
    jtrainer.init(ecog, 3, target_mean=mels[:5].mean(axis=0))
    variables = {"params": jax.tree.map(np.asarray, jtrainer.params),
                 "batch_stats": jax.tree.map(np.asarray, jtrainer.batch_stats)}
    model = load_flax_variables(SynthesisLite(MEL, C_NON, T_SYN, dropout=0.0), variables)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    stacks = jtrainer._layout.place_stacks(
        *(jnp.asarray(a)[None] for a in (ecog, labels, mels, w)))
    params, stats, _, _, loss, mcd = jax.jit(jtrainer._train_epoch_inner)(
        jtrainer.params, jtrainer.batch_stats, jtrainer.opt_state, jax.random.key(0), stacks)
    after = flax_to_state_dict({"params": jax.tree.map(np.asarray, params),
                                "batch_stats": jax.tree.map(np.asarray, stats)}, model)
    probe = copy.deepcopy(model).train()
    t = [torch.as_tensor(a) for a in (ecog, labels, mels, w)]
    out = probe(t[0], t[1])
    l1 = ((out - t[2]).abs().mean(1) * t[3]).sum() / t[3].sum()
    grads = dict(zip([k for k, _ in probe.named_parameters()],
                     torch.autograd.grad(l1, list(probe.parameters()))))
    case = {"state": state, "batch": (ecog, labels, mels, w)}
    return case, float(loss), float(mcd), after, grads, state


def _assert_step_rule(got, want, grads, before, lr, decay=0.0):
    """Parameters within rtol 1e-4 / atol 1e-6, except elements whose
    (decayed) gradient is below NEAR_ZERO_GRAD, which stay within
    MAX_STEP learning rates (module docstring)."""
    for k, g in grads.items():
        g = (g + decay * before[k]).numpy()
        a, b = got[k].numpy(), want[k].numpy()
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-6)
        assert (np.abs(g[off]) < NEAR_ZERO_GRAD).all(), (k, int(off.sum()))
        assert (np.abs(a - b)[off] <= MAX_STEP * lr).all(), k


def _assert_two_step_rule(got, want, grads, init, lr):
    """Two NAdam steps: every element within 2 * MAX_STEP learning rates,
    each tensor's update within relative L2 1e-3 unless its gradient is
    below NEAR_ZERO_GRAD everywhere (module docstring)."""
    for k, g in grads.items():
        a, b, i0 = got[k].numpy(), want[k].numpy(), init[k].numpy()
        assert np.abs(a - b).max() <= 2 * MAX_STEP * lr, k
        if np.abs(g.numpy()).max() >= NEAR_ZERO_GRAD:
            err = np.linalg.norm(a - b) / np.linalg.norm(b - i0)
            assert err <= 1e-3, (k, err)


def _synthesis_data(rng, n):
    """(ecog_non, ecog_syll, ecog_tone, mels) of ``n`` trials."""
    mels = (rng.standard_normal((n, MEL)) * 0.5 - 30.0).astype(np.float32)
    return (rng.standard_normal((n, C_NON, T_SYN)).astype(np.float32),
            rng.standard_normal((n, C_CLS, T_SYN)).astype(np.float32),
            rng.standard_normal((n, C_CLS, T_SYN)).astype(np.float32), mels)


def _decoder_states():
    tone = init_params(LogisticRegressionClassifier(C_CLS * T_SYN, 4), 1)
    syll = init_params(LogisticRegressionClassifier(C_CLS * T_SYN, 2), 2)
    syn = init_params(SynthesisLite(MEL, C_NON, T_SYN), 3)
    with torch.no_grad():
        syn.bn1.running_mean.uniform_(-0.1, 0.1)
        syn.bn2.running_var.uniform_(0.5, 1.5)
    return [m.state_dict() for m in (tone, syll, syn)]


def _decoder(states, mesh=None):
    models = [LogisticRegressionClassifier(C_CLS * T_SYN, 4),
              LogisticRegressionClassifier(C_CLS * T_SYN, 2),
              SynthesisLite(MEL, C_NON, T_SYN)]
    for m, s in zip(models, states):
        m.load_state_dict(s)
    return TonalDecoder(models[0], models[1], MAPPING, synthesis_model=models[2],
                        device="cpu", mesh=mesh)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One 2-rank spawn for the fits, the synthesis step and the decode;
    returns (the ranks' outputs, the references)."""
    fit_case, jax_history, jax_final = _fit_jax_case()
    syn_case, *syn_ref = _synthesis_case()
    x, y = _separable(np.random.default_rng(1), 40)
    drop_case = {"data": (x[:21], y[:21], x[21:], y[21:]),  # 21 rows pad to 24
                 "kw": dict(learning_rate=5e-3, batch_size=8, max_epochs=4, patience=100,
                            seed=3)}
    rng = np.random.default_rng(2)
    channels = {"tone_discriminative": [5, 6, 7], "syllable_discriminative": [2, 3, 4],
                "active_channels": list(range(C_NON + 2 * C_CLS))}
    decode_case = {"states": _decoder_states(), "channels": channels,
                   "ecog": rng.standard_normal((5, C_NON + 2 * C_CLS, T_SYN)).astype(np.float32)}
    syn_fit_case = {"train": _synthesis_data(np.random.default_rng(6), 21),
                    "test": _synthesis_data(np.random.default_rng(7), 10),
                    "state": init_params(SynthesisLite(MEL, C_NON, T_SYN), 5).state_dict()}
    outs = _spawn(str(tmp_path_factory.mktemp("two_ranks")), 2, {"cases": {
        "fit_jax": fit_case, "fit_dropout": drop_case, "synthesis_step": syn_case,
        "synthesis_fit": syn_fit_case, "decode": decode_case}})
    refs = {"fit_jax": (fit_case, jax_history, jax_final), "fit_dropout": drop_case,
            "synthesis_step": syn_ref, "synthesis_fit": syn_fit_case, "decode": decode_case}
    return outs, refs


# ----------------------------------------------------------------------
def test_two_rank_fit_matches_jax_meshed_fit(two_ranks):
    outs, refs = two_ranks
    case, want, want_final = refs["fit_jax"]
    one_rank = _replayed_fit(LogisticRegressionClassifier(64, 3), case["state"], case, None)
    for rows, params in (out["fit_jax"] for out in outs):
        np.testing.assert_allclose(rows, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(rows, one_rank[0], rtol=1e-5, atol=1e-6)
        for k, v in want_final.items():
            np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    assert outs[0]["fit_jax"][0] == outs[1]["fit_jax"][0]  # one reduced history


def test_two_rank_fit_with_dropout_equals_one_rank_fit(two_ranks):
    outs, refs = two_ranks
    case = refs["fit_dropout"]
    one = ClassifierTrainer(_dropout_mlp(), 3, device="cpu", **case["kw"])
    want = one.fit(*case["data"])
    for history, params, batch_size in (out["fit_dropout"] for out in outs):
        assert batch_size == 8 and len(history) == len(want.history) == 4
        for got_row, want_row in zip(history, want.history):
            np.testing.assert_allclose([got_row[k] for k in HISTORY_KEYS],
                                       [want_row[k] for k in HISTORY_KEYS],
                                       rtol=1e-5, atol=1e-6)
        for k, v in one.params.items():
            np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_synthesis_lite_step_uses_the_global_batch_statistics(two_ranks):
    outs, refs = two_ranks
    loss, mcd, after, grads, before = refs["synthesis_step"]
    for got_loss, got_mcd, params in (out["synthesis_step"] for out in outs):
        assert got_loss == pytest.approx(loss, rel=1e-5, abs=1e-6)
        assert got_mcd == pytest.approx(mcd, rel=1e-5, abs=1e-6)
        for k in after:
            if "running" in k:
                np.testing.assert_allclose(params[k].numpy(), after[k].numpy(), rtol=1e-5,
                                           atol=1e-7, err_msg=k)
        _assert_step_rule(params, after, grads, before, lr=1e-3, decay=0.004)


def test_two_rank_synthesis_fit_follows_the_one_rank_fit(two_ranks):
    outs, refs = two_ranks
    want_history, want_mcd, want_recon = _synthesis_fit(None, refs["synthesis_fit"])
    for history, mcd, recon in (out["synthesis_fit"] for out in outs):
        np.testing.assert_allclose(history, want_history, rtol=1e-4, atol=1e-5)
        assert mcd == pytest.approx(want_mcd, rel=1e-4, abs=1e-5)
        np.testing.assert_allclose(recon, want_recon, rtol=2e-4, atol=1e-5)


def test_two_rank_decode_of_an_odd_batch_equals_one_rank(two_ranks):
    outs, refs = two_ranks
    case = refs["decode"]
    want = _decoder(case["states"]).decode(case["ecog"], case["channels"])
    for got in (out["decode"] for out in outs):
        assert set(got) == set(want) and got["mel"].shape == (5, MEL)
        for k in ("tone", "syllable"):
            np.testing.assert_array_equal(got[k], want[k])
        for k in ("tone_probs", "syllable_probs", "mel"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_column_parallel_head_steps_on_a_2x2_mesh(tmp_path):
    rng = np.random.default_rng(4)
    cnn = (rng.standard_normal((8, 2, 128)).astype(np.float32),
           rng.integers(0, 4, 8).astype(np.int64))
    lite = (rng.standard_normal((8, C_NON, T_SYN)).astype(np.float32),
            rng.standard_normal((8, 2, 3)).astype(np.float32),
            rng.standard_normal((8, MEL)).astype(np.float32))
    outs = _spawn(str(tmp_path), 4, {"cases": {"head_2x2": {"cnn": cnn, "lite": lite}}})
    for out in outs:
        for name, res in out["head_2x2"].items():
            (losses, params), (ref_losses, ref_params) = res["sharded"], res["plain"]
            np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
            assert params["fc1.weight"].shape == ref_params["fc1.weight"].shape
            _assert_two_step_rule(params, ref_params, res["grads"], res["init"], lr=1e-3)


def _stage_samples(root):
    rng = np.random.default_rng(7)
    n = 64
    syll, tone = np.tile([0, 1], n // 2), np.repeat([0, 1, 2, 3], n // 4)
    d = os.path.join(root, "samples")
    os.makedirs(d)
    for sid in (1, 2):
        x = rng.standard_normal((n, 6, 10)).astype(np.float32)
        x[syll == 1, :3] += 3.0 * (1 if sid == 1 else -1)
        x[tone == 2, 3:] += 3.0
        np.savez(os.path.join(d, f"subject_{sid}.npz"), ecog=x, ecog_sf=100.0,
                 syllable=syll, tone=tone)
    return d


def _stage_config(root, sample_dir, parallel=None):
    cfg = {
        "model": {"model": "models.simple_classifiers.LogisticRegressionClassifier",
                  "model_name": "logistic", "model_kwargs": {}},
        "training": {"module": "train_classifier", "params": {
            "io": {"log_dir": os.path.join(root, "logs"), "sample_dir": sample_dir},
            "experiment": {"targets": ["syllable", "tone"], "features": "ecog",
                           "separate_models": True, "seed": 42, "repeat": 2, "verbose": 0},
            "training": {"train_ratio": 0.6, "vali_ratio": 0.2, "test_ratio": 0.2,
                         "batch_size": 8, "epochs": 6, "lr": 0.01, "standardize": True,
                         "patience": 6, "save_checkpoints": True},
        }},
        "evaluation": {"metrics": ["accuracy", "f1_score", "confusion_matrix"]},
    }
    if parallel:
        cfg["parallel"] = parallel
    return cfg


def _csv_rows(path):
    with open(os.path.join(path, "results.csv"), newline="") as f:
        return list(csv.DictReader(f))


_WEIGHT_FREE = ("model_name", "model_size", "subject", "target", "channels", "seeds")


def _key(row):
    return row["subject"], row["target"]


def test_two_rank_stages_merge_the_one_process_rows(tmp_path):
    from decode_tonal_langauge_tpu.training import train_classifier as jstage
    from decode_tonal_langauge_tpu_torch.training import train_classifier

    root = str(tmp_path)
    sample_dir = _stage_samples(root)
    jdir = jstage.run(_stage_config(root, sample_dir))
    jax_rows = _csv_rows(jdir)
    shutil.move(os.path.join(root, "logs"), os.path.join(root, "jax_logs"))
    one_dir = train_classifier.run(_stage_config(root, sample_dir), device="cpu")
    one = _csv_rows(one_dir)
    shutil.move(os.path.join(root, "logs"), os.path.join(root, "one_logs"))

    outs = _spawn(os.path.join(root, "sharded"), 2, {"cases": {"stage": {
        "config": _stage_config(root, sample_dir), "sample_dir": sample_dir}}})
    training_dir, eval_dir = outs[0]["stage"]
    assert [o["stage"] for o in outs] == [outs[0]["stage"]] * 2
    assert os.path.basename(training_dir) == os.path.basename(one_dir)
    got = _csv_rows(training_dir)
    assert not [f for f in os.listdir(training_dir) if f.startswith("results.process")]
    assert sorted(map(_key, got)) == sorted(map(_key, one)) and len(got) == 6
    assert sorted(got, key=_key) == sorted(one, key=_key)
    assert sorted(_csv_rows(eval_dir), key=_key) == sorted(got, key=_key)
    for g, j in zip(sorted(got, key=_key), sorted(jax_rows, key=_key)):
        assert {c: g[c] for c in _WEIGHT_FREE} == {c: j[c] for c in _WEIGHT_FREE}
    shutil.move(os.path.join(root, "logs"), os.path.join(root, "sharded_logs"))

    outs = _spawn(os.path.join(root, "lockstep"), 2, {"cases": {"stage": {
        "config": _stage_config(root, sample_dir, {"data": 2}), "sample_dir": sample_dir}}})
    lock = sorted(_csv_rows(outs[0]["stage"][0]), key=_key)
    assert os.path.isdir(os.path.join(outs[0]["stage"][0], ".process1"))
    assert [{c: r[c] for c in _WEIGHT_FREE} for r in lock] == \
        [{c: r[c] for c in _WEIGHT_FREE} for r in sorted(one, key=_key)]
    for g, w in zip(lock, sorted(one, key=_key)):
        assert float(g["accuracy_mean"]) == pytest.approx(float(w["accuracy_mean"]), abs=0.05)
    assert sorted(_csv_rows(outs[0]["stage"][1]), key=_key) == lock


def test_initialize_from_the_jax_environment_variables(tmp_path):
    env = lambda rank: {"JAX_COORDINATOR_ADDRESS": f"file://{tmp_path}/env_store",  # noqa: E731
                        "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(rank)}
    outs = _spawn(str(tmp_path), 2, {"init": "env", "cases": {"env": {}}}, env=env)
    assert [o["env"] for o in outs] == [
        (0, 2, [2.0, 2.0, 2.0], ["s0", "s2", "s4"]),
        (1, 2, [2.0, 2.0, 2.0], ["s1", "s3"]),
    ]
