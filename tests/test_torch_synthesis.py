"""The port's synthesizer training against the JAX package's.

The same seeded numpy inputs, and the JAX initial weights carried across
with ``convert.py``, go through both packages on the CPU. Tolerances:

- NAdam without a decay mask: rtol 1e-5 / atol 1e-7 on parameters and
  moments (``tests/test_torch_training.py``: the same float32 operations,
  bias corrections one ulp apart at most);
- SynthesisLite in train mode: outputs atol 2e-5 / rtol 1e-5 (the model
  oracle's, ``tests/test_torch_models.py``), running mean and variance
  rtol 1e-5 / atol 1e-7 (a mean over a batch, summed in another order);
- frozen dynamics: equal arrays;
- one train step: loss and MCD rtol 1e-5 / atol 1e-6, the updated
  parameters rtol 1e-4 / atol 1e-6 with ``test_torch_training.py``'s
  exemption for elements whose gradient is within 1e-6 of zero (NAdam's
  step there follows the last digits of a cancelling sum);
- a 3-epoch fit fed JAX's permutations: per-epoch (loss, MCD) and
  ``evaluate``'s MCD rtol 1e-4 / atol 1e-5 (``tests/test_torch_fit.py``),
  its mels rtol 1e-4 / atol 1e-4 (values of order 30: a few ulps).
  SynthesisModelCNN is held so for its first epoch only, and after it at
  rtol 2e-2 (mels rtol 2e-2), for this reason: its first NAdam step moves
  165 of its 1.85 M elements (those whose gradient is within 1e-6 of
  zero, the exemption above) up to a whole step apart, and under the sign
  gradients of the L1 loss the two trajectories separate from there: 66 k
  elements off after the second step, 1.08 M after the sixth, the loss
  2.7e-3 apart (lr 2e-3). At lr 5e-4 the epochs after the first lie 2.2e-3
  and 8.2e-3 apart, ``evaluate``'s MCD 4.5e-4 and its mels ~3e-3 relative
  (measured on the CPU while writing this test).

Port-only tests (resume, checkpoint segments, the seed loop) hold the port
to itself, where results must be equal.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from decode_tonal_langauge_tpu.models import synthesis as jsyn
from decode_tonal_langauge_tpu.models.simple import (
    LogisticRegressionClassifier as JLogistic,
)
from decode_tonal_langauge_tpu.models.simple import ShallowNNClassifier as JShallow
from decode_tonal_langauge_tpu.runtime.checkpoint import save_params as jsave_params
from decode_tonal_langauge_tpu.training import synthesis_trainer as jst
from decode_tonal_langauge_tpu.training import train_synthesizer as jstage
from decode_tonal_langauge_tpu.training.optim import with_moment_dtype
from decode_tonal_langauge_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from decode_tonal_langauge_tpu_torch.data.splits import split_indices
from decode_tonal_langauge_tpu_torch.models import synthesis
from decode_tonal_langauge_tpu_torch.models.factory import get_classifier_by_name
from decode_tonal_langauge_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from decode_tonal_langauge_tpu_torch.training import train_synthesizer
from decode_tonal_langauge_tpu_torch.training.optim import NAdam
from decode_tonal_langauge_tpu_torch.training.synthesis_trainer import (
    SynthesisTrainer,
    _with_output_bias,
    compute_mcd,
    seed_loop_fit_eval,
)
from decode_tonal_langauge_tpu_torch.utils.audio import compare_mels
from decode_tonal_langauge_tpu_torch.utils.visualise import plot_training_losses

MAPPING = {"0": [5, 5, 5], "1": [3, 4, 5], "2": [3, 2, 3], "3": [5, 3, 1]}
C_NON, C_CLS, T, MEL = 5, 3, 64, 32
MODEL_TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs several workers at
    once, and torch's default of one thread per core then oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _data(rng, n=22, mel=MEL):
    """(ecog_non, ecog_syll, ecog_tone, mels): classifier channels carry
    the labels, mels a dB-like offset plus the ECoG mean and the tone."""
    tones = rng.integers(0, 4, n)
    sylls = rng.integers(0, 2, n)
    ecog_non = rng.standard_normal((n, C_NON, T)).astype(np.float32)
    ecog_syll = (rng.standard_normal((n, C_CLS, T)) + 2.0 * sylls[:, None, None]).astype(np.float32)
    ecog_tone = (rng.standard_normal((n, C_CLS, T)) + tones[:, None, None]).astype(np.float32)
    mels = (ecog_non.mean(axis=(1, 2))[:, None] + 0.5 * tones[:, None] - 30.0
            + 0.05 * rng.standard_normal((n, mel))).astype(np.float32)
    return ecog_non, ecog_syll, ecog_tone, mels


def _classifiers(scaled=False):
    """Flax logistic (tone) and shallow (syllable) classifiers with their
    variables, the port's with the same weights, and optional scalers."""
    rng = np.random.default_rng(9)
    x = np.zeros((1, C_CLS, T), np.float32)
    jt, js = JLogistic(input_dim=C_CLS * T, n_classes=4), JShallow(input_dim=C_CLS * T, n_classes=2)
    tv = _np_tree(jt.init({"params": jax.random.key(0)}, x, train=False))
    sv = _np_tree(js.init({"params": jax.random.key(1)}, x, train=False))
    port_t = load_flax_variables(get_classifier_by_name("logistic", 4, C_CLS, T), tv)
    port_s = load_flax_variables(get_classifier_by_name("ShallowNN", 2, C_CLS, T), sv)
    scalers = (None, None)
    if scaled:
        scalers = tuple((rng.standard_normal((1, C_CLS, T)).astype(np.float32) * 0.3,
                         (rng.random((1, C_CLS, T)) + 0.5).astype(np.float32))
                        for _ in range(2))
    return (jt, tv, js, sv), (port_t, port_s), scalers


_MODELS = {
    "lite": (lambda drop: jsyn.SynthesisLite(output_dim=MEL, n_channels=C_NON, n_timepoints=T,
                                             dropout=drop),
             lambda drop: synthesis.SynthesisLite(MEL, C_NON, T, dropout=drop)),
    "cnn": (lambda drop: jsyn.SynthesisModelCNN(output_dim=MEL, n_channels=C_NON,
                                                n_timepoints=T, dropout=drop),
            lambda drop: synthesis.SynthesisModelCNN(MEL, C_NON, T, dropout=drop)),
}


def _trainers(name, seed=0, lr=2e-3, scaled=False, **kw):
    """A JAX trainer and a port trainer of the same configuration, the
    port's model not initialised yet."""
    jmodel_fn, tmodel_fn = _MODELS[name]
    (jt, tv, js, sv), (pt, ps), (t_sc, s_sc) = _classifiers(scaled)
    cfg = dict(learning_rate=lr, seed=seed, verbose=False, tone_scaler=t_sc,
               syllable_scaler=s_sc, **kw)
    jtrainer = jst.SynthesisTrainer(jmodel_fn(0.0), jt, tv, js, sv, MAPPING, **cfg)
    ttrainer = SynthesisTrainer(tmodel_fn(0.0), pt, ps, MAPPING, device="cpu", **cfg)
    return jtrainer, ttrainer


def _carry(jtrainer, ttrainer):
    """Load the JAX trainer's current weights into the port's model."""
    variables = {"params": _np_tree(jtrainer.params)}
    if jtrainer.batch_stats:
        variables["batch_stats"] = _np_tree(jtrainer.batch_stats)
    load_flax_variables(ttrainer.model, variables)
    return variables


def _as_state(tree, model, stats=None):
    variables = {"params": _np_tree(tree)}
    if stats:
        variables["batch_stats"] = _np_tree(stats)
    return flax_to_state_dict(variables, model)


# ----------------------------------------------------------------------
_SHAPES = {"b": (4,), "k": (2, 3, 4), "w": (3, 4)}  # sorted: JAX leaf order


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_unmasked_nadam_matches_optax(steps, moment_dtype):
    rng = np.random.default_rng(steps)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in _SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in _SHAPES.items()}
             for _ in range(steps)]
    lr, wd = 1e-2, 0.004
    opt = with_moment_dtype(optax.chain(optax.add_decayed_weights(wd), optax.nadam(lr)),
                            moment_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = [torch.tensor(params[k]) for k in _SHAPES]
    topt = NAdam(tp, lr, wd, moment_dtype=moment_dtype, decay_all=True)
    for g in grads:
        topt.step([torch.tensor(g[k]) for k in _SHAPES])
    mu = optax.tree_utils.tree_get(state, "mu")
    nu = optax.tree_utils.tree_get(state, "nu")
    for i, k in enumerate(_SHAPES):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
        for got, want in ((topt.mu[i], mu[k]), (topt.nu[i], nu[k])):
            assert got.dtype == (torch.bfloat16 if moment_dtype else torch.float32)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       rtol=1e-5, atol=1e-7)


def test_decay_all_reaches_vectors_and_the_mask_stays_default():
    b = torch.ones(4)
    NAdam([b], 1e-2, weight_decay=0.1, decay_all=True).step([torch.zeros(4)])
    assert (b < 1).all()  # the L2 term alone moved the bias
    masked = torch.ones(4)
    NAdam([masked], 1e-2, weight_decay=0.1).step([torch.zeros(4)])
    assert torch.equal(masked, torch.ones(4))


# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(_MODELS))
def test_train_mode_matches_flax_with_batch_stats(name):
    """Two train-mode forwards (dropout 0) against Flax's
    ``apply(train=True, mutable=["batch_stats"])``: the outputs and, for
    SynthesisLite, the running mean and variance after each. With
    ``nn.BatchNorm1d`` the running variance came out n/(n-1) times
    Flax's (the unbiased batch variance) and this test failed."""
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((6, C_NON, T)).astype(np.float32) for _ in range(2)]
    labels = rng.standard_normal((6, 2, 3)).astype(np.float32)
    jmodel_fn, tmodel_fn = _MODELS[name]
    jm, tm = jmodel_fn(0.0), tmodel_fn(0.0)
    v = _np_tree(jm.init({"params": jax.random.key(0)}, xs[0], labels, train=False))
    load_flax_variables(tm, v).train()
    for x in xs:
        out, upd = jm.apply(v, x, labels, train=True, mutable=["batch_stats"])
        got = tm(torch.from_numpy(x), torch.from_numpy(labels))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **MODEL_TOL)
        if name == "lite":
            v = {**v, "batch_stats": _np_tree(upd["batch_stats"])}
            for bn in ("bn1", "bn2"):
                mod, stats = getattr(tm, bn), v["batch_stats"][bn]
                np.testing.assert_allclose(mod.running_mean.numpy(), stats["mean"],
                                           rtol=1e-5, atol=1e-7, err_msg=bn)
                np.testing.assert_allclose(mod.running_var.numpy(), stats["var"],
                                           rtol=1e-5, atol=1e-7, err_msg=bn)
    if name == "lite":  # eval mode serves with the carried statistics
        tm.eval()
        ref = jm.apply(v, xs[0], labels, train=False)
        with torch.no_grad():
            got = tm(torch.from_numpy(xs[0]), torch.from_numpy(labels))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MODEL_TOL)


@pytest.mark.parametrize("scaled", [False, True], ids=["no_scaler", "scaler"])
def test_frozen_dynamics_equal_jax(scaled):
    _, x_syll, x_tone, _ = _data(np.random.default_rng(3), n=40)
    jtrainer, ttrainer = _trainers("lite", scaled=scaled)
    want = np.asarray(jtrainer._predict_flat(jnp.asarray(x_tone), jnp.asarray(x_syll)))
    got = ttrainer._predict_flat(x_tone, x_syll).numpy()
    assert got.shape == (40, 2, 3)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want[:, 0, 0])) == 2 and len(np.unique(want[:, 1, 1])) > 1


@pytest.mark.parametrize("name", list(_MODELS))
def test_output_bias_and_target_mean_init(name):
    ecog_non, _, _, mels = _data(np.random.default_rng(4))
    target_mean = mels.mean(axis=0)
    jtrainer, ttrainer = _trainers(name)
    jtrainer.init(ecog_non, 3, target_mean=target_mean)
    ttrainer.init(target_mean=target_mean)
    head = "fc2" if name == "lite" else "output_layer"
    np.testing.assert_array_equal(getattr(ttrainer.model, head).bias.detach().numpy(),
                                  np.asarray(jtrainer.params[head]["bias"]))
    np.testing.assert_array_equal(
        np.asarray(jst._with_output_bias(jtrainer.params, target_mean)[head]["bias"]),
        target_mean)
    assert ttrainer.n_params() == jtrainer.n_params()
    with pytest.raises(ValueError, match="output head"):
        _with_output_bias(torch.nn.Sequential(torch.nn.Linear(2, 2)), target_mean)


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


NEAR_ZERO_GRAD = 1e-6
MAX_STEP = 1.5  # |first NAdam step| <= 1.5 lr


@pytest.mark.parametrize("name", list(_MODELS))
def test_one_train_step_matches_jax(name):
    ecog_non, x_syll, x_tone, mels = _data(np.random.default_rng(5), n=8)
    ecog_non[6:], mels[6:] = ecog_non[0], mels[0]  # two padding rows, as _stack pads
    w = np.array([1] * 6 + [0] * 2, np.float32)
    jtrainer, ttrainer = _trainers(name, lr=1e-3)
    jtrainer.init(ecog_non, 3, target_mean=mels[:6].mean(axis=0))
    ttrainer.init()
    _carry(jtrainer, ttrainer)
    labels = np.asarray(jtrainer._predict_flat(jnp.asarray(x_tone), jnp.asarray(x_syll)))
    batches = tuple(jnp.asarray(a)[None] for a in (ecog_non, labels, mels, w))
    params, stats, _, _, loss, mcd = jax.jit(jtrainer._train_epoch_inner)(
        jtrainer.params, jtrainer.batch_stats, jtrainer.opt_state, jax.random.key(0), batches)

    t_batch = [torch.from_numpy(np.array(a)) for a in (ecog_non, labels, mels, w)]
    model = ttrainer.model
    probe = copy.deepcopy(model).train()  # a forward updates running statistics
    out = probe(t_batch[0], t_batch[1])
    l1 = ((out - t_batch[2]).abs().mean(1) * t_batch[3]).sum() / t_batch[3].sum()
    grads = dict(zip([k for k, _ in probe.named_parameters()],
                     torch.autograd.grad(l1, list(probe.parameters()))))
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    t_loss, t_mcd = ttrainer.train_step(*t_batch)
    assert t_loss.item() == pytest.approx(float(loss), rel=1e-5, abs=1e-6)
    assert t_mcd.item() == pytest.approx(float(mcd), rel=1e-5, abs=1e-6)
    want = _as_state(params, model, stats)
    got = ttrainer.params
    for k, p in model.named_parameters():
        g = grads[k] + 0.004 * before[k]  # the decayed gradient NAdam sees
        off = ~np.isclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6)
        assert (np.abs(g.numpy()[off]) < NEAR_ZERO_GRAD).all(), (k, int(off.sum()))
        assert (np.abs(got[k].numpy() - want[k].numpy())[off] <= MAX_STEP * 1e-3).all(), k
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


_FITS = {"lite": (2e-3, 1e-4), "cnn": (5e-4, 2e-2)}  # lr, rtol after the first epoch


@pytest.mark.parametrize("name", list(_MODELS))
def test_three_epoch_fit_matches_jax_given_its_permutations(name):
    data = _data(np.random.default_rng(6), n=22)  # 22 rows pad to 24: 3 batches of 8
    test = _data(np.random.default_rng(7), n=10)
    bsz, epochs = 8, 3
    lr, rtol = _FITS[name]
    target_mean = data[3].mean(axis=0)
    jtrainer, ttrainer = _trainers(name, lr=lr)
    jtrainer.init(data[0], 3, target_mean=target_mean)
    ttrainer.init(target_mean=target_mean)
    _carry(jtrainer, ttrainer)
    history = jtrainer.train(data, epochs=epochs, batch_size=bsz, verbose=False)
    want_mcd, want_recon, _ = jtrainer.evaluate(test, batch_size=bsz)

    dev = ttrainer._device_data(data, bsz)
    n = dev.x.shape[0]
    for epoch, perm in enumerate(_jax_perms(0, n, n // bsz, epochs)):
        got = ttrainer._epoch(torch.tensor(perm, dtype=torch.long), dev, bsz).tolist()
        np.testing.assert_allclose(got, history[epoch], rtol=rtol if epoch else 1e-4,
                                   atol=1e-5, err_msg=f"epoch {epoch}")
    mcd, recon, origin = ttrainer.evaluate(test, batch_size=bsz)
    assert mcd == pytest.approx(want_mcd, rel=rtol, abs=1e-5)
    np.testing.assert_allclose(recon, want_recon, rtol=rtol, atol=1e-4)
    np.testing.assert_array_equal(origin, test[3])


# ----------------------------------------------------------------------
def _port_trainer(seed=0, **kw):
    """A port trainer on SynthesisLite with dropout on, so that resume
    must also continue the dropout generator."""
    (_, _, _, _), (pt, ps), _ = _classifiers()
    return SynthesisTrainer(synthesis.SynthesisLite(MEL, C_NON, T), pt, ps, MAPPING,
                            learning_rate=2e-3, seed=seed, verbose=False, device="cpu", **kw)


def _assert_equal_fits(a, b):
    assert a[0] == b[0]
    for k, v in a[1].items():
        assert torch.equal(v, b[1][k]), k


@pytest.mark.parametrize("mode,kw", [
    ("resume", {}), ("segments", {}), ("resume", {"moment_dtype": "bfloat16"}),
], ids=["resume", "segments", "resume_bf16_moments"])
def test_resume_and_segments_equal_uninterrupted(mode, kw, tmp_path):
    data = _data(np.random.default_rng(8), n=20)
    plain = _port_trainer(**kw)
    full = (plain.train(data, epochs=4, verbose=False), plain.params)
    ckpt = str(tmp_path / "state")
    if mode == "resume":
        _port_trainer(**kw).train(data, epochs=2, verbose=False, checkpoint_dir=ckpt)
        second = _port_trainer(**kw)
        hist = second.train(data, epochs=4, verbose=False, checkpoint_dir=ckpt, resume=True)
    else:
        second = _port_trainer(**kw)
        hist = second.train(data, epochs=4, verbose=False, checkpoint_dir=ckpt,
                            checkpoint_every=1)
    _assert_equal_fits(full, (hist, second.params))
    if kw:
        assert all(m.dtype == torch.bfloat16 for m in second.optimizer.mu)


def test_seed_loop_equals_sequential_trainers():
    data = _data(np.random.default_rng(9), n=30)
    seeds = [3, 5]
    splits = [split_indices(30, [0.8, 0.2], seed=s) for s in seeds]
    train = tuple(np.stack([a[s[0]] for s in splits]) for a in data)
    test = tuple(np.stack([a[s[1]] for s in splits]) for a in data)
    target_means = train[3].mean(axis=1)
    proto = _port_trainer()
    results = seed_loop_fit_eval(proto, seeds, train, test, epochs=3, batch_size=8,
                                 target_means=target_means, verbose=False)
    for i, (seed, (hist, mcd, recon, origin)) in enumerate(zip(seeds, results)):
        t = _port_trainer(seed=seed)
        want = t.train(tuple(a[i] for a in train), epochs=3, verbose=False,
                       target_mean=target_means[i])
        want_mcd, want_recon, _ = t.evaluate(tuple(a[i] for a in test))
        assert hist == want and mcd == want_mcd
        np.testing.assert_array_equal(recon, want_recon)
        np.testing.assert_array_equal(origin, test[3][i])
        for k, v in t.params.items():
            assert torch.equal(v, proto.seed_params[i][k]), k


def test_compute_mcd_formula():
    assert compute_mcd(np.zeros((2, 4)), np.ones((2, 4))) == pytest.approx(
        10 / np.log(10) * np.sqrt(8.0), rel=1e-6)
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((5, 7)), rng.standard_normal((5, 7))
    assert compute_mcd(a, b) == jst.compute_mcd(a, b)


def test_loss_curve_and_mel_figures(tmp_path):
    plot_training_losses([(1.0, 9.0), (0.5, 7.0)], labels=("L1 loss", "MCD"),
                         figure_path=str(tmp_path / "losses.png"))
    mel = np.random.default_rng(0).standard_normal((8, 5))
    compare_mels(mel, mel + 1, file_path=str(tmp_path / "mels.png"))
    assert os.path.getsize(tmp_path / "losses.png") > 0
    assert os.path.getsize(tmp_path / "mels.png") > 0


# ----------------------------------------------------------------------
# The stage through both packages.
N_STAGE, C_STAGE, SR = 32, 10, 2000
STAGE_CHANNELS = {"active_channels": list(range(C_STAGE)), "tone_discriminative": [1, 0],
                  "syllable_discriminative": [2, 3]}
STAGE_MEL = {"n_fft": 256, "hop_length": 128, "n_mels": 20}


@pytest.fixture(scope="module")
def stage_world(tmp_path_factory):
    """A sample file with audio, the channel and config JSON, and logistic
    classifiers saved by each package (Orbax directories for JAX, torch
    files for the port) with the same weights and scalers."""
    root = tmp_path_factory.mktemp("synth_stage")
    rng = np.random.default_rng(0)
    ecog = rng.standard_normal((N_STAGE, C_STAGE, T)).astype(np.float32)
    t = np.arange(2048) / SR
    tone = rng.integers(0, 4, N_STAGE)
    audio = (np.sin(2 * np.pi * (200 + 60 * tone)[:, None] * t)
             + 0.1 * rng.standard_normal((N_STAGE, 2048))).astype(np.float32)
    ecog[:, :2] += tone[:, None, None]
    paths = {k: str(root / n) for k, n in (("sample", "subject_1.npz"),
                                          ("channels", "channels.json"),
                                          ("config", "config.json"))}
    np.savez(paths["sample"], ecog=ecog, ecog_sf=200.0, audio=audio, audio_sf=SR,
             tone=tone, syllable=rng.integers(0, 2, N_STAGE))
    with open(paths["channels"], "w") as f:
        json.dump(STAGE_CHANNELS, f)
    with open(paths["config"], "w") as f:
        json.dump({"mel_kwargs": STAGE_MEL, "tone_dynamic_mapping": MAPPING,
                   "n_syllables": 2, "n_tones": 4}, f)
    x = np.zeros((1, 2, T), np.float32)
    for key, n_classes, seed in (("tone", 4, 0), ("syllable", 2, 1)):
        jm = JLogistic(input_dim=2 * T, n_classes=n_classes)
        v = _np_tree(jm.init({"params": jax.random.key(seed)}, x, train=False))
        scaler = (rng.standard_normal((1, 2, T)).astype(np.float32) * 0.1,
                  (rng.random((1, 2, T)) + 0.5).astype(np.float32))
        paths[f"jax_{key}"] = jsave_params(str(root / f"jax_{key}"), {
            "params": v["params"], "scaler": {"mu": scaler[0], "sd": scaler[1]}})
        model = load_flax_variables(get_classifier_by_name("logistic", n_classes, 2, T), v)
        paths[f"port_{key}"] = save_checkpoint(str(root / f"port_{key}.pt"), model, scaler)
    return root, paths


def _stage_args(paths, out, prefix, *extra):
    return [
        "--sample_path", paths["sample"], "--subject_id", "1",
        "--channel_file", paths["channels"], "--config_file", paths["config"],
        "--model_name", "lite_test", "--synthesis_model_name", "SynthesisLite",
        "--syllable_model_name", "logistic", "--tone_model_name", "logistic",
        "--syllable_model_path", paths[f"{prefix}_syllable"],
        "--tone_model_path", paths[f"{prefix}_tone"],
        "--epochs", "3", "--batch_size", "8", "--repeat", "2", "--verbose", "0",
        "--audio_sampling_rate", str(SR), "--lr", "0.005",
        "--checkpoint_dir", str(out / "ckpts"), "--result_file", str(out / "results.csv"),
        *extra,
    ]


def _csv(path):
    import csv

    with open(path) as f:
        return list(csv.reader(f))


def test_stage_matches_jax_stage(stage_world, tmp_path):
    root, paths = stage_world
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jsum = jstage.run(jstage.build_parser().parse_args(_stage_args(paths, jout, "jax")))
    tsum = train_synthesizer.run(train_synthesizer.build_parser().parse_args(
        _stage_args(paths, tout, "port", "--device", "cpu", "--figure_dir", str(tout / "figs"),
                    "--audio_dir", str(tout / "wavs"))))
    assert tsum["seeds"] == jsum["seeds"] and tsum["model_size"] == jsum["model_size"]
    assert list(tsum) == list(jsum)
    got, want = _csv(tout / "results.csv"), _csv(jout / "results.csv")
    assert got[0] == want[0] and len(got) == len(want) == 2
    assert sorted(os.listdir(tout / "ckpts")) == sorted(os.listdir(jout / "ckpts"))
    for name in ("figs/training_losses.png", "figs/mel_compare_0.png", "wavs/recon_0.wav",
                 "wavs/origin_0.wav"):
        assert (tout / name).exists(), name

    # The same test split: each seed's test mels, as the stage computes them.
    from decode_tonal_langauge_tpu_torch.utils.audio import audio_to_mel

    data = np.load(paths["sample"])
    mels = np.stack([audio_to_mel(a, SR, mel_kwargs=STAGE_MEL, device="cpu")
                     for a in data["audio"]])
    for seed, jm, tm in zip(json.loads(tsum["seeds"]), eval(jsum["mcd_all"]),
                            eval(tsum["mcd_all"])):
        te = split_indices(N_STAGE, [0.9, 0.1], seed=seed)[-1]
        zero = compute_mcd(mels[te], np.zeros_like(mels[te]))
        assert jm < zero and tm < zero, (seed, jm, tm, zero)

    # --evaluate_only reproduces the fit's rows from the checkpoints.
    ev = train_synthesizer.run(train_synthesizer.build_parser().parse_args(
        _stage_args(paths, tout, "port", "--device", "cpu", "--evaluate_only")))
    for key in ("mcd_all", "mel_pearson_r_mean", "model_size", "seeds"):
        assert ev[key] == tsum[key], key
    assert len(_csv(tout / "results.csv")) == 3  # appended, header once


def test_stage_flags(stage_world, tmp_path, capsys):
    _, paths = stage_world
    parse = train_synthesizer.build_parser().parse_args
    with pytest.raises(ValueError, match="checkpoint_dir"):
        train_synthesizer.run(parse([a for a in _stage_args(paths, tmp_path, "port")
                                     if "ckpts" not in a and a != "--checkpoint_dir"]
                                    + ["--device", "cpu", "--evaluate_only"]))
    # --dtype bfloat16 trains a bf16 synthesizer whose checkpoints hold
    # float32 parameters; an unknown dtype name raises.
    bf16 = train_synthesizer.run(parse(_stage_args(paths, tmp_path, "port", "--device", "cpu",
                                                   "--dtype", "bfloat16", "--parallel_data",
                                                   "auto", "--no_compilation_cache")))
    note = capsys.readouterr().out
    assert "--no_compilation_cache: accepted" in note and "--parallel_data" not in note
    seeds = json.loads(bf16["seeds"])
    assert np.isfinite(json.loads(bf16["mcd_all"])).all() and len(seeds) == 2
    ckpt, _ = load_checkpoint(str(tmp_path / "ckpts" / f"SynthesisLite_seed_{seeds[0]}"))
    assert all(v.dtype == torch.float32 for k, v in ckpt.items() if "num_batches" not in k)
    with pytest.raises(ValueError, match="compute dtype"):
        train_synthesizer.run(parse(_stage_args(paths, tmp_path, "port", "--device", "cpu",
                                                "--dtype", "bfloat17")))
    with pytest.raises(ValueError, match="Unknown classifier"):
        train_synthesizer.build_classifier("nope", 2, 3, 10)
    with pytest.raises(ValueError, match="Unknown synthesis"):
        train_synthesizer.build_synthesis_model("nope", 2, 3, 10)


def test_train_state_dir_resume_through_the_stage(stage_world, tmp_path):
    """--train_state_dir/--resume/--checkpoint_every through the stage:
    2 epochs then a resume to 3 equal the straight 3-epoch fit's rows. A
    train state runs the seed loop, so the straight fit runs it too
    (--seed_parallel 0; the batched fit sums in another order)."""
    _, paths = stage_world
    parse = train_synthesizer.build_parser().parse_args
    straight = train_synthesizer.run(parse(_stage_args(
        paths, tmp_path / "a", "port", "--device", "cpu", "--seed_parallel", "0")))
    ts = str(tmp_path / "b" / "states")
    common = ("--device", "cpu", "--train_state_dir", ts, "--checkpoint_every", "1")
    args = _stage_args(paths, tmp_path / "b", "port", *common)
    train_synthesizer.run(parse([a if a != "3" else "2" for a in args]))
    assert sorted(os.listdir(ts)) == sorted(os.listdir(tmp_path / "a" / "ckpts"))
    resumed = train_synthesizer.run(parse(args + ["--resume"]))
    assert resumed["mcd_all"] == straight["mcd_all"]


def test_serving_mel_summary_matches_jax(stage_world, tmp_path):
    """The serving CLI's mel_mcd and mel_pearson_r on a sample file with
    audio, the JAX CLI against the port's, given carried weights."""
    from decode_tonal_langauge_tpu import serving as jserving
    from decode_tonal_langauge_tpu_torch import serving

    root, paths = stage_world
    rng = np.random.default_rng(1)
    mel_dim = 20 * 17  # 2048 samples at hop 128
    jm = jsyn.SynthesisLite(output_dim=mel_dim, n_channels=6, n_timepoints=T)
    v = _np_tree(jm.init({"params": jax.random.key(2)}, np.zeros((1, 6, T), np.float32),
                         np.zeros((1, 2, 3), np.float32), train=False))
    v["params"]["fc2"]["bias"] = (rng.standard_normal(mel_dim) * 5 - 40).astype(np.float32)
    jsyn_path = jsave_params(str(tmp_path / "jax_synth"), v)
    port_syn = load_flax_variables(synthesis.SynthesisLite(mel_dim, 6, T), v)
    tsyn_path = save_checkpoint(str(tmp_path / "port_synth.pt"), port_syn)

    def args(prefix, syn_path, out):
        return ["--sample_path", paths["sample"], "--channel_file", paths["channels"],
                "--config_file", paths["config"], "--tone_model_name", "logistic",
                "--tone_model_path", paths[f"{prefix}_tone"],
                "--syllable_model_name", "logistic",
                "--syllable_model_path", paths[f"{prefix}_syllable"],
                "--synthesis_model_name", "SynthesisLite", "--synthesis_model_path", syn_path,
                "--audio_sampling_rate", str(SR), "--output_dir", str(out), "--n_wavs", "1"]

    want = jserving.run(jserving.build_parser().parse_args(
        args("jax", jsyn_path, tmp_path / "jax_out")))
    got = serving.run(serving.build_parser().parse_args(
        args("port", tsyn_path, tmp_path / "port_out") + ["--device", "cpu"]))
    assert got["mel_mcd"] == pytest.approx(want["mel_mcd"], rel=1e-4)
    assert got["mel_pearson_r"] == pytest.approx(want["mel_pearson_r"], rel=1e-4, abs=1e-5)
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "port_out" / "predictions.csv", delimiter=",", skiprows=1),
        np.loadtxt(tmp_path / "jax_out" / "predictions.csv", delimiter=",", skiprows=1))
