"""The port's bfloat16 compute path against the JAX package's.

The same seeded numpy inputs and the same float32 weights (the JAX
module's ``init``, carried across by ``convert.py``) go through the JAX
module with ``dtype=jnp.bfloat16`` and the port's with
``dtype=torch.bfloat16``, on the CPU. Both packages keep the parameters
float32 at rest and cast them inside the layer, so the converter carries
a bf16-configured model's parameters unchanged.

Tolerances. JAX's own rule for its bf16 LSTM is atol 0.05 against f32
(``tests/test_ops_lstm.py:150``). Port and JAX do the same bf16
operations, but XLA's CPU backend may keep a fused chain of bf16
elementwise ops in float32 where torch rounds after each op, so they
differ by a few roundings: bf16 keeps 8 significant bits, one rounding
moves a value of magnitude m by up to m * 2^-9. Each test states the
bound it holds, tightened from 0.05 to a few times what the CPU shows:

- values (``_assert_bf16_close``): rtol 2^-6 with an atol of 2^-6 times
  the output's largest magnitude (four roundings there);
- gradients: each tensor by its relative L2 distance, at most ``GRAD_REL``
  (0.03; the LSTM shows 0.006), or for the deep classifiers 1.5x JAX's own
  bf16 error (see ``test_classifier_bf16_step_matches_jax``);
- class probabilities and losses (the f32 head over bf16 features):
  ``PROB_ATOL`` 2e-3 (the CPU shows at most 7e-4).

The training tests hold a bf16 NAdam step against JAX's (with bf16
moments), a bf16 ``train_classifier`` + ``evaluation`` run whose rows
equal training's for each of 3 seeds (the port's counterpart of
``tests/test_pipeline_e2e.py::test_pipeline_cnn_bf16_config``),
``configs/fast_bf16.yaml`` through ``python -m
decode_tonal_langauge_tpu_torch`` on a small synthetic subject, and the
serving CLI with ``--synthesis_dtype bfloat16``.
"""

import copy
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
import yaml
from flax import linen as fnn

from decode_tonal_langauge_tpu.models import deep as jdeep
from decode_tonal_langauge_tpu.models import synthesis as jsyn
from decode_tonal_langauge_tpu.ops.lstm import TimeBatchedLSTM as JLSTM
from decode_tonal_langauge_tpu.ops.stencil import stencil_conv_pool_leaky as jstencil
from decode_tonal_langauge_tpu.training.trainer import ClassifierTrainer as JTrainer
from decode_tonal_langauge_tpu_torch import pipeline, serving
from decode_tonal_langauge_tpu_torch.config import load_config
from decode_tonal_langauge_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from decode_tonal_langauge_tpu_torch.data.synthetic import SyntheticSpec, write_subject
from decode_tonal_langauge_tpu_torch.evaluation import main as evaluation
from decode_tonal_langauge_tpu_torch.models import deep, synthesis
from decode_tonal_langauge_tpu_torch.models.factory import (
    build_synthesis_model,
    get_classifier_by_name,
)
from decode_tonal_langauge_tpu_torch.ops.lstm import TimeBatchedLSTM
from decode_tonal_langauge_tpu_torch.ops.stencil import stencil_conv_pool_leaky
from decode_tonal_langauge_tpu_torch.runtime.checkpoint import save_checkpoint
from decode_tonal_langauge_tpu_torch.runtime.device import exact_f32
from decode_tonal_langauge_tpu_torch.training import train_classifier
from decode_tonal_langauge_tpu_torch.training.trainer import ClassifierTrainer, _batch_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_REL = 0.03
PROB_ATOL = 2e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs several workers at
    once, and torch's default of one thread per core then oversubscribes
    the machine, which slows these tests' many small bf16 operations by an
    order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _f32(a) -> np.ndarray:
    """A JAX or torch array as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, dtype=np.float32)


def _assert_bf16_close(got, want):
    """Within four bf16 roundings of the larger magnitude (module doc)."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2**-6, atol=2**-6 * scale)


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _init(jmodel, *inputs):
    v = jax.jit(lambda key, *a: jmodel.init({"params": key}, *a, train=False))(
        jax.random.key(0), *inputs)
    return jax.tree_util.tree_map(np.asarray, v)


def _grads_close(model, jgrads, tgrads):
    """Each parameter's gradient (float32 in both packages) within
    GRAD_REL of JAX's by relative L2 distance."""
    want = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, model)
    for name, g in tgrads.items():
        assert g.dtype == torch.float32, name
        assert _rel(g, want[name]) <= GRAD_REL, (name, _rel(g, want[name]))


# ----------------------------------------------------------------------
# Ops.

@pytest.mark.parametrize("k,pool,t", [(3, 2, 21), (7, 2, 40), (7, 1, 16)])
def test_stencil_bf16_matches_jax(k, pool, t):
    x, kernel, bias = _rand((2, t, 5)), _rand((k, 1, 1, 8), 1), _rand(8, 2)
    ref = jstencil(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
                   pool=pool, negative_slope=0.01, dtype=jnp.bfloat16)
    got = stencil_conv_pool_leaky(
        torch.from_numpy(x), torch.from_numpy(kernel.reshape(k, 8)),
        torch.from_numpy(bias), pool=pool, negative_slope=0.01, dtype=torch.bfloat16,
    )
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _assert_bf16_close(got, ref)


def test_lstm_bf16_values_and_gradients_match_jax():
    """B 4 x T 50 x I 6 x H 40: the hidden sequence in bf16, and the
    gradients of x and of the three f32 parameters (summed in f32 and
    rounded once to bf16 in both packages)."""
    x, ct = _rand((4, 50, 6)), _rand((4, 50, 40), 1)
    jm = JLSTM(40, dtype=jnp.bfloat16)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0), x))

    def jloss(params, xs):
        return (jm.apply(params, xs).astype(jnp.float32) * ct).sum()

    ref = jm.apply(v, x)
    jg_params, jg_x = jax.grad(jloss, argnums=(0, 1))(v, x)

    tm = TimeBatchedLSTM(6, 40, dtype=torch.bfloat16)
    tm.load_state_dict(flax_to_state_dict(v, tm))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _assert_bf16_close(out, ref)
    names, params = zip(*tm.named_parameters())
    grads = torch.autograd.grad((out.float() * torch.from_numpy(ct)).sum(), (xt,) + params)
    assert _rel(grads[0], jg_x) <= GRAD_REL
    _grads_close(tm, jg_params["params"], dict(zip(names, grads[1:])))


def test_max_pool_and_maximum_route_ties_as_jax():
    """Exact ties are common on bf16's 2^-8 grid. A max-pool's gradient
    goes to the first of tied elements in both packages (``F.max_pool2d``
    and ``F.max_pool1d`` as Flax's ``nn.max_pool``), and the stencil's
    phase ``maximum`` splits a tie's gradient in halves in both."""
    x = np.array([1.0, 1.0, 2.0, 0.5, 3.0, 3.0, -1.0, -1.0], np.float32)
    g = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    for dt in (jnp.float32, jnp.bfloat16):
        jg = jax.grad(lambda a: (fnn.max_pool(a, (2, 1), (2, 1)).astype(jnp.float32)
                                 * g.reshape(1, 4, 1, 1)).sum())(
            jnp.asarray(x.reshape(1, 8, 1, 1), dt))
        jg1 = jax.grad(lambda a: (fnn.max_pool(a, (2,), (2,)).astype(jnp.float32)
                                  * g.reshape(1, 4, 1)).sum())(jnp.asarray(x.reshape(1, 8, 1), dt))
        tdt = torch.bfloat16 if dt == jnp.bfloat16 else torch.float32
        x2 = torch.tensor(x.reshape(1, 1, 8, 1), dtype=tdt, requires_grad=True)
        (F.max_pool2d(x2, (2, 1), (2, 1)).float() * torch.from_numpy(g).view(1, 1, 4, 1)).sum().backward()
        x1 = torch.tensor(x.reshape(1, 1, 8), dtype=tdt, requires_grad=True)
        (F.max_pool1d(x1, 2, 2).float() * torch.from_numpy(g).view(1, 1, 4)).sum().backward()
        np.testing.assert_array_equal(_f32(x2.grad).ravel(), _f32(jg).ravel())
        np.testing.assert_array_equal(_f32(x1.grad).ravel(), _f32(jg1).ravel())
        np.testing.assert_array_equal(_f32(x2.grad).ravel(), [1, 0, 2, 0, 3, 0, 4, 0])
    a, b = np.array([1.0, 2.0, 3.0], np.float32), np.array([1.0, 1.0, 3.0], np.float32)
    ja, jb = jax.grad(lambda p, q: jnp.maximum(p, q).sum(), argnums=(0, 1))(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    ta = torch.tensor(a, dtype=torch.bfloat16, requires_grad=True)
    tb = torch.tensor(b, dtype=torch.bfloat16, requires_grad=True)
    torch.maximum(ta, tb).sum().backward()
    np.testing.assert_array_equal(_f32(ta.grad), _f32(ja))
    np.testing.assert_array_equal(_f32(tb.grad), _f32(jb))
    np.testing.assert_array_equal(_f32(ta.grad), [0.5, 1.0, 0.5])


def test_exact_f32_sums_half_precision_gemms_in_f32():
    """Every model call and train step runs inside ``exact_f32``, which
    keeps cuBLAS from reducing bf16 and fp16 GEMMs in half precision (the
    LSTM's weight gradients rely on it) and restores the caller's flags."""
    matmul = torch.backends.cuda.matmul
    before = (matmul.allow_bf16_reduced_precision_reduction,
              matmul.allow_fp16_reduced_precision_reduction)
    with pytest.raises(RuntimeError), exact_f32():
        assert not matmul.allow_bf16_reduced_precision_reduction
        assert not matmul.allow_fp16_reduced_precision_reduction
        raise RuntimeError
    assert (matmul.allow_bf16_reduced_precision_reduction,
            matmul.allow_fp16_reduced_precision_reduction) == before


# ----------------------------------------------------------------------
# Models.

CLASSIFIERS = {  # dropout 0: train mode without the packages' random streams
    "cnn": (lambda: jdeep.CNNClassifier(input_channels=3, input_length=128, n_classes=4,
                                        dropout_rate=0.0, dtype=jnp.bfloat16),
            lambda dt: deep.CNNClassifier(3, 128, 4, dropout_rate=0.0, dtype=dt), (8, 3, 128)),
    "cnnrnn": (lambda: jdeep.CNNRNNClassifier(input_channels=3, input_length=40, n_classes=4,
                                              lstm_dim=80, dropout=0.0, dtype=jnp.bfloat16),
               lambda dt: deep.CNNRNNClassifier(3, 40, 4, lstm_dim=80, dropout=0.0, dtype=dt),
               (8, 3, 40)),
}
LR, WD = 1e-3, 0.01


def _port_grads(model, x, y):
    """Probabilities, loss and named parameter gradients of the trainer's
    cross-entropy (unit weights), in train mode."""
    names, params = zip(*model.train().named_parameters())
    out = model(torch.from_numpy(x))
    loss = _batch_loss(out, torch.from_numpy(y).long(), torch.ones(len(y)))
    return out, loss, dict(zip(names, torch.autograd.grad(loss, params)))


@pytest.mark.parametrize("name", sorted(CLASSIFIERS))
def test_classifier_bf16_step_matches_jax(name):
    """One bf16 train step of each paper classifier, with bf16 NAdam
    moments, against the JAX trainer's (its loss, gradient and optimizer).

    - Probabilities are float32 in both (the head computes in f32), within
      PROB_ATOL, and not all on the bf16 grid (the counterpart of
      ``tests/test_models.py::test_bf16_class_head_has_f32_resolution``).
    - Gradients, per tensor by relative L2 distance: within GRAD_REL, or
      within 1.5x JAX's own bf16 error (its distance from the port's f32
      gradient, which ``tests/test_torch_training.py`` holds to JAX's f32
      at 2e-4). A bf16 forward lands max-pool near-ties and leaky-ReLU
      inputs near zero on either side (PERF.md), which moves the early
      layers' gradients by 10-25% against f32; two bf16 runs with
      independent roundings lie about sqrt(2) times that error apart.
    - The step: NAdam's first step is about ``lr * sign(g)``. Where the two
      gradients (decay term included) agree in sign and exceed 1e-6, the
      updated weights agree within 2^-6 of a step (1.5 lr): each package's
      bf16 moments round its step by up to 2^-8, and ``eps`` (1e-8) moves
      the step of a gradient near 1e-6 by up to 1%; elsewhere within two
      steps."""
    jfn, tfn, shape = CLASSIFIERS[name]
    x = _rand(shape)
    y = (np.arange(shape[0]) % 4).astype(np.int32)
    jt = JTrainer(jfn(), 4, learning_rate=LR, weight_decay=WD, batch_size=shape[0], seed=0,
                  moment_dtype="bfloat16")
    jt.init(x)
    params = jax.tree.map(np.asarray, jt.params)

    def jloss(p):
        out = jt.model.apply({"params": p}, x, train=False)
        return optax.softmax_cross_entropy_with_integer_labels(out, y).mean(), out

    (jl, ref), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jt.params)
    updates, _ = jt.optimizer.update(jg, jt.opt_state, jt.params)
    j_new = flax_to_state_dict({"params": jax.tree.map(
        np.asarray, optax.apply_updates(jt.params, updates))}, tfn(None))
    j_grads = flax_to_state_dict({"params": jax.tree.map(np.asarray, jg)}, tfn(None))

    _, _, f32_grads = _port_grads(load_flax_variables(tfn(None), {"params": params}), x, y)
    tt = ClassifierTrainer(tfn("bfloat16"), 4, learning_rate=LR, weight_decay=WD,
                           batch_size=shape[0], seed=0, moment_dtype="bfloat16", device="cpu")
    tt.init(x)
    load_flax_variables(tt.model, {"params": params})
    for key, value in flax_to_state_dict({"params": params}, tt.model).items():
        assert torch.equal(tt.model.state_dict()[key], value), key  # carried unchanged
    assert all(p.dtype == torch.float32 for p in tt.model.parameters())
    out, loss, grads = _port_grads(tt.model, x, y)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=PROB_ATOL)
    assert not torch.equal(out, out.bfloat16().float()), "the head computes in bf16"
    assert loss.item() == pytest.approx(float(jl), abs=PROB_ATOL)
    for key, g in grads.items():
        assert g.dtype == torch.float32, key
        bound = max(GRAD_REL, 1.5 * _rel(j_grads[key], f32_grads[key]))
        assert _rel(g, j_grads[key]) <= bound, (key, _rel(g, j_grads[key]), bound)

    before = tt.params
    tt.train_step(torch.from_numpy(x), torch.from_numpy(y).long(), torch.ones(shape[0]))
    assert all(m.dtype == torch.bfloat16 for m in tt.optimizer.state_dict()["mu"])
    for key, got in tt.params.items():
        decay = WD * _f32(before[key]) if before[key].ndim >= 2 else 0.0
        gp, gj = _f32(grads[key]) + decay, _f32(j_grads[key]) + decay
        agree = (np.sign(gp) == np.sign(gj)) & (np.minimum(abs(gp), abs(gj)) > 1e-6)
        off = np.abs(_f32(got) - _f32(j_new[key]))
        assert (off[agree] <= 2**-6 * 1.5 * LR).all(), (key, off[agree].max())
        assert (off <= 2 * 1.5 * LR).all(), (key, off.max())


SYNTHESIS = {
    "full": (lambda d: jsyn.SynthesisModelCNN(output_dim=24, n_channels=5, n_timepoints=64,
                                              dropout=d, dtype=jnp.bfloat16),
             lambda d: synthesis.SynthesisModelCNN(24, 5, 64, dropout=d, dtype="bfloat16"), 64),
    "lite": (lambda d: jsyn.SynthesisLite(output_dim=24, n_channels=5, n_timepoints=40,
                                          dropout=d, dtype=jnp.bfloat16),
             lambda d: synthesis.SynthesisLite(24, 5, 40, dropout=d, dtype="bfloat16"), 40),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(SYNTHESIS))
def test_synthesis_bf16_matches_jax(name, train):
    """Mels (the bf16 output layer's values, returned as float32) in eval
    mode and in train mode (dropout 0, so the two packages' random streams
    do not enter), where SynthesisLite normalises with its batch
    statistics, computed in float32 in both, and updates its float32
    running statistics: those within rtol 1e-5 of Flax's."""
    jfn, tfn, t = SYNTHESIS[name]
    jm, tm = jfn(0.0), tfn(0.0)
    inputs = [_rand((4, 5, t)), _rand((4, 2, 6), 1)]
    v = _init(jm, *inputs)
    if train:
        ref, updates = jax.jit(lambda *a: jm.apply(*a, train=True, mutable=["batch_stats"]))(
            v, *inputs)
    else:
        ref = jax.jit(lambda *a: jm.apply(*a, train=False))(v, *inputs)
    load_flax_variables(tm, v).train(train)
    with torch.no_grad():
        out = tm(*(torch.from_numpy(i) for i in inputs))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    _assert_bf16_close(out, ref)
    if train and name == "lite":
        stats = flax_to_state_dict({"params": v["params"], **updates}, tm)
        for key in ("bn1.running_mean", "bn1.running_var", "bn2.running_mean",
                    "bn2.running_var"):
            assert tm.state_dict()[key].dtype == torch.float32
            np.testing.assert_allclose(_f32(tm.state_dict()[key]), _f32(stats[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


# ----------------------------------------------------------------------
# Training, evaluation, the pipeline and serving.

def _bf16_subject(root, n=40):
    """A sample file on which the bf16 CNN trains: 2 syllables planted on
    three channels, every (syllable, tone) pair present."""
    rng = np.random.default_rng(3)
    syll = np.tile([0, 1], n // 2)
    tone = np.repeat([0, 1, 2, 3], n // 4)
    x = rng.standard_normal((n, 3, 128)).astype(np.float32)
    x[syll == 1] += 1.5
    d = os.path.join(root, "samples")
    os.makedirs(d)
    np.savez(os.path.join(d, "subject_1.npz"), ecog=x, ecog_sf=400.0, syllable=syll,
             tone=tone)
    return d


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_bf16_training_rows_equal_evaluation_rows(tmp_path):
    """The CNN at bf16 (``model_kwargs: {dtype: bfloat16}``) through
    ``train_classifier.run`` with 3 seeds and checkpoints, then
    ``evaluation.run`` from the provenance: rows equal for every seed,
    the provenance records the dtype name, and the checkpoints hold
    float32 parameters."""
    root = str(tmp_path)
    sample_dir = _bf16_subject(root)
    cfg = {
        "dataset": {"syllable_labels": ["mi", "ma"], "tone_labels": ["t1", "t2", "t3", "t4"]},
        "model": {"model": "models.deep_classifiers.CNNClassifier", "model_name": "cnn_bf16",
                  "model_kwargs": {"dtype": "bfloat16"}},
        "training": {"module": "train_classifier", "params": {
            "io": {"log_dir": os.path.join(root, "logs"), "sample_dir": sample_dir},
            "experiment": {"targets": ["syllable"], "features": "ecog",
                           "separate_models": False, "seed": 42, "repeat": 3, "verbose": 0},
            "training": {"train_ratio": 0.6, "vali_ratio": 0.2, "test_ratio": 0.2,
                         "batch_size": 8, "epochs": 2, "lr": 5e-4, "patience": 2,
                         "standardize": True, "save_checkpoints": True,
                         "moment_dtype": "bfloat16"},
        }},
        "evaluation": {"metrics": ["accuracy", "f1_score", "confusion_matrix"]},
    }
    training_dir = train_classifier.run(cfg, device="cpu")
    eval_dir = evaluation.run({"evaluation": {"module": "evaluation_main", "params": {
        "io": {"training_dir": training_dir, "sample_dir": sample_dir}}}}, device="cpu")
    train_rows = _rows(os.path.join(training_dir, "results.csv"))
    assert train_rows and all(r["model_name"] == "cnn_bf16" for r in train_rows)
    assert len(json.loads(train_rows[0]["accuracy_all"])) == 3
    assert _rows(os.path.join(eval_dir, "results.csv")) == train_rows
    provenance = load_config(os.path.join(training_dir, "config.yaml"))
    assert provenance["model"]["model_kwargs"] == {"dtype": "bfloat16"}
    ckpts = os.listdir(os.path.join(training_dir, "model_checkpoints"))
    assert len(ckpts) == 3
    state, _ = serving.load_checkpoint(os.path.join(training_dir, "model_checkpoints", ckpts[0]))
    assert all(v.dtype == torch.float32 for v in state.values())


def test_fast_bf16_config_through_the_port_cli(tmp_path):
    """``configs/fast_bf16.yaml`` unchanged but for its paths, the
    synthetic subject's 400 Hz rate (no downsample step), a 70-120 Hz band,
    one seed and one epoch, through ``python -m
    decode_tonal_langauge_tpu_torch``: both results files, rows equal,
    and the bf16 pairing (CNN syllable, CNN-RNN tone) in the rows."""
    root = str(tmp_path / "run")
    write_subject(f"{root}/raw", 1, SyntheticSpec(
        n_channels=12, n_blocks=2, trials_per_block=48, ecog_sf=400.0, audio_sf=800.0,
        active_channels=tuple(range(8)), tone_channels=(0, 1, 2, 3),
        syllable_channels=(4, 5, 6, 7)))
    cfg = load_config(os.path.join(REPO, "configs", "fast_bf16.yaml"))
    pre = cfg["preprocess"]["params"]
    pre["io"]["params"].update(root_dir=f"{root}/raw", output_dir=f"{root}/processed")
    steps = pre["modalities"]["ecog"]["preprocessing"]["steps"]
    steps[1]["params"]["bands"][0]["params"]["freq_ranges"] = [70, 120]
    pre["modalities"]["ecog"]["preprocessing"]["steps"] = steps[1:]
    cfg["sample_collection"]["params"]["io"].update(output_dir=f"{root}/samples",
                                                    textgrid_root=f"{root}/raw")
    cfg["channel_selection"]["params"]["io"]["output_dir"] = f"{root}/selection"
    tp = cfg["training"]["params"]
    tp["io"]["log_dir"] = f"{root}/logs"
    tp["experiment"]["repeat"] = 1  # repeat 3: test_bf16_training_rows_equal_evaluation_rows
    tp["training"].update(epochs=1, patience=1)
    cfg["model"]["per_target"]["tone"]["model_kwargs"]["lstm_dim"] = 160  # 0.4 s at 400 Hz
    cfg_path = str(tmp_path / "fast_bf16.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    pipeline.main([cfg_path, "--device", "cpu"])  # what ``python -m`` runs
    (training_dir,) = [os.path.join(f"{root}/logs", d) for d in os.listdir(f"{root}/logs")]
    rows = _rows(os.path.join(training_dir, "results.csv"))
    assert {r["target"]: r["model_name"] for r in rows} == {
        "syllable, tone": "cnn_bf16", "syllable": "cnn_bf16", "tone": "cnnrnn_bf16"}
    assert _rows(os.path.join(training_dir, "evaluation", "results.csv")) == rows


def test_serving_cli_bf16_synthesizer(tmp_path):
    """``serving --synthesis_dtype bfloat16`` with bf16 classifiers named
    through ``--*_model_kwargs``: float32 probabilities and mels, equal to
    a ``TonalDecoder`` over the same bf16 models, and the ids of the f32
    decoder where its top-2 margin exceeds PROB_ATOL."""
    from decode_tonal_langauge_tpu_torch.models.base import init_params

    t, mel_dim = 40, 8 * 3
    channels = {"tone_discriminative": [0, 1], "syllable_discriminative": [2, 3],
                "active_channels": list(range(8))}
    mapping = {"0": [0.1, 0.2, 0.3], "1": [0.4, 0.5, 0.6], "2": [0.7, 0.8, 0.9]}
    models = {"tone": init_params(get_classifier_by_name("CNNRNN", 3, 2, t, {"lstm_dim": t}), 0),
              "syll": init_params(get_classifier_by_name("CNNRNN", 2, 2, t, {"lstm_dim": t}), 1),
              "synth": init_params(build_synthesis_model("SynthesisLite", mel_dim, 4, t), 2)}
    paths = {k: save_checkpoint(str(tmp_path / f"{k}.pt"), m) for k, m in models.items()}
    for key, value in (("channels", channels), ("config", {
            "n_tones": 3, "n_syllables": 2, "tone_dynamic_mapping": mapping,
            "mel_kwargs": {"n_mels": 8, "n_fft": 64, "hop_length": 32}})):
        paths[key] = str(tmp_path / f"{key}.json")
        with open(paths[key], "w") as f:
            json.dump(value, f)
    ecog = _rand((6, 8, t))
    paths["samples"] = str(tmp_path / "samples.npz")
    np.savez(paths["samples"], ecog=ecog, tone=np.arange(6) % 3, syllable=np.arange(6) % 2)
    kwargs = json.dumps({"lstm_dim": t, "dtype": "bfloat16"})
    out_dir = tmp_path / "served"
    summary = serving.run(serving.build_parser().parse_args([
        "--channel_file", paths["channels"], "--config_file", paths["config"],
        "--tone_model_name", "CNNRNN", "--tone_model_path", paths["tone"],
        "--tone_model_kwargs", kwargs, "--syllable_model_name", "CNNRNN",
        "--syllable_model_path", paths["syll"], "--syllable_model_kwargs", kwargs,
        "--synthesis_model_name", "SynthesisLite", "--synthesis_model_path", paths["synth"],
        "--synthesis_dtype", "bfloat16", "--sample_path", paths["samples"],
        "--audio_sampling_rate", "8000", "--output_dir", str(out_dir), "--n_wavs", "1",
        "--device", "cpu"]))
    assert summary["n_trials"] == 6 and summary["n_wavs"] == 1
    served = np.load(out_dir / "mels.npz")["mel"]
    assert served.dtype == np.float32

    def decoder(dtype):
        ms = {"tone": get_classifier_by_name("CNNRNN", 3, 2, t, {"lstm_dim": t, "dtype": dtype}),
              "syll": get_classifier_by_name("CNNRNN", 2, 2, t, {"lstm_dim": t, "dtype": dtype}),
              "synth": build_synthesis_model("SynthesisLite", mel_dim, 4, t, dtype=dtype)}
        for k, m in ms.items():
            m.load_state_dict(models[k].state_dict())
        return serving.TonalDecoder(ms["tone"], ms["syll"], mapping, synthesis_model=ms["synth"],
                                    device="cpu")

    bf16 = decoder("bfloat16").decode(ecog, channels)
    f32 = decoder("float32").decode(ecog, channels)
    np.testing.assert_array_equal(served, bf16["mel"])
    for key in ("tone_probs", "syllable_probs", "mel"):
        assert bf16[key].dtype == np.float32, key
    with open(out_dir / "predictions.csv") as f:
        preds = list(csv.DictReader(f))
    np.testing.assert_array_equal([int(r["tone_pred"]) for r in preds], bf16["tone"])
    np.testing.assert_allclose(bf16["tone_probs"], f32["tone_probs"], atol=0.02)
    top2 = np.sort(f32["tone_probs"], axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 0.02
    np.testing.assert_array_equal(bf16["tone"][clear], f32["tone"][clear])
