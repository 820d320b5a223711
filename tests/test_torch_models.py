"""The port's stencil, LSTM and models against the JAX package.

Each Flax model is initialised with ``model.init``, its variables are
carried across with ``convert.py``, and both sides run the same seeded
numpy inputs. Tolerance atol 2e-5 / rtol 1e-5 (the stencil oracle's in
``tests/test_models.py``) unless a case says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decode_tonal_langauge_tpu.models import deep as jdeep
from decode_tonal_langauge_tpu.models import simple as jsimple
from decode_tonal_langauge_tpu.models import synthesis as jsyn
from decode_tonal_langauge_tpu.ops.lstm import TimeBatchedLSTM as JLSTM
from decode_tonal_langauge_tpu.ops.stencil import stencil_conv_pool_leaky as jstencil
from decode_tonal_langauge_tpu_torch.convert import (
    flax_to_state_dict,
    load_flax_variables,
)
from decode_tonal_langauge_tpu_torch.models import deep, simple, synthesis
from decode_tonal_langauge_tpu_torch.models.base import init_params
from decode_tonal_langauge_tpu_torch.models.factory import (
    build_synthesis_model,
    get_classifier_by_name,
)
from decode_tonal_langauge_tpu_torch.ops.lstm import TimeBatchedLSTM
from decode_tonal_langauge_tpu_torch.ops.stencil import stencil_conv_pool_leaky

TOL = dict(atol=2e-5, rtol=1e-5)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _variables(model, *inputs, seed=0):
    v = model.init({"params": jax.random.key(seed)}, *inputs, train=False)
    return jax.tree_util.tree_map(np.asarray, v)


def _run_both(jmodel, tmodel, inputs, variables=None):
    variables = variables or _variables(jmodel, *inputs)
    ref = np.asarray(jmodel.apply(variables, *inputs, train=False))
    load_flax_variables(tmodel, variables).eval()
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(i) for i in inputs)).numpy()
    assert got.shape == ref.shape
    return got, ref


@pytest.mark.parametrize("k,pool,t", [(3, 2, 21), (7, 2, 40), (3, 1, 10)])
def test_stencil_matches_jax(k, pool, t):
    x, kernel, bias = _rand((2, t, 5)), _rand((k, 1, 1, 8), 1), _rand(8, 2)
    ref = jstencil(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
                   pool=pool, negative_slope=0.01, dtype=jnp.float32)
    got = stencil_conv_pool_leaky(
        torch.from_numpy(x), torch.from_numpy(kernel.reshape(k, 8)),
        torch.from_numpy(bias), pool=pool, negative_slope=0.01,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_lstm_matches_jax():
    x = _rand((3, 7, 5))
    jm = JLSTM(6)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0), x))
    ref = np.asarray(jm.apply(v, x))
    tm = TimeBatchedLSTM(5, 6)
    tm.load_state_dict(flax_to_state_dict(v, tm))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)  # test_ops_lstm.py:45


def test_cnn_classifier():
    got, ref = _run_both(
        jdeep.CNNClassifier(input_channels=3, input_length=128, n_classes=4),
        deep.CNNClassifier(3, 128, 4), [_rand((2, 3, 128))],
    )
    np.testing.assert_allclose(got, ref, **TOL)


def test_cnnrnn_classifier():
    got, ref = _run_both(
        jdeep.CNNRNNClassifier(input_channels=3, input_length=40, n_classes=4,
                               lstm_dim=80),
        deep.CNNRNNClassifier(3, 40, 4, lstm_dim=80), [_rand((2, 3, 40))],
    )
    np.testing.assert_allclose(got, ref, **TOL)


def test_synthesis_lite_with_running_stats():
    jm = jsyn.SynthesisLite(output_dim=24, n_channels=5, n_timepoints=40)
    inputs = [_rand((2, 5, 40)), _rand((2, 2, 6), 1)]
    v = _variables(jm, *inputs)
    rng = np.random.default_rng(3)
    v["batch_stats"] = {
        name: {"mean": rng.standard_normal(s["mean"].shape).astype(np.float32),
               "var": (rng.random(s["var"].shape) + 0.5).astype(np.float32)}
        for name, s in v["batch_stats"].items()
    }
    got, ref = _run_both(jm, synthesis.SynthesisLite(24, 5, 40), inputs, v)
    np.testing.assert_allclose(got, ref, **TOL)


def test_synthesis_model_cnn():
    got, ref = _run_both(
        jsyn.SynthesisModelCNN(output_dim=24, n_channels=5, n_timepoints=64),
        synthesis.SynthesisModelCNN(24, 5, 64),
        [_rand((2, 5, 64)), _rand((2, 2, 6), 1)],
    )
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("name", ["logistic", "ShallowNN"])
def test_simple_classifiers(name):
    jcls = {"logistic": jsimple.LogisticRegressionClassifier,
            "ShallowNN": jsimple.ShallowNNClassifier}[name]
    got, ref = _run_both(
        jcls(input_dim=30, n_classes=3),
        get_classifier_by_name(name, 3, 3, 10), [_rand((4, 3, 10))],
    )
    np.testing.assert_allclose(got, ref, **TOL)


def test_factory_names_and_dtype():
    assert isinstance(get_classifier_by_name("CNN", 2, 3, 128), deep.CNNClassifier)
    assert isinstance(
        get_classifier_by_name("models.deep_classifiers.CNNRNNClassifier", 2, 3,
                               40, {"lstm_dim": 80}),
        deep.CNNRNNClassifier,
    )
    assert isinstance(get_classifier_by_name("logistic", 2, 3, 4),
                      simple.LogisticRegressionClassifier)
    assert isinstance(build_synthesis_model("SynthesisFull", 8, 3, 64),
                      synthesis.SynthesisModelCNN)
    # A compute dtype builds a bf16 model whose parameters stay float32,
    # an unknown or non-floating name raises, and classes without a dtype
    # (logistic, ShallowNN) drop it, as JAX's dataclass-field filter does.
    bf16 = get_classifier_by_name("CNN", 2, 3, 128, {"dtype": "bfloat16"})
    assert bf16.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    syn = build_synthesis_model("SynthesisLite", 8, 3, 64, dtype="bfloat16")
    assert syn.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in syn.parameters())
    for bad in ("bfloat17", "int32"):
        with pytest.raises(ValueError, match="compute dtype"):
            get_classifier_by_name("CNN", 2, 3, 128, {"dtype": bad})
    assert isinstance(get_classifier_by_name("logistic", 2, 3, 4, {"dtype": "bfloat16"}),
                      simple.LogisticRegressionClassifier)
    with pytest.raises(ValueError, match="Unknown"):
        get_classifier_by_name("Transformer", 2, 3, 128)


def test_init_params_is_seeded():
    a = init_params(deep.CNNRNNClassifier(2, 40, 3, lstm_dim=80), seed=5)
    b = init_params(deep.CNNRNNClassifier(2, 40, 3, lstm_dim=80), seed=5)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    wh = a.lstm1.wh.detach()[:, :80]  # one gate's recurrent kernel is orthogonal
    np.testing.assert_allclose((wh.T @ wh).numpy(), np.eye(80), atol=1e-5)
