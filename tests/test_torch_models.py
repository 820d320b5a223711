"""The port's stencil, LSTM and models against the JAX package.

Each Flax model is initialised with ``model.init``, its variables are
carried across with ``convert.py``, and both sides run the same seeded
numpy inputs. Tolerance atol 2e-5 / rtol 1e-5 (the stencil oracle's in
``tests/test_models.py``) unless a case says otherwise.

The port's own initial weights (``init_params``) are held to Flax's
``init`` as distributions: every LeCun-normal draw (dense, convolution
and stencil kernels, LSTM input kernels) times the square root of its
fan-in, pooled over a model, on both sides. Flax draws a normal cut at
+-2 and divides by its standard deviation 0.87962566, so no standardized
weight exceeds 2 / 0.87962566 (plus 1e-6 of float32 rounding); the pools'
standard deviations agree within 2%, their kurtoses within 0.1 (2.37 cut,
3.0 uncut), and a two-sample Kolmogorov-Smirnov test on 200,000 draws of
each does not reject at p 1e-3. Parameter counts (``count_params``,
``layer_param_counts``) equal JAX's exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decode_tonal_langauge_tpu.models import base as jbase
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
from decode_tonal_langauge_tpu_torch.models.base import (
    count_params,
    init_params,
    layer_param_counts,
)
from decode_tonal_langauge_tpu_torch.models.factory import (
    build_synthesis_model,
    get_classifier_by_name,
)
from decode_tonal_langauge_tpu_torch.ops.lstm import TimeBatchedLSTM
from decode_tonal_langauge_tpu_torch.ops.stencil import (
    StencilConvPoolLeaky,
    stencil_conv_pool_leaky,
)

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


# The paper models at narrow inputs; the CNN-RNN keeps lstm_dim 800.
_INIT_CASES = {
    "CNN": (lambda: jdeep.CNNClassifier(input_channels=3, input_length=128, n_classes=4),
            lambda: deep.CNNClassifier(3, 128, 4), [(2, 3, 128)]),
    "CNN-RNN": (lambda: jdeep.CNNRNNClassifier(input_channels=3, input_length=40,
                                               n_classes=4, lstm_dim=800),
                lambda: deep.CNNRNNClassifier(3, 40, 4, lstm_dim=800), [(2, 3, 40)]),
    "SynthesisLite": (lambda: jsyn.SynthesisLite(output_dim=24, n_channels=5,
                                                 n_timepoints=40),
                      lambda: synthesis.SynthesisLite(24, 5, 40), [(2, 5, 40), (2, 2, 6)]),
    "SynthesisModelCNN": (lambda: jsyn.SynthesisModelCNN(output_dim=24, n_channels=5,
                                                         n_timepoints=64),
                          lambda: synthesis.SynthesisModelCNN(24, 5, 64),
                          [(2, 5, 64), (2, 2, 6)]),
}
_TRUNCATED_MAX = 2 / 0.87962566103423978


@functools.lru_cache(maxsize=None)
def _init_case_variables(name):
    """Flax's variables of an ``_INIT_CASES`` model from key 1 (jitted:
    the CNN-RNN's eager init is several times slower), and its inputs."""
    jmodel, _, shapes = _INIT_CASES[name]
    model, inputs = jmodel(), [_rand(s, i) for i, s in enumerate(shapes)]
    init = jax.jit(lambda key: model.init({"params": key}, *inputs, train=False))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.key(1))), inputs


def _flax_lecun_pool(variables) -> np.ndarray:
    """Flax's LeCun-normal kernels times sqrt(fan-in) (prod(shape[:-1])),
    the orthogonal recurrent kernels (``cell/h*``) left out."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]:
        names = [getattr(k, "key", "") for k in path]
        if names[-1] != "kernel" or (len(names) > 2 and names[-2].startswith("h")
                                     and names[-3] == "cell"):
            continue
        leaf = np.asarray(leaf, np.float64)
        out.append(leaf.ravel() * np.sqrt(np.prod(leaf.shape[:-1])))
    return np.concatenate(out)


def _port_lecun_pool(module) -> np.ndarray:
    """The port's LeCun-normal tensors times sqrt(fan-in), by
    ``init_params``'s fan-in rules."""
    out = []
    for m in module.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)):
            w, fan_in = m.weight, m.weight[0].numel()
        elif isinstance(m, torch.nn.Linear):
            w, fan_in = m.weight, m.in_features
        elif isinstance(m, StencilConvPoolLeaky):
            w, fan_in = m.weight, m.weight.shape[0]
        elif isinstance(m, TimeBatchedLSTM):
            w, fan_in = m.wi, m.wi.shape[0]
        else:
            continue
        out.append(w.detach().double().numpy().ravel() * np.sqrt(fan_in))
    return np.concatenate(out)


def _kurtosis(x: np.ndarray) -> float:
    z = x - x.mean()
    return float((z ** 4).mean() / (z ** 2).mean() ** 2)


@pytest.mark.parametrize("name", list(_INIT_CASES))
def test_init_params_draws_flax_truncated_lecun_normal(name):
    from scipy.stats import ks_2samp

    flax = _flax_lecun_pool(_init_case_variables(name)[0])
    port = _port_lecun_pool(init_params(_INIT_CASES[name][1](), seed=1))
    assert port.size == flax.size
    assert np.abs(port).max() <= _TRUNCATED_MAX + 1e-6, np.abs(port).max()
    assert np.abs(flax).max() <= _TRUNCATED_MAX + 1e-6  # the yardstick's own bound
    assert port.std() == pytest.approx(flax.std(), rel=0.02)
    assert abs(_kurtosis(port) - _kurtosis(flax)) <= 0.1, (_kurtosis(port), _kurtosis(flax))
    rng = np.random.default_rng(0)
    sample = lambda x: rng.choice(x, 200_000, replace=False)  # noqa: E731
    assert ks_2samp(sample(port), sample(flax)).pvalue > 1e-3


@pytest.mark.parametrize("name", ["logistic", "ShallowNN"] + list(_INIT_CASES))
def test_param_counts_equal_jax(name):
    """``count_params`` and ``layer_param_counts`` of the converted model
    (module and state dict) equal the JAX package's on its variables,
    including ``tests/test_models.py``'s pinned 123 (logistic 40 -> 3)."""
    if name in _INIT_CASES:
        variables, tm = _init_case_variables(name)[0], _INIT_CASES[name][1]()
    else:
        jcls = {"logistic": jsimple.LogisticRegressionClassifier,
                "ShallowNN": jsimple.ShallowNNClassifier}[name]
        tm = get_classifier_by_name(name, 3, 4, 10)
        variables = _variables(jcls(input_dim=40, n_classes=3), _rand((2, 4, 10)))
    load_flax_variables(tm, variables)
    want = jbase.count_params(variables["params"])
    assert count_params(tm) == count_params(tm.state_dict()) == want
    if name == "logistic":
        assert want == 123
    want_layers = jbase.layer_param_counts(variables)
    assert layer_param_counts(tm) == layer_param_counts(tm.state_dict()) == want_layers
