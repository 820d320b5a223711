"""The port's training core against the JAX package: the LSTM backward,
the NAdam update and one train step.

The same seeded numpy inputs (and, for models, the JAX initial weights
carried across by ``convert.py``) go through both packages on the CPU.
Tolerances: the LSTM's values rtol 1e-5 / atol 1e-6 and gradients rtol
2e-4 / atol 1e-5 (``tests/test_ops_lstm.py``); the NAdam update rtol 1e-5
/ atol 1e-7 on parameters and moments (both sides do the same float32
operations; the bias corrections may round one ulp apart); a train step
rtol 1e-5 / atol 1e-6 on the loss and rtol 1e-4 / atol 1e-6 on the
updated parameters (the fit tolerance of ``tests/test_resume.py``).

One exemption, with its reason: NAdam's step is ``g / (|g| + eps)``
scaled, so for an element whose gradient (decay term included) is within
a hundred ``eps`` (1e-6) of zero, the step's size is set by the last
digits of a cancelling sum, which two frameworks round differently. Such
elements (30 of 786,432 in one CNN layer here) may differ by up to one
whole step; every other element is held to the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from decode_tonal_langauge_tpu.models import deep as jdeep
from decode_tonal_langauge_tpu.models import simple as jsimple
from decode_tonal_langauge_tpu.ops.lstm import lstm_sequence as jlstm
from decode_tonal_langauge_tpu.training.optim import (
    nadam_with_decay_groups as jnadam,
)
from decode_tonal_langauge_tpu.training.trainer import (
    ClassifierTrainer as JTrainer,
)
from decode_tonal_langauge_tpu_torch.convert import (
    flax_to_state_dict,
    load_flax_variables,
)
from decode_tonal_langauge_tpu_torch.models import deep, simple
from decode_tonal_langauge_tpu_torch.ops.dropout import Dropout, set_dropout_generator
from decode_tonal_langauge_tpu_torch.ops.lstm import LSTMSequence, lstm_sequence
from decode_tonal_langauge_tpu_torch.training.optim import NAdam, decay_mask
from decode_tonal_langauge_tpu_torch.training.trainer import (
    ClassifierTrainer,
    _macro_accuracy,
)


def _lstm_inputs(rng, b, t, i, h, dtype=np.float32):
    x = rng.standard_normal((b, t, i))
    h0 = 0.5 * rng.standard_normal((b, h))
    c0 = 0.5 * rng.standard_normal((b, h))
    wi = 0.4 * rng.standard_normal((i, 4 * h))
    wh = 0.4 * rng.standard_normal((h, 4 * h))
    bias = 0.1 * rng.standard_normal(4 * h)
    return [a.astype(dtype) for a in (x, h0, c0, wi, wh, bias)]


def test_lstm_values_and_all_six_gradients_match_jax_grad():
    rng = np.random.default_rng(1)
    inputs = _lstm_inputs(rng, 4, 7, 5, 6)
    cot = rng.standard_normal((4, 7, 6)).astype(np.float32)

    ref_out = np.asarray(jlstm(*map(jnp.asarray, inputs)))
    ref_grads = jax.grad(
        lambda *a: jnp.sum(jlstm(*a) * cot), argnums=tuple(range(6))
    )(*map(jnp.asarray, inputs))

    tensors = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = lstm_sequence(*tensors)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=1e-5, atol=1e-6)
    for name, t, rg in zip(("x", "h0", "c0", "wi", "wh", "b"), tensors, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(rg),
                                   rtol=2e-4, atol=1e-5, err_msg=name)


def test_lstm_backward_gradcheck_f64():
    rng = np.random.default_rng(3)
    inputs = tuple(
        torch.tensor(a, requires_grad=True)
        for a in _lstm_inputs(rng, 2, 3, 2, 3, dtype=np.float64)
    )
    assert torch.autograd.gradcheck(lambda *a: LSTMSequence.apply(*a)[0], inputs)


def _loop_lstm(x, h0, c0, wi, wh, b):
    """The port's forward before it had a backward, as the oracle that the
    forward result is unchanged."""
    xg = torch.einsum("bti,ih->bth", x, wi) + b
    h, c = h0, c0
    hs = []
    for t in range(x.shape[1]):
        gates = xg[:, t] + h @ wh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def test_lstm_forward_unchanged_with_and_without_grad():
    inputs = [torch.from_numpy(a) for a in _lstm_inputs(np.random.default_rng(4), 3, 9, 4, 5)]
    want = _loop_lstm(*inputs)
    with torch.no_grad():
        assert torch.equal(lstm_sequence(*inputs), want)
    with_grad = [t.clone().requires_grad_() for t in inputs]
    assert torch.equal(lstm_sequence(*with_grad).detach(), want)


# ----------------------------------------------------------------------
# NAdam
_SHAPES = {"b": (4,), "k": (2, 3, 4), "w": (3, 4)}  # sorted: JAX leaf order


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("weight_decay,moment_dtype", [
    (0.0, None), (0.01, None), (0.01, "bfloat16"),
])
def test_nadam_matches_optax(steps, weight_decay, moment_dtype):
    rng = np.random.default_rng(steps)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in _SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in _SHAPES.items()}
             for _ in range(steps)]
    lr = 1e-2

    opt = jnadam(lr, weight_decay, moment_dtype=moment_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)

    tp = [torch.tensor(params[k]) for k in _SHAPES]
    topt = NAdam(tp, lr, weight_decay, moment_dtype=moment_dtype)
    for g in grads:
        topt.step([torch.tensor(g[k]) for k in _SHAPES])

    assert topt.count == steps
    mu = optax_tree_get(state, "mu")
    nu = optax_tree_get(state, "nu")
    for i, k in enumerate(_SHAPES):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
        for got, want in ((topt.mu[i], mu[k]), (topt.nu[i], nu[k])):
            assert got.dtype == (torch.bfloat16 if moment_dtype else torch.float32)
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32), rtol=1e-5, atol=1e-7)


def optax_tree_get(state, key):
    return optax.tree_utils.tree_get(state, key)


def test_nadam_decays_only_ndim_ge_2():
    w = torch.ones(3, 4)
    b = torch.ones(4)
    assert decay_mask([w, b]) == [True, False]
    opt = NAdam([w, b], 1e-2, weight_decay=0.1)
    opt.step([torch.zeros(3, 4), torch.zeros(4)])
    assert torch.equal(b, torch.ones(4))  # zero gradient, no decay
    assert (w < 1).all()  # the L2 term alone moved the weight


def test_nadam_state_round_trips():
    rng = np.random.default_rng(0)
    p = [torch.tensor(rng.standard_normal((3, 2)).astype(np.float32))]
    opt = NAdam(p, 1e-3, moment_dtype="bfloat16")
    opt.step([torch.ones(3, 2)])
    fresh = NAdam([p[0].clone()], 1e-3, moment_dtype="bfloat16")
    fresh.load_state_dict(opt.state_dict())
    assert fresh.count == 1 and torch.equal(fresh.mu[0], opt.mu[0])
    with pytest.raises(ValueError):
        NAdam(p, 1e-3).load_state_dict(opt.state_dict())  # f32 vs bf16 moments


# ----------------------------------------------------------------------
def test_dropout_draws_from_its_generator():
    drop = Dropout(0.5).train()
    x = torch.ones(64, 32)
    set_dropout_generator(drop, torch.Generator().manual_seed(3))
    a = drop(x)
    set_dropout_generator(drop, torch.Generator().manual_seed(3))
    assert torch.equal(a, drop(x))
    assert set(a.unique().tolist()) == {0.0, 2.0}  # kept units scaled by 1/(1-p)
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(Dropout(0.0).train()(x), x)


def test_macro_accuracy_counts_present_classes_only():
    y = torch.tensor([0, 0, 1, 2, 2])
    preds = torch.tensor([0, 1, 1, 2, 0])
    w = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0])  # the last sample is padding
    # class 0: 1/2, class 1: 1/1, class 2: 1/1, class 3 absent
    assert _macro_accuracy(preds, y, w, 4).item() == pytest.approx((0.5 + 1 + 1) / 3)


# ----------------------------------------------------------------------
# One train step against the JAX trainer's _batch_step.
_MODELS = {
    "logistic": (lambda: jsimple.LogisticRegressionClassifier(input_dim=2 * 16, n_classes=3),
                 lambda: simple.LogisticRegressionClassifier(2 * 16, 3), 3, (2, 16)),
    "cnn": (lambda: jdeep.CNNClassifier(input_channels=2, input_length=128, n_classes=3,
                                        dropout_rate=0.0),
            lambda: deep.CNNClassifier(2, 128, 3, dropout_rate=0.0), 3, (2, 128)),
    "cnnrnn": (lambda: jdeep.CNNRNNClassifier(input_channels=2, input_length=40, n_classes=4,
                                              lstm_dim=80, dropout=0.0),
               lambda: deep.CNNRNNClassifier(2, 40, 4, lstm_dim=80, dropout=0.0), 4, (2, 40)),
}


NEAR_ZERO_GRAD = 1e-6  # 100 * NAdam's eps: the step's size is rounding there
MAX_STEP = 1.5  # |first NAdam step| <= (b1 / (1 - b1**2) * (1 - b1) + 1) * lr


def _state_close(got, want, grads, lr, rtol, atol):
    """Every element within tolerance, but for elements whose gradient is
    within NEAR_ZERO_GRAD of zero, which may differ by up to one step."""
    assert got.keys() == want.keys()
    for k in want:
        g, w, grad = got[k].numpy(), want[k].numpy(), grads[k].numpy()
        off = ~np.isclose(g, w, rtol=rtol, atol=atol)
        assert (np.abs(grad[off]) < NEAR_ZERO_GRAD).all(), (
            f"{k}: {int(off.sum())} elements off, gradients up to "
            f"{np.abs(grad[off]).max()}")
        assert (np.abs(g - w)[off] <= MAX_STEP * lr).all(), k


def _step_grads(trainer, x, y, w, weight_decay):
    """The gradient the step hands NAdam at the current weights, decay term
    included (the port's; JAX's agrees with it but for rounding)."""
    from decode_tonal_langauge_tpu_torch.training.trainer import _batch_loss

    names, weights = zip(*trainer.model.named_parameters())
    loss = _batch_loss(trainer.model.train()(x), y, w)
    grads = torch.autograd.grad(loss, weights)
    return {k: g + weight_decay * p.detach() if p.ndim >= 2 else g
            for k, g, p in zip(names, grads, weights)}


@pytest.mark.parametrize("name", list(_MODELS))
def test_one_train_step_matches_jax(name):
    jmodel_fn, tmodel_fn, n_classes, shape = _MODELS[name]
    rng = np.random.default_rng(7)
    bsz = 8
    x = rng.standard_normal((bsz,) + shape).astype(np.float32)
    y = rng.integers(0, n_classes, bsz).astype(np.int32)
    w = np.ones(bsz, np.float32)
    w[-2:] = 0.0  # padding samples

    lr, wd = 1e-3, 0.01
    jt = JTrainer(jmodel_fn(), n_classes, learning_rate=lr, weight_decay=wd,
                  batch_size=bsz, seed=0)
    jt.init(x)
    variables = {"params": jax.tree.map(np.array, jt.params)}
    batch = tuple(map(jnp.asarray, (x, y, w)))
    carry = (jt.params, jt.batch_stats, jt.opt_state, jax.random.key(0))
    (new_params, _, _, _), (loss, acc) = jax.jit(jt._batch_step)(carry, batch)

    tt = ClassifierTrainer(tmodel_fn(), n_classes, learning_rate=lr, weight_decay=wd,
                           batch_size=bsz, seed=0, device="cpu")
    tt.init(x)
    load_flax_variables(tt.model, variables)
    t_batch = (torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(w))
    grads = _step_grads(tt, *t_batch, wd)
    t_loss, t_acc = tt.train_step(*t_batch)
    assert t_loss.item() == pytest.approx(float(loss), rel=1e-5, abs=1e-6)
    assert t_acc.item() == pytest.approx(float(acc), abs=1e-6)
    as_state = lambda tree: flax_to_state_dict(  # noqa: E731
        {"params": jax.tree.map(np.asarray, tree)}, tt.model)
    _state_close(tt.params, as_state(new_params), grads, lr, rtol=1e-4, atol=1e-6)
