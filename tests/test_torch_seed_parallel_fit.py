"""The batched fit of 3 seeds against each seed's loop fit, for the
logistic, shallow and CNN classifiers (the CNN-RNN case is in
``tests/test_torch_seed_parallel_rnn.py``). Part (a) of
``tests/test_torch_seed_parallel.py``, whose docstring states the rules
and whose helpers build the data; it has a file of its own so that
``--dist loadfile`` runs it on a worker of its own."""

import numpy as np
import pytest

from test_torch_seed_parallel import (  # noqa: F401  (_one_thread: autouse)
    _MODELS,
    SEEDS,
    _assert_rows_close,
    _one_thread,
    _separable,
    _stacks,
)
from decode_tonal_langauge_tpu_torch.training.seed_parallel import SeedParallelTrainer
from decode_tonal_langauge_tpu_torch.training.trainer import ClassifierTrainer


def check_batched_fit_equals_the_seed_loop(name):
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


@pytest.mark.parametrize("name", ["logistic", "shallow", "cnn"])
def test_batched_fit_equals_the_seed_loop(name):
    check_batched_fit_equals_the_seed_loop(name)
