"""The batched fit of 3 seeds against each seed's loop fit for the
CNN-RNN (input length 40, lstm_dim 80), the slowest case of
``tests/test_torch_seed_parallel_fit.py``'s test, in a file of its own so
that ``--dist loadfile`` runs it on a worker of its own. The rules are in
``tests/test_torch_seed_parallel.py``'s docstring."""

import pytest

from test_torch_seed_parallel import _one_thread  # noqa: F401  (autouse)
from test_torch_seed_parallel_fit import check_batched_fit_equals_the_seed_loop


@pytest.mark.parametrize("name", ["cnnrnn"])
def test_batched_fit_equals_the_seed_loop(name):
    check_batched_fit_equals_the_seed_loop(name)
