"""Device operations (kernels, copies, memsets) a train step launches in
the LSTMs: under the port's ``lstm.forward``, ``lstm.reverse`` and
``lstm.weight_grads`` spans (``ops/lstm.py``), in the step traced with the
host's ops; from ``torch.profiler``."""

from benchmark.harness.spans import launches


def read(m):
    return launches(m, lambda name: name.startswith("lstm."))
