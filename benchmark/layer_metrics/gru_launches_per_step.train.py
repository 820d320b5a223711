"""Device operations (kernels, copies, memsets) a train step launches in
the GRU layers: under the port's ``gru.forward``, ``gru.reverse`` and
``gru.weight_grads`` spans (``ops/gru.py``), in the step traced with the
host's ops; from ``torch.profiler``."""

from benchmark.harness.spans import launches


def read(m):
    return launches(m, lambda name: name.startswith("gru."))
