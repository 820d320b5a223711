"""Device milliseconds of the operations a train step launches under the
port's ``gru.*`` spans (``ops/gru.py``: the input projection and the
forward loop, the reverse loop, the time-batched weight gradients), in the
step traced with the host's ops; from ``torch.profiler``."""

from benchmark.harness.spans import device_ms


def read(m):
    return device_ms(m, lambda name: name.startswith("gru."))
