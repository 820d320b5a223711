"""Device milliseconds of the operations a train step launches under the
port's ``ctc.*`` spans (``training/ctc.py``: the loss, ``ctc.loss``, and
its gradient, ``ctc.grad``), in the step traced with the host's ops; from
``torch.profiler``."""

from benchmark.harness.spans import device_ms


def read(m):
    return device_ms(m, lambda name: name.startswith("ctc."))
