"""Device operations (kernels, copies, memsets) a train step launches in
the optimizer: under the port's ``optim.nadam`` span (``training/optim.py``,
``NAdam.step``), in the step traced with the host's ops; from
``torch.profiler``."""

from benchmark.harness.spans import launches


def read(m):
    return launches(m, lambda name: name == "optim.nadam")
