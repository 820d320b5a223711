"""Device operations (kernels, copies, memsets) a train step launches, a
count that repeats exactly from step to step; from ``torch.profiler``."""


def read(m):
    return len(m.trace.device) / m.trace.units
