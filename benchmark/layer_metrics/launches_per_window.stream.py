"""Device operations (kernels, copies, memsets) one streamed window
launches through the decoder and Griffin-Lim; from ``torch.profiler``."""


def read(m):
    return len(m.trace.device) / m.trace.units
