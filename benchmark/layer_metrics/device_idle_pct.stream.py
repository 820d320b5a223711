"""The device's idle share of the traced window: 100 x (1 - the union of
its kernels, copies and memsets over the window), from ``torch.profiler``."""


def read(m):
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
