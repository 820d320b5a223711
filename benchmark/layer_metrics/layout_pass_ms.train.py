"""Device milliseconds a train step spends in cuDNN's layout passes
(kernels whose name holds ``genericTranspose``), which wrap the seed
stack's grouped convolutions; from ``torch.profiler``."""


def read(m):
    return 1e3 * m.trace.device_seconds(lambda e: "genericTranspose" in e["name"]) / m.trace.units
