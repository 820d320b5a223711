"""Device operations (kernels, copies, memsets) one streamed window
launches in Griffin-Lim: under the port's ``audio.griffinlim`` span
(``ops/griffinlim.py``, ``ops/stft.py``), in the window traced with the
host's ops; from ``torch.profiler``."""

from benchmark.harness.spans import launches


def read(m):
    return launches(m, lambda name: name == "audio.griffinlim")
