"""Device operations (kernels, copies, memsets) one streamed window
launches in the mel inversion: under the port's ``audio.nnls`` span and
its ``audio.nnls_setup`` (``utils/audio.py``, ``ops/griffinlim.py``), in the
window traced with the host's ops; from ``torch.profiler``."""

from benchmark.harness.spans import launches


def read(m):
    return launches(m, lambda name: name == "audio.nnls")
