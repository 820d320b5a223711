"""Device operations (kernels, copies, memsets) one streamed window
launches in the LSTMs at batch 1 (the tone classifier's and the
synthesizer's label LSTM): under the port's ``lstm.*`` spans
(``ops/lstm.py``), in the window traced with the host's ops; from
``torch.profiler``."""

from benchmark.harness.spans import launches


def read(m):
    return launches(m, lambda name: name.startswith("lstm."))
