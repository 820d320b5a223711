"""The GRU step kernel's share of its roofline in a train step: the
kernels named ``gru_stream_kernel`` or ``gru_gemm_kernel``
(``csrc/gru_step.cu``) under the port's ``gru.forward`` and
``gru.reverse`` spans, in the step traced with the host's ops, found by
span and kernel name. Each forward launch is one time step's recurrent
product of a layer (all its directions); each reverse loop launches one
such product a step but the first, whose launch forms deltas alone.
Their least time (each weight byte read once, the left operand read and
the result written, at 3.35 TB/s, or their FLOPs at 67 TFLOP/s, whichever
is longer; ``flops/<config>.py``) over their device time. Nothing is read
where the trace holds no such kernel."""

from benchmark.harness.spans import _detail

KERNELS = ("gru_stream_kernel<", "gru_gemm_kernel<")


def read(m):
    spans = _detail(m)
    if spans is None:
        return None
    names = [s["name"] for s in spans.spans]
    products = m.flops.gru_recurrent_products(m.cfg, m.mix["batch"])
    least = seconds = 0.0
    for part, reverse in (("forward", False), ("reverse", True)):
        found = [e for e in spans.under(lambda n, p=part: n == f"gru.{p}")
                 if any(k in e["name"] for k in KERNELS)
                 and (", true," in e["name"]) == reverse]
        if not found:
            return None
        launches = len(found) - (names.count("gru.reverse") if reverse else 0)
        least += launches * m.peaks.least_seconds(*products[part])
        seconds += sum(e["dur"] for e in found) / 1e6
    return 100.0 * least / seconds if seconds > 0 else None
