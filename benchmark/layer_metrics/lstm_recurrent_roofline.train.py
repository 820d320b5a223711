"""The LSTMs' recurrent products' share of their roofline in a train
step: the forward loop's ``h @ wh`` and the reverse loop's ``da @ wh^T``,
one a time step, found by their operand shapes in the trace of one step
taken with input shapes.
Their least time (each weight byte read once, the left operand read and
the result written, at 3.35 TB/s, or their FLOPs at 67 TFLOP/s, whichever
is longer; ``flops/<config>.py``) over their device time. Nothing is
read where the trace does not hold exactly one such product a time step
of each loop."""

from benchmark.harness.trace import matches


def read(m):
    trace = m.detail_trace
    if trace is None:
        return None
    least = seconds = 0.0
    products = m.flops.lstm_recurrent_products(m.cfg, m.mix["seeds"], m.mix["batch"])
    for _, shapes, count, flops, nbytes in products:
        found, s = trace.kernels_of_ops(lambda op: matches(op, shapes))
        if found != count * trace.units or s <= 0:
            return None
        least += found * m.peaks.least_seconds(flops, nbytes)
        seconds += s
    return 100.0 * least / seconds
