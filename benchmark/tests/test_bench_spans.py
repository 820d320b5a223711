"""The reader of the port's layer spans (``harness/spans.py``) on a
synthetic trace of two host threads: the main thread's step with its
seed-stack and optimizer spans, and autograd's device thread with an
LSTM reverse span; kernels launched on each, one outside every span."""

from types import SimpleNamespace

from benchmark.harness.spans import Spans, device_ms, launches
from benchmark.harness.trace import Trace

MAIN, AUTOGRAD, OTHER = 1, 2, 3


def _span(name, tid, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid, "ts": ts, "dur": dur}


def _op(ext, tid, ts, dur=5):
    return {"ph": "X", "cat": "cpu_op", "name": f"aten::op{ext}", "tid": tid, "ts": ts,
            "dur": dur, "args": {"External id": ext}}


def _kernel(ext, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": f"kernel{ext}", "tid": 7, "ts": ts, "dur": dur,
            "args": {"External id": ext}}


def _events(port_spans=True):
    spans = [_span("trainer.step", MAIN, 0, 1000),
             _span("seed_stack.grad_step", MAIN, 100, 800),
             _span("optim.nadam", MAIN, 920, 70),
             _span("lstm.reverse", AUTOGRAD, 300, 200)] if port_spans else []
    ops = [_op(1, MAIN, 150),        # the forward, on the main thread: grad_step
           _op(2, AUTOGRAD, 350),    # the LSTM's reverse loop: lstm.reverse
           _op(3, AUTOGRAD, 360),
           _op(4, AUTOGRAD, 600),    # the backward outside the LSTM: grad_step, by time
           _op(5, MAIN, 950),        # optim.nadam
           _op(6, MAIN, 995, 2),     # the step itself
           _op(7, OTHER, 1500)]      # outside every span
    kernels = [_kernel(k, 2000 + 10 * k, d)
               for k, d in ((1, 4), (2, 3), (3, 3), (4, 5), (5, 2), (6, 1), (7, 6))]
    return ([_span("bench.window", MAIN, -10, 3000), _span("bench.decode", MAIN, 0, 1000)]
            + spans + ops + kernels)


def test_each_kernel_goes_to_the_innermost_span_of_its_launching_op():
    spans = Spans(Trace(_events(), units=1))
    assert spans.names() == {"trainer.step", "seed_stack.grad_step", "optim.nadam",
                             "lstm.reverse"}
    owners = [spans.owner_name(k) for k in range(len(spans.trace.device))]
    assert owners == ["seed_stack.grad_step", "lstm.reverse", "lstm.reverse",
                      "seed_stack.grad_step", "optim.nadam", "trainer.step", None]
    # under a span: its own kernels and those of spans inside it on its thread
    under_step = spans.under(lambda n: n == "trainer.step")
    assert [e["name"] for e in under_step] == ["kernel1", "kernel4", "kernel5", "kernel6"]
    grad_step = spans.under(lambda n: n == "seed_stack.grad_step")
    assert [e["name"] for e in grad_step] == ["kernel1", "kernel4"]


def test_the_metrics_count_and_time_the_kernels_under_their_spans():
    m = SimpleNamespace(detail_trace=Trace(_events(), units=1))
    lstm = lambda n: n.startswith("lstm.")  # noqa: E731
    assert launches(m, lstm) == 2 and device_ms(m, lstm) == 6e-3
    nadam = lambda n: n == "optim.nadam"  # noqa: E731
    assert launches(m, nadam) == 1 and device_ms(m, nadam) == 2e-3


def test_a_trace_without_the_port_spans_reads_nothing():
    m = SimpleNamespace(detail_trace=Trace(_events(port_spans=False), units=1))
    assert launches(m, lambda n: n.startswith("lstm.")) is None
    assert device_ms(m, lambda n: n == "optim.nadam") is None
    assert launches(SimpleNamespace(detail_trace=None), lambda n: True) is None
