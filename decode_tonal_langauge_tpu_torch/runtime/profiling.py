"""Profiling hooks and layer spans.

Counterpart of ``decode_tonal_langauge_tpu/runtime/profiling.py``: every
pipeline stage can run inside a ``torch.profiler`` trace, written as a
Chrome trace file, and a :class:`StageTimer` sums named wall-clock spans.

Layer spans. The port marks its layer boundaries with :func:`span` (the
trainers' steps, the seed stack, the LSTM's loops, NAdam, the decoder's
parts, the mel inversion and Griffin-Lim). A span only reads clocks on
the host: it never synchronises the device, launches no work and changes
no number the program computes. It has three states:

- **off** (no profiler running, no :func:`recording` active): the span is
  a shared no-op context, one check of the profiler's flag and one
  module-level read;
- **under a profiler** (``torch.profiler`` with CPU activity): it opens
  ``torch.profiler.record_function(name)``, so the trace holds a
  ``user_annotation`` of that name on the profiler's own clock, and the
  kernels launched inside it are placed under it (a profiler with CUDA
  activity alone turns this state on too, but its trace holds no
  annotation);
- **inside** :func:`recording`: it appends (name, start ns, end ns, parent
  index, thread id) to the in-memory :class:`Recording`, timed with
  ``time.perf_counter_ns``.

Spans sit at layer boundaries only, never inside a per-time-step,
per-tensor or per-iteration loop: entering ``record_function`` costs
~12 µs on the host, even with no profiler running.

A recording converts its times to a profiler trace's timeline through one
anchor pair read together at its start (``perf_counter_ns``,
``time_ns``): a Chrome trace exported by ``torch.profiler`` carries
``baseTimeNanoseconds``, and an event's ``ts`` (µs) is its Unix time in
µs minus ``baseTimeNanoseconds / 1000``. Checked on torch 2.13 (CPU) and
on torch 2.11 with CUDA 12.8 on an H100 (CPU and CUDA activity,
``scripts/span_costs_torch.py``): a recorded span lies inside its own
``user_annotation``, its start 54-70 µs after the annotation's and its
end 58-86 µs before it.

Timing on a CUDA card, for ``chip_smoke.py`` and ``scripts/``:
:func:`time_ms` (milliseconds of one call made back to back with others,
between two CUDA events), :func:`device_events` (the device work of one
call by name, from ``torch.profiler``, no host time in it) and
:func:`kernel_ms` (device milliseconds of named kernels per call).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

_profiler_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_recording: Optional["Recording"] = None  # the active recording, if any


class SpanRecord:
    """One recorded span: ``name``, ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns``'s clock (``end_ns`` None while open), the
    index of its ``parent`` (the innermost span open on the same thread
    when it opened; None for none) and its ``thread`` id."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread")

    def __init__(self, name: str, start_ns: int, parent: Optional[int], thread: int) -> None:
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.thread = parent, thread

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recording:
    """Spans kept in memory, in the order they opened, from every thread
    (autograd runs a CUDA backward on a thread of its own)."""

    def __init__(self) -> None:
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self.spans: List[SpanRecord] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _open(self, name: str) -> int:
        stack = self._local.__dict__.setdefault("stack", [])
        thread = threading.get_ident()
        with self._lock:
            index = len(self.spans)
            self.spans.append(SpanRecord(name, time.perf_counter_ns(),
                                         stack[-1] if stack else None, thread))
        stack.append(index)
        return index

    def _close(self, index: int) -> None:
        self.spans[index].end_ns = time.perf_counter_ns()
        self._local.stack.pop()

    def trace_us(self, t_ns: int, base_time_ns: int) -> float:
        """``perf_counter_ns`` time ``t_ns`` on the timeline of a Chrome
        trace whose ``baseTimeNanoseconds`` is ``base_time_ns``: its Unix
        time in µs less ``base_time_ns / 1000``."""
        return (t_ns - self.anchor[0] + self.anchor[1] - base_time_ns) / 1e3

    def durations(self, name: str) -> List[float]:
        """Seconds of every closed span called ``name``, in order."""
        return [s.seconds for s in self.spans if s.name == name and s.end_ns is not None]

    def self_ns(self) -> List[int]:
        """Each span's self time: its duration less the part its children
        on the same thread cover (0 for a span still open)."""
        own = [s.end_ns - s.start_ns if s.end_ns is not None else 0 for s in self.spans]
        out = list(own)
        for s, d in zip(self.spans, own):
            if s.parent is not None and s.end_ns is not None:
                out[s.parent] -= d
        return out

    def by_name(self) -> Dict[str, Dict[str, float]]:
        """{name: {"count", "total_s", "self_s"}} over the closed spans."""
        table: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "total_s": 0.0, "self_s": 0.0})
        for s, own in zip(self.spans, self.self_ns()):
            if s.end_ns is None:
                continue
            row = table[s.name]
            row["count"] += 1
            row["total_s"] += s.seconds
            row["self_s"] += own / 1e9
        return dict(table)


class _Span:
    __slots__ = ("name", "rec", "index", "annotation")

    def __init__(self, name: str, rec: Optional[Recording]) -> None:
        self.name, self.rec, self.index, self.annotation = name, rec, None, None

    def __enter__(self) -> "_Span":
        if _profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        if self.rec is not None:
            self.index = self.rec._open(self.name)
        return self

    def __exit__(self, *exc) -> None:
        if self.index is not None:
            self.rec._close(self.index)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)


def span(name: str):
    """A context marking one layer boundary (module docstring); a shared
    no-op when no profiler runs and no recording is active."""
    rec = _recording
    if rec is None and not _profiler_enabled():
        return _OFF
    return _Span(name, rec)


@contextlib.contextmanager
def recording(rec: Optional[Recording] = None) -> Iterator[Recording]:
    """Record every span of the block, on every thread, into ``rec`` (a
    new :class:`Recording` by default), which it yields."""
    global _recording
    rec = Recording() if rec is None else rec
    outer, _recording = _recording, rec
    try:
        yield rec
    finally:
        _recording = outer


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, name: str = "trace"):
    """``torch.profiler`` over the block (the host, and the card where
    there is one), written to ``<log_dir>/<name>.<ns>.pt.trace.json``;
    no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"{name}.{time.time_ns()}.pt.trace.json")
    )


class StageTimer:
    """Named wall-clock stage spans with a printable summary: a view over
    a :class:`Recording`, so the layer spans a stage runs are recorded as
    its descendants."""

    def __init__(self) -> None:
        self.recording = Recording()
        self._stages: List[int] = []

    @contextlib.contextmanager
    def span(self, name: str):
        with recording(self.recording), _Span(name, self.recording) as s:
            try:
                yield
            finally:
                self._stages.append(s.index)

    @property
    def spans(self) -> Dict[str, float]:
        """Seconds by stage name, summed over the stage's spans."""
        out: Dict[str, float] = {}
        for i in self._stages:
            s = self.recording.spans[i]
            if s.end_ns is not None:
                out[s.name] = out.get(s.name, 0.0) + s.seconds
        return out

    def summary(self) -> str:
        spans = self.spans
        total = sum(spans.values()) or 1.0
        lines = [
            f"{name}: {secs:.3f}s ({100 * secs / total:.1f}%)"
            for name, secs in sorted(spans.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)

    def layers(self, top: int = 5) -> str:
        """The ``top`` layer spans (the stages left out), one line each,
        the most self time first."""
        stages = {self.recording.spans[i].name for i in self._stages}
        rows = sorted(((k, v) for k, v in self.recording.by_name().items() if k not in stages),
                      key=lambda kv: -kv[1]["self_s"])[:top]
        return "\n".join(f"{k}: self {v['self_s']:.3f}s, total {v['total_s']:.3f}s, "
                         f"{int(v['count'])} calls" for k, v in rows)


def time_ms(fn: Callable, warmup: int = 2, runs: int = 20) -> float:
    """Milliseconds a call of ``fn`` takes on the card: ``runs`` calls back
    to back between two CUDA events, after ``warmup`` calls, so the host's
    work for one call overlaps the card's work for the one before."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def device_events(fn: Callable, runs: int = 20) -> List[Tuple[float, float, str]]:
    """Device work per call of ``fn`` over ``runs`` calls, after two
    warm-up calls, from ``torch.profiler`` tracing the card only (kernels,
    copies, memsets): (milliseconds, launches, name) per call for each
    name the profiler reports, largest first."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        total_us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if total_us:
            rows.append((total_us / runs / 1e3, e.count / runs, e.key))
    return sorted(rows, reverse=True)


def kernel_ms(
    fn: Callable, kernels: Sequence[Tuple[str, ...]], runs: int = 20
) -> Optional[List[float]]:
    """Mean device milliseconds per call of ``fn`` spent in each kernel of
    ``kernels`` (see :func:`device_events`). A kernel is named by
    substrings that all occur in the profiler's name for it. None if the
    profiler saw no device time for one of them."""
    found: List[Optional[float]] = [None] * len(kernels)
    for ms, _, name in device_events(fn, runs):
        for i, parts in enumerate(kernels):
            if all(p in name for p in parts):
                found[i] = (found[i] or 0.0) + ms
    return None if None in found else found
