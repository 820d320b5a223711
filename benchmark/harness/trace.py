"""The profiler's trace of a short window, read into the numbers the
per-layer metrics and the ``breakdown`` need.

The traffic driver runs its traced units inside :func:`profiled`, which wraps
them in ``torch.profiler`` (host and device activity, with input shapes)
and a ``bench.window`` annotation that ends after a synchronise. The
trace is exported as a Chrome trace into the temporary directory, read
and deleted. Device activity is every kernel, copy and memset; the busy
time is the length of their union inside the window.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


class Trace:
    """The events of one traced window (times in seconds)."""

    def __init__(self, events: List[Dict], units: int, require_device: bool = True,
                 window_s: Optional[float] = None) -> None:
        """``window_s``, where given, is the window's host-clock length and
        every device event in ``events`` lies inside it (a device-only
        trace); else the window is the ``bench.window`` annotation."""
        self.units = units
        if window_s is None:
            spans = [e for e in events
                     if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
            if not spans:
                raise RuntimeError("the trace holds no bench.window annotation")
            self.t0, self.t1 = spans[0]["ts"] / 1e6, (spans[0]["ts"] + spans[0]["dur"]) / 1e6
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        if window_s is None:
            self.device = [e for e in self.device if self.t0 <= e["ts"] / 1e6 <= self.t1]
        else:
            first = min((e["ts"] / 1e6 for e in self.device), default=0.0)
            self.t0, self.t1 = first, first + window_s
        if require_device and not self.device:
            raise RuntimeError("the profiler saw no device activity in the window")
        self.host = [e for e in events if e.get("cat") in HOST_CATS and e.get("name") != WINDOW]
        self.ops_by_id = {e["args"]["External id"]: e for e in self.host
                          if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((max(e["ts"] / 1e6, self.t0), min((e["ts"] + e["dur"]) / 1e6, self.t1))
                       for e in self.device)
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged if b > a]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_seconds(self, keep: Callable[[Dict], bool] = lambda e: True) -> float:
        return sum(e["dur"] for e in self.device if keep(e)) / 1e6

    def kernels_of_ops(self, keep_op: Callable[[Dict], bool]) -> Tuple[int, float]:
        """(number of host ops that ``keep_op`` picks and that launched
        device work, their device seconds)."""
        ids, seconds = set(), 0.0
        for e in self.device:
            op = self.ops_by_id.get(e.get("args", {}).get("External id"))
            if op is not None and keep_op(op):
                ids.add(op["args"]["External id"])
                seconds += e["dur"] / 1e6
        return len(ids), seconds

    def _host_label(self, t: float) -> str:
        inside = [e for e in self.host if e["ts"] / 1e6 <= t <= (e["ts"] + e["dur"]) / 1e6]
        spans = [e for e in inside if e["name"].startswith("bench.")]
        ops = [e for e in inside if not e["name"].startswith("bench.")]
        span = max(spans, key=lambda e: e["dur"])["name"] if spans else ""
        op = min(ops, key=lambda e: e["dur"])["name"] if ops else "python"
        return f"{span} | {op}" if span else op

    def breakdown(self, top: int = 10, name_chars: int = 160) -> Dict[str, List]:
        by_name: Dict[str, float] = defaultdict(float)
        for e in self.device:
            by_name[e["name"][:name_chars]] += e["dur"] / 1e6
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        gaps = sorted(gaps, reverse=True)[:top]
        idle = [[self._host_label((a + b) / 2), g] for g, a, b in gaps]
        return {"device_ops": [[k, v] for k, v in device_ops], "idle_gaps": idle}


@contextlib.contextmanager
def profiled(device, holder: Dict, host_ops: bool = True, record_shapes: bool = False):
    """Profile the block; on exit ``holder["events"]`` holds the trace's
    complete events. With ``host_ops`` the host's operations are traced
    too (their names label the idle gaps; recording them slows a
    host-bound step two to three times) and the window is a
    ``bench.window`` annotation; without, only the card's activity is
    traced and ``holder["window_s"]`` is the block's host-clock length,
    both ending after a synchronise. ``record_shapes`` adds each host op's
    input shapes: under the port's seed-batched steps the profiler then
    keeps tens of GB a step alive (34 GB a CNN-RNN step on the card), so
    only a single step is traced so."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    host_ops = host_ops or not cuda  # a CPU run has no device activity to trace
    activities = ([ProfilerActivity.CPU] if host_ops else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW) if host_ops else contextlib.nullcontext():
            yield
            if cuda:
                torch.cuda.synchronize()
        if not host_ops:
            holder["window_s"] = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.remove(path)
    holder["events"] = [e for e in raw.get("traceEvents", raw) if e.get("ph") == "X"]


def capture(run: Callable, device) -> Dict[str, "Trace"]:
    """``run(profile)`` runs the traced units: ``profile()`` for the main
    window (the card's activity alone, so that tracing slows the host as
    little as it can), then one unit inside ``profile(host_ops=True)``,
    with ``record_shapes=True`` where a metric needs input shapes; it
    returns how many units the main window ran. Returns the traces by
    name: ``main`` and ``detail`` (of one unit, the host's ops too)."""
    import torch

    holders: Dict[str, Dict] = {}

    def profile(host_ops: bool = False, record_shapes: bool = False):
        return profiled(device, holders.setdefault("detail" if host_ops else "main", {}),
                        host_ops, record_shapes)

    units = run(profile)
    cuda = torch.device(device).type == "cuda"
    return {name: Trace(h["events"], units if name == "main" else 1, require_device=cuda,
                        window_s=h.get("window_s")) for name, h in holders.items()}


def matches(op: Dict, shapes: List[List[int]]) -> bool:
    dims: Optional[List] = op.get("args", {}).get("Input Dims")
    return bool(dims) and len(dims) >= len(shapes) and \
        all(list(d) == list(s) for d, s in zip(dims, shapes))
