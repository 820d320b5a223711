"""Profiling / timing hooks.

Counterpart of ``decode_tonal_langauge_tpu/runtime/profiling.py``: every
pipeline stage can run inside a ``torch.profiler`` trace, written as a
Chrome trace file; hot calls are timed with device fencing; a
:class:`StageTimer` sums named wall-clock spans.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


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


def _fence(tree) -> None:
    """Wait for the card if any tensor in ``tree`` lives on it."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for leaf in tree.values():
            _fence(leaf)
    elif isinstance(tree, (list, tuple)):
        for leaf in tree:
            _fence(leaf)


def timed(fn: Callable, *args, warmup: int = 1, repeats: int = 5, **kwargs):
    """(result, seconds-per-call) with device-completion fencing."""
    result = None
    for _ in range(max(warmup, 0)):
        result = fn(*args, **kwargs)
    _fence(result)

    t0 = time.perf_counter()
    for _ in range(repeats):
        result = fn(*args, **kwargs)
    _fence(result)
    per_call = (time.perf_counter() - t0) / repeats
    return result, per_call


class StageTimer:
    """Accumulates named wall-clock spans; printable summary."""

    def __init__(self):
        self.spans = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> str:
        total = sum(self.spans.values()) or 1.0
        lines = [
            f"{name}: {secs:.3f}s ({100 * secs / total:.1f}%)"
            for name, secs in sorted(self.spans.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
