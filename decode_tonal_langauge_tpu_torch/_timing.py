"""Timing on a CUDA card, shared by ``chip_smoke.py`` and ``scripts/``.

- :func:`time_ms`: milliseconds of one call made back to back with
  others, between two CUDA events (host work included where it does not
  hide behind the card's).
- :func:`kernel_ms`: device milliseconds of named kernels per call, from
  ``torch.profiler`` (no host time in them).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple


def time_ms(fn: Callable, warmup: int = 2, runs: int = 20) -> float:
    """Milliseconds a call of ``fn`` takes on the card: ``runs`` calls back
    to back between two CUDA events, after ``warmup`` calls, so the host's
    work for one call overlaps the card's work for the one before."""
    import torch

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


def kernel_ms(
    fn: Callable, kernels: Sequence[Tuple[str, ...]], runs: int = 20
) -> Optional[List[float]]:
    """Mean device milliseconds per call of ``fn`` spent in each kernel of
    ``kernels`` over ``runs`` calls, after two warm-up calls. A kernel is
    named by substrings that all occur in the profiler's name for it.
    None if the profiler saw no device time for one of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    found: List[Optional[float]] = [None] * len(kernels)
    for e in prof.key_averages():
        total_us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        for i, parts in enumerate(kernels):
            if total_us and all(p in e.key for p in parts):
                found[i] = (found[i] or 0.0) + total_us / runs / 1e3
    return None if None in found else found
