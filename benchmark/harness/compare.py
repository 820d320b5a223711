"""The numbers compared with the reference, each against its limit.

Every number is a gap that is 0 for a perfect match; a run is correct
when each is at or below its limit (``limits/<cell>.json``).
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence

import numpy as np


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


def checks(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    missing = set(values) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    return [Check(k, float(v), float(limits[k])) for k, v in values.items()]


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: Iterable[str] = None) -> float:
    """The largest gap between the port's and the reference's norm of a
    leaf, over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    keys = list(ref if leaves is None else leaves)
    median = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-300) for k in keys)


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The median over the leaves of :func:`worst_leaf_gap`'s gap."""
    median = statistics.median(ref.values())
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-300) for k in ref)


def rel_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The largest relative gap between paired numbers."""
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(p - r) / np.maximum(np.abs(r), 1e-300)))


def top2_margin(probs: np.ndarray) -> np.ndarray:
    top = np.sort(probs, axis=1)[:, -2:]
    return top[:, 1] - top[:, 0]
