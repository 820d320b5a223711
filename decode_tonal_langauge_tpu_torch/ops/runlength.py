"""Vectorized longest-consecutive-run computation, in torch.

Counterpart of ``decode_tonal_langauge_tpu/ops/runlength.py``: a cumsum /
cumulative-max trick that runs for all channels at once, in exact integer
arithmetic.
"""

from __future__ import annotations

import torch


def max_consecutive_true(mask) -> torch.Tensor:
    """Length of the longest run of True along the last axis (int64).

    The running streak at each position is ``cumsum(mask)`` less its
    value at the most recent False; the answer is the streak's maximum."""
    mask = torch.as_tensor(mask, dtype=torch.bool)
    cs = torch.cumsum(mask.to(torch.int64), dim=-1)
    reset = torch.where(mask, 0, cs)
    streak = cs - torch.cummax(reset, dim=-1).values
    return streak.max(dim=-1).values
