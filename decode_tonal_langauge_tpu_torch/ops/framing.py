"""Epoch extraction as one batched gather.

Counterpart of ``decode_tonal_langauge_tpu/ops/framing.py``: windows
``[start, start + length)`` of a recording, gathered on the recording's
device in one indexing op, and the host helper that tiles rest windows.
"""

from __future__ import annotations

import torch


def _window_index(starts, length: int, device) -> torch.Tensor:
    starts = torch.as_tensor(starts, device=device).long()
    return starts[:, None] + torch.arange(length, device=device)[None, :]


def extract_epochs(
    data: torch.Tensor, starts: torch.Tensor, length: int
) -> torch.Tensor:
    """(C, T) -> (N, C, length). ``starts`` is an (N,) integer tensor;
    callers guarantee ``start + length <= T``."""
    return data[:, _window_index(starts, length, data.device)].permute(1, 0, 2)


def extract_epochs_1d(
    data: torch.Tensor, starts: torch.Tensor, length: int
) -> torch.Tensor:
    """The same for a 1-D series: (T,) -> (N, length)."""
    return data[_window_index(starts, length, data.device)]


def tile_rest_windows(rest_start: int, rest_end: int, length: int) -> torch.Tensor:
    """Start indices (int32, host) of non-overlapping rest windows; the
    final partial window is dropped."""
    starts = []
    for i in range(rest_start, rest_end, length):
        if i + length > rest_end:
            break
        starts.append(i)
    return torch.tensor(starts, dtype=torch.int32)
