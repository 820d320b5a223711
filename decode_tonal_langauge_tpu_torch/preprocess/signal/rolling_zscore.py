"""Rolling-window z-score step (pandas semantics) over
``params.window_length`` seconds."""

from __future__ import annotations

from argparse import Namespace

import torch

from ...ops.rereference import rolling_zscore


def run(data: torch.Tensor, params: Namespace) -> torch.Tensor:
    window_length = getattr(params, "window_length", 10)
    window_size = int(window_length * params.signal_freq)
    preserve_nans = getattr(params, "preserve_nans", True)

    if window_size <= 1:
        raise ValueError("window_size must be greater than 1.")
    return rolling_zscore(data, window_size, fill_nans=not preserve_nans)
