"""Interval z-score step: z-scores each channel by its mean and std over
``params.rereference_interval`` (seconds), e.g. the first 25 s of rest."""

from __future__ import annotations

from argparse import Namespace

import torch

from ...ops.rereference import interval_zscore


def run(data: torch.Tensor, params: Namespace) -> torch.Tensor:
    if not hasattr(params, "rereference_interval") or not hasattr(
        params, "signal_freq"
    ):
        raise ValueError(
            "params must have 'rereference_interval' and 'signal_freq' attributes."
        )

    start_s, end_s = params.rereference_interval
    start = int(start_s * params.signal_freq)
    end = int(end_s * params.signal_freq)

    if start < 0 or end > data.shape[1]:
        raise ValueError("Reference time indices are out of bounds.")
    if start >= end:
        raise ValueError("Start time must be less than end time.")
    return interval_zscore(data, start, end)
