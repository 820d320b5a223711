"""Global per-channel z-score step (``params.preserve_nans`` False
zero-fills NaNs)."""

from __future__ import annotations

from argparse import Namespace

import torch

from ...ops.rereference import channel_zscore


def run(data: torch.Tensor, params: Namespace) -> torch.Tensor:
    preserve_nans = getattr(params, "preserve_nans", True)
    return channel_zscore(data, fill_nans=not preserve_nans)
