"""Common-average-reference step (``params.exclude_channels`` stay out of
the mean)."""

from __future__ import annotations

from argparse import Namespace

import torch

from ...ops.rereference import car_rereference


def run(data: torch.Tensor, params: Namespace) -> torch.Tensor:
    exclude = getattr(params, "exclude_channels", []) or []
    if not isinstance(exclude, list):
        raise ValueError("exclude_channels must be a list of integers.")
    return car_rereference(data, exclude_channels=exclude)
