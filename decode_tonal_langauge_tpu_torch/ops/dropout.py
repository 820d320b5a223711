"""Dropout whose mask comes from an explicit ``torch.Generator``.

``nn.Dropout`` draws from the process-global RNG, which the trainer does
not own: two fits in one process would then depend on each other's
draws, and a resumed fit could not continue the interrupted one's masks.
This module draws its keep-mask with ``bernoulli_(..., generator=g)`` from
the generator the trainer sets (:func:`set_dropout_generator`). As Flax's
``nn.Dropout``, kept units are scaled by ``1 / (1 - p)``; in eval mode,
or with ``p == 0``, it is the identity.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Dropout(nn.Module):
    def __init__(self, p: float = 0.5) -> None:
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout probability must be in [0, 1], got {p}")
        self.p = float(p)
        # Not a buffer: the trainer owns the generator and its state.
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.p
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def set_dropout_generator(module: nn.Module, generator: torch.Generator) -> None:
    """Point every :class:`Dropout` inside ``module`` at ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
