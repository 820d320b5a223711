"""Dropout whose mask comes from an explicit ``torch.Generator``.

``nn.Dropout`` draws from the process-global RNG, which the trainer does
not own: two fits in one process would then depend on each other's
draws, and a resumed fit could not continue the interrupted one's masks.
This module draws its keep-mask with ``bernoulli_(..., generator=g)`` from
the generator the trainer sets (:func:`set_dropout_generator`). As Flax's
``nn.Dropout``, kept units are scaled by ``1 / (1 - p)``; in eval mode,
or with ``p == 0``, it is the identity.

Under data parallelism (``parallel/mesh.py``) a rank holds rows
``[rank * b, (rank + 1) * b)`` of a global batch of ``dp * b``
(``shard = (rank, dp)``): it draws the keep-mask of the whole global
batch from the generator, which every rank seeds alike, and keeps its
rows, so a data-parallel fit draws the one-device fit's masks. The cost is
``dp`` times the mask generation.

A seed-batched fit (``training/seed_stack.py``) runs the module inside
``torch.func.vmap``, which allows no random operation: it draws each
seed's masks before the step with :meth:`Dropout.draw`, from that seed's
generator and in the order and shapes of the seed's own forward, and
hands them in with :func:`given_masks`. Seed s then drops the units a
fit of that seed alone drops.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

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
        self.shard: Tuple[int, int] = (0, 1)  # (rank, dp) of the batch axis
        # A keep-mask handed in from outside (given_masks), drawn by draw().
        self.mask: Optional[torch.Tensor] = None

    @property
    def draws(self) -> bool:
        """Whether a forward draws a mask (train mode, 0 < p < 1)."""
        return self.training and 0.0 < self.p < 1.0

    def draw(self, shape, dtype: torch.dtype, device, generator=None) -> torch.Tensor:
        """The keep-mask of an input of ``shape``: this rank's rows of the
        global batch's mask, from ``generator`` (None: the module's)."""
        rank, dp = self.shard
        b = shape[0]
        generator = self.generator if generator is None else generator
        mask = torch.empty((dp * b,) + tuple(shape[1:]), dtype=dtype, device=device)
        return mask.bernoulli_(1.0 - self.p, generator=generator)[rank * b:(rank + 1) * b]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.draws:
            return torch.zeros_like(x) if self.training and self.p == 1.0 else x
        mask = self.mask if self.mask is not None else self.draw(x.shape, x.dtype, x.device)
        keep = 1.0 - self.p
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def set_dropout_generator(module: nn.Module, generator: torch.Generator) -> None:
    """Point every :class:`Dropout` inside ``module`` at ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


@contextlib.contextmanager
def given_masks(modules: Dict[str, Dropout], masks: Dict[str, torch.Tensor]):
    """For the block, each ``modules[name]`` applies ``masks[name]``
    instead of drawing one."""
    for name, mask in masks.items():
        modules[name].mask = mask
    try:
        yield
    finally:
        for name in masks:
            modules[name].mask = None
