"""NAdam with decay/no-decay parameter groups, the optax update written out;
and Adam with L2, ``torch.optim.Adam``'s update (:class:`Adam`).

Counterpart of ``decode_tonal_langauge_tpu/training/optim.py``, whose
optimizer is ``optax.chain(add_decayed_weights(wd, mask=ndim >= 2),
nadam(lr))``. That is not ``torch.optim.NAdam`` (which adds a
momentum-decay schedule) nor AdamW (whose decay is decoupled): the decay
is an L2 term added to the gradient before NAdam, on parameters of two or
more dimensions only. The synthesizer's optimizer
(``training/synthesis_trainer.py``) decays every parameter: that is
``decay_all=True``. One step, with ``t`` the step count after
increment::

    g      = grad + wd * p                     (ndim >= 2, or every p)
    mu     = (1 - b1) * g + b1 * mu
    nu     = (1 - b2) * g * g + b2 * nu
    mu_hat = b1 * mu / (1 - b1**(t+1)) + (1 - b1) * g / (1 - b1**t)
    nu_hat = nu / (1 - b2**t)
    p      = p + (mu_hat / (sqrt(nu_hat) + eps)) * -lr

(optax ``scale_by_adam(nesterov=True)``; ``eps`` outside the root). The
bias corrections are formed in float32, as optax forms them.

``moment_dtype`` (e.g. ``"bfloat16"``) stores ``mu`` and ``nu`` in that
dtype at rest; each step widens them to float32, updates in float32 and
rounds the new moments back (JAX ``with_moment_dtype``). By default the
moments take each parameter's dtype, and float64 parameters update in
float64.

:class:`SeedNAdam` runs the same update on seed-stacked tensors (a
leading axis of S seeds, ``training/seed_stack.py``): the decay mask is
taken from each tensor's per-seed shape, as the JAX package's mask sees
unbatched shapes inside ``vmap``, so a stacked bias (ndim 2) is not
decayed.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Union

import math

import numpy as np
import torch
from torch import nn

from ..runtime.profiling import span


def decay_mask(params: Sequence[torch.Tensor], seed_axis: bool = False) -> List[bool]:
    """True for parameters that receive weight decay (ndim >= 2, not
    counting a leading seed axis)."""
    return [p.ndim - int(seed_axis) >= 2 for p in params]


def _moment_dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32."""
    return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(count)))


class NAdam:
    """The optax NAdam update on a list of tensors or a module's
    parameters. ``step(grads)`` takes the gradients in parameter order
    (``None``: each parameter's ``.grad``). Weight decay reaches the
    parameters of :func:`decay_mask`, or every parameter with
    ``decay_all``."""

    seed_axis = False  # SeedNAdam: every tensor leads with a seed axis

    def __init__(
        self,
        params: Union[nn.Module, Iterable[torch.Tensor]],
        learning_rate: float,
        weight_decay: float = 0.0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        moment_dtype=None,
        decay_all: bool = False,
    ) -> None:
        if isinstance(params, nn.Module):
            params = params.parameters()
        self.params = list(params)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.moment_dtype = _moment_dtype(moment_dtype)
        self.decay = ([True] * len(self.params) if decay_all
                      else decay_mask(self.params, self.seed_axis))
        dtype = lambda p: self.moment_dtype or p.dtype  # noqa: E731
        self.mu = [torch.zeros_like(p, dtype=dtype(p)) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=dtype(p)) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[torch.Tensor]] = None) -> None:
        with span("optim.nadam"):
            if grads is None:
                grads = [p.grad for p in self.params]
            b1, b2 = self.b1, self.b2
            self.count += 1
            bc1 = _bias_correction(b1, self.count)
            bc1_next = _bias_correction(b1, self.count + 1)
            bc2 = _bias_correction(b2, self.count)
            for p, g, mu, nu, decays in zip(self.params, grads, self.mu, self.nu, self.decay):
                dtype = torch.promote_types(p.dtype, torch.float32)  # float32 at least
                g = g.to(dtype)
                if self.weight_decay and decays:
                    g = g + self.weight_decay * p
                m = (1 - b1) * g + b1 * mu.to(dtype)
                v = (1 - b2) * (g * g) + b2 * nu.to(dtype)
                mu_hat = b1 * (m / bc1_next) + (1 - b1) * (g / bc1)
                update = mu_hat / (torch.sqrt(v / bc2) + self.eps)
                p.copy_(p + update * -self.learning_rate)
                mu.copy_(m)
                nu.copy_(v)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(
                    f"optimizer state {tuple(src.shape)} {src.dtype} does not "
                    f"fit a moment of {tuple(dst.shape)} {dst.dtype}"
                )
            dst.copy_(src)


class SeedNAdam(NAdam):
    """:class:`NAdam` on seed-stacked tensors (S, ...), with the per-seed
    decay mask of the module docstring. Every seed in the stacks steps at
    each :meth:`step`, so ``count`` is each seed's own step count; a seed
    that stops leaves the stacks (:meth:`select`), and neither its weights
    nor its moments move again."""

    seed_axis = True

    def select(self, params: Sequence[torch.Tensor], keep: torch.Tensor) -> None:
        """Keep the seeds at indices ``keep`` (a long tensor): the stacks
        now hold ``params``, those seeds' rows in that order."""
        self.params = list(params)
        self.mu = [m[keep.to(m.device)] for m in self.mu]
        self.nu = [v[keep.to(v.device)] for v in self.nu]


class Adam(NAdam):
    """``torch.optim.Adam`` with ``weight_decay`` (an L2 term added to the
    gradient of every parameter, before the moments), the optimizer of the
    GRU-CTC decoder's published training (``training/sequence_trainer.py``).
    One step, ``t`` the step count after increment::

        g = grad + wd * p
        m = m + (1 - b1) * (g - m)
        v = b2 * v + (1 - b2) * g * g
        p = p - lr / (1 - b1**t) * m / (sqrt(v) / sqrt(1 - b2**t) + eps)

    run as ``torch.optim.Adam``'s multi-tensor path runs it: each line one
    ``torch._foreach_*`` call over every parameter, a handful of launches a
    step on the card. It keeps :class:`NAdam`'s moments, step count and
    state dict."""

    def __init__(self, params: Union[nn.Module, Iterable[torch.Tensor]], learning_rate: float,
                 weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
        super().__init__(params, learning_rate, weight_decay, b1, b2, eps, decay_all=True)

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[torch.Tensor]] = None) -> None:
        with span("optim.adam"):
            grads = [p.grad for p in self.params] if grads is None else list(grads)
            b1, b2 = self.b1, self.b2
            self.count += 1
            if self.weight_decay:
                grads = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
            torch._foreach_lerp_(self.mu, grads, 1 - b1)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, grads, grads, 1 - b2)
            denom = torch._foreach_sqrt(self.nu)
            torch._foreach_div_(denom, math.sqrt(1 - b2 ** self.count))
            torch._foreach_add_(denom, self.eps)
            torch._foreach_addcdiv_(self.params, self.mu, denom,
                                    -self.learning_rate / (1 - b1 ** self.count))
