"""NAdam with decay/no-decay parameter groups, the optax update written out.

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
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn


def decay_mask(params: Sequence[torch.Tensor]) -> List[bool]:
    """True for parameters that receive weight decay (ndim >= 2)."""
    return [p.ndim >= 2 for p in params]


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
        self.decay = [True] * len(self.params) if decay_all else decay_mask(self.params)
        dtype = lambda p: self.moment_dtype or p.dtype  # noqa: E731
        self.mu = [torch.zeros_like(p, dtype=dtype(p)) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=dtype(p)) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[torch.Tensor]] = None) -> None:
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
