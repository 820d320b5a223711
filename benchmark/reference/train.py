"""The first steps of a fit, followed in plain PyTorch.

A step is the published one: a forward in train mode (dropout on), the
loss, its gradient by autograd through the plain layers, and NAdam as
optax writes it, with the L2 decay added to the gradient before the
moments (on tensors of two or more dimensions for the classifiers, on
every tensor for the synthesizer)::

    g      = grad + wd * p
    mu     = (1 - b1) * g + b1 * mu
    nu     = (1 - b2) * g * g + b2 * nu
    mu_hat = b1 * mu / (1 - b1**(t+1)) + (1 - b1) * g / (1 - b1**t)
    p      = p - lr * mu_hat / (sqrt(nu / (1 - b2**t)) + eps)

Dropout keeps each unit with probability 1 - p and scales it by 1 / (1 -
p). Each seed's keep-masks come from that seed's own generator on the
device, seeded with the seed, one ``bernoulli_`` per dropout and step
in forward order: the rule by which a fit of one seed draws them, so
that the masks are worked out again here rather than taken from the fit.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from .precision import Precision


def class_loss(out: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               total: torch.Tensor) -> torch.Tensor:
    """Weighted cross-entropy of the (sigmoid) outputs taken as logits."""
    ce = -F.log_softmax(out, dim=-1).gather(1, y[:, None])[:, 0]
    return (ce * w).sum() / total.clamp_min(1.0)


def mel_l1_loss(out: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                total: torch.Tensor) -> torch.Tensor:
    """Weighted mean over trials of the mean absolute mel error."""
    return ((out - y).abs().mean(dim=1) * w).sum() / total.clamp_min(1.0)


def keep_masks(seed: int, shapes: Dict[str, tuple], steps: int, p: float,
               device) -> List[Dict[str, torch.Tensor]]:
    """Each step's keep-masks (float32 0/1) of one seed, in forward order."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return [{name: torch.empty(shape, dtype=torch.float32, device=device)
             .bernoulli_(1.0 - p, generator=g) for name, shape in shapes.items()}
            for _ in range(steps)]


def follow_steps(
    forward: Callable, params0: Dict[str, torch.Tensor], batches: Sequence,
    masks: Sequence[Dict[str, torch.Tensor]], loss_fn: Callable, hyper: Dict,
    decayed: Callable[[str, torch.Tensor], bool], prec: Precision, device,
) -> Dict[str, object]:
    """``len(batches)`` NAdam steps of one seed from ``params0``.

    ``batches[k]`` is (inputs tuple, y, w) of step k; ``forward(p,
    *inputs, masks=...)`` the model. Returns each step's loss, the first
    gradient per tensor (``grad``, as autograd gives it, and ``grad_eff``
    with the decay added, what the optimizer's first moment holds) and the
    change of every tensor after the steps, all as norms by name."""
    dt = prec.dtype
    p = {k: v.to(device=device, dtype=dt).clone() for k, v in params0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = hyper["b1"], hyper["b2"], hyper["eps"]
    lr, wd = hyper["learning_rate"], hyper["weight_decay"]
    losses, first = [], {}
    for step, ((inputs, y, w), mask) in enumerate(zip(batches, masks), start=1):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        inputs = [x.to(device=device, dtype=dt) for x in inputs]
        y = y.to(device)
        w = w.to(device=device, dtype=dt)
        out = forward(leaves, *inputs, masks={k: m.to(dt) for k, m in mask.items()})
        loss = loss_fn(out, y, w, w.sum())
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in grads.items():
                if wd and decayed(k, p[k]):
                    g = g + wd * p[k]
                if step == 1:
                    first[k] = (float(grads[k].norm()), float(g.norm()))
                mu[k] = (1 - b1) * g + b1 * mu[k]
                nu[k] = (1 - b2) * g * g + b2 * nu[k]
                mu_hat = b1 * mu[k] / (1 - b1 ** (step + 1)) + (1 - b1) * g / (1 - b1 ** step)
                p[k] = p[k] - lr * mu_hat / (torch.sqrt(nu[k] / (1 - b2 ** step)) + eps)
    change = {k: float((p[k] - params0[k].to(device=device, dtype=dt)).norm()) for k in p}
    return {"loss": losses, "grad": {k: v[0] for k, v in first.items()},
            "grad_eff": {k: v[1] for k, v in first.items()}, "change": change}
