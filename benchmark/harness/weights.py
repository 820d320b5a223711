"""Seeded weights, drawn on the device.

A model's tensors are named and shaped by its reference module's
``param_spec`` (the port's state-dict names). Each seed's weights come
from a generator on the device seeded with it, in a few large calls:

- kernels: a normal truncated to +-2 and scaled by 1 / sqrt(fan-in)
  (Flax's LeCun normal, drawn by the inverse CDF of one uniform buffer);
- recurrent kernels: an orthogonal matrix per gate (QR of a normal draw,
  signs fixed by R's diagonal);
- biases zero.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

_TRUNCATED_STD = 0.87962566103423978  # sd of a unit normal cut at +-2


def draw(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """One seed's float32 weights by name, on ``device``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    lecun = [(n, s, f) for n, s, kind, f in spec if kind == "lecun"]
    total = sum(math.prod(s) for _, s, _ in lecun)
    edge = math.erf(math.sqrt(2.0))
    flat = torch.empty(total, device=device).uniform_(-edge, edge, generator=g)
    flat = (math.sqrt(2.0) * torch.erfinv(flat)).clamp_(-2.0, 2.0)
    scale = torch.cat([torch.full((math.prod(s),), 1.0 / (math.sqrt(f) * _TRUNCATED_STD),
                                  device=device) for _, s, f in lecun])
    flat.mul_(scale)
    for (name, shape, _), part in zip(lecun, flat.split([math.prod(s) for _, s, _ in lecun])):
        out[name] = part.view(shape)
    for name, shape, kind, _ in spec:
        if kind == "orthogonal_gates":
            hid = shape[0]
            q, r = torch.linalg.qr(torch.randn((4, hid, hid), generator=g, device=device))
            q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
            out[name] = torch.cat(list(q), dim=1)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name, *_ in spec}


def stacked(spec, seeds: Sequence[int], device) -> Dict[str, torch.Tensor]:
    """Every seed's weights stacked on a leading seed axis."""
    per_seed: List[Dict[str, torch.Tensor]] = [draw(spec, s, device) for s in seeds]
    return {name: torch.stack([w[name] for w in per_seed]) for name, *_ in spec}


def checksums(w: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """A float64 sum of each tensor: what a second draw must repeat."""
    return {k: float(v.double().sum()) for k, v in w.items()}
