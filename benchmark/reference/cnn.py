"""The paper's temporal CNN (syllables): (B, C, T) -> class probabilities.

A stencil conv (3, 1) to 512 features with pool 2, then conv (3, 1)
blocks 512, 512, 512, 512 (no pool after the fourth), 256, each pooled
(2, 1) and leaky (slope 0.01); dropout; Dense(1024) leaky; Dense(classes)
sigmoid (Liu et al. 2023; the reference repository's
``models/deep_classifiers.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .layers import (Spec, conv, conv_len, conv_spec, dropout, linear, linear_spec,
                     nhwc_flat, stencil, stencil_spec)
from .precision import Precision

WIDTHS = (512, 512, 512, 512, 512, 256)
DROPOUTS = ("dropout",)


def latent_length(t: int) -> int:
    t = conv_len(t, 3) // 2
    for i in range(1, len(WIDTHS)):
        t = conv_len(t, 3)
        if i != 4:
            t //= 2
    return t


def param_spec(m: Dict) -> Spec:
    spec = stencil_spec("convs.0", WIDTHS[0], 3)
    for i in range(1, len(WIDTHS)):
        spec += conv_spec(f"convs.{i}", WIDTHS[i], WIDTHS[i - 1], 3)
    flat = latent_length(m["input_length"]) * m["input_channels"] * WIDTHS[-1]
    return (spec + linear_spec("fc1", 1024, flat)
            + linear_spec("fc2", m["n_classes"], 1024))


def dropout_shapes(m: Dict, batch: int) -> Dict[str, tuple]:
    """The shape of each dropout's input for a batch, in forward order."""
    return {"dropout": (batch, WIDTHS[-1], latent_length(m["input_length"]),
                        m["input_channels"])}


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, m: Dict, prec: Precision,
            masks: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    slope = m.get("negative_slope", 0.01)
    y = stencil(x.transpose(1, 2), p["convs.0.weight"], p["convs.0.bias"], 2, slope, prec)
    for i in range(1, len(WIDTHS)):
        y = conv(y, p[f"convs.{i}.weight"], p[f"convs.{i}.bias"], prec)
        if i != 4:
            y = F.max_pool2d(y, (2, 1), (2, 1))
        y = F.leaky_relu(y, slope)
    y = dropout(y, (masks or {}).get("dropout"), m.get("dropout", 0.5))
    y = F.leaky_relu(linear(nhwc_flat(y), p["fc1.weight"], p["fc1.bias"], prec), slope)
    return torch.sigmoid(linear(y, p["fc2.weight"], p["fc2.bias"], prec))
