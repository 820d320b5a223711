"""A shallow MLP classifier (``ShallowNN``): (B, C, T) flattened in
channel-major order, Dense(hidden) ReLU, Dense(classes) logits."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .layers import Spec, linear, linear_spec
from .precision import Precision


def param_spec(m: Dict) -> Spec:
    n_in = m["input_channels"] * m["input_length"]
    return (linear_spec("hidden", m["hidden_dim"], n_in)
            + linear_spec("output", m["n_classes"], m["hidden_dim"]))


def dropout_shapes(m: Dict, batch: int) -> Dict[str, tuple]:
    return {}


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, m: Dict, prec: Precision,
            masks: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    y = torch.relu(linear(x.reshape(x.shape[0], -1), p["hidden.weight"], p["hidden.bias"], prec))
    return linear(y, p["output.weight"], p["output.bias"], prec)
