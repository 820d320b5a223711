"""The frozen decode, plainly: each classifier on its own channels
(sorted) after its scaler, the argmax of each, the tone's contour from the
dynamics table beside a constant syllable row, then the synthesis model
on the remaining active channels."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import module_of
from .layers import cast
from .precision import Precision


def dynamics(tones: torch.Tensor, sylls: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B,) ids -> (B, 2, n) label dynamics: the syllable id, the contour."""
    contour = table[tones]
    return torch.stack([sylls[:, None].to(contour.dtype).expand(contour.shape), contour], 1)


def classify(params: Dict, models: Dict, key: str, x: torch.Tensor,
             scaler, prec: Precision) -> torch.Tensor:
    if scaler is not None:
        x = (x - scaler[0].to(x)) / scaler[1].to(x)
    m = models[key]
    return module_of(m).forward(cast(params[key], prec), x, m, prec)


def decode(params: Dict, models: Dict, windows: torch.Tensor, channels: Dict,
           scalers: Dict, table: torch.Tensor, prec: Precision,
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, C_total, T) windows -> (tone probs, syllable probs, mels)."""
    dt = prec.dtype
    windows = windows.to(dt)
    idx = {k: torch.as_tensor(sorted(v), device=windows.device) for k, v in channels.items()}
    pt = classify(params, models, "tone", windows[:, idx["tone"]], scalers.get("tone"), prec)
    ps = classify(params, models, "syllable", windows[:, idx["syllable"]],
                  scalers.get("syllable"), prec)
    labels = dynamics(pt.argmax(1), ps.argmax(1), table.to(dt))
    m = models["synthesis"]
    mel = module_of(m).forward(cast(params["synthesis"], prec), windows[:, idx["non"]], labels,
                              m, prec)
    return pt, ps, mel
