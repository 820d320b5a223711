"""The paper's synthesis model ("SynthesisFull"): ECoG (B, C, T) and label
dynamics (B, 2, n) -> a flattened mel (B, output_dim).

ECoG: a stencil conv (3, 1) to 512 with pool 2, conv (3, 1) 512 pool 2,
conv (3, 1) 512 pool 2, conv (1, 1) 256 pool 2, conv (1, 1) 64, each
leaky (0.01); dropout. Labels: an LSTM (2 -> latent * C * 6) whose last
state is laid on the ECoG latent grid as 6 features. Both joined on the
feature axis; four conv (1, 1) 128 and one conv (1, 1) 64, leaky (0.1);
flattened channels-last into Dense(output_dim) (Liu et al. 2023; the
reference repository's ``models/synthesis_models.py:49-198``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .layers import (Spec, conv, conv_len, conv_spec, dropout, linear, linear_spec,
                     lstm_last, lstm_spec, nhwc_flat, stencil, stencil_spec)
from .precision import Precision

DROPOUTS = ("ecog_dropout",)
MEAN_MEL_BIAS = "output_layer.bias"  # a fit starts it at its train mels' mean
ECOG = ((512, 3, True), (512, 3, True), (256, 1, True), (None, 1, False))  # after the stencil


def latent_length(t: int) -> int:
    t = conv_len(t, 3) // 2
    for _, k, pool in ECOG:
        t = conv_len(t, k)
        if pool:
            t //= 2
    return t


def _widths(m: Dict):
    return [512, 512, 512, 256, m.get("conv_channels", 64)]


def param_spec(m: Dict) -> Spec:
    w = _widths(m)
    c, lc = m["n_channels"], m.get("lstm_channels", 6)
    lat = latent_length(m["n_timepoints"])
    spec = stencil_spec("ecog_convs.0", 512, 3)
    for i, (_, k, _) in enumerate(ECOG, start=1):
        spec += conv_spec(f"ecog_convs.{i}", w[i], w[i - 1], k)
    spec += lstm_spec("label_lstm", 2, lat * c * lc)
    cw = [w[-1] + lc, 128, 128, 128, 128, w[-1]]
    for i in range(5):
        spec += conv_spec(f"concat_convs.{i}", cw[i + 1], cw[i], 1)
    return spec + linear_spec("output_layer", m["output_dim"], lat * c * w[-1])


def dropout_shapes(m: Dict, batch: int) -> Dict[str, tuple]:
    """The shape of each dropout's input for a batch, in forward order."""
    return {"ecog_dropout": (batch, _widths(m)[-1], latent_length(m["n_timepoints"]),
                             m["n_channels"])}


def forward(p: Dict[str, torch.Tensor], ecog: torch.Tensor, labels: torch.Tensor, m: Dict,
            prec: Precision, masks: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    slope = m.get("negative_slope", 0.01)
    n_b, c = ecog.shape[0], m["n_channels"]
    lc = m.get("lstm_channels", 6)
    x = stencil(ecog.transpose(1, 2), p["ecog_convs.0.weight"], p["ecog_convs.0.bias"], 2,
                slope, prec)
    for i, (_, _, pool) in enumerate(ECOG, start=1):
        x = conv(x, p[f"ecog_convs.{i}.weight"], p[f"ecog_convs.{i}.bias"], prec)
        if pool:
            x = F.max_pool2d(x, (2, 1), (2, 1))
        x = F.leaky_relu(x, slope)
    x = dropout(x, (masks or {}).get("ecog_dropout"), m.get("dropout", 0.5))
    lat = x.shape[2]
    last = lstm_last(labels.transpose(1, 2), p["label_lstm.wi"], p["label_lstm.wh"],
                     p["label_lstm.b"], prec)
    x2 = last.reshape(n_b, lat, c, lc).permute(0, 3, 1, 2)
    y = torch.cat([x, x2], dim=1)
    for i in range(5):
        y = F.leaky_relu(conv(y, p[f"concat_convs.{i}.weight"], p[f"concat_convs.{i}.bias"],
                              prec), 0.1)
    return linear(nhwc_flat(y), p["output_layer.weight"], p["output_layer.bias"], prec)
