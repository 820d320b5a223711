"""The paper's CNN-RNN (tones): (B, C, T) -> class probabilities.

An LSTM (C -> lstm_dim) whose last state, viewed as a (T, lstm_dim / T)
image, and the raw (T, C) image each pass a stencil conv (7, 1) to 1024
features with pool 2; the two are joined on the electrode axis (LSTM
branch first); conv (7, 1) 512 leaky, conv (7, 1) 256 pooled (3, 1)
leaky, dropout; a second LSTM (-> 512) over the time axis, its last
state to a Dense(classes) sigmoid (Liu et al. 2023; the reference
repository's ``models/deep_classifiers.py:158-343``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .layers import (Spec, conv, conv_len, conv_spec, dropout, linear, linear_spec,
                     lstm_last, lstm_spec, stencil, stencil_spec)
from .precision import Precision

DROPOUTS = ("drop",)


def shapes(m: Dict) -> Dict[str, int]:
    """The time lengths and widths the layers see."""
    t, c, h = m["input_length"], m["input_channels"], m.get("lstm_dim", 800)
    u = conv_len(t, 7) // 2
    width = h // t + c
    t2 = conv_len(conv_len(u, 7), 7) // 3
    return {"u": u, "width": width, "t2": t2, "lstm2_in": width * 256}


def param_spec(m: Dict) -> Spec:
    c, h = m["input_channels"], m.get("lstm_dim", 800)
    s = shapes(m)
    return (lstm_spec("lstm1", c, h) + stencil_spec("conv1", 1024, 7)
            + stencil_spec("conv2", 1024, 7) + conv_spec("conv3a", 512, 1024, 7)
            + conv_spec("conv3b", 256, 512, 7) + lstm_spec("lstm2", s["lstm2_in"], 512)
            + linear_spec("head", m["n_classes"], 512))


def dropout_shapes(m: Dict, batch: int) -> Dict[str, tuple]:
    """The shape of each dropout's input for a batch, in forward order."""
    s = shapes(m)
    return {"drop": (batch, 256, s["t2"], s["width"])}


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, m: Dict, prec: Precision,
            masks: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    slope = m.get("negative_slope", 0.01)
    n_b, _, t = x.shape
    h = m.get("lstm_dim", 800)
    seq = x.transpose(1, 2)  # (B, T, C)
    last = lstm_last(seq, p["lstm1.wi"], p["lstm1.wh"], p["lstm1.b"], prec)
    raw = stencil(seq, p["conv1.weight"], p["conv1.bias"], 2, slope, prec)
    x1 = stencil(last.reshape(n_b, t, h // t), p["conv2.weight"], p["conv2.bias"], 2,
                 slope, prec)
    y = torch.cat([x1, raw], dim=3)  # (B, 1024, U, width): the LSTM branch first
    y = F.leaky_relu(conv(y, p["conv3a.weight"], p["conv3a.bias"], prec), slope)
    y = F.max_pool2d(conv(y, p["conv3b.weight"], p["conv3b.bias"], prec), (3, 1), (3, 1))
    y = dropout(F.leaky_relu(y, slope), (masks or {}).get("drop"), m.get("dropout", 0.5))
    seq2 = y.permute(0, 2, 3, 1).reshape(n_b, y.shape[2], -1)  # (B, t2, width * 256)
    last2 = lstm_last(seq2, p["lstm2.wi"], p["lstm2.wh"], p["lstm2.b"], prec)
    return torch.sigmoid(linear(last2, p["head.weight"], p["head.bias"], prec))
