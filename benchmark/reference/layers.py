"""Plain layers of the paper models, on a dict of weights.

Weights use the port's state-dict names and layouts, the layout of the
checkpoints users carry between the trainer and serving: a conv kernel
(out, in, k, 1), a linear weight (out, in), the first-layer stencil
kernel (k, features), an LSTM's ``wi`` (in, 4H), ``wh`` (H, 4H) and one
bias ``b`` (4H), gates in the order i, f, g, o.

Layouts follow the published (Flax, channels-last) models: images are
(batch, time, electrodes, features) when flattened or concatenated, and
pooling comes before the leaky ReLU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .precision import Precision

Spec = List[Tuple[str, Tuple[int, ...], str, int]]  # (name, shape, init, fan_in)


def conv_len(t: int, k: int, stride: int = 1) -> int:
    return (t - k) // stride + 1


def stencil(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, pool: int,
            slope: float, prec: Precision) -> torch.Tensor:
    """Conv (k, 1) over time of the one-channel image of ``x`` (B, T, C),
    max-pool (pool, 1), bias, leaky ReLU. Returns (B, features, U, C)."""
    img = x[:, None]  # (B, 1, T, C)
    kern = w.t()[:, None, :, None]  # (F, 1, k, 1)
    y = F.conv2d(prec.operand(img), prec.operand(kern))
    y = F.max_pool2d(y, (pool, 1), (pool, 1))
    return F.leaky_relu(y + b[None, :, None, None], slope)


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
         prec: Precision) -> torch.Tensor:
    """2-D convolution, no padding, of (B, in, T, C) by (out, in, k, 1)."""
    return F.conv2d(prec.operand(x), prec.operand(w), b)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    return F.linear(prec.operand(x), prec.operand(w), b)


def lstm_last(x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    """The last hidden state of an LSTM over ``x`` (B, T, I) from zero
    state: gates = x_t wi + h wh + b, i, f, o sigmoid, g tanh,
    c = f c + i g, h = o tanh(c)."""
    n_b, n_t, _ = x.shape
    hid = wh.shape[0]
    xg = (prec.operand(x).reshape(n_b * n_t, -1) @ prec.operand(wi)).reshape(n_b, n_t, -1) + b
    h = x.new_zeros(n_b, hid)
    c = x.new_zeros(n_b, hid)
    whp = prec.operand(wh)
    for t in range(n_t):
        gates = xg[:, t] + prec.operand(h) @ whp
        i = torch.sigmoid(gates[:, :hid])
        f = torch.sigmoid(gates[:, hid:2 * hid])
        g = torch.tanh(gates[:, 2 * hid:3 * hid])
        o = torch.sigmoid(gates[:, 3 * hid:])
        c = f * c + i * g
        h = o * torch.tanh(c)
    return h


def dropout(x: torch.Tensor, keep_mask: Optional[torch.Tensor], p: float) -> torch.Tensor:
    """Inverted dropout with a given keep-mask; identity without one."""
    if keep_mask is None:
        return x
    return torch.where(keep_mask.to(torch.bool), x / (1.0 - p), torch.zeros_like(x))


def nhwc_flat(y: torch.Tensor) -> torch.Tensor:
    """(B, F, T, C) flattened in channels-last order (T, C, F)."""
    return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)


def conv_spec(name: str, n_out: int, n_in: int, k: int) -> Spec:
    return [(f"{name}.weight", (n_out, n_in, k, 1), "lecun", n_in * k),
            (f"{name}.bias", (n_out,), "zeros", 0)]


def stencil_spec(name: str, features: int, k: int) -> Spec:
    return [(f"{name}.weight", (k, features), "lecun", k),
            (f"{name}.bias", (features,), "zeros", 0)]


def linear_spec(name: str, n_out: int, n_in: int) -> Spec:
    return [(f"{name}.weight", (n_out, n_in), "lecun", n_in),
            (f"{name}.bias", (n_out,), "zeros", 0)]


def lstm_spec(name: str, n_in: int, hid: int) -> Spec:
    return [(f"{name}.wi", (n_in, 4 * hid), "lecun", n_in),
            (f"{name}.wh", (hid, 4 * hid), "orthogonal_gates", hid),
            (f"{name}.b", (4 * hid,), "zeros", 0)]


def cast(params: Dict[str, torch.Tensor], prec: Precision) -> Dict[str, torch.Tensor]:
    return {k: v.to(prec.dtype) for k, v in params.items()}
