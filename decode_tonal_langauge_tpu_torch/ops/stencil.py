"""Fused first-layer stencil conv for C_in=1 image stacks.

Counterpart of ``decode_tonal_langauge_tpu/ops/stencil.py``. The paper
models open by convolving a (B, T, C) field, lifted to a one-channel
image, with a (K, 1) kernel over time. With one input channel that conv
is K broadcast products of time-shifted views:

    y[b, t, c, f] = sum_k w[k, f] * x[b, t + k, c] + bias[f]

Written as the JAX package writes it: each pool phase is its own sum of
shifted products, phases combine with ``maximum``, then bias and leaky
ReLU. Every op is an exact f32 elementwise product or sum (no cuDNN, so
TF32 never enters), and pooling comes before the activation. A compute
``dtype`` (bfloat16) casts x, the weight and the bias to it, and the K
shifted products accumulate in that dtype, as JAX's do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def stencil_conv_pool_leaky(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    pool: int,
    negative_slope: float,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """leaky(max_pool(conv_valid(x, weight) + bias)).

    x: (B, T, C); weight: (K, F); bias: (F,). ``pool`` is the max-pool
    window/stride over time (1 skips pooling). Returns (B, U, C, F) with
    U = (T - K + 1) // pool, the JAX package's NHWC layout. ``dtype``
    (None: the inputs' own) is the dtype the products, sums and output
    are computed in.
    """
    if dtype is not None:
        x, weight, bias = x.to(dtype), weight.to(dtype), bias.to(dtype)
    k_taps = weight.shape[0]
    u = (x.shape[1] - k_taps + 1) // pool

    def phase(p):
        acc = None
        for k in range(k_taps):
            start = p + k
            sl = x[:, start : start + pool * (u - 1) + 1 : pool]
            term = sl[..., None] * weight[k]
            acc = term if acc is None else acc + term
        return acc

    y = phase(0)
    for p in range(1, pool):
        y = torch.maximum(y, phase(p))
    return F.leaky_relu(y + bias, negative_slope=negative_slope)


class StencilConvPoolLeaky(nn.Module):
    """Conv (K, 1) VALID + (pool, 1) max-pool + leaky ReLU on a C_in=1
    image. Called with the (B, T, C) field; returns (B, U, C, F).

    ``weight`` is (K, F): the Flax kernel (K, 1, 1, F) reshaped; it stays
    in its own dtype and ``dtype`` (None: the weight's) is the compute
    dtype."""

    def __init__(self, features: int, kernel_size: int, pool: int = 2,
                 negative_slope: float = 0.01,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.pool = pool
        self.negative_slope = negative_slope
        self.weight = nn.Parameter(torch.empty(kernel_size, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stencil_conv_pool_leaky(
            x, self.weight, self.bias,
            pool=self.pool, negative_slope=self.negative_slope, dtype=self.dtype,
        )
