"""Speech-synthesis models: ECoG + label dynamics -> mel spectrogram.

Counterparts of ``decode_tonal_langauge_tpu/models/synthesis.py``. Both
take non-discriminative ECoG channels (B, C, T) and label-dynamics
sequences (B, 2, n_dynamics) and return a flattened mel vector
(B, output_dim). Convolutions run in NCHW / NCL; flattens and concats
follow the JAX (channels-last) order. Dropout draws its mask from the
generator the trainer sets (``ops/dropout.py``); SynthesisLite's batch
norm trains as Flax's does (:class:`BatchNorm1d`). ``dtype`` is the
compute dtype of every stencil, conv, dense and LSTM, the output layer
included, as in JAX (``models/base.py``); the outputs are float32 (or
float64 for a float64 reference run).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import Dropout
from ..ops.lstm import TimeBatchedLSTM
from ..ops.stencil import StencilConvPoolLeaky
from .base import at_least_f32, compute_dtype, conv, conv_output_length, dense
from .deep import _flatten_nhwc, _nhwc_to_nchw


def synthesis_cnn_latent_length(n_timepoints: int) -> int:
    """Temporal length after the SynthesisModelCNN ECoG conv stack."""
    t = n_timepoints
    for _ in range(3):
        t = conv_output_length(t, 3)
        t = conv_output_length(t, 2, stride=2)
    t = conv_output_length(t, 1)
    t = conv_output_length(t, 2, stride=2)
    return conv_output_length(t, 1)


class BatchNorm1d(nn.BatchNorm1d):
    """Flax's ``nn.BatchNorm`` over the channels of (B, C, T).

    In train mode it normalises with the biased batch statistics, Flax's
    ``E[x^2] - E[x]^2`` clipped at 0, and updates the running mean and
    variance with those same statistics: ``ra = 0.99 * ra + 0.01 * stat``
    (Flax's momentum 0.99, torch's 0.01). ``nn.BatchNorm1d`` would update
    the running variance with the unbiased batch variance, n / (n - 1)
    times Flax's. Both modes compute ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias`` as Flax does. The statistics and the normalisation
    are computed in at least float32 and the running statistics stay
    float32, as Flax's ``force_float32_reductions``; the output is in the
    input's dtype (the model's compute dtype). The state dict keeps
    ``nn.BatchNorm1d``'s keys."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.01) -> None:
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype, x = x.dtype, at_least_f32(x)
        if self.training:
            mean = x.mean(dim=(0, 2))
            var = ((x * x).mean(dim=(0, 2)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
                self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None]) * mul[:, None] + self.bias[:, None]).to(dtype)


class SynthesisModelCNN(nn.Module):
    """Paper synthesis model ("SynthesisFull"). ECoG: five conv(+pool)
    blocks 512/512/512/256/conv_channels. Labels: LSTM(2 -> latent * C *
    lstm_channels), last state reshaped onto the ECoG latent grid. Concat
    on features, 4x 1x1 conv(128) + 1x1 conv(conv_channels) with slope
    0.1, flatten, Dense(output_dim)."""

    def __init__(self, output_dim: int, n_channels: int,
                 n_timepoints: int = 200, lstm_channels: int = 6,
                 conv_channels: int = 64, dropout: float = 0.5,
                 negative_slope: float = 0.01,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.latent_len = synthesis_cnn_latent_length(n_timepoints)
        if self.latent_len <= 0:
            raise ValueError(
                "n_timepoints too small for the SynthesisModelCNN conv stack."
            )
        self.n_channels = n_channels
        self.lstm_channels = lstm_channels
        self.negative_slope = negative_slope
        self.dtype = dtype = compute_dtype(dtype)
        self.ecog_convs = nn.ModuleList([
            StencilConvPoolLeaky(512, 3, pool=2, negative_slope=negative_slope,
                                 dtype=dtype),
            nn.Conv2d(512, 512, (3, 1)),
            nn.Conv2d(512, 512, (3, 1)),
            nn.Conv2d(512, 256, (1, 1)),
            nn.Conv2d(256, conv_channels, (1, 1)),
        ])
        self.ecog_dropout = Dropout(dropout)
        self.label_lstm = TimeBatchedLSTM(
            2, self.latent_len * n_channels * lstm_channels, dtype=dtype
        )
        widths = [conv_channels + lstm_channels, 128, 128, 128, 128,
                  conv_channels]
        self.concat_convs = nn.ModuleList(
            nn.Conv2d(widths[i], widths[i + 1], (1, 1)) for i in range(5)
        )
        self.output_layer = nn.Linear(
            self.latent_len * n_channels * conv_channels, output_dim
        )

    def forward(self, inputs_ecog: torch.Tensor,
                inputs_labels: torch.Tensor) -> torch.Tensor:
        b = inputs_ecog.shape[0]
        x = _nhwc_to_nchw(self.ecog_convs[0](inputs_ecog.transpose(1, 2)))
        for i, layer in enumerate(self.ecog_convs[1:], start=1):
            x = conv(layer, x, self.dtype)
            if i != 4:  # the final conv block has no pool
                x = F.max_pool2d(x, (2, 1), (2, 1))
            x = F.leaky_relu(x, self.negative_slope)
        x = self.ecog_dropout(x)  # (B, conv_channels, latent, C)

        x2 = self.label_lstm(inputs_labels.transpose(1, 2))[:, -1, :]
        x2 = _nhwc_to_nchw(x2.reshape(
            b, self.latent_len, self.n_channels, self.lstm_channels
        ))
        y = torch.cat([x, x2], dim=1)  # concat on features
        for layer in self.concat_convs:
            y = F.leaky_relu(conv(layer, y, self.dtype), 0.1)
        return at_least_f32(dense(self.output_layer, _flatten_nhwc(y), self.dtype))


class SynthesisLite(nn.Module):
    """Lightweight synthesis model. ECoG: 2x [Conv1d + BatchNorm +
    MaxPool(2) + LeakyReLU]; labels: LSTM(label_dim -> lstm_hidden) final
    state; concat -> Dropout -> Dense(512) -> Dense(output_dim). BatchNorm
    is Flax's (:class:`BatchNorm1d`, eps 1e-5, momentum 0.99)."""

    def __init__(self, output_dim: int, n_channels: int,
                 n_timepoints: int = 200, label_dim: int = 2,
                 conv_channels: int = 32, lstm_hidden: int = 64,
                 dropout: float = 0.3, negative_slope: float = 0.01,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.negative_slope = negative_slope
        self.dtype = dtype = compute_dtype(dtype)
        self.conv1 = nn.Conv1d(n_channels, conv_channels, 5, padding=2)
        self.bn1 = BatchNorm1d(conv_channels)
        self.conv2 = nn.Conv1d(conv_channels, conv_channels, 3, padding=1)
        self.bn2 = BatchNorm1d(conv_channels)
        self.label_lstm = TimeBatchedLSTM(label_dim, lstm_hidden, dtype=dtype)
        self.drop = Dropout(dropout)
        t_out = n_timepoints // 2 // 2
        self.fc1 = nn.Linear(t_out * conv_channels + lstm_hidden, 512)
        self.fc2 = nn.Linear(512, output_dim)

    def forward(self, x_ecog: torch.Tensor,
                x_label: torch.Tensor) -> torch.Tensor:
        slope, dt = self.negative_slope, self.dtype
        x = F.max_pool1d(self.bn1(conv(self.conv1, x_ecog, dt)), 2, 2)
        x = F.leaky_relu(x, slope)
        x = F.max_pool1d(self.bn2(conv(self.conv2, x, dt)), 2, 2)
        x = F.leaky_relu(x, slope)
        x = x.transpose(1, 2).reshape(x.shape[0], -1)  # (B, T/4 * F)
        lbl = self.label_lstm(x_label.transpose(1, 2))[:, -1, :]
        y = self.drop(torch.cat([x, lbl], dim=-1))
        y = F.leaky_relu(dense(self.fc1, y, dt), slope)
        return at_least_f32(dense(self.fc2, y, dt))
