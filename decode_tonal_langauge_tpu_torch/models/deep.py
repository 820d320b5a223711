"""Paper deep classifiers: temporal CNN (syllable) and CNN-RNN (tone).

Counterparts of ``decode_tonal_langauge_tpu/models/deep.py``. The JAX
models are NHWC (time = H, electrodes = W, features = C); these convolve
in PyTorch's NCHW, and every flatten and concat follows the JAX order:
the CNN flattens (B, t, C, 256), and the CNN-RNN reshapes to
(B, t', w * 256), w-major, before its second LSTM. Pooling comes before
the leaky ReLU. ``dtype`` is the compute dtype of every stencil, conv,
dense and LSTM (``models/base.py``); the class heads compute in at least
float32 (``base.head``) and the outputs are float32. Dropout draws its
mask from the generator the trainer sets (``ops/dropout.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import Dropout
from ..ops.lstm import TimeBatchedLSTM
from ..ops.stencil import StencilConvPoolLeaky
from .base import compute_dtype, conv, conv_output_length, dense, head


def cnn_latent_length(input_length: int) -> int:
    """Temporal length after the CNNClassifier feature extractor."""
    t = input_length
    for _ in range(4):
        t = conv_output_length(t, 3)
        t = conv_output_length(t, 2, stride=2)
    t = conv_output_length(t, 3)  # block 5: conv only
    t = conv_output_length(t, 3)
    t = conv_output_length(t, 2, stride=2)
    return t


def _nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, F, H, W) -> (B, H * W * F) in the JAX (NHWC) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class CNNClassifier(nn.Module):
    """Temporal CNN for syllable decoding: (B, C, T) -> six conv blocks
    (512 ... 256 features, kernel (3, 1) over time) -> Dense(1024) ->
    Dense(n_classes) -> sigmoid."""

    def __init__(self, input_channels: int, input_length: int,
                 n_classes: int, dropout_rate: float = 0.5,
                 negative_slope: float = 0.01,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        if n_classes < 2:
            raise ValueError("Number of classes must be at least 2.")
        if input_channels <= 0:
            raise ValueError("Input channels must be a positive integer.")
        latent = cnn_latent_length(input_length)
        if latent <= 0:
            raise ValueError(
                "Input length is too small for the convolutional layers. "
                "Please increase the input length or adjust the model "
                "architecture."
            )
        self.negative_slope = negative_slope
        self.dtype = dtype = compute_dtype(dtype)
        widths = [512, 512, 512, 512, 512, 256]
        self.convs = nn.ModuleList(
            [StencilConvPoolLeaky(widths[0], 3, pool=2,
                                  negative_slope=negative_slope, dtype=dtype)]
            + [nn.Conv2d(widths[i - 1], widths[i], (3, 1))
               for i in range(1, len(widths))]
        )
        self.dropout = Dropout(dropout_rate)
        self.fc1 = nn.Linear(latent * input_channels * widths[-1], 1024)
        self.fc2 = nn.Linear(1024, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _nhwc_to_nchw(self.convs[0](x.transpose(1, 2)))
        for i, layer in enumerate(self.convs[1:], start=1):
            y = conv(layer, y, self.dtype)
            if i != 4:  # block 5 has no pool
                y = F.max_pool2d(y, (2, 1), (2, 1))
            y = F.leaky_relu(y, self.negative_slope)
        y = self.dropout(y)
        y = F.leaky_relu(dense(self.fc1, _flatten_nhwc(y), self.dtype), self.negative_slope)
        return torch.sigmoid(head(self.fc2, y))


class CNNRNNClassifier(nn.Module):
    """CNN-RNN for tone decoding: an LSTM(C -> lstm_dim) last state viewed
    as a (T, lstm_dim // T) image and the raw (T, C) image, each through a
    stencil conv(1024, k=7) + pool, concatenated on the electrode axis,
    then conv 512 -> 256 + pool(3), a second LSTM(-> 512) and the sigmoid
    head. Requires ``lstm_dim % input_length == 0``."""

    def __init__(self, input_channels: int, input_length: int,
                 n_classes: int, lstm_dim: int = 800, dropout: float = 0.5,
                 negative_slope: float = 0.01,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        if n_classes < 2:
            raise ValueError("Number of classes must be at least 2.")
        if lstm_dim % input_length != 0:
            raise ValueError(
                f"lstm_dim ({lstm_dim}) must be divisible "
                f"by input_length ({input_length})."
            )
        self.input_channels = input_channels
        self.input_length = input_length
        self.lstm_dim = lstm_dim
        self.negative_slope = negative_slope
        self.dtype = dtype = compute_dtype(dtype)
        self.lstm1 = TimeBatchedLSTM(input_channels, lstm_dim, dtype=dtype)
        self.conv1 = StencilConvPoolLeaky(1024, 7, pool=2,
                                          negative_slope=negative_slope, dtype=dtype)
        self.conv2 = StencilConvPoolLeaky(1024, 7, pool=2,
                                          negative_slope=negative_slope, dtype=dtype)
        self.conv3a = nn.Conv2d(1024, 512, (7, 1))
        self.conv3b = nn.Conv2d(512, 256, (7, 1))
        self.drop = Dropout(dropout)
        width = lstm_dim // input_length + input_channels
        self.lstm2 = TimeBatchedLSTM(width * 256, 512, dtype=dtype)
        self.head = nn.Linear(512, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        if c != self.input_channels:
            raise ValueError(f"Expected {self.input_channels} channels, got {c}.")
        if t != self.input_length:
            raise ValueError(f"Expected input length {self.input_length}, got {t}.")
        seq = x.transpose(1, 2)  # (B, T, C)
        x1 = self.lstm1(seq)[:, -1, :]  # (B, lstm_dim)
        raw = self.conv1(seq)  # (B, t', C, 1024)
        x1 = self.conv2(x1.reshape(b, t, self.lstm_dim // t))
        xf = _nhwc_to_nchw(torch.cat([x1, raw], dim=2))  # concat on width

        y = F.leaky_relu(conv(self.conv3a, xf, self.dtype), self.negative_slope)
        y = F.max_pool2d(conv(self.conv3b, y, self.dtype), (3, 1), (3, 1))
        y = self.drop(F.leaky_relu(y, self.negative_slope))
        # (B, 256, t'', w) -> (B, t'', w * 256), w-major as in JAX
        y = y.permute(0, 2, 3, 1).reshape(b, y.shape[2], -1)
        y = self.lstm2(y)[:, -1, :]
        return torch.sigmoid(head(self.head, y))
