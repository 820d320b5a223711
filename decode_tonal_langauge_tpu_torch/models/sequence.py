"""Sequence decoders: the GRU-CTC phoneme decoder of Willett et al., "A
high-performance speech neuroprosthesis", Nature 620, 1031-1036 (2023),
the ``GRUDecoder`` of ``neural_seq_decoder`` (``src/neural_decoder/
model.py``).

Binned neural features (B, T, neural_dim) and each trial's recording day
-> per-frame class logits (B, L, n_classes + 1), the CTC blank at index 0:

1. depthwise Gaussian smoothing over time: 20 taps (``SMOOTH_TAPS``, the
   source's constant) of a Gaussian of sd ``smooth_width`` bins centred at 9.5,
   normalised to sum 1, ``padding="same"`` (9 bins before, 10 after);
2. the day's affine layer, ``softsign(x W_d + b_d)``, its weights
   gathered per trial;
3. patches of ``kernel_len`` bins at stride ``stride_len``, channel-major
   (feature ``c * kernel_len + k``, ``torch.nn.Unfold``'s order), so
   L = (T - kernel_len) // stride_len + 1 frames;
4. ``layer_dim`` GRU layers of ``hidden_dim`` (``ops/gru.py``, both
   directions with ``bidirectional``), dropout on the outputs of every
   layer but the last;
5. a linear layer to ``n_classes + 1``.

The state-dict names are the source's (``dayWeights``, ``dayBias``,
``gru_decoder.weight_ih_l0``..., ``fc_decoder_out``). The source also
holds ``n_days`` affine modules (``inpLayer{k}``) that its forward never
uses, and the smoothing kernel as a buffer; neither is kept here, so its
checkpoints load with ``strict=False``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gru import TimeBatchedGRU

SMOOTH_TAPS = 20


def gaussian_kernel(taps: int, sd: float) -> torch.Tensor:
    """The source's ``GaussianSmoothing`` kernel (float32): a Gaussian of
    ``sd`` over ``taps`` points centred at (taps - 1) / 2, over its sum."""
    grid = torch.arange(taps, dtype=torch.float32)
    mean = (taps - 1) / 2
    k = 1 / (sd * math.sqrt(2 * math.pi)) * torch.exp(-(((grid - mean) / sd) ** 2) / 2)
    return k / torch.sum(k)


class GRUDecoder(nn.Module):
    """The GRU-CTC phoneme decoder (module docstring), called as
    ``model(x, day)``: ``x`` (B, T, neural_dim), ``day`` (B,) long."""

    def __init__(self, neural_dim: int, n_classes: int, hidden_dim: int, layer_dim: int,
                 n_days: int = 1, kernel_len: int = 32, stride_len: int = 4,
                 smooth_width: float = 2.0, dropout: float = 0.0,
                 bidirectional: bool = True) -> None:
        super().__init__()
        self.neural_dim, self.n_classes = neural_dim, n_classes
        self.kernel_len, self.stride_len = kernel_len, stride_len
        kern = gaussian_kernel(SMOOTH_TAPS, smooth_width)
        self.register_buffer("smoother", kern.repeat(neural_dim, 1, 1), persistent=False)
        self.dayWeights = nn.Parameter(torch.empty(n_days, neural_dim, neural_dim))
        self.dayBias = nn.Parameter(torch.empty(n_days, 1, neural_dim))
        self.gru_decoder = TimeBatchedGRU(neural_dim * kernel_len, hidden_dim, layer_dim,
                                          dropout, bidirectional)
        self.fc_decoder_out = nn.Linear(hidden_dim * self.gru_decoder.directions, n_classes + 1)

    def frames(self, n_bins: int) -> int:
        """Frames the GRU sees for ``n_bins`` bins of input."""
        return (n_bins - self.kernel_len) // self.stride_len + 1

    def output_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        """The source's CTC input lengths, ``(T - kernel_len) // stride_len``
        frames for a trial of T real bins (one fewer than :meth:`frames`)."""
        return torch.div(lengths - self.kernel_len, self.stride_len, rounding_mode="floor")

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The source's initialisation, drawn from ``generator``: the day
        layers the identity and a zero bias; ``weight_hh`` orthogonal and
        ``weight_ih`` Xavier-uniform, GRU biases uniform in +-1/sqrt(H)
        (``nn.GRU``'s); the output layer ``nn.Linear``'s."""
        with torch.no_grad():
            eye = torch.eye(self.neural_dim)
            self.dayWeights.copy_(eye.expand_as(self.dayWeights))
            self.dayBias.zero_()
            bound = 1 / math.sqrt(self.gru_decoder.hidden_size)
            for name, p in self.gru_decoder.named_parameters():
                w = torch.empty(p.shape)
                if name.startswith("weight_hh"):
                    nn.init.orthogonal_(w, generator=generator)
                elif name.startswith("weight_ih"):
                    nn.init.xavier_uniform_(w, generator=generator)
                else:
                    w.uniform_(-bound, bound, generator=generator)
                p.copy_(w)
            fc = self.fc_decoder_out
            w = torch.empty(fc.weight.shape)
            nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=generator)
            fc.weight.copy_(w)
            fan_in = fc.weight.shape[1]
            fc.bias.copy_(torch.empty(fc.bias.shape).uniform_(
                -1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in), generator=generator))

    def forward(self, x: torch.Tensor, day: torch.Tensor) -> torch.Tensor:
        # padding="same": 9 bins before, 10 after
        padded = F.pad(x.transpose(1, 2), ((SMOOTH_TAPS - 1) // 2, SMOOTH_TAPS // 2))
        smooth = F.conv1d(padded, self.smoother.to(x.dtype), groups=self.neural_dim).transpose(1, 2)
        w, b = self.dayWeights[day], self.dayBias[day]
        y = F.softsign(torch.bmm(smooth, w) + b)
        n_b, n_t, n_c = y.shape
        patches = y.unfold(1, self.kernel_len, self.stride_len)  # (B, L, C, K)
        patches = patches.reshape(n_b, patches.shape[1], n_c * self.kernel_len)
        return self.fc_decoder_out(self.gru_decoder(patches))
