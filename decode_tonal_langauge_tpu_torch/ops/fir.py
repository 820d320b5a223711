"""FIR filtering as one batched causal convolution.

Counterpart of ``decode_tonal_langauge_tpu/ops/fir.py``: the design
(``firwin``) is host-side SciPy; the application is one ``conv1d`` over
all channels, in full f32.
"""

from __future__ import annotations

from typing import List

import numpy as np
import scipy.signal as sps
import torch
import torch.nn.functional as F

from ..runtime.device import exact_f32


def firwin_bandpass(order: int, lowcut: float, highcut: float, fs: float) -> np.ndarray:
    """FIR bandpass taps, reference parameterisation (``firwin(order+1, ...)``)."""
    nyq = 0.5 * fs
    return sps.firwin(order + 1, [lowcut / nyq, highcut / nyq], pass_zero=False, fs=fs)


def fir_causal(taps, x: torch.Tensor) -> torch.Tensor:
    """Causal FIR filtering of (..., T), equal to
    ``scipy.signal.lfilter(taps, 1, x)``: a correlation with the flipped
    taps over the input padded on the left by ``k - 1`` zeros."""
    taps = torch.as_tensor(np.asarray(taps), dtype=x.dtype, device=x.device)
    k = taps.shape[0]
    t = x.shape[-1]
    xb = F.pad(x.reshape(-1, 1, t), (k - 1, 0))
    with exact_f32():
        y = F.conv1d(xb, taps.flip(0).reshape(1, 1, k))
    return y.reshape(x.shape)


def fir_bandpass_filter(
    data: torch.Tensor,
    fs: float,
    order: int,
    center_frequencies: List[float],
) -> torch.Tensor:
    """Mean of causal FIR bandpasses at +/-10% around each center
    frequency (accumulate, then divide)."""
    acc = torch.zeros_like(data)
    for center in center_frequencies:
        acc = acc + fir_causal(firwin_bandpass(order, center * 0.9, center * 1.1, fs), data)
    return acc / len(center_frequencies)
