"""Downsample step: FFT resampling for short signals, the polyphase FIR
for recording-length ones (``params.resample_method`` "auto", "fft" or
"poly" overrides). Sets ``params.signal_freq`` to the target rate."""

from __future__ import annotations

from argparse import Namespace

import torch

from ...ops.resample import resample_to_rate


def run(data: torch.Tensor, params: Namespace) -> torch.Tensor:
    target_freq = getattr(params, "downsample_freq", 400)
    method = getattr(params, "resample_method", "auto")
    out = resample_to_rate(data, params.signal_freq, target_freq, method=method)
    params.signal_freq = target_freq
    return out
