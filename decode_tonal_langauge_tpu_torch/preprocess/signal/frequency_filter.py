"""Frequency-filter step: hilbert / butter / fir bands.

Each entry of ``params.bands`` selects a method; the bands' outputs are
concatenated along the channel axis on the data's device.
"""

from __future__ import annotations

from argparse import Namespace

import torch

from ...ops.fir import fir_bandpass_filter
from ...ops.hilbert import hilbert_filter, hilbert_filter_blocked
from ...ops.iir import butter_filter

# Above this length the Hilbert bank runs blockwise (8192-sample chunks).
# The JAX package's threshold, kept so that both packages take the same
# route: the blocked output differs from the full-length one at ~1e-3.
HILBERT_FFT_LIMIT = 16384


def run(data: torch.Tensor, params: Namespace) -> torch.Tensor:
    bands = getattr(params, "bands", None)
    if bands is None:
        raise ValueError("bands must be specified in params.")

    all_channels = []
    for freq_config in bands:
        if not isinstance(freq_config, dict):
            freq_config = vars(freq_config)
        method = freq_config.get("method", "hilbert")
        method_params = freq_config.get("params", {}) or {}
        if not isinstance(method_params, dict):
            method_params = vars(method_params)

        if method == "hilbert":
            if "freq_ranges" not in method_params:
                raise ValueError("Hilbert filter requires 'freq_ranges' in params.")
            mp = dict(method_params)
            freq_ranges = mp.pop("freq_ranges")
            if (
                isinstance(freq_ranges, (list, tuple))
                and len(freq_ranges) == 2
                and isinstance(freq_ranges[0], (int, float))
            ):
                freq_ranges = [tuple(float(v) for v in freq_ranges)]
            if data.shape[-1] > HILBERT_FFT_LIMIT:
                signals = hilbert_filter_blocked(
                    data, params.signal_freq, freq_ranges, **mp
                )
            else:
                signals = hilbert_filter(data, params.signal_freq, freq_ranges, **mp)
        elif method == "butter":
            if "freqs" not in method_params:
                raise ValueError("Butterworth filter requires 'freqs' in params.")
            mp = dict(method_params)
            freqs = mp.pop("freqs")
            signals = butter_filter(data, freqs, fs=params.signal_freq, **mp)
        elif method == "fir":
            if "order" not in method_params or "center_frequencies" not in method_params:
                raise ValueError(
                    "FIR filter requires 'order' and 'center_frequencies' in params."
                )
            signals = fir_bandpass_filter(
                data,
                fs=params.signal_freq,
                order=method_params["order"],
                center_frequencies=method_params["center_frequencies"],
            )
        else:
            raise ValueError(
                f"Unknown filter method '{method}'; expected hilbert/butter/fir."
            )
        all_channels.append(signals)

    if len(all_channels) == 1:
        return all_channels[0]
    return torch.cat(all_channels, dim=0)
