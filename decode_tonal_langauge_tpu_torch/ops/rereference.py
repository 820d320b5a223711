"""Re-referencing and normalisation: CAR, interval z-score, channel
z-score and rolling-window z-score over (C, T) tensors.

Counterpart of ``decode_tonal_langauge_tpu/ops/rereference.py``. Every
op runs on the tensor's device. ``torch.std`` defaults to the sample std
(``correction=1``); the interval and channel z-scores use the population
std (ddof 0, as ``np.std``), and the rolling z-score its own ddof-1
formula from cumulative sums (pandas' ``rolling(min_periods=1).std``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def car_rereference(
    data: torch.Tensor, exclude_channels: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """Common-average referencing; excluded channels don't enter the mean
    but are still re-referenced."""
    n_channels = data.shape[0]
    exclude_channels = list(exclude_channels or [])
    if any(ch < 0 or ch >= n_channels for ch in exclude_channels):
        raise ValueError("exclude_channels contains invalid channel indices.")
    weights = torch.ones(n_channels, dtype=data.dtype, device=data.device)
    if exclude_channels:
        weights[exclude_channels] = 0.0
    common = (weights[:, None] * data).sum(dim=0, keepdim=True) / weights.sum()
    return data - common


def interval_zscore(data: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Z-score each channel by the mean and population std of
    ``data[:, start:end]``."""
    ref = data[:, start:end]
    mean = ref.mean(dim=1, keepdim=True)
    std = ref.std(dim=1, keepdim=True, correction=0)
    return (data - mean) / std


def _fill_nans(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(z), torch.zeros_like(z), z)


def channel_zscore(data: torch.Tensor, fill_nans: bool = False) -> torch.Tensor:
    """Global per-channel z-score (population std); optionally zero-fill
    NaNs."""
    mean = data.mean(dim=-1, keepdim=True)
    std = data.std(dim=-1, keepdim=True, correction=0)
    z = (data - mean) / std
    return _fill_nans(z) if fill_nans else z


def rolling_zscore(
    data: torch.Tensor, window_size: int, fill_nans: bool = False
) -> torch.Tensor:
    """Trailing rolling-window z-score with pandas semantics.

    At time t the window covers ``[max(0, t-w+1), t]``; the mean uses the
    actual count, the std uses ddof 1 and is NaN where the window holds one
    sample (t = 0), which reaches the z-score unless ``fill_nans``.
    Rolling sums are cumulative-sum differences, taken after subtracting
    each channel's mean so that f32 accumulation stays well conditioned.
    """
    if window_size <= 1:
        raise ValueError("window_size must be greater than 1.")

    t = data.shape[-1]
    center = data.mean(dim=-1, keepdim=True)
    x = (data - center).to(torch.float32)

    cs1 = torch.cumsum(x, dim=-1)
    cs2 = torch.cumsum(x * x, dim=-1)

    # Trailing-window sums: s[t] = cs[t] - cs[t - w] (0 before the window fills).
    def shifted(cs):
        if t > window_size:
            pad = torch.zeros_like(cs[..., :window_size])
            return torch.cat([pad, cs[..., : t - window_size]], dim=-1)
        return torch.zeros_like(cs)

    s1 = cs1 - shifted(cs1)
    s2 = cs2 - shifted(cs2)

    counts = torch.clamp(
        torch.arange(1, t + 1, device=data.device), max=window_size
    ).to(torch.float32)
    mean = s1 / counts
    # Sample variance (ddof=1); guard the count-1 positions.
    denom = torch.clamp(counts - 1.0, min=1.0)
    var = torch.clamp(s2 - s1 * s1 / counts, min=0.0) / denom
    std = torch.sqrt(var)
    std = torch.where(counts > 1.5, std, torch.full_like(std, float("nan")))

    z = (x - mean) / std
    if fill_nans:
        z = _fill_nans(z)
    return z.to(data.dtype)
