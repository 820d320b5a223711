"""Seeding: the per-repeat seed stream and process-wide seeds.

Counterpart of ``decode_tonal_langauge_tpu/utils/seeding.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def set_seeds(seed: int) -> torch.Generator:
    """Seed numpy's and torch's global streams and return a CPU
    ``torch.Generator`` seeded the same, for callers that keep their
    randomness explicit (the trainer owns its own generators)."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def seed_stream(seed: int = 42, repeat: int = 1) -> np.ndarray:
    """The per-repeat seed draw ``np.random.seed(seed);
    np.random.randint(0, 10000, repeat)``, from a local ``RandomState`` so
    the process-global stream is left alone. Training, evaluation and
    serving all derive the same seeds, in both packages."""
    return np.random.RandomState(seed).randint(0, 10000, repeat)
