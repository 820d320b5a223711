"""Dataset splitting: seeded random partitions with reference size rules.

A copy of ``decode_tonal_langauge_tpu/data/splits.py`` (plain numpy, so
both packages draw identical splits): sizes are ``int(n * ratio)`` for all
but the last split, which takes the remainder; the permutation is seeded.
"""

from __future__ import annotations

from typing import List

import numpy as np


def split_indices(
    n_samples: int, ratios: List[float], seed: int = 42
) -> List[np.ndarray]:
    """Seeded random partition of ``range(n_samples)`` by ratio list."""
    if sum(ratios) > 1.0 + 1e-9:
        # Without this gate, ratios summing past 1 silently make the last
        # split negative-sized -> an empty test set.
        raise ValueError(
            f"Split ratios {list(ratios)} sum to {sum(ratios):.4f} > 1; "
            "they must sum to at most 1."
        )
    sizes = []
    for i, ratio in enumerate(ratios):
        if ratio <= 0 or ratio >= 1:
            raise ValueError("All ratios must be between 0 and 1 (exclusive).")
        if i == len(ratios) - 1:
            sizes.append(n_samples - sum(sizes))
        else:
            sizes.append(int(n_samples * ratio))

    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_samples)

    out = []
    offset = 0
    for size in sizes:
        out.append(perm[offset : offset + size])
        offset += size
    return out


def batch_iter(
    n: int,
    batch_size: int,
    shuffle: bool,
    rng: np.random.Generator | None = None,
):
    """Yield index arrays of up to ``batch_size`` (last batch may be short)."""
    order = np.arange(n)
    if shuffle:
        assert rng is not None, "shuffle requires an rng"
        order = rng.permutation(n)
    for start in range(0, n, batch_size):
        yield order[start : start + batch_size]
