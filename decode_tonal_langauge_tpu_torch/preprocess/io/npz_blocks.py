"""NPZ block IO backend.

A block directory holds a ``raw.npz`` with modality arrays (``ecog``,
``audio``) and their sampling rates (``ecog_sf``, ``audio_sf``).
``save_block`` writes per-modality ``B<block>_<mod>.npz`` files with
``data`` and ``sf`` keys inside ``subject_<id>/``, the schema epoch
extraction reads. A modality may be a tensor on any device: it is
copied to the host here.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def load_block(block_path: str) -> dict:
    """Read a block directory and return ``{mod: array, mod_sf: rate}``."""
    raw_path = os.path.join(block_path, "raw.npz")
    if not os.path.exists(raw_path):
        raise FileNotFoundError(
            f"Expected {raw_path}; npz block directories must contain raw.npz"
        )
    data = {}
    with np.load(raw_path) as archive:
        for key in archive.files:
            value = archive[key]
            data[key] = float(value) if key.endswith("_sf") else value
    return data


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_block(
    setup_dir: str, subject_id: int, block_id: int, data_dict: dict
) -> None:
    """Save all modalities of a block."""
    subject_output_dir = os.path.join(setup_dir, f"subject_{subject_id}")
    os.makedirs(subject_output_dir, exist_ok=True)

    for key, value in data_dict.items():
        if key.endswith("_sf"):
            continue
        sf = data_dict.get(f"{key}_sf")
        file_path = os.path.join(subject_output_dir, f"B{block_id}_{key}.npz")
        np.savez(file_path, data=_host(value), sf=sf)
