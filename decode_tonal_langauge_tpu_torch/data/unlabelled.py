"""Unlabelled sliding-window sample collection (self-supervised hook).

A copy of ``decode_tonal_langauge_tpu/data/unlabelled.py`` (host numpy):
walk a folder of processed ``.npz`` files, cut each continuous recording
into overlapping segments and split every segment into patches. The
windowing is a zero-copy ``sliding_window_view``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .utils import match_filename


def sliding_window_patches(
    data: np.ndarray, patch_size: int, segment_length: int,
    step_size: Optional[int] = None,
) -> np.ndarray:
    """(C, T) -> (n_windows, C, n_patches, patch_size) without copying."""
    if step_size is None:
        step_size = segment_length // 2
    if segment_length % patch_size != 0:
        raise ValueError(
            f"segment_length ({segment_length}) must be a multiple of "
            f"patch_size ({patch_size})."
        )
    n_channels, n_timepoints = data.shape
    if n_timepoints < segment_length:
        return np.empty(
            (0, n_channels, segment_length // patch_size, patch_size),
            dtype=data.dtype,
        )
    windows = np.lib.stride_tricks.sliding_window_view(
        data, segment_length, axis=-1
    )[:, ::step_size, :]  # (C, n_windows, segment_length)
    windows = np.moveaxis(windows, 0, 1)  # (n_windows, C, segment_length)
    n_patches = segment_length // patch_size
    return windows.reshape(
        windows.shape[0], n_channels, n_patches, patch_size
    )


def collect_unlabelled_samples(
    dataset_folder: str,
    patch_size: int,
    segment_length: int,
    step_size: Optional[int] = None,
    kwords: Optional[List[str]] = None,
    data_key: str = "data",
    verbose: bool = False,
) -> np.ndarray:
    """Gather patched sliding-window segments from every matching npz.

    Returns (n_samples, n_channels, n_patches, patch_size) concatenated
    over files. Files must store the continuous recording as ``data_key``
    with shape (C, T) (the preprocess stage's block npz layout).
    """
    all_samples = []
    for root, _, files in os.walk(dataset_folder):
        for file in sorted(files):
            if not match_filename(file, "npz", kwords):
                continue
            file_path = os.path.join(root, file)
            with np.load(file_path) as dataset:
                if data_key not in dataset:
                    raise KeyError(
                        f"No '{data_key}' array in {file_path}; "
                        f"found keys: {list(dataset.keys())}"
                    )
                data = dataset[data_key]
            samples = sliding_window_patches(
                data, patch_size, segment_length, step_size
            )
            if verbose:
                print(f"{file_path}: {samples.shape[0]} windows")
            if samples.shape[0]:
                all_samples.append(samples)

    if not all_samples:
        raise ValueError(
            f"No unlabelled samples found under {dataset_folder} "
            f"(kwords={kwords})."
        )
    out = np.concatenate(all_samples, axis=0)
    if verbose:
        print(f"collected {out.shape[0]} unlabelled samples total")
    return out
