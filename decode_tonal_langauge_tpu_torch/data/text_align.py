"""TextGrid-driven ECoG/audio epoch extraction.

Counterpart of ``decode_tonal_langauge_tpu/data/text_align.py``:
``handle_textgrids`` parses each block's Praat annotations into
intervals (digit-leading marks ``<tone><syllable>``, the start/end
offsets applied, overlapping intervals skipped, times rounded to 0.1 s),
and ``extract_ecog_audio`` cuts aligned ECoG (C, T) -> (N, C, L) and
audio -> (N, L) windows at their own rates, codes the labels, tiles rest
windows, merges the blocks and writes the sample npz.

The JAX module keeps each block's intervals as a pandas DataFrame; here
they are records, a list of ``{"start", "end", "syllable", "tone"}``
dicts (the DataFrame's ``to_dict("records")``), since the card's machine
has no pandas. Syllables are coded as ``pd.Categorical(values,
categories=syllables).codes`` codes them: the category's index, -1 for a
syllable outside the list, in the smallest signed integer type that holds
the category count. Windows are cut with ``ops/framing`` on ``device``
(``None``: the card), in 32-bit types as the JAX gather returns them.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.framing import extract_epochs, extract_epochs_1d, tile_rest_windows
from ..runtime.device import DeviceLike, resolve_device
from .textgrid import TextGrid
from .utils import extract_block_id, match_filename

Intervals = List[dict]


def handle_textgrids(
    data_dir: str,
    start_offset: float = 0.0,
    end_offset: float = 0.0,
    tier_list: Optional[List[str]] = None,
    blocks: Optional[List[int]] = None,
) -> Dict[int, Intervals]:
    """Each block's TextGrid as interval records, keyed by the block id
    ``B<n>`` in its file name; each block is loaded once."""
    intervals: Dict[int, Intervals] = {}
    for file in sorted(os.listdir(data_dir)):
        if not file.endswith(".TextGrid"):
            continue
        block_number = extract_block_id(file)
        if blocks is not None and block_number not in blocks:
            continue
        if block_number in intervals:
            continue
        tg = TextGrid.from_file(os.path.join(data_dir, file))
        intervals[block_number] = read_textgrid(tg, start_offset, end_offset, tier_list)
        print(f"Maximum time for block {block_number}:", get_textgrid_time(tg, tier_list), " s")
    return intervals


def get_textgrid_time(tg: TextGrid, tier_list: Optional[List[str]] = None) -> float:
    """Largest interval end time over the selected tiers."""
    if tier_list is None:
        tier_list = [tier.name.lower() for tier in tg.tiers]
    return max(
        (interval.maxTime for tier in tg.tiers if tier.name.lower() in tier_list
         for interval in tier.intervals),
        default=0.0,
    )


def read_textgrid(
    tg: TextGrid,
    start_offset: float,
    end_offset: float,
    tier_list: Optional[List[str]] = None,
) -> Intervals:
    """Records of the intervals whose mark starts with a digit:
    ``<tone digit><syllable char>``."""
    if tier_list is None:
        wanted = {tier.name.lower() for tier in tg.tiers}
    else:
        wanted = {name.lower() for name in tier_list}
    trials: Intervals = []
    for tier in tg.tiers:
        if tier.name.lower() not in wanted:
            continue
        for interval in tier.intervals:
            if not interval.mark or not interval.mark[0].isdigit():
                continue
            tone = int(interval.mark[0])
            syllable = interval.mark[1]
            start = interval.minTime - start_offset
            end = interval.maxTime + end_offset
            if trials and start < trials[-1]["end"]:
                warnings.warn(
                    f"Overlapping intervals detected in tier '{tier.name}' "
                    f"at time {interval.minTime:.2f} for syllable '{syllable}', "
                    f"previous end time was {trials[-1]['end']:.2f}. "
                    "Skipping this interval ... "
                )
                continue
            trials.append({
                "start": float(np.around(start, decimals=1)),
                "end": float(np.around(end, decimals=1)),
                "syllable": syllable,
                "tone": tone,
            })
    return trials


def categorical_codes(values: Sequence, categories: Sequence) -> np.ndarray:
    """``pd.Categorical(values, categories=categories).codes``: each value's
    index in ``categories``, -1 where it is absent, as int8 below 127
    categories (int16, int32, int64 above)."""
    index = {c: i for i, c in enumerate(categories)}
    n = len(categories)
    for dtype in (np.int8, np.int16, np.int32):
        if n < np.iinfo(dtype).max:
            break
    else:
        dtype = np.int64
    return np.array([index.get(v, -1) for v in values], dtype=dtype)


def _load_recording(path: str, file: str) -> Tuple[np.ndarray, float]:
    dataset = np.load(path)
    for key in ("data", "sf"):
        if key not in dataset:
            raise KeyError(
                f"Expected key '{key}' not found in the npz file {file}. "
                f"Existing keys {list(dataset.keys())}."
            )
    return dataset["data"], float(dataset["sf"])


def _cut(fn, data: np.ndarray, starts, length: int, device: torch.device) -> np.ndarray:
    """Windows of ``data`` on ``device``, in 32-bit types (float32 for
    floating data, int32 otherwise), back on the host."""
    dtype = np.float32 if np.issubdtype(data.dtype, np.floating) else np.int32
    signal = torch.as_tensor(np.ascontiguousarray(data, dtype=dtype), device=device)
    return fn(signal, torch.as_tensor(np.asarray(starts)), length).cpu().numpy()


def extract_ecog_audio(
    intervals: Dict[int, Intervals],
    recording_dir: str,
    syllables: List[str],
    length: float = 1.0,
    output_path: Optional[str] = None,
    rest_period: Optional[Tuple[float, float]] = None,
    recording_format: str = "npz",
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Aligned ECoG/audio windows and labels, saved as a sample npz when
    ``output_path`` is given.

    Output keys: ``ecog (N, C, L_e)``, ``ecog_sf``, ``audio (N, L_a)``,
    ``audio_sf``, ``syllable (N,)``, ``tone (N,)`` (shifted to start at 0)
    and, with a rest period, ``ecog_rest``. Audio files match the keyword
    ``sound`` or ``audio``, ECoG files ``ecog``."""
    device = resolve_device(device)
    erp_samples: Dict[int, np.ndarray] = {}
    ecog_rest_samples: Dict[int, np.ndarray] = {}
    audio_samples: Dict[int, np.ndarray] = {}
    syllable_labels: Dict[int, np.ndarray] = {}
    tone_labels: Dict[int, np.ndarray] = {}
    ecog_sampling_rate = audio_sampling_rate = None

    for file in sorted(os.listdir(recording_dir)):
        is_ecog = match_filename(file, recording_format, ["ecog"])
        is_audio = (match_filename(file, recording_format, ["sound"])
                    or match_filename(file, recording_format, ["audio"]))
        if not (is_ecog or is_audio):
            continue
        block = extract_block_id(file)
        if block not in intervals:
            continue
        store = erp_samples if is_ecog else audio_samples
        if block in store:
            warnings.warn(
                f"Found multiple {'ECoG' if is_ecog else 'audio'} files for "
                f"block {block}, skipping file {file}. "
            )
            continue

        data, sf = _load_recording(os.path.join(recording_dir, file), file)
        records = intervals[block]
        seg_len = int(length * sf)
        block_starts = np.array([r["start"] for r in records], dtype=np.float64)
        starts = (block_starts * sf).astype(int)
        if len(starts) and starts.max() + seg_len > data.shape[1]:
            raise ValueError(
                f"Requested sample length exceeds data length for block {block}. "
                f"Max start: {starts.max()}, End: {starts.max() + seg_len}; "
                f"Data length: {data.shape[1]}."
            )

        if is_ecog:
            ecog_sampling_rate = sf
            erp_samples[block] = _cut(extract_epochs, data, starts, seg_len, device)
            tone_labels[block] = np.array([r["tone"] for r in records], dtype=np.int64)
            syllable_labels[block] = categorical_codes([r["syllable"] for r in records],
                                                       syllables)
            if rest_period is not None:
                interval_earliest = float(block_starts.min())
                rest_start = int(rest_period[0] * sf)
                rest_end = int(rest_period[1] * sf)
                if rest_period[1] > interval_earliest:
                    warnings.warn(
                        f"Rest period end ({rest_period[1]} s) is after the "
                        f"earliest interval start for block {block} "
                        f"(earliest event time: {interval_earliest} s). "
                        "Reducing rest period end ..."
                    )
                    rest_end = int(interval_earliest * sf)
                rest_starts = tile_rest_windows(rest_start, rest_end, seg_len)
                ecog_rest_samples[block] = _cut(extract_epochs, data, rest_starts, seg_len,
                                                device)
        else:
            audio_sampling_rate = sf
            series = data[0] if data.ndim == 2 else data  # mono: (1, T) or (T,)
            audio_samples[block] = _cut(extract_epochs_1d, series, starts, seg_len, device)

    block_ids = list(audio_samples.keys())
    if set(erp_samples.keys()) != set(block_ids):
        raise ValueError(
            "Mismatch between ECoG and audio samples blocks. "
            "Ensure both ECoG and audio files are present for each block."
            f" ECoG blocks found: {list(erp_samples.keys())},"
            f" Audio blocks found: {block_ids}."
        )
    if len(block_ids) == 0:
        raise ValueError(
            "No valid blocks found in the specified directories."
            f"Blocks in textgrids: {list(intervals.keys())}. "
        )

    all_tone = np.concatenate([tone_labels[b] for b in block_ids], axis=0)
    min_label = np.min(all_tone)
    if min_label > 0:
        all_tone = all_tone - min_label  # tone labels from 0
    output_data = {
        "ecog": np.concatenate([erp_samples[b] for b in block_ids], axis=0),
        "ecog_sf": ecog_sampling_rate,
        "audio": np.concatenate([audio_samples[b] for b in block_ids], axis=0),
        "audio_sf": audio_sampling_rate,
        "syllable": np.concatenate([syllable_labels[b] for b in block_ids], axis=0),
        "tone": all_tone,
    }
    if rest_period is not None:
        output_data["ecog_rest"] = np.concatenate(
            [ecog_rest_samples[b] for b in block_ids], axis=0)
    if output_path is not None:
        np.savez(output_path, **output_data)
    return output_data
