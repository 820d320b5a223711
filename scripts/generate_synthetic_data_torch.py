#!/usr/bin/env python
"""Generate a synthetic subject for the example pipeline config, with the
PyTorch port (no JAX needed).

Writes raw block npz files + Praat TextGrids under ``<root>/raw`` in the
layout the preprocess stage expects:

    <root>/raw/Sub1/HS1-B<b>/raw.npz
    <root>/raw/annotations/subject_1/B<b>.TextGrid

The files are byte-equal to those of ``scripts/generate_synthetic_data.py``
with the same arguments (both packages draw the same numbers).

Usage:
    python scripts/generate_synthetic_data_torch.py [root=data] [--channels N]
        [--blocks N] [--trials N] [--ecog-sf HZ]

Then run the pipeline:
    python -m decode_tonal_langauge_tpu_torch configs/example_config.yaml [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from decode_tonal_langauge_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticSpec,
    write_subject,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("root", nargs="?", default="data")
    parser.add_argument("--subject", type=int, default=1)
    parser.add_argument("--channels", type=int, default=16)
    parser.add_argument("--blocks", type=int, default=2)
    parser.add_argument("--trials", type=int, default=48)
    parser.add_argument("--ecog-sf", type=float, default=400.0)
    parser.add_argument("--audio-sf", type=float, default=800.0)
    args = parser.parse_args(argv)

    spec = SyntheticSpec(
        n_channels=args.channels,
        n_blocks=args.blocks,
        trials_per_block=args.trials,
        ecog_sf=args.ecog_sf,
        audio_sf=args.audio_sf,
        active_channels=tuple(range(min(12, args.channels))),
        tone_channels=(0, 1, 2, 3),
        syllable_channels=(4, 5, 6, 7),
    )
    raw_root = os.path.join(args.root, "raw")
    blocks = write_subject(raw_root, args.subject, spec)
    n_trials = sum(len(b.events) for b in blocks.values())
    print(
        f"wrote subject {args.subject}: {len(blocks)} blocks, "
        f"{n_trials} trials, {args.channels} channels -> {raw_root}"
    )


if __name__ == "__main__":
    main()
