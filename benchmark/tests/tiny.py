"""Small sizes of the benchmark's configurations and mixes, for the CPU
tests: the same architectures and traffic, cut in length, channels,
trials, seeds and mel size so that a run takes seconds on one CPU.

Each configuration's cut is ``cuts/configs/<config>.json`` and each
mix's ``cuts/traffic/<mix>.json`` beside this file, merged into the
configuration or mix: an object key by key, any other value replaced.
A configuration or mix without a cut fails and names the file to add."""

import copy
import json
from pathlib import Path

from benchmark.harness import cells

CUTS = Path(__file__).resolve().parent / "cuts"


def _merged(base, cut):
    if not isinstance(base, dict) or not isinstance(cut, dict):
        return copy.deepcopy(cut)
    out = copy.deepcopy(base)
    for k, v in cut.items():
        out[k] = _merged(out[k], v) if k in out else copy.deepcopy(v)
    return out


def _cut(kind: str, name: str, full):
    path = CUTS / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no small cut for {name!r}: add {path}")
    with open(path) as f:
        return _merged(full, json.load(f))


def config(name: str):
    return _cut("configs", name, cells.config(name))


def mix(name: str):
    return _cut("traffic", name, cells.mix(name))


# At these sizes a fit's float32 gaps read otherwise than at the cells'
# (on the CPU: the CNN-RNN's first-gradient gap 1.4e-4 to 1.7e-4 over
# four seeds, against a median of 1.5e-5 at its published widths on the card), so
# the fits are held to limits read here: above four seeds of the port and
# below the TF32 control (first loss 8.3e-7 and 9.3e-6, first gradient
# 1.1e-3 and 8.5e-3). The decode cells keep their own limits.
FIT_LIMITS = {"loss_gap_first": 3e-7, "loss_gap_later": 1e-3, "grad_norm_gap": 5e-4,
              "change_norm_gap": 1e-2}


# A median leaf's gap lies at or below the worst leaf's: a fit that reads
# it is held to the worst leaf's limit here.
MEDIAN_OF = {"grad_norm_gap_median": "grad_norm_gap"}


def limits(cell_name: str):
    own = cells.limits(cell_name)
    if set(FIT_LIMITS) <= set(own) <= set(FIT_LIMITS) | set(MEDIAN_OF):
        return {k: FIT_LIMITS[MEDIAN_OF.get(k, k)] for k in own}
    return own
