"""Minimal Praat TextGrid reader/writer (no third-party dependency).

A copy of ``decode_tonal_langauge_tpu/data/textgrid.py``: the subset of
the format the pipeline needs, long-form ``ooTextFile`` TextGrids with
``IntervalTier`` tiers (other tiers are skipped), and a writer for
synthetic subjects.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List


@dataclass
class Interval:
    minTime: float
    maxTime: float
    mark: str


@dataclass
class IntervalTier:
    name: str
    minTime: float
    maxTime: float
    intervals: List[Interval] = field(default_factory=list)


@dataclass
class TextGrid:
    minTime: float
    maxTime: float
    tiers: List[IntervalTier] = field(default_factory=list)

    @classmethod
    def from_file(cls, path: str) -> "TextGrid":
        with open(path, "r", encoding="utf-8") as f:
            return parse_textgrid(f.read())

    # Alias matching the textgrid package's classmethod name.
    fromFile = from_file


_NUM_RE = re.compile(r"=\s*([-+0-9.eE]+)")
_STR_RE = re.compile(r"=\s*\"(.*)\"\s*$")


def _num(line: str) -> float:
    m = _NUM_RE.search(line)
    if not m:
        raise ValueError(f"Expected a number in TextGrid line: {line!r}")
    return float(m.group(1))


def _string(line: str) -> str:
    m = _STR_RE.search(line)
    if not m:
        raise ValueError(f"Expected a quoted string in TextGrid line: {line!r}")
    return m.group(1)


def parse_textgrid(text: str) -> TextGrid:
    """Parse long-form TextGrid text into a :class:`TextGrid`."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not any("ooTextFile" in ln for ln in lines[:3]):
        raise ValueError("Not an ooTextFile TextGrid.")

    def find(prefix: str, start: int) -> int:
        for j in range(start, len(lines)):
            if lines[j].startswith(prefix):
                return j
        raise ValueError(f"TextGrid parse error: missing {prefix!r}")

    i = find("xmin", 0)
    g_min = _num(lines[i])
    i = find("xmax", i + 1)
    g_max = _num(lines[i])

    grid = TextGrid(minTime=g_min, maxTime=g_max)

    j = 0
    while True:
        try:
            j = find("class", j)
        except ValueError:
            break
        tier_class = _string(lines[j])
        j_name = find("name", j + 1)
        name = _string(lines[j_name])
        j_min = find("xmin", j_name + 1)
        t_min = _num(lines[j_min])
        j_max = find("xmax", j_min + 1)
        t_max = _num(lines[j_max])

        if tier_class != "IntervalTier":
            # Skip point tiers etc.: advance past this tier's content.
            j = j_max + 1
            continue

        j_size = find("intervals: size", j_max + 1)
        size = int(_num(lines[j_size]))

        tier = IntervalTier(name=name, minTime=t_min, maxTime=t_max)
        k = j_size + 1
        for _ in range(size):
            k_min = find("xmin", k)
            imin = _num(lines[k_min])
            k_max = find("xmax", k_min + 1)
            imax = _num(lines[k_max])
            k_text = find("text", k_max + 1)
            mark = _string(lines[k_text])
            tier.intervals.append(Interval(imin, imax, mark))
            k = k_text + 1

        grid.tiers.append(tier)
        j = k

    return grid


def write_textgrid(grid: TextGrid, path: str) -> None:
    """Write a long-form TextGrid file."""
    out = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        f"xmin = {grid.minTime} ",
        f"xmax = {grid.maxTime} ",
        "tiers? <exists> ",
        f"size = {len(grid.tiers)} ",
        "item []: ",
    ]
    for ti, tier in enumerate(grid.tiers, start=1):
        out += [
            f"    item [{ti}]:",
            '        class = "IntervalTier" ',
            f'        name = "{tier.name}" ',
            f"        xmin = {tier.minTime} ",
            f"        xmax = {tier.maxTime} ",
            f"        intervals: size = {len(tier.intervals)} ",
        ]
        for ii, iv in enumerate(tier.intervals, start=1):
            out += [
                f"        intervals [{ii}]:",
                f"            xmin = {iv.minTime} ",
                f"            xmax = {iv.maxTime} ",
                f'            text = "{iv.mark}" ',
            ]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(out) + "\n")
