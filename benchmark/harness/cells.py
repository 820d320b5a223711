"""A cell's files, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; the rest sits in files of their own under this folder:

- ``configs/<config>.json``: the configuration as it is run; each model
  entry names its plain reference module (``"reference"``) and how the
  port builds it (``"port"``, read by ``harness/program.py``);
- ``traffic/<mix>.json``: a traffic mix's parameters, with the name of
  the driver that reads them (``traffic/<driver>.py``);
- ``limits/<cell>.json``: the limit of each number compared;
- ``flops/<module>.py``: the configuration's FLOP and byte counts (its
  own layer list, on ``harness/flopcount.py``'s rules);
- ``layer_metrics/<metric>.py``: one reader per per-layer metric;
- ``tests/cuts/configs/<config>.json``, ``tests/cuts/traffic/<mix>.json``:
  the small cuts the CPU tests run them at (``tests/tiny.py``).

A new cell, configuration, mix, driver or metric is new files and new
entries; no file here names them. A new architecture brings its
reference module (``reference/<module>.py``: ``param_spec``,
``forward``, ``dropout_shapes``), the ``port`` entry of its model, and its
configuration's small cut. A new driver gives ``setup``, ``window``,
``traced``, ``release``, ``judge`` and ``control``, and declares the
faults its cells can have (``FAULTS``; for a fit also ``TRAINERS``, the
port's classes whose ``train_step`` the half-batch fault cuts, and
``BATCH_AXIS``), which ``tests/test_bench_faults.py`` breaks underneath.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]  # the benchmark's folder
CHECKOUT = ROOT.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(checkout: Optional[Path] = None) -> Dict:
    return _json((checkout or CHECKOUT) / "BENCHMARK.json")


def cell(name: str, bench: Dict) -> Dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no cell named {name!r} in BENCHMARK.json")


def config(name: str) -> Dict:
    return _json(ROOT / "configs" / f"{name}.json")


def mix(name: str) -> Dict:
    return _json(ROOT / "traffic" / f"{name}.json")


def limits(cell_name: str) -> Dict[str, float]:
    return _json(ROOT / "limits" / f"{cell_name}.json")


def module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` under this folder, imported from its file."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"_bench_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"{path} does not exist")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_cell(metric: Dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: Dict, cell_name: str) -> List[Dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"] if _in_cell(m, cell_name)]


def per_layer(bench: Dict, cell_name: str) -> List[Dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    moved = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
