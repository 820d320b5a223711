"""What the benchmark loads: nothing of JAX or the JAX package, and a
reference that loads nothing of the port.

Top-level module names are compared whole, so the port
(``decode_tonal_langauge_tpu_torch``) is not taken for the JAX package
(``decode_tonal_langauge_tpu``)."""

import json
import subprocess
import sys

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

FORBIDDEN = {"jax", "jaxlib", "flax", "decode_tonal_langauge_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_every_file_it_runs_load_no_jax():
    code = """
import sys
sys.path.insert(0, '.')
from benchmark import run
from benchmark.harness import cells, decode_check, program, trace
import importlib
bench = cells.benchmark()
for mix in {c["traffic"] for c in bench["workloads"]}:
    driver = cells.module("traffic", cells.mix(mix)["driver"])
    for path in getattr(driver, "TRAINERS", ()):  # what the drivers drive
        importlib.import_module(path.rpartition(".")[0])
for cfg in bench["configs"]:
    cells.module("flops", cells.config(cfg["name"])["flops"])
    for m in cells.config(cfg["name"])["models"].values():
        program.build(m, "meta")
for m in bench["per_layer"]:
    cells.module("layer_metrics", m["name"])
import decode_tonal_langauge_tpu_torch.serving
"""
    loaded = _loaded(code)
    assert "decode_tonal_langauge_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    modules = sorted(p.stem for p in (ROOT / "benchmark" / "reference").glob("*.py")
                     if p.stem != "__init__")
    assert {"decode", "train", "cnnrnn"} <= set(modules)
    loaded = _loaded("import sys\nsys.path.insert(0, '.')\n"
                     f"from benchmark.reference import {', '.join(modules)}")
    assert not loaded & (FORBIDDEN | {"decode_tonal_langauge_tpu_torch"})


def test_the_guard_finds_a_loaded_jax(monkeypatch):
    from types import ModuleType

    from benchmark.harness import device

    assert device.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", ModuleType("jax.numpy"))
    assert device.forbidden_modules() == ["jax"]
