"""The control: the reference in the next precision below the
configuration's (float32 with TF32-rounded products, for float32 with
TF32 off) put in the port's place must come out not correct; for the
cells whose driver declares the half-batch fault (``FAULTS``), so must
the reference stepping half of each batch. Here at small
sizes on the CPU; on the card at the cells' own sizes with
``python3 benchmark/control.py --workload <cell> --seeds ... --mode tf32``."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.harness import cells, compare
from tiny import config, limits, mix

ROOT = Path(__file__).resolve().parents[2]
BENCH = cells.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def control(name, mode, seed=3):
    cell = cells.cell(name, BENCH)
    m = mix(cell["traffic"])
    ctx = run.Context(name, config(cell["config"]), m, seed, torch.device("cpu"), sys.stderr)
    ctx.seconds = 1.0
    return compare.checks(cells.module("traffic", m["driver"]).control(ctx, mode), limits(name))


@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_is_not_correct(name):
    assert not all(c.ok for c in control(name, "tf32"))


@pytest.mark.parametrize("name", [n for n in CELLS if "half_batch" in cells.module(
    "traffic", cells.mix(cells.cell(n, BENCH)["traffic"])["driver"]).FAULTS])
def test_half_batch_fault_is_not_correct(name):
    assert not all(c.ok for c in control(name, "half_batch"))


@pytest.mark.cuda
def test_control_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload",
                          "synthfull_stream.realtime", "--seeds", "1", "--mode", "tf32"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": false' in out.stdout
