"""BENCHMARK.json against the shape its readers expect, every file it names, and
a cell, a configuration, a mix and a per-layer metric added as new files
alone; so too an architecture with a traffic driver of its own."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
from benchmark import run
from benchmark.harness import cells
from tiny import FIT_LIMITS
from tiny import config as tiny_config
from tiny import mix as tiny_mix

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_names_and_files():
    bench = cells.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"] == f"benchmark/configs/{c['name']}.json"
        assert cells.config(c["name"])["reduced"] == c["reduced"] == []
        names.add(c["name"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert cells.limits(w["name"])
        mix = cells.mix(w["traffic"])
        assert (ROOT / "benchmark" / "traffic" / f"{mix['driver']}.py").exists()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert (ROOT / "benchmark" / "layer_metrics" / f"{m['name']}.py").exists()
    for w in bench["workloads"]:  # every cell: set-up, another end-to-end and a per-layer metric
        got = {m["name"] for m in cells.end_to_end(bench, w["name"])}
        assert "setup_s" in got and len(got) >= 2 and cells.per_layer(bench, w["name"])


def test_a_new_cell_config_mix_and_metric_are_new_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a cell's
    limits and a per-layer metric as new files, and entries in
    BENCHMARK.json; no existing file under the benchmark changes, and the
    new cell runs with the new metric."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = cells.benchmark()
    cfg = tiny_config("liu2023_cnnrnn_tone")
    cfg["name"] = "tiny_cnnrnn"
    (tmp_path / "benchmark" / "configs" / "tiny_cnnrnn.json").write_text(json.dumps(cfg))
    mix = dict(tiny_mix("fit_s4_b32"), seeds=3)
    (tmp_path / "benchmark" / "traffic" / "fit_s3_b4.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark" / "limits" / "tiny_fit.s3_b4.json").write_text(
        json.dumps(FIT_LIMITS))
    (tmp_path / "benchmark" / "layer_metrics" / "steps_in_window.train.py").write_text(
        "def read(m):\n    return m.window['attempted']\n")
    bench["configs"].append({"name": "tiny_cnnrnn", "source": "https://example.org",
                             "file": "benchmark/configs/tiny_cnnrnn.json", "reduced": [],
                             "why": "a test's"})
    bench["workloads"].append({"name": "tiny_fit.s3_b4", "config": "tiny_cnnrnn",
                               "traffic": "fit_s3_b4", "chips": 1, "why": "a test's"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_trials_per_s":
            m["workloads"].append("tiny_fit.s3_b4")
    bench["per_layer"].append({"name": "steps_in_window.train", "unit": "steps",
                               "better": "higher", "source": "host_clock", "layer": "trainer",
                               "moves": "train_trials_per_s", "workloads": ["tiny_fit.s3_b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p: p.read_bytes() for p in before}
    assert after == before

    code = f"""
import json, sys  # the copy first, the port from the checkout
sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]
from benchmark import run
res = run.run_cell("tiny_fit.s3_b4", 7, 0.5, True, device="cpu")
print(json.dumps(res))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["steps_in_window.train"]["value"] >= 1


NEW_ARCH = Path(__file__).resolve().parent / "new_arch"


def test_a_new_architecture_and_driver_are_new_files_alone(tmp_path):
    """A copy of the benchmark gains an architecture it lacks and the port
    has (``ShallowNN``: a plain reference module of its own and the port
    build in its model entry), its configuration, a traffic driver of its
    own (``fit_shallow``, a copy of ``fit_single`` under another name),
    a mix, limits, small cuts, a flops file with its own layer list and a
    per-layer metric: the files under ``new_arch/`` (laid out as the
    benchmark's folder) and entries in BENCHMARK.json. No existing file
    of the copy changes. In the copy, in subprocesses, the new cell runs
    correct with its metrics, and the tests of ``test_bench_runs.py``,
    ``test_bench_faults.py`` and ``test_bench_control.py`` run for it and
    pass."""
    copy = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    new = [(copy / "traffic" / "fit_shallow.py", (copy / "traffic" / "fit_single.py").read_bytes())]
    new += [(copy / p.relative_to(NEW_ARCH), p.read_bytes())
            for p in NEW_ARCH.rglob("*") if p.is_file() and "__pycache__" not in p.parts]
    for path, data in new:
        assert not path.exists(), path
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    cell = "shallow_fit.s1_b8"
    bench = cells.benchmark()
    bench["configs"].append({"name": "shallow_tone", "source": "https://example.org",
                             "file": "benchmark/configs/shallow_tone.json", "reduced": [],
                             "why": "a test's"})
    bench["workloads"].append({"name": cell, "config": "shallow_tone",
                               "traffic": "fit_shallow_b8", "chips": 1, "why": "a test's"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_trials_per_s", "step_mfu.train"):
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "steps_in_window.train", "unit": "steps",
                               "better": "higher", "source": "host_clock", "layer": "trainer",
                               "moves": "train_trials_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert {p: p.read_bytes() for p in before} == before

    env = dict(os.environ, PYTHONPATH=str(ROOT))  # the port from the checkout
    code = ("import json, sys\nsys.path.insert(0, '.')\nfrom benchmark import run\n"
            f"print(json.dumps(run.run_cell({cell!r}, 2**31 + 5, 0.5, True, device='cpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["steps_in_window.train"]["value"] >= 1
    assert res["metrics"]["step_mfu.train"]["value"] > 0

    tests = [f"benchmark/tests/{f}" for f in ("test_bench_runs.py", "test_bench_faults.py",
                                               "test_bench_control.py")]
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          "-p", "no:randomly", "-k", cell, *tests], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    passed = re.search(r"(\d+) passed", out.stdout)
    # two runs and a seed's repeat, the state and half-batch faults, both controls
    assert passed and int(passed.group(1)) == 7, out.stdout[-2000:]


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "cnnrnn_fit.s4_b32", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
