"""Every cell's run at small sizes on the CPU: each traffic driver
against the reference, and the keys of the result line."""

import json

import pytest

from benchmark import run
from benchmark.harness import cells
from tiny import config, limits, mix

BENCH = cells.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny_run(name, seed, trace=False, seconds=0.5):
    cell = cells.cell(name, BENCH)
    return run.run_cell(name, seed, seconds, trace, device="cpu", cfg=config(cell["config"]),
                        mix=mix(cell["traffic"]), limits=limits(name))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_with_its_metrics(name, trace):
    res = tiny_run(name, 2**31 + 97, trace)
    json.dumps(res)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and ("breakdown" in keys) == trace
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    if trace:
        declared = {m["name"] for m in cells.per_layer(BENCH, name)}
        assert set(res["metrics"]) <= declared
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {m["name"] for m in cells.end_to_end(BENCH, name)}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name):
    """Two runs of a seed compare the same numbers alike: the inputs,
    weights and sampled windows come from the seed alone."""
    a, b = tiny_run(name, 5), tiny_run(name, 5)
    for key in ("loss_gap", "prob_gap"):
        if key in a["checks"]:
            assert a["checks"][key]["value"] == pytest.approx(b["checks"][key]["value"], rel=1e-3)
