"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``: a configuration
(``configs/<config>.json``, whose model entries name their plain
reference module and how the port builds them) under a traffic mix
(``traffic/<mix>.json``, read by the driver it names,
``traffic/<driver>.py``). Nothing here names a cell, an architecture or
a driver: a new one is new files (``harness/cells.py`` lists them: for an
architecture its reference module, the ``port`` entry of its model, its
small cuts; for a driver its faults declaration) and new entries. A run:

1. sets up the port as its users do, from seeded inputs and weights, and
   warms up every shape the mix uses (``setup_s`` is the time from the
   process's start to here);
2. measures for ``--seconds`` (the cell's end-to-end metrics);
3. with ``--trace 1``, profiles a short window of the same traffic and
   reads the cell's per-layer metrics from it (``layer_metrics/``);
4. reads the peak device memory, frees the port's state and compares
   what the timed path produced with the plain reference
   (``reference/``), each number against its limit (``limits/<cell>.json``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (end-to-end with ``--trace 0``,
per-layer with ``--trace 1``), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared beside its
limit; the same numbers are the last lines of standard error. Without a
CUDA card, with fewer than the cell asks for, or with JAX loaded, it
prints no result and exits with another code than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, Optional  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


class Context:
    """What a traffic driver is given: the cell's configuration and mix,
    the seed, the device, a log stream, and host-clock spans."""

    def __init__(self, name: str, cfg: Dict, mix: Dict, seed: int, device, log) -> None:
        self.name, self.cfg, self.mix, self.seed = name, cfg, mix, seed
        self.device, self.log = device, log
        self.spans = defaultdict(list)
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name: str):
        """Seconds of the block on the host clock, appended to
        ``spans[name]``; while tracing, also a ``bench.<name>`` annotation."""
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with (record_function(f"bench.{name}") if self.tracing else contextlib.nullcontext()):
            yield
        self.spans[name].append(time.perf_counter() - t0)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench: Optional[Dict] = None, cfg: Optional[Dict] = None, mix: Optional[Dict] = None,
             limits: Optional[Dict] = None, log=sys.stderr, t_start: Optional[float] = None
             ) -> Dict:
    """One run of cell ``name``; returns the result line's object. ``cfg``,
    ``mix`` and ``limits`` replace the cell's files where given (the tests'
    small sizes)."""
    import torch

    from benchmark.harness import cells, compare, peaks
    from benchmark.harness import device as dev
    from benchmark.harness import trace as tracing

    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or cells.benchmark()
    cell = cells.cell(name, bench)
    cfg = cfg or cells.config(cell["config"])
    mix = mix or cells.mix(cell["traffic"])
    limits = limits or cells.limits(name)
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    driver = cells.module("traffic", mix["driver"])
    ctx = Context(name, cfg, mix, seed, device, log)
    ctx.seconds = seconds

    state = driver.setup(ctx)
    sync()
    setup_s = time.perf_counter() - t_start
    print(f"set-up: {setup_s:.4f} s", file=log)
    ctx.spans.clear()
    win = driver.window(ctx, state, seconds)
    spans = {k: list(v) for k, v in ctx.spans.items()}
    # the peak of set-up and the window, before the profiler holds anything
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    traced = None
    if trace:
        ctx.spans.clear()
        ctx.tracing = True
        traces = tracing.capture(lambda profile: driver.traced(ctx, state, profile), device)
        traced = traces["main"]
        ctx.tracing = False
    readings = driver.release(ctx, state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    found = compare.checks(driver.judge(ctx, readings), limits)

    info = dev.card(device.index or 0) if cuda else {"kind": "cpu"}
    result = {"correct": all(c.ok for c in found) and win["failed"] == 0,
              "attempted": int(win["attempted"]), "failed": int(win["failed"])}
    if trace:
        flops = cells.module("flops", cfg["flops"])
        mctx = SimpleNamespace(trace=traced, detail_trace=traces.get("detail"), window=win,
                               spans=spans, cfg=cfg, mix=mix, flops=flops, peaks=peaks,
                               power_limit_w=info.get("power_limit_w"))
        metrics = {}
        for m in cells.per_layer(bench, name):
            value = cells.module("layer_metrics", m["name"]).read(mctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        measured = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(measured[m["name"]]), "unit": m["unit"]}
                   for m in cells.end_to_end(bench, name)}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if cuda else "cpu", "kind": info["kind"], "count": 1,
                        "memory_peak_bytes": peak}
    if "power_limit_w" in info:
        result["device"]["power_limit_w"] = info["power_limit_w"]
    if trace:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.breakdown()["device_ops"],
                               "idle_gaps": traces.get("detail", traced).breakdown()["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in found}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    from benchmark.harness import cells
    from benchmark.harness import device as dev

    dev.set_cache_dirs(CHECKOUT)
    import torch

    chips = cells.cell(args.workload, cells.benchmark())["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    loaded = dev.forbidden_modules()
    if loaded:
        print(f"no result: the run loaded {loaded}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
