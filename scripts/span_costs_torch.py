"""What the port's layer spans (``runtime/profiling.span``) cost on the
card, and how much of each cell's work they cover.

    python3 scripts/span_costs_torch.py [--cells a,b,...] [--seed N] [--seconds S]
                                         [--out span_costs.json]

1. One span site's cost on the host: off (no profiler, no recording),
   inside a recording, and under a profiler with CPU activity.
2. The anchor: a span recorded under a profiler with CPU and CUDA activity
   against its own ``user_annotation``, through the recording's anchor
   (start and end, µs); and which events of a profiler with CUDA activity
   alone carry a span's name.
3. For each benchmark cell named (default: all of ``BENCHMARK.json``): set
   up as ``benchmark/run.py`` does; run the window with the spans off, then
   inside ``recording()`` (the end-to-end metric both times, and the
   recording's count, total and self time by span); then the cell's traced
   units four times after one discarded capture, with the port's
   annotations off, on, on and off (they are switched off here; each
   unit's host-clock length), and split the launches of the last unit
   traced with the host's ops and the annotations on by their innermost
   port span.

Needs a CUDA card. Writes one JSON object to ``--out`` and prints it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def span_site_ns(n: int = 200_000):
    """ns a ``with span(...)`` block takes in each state."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from decode_tonal_langauge_tpu_torch.runtime.profiling import recording, span

    def loop(k):
        t0 = time.perf_counter_ns()
        for _ in range(k):
            with span("optim.nadam"):
                pass
        return (time.perf_counter_ns() - t0) / k

    out = {"off": loop(n)}
    with recording():
        out["recording"] = loop(n // 10)
    with profile(activities=[ProfilerActivity.CPU]):
        out["profiler_cpu"] = loop(n // 100)
    with profile(activities=[ProfilerActivity.CUDA]):
        out["profiler_cuda_only"] = loop(n // 100)
    torch.cuda.synchronize()
    return out


def anchor_check(tmp: Path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from decode_tonal_langauge_tpu_torch.runtime.profiling import recording, span

    x = torch.randn(4096, 4096, device="cuda")
    out = {}
    for label, acts in (("cpu_cuda", [ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                        ("cuda_only", [ProfilerActivity.CUDA])):
        with profile(activities=acts) as prof, recording() as rec:
            for _ in range(3):
                with span("audio.griffinlim"):
                    y = x @ x
                    torch.cuda.synchronize()
                time.sleep(0.01)
        path = tmp / f"anchor_{label}.json"
        prof.export_chrome_trace(str(path))
        raw = json.loads(path.read_text())
        path.unlink()
        events = [e for e in raw["traceEvents"] if e.get("name") == "audio.griffinlim"]
        row = {"categories": sorted(Counter(e.get("cat") for e in events).items()),
               "base_time_ns": raw.get("baseTimeNanoseconds")}
        notes = [e for e in events if e.get("cat") == "user_annotation"]
        if notes and row["base_time_ns"] is not None:
            base = raw["baseTimeNanoseconds"]
            row["start_gap_us"] = [rec.trace_us(s.start_ns, base) - e["ts"]
                                   for s, e in zip(rec.spans, notes)]
            row["end_gap_us"] = [rec.trace_us(s.end_ns, base) - (e["ts"] + e["dur"])
                                 for s, e in zip(rec.spans, notes)]
        out[label] = row
    del y
    return out


def cell_costs(name: str, seed: int, seconds: float, log, device: str = "cuda"):
    import gc

    import torch

    from benchmark.harness import cells, spans
    from benchmark.harness import trace as tracing
    from benchmark.run import Context
    from decode_tonal_langauge_tpu_torch.runtime import profiling

    bench = cells.benchmark()
    cell = cells.cell(name, bench)
    cfg, mix = cells.config(cell["config"]), cells.mix(cell["traffic"])
    traffic = cells.module("traffic", mix["driver"])
    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ctx = Context(name, cfg, mix, seed, device, log)
    ctx.seconds = seconds
    t0 = time.perf_counter()
    st = traffic.setup(ctx)
    sync()
    out = {"setup_s": time.perf_counter() - t0}

    off = traffic.window(ctx, st, seconds)
    with profiling.recording() as rec:
        on = traffic.window(ctx, st, seconds)
    out["window_off"], out["window_recorded"] = off["metrics"], on["metrics"]
    out["recorded_by_span"] = rec.by_name()
    out["recorded_units"] = on["attempted"]

    def traced(annotated: bool):
        real = profiling._profiler_enabled
        if not annotated:
            profiling._profiler_enabled = lambda: False  # the port's annotations off
        try:
            traces = tracing.capture(lambda profile: traffic.traced(ctx, st, profile), device)
        finally:
            profiling._profiler_enabled = real
        gc.collect()  # the profiler's retained memory (tens of GB a fit step with shapes)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return traces["main"], traces["detail"]

    traced(True)  # the first capture grows the allocator's pool: not compared
    unit_s, launches = {}, {}
    for annotated in (False, True, True, False):
        main, detail = traced(annotated)
        key = "annotated" if annotated else "plain"
        unit_s.setdefault("main_" + key, []).append(main.window_s / main.units)
        unit_s.setdefault("detail_" + key, []).append(detail.window_s)
        launches.setdefault("main_" + key, []).append(len(main.device) / main.units)
        launches.setdefault("detail_" + key, []).append(len(detail.device))
        if annotated:
            annotated_detail = detail
    out["unit_s"], out["launches_per_unit"] = unit_s, launches
    detail = annotated_detail
    s = spans.Spans(detail)
    owners = Counter(s.owner_name(k) for k in range(len(detail.device)))
    device_ms = Counter()
    for k, e in enumerate(detail.device):
        device_ms[s.owner_name(k)] += e["dur"] / 1e3
    out["detail_by_owner"] = {str(k): {"launches": v, "device_ms": device_ms[k]}
                              for k, v in owners.most_common()}
    out["detail_under"] = {
        key: {"launches": len(s.under(keep)),
              "device_ms": sum(e["dur"] for e in s.under(keep)) / 1e3}
        for key, keep in (("lstm.*", lambda n: n.startswith("lstm.")),
                          ("optim.nadam", lambda n: n == "optim.nadam"),
                          ("audio.nnls", lambda n: n == "audio.nnls"),
                          ("audio.griffinlim", lambda n: n == "audio.griffinlim"),
                          ("decoder.decode", lambda n: n == "decoder.decode"),
                          ("audio.mels_to_audio", lambda n: n == "audio.mels_to_audio"))}
    traffic.release(ctx, st)
    del st
    gc.collect()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cells", default=None)
    parser.add_argument("--seed", type=int, default=4100000001)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--out", default="span_costs.json")
    args = parser.parse_args(argv)

    from benchmark.harness import device as dev

    dev.set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from benchmark.harness import cells

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    info = dev.card(0)
    result = {"card": info, "torch": torch.__version__, "cuda": torch.version.cuda,
              "span_site_ns": span_site_ns(), "anchor": anchor_check(out_path.parent)}
    names = (args.cells.split(",") if args.cells
             else [c["name"] for c in cells.benchmark()["workloads"]])
    result["cells"] = {}
    for i, name in enumerate(names):
        result["cells"][name] = cell_costs(name, args.seed + i, args.seconds, sys.stderr)
        out_path.write_text(json.dumps(result, indent=1))
        torch.cuda.empty_cache()
    out_path.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
