"""The rate a streaming cell sustains: its traffic at several hops, one
process, to set the cell's fixed rate below the highest one sustained.

    python3 benchmark/sweep.py --workload synthfull_stream.realtime --hops 40,48,60,80 \
        --seconds 20 --seed 1

For each hop (samples between windows; the rate is sample_rate_hz / hop)
one JSON line: the rate, the latency's median, 95th percentile and
maximum, and how late the generator ran at the start and at the end of
the window (a backlog that grows means the rate is not sustained).
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--hops", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    from benchmark.harness import cells
    from benchmark.harness import device as dev

    dev.set_cache_dirs(CHECKOUT)
    import torch

    from benchmark.run import Context

    cell = cells.cell(args.workload, cells.benchmark())
    cfg, base = cells.config(cell["config"]), cells.mix(cell["traffic"])
    driver = cells.module("traffic", base["driver"])
    for hop in (int(h) for h in args.hops.split(",")):
        mix = dict(base, hop=hop)
        ctx = Context(args.workload, cfg, mix, args.seed, torch.device("cuda"), sys.stderr)
        ctx.seconds = args.seconds
        st = driver.setup(ctx)
        latency, lateness, _, _ = driver.run_windows(ctx, st, st.n, keep=False)
        tenth = max(1, len(lateness) // 10)
        print(json.dumps({"hop": hop, "rate_per_s": mix["sample_rate_hz"] / hop,
                          "windows": len(latency),
                          "latency_ms": {q: float(np.percentile(latency, q) * 1e3)
                                         for q in (50, 95, 100)},
                          "late_ms_first_tenth": float(lateness[:tenth].mean() * 1e3),
                          "late_ms_last_tenth": float(lateness[-tenth:].mean() * 1e3)}),
              flush=True)
        del st
    return 0


if __name__ == "__main__":
    sys.exit(main())
