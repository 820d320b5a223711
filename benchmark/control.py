"""The control of a cell's comparison: the plain reference put in the
port's place, in the next precision below the configuration's, read by
the same numbers and limits as a run. It must come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--mode tf32|f32|half_batch]

``tf32``: float32 with every product's operands rounded to TF32 (the
configurations state float32 with TF32 off); ``f32``: float32 itself, a
stand-in that should pass; ``half_batch`` (fits): float32 stepping only
the first half of each batch. One JSON line a seed: the numbers, each
beside its limit, and ``correct``. The benchmark's own runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="tf32", choices=("tf32", "f32", "half_batch"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    from benchmark.harness import cells, compare
    from benchmark.harness import device as dev

    dev.set_cache_dirs(CHECKOUT)
    import torch

    from benchmark.run import Context

    bench = cells.benchmark()
    cell = cells.cell(args.workload, bench)
    cfg, mix = cells.config(cell["config"]), cells.mix(cell["traffic"])
    driver = cells.module("traffic", mix["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Context(args.workload, cfg, mix, seed, torch.device("cuda"), sys.stderr)
        ctx.seconds = bench["run_seconds"]  # a run's length sets how many windows it judges
        found = compare.checks(driver.control(ctx, args.mode), cells.limits(args.workload))
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "correct": all(c.ok for c in found), "seconds": time.perf_counter() - t0,
                          "checks": {c.name: {"value": c.value, "limit": c.limit}
                                     for c in found}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
