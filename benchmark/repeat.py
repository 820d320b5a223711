"""Runs of one cell, one process each, as a check makes them, and their
spread.

    python3 benchmark/repeat.py --workload <cell> --seeds 11,12,13 --seconds <s> \
        [--trace 0|1] [--out runs.jsonl]

Each seed is one ``run.py`` process, one after the other. Every result
line goes to ``--out`` (with the seed, the exit code and the end of
standard error), and a summary prints each metric's median and its
spread: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) over the median.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(HERE / "run.py"), "--workload", args.workload, "--seed",
             str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)],
            capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        row = {"workload": args.workload, "seed": seed, "trace": args.trace, "rc": proc.returncode,
               "process_s": time.perf_counter() - t0, "stderr_tail": proc.stderr[-3000:]}
        try:
            row["result"] = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            row["result"] = None
        rows.append(row)
        res = row["result"] or {}
        summary = {k: v["value"] for k, v in res.get("metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": proc.returncode, "correct": res.get("correct"),
                          "process_s": round(row["process_s"], 2), "metrics": summary,
                          "checks": {k: v["value"] for k, v in res.get("checks", {}).items()}}),
              flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    metrics = {}
    for row in rows:
        for k, v in ((row["result"] or {}).get("metrics") or {}).items():
            metrics.setdefault(k, []).append(v["value"])
    for k, vals in metrics.items():
        print(f"{args.workload} {k}: n {len(vals)} median {statistics.median(vals)!r} "
              f"spread {spread(vals)!r} values {vals}", flush=True)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
