"""Run cells several times, each run a process of its own as a check runs
it, and summarize the spread of each metric.

    python3 -m benchmark.tools.runs --workload <cell> --seeds 11,12,13 \
        --seconds 10 [--trace 0] [--sets 2] [--out chiprun_out/x.jsonl]

Runs go in order: each set runs every seed once.  Each run's result line
(or its exit code and the end of its standard error) is appended to
``--out`` as JSON, and a table goes to standard output: for each metric
the median and the spread, the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) over the median, for
each set.  ``--summarize FILE`` prints the table of a file written
before.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def one(cell: str, seed: int, seconds: float, trace: int):
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        cell, "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True)
    wall = time.perf_counter() - t0
    line = None
    if p.returncode == 0 and p.stdout.strip():
        try:
            line = json.loads(p.stdout.strip().splitlines()[-1])
        except json.JSONDecodeError:
            line = None
    return {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace,
            "rc": p.returncode, "wall_s": wall, "result": line,
            "stdout_tail": p.stdout[-3000:], "stderr_tail": p.stderr[-4000:]}


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def table(rows) -> str:
    by = defaultdict(lambda: defaultdict(list))
    for r in rows:
        res = r.get("result")
        if not res:
            continue
        key = (r["cell"], r["trace"], r.get("set", 0))
        for name, m in res["metrics"].items():
            by[key][name].append(m["value"])
        by[key]["_correct"].append(1.0 if res["correct"] else 0.0)
        by[key]["_memory_gb"].append(res["device"]["memory_peak_bytes"] / 1e9)
        if "busy_s" in res["device"]:
            by[key]["_busy_share"].append(res["device"]["busy_s"]
                                          / res["device"]["window_s"])
        for name, c in res.get("checks", {}).items():
            by[key]["check." + name].append(c["value"])
        by[key]["_wall_s"].append(r["wall_s"])
    out = []
    for key in sorted(by):
        out.append(f"== {key[0]} trace={key[1]} set={key[2]}")
        for name, vals in by[key].items():
            sp = spread(vals)
            out.append(f"  {name:42s} n={len(vals):2d} median="
                       f"{statistics.median(vals):.6g} min={min(vals):.6g} "
                       f"max={max(vals):.6g} spread="
                       f"{'-' if sp is None else f'{sp:.4%}'}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", default=[])
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--summarize", default=None)
    args = ap.parse_args(argv)
    if args.summarize:
        rows = [json.loads(x) for x in Path(args.summarize).read_text()
                .splitlines() if x.strip()]
        print(table(rows))
        return 0
    seeds = [int(s) for s in args.seeds.split(",") if s]
    out = Path(args.out) if args.out else None
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for cell in args.workload:
        for k in range(args.sets):
            for seed in seeds:
                r = one(cell, seed, args.seconds, args.trace)
                r["set"] = k
                rows.append(r)
                res = r["result"]
                brief = ({n: m["value"] for n, m in res["metrics"].items()}
                         if res else None)
                print(f"{cell} set {k} seed {seed}: rc {r['rc']} wall "
                      f"{r['wall_s']:.1f} s correct "
                      f"{res and res['correct']} {brief}", flush=True)
                if res is None:
                    print(r["stderr_tail"][-2500:], flush=True)
                if out:
                    with out.open("a") as f:
                        f.write(json.dumps(r) + "\n")
    print(table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
