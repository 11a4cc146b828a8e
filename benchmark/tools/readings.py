"""The readings a cell's limits are set from, in one process on the card:

- the program's numbers over ``--seeds`` (sound runs: the lower reading);
- the control's over ``--control-seeds``: the plain reference computed
  one precision below the configuration's bfloat16 (float8 e4m3
  products, ``reference/transformer.mm_fp8``) in the program's place;
- each fault of ``tools/faults.py`` the cell can have, planted in the
  program, over ``--fault-seeds`` (by default the control's).

    python3 -m benchmark.tools.readings --workload <cell> \
        --seeds 1,2,...,12 --control-seeds 1,2,3 [--seconds 6] \
        [--out chiprun_out/readings.jsonl]

Training cells need no window: each seed builds its weights and
batches, takes the program's first three steps and the reference's, and
compares; each row also gives the first gradient's norm by leaf, the
program's (or the control's) beside the reference's (``norms``).  With
``--vary-schedule`` each seed also draws its own schedule of sizes
(``schedule_seed``), so a BERT batch's count of predicted positions
moves from seed to seed; each row gives that count (``count``, the
first step's).  Serving cells serve ``--seconds`` of the cell's own
traffic on one engine (``rebind_params`` swaps each seed's weights in,
with no new capture) and compare a sample as a run does (``gap`` over
its greedy requests, ``gap_sampled`` over its sampled ones); the
control judges the same positions by the token its own forward puts
first under the same noise.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _ctx(cell, seed, seconds, torch, device, overrides=None):
    from benchmark.harness import core
    from benchmark.harness.trace import Tracer
    return core.Context(cell, seed, seconds, False, device, torch,
                        Tracer(False, torch), lambda t: 0.0, overrides)


def _numbers(got):
    out = {k: v["value"] for k, v in got.items() if not k.startswith("_")}
    out.update({f"{k}_leaf": v["leaf"] for k, v in got.items()
                if not k.startswith("_") and "leaf" in v})
    return out


def _grad_norms(check, got, refr):
    """The first gradient's norm by leaf, the program's (or the
    control's) beside the reference's."""
    g, r = check._norms(got["grads"]), check._norms(refr["grads"])
    return {n: [g[n], r[n]] for n in r}


def train_readings(cell, seeds, control_seeds, torch, device, emit,
                   overrides=None, vary=False, fault_seeds=None):
    from benchmark.check import train as check
    from benchmark.drivers.train import Trainer
    from benchmark.families import weights
    from benchmark.reference import transformer as ref
    from benchmark.tools import faults

    ctx = _ctx(cell, seeds[0], 0, torch, device, overrides)

    def schedule(seed):
        if vary:
            ctx.traffic["schedule_seed"] = seed

    def count(batches):
        return ctx.family.targets(batches[0])

    tr = Trainer(ctx)
    for seed in seeds:
        schedule(seed)
        state, prog, params0, batches = tr.first_steps(seed)
        del state
        p0 = dict(weights.flat_leaves(params0))
        refr = tr.reference(params0, batches)
        emit({"cell": cell, "kind": "program", "seed": seed,
              "count": count(batches),
              **_numbers(check.compare(prog, refr, p0)),
              "norms": _grad_norms(check, prog, refr)})
        if seed in control_seeds:
            low = tr.reference(params0, batches, mm=ref.mm_fp8)
            emit({"cell": cell, "kind": "control_fp8", "seed": seed,
                  "count": count(batches),
                  **_numbers(check.compare(low, refr, p0)),
                  "norms": _grad_norms(check, low, refr)})
        del prog, refr, batches, params0
        gc.collect()
    family = ctx.conf["family"]
    tr = None
    gc.collect()
    for name in faults.TRAIN_FAULTS:
        with faults.planted(name, family):
            ftr = Trainer(ctx)
            for seed in fault_seeds or control_seeds:
                schedule(seed)
                state, prog, params0, batches = ftr.first_steps(seed)
                del state
                refr = ftr.reference(params0, batches)
                emit({"cell": cell, "kind": f"fault_{name}", "seed": seed,
                      "count": count(batches), **_numbers(check.compare(
                          prog, refr, dict(weights.flat_leaves(params0))))})
                del prog, refr
                gc.collect()
        ftr = None
        gc.collect()


def serve_readings(cell, seeds, control_seeds, seconds, torch, device, emit,
                   overrides=None, fault_seeds=None):
    import importlib

    from benchmark.drivers import serving
    from benchmark.families import weights
    from benchmark.reference import transformer as ref
    from benchmark.tools import faults

    def pass_(server, seed, kind):
        ctx = _ctx(cell, seed, seconds, torch, device, overrides)
        server.rebind(weights.make(ctx.family.leaves(ctx.conf), seed,
                                   device, **ctx.workload["weights"]))
        driver = importlib.import_module(
            f"benchmark.drivers.{ctx.workload['driver']}")
        out = driver.run(ctx, server=server, keep=True)
        row = {"cell": cell, "kind": kind, "seed": seed,
               **{k: v["value"] for k, v in out.checks.items()},
               "attempted": out.attempted, "failed": out.failed,
               "correct": out.passed, "notes": out.notes}
        emit(row)
        if kind == "program" and seed in control_seeds:
            recs, params = out.material["_sample"], out.material["_params"]
            low = serving.served_gap(ctx, params, recs, pick=ref.mm_fp8)
            emit({"cell": cell, "kind": "control_fp8", "seed": seed,
                  **{k: v["value"] for k, v in low.items()},
                  "tokens": {k: v["tokens"] for k, v in low.items()}})

    ctx = _ctx(cell, seeds[0], seconds, torch, device, overrides)
    server = serving.Server(ctx)
    for seed in seeds:
        pass_(server, seed, "program")
    server.close()
    server = None
    gc.collect()
    for name in faults.SERVE_FAULTS:
        with faults.planted(name, ctx.conf["family"]):
            fserver = serving.Server(ctx)
            for seed in fault_seeds or control_seeds:
                pass_(fserver, seed, f"fault_{name}")
            fserver.close()
            fserver = None
            gc.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault-seeds", default=None,
                    help="the seeds each fault runs on (default: the "
                    "control's)")
    ap.add_argument("--vary-schedule", action="store_true",
                    help="training: each seed draws its own schedule")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.run import cache_env
    cache_env()
    import torch
    if not torch.cuda.is_available():
        print("error: readings are taken on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = Path(args.out) if args.out else None

    def emit(row):
        print(json.dumps(row), flush=True)
        if out:
            out.parent.mkdir(parents=True, exist_ok=True)
            with out.open("a") as f:
                f.write(json.dumps(row) + "\n")

    seeds = [int(s) for s in args.seeds.split(",")]
    controls = [int(s) for s in args.control_seeds.split(",")]
    fault_seeds = ([int(s) for s in args.fault_seeds.split(",")]
                   if args.fault_seeds else controls)
    from benchmark.harness import core
    driver = core.load_json(core.BENCH / "workloads"
                            / f"{args.workload}.json")["driver"]
    if driver == "train":
        train_readings(args.workload, seeds, controls, torch, device, emit,
                       vary=args.vary_schedule, fault_seeds=fault_seeds)
    else:
        serve_readings(args.workload, seeds, controls, args.seconds, torch,
                       device, emit, fault_seeds=fault_seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
