"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run needs a CUDA card (it exits with
code 2 and prints no result without one, or with fewer cards than the
cell asks for), makes its inputs and weights from ``--seed``, warms up
the cell's shapes, measures for ``--seconds`` (with ``--trace 1`` at
most the cell's ``trace_seconds``, under the profiler), checks what the
timed path produced against the plain reference, and prints one JSON
object as the last line of its standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, and last ``checks``, each compared number beside its
limit (also the last lines of standard error).  It exits with code 3,
and prints no result, if JAX or the JAX package was loaded.

Every cache the program builds lives under ``build/`` in the checkout.
"""

from __future__ import annotations

import time

_T_TOP = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")


def _process_age() -> float:
    """Seconds since this process started (the kernel's start time, in
    clock ticks since boot, against the uptime clock)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_TOP = _process_age()


def setup_clock(t: float) -> float:
    """Seconds from the process's start to ``t`` (a ``perf_counter``
    reading)."""
    return _AGE_TOP + (t - _T_TOP)


def cache_env() -> None:
    """Put every build and kernel cache of the program in fixed
    directories of the checkout, and keep libraries from loading JAX."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["DL4J_TPU_TELEMETRY_DIR"] = str(build / "telemetry")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line(torch) -> str:
    """The card's name, power limit and SM clock, from ``nvidia-smi``."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return got.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.harness import core

    man = core.manifest()
    entry = core.cell_entry(man, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: the cell needs {entry['chips']} CUDA card(s); this "
              f"machine has {n}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"card: {card_line(torch)}", flush=True)
    result = core.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device, torch, setup_clock,
                           man=man)
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {bad}", file=sys.stderr)
        return 3
    print(f"card after the run: {card_line(torch)}")
    for note in result.pop("_notes"):
        print(note)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": int(entry["chips"]),
           "memory_peak_bytes": result.pop("_memory_peak_bytes")}
    if args.trace:
        dev["busy_s"] = result.pop("_busy_s")
        dev["window_s"] = result.pop("_window_s")
    checks = result.pop("_checks")
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics")}
    line["device"] = dev
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    sys.stdout.flush()
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
