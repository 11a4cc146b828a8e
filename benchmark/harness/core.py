"""One run of one cell: load what the cell names, hand it to its driver,
read the per-layer metrics, and assemble the result line.

Everything a cell is made of is found by name:

- ``BENCHMARK.json``: the cell's entry and which metrics it reports;
- ``benchmark/workloads/<cell>.json``: its config, traffic, driver and
  the limits of its comparison;
- ``benchmark/configs/<config>.json``: the sizes, with ``family`` naming
  ``benchmark/families/<family>.py``;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters;
- ``benchmark/drivers/<driver>.py``: ``run(ctx) -> Outcome``;
- ``benchmark/metrics/<metric>.py``: ``read(material) -> value | None``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> Dict[str, Any]:
    return json.loads(path.read_text())


def manifest() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(man: Dict[str, Any], cell: str) -> Dict[str, Any]:
    for w in man["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def reports(metric: Dict[str, Any], cell: str,
            e2e_of_cell: Optional[List[str]] = None) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed, or the metric
    lists no cells and (per-layer) the cell reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric and e2e_of_cell is not None:
        return metric["moves"] in e2e_of_cell
    return True


def e2e_metrics(man: Dict[str, Any], cell: str) -> List[Dict[str, Any]]:
    return [m for m in man["end_to_end"] if reports(m, cell)]


def layer_metrics(man: Dict[str, Any], cell: str) -> List[Dict[str, Any]]:
    e2e = [m["name"] for m in e2e_metrics(man, cell)]
    return [m for m in man["per_layer"] if reports(m, cell, e2e)]


def load_reader(name: str):
    """``benchmark/metrics/<name>.py`` (a metric's name may hold dots, so
    the file is loaded by path)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a driver gets: the cell's files, the run's arguments, the
    device and the tracer."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device, torch, tracer, setup_clock,
                 overrides: Optional[Dict] = None):
        man_cell = load_json(BENCH / "workloads" / f"{cell}.json")
        overrides = overrides or {}
        self.cell = cell
        self.workload = {**man_cell, **overrides.get("workload", {})}
        self.conf = {**load_json(BENCH / "configs"
                                 / f"{self.workload['config']}.json"),
                     **overrides.get("config", {})}
        self.traffic = {**load_json(BENCH / "traffic"
                                    / f"{self.workload['traffic']}.json"),
                        **overrides.get("traffic", {})}
        self.family = importlib.import_module(
            f"benchmark.families.{self.conf['family']}")
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.torch = torch
        self.tracer = tracer
        #: seconds from the process's start to a ``perf_counter`` reading
        self.setup_clock = setup_clock

    @property
    def window_seconds(self) -> float:
        """A training cell's window: ``--seconds``, or in a traced run at
        most the workload's ``trace_seconds`` (the serving drivers trace
        a tail after the window instead)."""
        if self.trace:
            return min(self.seconds, float(self.workload["trace_seconds"]))
        return self.seconds


class Outcome:
    """What a driver hands back."""

    def __init__(self):
        self.e2e: Dict[str, float] = {}
        self.material: Dict[str, Any] = {}
        self.checks: Dict[str, Dict[str, float]] = {}
        self.passed: bool = False
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.notes: List[str] = []


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             torch, setup_clock, overrides: Optional[Dict] = None,
             man: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run ``cell`` once; the result object (without ``device``)."""
    from benchmark.harness.trace import Tracer

    man = man or manifest()
    tracer = Tracer(trace, torch)
    ctx = Context(cell, seed, seconds, trace, device, torch, tracer,
                  setup_clock, overrides)
    driver = importlib.import_module(
        f"benchmark.drivers.{ctx.workload['driver']}")
    out: Outcome = driver.run(ctx)
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        for m in e2e_metrics(man, cell):
            if m["name"] not in out.e2e:
                raise RuntimeError(f"driver gave no {m['name']!r}")
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    else:
        material = dict(out.material)
        material["trace"] = tracer.summary
        for m in layer_metrics(man, cell):
            value = load_reader(m["name"])(material)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result: Dict[str, Any] = {
        "correct": bool(out.passed), "attempted": int(out.attempted),
        "failed": int(out.failed), "metrics": metrics}
    result["_memory_peak_bytes"] = int(out.memory_peak_bytes)
    if trace and tracer.summary is not None:
        result["_busy_s"] = tracer.summary.busy_s
        result["_window_s"] = tracer.summary.window_s
        result["breakdown"] = tracer.summary.breakdown()
    result["_checks"] = out.checks
    result["_notes"] = out.notes
    return result
