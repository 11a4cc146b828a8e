"""``BENCHMARK.json`` against the contract's rules of form, and every file
a cell names."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in MAN["end_to_end"]}


def _cells_reporting(metric):
    return metric.get("workloads", [w["name"] for w in MAN["workloads"]])


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["benchmark"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_plain(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metric_names_are_unique_across_kinds():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_units_sources_and_arrows(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric["name"] in E2E:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        if metric["unit"] == "%" and ("roofline" in metric["name"]
                                      or "mfu" in metric["name"]):
            assert metric["better"] == "higher"


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_in_each_listed_cell(metric):
    moved = next(m for m in MAN["end_to_end"] if m["name"] == metric["moves"])
    for cell in _cells_reporting(metric):
        assert cell in _cells_reporting(moved), (metric["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in MAN["end_to_end"]
               if w["name"] in _cells_reporting(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(w["name"] in _cells_reporting(m)
                   for m in MAN["per_layer"]), w["name"]


def test_layers_match_letter_for_letter():
    layers = {m["layer"] for m in MAN["per_layer"]}
    for layer in layers:
        assert 1 <= len(layer) <= 200 and "\n" not in layer


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist(cell):
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    wl = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    assert wl["config"] == cell["config"]
    assert wl["traffic"] == cell["traffic"]
    assert (BENCH / "drivers" / f"{wl['driver']}.py").exists()
    assert (BENCH / "traffic" / f"{cell['traffic']}.json").exists()
    conf = json.loads((BENCH / "configs" / f"{cell['config']}.json")
                      .read_text())
    assert (BENCH / "families" / f"{conf['family']}.py").exists()
    for m in MAN["per_layer"]:
        if cell["name"] in _cells_reporting(m):
            assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert conf["file"].startswith("benchmark/configs/")
    body = json.loads((ROOT / conf["file"]).read_text())
    assert body["source"] == conf["source"]
    assert sorted(body["reduced"]) == sorted(conf["reduced"])
    for key in conf["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank", "_size"))
    assert any(conf["name"] == w["config"] for w in MAN["workloads"])


def test_files_under_paths_are_named_plainly():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_nothing_loads_jax_or_the_jax_package():
    """Every module a run imports, the program's included: no top-level
    name ``jax``, ``jaxlib``, ``flax`` or ``deeplearning4j_tpu``
    (compared whole: ``deeplearning4j_tpu_torch`` is the program)."""
    code = """
import importlib, sys
sys.path.insert(0, %r)
import benchmark.run
from benchmark.harness import core, trace
from benchmark.reference import sampler, transformer, adamw
for d in ("train", "serve_closed", "serving"):
    importlib.import_module("benchmark.drivers." + d)
for f in ("gpt", "bert"):
    fam = importlib.import_module("benchmark.families." + f)
for m in core.manifest()["per_layer"]:
    core.load_reader(m["name"])
from deeplearning4j_tpu_torch.models import gpt, bert, transformer
from deeplearning4j_tpu_torch.serving import decode
from deeplearning4j_tpu_torch.ops import flash_attention, updaters
from deeplearning4j_tpu_torch.runtime import metrics, compile_cache
print(benchmark.run.forbidden_modules())
""" % str(ROOT)
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole():
    import benchmark.run as run
    assert "deeplearning4j_tpu" in run.FORBIDDEN
    saved = dict(sys.modules)
    try:
        sys.modules["deeplearning4j_tpu_torch_probe"] = object()
        assert "deeplearning4j_tpu" not in run.forbidden_modules()
        sys.modules["deeplearning4j_tpu.probe"] = object()
        assert "deeplearning4j_tpu" in run.forbidden_modules()
    finally:
        for k in list(sys.modules):
            if k not in saved:
                del sys.modules[k]
