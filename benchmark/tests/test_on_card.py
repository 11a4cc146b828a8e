"""On the card: one short run of each cell, and the control and the
faults at the cell's own size against the cell's limits.  Marked
``cuda``; each test skips without a card.

    python3 -m pytest benchmark/tests -m cuda
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    _card()
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        cell, "--seed", str(2 ** 31 + 77), "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_limits(cell, tmp_path):
    """The reference at float8 in the program's place, and each fault the
    cell can have, fail at least one of the cell's limits on three
    seeds; the program's own readings pass them."""
    _card()
    out = tmp_path / "readings.jsonl"
    p = subprocess.run([sys.executable, "-m", "benchmark.tools.readings",
                        "--workload", cell, "--seeds", "11,12,13",
                        "--control-seeds", "11,12,13", "--seconds", "4",
                        "--out", str(out)], cwd=ROOT, capture_output=True,
                       text=True, timeout=3000)
    assert p.returncode == 0, p.stderr[-3000:]
    limits = json.loads((ROOT / "benchmark" / "workloads"
                         / f"{cell}.json").read_text())["limits"]
    held = {k: v for k, v in limits.items() if v is not None}
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    for row in rows:
        fails = any(row[k] > v for k, v in held.items())
        if row["kind"] == "program":
            assert not fails, row
        else:
            assert fails, row
