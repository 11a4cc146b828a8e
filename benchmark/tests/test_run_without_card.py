"""A run that finds no CUDA card fails and prints no result."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell", ["gpt2s-train-t1024", "gpt2s-serve-batch"])
def test_no_card_exits_nonzero_without_a_result(cell):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        cell, "--seed", str(2 ** 31 + 5), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    for line in p.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
    assert "CUDA card" in p.stderr
