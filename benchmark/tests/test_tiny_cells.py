"""Each cell driven end to end on the CPU at toy widths (the harness's
look for a card skipped): sound, ``correct`` comes out true; with a fault
planted under the timed path (``tools/faults.py``) it comes out false.

The limits here are the toy size's, set between its sound readings and
its faults' (CPU, seeds 5-7: training loss gaps <= 2.5e-5, gradient
gaps <= 2.0e-3, change gaps <= 7.0e-3 against 0.34-1.0 for a fault's
gradient; served-token gaps 0-1.8e-4, greedy and sampled, against
0.98-14 with tokens shifted, 9.6-10 with the seed ignored and 0.06-0.50
at half the temperature).
"""

import pytest
import torch

from benchmark.harness import core
from benchmark.tests import tiny
from benchmark.tools import faults

TRAIN_LIMITS = {"loss": 5e-4, "grad": 0.05, "change": 0.05}
SERVE_LIMITS = {"gap": 0.02, "gap_sampled": 0.02}
SEED = 2 ** 31 + 99
TRAIN = ["gpt2s-train-t1024", "bertb-mlm-t128"]
SERVE = ["gpt2s-serve-batch"]


def _run(cell, trace=False):
    limits = TRAIN_LIMITS if cell in TRAIN else SERVE_LIMITS
    o = tiny.overrides(cell, workload={"limits": limits,
                                       "trace_seconds": 0.5})
    return core.run_cell(cell, SEED, 1.0, trace, torch.device("cpu"), torch,
                         lambda t: t, overrides=o)


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_cell_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["_checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    names = {m["name"] for m in core.e2e_metrics(core.manifest(), cell)}
    assert set(r["metrics"]) == names
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r["_checks"])


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN
                                        for f in faults.TRAIN_FAULTS]
                         + [(c, f) for c in SERVE
                            for f in faults.SERVE_FAULTS])
def test_fault_under_the_timed_path_is_not_correct(cell, fault):
    family = core.load_json(core.BENCH / "configs" / "gpt2s.json")["family"] \
        if "gpt2s" in cell else "bert"
    with faults.planted(fault, family):
        r = _run(cell)
    assert not r["correct"], r["_checks"]


@pytest.mark.parametrize("cell", ["gpt2s-serve-batch"])
def test_traced_serving_run_reads_its_counters(cell):
    r = _run(cell, trace=True)
    assert r["correct"]
    want = {m["name"] for m in core.layer_metrics(core.manifest(), cell)}
    # the CPU has no device trace: the counters are read, and the traced
    # tail is as long as the cell asks
    got = set(r["metrics"])
    assert got <= want and got - {"device_idle_share.batch"}
    assert r["_window_s"] == pytest.approx(0.5, abs=0.2)
