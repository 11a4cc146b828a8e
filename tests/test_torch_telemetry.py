"""The port's run telemetry, metrics families and console.

``runtime/telemetry.py``: the journal round trip, Perfetto JSON with
numpy attributes (the same converter as the reference's, held on the
same records), the registry's families and deltas, ``summarize_journal``
(tree, top, deltas; equal to the reference's on the same journal), a
warmed LeNet fit that captures nothing new with the tracer off and on
(the documented contract), and ``ResilientFit``'s checkpoint spans and
events.  ``runtime/metrics.py``: ``ScalarsLogger``, ``ThroughputMeter``,
``MetricsListener``, the MFU helpers keyed on CUDA names, the memory
stats' explicit CPU marker and the profiler helpers.
``runtime/console.py``: the dashboard, scalars (incremental, torn
lines, a replaced file), tracker state and renders (port of
``tests/test_console.py``).
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.runtime import telemetry as jtel
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models import lenet
from deeplearning4j_tpu_torch.nn.conf import LayerKind, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.runtime import (compile_cache, metrics,
                                              telemetry)
from deeplearning4j_tpu_torch.runtime.console import ConsoleServer
from deeplearning4j_tpu_torch.runtime.metrics import (
    MetricsListener, Profiler, ScalarsLogger, ThroughputMeter,
    checkpoint_metrics, compile_metrics, resilience_metrics)
from deeplearning4j_tpu_torch.runtime.resilience import (
    LossSpikeDetector, ResilienceConfig, ResilientFit, RetryBudgetExceeded)

torch.set_num_threads(2)

FAMILIES = ["checkpoint", "compile", "decode", "dp", "ingest", "mfu",
            "multihost", "resilience", "serving"]


@pytest.fixture(autouse=True)
def _tracer_off():
    telemetry.disable()
    yield
    telemetry.disable()


def _traced_records():
    t = telemetry.enable(run_id="run-a")
    with telemetry.span("fit", epochs=np.int64(2), lr=np.float32(0.5)):
        with telemetry.span("epoch", epoch=0):
            telemetry.event("ckpt", step=np.int32(3))
        with telemetry.span("epoch", epoch=1) as sp:
            sp.set(bytes=np.uint64(7))
    try:
        with telemetry.span("boom"):
            raise KeyError("x")
    except KeyError:
        pass
    return t


# -- the tracer and its exporters -------------------------------------------

def test_journal_round_trip(tmp_path):
    t = _traced_records()
    path = str(tmp_path / "j" / "run.jsonl")
    snap = telemetry.registry.snapshot()
    t.export_journal(path, snapshot=snap)
    t.export_journal(path)                      # append-only
    recs = telemetry.read_journal(path)
    assert [r["type"] for r in recs[:1]] == ["run"]
    assert recs[0]["run_id"] == "run-a" and recs[0]["dropped"] == 0
    spans = [r for r in recs if r["type"] == "span"]
    assert {r["name"] for r in spans} == {"fit", "epoch", "boom"}
    by = {r["sid"]: r for r in spans[:4]}
    fit = next(r for r in spans if r["name"] == "fit")
    assert all(by[r["sid"]]["parent"] == fit["sid"]
               for r in spans[:4] if r["name"] == "epoch")
    assert next(r for r in spans if r["name"] == "boom")["attrs"] == {
        "error": "KeyError"}
    assert sum(r["type"] == "run" for r in recs) == 2
    assert sum(r["type"] == "snapshot" for r in recs) == 1
    assert telemetry.enabled() and t.count() == 5


def test_chrome_trace_is_valid_perfetto_json_with_numpy_attrs(tmp_path):
    t = _traced_records()
    path = str(tmp_path / "trace.json")
    t.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    evs = trace["traceEvents"]
    assert trace["displayTimeUnit"] == "ms"
    xs = [e for e in evs if e["ph"] == "X"]
    assert len(xs) == 4 and all(e["dur"] >= 0 for e in xs)
    assert [e["name"] for e in evs if e["ph"] == "i"] == ["ckpt"]
    assert {e["name"] for e in evs if e["ph"] == "M"} == {
        "process_name", "thread_name"}
    # the same records through the reference's converter
    ref = jtel.chrome_trace(t.records(), run_id=t.run_id)
    got = telemetry.chrome_trace(t.records(), run_id=t.run_id)
    assert json.dumps(got, default=str).replace("dl4j-torch", "dl4j-tpu") \
        == json.dumps(ref, default=str)


def test_traced_decorator_resolves_per_call():
    @telemetry.traced("work")
    def work(x):
        return x + 1

    assert work(1) == 2                      # off: plain call
    t = telemetry.enable()
    assert work(2) == 3
    assert [r["name"] for r in t.records()] == ["work"]
    assert telemetry.span("x") is not telemetry.NOOP_SPAN
    telemetry.disable()
    assert telemetry.span("x") is telemetry.NOOP_SPAN
    assert not telemetry.enabled()


def test_registry_families_deltas_and_memory():
    reg = telemetry.registry
    assert reg.sources() == FAMILIES
    compile_metrics.reset()
    resilience_metrics.reset()
    reg.mark()
    resilience_metrics.note("rollbacks", 2)
    compile_metrics.note_trace("x")
    snap = reg.snapshot()
    assert set(snap["counters"]) == set(FAMILIES)
    assert snap["since_mark"]["resilience"]["rollbacks"] == 2
    assert snap["since_mark"]["compile"]["compile_count"] == 1
    assert reg.compile_delta_since_mark() == 1
    assert snap["device_memory"]["peak_bytes_in_use"] == {"cpu": None}
    assert snap["device_memory"]["devices"] == {
        "cpu": {"unsupported": "cpu"}}
    assert snap["telemetry_enabled"] is False
    with pytest.raises(TypeError):
        reg.register("bad", object())
    assert telemetry._numeric_delta({"a": 3, "b": 1.5, "c": "s",
                                     "d": True},
                                    {"a": 1, "b": 0.5, "c": "t",
                                     "d": False}) == {
        "a": 2, "b": 1.0, "c": "s", "d": True}


def test_summarize_journal_tree_top_and_deltas(tmp_path):
    t = _traced_records()
    path = str(tmp_path / "run.jsonl")
    resilience_metrics.reset()
    t.export_journal(path, snapshot=telemetry.registry.snapshot())
    resilience_metrics.note("steps_skipped", 3)
    telemetry.disable()
    t2 = telemetry.enable(run_id="run-b")
    with telemetry.span("fit"):
        pass
    t2.export_journal(path, snapshot=telemetry.registry.snapshot())
    recs = telemetry.read_journal(path)
    out = telemetry.summarize_journal(recs, top_k=3)
    assert out == jtel.summarize_journal(recs, top_k=3)
    assert [r["run_id"] for r in out["runs"]] == ["run-a", "run-b"]
    rows = {tuple(r["path"]): r for r in out["tree"]}
    assert rows[("fit", "epoch")]["count"] == 2
    assert rows[("fit",)]["count"] == 2 and rows[("fit",)]["depth"] == 0
    assert len(out["top"]) == 3 and out["events"] == {"ckpt": 1}
    assert out["counter_deltas"]["resilience"]["steps_skipped"] == 3


# -- the instrumentation sites -----------------------------------------------

def _lenet_batches(n=3, b=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.random((b, 28, 28, 1), dtype=np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]
        out.append(DataSet(x, y))
    return out


def test_warmed_lenet_fit_has_zero_compile_delta_tracer_off_and_on():
    compile_cache.clear()
    compile_metrics.reset()
    net = lenet.lenet(compute_dtype="float32", device="cpu")
    batches = _lenet_batches()
    net.fit_backprop(batches)                 # warm-up: the one compile
    assert compile_metrics.snapshot()["traces"] == {
        "multilayer.train_step": 1}
    reg = telemetry.registry
    reg.mark()
    net.fit_backprop(batches)
    net.fit_backprop(batches[0])               # the per-step path too
    assert reg.compile_delta_since_mark() == 0
    t = telemetry.enable()
    net.fit_backprop(batches, num_epochs=2)
    net.fit_backprop(batches[0])
    assert reg.compile_delta_since_mark() == 0
    names = [r["name"] for r in t.records()]
    for n in ("multilayer.fit", "multilayer.stage", "multilayer.dispatch",
              "multilayer.epoch"):
        assert n in names, n


class _FireAt(LossSpikeDetector):
    def __init__(self, at):
        super().__init__()
        self.at, self.calls = at, 0

    def observe(self, loss):
        self.calls += 1
        return self.calls == self.at


def _mlp_net(seed=1):
    conf = (NeuralNetConfiguration.builder()
            .n_in(4).lr(0.1).momentum(0.5).use_adagrad(False)
            .activation("tanh").compute_dtype("float32")
            .list(3).hidden_layer_sizes(8, 6)
            .override(2, kind=LayerKind.OUTPUT, n_out=3,
                      activation="softmax", loss_function="mcxent")
            .pretrain(False).backward(True).build())
    return MultiLayerNetwork(conf, device="cpu").init(seed=seed)


def _mlp_batches(n=4, poison=()):
    rng = np.random.RandomState(0)
    out = []
    for b in range(n):
        x = rng.randn(16, 4).astype(np.float32)
        if b in poison:
            x[0, 0] = np.nan
        out.append(DataSet(x, np.eye(3, dtype=np.float32)[
            rng.randint(0, 3, 16)]))
    return out


def test_resilient_fit_emits_checkpoint_spans_and_events(tmp_path):
    checkpoint_metrics.reset()
    t = telemetry.enable()
    d = str(tmp_path / "ck")
    ResilientFit(_mlp_net(), ResilienceConfig(
        checkpoint_dir=d, checkpoint_every=2, max_steps=5),
        detector=_FireAt(4)).fit(_mlp_batches(poison={1}), num_epochs=2)
    ResilientFit(_mlp_net(), ResilienceConfig(
        checkpoint_dir=d, checkpoint_every=2, resume=True)).fit(
            _mlp_batches(), num_epochs=2)
    with pytest.raises(RetryBudgetExceeded):
        ResilientFit(_mlp_net(), ResilienceConfig(
            checkpoint_dir=str(tmp_path / "b"), patience=1, min_history=0,
            max_rollbacks=0)).fit(_mlp_batches(poison={0}))
    recs = t.records()
    spans = [r for r in recs if r["type"] == "span"]
    modes = {r["attrs"]["mode"] for r in spans
             if r["name"] == "resilience.checkpoint"}
    assert modes == {"async", "sync"}
    assert sum(r["name"] == "resilience.restore" for r in spans) == 2
    events = [r["name"] for r in recs if r["type"] == "event"]
    for e in ("resilience.rollback", "resilience.resume",
              "resilience.guard_skips", "resilience.retry_budget_exceeded"):
        assert e in events, e
    rb = next(r for r in recs if r["name"] == "resilience.rollback")
    assert rb["attrs"] == {"step": 3, "to_step": 2, "rollbacks": 1}
    assert checkpoint_metrics.count("snapshots_committed") >= 4


# -- metrics: scalars, throughput, listener, MFU, memory, profiler ----------

def test_scalars_logger_and_listener(tmp_path):
    path = str(tmp_path / "d" / "scalars.jsonl")
    logger = ScalarsLogger(path)
    ml = MetricsListener(logger, batch_size=32)
    for i in range(3):
        ml.iteration_done(None, i, 1.0 / (i + 1))
    logger.log(3, loss=np.float32(0.25))
    logger.close()
    recs = ScalarsLogger.read(path)
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    assert "samples_per_sec" in recs[2] and "step_seconds" not in recs[0]
    assert recs[3]["loss"] == 0.25


def test_metrics_listener_resets_between_fits_and_logs_guard_skips(tmp_path):
    path = str(tmp_path / "s.jsonl")
    logger = ScalarsLogger(path)
    ml = MetricsListener(logger, batch_size=16)
    net = _mlp_net()
    net.set_listeners([ml])
    net.fit_backprop(_mlp_batches(poison={1}))
    net.fit_backprop(_mlp_batches()[0])
    logger.close()
    recs = ScalarsLogger.read(path)
    assert len(recs) == 5
    # the first record of each fit has no step time (on_fit_start)
    assert "step_seconds" not in recs[0] and "step_seconds" not in recs[4]
    # the staged path books its skips before replaying the listeners
    assert [r["guard_skips"] for r in recs] == [1, 1, 1, 1, 1]


def test_throughput_meter(monkeypatch):
    m = ThroughputMeter(window=3)
    assert m.tick(32) is None
    rates = [m.tick(32) for _ in range(5)]
    assert all(r is not None and r > 0 for r in rates)
    assert len(m._events) == 3
    clock = iter([5.0, 5.0])
    monkeypatch.setattr(metrics.time, "perf_counter", lambda: next(clock))
    z = ThroughputMeter()
    assert z.tick(1) is None and z.tick(1) is None     # dt == 0


def test_mfu_helpers_keyed_on_cuda_names():
    assert metrics.chip_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert metrics.chip_peak_flops("TPU v5 lite") is None
    assert metrics.chip_peak_flops("") is None
    est = metrics.estimate_mfu(989e12 * 0.5, 1.0, "NVIDIA H100 80GB HBM3")
    assert est == pytest.approx(0.5)
    assert metrics.estimate_mfu(1e12, 0.0, "NVIDIA H100 80GB HBM3") is None
    metrics.mfu_metrics.reset()
    metrics.mfu_metrics.note_mfu("gpt", 2e15, 2.0, "NVIDIA H100 80GB HBM3")
    e = metrics.mfu_metrics.estimate("gpt")
    assert e["mfu"] == pytest.approx(round(1e15 / 989e12, 4))
    assert metrics.mfu_metrics.snapshot()["estimates"]["gpt"] == e


def test_memory_stats_mark_the_cpu_unsupported():
    stats = metrics.device_memory_stats()
    assert stats == {"cpu": {"unsupported": "cpu"}}
    assert metrics.peak_bytes_in_use(stats) == {"cpu": None}
    assert metrics.peak_bytes_in_use(
        {"cuda:0": {"peak_bytes_in_use": 12}, "x": {"unsupported": "e"}}) \
        == {"cuda:0": 12, "x": None}


def test_profiler_helpers(tmp_path):
    t = Profiler.step_timer()
    for _ in range(3):
        with t:
            torch.ones(8).sum()
    assert len(t.times) == 3 and t.mean_s > 0
    with Profiler.trace(str(tmp_path / "prof")) as prof:
        with Profiler.annotate("test-span"):
            torch.ones(16).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        trace = json.load(f)
    assert any(e.get("name") == "test-span" for e in trace["traceEvents"])
    assert prof is not None


def test_the_other_families_snapshot_and_reset():
    for fam in (metrics.dp_metrics, metrics.multihost_metrics,
                metrics.ingest_metrics, checkpoint_metrics):
        fam.reset()
        before = fam.snapshot()
        assert all(v in (0, 0.0, 1) for v in before.values())
    metrics.dp_metrics.note_dispatch(4, 2, 8)
    assert metrics.dp_metrics.snapshot()["steps_per_dispatch"] == 4.0
    metrics.ingest_metrics.note_depth(5)
    assert metrics.ingest_metrics.count("depth_hw") == 5
    metrics.multihost_metrics.note("barriers")
    assert metrics.multihost_metrics.count("barriers") == 1
    checkpoint_metrics.note_staged(10, 1.0)
    checkpoint_metrics.note_committed(20, 2.0, 3.0, was_async=True)
    s = checkpoint_metrics.snapshot()
    assert (s["in_flight"], s["max_in_flight"], s["bytes_written"]) == \
        (0, 1, 20)


# -- the console (port of tests/test_console.py) ----------------------------

def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


class _Tracker:
    """The reference StateTracker's read surface."""

    def workers(self):
        return ["w1"]

    def heartbeats(self):
        return {"w1": 1.0}

    def count(self, key):
        return {"jobs_done": 3}.get(key, 0)

    def has_pending(self):
        return True

    def is_done(self):
        return False


def test_console_serves_dashboard_scalars_state_and_renders(tmp_path):
    scalars = str(tmp_path / "scalars.jsonl")
    logger = ScalarsLogger(scalars)
    for step in range(5):
        logger.log(step, loss=1.0 / (step + 1), acc=step / 5.0)
    logger.close()
    render = tmp_path / "renders"
    render.mkdir()
    (render / "embedding.html").write_text("<html>embedding</html>")
    with ConsoleServer(scalars_path=scalars, tracker=_Tracker(),
                       render_dir=str(render)) as srv:
        assert "training console" in _get(srv.url + "/").decode()
        rows = json.loads(_get(srv.url + "/api/scalars"))
        assert len(rows) == 5 and rows[0]["loss"] == 1.0
        state = json.loads(_get(srv.url + "/api/state"))
        assert state["attached"] and state["workers"] == ["w1"]
        assert state["counters"]["jobs_done"] == 3
        assert state["has_pending"] is True
        assert _get(srv.url + "/renders/embedding.html").decode() == \
            "<html>embedding</html>"
        for bad in ("/renders/../secret", "/renders/nope.html", "/zzz"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(srv.url + bad, timeout=10)
            assert e.value.code == 404


def test_console_without_sources_is_empty_not_broken():
    with ConsoleServer() as srv:
        assert json.loads(_get(srv.url + "/api/scalars")) == []
        assert json.loads(_get(srv.url + "/api/state")) == {
            "attached": False}


def test_console_scalars_incremental_torn_and_replaced(tmp_path):
    scalars = str(tmp_path / "s.jsonl")
    with open(scalars, "w") as f:
        f.write('{"step": 0, "loss": 1.0}\n')
    with ConsoleServer(scalars_path=scalars) as srv:
        assert len(json.loads(_get(srv.url + "/api/scalars"))) == 1
        with open(scalars, "a") as f:
            f.write('{"step": 1, "lo')
        assert len(json.loads(_get(srv.url + "/api/scalars"))) == 1
        with open(scalars, "a") as f:
            f.write('ss": 0.5}\n{"step": 2, "loss": 0.25}\n')
        rows = json.loads(_get(srv.url + "/api/scalars"))
        assert [r["step"] for r in rows] == [0, 1, 2]
        with open(scalars, "w") as f:           # a new run replaces it
            for i in range(8):
                f.write('{"step": %d, "acc": 0.5}\n' % i)
        rows = json.loads(_get(srv.url + "/api/scalars"))
        assert len(rows) == 8 and all("acc" in r for r in rows)


def test_telemetry_modules_import_no_jax():
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.runtime.telemetry\n"
            "import deeplearning4j_tpu_torch.runtime.console\n"
            "import deeplearning4j_tpu_torch.runtime.metrics\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(repo),
                         env=dict(os.environ, PYTHONPATH=str(repo)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), \
        res.stdout + res.stderr
