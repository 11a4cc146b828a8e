"""The port's self-healing training against the JAX reference.

``runtime/resilience.py``: the in-step guard helpers, the loss-spike
detector, ``ResilientFit`` (rollback, retry budget, skip counting,
resume equal to an uninterrupted run with the optimizer state, refusal
of a poisoned checkpoint, reshuffling on a new seed), the preemption
guard (programmatic, a SIGTERM drill in a torch subprocess on the CPU,
a second signal escaping) and the preemption stop of the plain fits.

Against JAX, on the same conf (no dropout), params, batches and
poisoned step with ``shuffle=False`` (the port's permutations are not
JAX's bits): ``steps_skipped`` and ``rollbacks`` equal, and the final
params within 1e-6 relative in fp32 (the same fp32 arithmetic in the
same order; ``tests/test_torch_nn.py`` holds one step to 1e-6).  A
directory written by JAX's ``ResilientFit(max_steps=k)`` is resumed by
the port to the end, within 1e-6 of JAX's uninterrupted run.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import LayerKind as JLayerKind
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.runtime import resilience as jres
from deeplearning4j_tpu.runtime.metrics import \
    resilience_metrics as jres_metrics
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf import LayerKind, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.updaters import UpdaterState, tree_leaves
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.runtime import compile_cache, resilience
from deeplearning4j_tpu_torch.runtime.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.runtime.metrics import (checkpoint_metrics,
                                                      compile_metrics,
                                                      resilience_metrics)
from deeplearning4j_tpu_torch.runtime.resilience import (
    LossSpikeDetector, PreemptionGuard, ResilienceConfig, ResilientFit,
    RetryBudgetExceeded)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
#: final params against JAX's: the same fp32 arithmetic in the same order
PARITY_RTOL = 1e-6


def _fresh():
    compile_cache.clear()
    compile_metrics.reset()
    resilience_metrics.reset()
    checkpoint_metrics.reset()
    jres_metrics.reset()


def _mlp_conf(conf_cls=NeuralNetConfiguration, kind=LayerKind, lr=0.1):
    return (conf_cls.builder()
            .n_in(4).lr(lr).momentum(0.5).use_adagrad(False)
            .num_iterations(5).activation("tanh").compute_dtype("float32")
            .list(3).hidden_layer_sizes(8, 6)
            .override(2, kind=kind.OUTPUT, n_out=3, activation="softmax",
                      loss_function="mcxent", dropout=0.0)
            .pretrain(False).backward(True).build())


def _np_batches(n_batches=4, n=16, poison=()):
    rng = np.random.RandomState(0)
    out = []
    for b in range(n_batches):
        x = rng.randn(n, 4).astype(np.float32)
        if b in poison:
            x[0, 0] = np.nan
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
        out.append((x, y))
    return out


def _batches(n_batches=4, n=16, poison=()):
    return [DataSet(torch.from_numpy(x), torch.from_numpy(y))
            for x, y in _np_batches(n_batches, n, poison)]


def _net(seed, lr=0.1):
    return MultiLayerNetwork(_mlp_conf(lr=lr), device="cpu").init(seed=seed)


class _FireOnce(LossSpikeDetector):
    """Stub detector: report one sustained anomaly at its ``at``-th
    observation (any package: it only sees losses)."""

    def __init__(self, at):
        super().__init__()
        self.at = at
        self.calls = 0
        self.fired = False

    def observe(self, loss):
        self.calls += 1
        if not self.fired and self.calls == self.at:
            self.fired = True
            return True
        return False


class _JFireOnce(jres.LossSpikeDetector):
    def __init__(self, at):
        super().__init__()
        self.at = at
        self.calls = 0
        self.fired = False

    def observe(self, loss):
        self.calls += 1
        if not self.fired and self.calls == self.at:
            self.fired = True
            return True
        return False


# -- in-step guard primitives ----------------------------------------------

def test_tree_all_finite_flags_nan_inf_and_skips_int_leaves():
    assert bool(resilience.tree_all_finite(
        {"a": torch.ones(3), "b": torch.arange(4)}))
    assert not bool(resilience.tree_all_finite(
        {"a": torch.tensor([1.0, float("nan")])}))
    assert not bool(resilience.tree_all_finite((torch.tensor(float("inf")),)))
    assert bool(resilience.tree_all_finite({"i": torch.arange(3)}))
    assert not bool(resilience.tree_all_finite(
        [UpdaterState({"W": torch.ones(2)},
                      {"W": torch.tensor([0.0, float("-inf")])})]))


def test_guard_update_selects_old_state_and_flags_skip():
    p, u = {"w": torch.ones(2)}, {"m": torch.zeros(2)}
    new_p, new_u = {"w": torch.full((2,), 9.0)}, {"m": torch.full((2,), 5.0)}
    out_p, out_u, skipped = resilience.guard_update(
        p, u, new_p, new_u, (torch.tensor(float("nan")),))
    assert skipped.dtype == torch.int32 and int(skipped) == 1
    assert torch.equal(out_p["w"], p["w"]) and torch.equal(out_u["m"], u["m"])
    out_p, _, skipped = resilience.guard_update(
        p, u, new_p, new_u, (torch.tensor(1.0),))
    assert int(skipped) == 0 and torch.equal(out_p["w"], new_p["w"])
    # a buffer the step left alone is returned as is, with no select
    same = {"w": torch.ones(2)}
    assert resilience.where_ok(torch.tensor(False), same, same)["w"] \
        is same["w"]


def test_note_skips_books_metrics_once():
    _fresh()
    flags = [torch.tensor(0, dtype=torch.int32),
             torch.tensor(1, dtype=torch.int32),
             torch.tensor(1, dtype=torch.int32)]
    assert resilience.note_skips(flags, where="test") == 2
    assert resilience.note_skips([], where="test") == 0
    assert resilience.note_skips(None) == 0
    assert resilience_metrics.count("steps_skipped") == 2


def test_result_and_compiled_all_finite():
    assert resilience.result_all_finite({"w": torch.ones(3)})
    assert not resilience.result_all_finite(
        [np.ones(2), {"b": np.float32(np.nan)}])
    assert not resilience.result_all_finite({"w": np.array(["a", "b"])})
    assert resilience.result_all_finite(
        {"h": torch.ones(2, dtype=torch.bfloat16)})
    _fresh()
    assert resilience.compiled_all_finite({"a": torch.ones(4)})
    assert not resilience.compiled_all_finite(
        {"a": torch.tensor([1.0, float("nan"), 1.0, 1.0])})
    assert compile_metrics.snapshot()["traces"] == {
        "resilience.all_finite": 1}


# -- loss-spike detector ----------------------------------------------------

def test_spike_detector_needs_sustained_anomaly():
    det = LossSpikeDetector(window=8, factor=3.0, patience=3, min_history=3)
    for _ in range(5):
        assert not det.observe(1.0)
    assert not det.observe(10.0)
    assert not det.observe(float("nan"))
    assert det.observe(50.0)
    det.reset()
    assert not det.observe(50.0)


def test_spike_detector_empty_window_does_not_crash():
    det = LossSpikeDetector(window=4, factor=3.0, patience=1, min_history=0)
    assert not det.observe(1.0)
    assert det.observe(float("nan"))


def test_spike_detector_transients_do_not_fire():
    det = LossSpikeDetector(window=8, factor=3.0, patience=2, min_history=3)
    fired = False
    for i in range(30):
        fired = fired or det.observe(20.0 if i % 5 == 4 else 1.0)
    assert not fired


def test_config_checks():
    with pytest.raises(ValueError, match="checkpoint_every"):
        ResilienceConfig(checkpoint_dir="x", checkpoint_every=0)
    with pytest.raises(ValueError, match="max_in_flight"):
        ResilienceConfig(checkpoint_dir="x", max_in_flight=0)


# -- ResilientFit -----------------------------------------------------------

def test_rolls_back_and_completes(tmp_path):
    _fresh()
    net = _net(3)
    det = _FireOnce(at=7)
    fitter = ResilientFit(net, ResilienceConfig(
        checkpoint_dir=str(tmp_path), checkpoint_every=3,
        max_rollbacks=2), detector=det)
    fitter.fit(_batches(4), num_epochs=3, seed=5)
    assert det.fired and fitter.rollbacks == 1
    assert resilience_metrics.count("rollbacks") == 1
    assert torch.isfinite(net.params_flat()).all()
    assert fitter.manager.latest_step() is not None
    # the rollback restored into the step's free state set: the train
    # step and the restore check were each compiled once
    assert compile_metrics.snapshot()["traces"] == {
        "multilayer.train_step": 1, "resilience.all_finite": 1}


def test_retry_budget_exhausts(tmp_path):
    _fresh()
    fitter = ResilientFit(_net(4), ResilienceConfig(
        checkpoint_dir=str(tmp_path), checkpoint_every=100,
        patience=1, min_history=0, max_rollbacks=2))
    with pytest.raises(RetryBudgetExceeded):
        fitter.fit(_batches(4, poison={0, 1, 2, 3}), num_epochs=2, seed=6)
    assert resilience_metrics.count("rollbacks") == 2
    assert resilience_metrics.count("retry_budget_exceeded") == 1


def test_counts_skips(tmp_path):
    _fresh()
    net = _net(12)
    fitter = ResilientFit(net, ResilienceConfig(
        checkpoint_dir=str(tmp_path), checkpoint_every=100,
        patience=10 ** 6))
    fitter.fit(_batches(4, poison={1}), num_epochs=2, seed=9)
    assert resilience_metrics.count("steps_skipped") == 2
    assert net.guard_skips == 2
    assert torch.isfinite(net.params_flat()).all()


def _state_of(fitter, net):
    """(params, updater state) of the fitter's newest snapshot."""
    _, updaters = net._backprop_machinery()
    return fitter._restore_latest(net, updaters)[:2]


@pytest.mark.parametrize("sync", [False, True])
def test_resume_equals_uninterrupted_with_optimizer_state(tmp_path, sync):
    _fresh()
    batches = _batches(3)

    def run(ckdir, max_steps=None, resume=False):
        net = _net(11, lr=0.2)
        fitter = ResilientFit(net, ResilienceConfig(
            checkpoint_dir=str(ckdir), checkpoint_every=2, sync=sync,
            max_steps=max_steps, resume=resume, max_to_keep=10))
        fitter.fit(batches, num_epochs=4, seed=8)      # 12 steps
        return net, fitter

    full, fd = run(tmp_path / "full")
    run(tmp_path / "part", max_steps=5)
    resumed, rd = run(tmp_path / "part", resume=True)
    assert rd.steps_run == 7
    assert torch.equal(full.params_flat(), resumed.params_flat())
    # the final snapshots agree leaf for leaf, optimizer state included
    fp, fu = _state_of(fd, full)
    rp, ru = _state_of(rd, resumed)
    for a, b in zip(fp + fu, rp + ru):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)
    assert any(float(x.abs().sum()) > 0 for u in fu
               for x in tree_leaves(u.momentum_buf))


def test_refuses_a_poisoned_checkpoint(tmp_path):
    _fresh()
    net = _net(13)
    params = net._require_params()
    _, updaters = net._backprop_machinery()
    ustate = [u.init(p) for u, p in zip(updaters, params)]
    poisoned = [{k: v * float("nan") for k, v in p.items()} for p in params]
    CheckpointManager(str(tmp_path)).save(4, (poisoned, ustate),
                                          meta={"rollbacks": 0})
    fitter = ResilientFit(net, ResilienceConfig(
        checkpoint_dir=str(tmp_path), resume=True))
    with pytest.raises(RuntimeError, match="non-finite"):
        fitter.fit(_batches(4), num_epochs=2, seed=3)


def test_fresh_run_refuses_a_populated_directory(tmp_path):
    _fresh()
    ResilientFit(_net(1), ResilienceConfig(
        checkpoint_dir=str(tmp_path), max_steps=2)).fit(_batches(2))
    with pytest.raises(ValueError, match="already holds snapshots"):
        ResilientFit(_net(1), ResilienceConfig(
            checkpoint_dir=str(tmp_path))).fit(_batches(2))


def test_new_seed_reshuffles_and_rollback_redraws(tmp_path):
    fitter = ResilientFit(_net(14), ResilienceConfig(
        checkpoint_dir=str(tmp_path), checkpoint_every=100))

    def expected(seed, rollbacks, epoch):
        g = torch.Generator().manual_seed(
            resilience.fold(seed, 7 + rollbacks, epoch))
        return torch.randperm(8, generator=g).tolist()

    o1 = fitter._epoch_order(21, 0, 0, 8)
    assert o1 == expected(21, 0, 0) and sorted(o1) == list(range(8))
    o2 = fitter._epoch_order(22, 0, 0, 8)
    assert o2 == expected(22, 0, 0) and o2 != o1
    assert fitter._epoch_order(21, 1, 0, 8) != o1
    assert fitter._epoch_order(21, 0, 0, 8) == o1
    assert resilience.fold(1, 2, 3) != resilience.fold(1, 3, 2)


def test_unported_paths_name_roadmap_a7(tmp_path):
    net = _net(1)
    cfg = ResilienceConfig(checkpoint_dir=str(tmp_path))
    for kw in ({"mesh": object()}, {"cluster": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            ResilientFit(net, cfg, **kw)

    def lose(step):
        if step == 1:
            raise resilience.DeviceLossError([0])
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        ResilientFit(net, ResilienceConfig(
            checkpoint_dir=str(tmp_path / "a")), fault_hook=lose).fit(
                _batches(2))
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        ResilientFit(net, ResilienceConfig(
            checkpoint_dir=str(tmp_path / "b"),
            data_service=True)).fit(_batches(2))


def test_no_capture_after_warm_up_with_the_cards_bookkeeping(
        tmp_path, monkeypatch):
    """The card's state sets, with the CPU stand-in for the capture: a
    rollback, a bounded slice, its resume and a preemption each restore
    into the step's free state set, so after warm-up nothing is
    captured.  (A reference cycle holding a snapshot's leaves once kept
    the slice's aliases alive into the resume, which then took a second
    state set and a capture.)"""
    from test_torch_compile_cache import _record_eagerly

    monkeypatch.setattr(compile_cache, "_graphs_on", lambda dev: True)
    monkeypatch.setattr(compile_cache, "_new_pool", lambda: None)
    monkeypatch.setattr(compile_cache, "_record", _record_eagerly)
    _fresh()
    warm = _net(3)
    warm.fit_backprop(_batches(1)[0])
    assert resilience.compiled_all_finite(warm.params)
    warmed = dict(compile_metrics.traces)
    assert warmed == {"multilayer.train_step": 1,
                      "resilience.all_finite": 1}
    batches = _batches(4, poison={2})

    def fit(name, det=None, **kw):
        net = _net(3)
        drv = ResilientFit(net, ResilienceConfig(
            checkpoint_dir=str(tmp_path / name), checkpoint_every=3,
            max_to_keep=10, **kw), detector=det)
        drv.fit(batches, num_epochs=3, seed=5)
        return net, drv

    full, fd = fit("full", _FireOnce(at=8))
    det = _FireOnce(at=8)
    fit("split", det, max_steps=5)
    part, rd = fit("split", det, resume=True)
    guard = PreemptionGuard()
    net = _net(3)
    net.set_listeners([_RequestAt(guard, 4)])
    ResilientFit(net, ResilienceConfig(
        checkpoint_dir=str(tmp_path / "p")), preemption_guard=guard).fit(
            batches, num_epochs=3)
    assert fd.rollbacks == rd.rollbacks == 1
    assert torch.equal(full.params_flat(), part.params_flat())
    assert compile_metrics.traces == warmed


# -- against JAX ------------------------------------------------------------

def _jax_net(seed):
    return JNet(_mlp_conf(JConf, JLayerKind)).init(seed=seed)


def _port_twin(jnet):
    net = _net(0)
    net.set_params_flat(torch.from_numpy(np.array(jnet.params_flat())))
    return net


def _assert_params_close(tnet, jnet):
    got = tnet.params_flat().numpy().astype(np.float64)
    ref = np.asarray(jnet.params_flat(), np.float64)
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel <= PARITY_RTOL, rel


def test_resilient_fit_matches_jax(tmp_path):
    """Skip counts, rollbacks and final params against JAX's fitter:
    one poisoned batch, one forced rollback, no shuffle, fp32."""
    _fresh()
    np_b = _np_batches(4, poison={2})
    jnet = _jax_net(21)
    tnet = _port_twin(jnet)
    jdrv = jres.ResilientFit(jnet, jres.ResilienceConfig(
        checkpoint_dir=str(tmp_path / "j"), checkpoint_every=3,
        shuffle=False, sync=True), detector=_JFireOnce(at=8))
    jdrv.fit([JDataSet(jnp.asarray(x), jnp.asarray(y)) for x, y in np_b],
             num_epochs=3, seed=4)
    tdrv = ResilientFit(tnet, ResilienceConfig(
        checkpoint_dir=str(tmp_path / "t"), checkpoint_every=3,
        shuffle=False), detector=_FireOnce(at=8))
    tdrv.fit([DataSet(torch.from_numpy(x), torch.from_numpy(y))
              for x, y in np_b], num_epochs=3, seed=4)
    assert tdrv.rollbacks == jdrv.rollbacks == 1
    assert resilience_metrics.count("steps_skipped") == \
        jres_metrics.count("steps_skipped") > 0
    assert tnet.guard_skips == jnet.guard_skips
    _assert_params_close(tnet, jnet)


def test_port_resumes_a_jax_run(tmp_path):
    """JAX's ResilientFit stops at max_steps; the port resumes its
    directory to the end and lands within 1e-6 of JAX's uninterrupted
    run (the snapshot carries params, momentum and the step)."""
    _fresh()
    np_b = _np_batches(3)
    jb = [JDataSet(jnp.asarray(x), jnp.asarray(y)) for x, y in np_b]

    def jrun(d, max_steps=None):
        net = _jax_net(31)
        jres.ResilientFit(net, jres.ResilienceConfig(
            checkpoint_dir=str(d), checkpoint_every=2, shuffle=False,
            max_steps=max_steps, sync=True)).fit(jb, num_epochs=3, seed=2)
        return net

    full = jrun(tmp_path / "full")
    jrun(tmp_path / "split", max_steps=5)
    tnet = _port_twin(_jax_net(31))
    drv = ResilientFit(tnet, ResilienceConfig(
        checkpoint_dir=str(tmp_path / "split"), checkpoint_every=2,
        shuffle=False, resume=True))
    drv.fit([DataSet(torch.from_numpy(x), torch.from_numpy(y))
             for x, y in np_b], num_epochs=3, seed=2)
    assert drv.steps_run == 4
    _assert_params_close(tnet, full)


# -- preemption -------------------------------------------------------------

class _RequestAt(IterationListener):
    def __init__(self, guard, at):
        self.guard, self.at = guard, at

    def iteration_done(self, model, iteration, score):
        if iteration == self.at:
            self.guard.request()


def test_programmatic_preemption_stops_with_a_final_snapshot(tmp_path):
    _fresh()
    net = _net(5)
    guard = PreemptionGuard()
    net.set_listeners([_RequestAt(guard, 4)])
    fitter = ResilientFit(net, ResilienceConfig(
        checkpoint_dir=str(tmp_path), checkpoint_every=100),
        preemption_guard=guard)
    fitter.fit(_batches(4), num_epochs=3, seed=1)
    assert fitter.preempted and fitter.steps_run == 5
    assert fitter.manager.latest_step() == 5
    snap = checkpoint_metrics.snapshot()
    assert snap["preemption_snapshots"] == 1
    assert snap["preemptions_requested"] == 1
    assert snap["saves_sync"] == 1           # the final one
    assert not resilience.preemption_requested()   # guard uninstalled


def test_preemption_stops_plain_fits_at_a_step_boundary():
    _fresh()
    from deeplearning4j_tpu_torch.datasets.iterator import \
        ListDataSetIterator

    for fit in ("staged", "stream", "iterator"):
        net = _net(6)
        guard = PreemptionGuard()
        steps = []

        class Count(IterationListener):
            def iteration_done(self, model, iteration, score):
                steps.append(iteration)

        batches = _batches(4)
        net.set_listeners([Count()])
        with guard:
            guard.request()
            if fit == "staged":
                net.fit_backprop(batches, num_epochs=2)
            elif fit == "stream":
                net.fit_backprop(batches[0], num_epochs=2)
            else:
                net.fit_iterator(ListDataSetIterator(batches), num_epochs=2)
        assert steps == []
        before = _net(6).params_flat()
        assert torch.equal(net.params_flat(), before)


def test_second_signal_escapes_to_the_previous_handler():
    hits = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: hits.append(s))
    try:
        guard = PreemptionGuard(signals=(signal.SIGUSR1,))
        with guard:
            signal.raise_signal(signal.SIGUSR1)
            assert guard.requested() and hits == []
            signal.raise_signal(signal.SIGUSR1)
            assert hits == [signal.SIGUSR1]
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_guard_is_reentrant_and_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    with guard:
        inner = signal.getsignal(signal.SIGTERM)
        with guard:
            assert signal.getsignal(signal.SIGTERM) == inner
        assert signal.getsignal(signal.SIGTERM) == inner
    assert signal.getsignal(signal.SIGTERM) == before
    # from a worker thread the guard degrades to request()
    out = {}

    def worker():
        g = PreemptionGuard()
        with g:
            g.request()
            out["seen"] = resilience.preemption_requested()
    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert out["seen"] and signal.getsignal(signal.SIGTERM) == before


_DRILL = textwrap.dedent("""
    import json, os, signal, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.conf import (LayerKind,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
    from deeplearning4j_tpu_torch.runtime.resilience import (
        ResilienceConfig, ResilientFit)

    # the test module's _mlp_conf(), _net(8) and _batches(4)
    conf = (NeuralNetConfiguration.builder()
            .n_in(4).lr(0.1).momentum(0.5).use_adagrad(False)
            .num_iterations(5).activation("tanh").compute_dtype("float32")
            .list(3).hidden_layer_sizes(8, 6)
            .override(2, kind=LayerKind.OUTPUT, n_out=3,
                      activation="softmax", loss_function="mcxent",
                      dropout=0.0)
            .pretrain(False).backward(True).build())
    rng = np.random.RandomState(0)
    batches = []
    for b in range(4):
        x = rng.randn(16, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)]
        batches.append(DataSet(torch.from_numpy(x), torch.from_numpy(y)))

    class Term(IterationListener):
        def iteration_done(self, model, iteration, score):
            if iteration == 6:
                os.kill(os.getpid(), signal.SIGTERM)

    net = MultiLayerNetwork(conf, device="cpu").init(seed=8)
    net.set_listeners([Term()])
    d = ResilientFit(net, ResilienceConfig(checkpoint_dir={ckdir!r},
                                           checkpoint_every=4))
    d.fit(batches, num_epochs=3, seed=3)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "deeplearning4j_tpu"))
    print(json.dumps({{"preempted": d.preempted, "steps": d.steps_run,
                      "latest": d.manager.latest_step(), "jax": bad}}))
""")


def test_sigterm_drill_in_a_subprocess_then_resume(tmp_path):
    """A torch process on the CPU gets SIGTERM at step 6: it stops at the
    next boundary with one final snapshot and exits 0; a resume in this
    process ends equal to an uninterrupted run."""
    ckdir = str(tmp_path / "drill")
    code = _DRILL.format(repo=str(REPO), ckdir=ckdir)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"preempted": True, "steps": 7, "latest": 7, "jax": []}
    _fresh()
    resumed = _net(8)
    ResilientFit(resumed, ResilienceConfig(
        checkpoint_dir=ckdir, checkpoint_every=4, resume=True)).fit(
            _batches(4), num_epochs=3, seed=3)
    full = _net(8)
    ResilientFit(full, ResilienceConfig(
        checkpoint_dir=str(tmp_path / "full"), checkpoint_every=4)).fit(
            _batches(4), num_epochs=3, seed=3)
    assert torch.equal(resumed.params_flat(), full.params_flat())


# -- the port imports no JAX ---------------------------------------------------

def test_resilience_imports_no_jax():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.runtime.resilience\n"
            "import deeplearning4j_tpu_torch.nn.multilayer\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), \
        res.stdout + res.stderr
