"""The port's scale-out SPI, in-process runner, ``IRUnitDriver``, library
performers and chaos performer against the JAX package, on the CPU.

After ``tests/test_scaleout.py`` and ``tests/test_chaos.py``: the real
runtime in one process with a fake performer, then with the library
``MultiLayerNetworkPerformer``, then the BSP supersteps on Iris.  Held
against the reference where the result is deterministic:

- ``WorkAccumulator`` on the same numpy trees: the running means
  (rtol 1e-6; both compute ``a + (r - a) / n`` in fp32), which results
  it rejects (non-finite, corrupt, structurally mismatched) and the
  counts it books;
- the runners' results on fake workloads (IterativeReduce keeps the
  last round's mean, HogWild folds as results arrive), the requeue of
  failed jobs, the retry cap's drop, the master pump's timeout that
  publishes what finished: equal;
- ``IRUnitDriver`` on Iris, three BSP supersteps of three workers from
  the same initial params (carried by ``nn/params.params_from_numpy``):
  the averaged params within 1e-5 (``tests/test_torch_lenet.py``'s fp32
  params tolerance);
- one ``MultiLayerNetworkPerformer.perform`` from the same params:
  within 1e-5;
- under ``chaos_factory``: every job's contribution exactly once under
  crashes, and every corrupted result rejected and counted.
"""

import itertools

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.parallel import coordinator as tc
from deeplearning4j_tpu_torch.parallel import scaleout as so
from deeplearning4j_tpu_torch.parallel.chaos import chaos_factory
from deeplearning4j_tpu_torch.parallel.coordinator import Job, StateTracker
from deeplearning4j_tpu_torch.runtime.metrics import resilience_metrics
from test_torch_paged import assert_no_jax

torch.set_num_threads(2)

PARAM_TOL = 1e-5
MEAN_RTOL = 1e-6


# ---------------------------------------------------------------------------
# WorkAccumulator
# ---------------------------------------------------------------------------

def _tree(rng, shape=(3,)):
    return {"w": rng.standard_normal(shape).astype(np.float32),
            "b": [rng.standard_normal(2).astype(np.float32)]}


def _results(case):
    """The posted results of a case, numpy trees (and corrupt ones)."""
    rng = np.random.default_rng(7)
    good = [_tree(rng) for _ in range(4)]
    nan = _tree(rng)
    nan["w"][1] = np.nan
    return {
        "means": good,
        "nonfinite": [good[0], nan, good[1]],
        "keys": [good[0], {"v": good[1]["w"], "b": good[1]["b"]}, good[2]],
        "kinds": [good[0], {"w": good[1]["w"], "b": tuple(good[1]["b"])}],
        "shapes": [good[0], _tree(rng, (4,)), good[1]],
        "corrupt_first": ["not a param tree at all", good[0], good[1]],
        "none": [None, good[0], None, good[1]],
    }[case]


def _accumulate(mod_so, mod_c, results):
    resilience_metrics.reset()
    tracker = mod_c.StateTracker()
    acc = mod_so.WorkAccumulator()
    acc.bind_tracker(tracker)
    for i, r in enumerate(results):
        acc.accumulate(mod_c.Job(work=None, worker_id=f"w{i}", result=r))
    agg = acc.aggregate()
    flat = (None if agg is None else
            [np.asarray(agg["w"])] + [np.asarray(x) for x in agg["b"]])
    return flat, acc.rejected, tracker.count("updates_rejected")


@pytest.mark.parametrize("case", ["means", "nonfinite", "keys", "kinds",
                                  "shapes", "corrupt_first", "none"])
def test_work_accumulator_matches_reference(case):
    from deeplearning4j_tpu.parallel import coordinator as jc
    from deeplearning4j_tpu.parallel import scaleout as jso
    from deeplearning4j_tpu.runtime.metrics import \
        resilience_metrics as jmetrics

    got = _accumulate(so, tc, _results(case))
    port_noted = resilience_metrics.count("updates_rejected")
    jmetrics.reset()
    want = _accumulate(jso, jc, _results(case))
    assert got[1:] == want[1:]
    assert port_noted == jmetrics.count("updates_rejected") == got[1]
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=MEAN_RTOL, atol=0)
    if case == "means":
        np.testing.assert_allclose(
            got[0][0], np.mean([r["w"] for r in _results(case)], 0),
            rtol=MEAN_RTOL)


def test_work_accumulator_averages_tensor_trees():
    """The running mean over trees of tensors (what in-process performers
    post) equals the numpy one."""
    rng = np.random.default_rng(3)
    trees = [_tree(rng) for _ in range(3)]
    acc, ref = so.WorkAccumulator(), so.WorkAccumulator()
    for t in trees:
        acc.accumulate(Job(work=None, result={
            "w": torch.from_numpy(t["w"]),
            "b": [torch.from_numpy(t["b"][0])]}))
        ref.accumulate(Job(work=None, result=t))
    np.testing.assert_array_equal(acc.aggregate()["w"].numpy(),
                                  ref.aggregate()["w"])


# ---------------------------------------------------------------------------
# the runner on fake workloads (both packages)
# ---------------------------------------------------------------------------

def _fake(mod_so):
    class DoublePerformer(mod_so.WorkerPerformer):
        def perform(self, job):
            job.result = 2.0 * job.work

    class MeanAggregator(mod_so.JobAggregator):
        def __init__(self):
            self.vals = []

        def accumulate(self, job):
            if job.result is not None:
                self.vals.append(job.result)

        def aggregate(self):
            return sum(self.vals) / len(self.vals) if self.vals else None

        def reset(self):
            self.vals = []

    return DoublePerformer, MeanAggregator


def _run_fake(mod_so, case):
    perf, agg = _fake(mod_so)
    if case == "iterative_reduce":
        runner = mod_so.DistributedRunner(
            mod_so.CollectionJobIterator([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]),
            perf, agg(), n_workers=3)
    elif case == "hogwild":
        runner = mod_so.DistributedRunner(
            mod_so.CollectionJobIterator(list(map(float, range(1, 9)))),
            perf, agg(), n_workers=2, router_cls=mod_so.HogWildWorkRouter)
    elif case == "flaky":
        counter = itertools.count()

        class Flaky(mod_so.WorkerPerformer):
            def perform(self, job):
                if next(counter) < 2:          # the first two attempts die
                    raise RuntimeError("injected fault")
                job.result = 2.0 * job.work

        runner = mod_so.DistributedRunner(
            mod_so.CollectionJobIterator([1.0, 2.0, 3.0]), Flaky, agg(),
            n_workers=2)
    else:
        class Poison(mod_so.WorkerPerformer):
            def perform(self, job):
                if job.work == 13.0:
                    raise RuntimeError("always fails")
                job.result = 2.0 * job.work

        runner = mod_so.DistributedRunner(
            mod_so.CollectionJobIterator([1.0, 13.0, 3.0]), Poison, agg(),
            n_workers=2, router_cls=mod_so.HogWildWorkRouter,
            max_job_retries=3)
    result = runner.run(timeout_s=30)
    t = runner.tracker
    return (result, t.count("jobs_done"), t.count("jobs_failed"),
            t.count("jobs_dropped"), len(t.workers()))


@pytest.mark.parametrize("case,want", [
    ("iterative_reduce", (10.0, 6, 0, 0, 3)),   # the last round's mean
    ("hogwild", (9.0, 8, 0, 0, 2)),
    ("flaky", (None, 3, 2, 0, 2)),
    ("poison", ((2.0 + 6.0) / 2, 2, 4, 1, 2))])
def test_runner_matches_reference(case, want):
    from deeplearning4j_tpu.parallel import scaleout as jso
    got = _run_fake(so, case)
    ref = _run_fake(jso, case)
    if case == "flaky":                          # the round that survived
        assert got[0] is not None and ref[0] is not None
        got, ref, want = got[1:], ref[1:], want[1:]
    assert got == ref == want


def test_master_pump_timeout_publishes_partial_and_reports_counts():
    """A wedged run keeps what finished: the pump publishes it, then
    raises naming the queued, in-flight and worker counts."""
    tracker = StateTracker()
    tracker.add_worker("w0")
    done = Job(work=[1, 2], worker_id="w0", result=3)
    tracker.add_update("w0", done)

    class Sum(so.JobAggregator):
        total = 0

        def accumulate(self, job):
            self.total += job.result

        def aggregate(self):
            return self.total

    with pytest.raises(TimeoutError) as exc:
        so.master_pump(tracker, so.CollectionJobIterator([[9, 9]]), Sum(),
                       so.IterativeReduceWorkRouter(tracker),
                       n_slots=lambda: 1, poll=0.01, timeout_s=0.3)
    msg = str(exc.value)
    assert "queued" in msg and "in-flight" in msg and "worker" in msg
    assert tracker.get_current() == 3


def test_update_saver_work_retriever_and_updateable():
    s = so.UpdateSaver()
    s.save("w1", {"a": np.ones(3)})
    assert s.ids() == ["w1"]
    np.testing.assert_allclose(s.load("w1")["a"], np.ones(3))
    assert s.load("w1") is None                  # consumed
    r = so.WorkRetriever()
    r.save("w1", "d1")
    r.save("w1", "d2")
    assert [r.load("w1"), r.load("w1"), r.load("w1")] == ["d1", "d2", None]
    u = so.ParameterVectorUpdateable({"w": torch.ones(2)})
    v = so.ParameterVectorUpdateable()
    v.from_bytes(u.to_bytes())
    assert torch.equal(v.get()["w"], torch.ones(2))
    with pytest.raises(ValueError):
        so.IRUnitDriver(so.ComputableMaster(), [so.ComputableWorker()],
                        [1, 2])


# ---------------------------------------------------------------------------
# real models: IRUnit on Iris and the library performer
# ---------------------------------------------------------------------------

def _iris_conf(conf_mod):
    K = conf_mod.LayerKind
    return (conf_mod.NeuralNetConfiguration.builder()
            .n_in(4).lr(0.1).num_iterations(30).use_adagrad(False)
            .activation("tanh").compute_dtype("float32")
            .list(2).hidden_layer_sizes(10)
            .override(1, kind=K.OUTPUT, n_out=3,
                      activation="softmax", loss_function="mcxent")
            .pretrain(False).backward(True).build())


def _iris():
    """Iris, normalized and shuffled, as numpy (both packages' fetchers
    give the same rows)."""
    from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataFetcher
    f = IrisDataFetcher()
    f.fetch(150)
    data = f.next().normalize_zero_mean_unit_variance().shuffle(0)
    return np.asarray(data.features), np.asarray(data.labels)


def _splits(ds_cls, n=3):
    x, y = _iris()
    k = len(x) // n
    return [ds_cls(x[i * k:(i + 1) * k], y[i * k:(i + 1) * k])
            for i in range(n)]


def _jax_start():
    """The reference's Iris net at seed 1 and its params as numpy."""
    import jax
    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    net = JNet(_iris_conf(jconf)).init(seed=1)
    return net, jax.tree.map(np.asarray, net.params)


def _np(params):
    return [{k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in p.items()} for p in params]


def _assert_params_close(got, ref):
    for i, (t, j) in enumerate(zip(_np(got), _np(ref))):
        assert sorted(t) == sorted(j)
        for k in t:
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=PARAM_TOL,
                                       err_msg=f"layer {i} {k}")


def _irunit(mod_so, make_net, ds_cls, tree_avg, mesh_kw):
    class IrisWorker(mod_so.ComputableWorker):
        def __init__(self):
            self.net = make_net()

        def compute(self, split):
            self.net.fit_backprop(split, num_epochs=10, **mesh_kw)
            return mod_so.ParameterVectorUpdateable(self.net.params)

        def update(self, master_update):
            self.net.params = master_update.get()

    class AveragingMaster(mod_so.ComputableMaster):
        def compute(self, updates, previous):
            return mod_so.ParameterVectorUpdateable(
                tree_avg([u.get() for u in updates]))

    splits = _splits(ds_cls)
    bsp = mod_so.IRUnitDriver(AveragingMaster(),
                              [IrisWorker() for _ in splits], splits,
                              iterations=3)
    return bsp.run().get()


def test_irunit_iris_bsp_matches_reference():
    """Three BSP supersteps, three workers, from the same params: the
    averaged params within 1e-5 of the reference's, and they classify
    Iris (the reference test's accuracy bar)."""
    import jax
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.params import params_from_numpy
    from deeplearning4j_tpu.parallel import scaleout as jso

    _, start = _jax_start()

    def jnet():
        net = JNet(_iris_conf(jconf)).init(seed=1)
        return net

    def tnet():
        return MultiLayerNetwork(_iris_conf(tconf),
                                 params=params_from_numpy(start, "cpu"),
                                 device="cpu")

    def javg(trees):
        return jax.tree.map(lambda *ps: sum(ps) / float(len(ps)), *trees)

    def tavg(trees):
        from deeplearning4j_tpu_torch.ops.updaters import tree_map
        return tree_map(lambda *ps: sum(ps) / float(len(ps)), *trees)

    ref = _irunit(jso, jnet, JDataSet, javg, {"mesh": None})
    got = _irunit(so, tnet, DataSet, tavg, {})
    _assert_params_close(got, ref)
    x, y = _iris()
    net = tnet()
    net.params = got
    assert net.evaluate(DataSet(x, y)).accuracy() > 0.8


def test_multilayer_network_performer_matches_reference():
    """One job of the library performer, rebuilt from the conf's JSON and
    handed the reference's params by ``update`` (numpy, as over the
    wire): its params within 1e-5 of the reference performer's."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.parallel import coordinator as jc
    from deeplearning4j_tpu.parallel import performers as jperf
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.parallel import performers as tperf

    _, start = _jax_start()
    x, y = _iris()
    jp = jperf.MultiLayerNetworkPerformer(_iris_conf(jconf).to_json(),
                                          num_epochs=10)
    jp.update(start)
    jjob = jc.Job(work=JDataSet(x[:50], y[:50]))
    jp.perform(jjob)
    tp = tperf.MultiLayerNetworkPerformer(_iris_conf(tconf).to_json(),
                                          num_epochs=10, device="cpu")
    tp.update(start)
    tjob = Job(work=DataSet(x[:50], y[:50]))
    tp.perform(tjob)
    assert all(isinstance(v, torch.Tensor) for p in tjob.result
               for v in p.values())
    _assert_params_close(tjob.result, jjob.result)


def test_runner_trains_multilayer_network_param_averaging():
    """The flagship workload through the library performer and the
    ``ParameterAveragingAggregator`` (tests/test_scaleout.py:110): three
    jobs of 50 rows, the averaged params classify Iris."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.performers import (
        MultiLayerNetworkPerformer, ParameterAveragingAggregator)

    conf_json = _iris_conf(tconf).to_json()
    runner = so.DistributedRunner(
        so.CollectionJobIterator(_splits(DataSet)),
        lambda: MultiLayerNetworkPerformer(conf_json, num_epochs=10,
                                           device="cpu"),
        ParameterAveragingAggregator(), n_workers=3)
    averaged = runner.run(timeout_s=120)
    assert runner.tracker.count("jobs_done") == 3
    net = MultiLayerNetwork(_iris_conf(tconf), device="cpu").init(seed=0)
    net.params = averaged
    x, y = _iris()
    assert net.evaluate(DataSet(x, y)).accuracy() > 0.7


# ---------------------------------------------------------------------------
# under the chaos performer
# ---------------------------------------------------------------------------

class SumPerformer(so.WorkerPerformer):
    def perform(self, job):
        job.result = sum(job.work)


class SumAggregator(so.JobAggregator):
    def __init__(self):
        self.total = 0

    def accumulate(self, job):
        self.total += job.result

    def aggregate(self):
        return self.total


class ArrayPerformer(so.WorkerPerformer):
    """A params-like tree: the shard's mean times ones."""

    def perform(self, job):
        job.result = {"w": torch.tensor(job.work).mean() * torch.ones(3)}


def test_runner_completes_under_injected_crashes():
    """20 jobs, 25% injected crashes: every job's contribution arrives
    exactly once (the retry budget raised, as the reference's test)."""
    shards = [[i, i + 1] for i in range(0, 40, 2)]
    runner = so.DistributedRunner(
        so.CollectionJobIterator(shards),
        chaos_factory(SumPerformer, p_fail=0.25, seed=3),
        SumAggregator(), n_workers=3,
        router_cls=so.HogWildWorkRouter, max_job_retries=100)
    assert runner.run(timeout_s=60.0) == sum(sum(s) for s in shards)
    assert runner.tracker.count("jobs_dropped") == 0
    assert runner.tracker.count("jobs_failed") > 0


def test_corrupt_worker_results_rejected_end_to_end():
    """The corrupt hook NaNs results mid-run: the aggregate stays finite
    and every corruption is counted as a rejection."""
    resilience_metrics.reset()
    shards = [[float(i), float(i + 1)] for i in range(0, 16, 2)]
    factory = chaos_factory(ArrayPerformer, p_corrupt=0.5,
                            corrupt=lambda r: {"w": r["w"] * np.nan},
                            seed=11)
    runner = so.DistributedRunner(
        so.CollectionJobIterator(shards), factory, so.WorkAccumulator(),
        n_workers=2, router_cls=so.HogWildWorkRouter)
    agg = runner.run(timeout_s=60.0)
    n_corrupt = sum(p.injected["corrupt"] for p in factory.instances)
    assert n_corrupt >= 1
    assert bool(torch.isfinite(agg["w"]).all())
    assert runner.tracker.count("updates_rejected") == n_corrupt
    assert resilience_metrics.count("updates_rejected") == n_corrupt


def test_runner_under_thread_contention_loses_no_update():
    """More worker threads than cores and a short switch interval: every
    job is counted done exactly once, and the HogWild fold of every
    result arrives (a lost update in the tracker would break the sum)."""
    import sys
    import threading

    shards = [[i] for i in range(400)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runner = so.DistributedRunner(
            so.CollectionJobIterator(shards), SumPerformer,
            SumAggregator(), n_workers=16,
            router_cls=so.HogWildWorkRouter, poll_interval_s=0.0005)
        total = runner.run(timeout_s=60.0)
    finally:
        sys.setswitchinterval(old)
    assert total == sum(range(400))
    assert runner.tracker.count("jobs_done") == 400
    assert runner.tracker.pending_counts() == (0, 0)
    # every worker thread has ended (they are named after their target)
    assert not [t for t in threading.enumerate() if "_worker_loop" in t.name]


def test_hash01_bit_equal_to_reference():
    """The fault schedule's hash over 10,000 (seed, n) pairs: bit-equal
    floats."""
    from deeplearning4j_tpu.parallel.chaos import _hash01 as jhash
    from deeplearning4j_tpu_torch.parallel.chaos import _hash01 as thash

    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2 ** 40, 100)
    pairs = [(int(s), int(n)) for s in seeds for n in range(100)]
    got = np.array([thash(s, n) for s, n in pairs])
    want = np.array([jhash(s, n) for s, n in pairs])
    assert got.tobytes() == want.tobytes()
    assert 0.0 <= got.min() and got.max() < 1.0


def test_scaleout_modules_import_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.parallel.scaleout",
                  "deeplearning4j_tpu_torch.parallel.performers",
                  "deeplearning4j_tpu_torch.parallel.chaos")
