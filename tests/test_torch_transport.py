"""The port's cross-process control plane, on the CPU: the socket-served
StateTracker, worker processes joining by connection string, and crash
recovery through the stale-worker reaper.

After ``tests/test_transport.py``.  The same script of tracker calls
through the port's server and through the JAX package's (which imports
no JAX) reads back the same values; the rest is the reference's
behaviour: an unauthenticated client is refused before any pickle, a
private or unknown method is refused and a bad call's error comes back,
``"module:callable"`` specs resolve, worker processes (``spawn``) drain
the queue, a worker killed mid-job (``os._exit``) has its job requeued
by the reaper and done by a peer, a worker that joins mid-run takes the
gated half, ``MultiLayerNetworkPerformer`` trains across processes with
its params crossing the wire as numpy arrays, and ``worker_main``'s
join retries give up cleanly or win against a late server.  Tensors
cross the wire as numpy arrays both ways.

The performers the worker processes build live in this module (spawned
workers import it by its ``"module:callable"`` spec); it imports no JAX
at its top, and nothing that does.  Each spawned run has its own time
limit (the runner's ``timeout_s`` and ``join_timeout_s``).
"""

import multiprocessing
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.parallel import scaleout as so
from deeplearning4j_tpu_torch.parallel import transport as tp
from deeplearning4j_tpu_torch.parallel.coordinator import Job
from deeplearning4j_tpu_torch.runtime.metrics import resilience_metrics

torch.set_num_threads(2)

#: the limit of each spawned run, seconds
RUN_S = 60.0


# -- the workers' performers -------------------------------------------------

class SquarePerformer(so.WorkerPerformer):
    """result = work ** 2."""

    def perform(self, job: Job) -> None:
        job.result = float(job.work) ** 2


class CrashOncePerformer(so.WorkerPerformer):
    """Ends its WHOLE process the first time it sees the poison job (no
    handler can run), so recovery must come from the master's reaper; a
    marker file makes it once only."""

    def __init__(self, marker_path: str, poison: float = 13.0):
        self.marker_path = marker_path
        self.poison = poison

    def perform(self, job: Job) -> None:
        if float(job.work) == self.poison and not os.path.exists(
                self.marker_path):
            with open(self.marker_path, "w") as f:
                f.write("crashed")
            os._exit(3)
        job.result = float(job.work) ** 2


class GateWaitPerformer(so.WorkerPerformer):
    """Squares; the "gate" job blocks until a marker file appears."""

    def __init__(self, marker_path: str):
        self.marker_path = marker_path

    def perform(self, job: Job) -> None:
        if job.work == "gate":
            while not os.path.exists(self.marker_path):
                time.sleep(0.01)
            job.result = "gate-done"
            return
        job.result = float(job.work) ** 2


class CollectSetAggregator:
    """The union of every result seen (never reset)."""

    def __init__(self):
        self.seen = set()

    def accumulate(self, job) -> None:
        if job.result is not None:
            self.seen.add(job.result)

    def aggregate(self):
        return sorted(self.seen) if self.seen else None

    def reset(self) -> None:
        pass


# -- the RPC layer -----------------------------------------------------------

def _roundtrip(tp_mod, job_cls):
    """Every tracker primitive through a socket; what the client reads."""
    seen = []
    with tp_mod.StateTrackerServer() as server:
        with tp_mod.RemoteStateTracker(server.connection_string,
                                       authkey=server.authkey) as remote:
            remote.add_worker("w1")
            seen.append(remote.workers())
            seen.append(remote.heartbeat("w1"))
            seen.append("w1" in remote.heartbeats())
            remote.add_job(job_cls(work=3.0))
            seen.append(remote.has_pending())
            job = remote.job_for("w1")
            seen.append((job.work, job.worker_id, remote.pending_counts()))
            job.result = 9.0
            remote.add_update("w1", job)
            remote.clear_job("w1")
            seen.append(remote.has_pending())
            seen.append([u.result for u in remote.drain_updates()])
            remote.set_current({"params": [1.0, 2.0]})
            seen.append(remote.get_current())
            seen.append(remote.needs_replicate("w1"))
            remote.done_replicating("w1")
            seen.append(remote.needs_replicate("w1"))
            remote.increment("jobs_done", 2)
            seen.append(remote.count("jobs_done"))
            seen.append(remote.is_done())
            remote.set_done()
            seen.append(remote.is_done())
            seen.append(server.tracker.count("jobs_done"))
    return seen


def test_remote_tracker_roundtrip_matches_reference():
    from deeplearning4j_tpu.parallel import coordinator as jc
    from deeplearning4j_tpu.parallel import transport as jtp
    assert _roundtrip(tp, Job) == _roundtrip(jtp, jc.Job)


def test_tensors_cross_the_wire_as_numpy():
    """A tensor argument reaches the tracker as a numpy array; a tensor
    the tracker holds comes back as one (bf16 as a CPU tensor)."""
    with tp.StateTrackerServer() as server:
        with tp.RemoteStateTracker(server.connection_string,
                                   authkey=server.authkey) as remote:
            remote.set_current([{"W": torch.arange(4.0)}])
            held = server.tracker.get_current()
            assert isinstance(held[0]["W"], np.ndarray)
            np.testing.assert_array_equal(held[0]["W"], np.arange(4.0))
            server.tracker.set_current({"a": torch.ones(2),
                                        "h": torch.ones(2,
                                                        dtype=torch.bfloat16)})
            back = remote.get_current()
            assert isinstance(back["a"], np.ndarray)
            assert back["h"].dtype == torch.bfloat16
            remote.add_worker("w")
            remote.add_job(Job(work=torch.zeros(3)))
            job = remote.job_for("w")
            assert isinstance(job.work, np.ndarray)
            job.result = {"g": torch.full((2,), 5.0)}
            assert remote.complete_job("w", job)
            (done,) = server.tracker.drain_updates()
            assert isinstance(done.result["g"], np.ndarray)


def test_remote_tracker_rejects_unknown_and_propagates_errors():
    with tp.StateTrackerServer() as server:
        with tp.RemoteStateTracker(server.connection_string,
                                   authkey=server.authkey) as remote:
            with pytest.raises(AttributeError):
                remote._call("_requeue_locked", "w1")   # private
            with pytest.raises(AttributeError):
                remote._call("no_such_method")
            with pytest.raises(TypeError):
                remote.increment()                       # bad arity


def test_remote_tracker_requires_authkey():
    """HMAC-authenticated: a wrong key is refused before any payload."""
    with tp.StateTrackerServer() as server:
        with pytest.raises(multiprocessing.AuthenticationError):
            tp.RemoteStateTracker(server.connection_string,
                                  authkey=b"wrong-key")
        with tp.RemoteStateTracker(server.connection_string,
                                   authkey=server.authkey) as remote:
            remote.increment("ok")
            assert remote.count("ok") == 1


def test_performer_spec_resolution():
    p = tp.resolve_performer_factory("test_torch_transport:SquarePerformer")()
    job = Job(work=4.0)
    p.perform(job)
    assert job.result == 16.0
    made = tp.resolve_performer_factory(
        ("test_torch_transport:CrashOncePerformer", ("/tmp/x",), {}))()
    assert made.marker_path == "/tmp/x"
    perf = tp.resolve_performer_factory(
        ("deeplearning4j_tpu_torch.parallel.performers:"
         "MultiLayerNetworkPerformer", (_iris_conf_json(),),
         {"num_epochs": 1, "device": "cpu"}))()
    assert perf.net.device == torch.device("cpu")
    assert tp.resolve_performer_factory(SquarePerformer) is SquarePerformer
    with pytest.raises(ValueError):
        tp.resolve_performer_factory("not-a-spec")


# -- the multi-process runner ------------------------------------------------

def test_multiprocess_runner_completes_jobs():
    """Three worker PROCESSES drain the queue through the socket."""
    jobs = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    runner = tp.MultiProcessRunner(
        so.CollectionJobIterator(jobs),
        ("test_torch_transport:SquarePerformer", (), {}),
        CollectSetAggregator(), n_workers=3,
        router_cls=so.HogWildWorkRouter)
    assert runner.run(timeout_s=RUN_S) == [x * x for x in jobs]
    assert runner.tracker.count("jobs_done") == 6
    assert len(runner.tracker.workers()) == 3
    assert all(not p.is_alive() for p in runner.processes)


def test_multiprocess_worker_crash_requeues_and_completes(tmp_path):
    """A worker process dies mid-job: its heartbeats stop, the reaper
    drops it and requeues the job, a surviving worker does it."""
    marker = str(tmp_path / "crashed.marker")
    jobs = [1.0, 2.0, 13.0, 4.0, 5.0, 6.0]        # 13.0 is the poison
    runner = tp.MultiProcessRunner(
        so.CollectionJobIterator(jobs),
        ("test_torch_transport:CrashOncePerformer", (marker,), {}),
        CollectSetAggregator(), n_workers=3,
        router_cls=so.HogWildWorkRouter, stale_after_s=1.5)
    assert runner.run(timeout_s=RUN_S) == sorted(x * x for x in jobs)
    assert runner.tracker.count("jobs_done") == 6
    assert runner.tracker.count("workers_reaped") >= 1
    assert sorted(p.exitcode for p in runner.processes)[-1] == 3


def _iris_conf_json():
    from deeplearning4j_tpu_torch.nn.conf import (LayerKind,
                                                  NeuralNetConfiguration)
    return (NeuralNetConfiguration.builder()
            .n_in(4).lr(0.1).num_iterations(30).use_adagrad(False)
            .activation("tanh").compute_dtype("float32")
            .list(2).hidden_layer_sizes(10)
            .override(1, kind=LayerKind.OUTPUT, n_out=3,
                      activation="softmax", loss_function="mcxent")
            .pretrain(False).backward(True).build().to_json())


def test_multiprocess_mln_param_averaging():
    """The library performer rebuilt from the conf's JSON in each worker
    process (on the CPU, its spec's ``device``); the params come back as
    numpy arrays and their average classifies Iris."""
    from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataFetcher
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.performers import (
        ParameterAveragingAggregator, params_on)

    f = IrisDataFetcher()
    f.fetch(150)
    data = f.next().normalize_zero_mean_unit_variance().shuffle(0)
    conf = _iris_conf_json()
    runner = tp.MultiProcessRunner(
        so.CollectionJobIterator(data.batch_by(75)),
        ("deeplearning4j_tpu_torch.parallel.performers:"
         "MultiLayerNetworkPerformer", (conf,),
         {"num_epochs": 10, "device": "cpu"}),
        ParameterAveragingAggregator(), n_workers=2, stale_after_s=30.0)
    averaged = runner.run(timeout_s=RUN_S, join_timeout_s=RUN_S)
    assert isinstance(averaged[0]["W"], np.ndarray)
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf),
                            device="cpu").init(seed=0)
    net.params = params_on(averaged, torch.device("cpu"))
    assert net.evaluate(data).accuracy() > 0.7


def test_worker_joins_mid_run_and_shares_work(tmp_path):
    """A worker that joins by connection string after the run started is
    given work: a "gate" job holds the first worker until the late one
    registers, the second half appears only then, and the first worker
    is disabled at the gate, so the late joiner does that half."""
    marker = str(tmp_path / "joined.marker")
    first, second = [1.0, 2.0, "gate"], [4.0, 5.0, 6.0, 7.0]
    spec = ("test_torch_transport:GateWaitPerformer", (marker,), {})

    class GatedIterator(so.JobIterator):
        def __init__(self):
            self._i = 0

        def _avail(self):
            items = list(first)
            if "late-joiner" in runner.tracker.workers():
                runner.tracker.enable_worker("proc-worker-0", False)
                items += second
            return items

        def has_next(self):
            return self._i < len(self._avail())

        def next(self, worker_id):
            job = Job(work=self._avail()[self._i], worker_id=worker_id)
            self._i += 1
            return job

        def reset(self):
            self._i = 0

    class ByWorkerAggregator:
        def __init__(self):
            self.by_worker = {}

        def accumulate(self, job):
            self.by_worker.setdefault(job.worker_id, set()).add(job.result)

        def aggregate(self):
            return self.by_worker

        def reset(self):
            pass

    runner = tp.MultiProcessRunner(GatedIterator(), spec,
                                   ByWorkerAggregator(), n_workers=1,
                                   router_cls=so.HogWildWorkRouter)
    late = {}

    def join_late():
        while not runner.tracker.workers():
            time.sleep(0.01)
        ctx = multiprocessing.get_context("spawn")
        p = ctx.Process(target=tp.worker_main,
                        args=(runner.connection_string, spec),
                        kwargs={"worker_id": "late-joiner",
                                "authkey": runner.server.authkey},
                        daemon=True)
        p.start()
        late["p"] = p
        while "late-joiner" not in runner.tracker.workers():
            time.sleep(0.01)
        open(marker, "w").write("joined")

    t = threading.Thread(target=join_late, daemon=True)
    t.start()
    result = runner.run(timeout_s=RUN_S)
    t.join(10)
    late["p"].join(10)
    assert not late["p"].is_alive()
    assert set().union(*result.values()) == {1.0, 4.0, "gate-done"} | {
        x * x for x in second}
    assert runner.tracker.count("jobs_done") == len(first) + len(second)
    assert result.get("late-joiner", set()) >= {x * x for x in second}


# -- worker_main's join retries ----------------------------------------------

def test_worker_main_join_retry_gives_up_cleanly():
    """No server: worker_main spends its retries and RETURNS."""
    resilience_metrics.reset()
    t0 = time.perf_counter()
    tp.worker_main("127.0.0.1:1", "test_torch_transport:SquarePerformer",
                   worker_id="orphan", join_retries=2, join_backoff_s=0.01)
    assert time.perf_counter() - t0 < 30
    assert resilience_metrics.count("worker_join_retries") == 2


def test_worker_main_join_retry_wins_race_against_late_server():
    """The listener comes up after the worker's first attempts: a retry
    joins and the worker does a job."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    authkey = b"retry-test"
    box = {}

    def bring_up_late():
        time.sleep(0.3)
        server = tp.StateTrackerServer(host="127.0.0.1", port=port,
                                       authkey=authkey).start()
        server.tracker.add_job(Job(work=5.0))
        box["server"] = server

    t = threading.Thread(target=bring_up_late, daemon=True)
    t.start()
    worker = threading.Thread(
        target=tp.worker_main,
        args=(f"127.0.0.1:{port}", "test_torch_transport:SquarePerformer"),
        kwargs={"worker_id": "retrier", "join_retries": 8,
                "join_backoff_s": 0.1, "authkey": authkey}, daemon=True)
    worker.start()
    t.join(10)
    server = box["server"]
    try:
        deadline = time.time() + 20
        while time.time() < deadline and not server.tracker.updates():
            time.sleep(0.02)
        assert server.tracker.workers() == ["retrier"]
        assert [u.result for u in server.tracker.updates()] == [25.0]
    finally:
        server.tracker.set_done()
        worker.join(10)
        server.shutdown()


def test_transport_imports_no_jax():
    from test_torch_paged import assert_no_jax   # it imports JAX
    assert_no_jax("deeplearning4j_tpu_torch.parallel.transport")
