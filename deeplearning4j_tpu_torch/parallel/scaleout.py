"""Transport-agnostic scale-out SPI and the in-process distributed runner.

Port of ``deeplearning4j_tpu/parallel/scaleout.py``, in three pieces:

1. The SPI of ``deeplearning4j-scaleout-api``: ``Job`` /
   :class:`JobIterator` (scaleout/job/JobIterator.java:24),
   :class:`WorkerPerformer` (scaleout/perform/WorkerPerformer.java:27),
   :class:`JobAggregator` + :class:`WorkAccumulator`
   (scaleout/aggregator/), :class:`UpdateSaver` / :class:`WorkRetriever`
   (param blobs and per-worker datasets stored off the tracker), the
   :class:`WorkRouter` policies (IterativeReduce: synchronous rounds;
   HogWild: always send), :class:`Updateable`.

2. :class:`DistributedRunner`: the in-process form of the Akka topology
   (DeepLearning4jDistributed.setup:205 + MasterActor / WorkerActor /
   BatchActor): a master pump and N worker threads polling the
   :class:`~deeplearning4j_tpu_torch.parallel.coordinator.StateTracker`.
   On one card every worker thread drives the same device; the
   performers decide where their work runs (their ``device=``).

3. :class:`IRUnitDriver`: the YARN IterativeReduce simulation
   (runtime/irunit/IRUnitDriver.java): a :class:`ComputableMaster` and N
   :class:`ComputableWorker` s in BSP supersteps, no cluster.

Results are trees (nested dicts, lists and tuples) of tensors or numpy
arrays.  :class:`WorkAccumulator` averages them leaf by leaf through
``torch.utils._pytree``; a result whose float leaves are not all finite
(``runtime/resilience.result_all_finite``), or whose structure does not
match the round's, is rejected and counted (``updates_rejected`` in the
bound tracker and in ``resilience_metrics``).  The runner's telemetry
events keep the reference's names: ``scaleout.master_pump`` (a span),
``scaleout.workers_reaped``, ``scaleout.timeout``,
``scaleout.update_rejected`` and ``scaleout.worker_join``.

The data plane of real training is ``parallel/collectives.py``; this
module is the control plane and the orchestration harness.
"""

from __future__ import annotations

import logging
import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from torch.utils import _pytree as pytree

from deeplearning4j_tpu_torch.parallel.coordinator import Job, StateTracker

log = logging.getLogger(__name__)

__all__ = ["CollectionJobIterator", "ComputableMaster", "ComputableWorker",
           "DistributedRunner", "HogWildWorkRouter", "IRUnitDriver",
           "IterativeReduceWorkRouter", "Job", "JobAggregator",
           "JobIterator", "ParameterVectorUpdateable", "UpdateSaver",
           "Updateable", "WorkAccumulator", "WorkRetriever", "WorkRouter",
           "WorkerPerformer", "master_pump"]


# ---------------------------------------------------------------------------
# SPI
# ---------------------------------------------------------------------------

class JobIterator:
    """next(worker_id)/has_next/reset (JobIterator.java:24)."""

    def next(self, worker_id: str) -> Job:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class CollectionJobIterator(JobIterator):
    def __init__(self, items: Sequence[Any]):
        self.items = list(items)
        self._i = 0

    def next(self, worker_id: str) -> Job:
        job = Job(work=self.items[self._i], worker_id=worker_id)
        self._i += 1
        return job

    def has_next(self) -> bool:
        return self._i < len(self.items)

    def reset(self) -> None:
        self._i = 0


class WorkerPerformer:
    """perform(job) sets job.result; update(*) absorbs new global state
    (WorkerPerformer.java:27)."""

    def perform(self, job: Job) -> None:
        raise NotImplementedError

    def update(self, *args: Any) -> None:
        pass


class JobAggregator:
    """accumulate/aggregate (JobAggregator.java:30); ``reset`` starts a
    fresh round for synchronous routers.  ``bind_tracker`` hands the
    aggregator the master pump's tracker, so rejections land in the
    run's counters (a no-op for aggregators that do not care)."""

    def accumulate(self, job: Job) -> None:
        raise NotImplementedError

    def aggregate(self) -> Any:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def bind_tracker(self, tracker: StateTracker) -> None:
        pass


def _mean_step(n: int):
    """The running mean's leaf update ``a + (r - a) / n``; a None leaf
    must meet a None (the reference's trees have no leaf there)."""
    def step(a, r):
        if a is None or r is None:
            if a is None and r is None:
                return None
            raise ValueError("a None leaf against a value")
        return a + (r - a) / n
    return step


class WorkAccumulator(JobAggregator):
    """Running average of numeric results (WorkAccumulator.java:29),
    hardened: a posted result holding a non-finite value, or one so
    corrupt that it does not flatten, is REJECTED instead of averaged
    (one NaN worker would otherwise poison the round's aggregate and,
    through ``set_current``, every replica); so is a result whose tree
    does not match the round's.  Rejections add to the bound tracker's
    ``updates_rejected``, to ``resilience_metrics`` and to
    ``self.rejected``."""

    def __init__(self, tracker: Optional[StateTracker] = None):
        self._avg = None
        self._n = 0
        self.tracker = tracker
        #: how many posted results this accumulator refused
        self.rejected = 0

    def bind_tracker(self, tracker: StateTracker) -> None:
        self.tracker = tracker

    def reset(self) -> None:
        self._avg = None
        self._n = 0

    def _reject(self, job: Job, why: str) -> None:
        from deeplearning4j_tpu_torch.runtime import telemetry
        from deeplearning4j_tpu_torch.runtime.metrics import \
            resilience_metrics

        self.rejected += 1
        resilience_metrics.note("updates_rejected")
        if self.tracker is not None:
            self.tracker.increment("updates_rejected")
        telemetry.event("scaleout.update_rejected",
                        worker=str(job.worker_id), why=why)
        log.warning("rejecting %s result from worker %r; excluded from "
                    "the round average", why, job.worker_id)

    def accumulate(self, job: Job) -> None:
        from deeplearning4j_tpu_torch.runtime.resilience import \
            result_all_finite

        if job.result is None:
            return
        if not result_all_finite(job.result):
            self._reject(job, "non-finite/corrupt")
            return
        if self._avg is None:
            self._n += 1
            self._avg = job.result
            return
        try:
            n = self._n + 1
            avg = pytree.tree_map(_mean_step(n), self._avg, job.result)
        except Exception:  # noqa: BLE001
            # a result whose SHAPE does not match the round's (a truncated
            # payload, another tree) is corruption too: reject it rather
            # than crash the master pump mid-round
            self._reject(job, "structurally-mismatched")
            return
        self._n, self._avg = n, avg

    def aggregate(self) -> Any:
        return self._avg


class UpdateSaver:
    """Param blobs stored OFF the tracker (UpdateSaver.java:28): the
    tracker holds ids, the saver holds bytes."""

    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def save(self, worker_id: str, value: Any) -> None:
        with self._lock:
            self._store[worker_id] = pickle.dumps(value)

    def load(self, worker_id: str) -> Any:
        with self._lock:
            blob = self._store.pop(worker_id, None)
        return None if blob is None else pickle.loads(blob)

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._store)


class WorkRetriever:
    """Per-worker dataset storage (WorkRetriever.java:33)."""

    def __init__(self):
        self._store: Dict[str, List[Any]] = {}
        self._lock = threading.Lock()

    def save(self, worker_id: str, data: Any) -> None:
        with self._lock:
            self._store.setdefault(worker_id, []).append(data)

    def load(self, worker_id: str) -> Optional[Any]:
        with self._lock:
            queue = self._store.get(worker_id)
            return queue.pop(0) if queue else None


class Updateable:
    """Typed update envelope (api/ir/Updateable.java:26)."""

    def get(self) -> Any:
        raise NotImplementedError

    def set(self, value: Any) -> None:
        raise NotImplementedError

    def to_bytes(self) -> bytes:
        return pickle.dumps(self.get())

    def from_bytes(self, blob: bytes) -> None:
        self.set(pickle.loads(blob))


class ParameterVectorUpdateable(Updateable):
    """A tree-of-arrays payload (ParameterVectorUpdateable.java:34)."""

    def __init__(self, value: Any = None):
        self._value = value

    def get(self) -> Any:
        return self._value

    def set(self, value: Any) -> None:
        self._value = value


class WorkRouter:
    """When should the master push more work?
    (api/workrouter/WorkRouter.java:29)"""

    #: synchronous routers aggregate a whole round at once and REPLACE the
    #: global state with that round's aggregate; async routers fold
    #: updates in as they arrive
    synchronous_rounds = True

    def __init__(self, tracker: StateTracker):
        self.tracker = tracker

    def send_work(self) -> bool:
        raise NotImplementedError


class IterativeReduceWorkRouter(WorkRouter):
    """Synchronous rounds: new work only when every outstanding job
    reported back (IterativeReduceWorkRouter.java:32)."""

    synchronous_rounds = True

    def send_work(self) -> bool:
        return not self.tracker.has_pending()


class HogWildWorkRouter(WorkRouter):
    """Always send: async, lock-free (HogWildWorkRouter.java:30)."""

    synchronous_rounds = False

    def send_work(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# The master pump (MasterActor's steady-state loop), shared by the
# in-process runner below and the multi-process runner of transport.py
# ---------------------------------------------------------------------------

def master_pump(tracker: StateTracker, jobs: JobIterator,
                aggregator: JobAggregator, router: WorkRouter,
                n_slots: Callable[[], int], poll: float,
                timeout_s: float, reap: bool = False) -> Any:
    """The reference's master loop (MasterActor.java:104-137): collect
    results, publish round aggregates, push new work, and (``reap``)
    drop stale workers, requeueing their jobs (:139-169).

    ``n_slots`` is how many jobs one round may hold, read every pass
    (worker processes join and die).  Synchronous routers REPLACE the
    current value with each round's aggregate; async ones fold updates
    in as they arrive.  On timeout the completed but unpublished
    updates are published FIRST, and the error names the queued,
    in-flight and worker counts."""
    from deeplearning4j_tpu_torch.runtime import telemetry

    deadline = time.time() + timeout_s
    sync = router.synchronous_rounds
    round_jobs: List[Job] = []
    # the tracker, so rejections land in the run's counters; duck-typed
    # aggregators without the hook are fine
    bind = getattr(aggregator, "bind_tracker", None)
    if callable(bind):
        bind(tracker)

    def publish(jobs_done: List[Job]) -> None:
        if not jobs_done:
            return
        if sync:
            aggregator.reset()
        for job in jobs_done:
            aggregator.accumulate(job)
        agg = aggregator.aggregate()
        if agg is not None:
            tracker.set_current(agg)

    with telemetry.span("scaleout.master_pump", timeout_s=timeout_s):
        while time.time() < deadline:
            if reap:
                removed = tracker.remove_stale_workers()
                if removed:
                    log.warning("reaped stale workers %s; jobs requeued",
                                removed)
                    tracker.increment("workers_reaped", len(removed))
                    telemetry.event("scaleout.workers_reaped",
                                    workers=[str(w) for w in removed])
            # 1) collect results; sync publishes only at the round
            #    boundary, async as soon as anything arrived
            round_jobs.extend(tracker.drain_updates())
            if round_jobs and (not sync or not tracker.has_pending()):
                publish(round_jobs)
                round_jobs = []
            # 2) only then push new work: never start round N+1 while
            #    round N's results are drained but unpublished
            if jobs.has_next():
                if router.send_work() and not (sync and round_jobs):
                    for _ in range(max(1, n_slots())):
                        if not jobs.has_next():
                            break
                        tracker.add_job(jobs.next(""))
            elif not tracker.has_pending() and not round_jobs:
                break
            time.sleep(poll)
        else:
            # publish what completed BEFORE raising: the partial aggregate
            # stays in tracker.get_current() for the caller
            round_jobs.extend(tracker.drain_updates())
            publish(round_jobs)
            queued, in_flight = tracker.pending_counts()
            telemetry.event("scaleout.timeout", timeout_s=timeout_s,
                            queued=queued, in_flight=in_flight,
                            workers=len(tracker.workers()),
                            published=len(round_jobs))
            raise TimeoutError(
                f"distributed run did not finish within {timeout_s}s: "
                f"{queued} queued + {in_flight} in-flight job(s), "
                f"{len(tracker.workers())} live worker(s); "
                f"{len(round_jobs)} completed update(s) were published — "
                "partial aggregate preserved in tracker.get_current()")
        round_jobs.extend(tracker.drain_updates())
        publish(round_jobs)
        return tracker.get_current()


# ---------------------------------------------------------------------------
# The in-process distributed runner
# ---------------------------------------------------------------------------

class DistributedRunner:
    """A master pump and N worker threads over one StateTracker.

    The reference's flow: jobs come from the JobIterator; workers poll
    ``job_for``, replicate the current value when flagged, run their
    performer and post the result (``complete_job``); the master
    aggregates a round, sets the new current value and flags every
    worker to replicate.  A performer that raises has its job requeued
    (``jobs_failed``), up to the tracker's ``max_job_retries``."""

    def __init__(self, job_iterator: JobIterator,
                 performer_factory: Callable[[], WorkerPerformer],
                 aggregator: JobAggregator,
                 n_workers: int = 2,
                 router_cls=IterativeReduceWorkRouter,
                 poll_interval_s: float = 0.005,
                 max_job_retries: int = 5):
        self.tracker = StateTracker(max_job_retries=max_job_retries)
        self.update_saver = UpdateSaver()
        self.jobs = job_iterator
        self.performer_factory = performer_factory
        self.aggregator = aggregator
        self.router = router_cls(self.tracker)
        self.n_workers = n_workers
        self.poll = poll_interval_s
        self._stop = threading.Event()

    def _worker_loop(self, worker_id: str,
                     stop: Optional[threading.Event] = None) -> None:
        """WorkerActor.checkJobAvailable:287.  The stop event is bound
        per run: a worker a timed-out join left behind keeps watching
        its own run's (set) event, not a later run's."""
        from deeplearning4j_tpu_torch.runtime import telemetry

        stop = self._stop if stop is None else stop
        performer = self.performer_factory()
        self.tracker.add_worker(worker_id)
        telemetry.event("scaleout.worker_join", worker=worker_id)
        while not stop.is_set():
            self.tracker.heartbeat(worker_id)
            job = self.tracker.job_for(worker_id)
            if job is None:
                time.sleep(self.poll)
                continue
            if self.tracker.needs_replicate(worker_id):
                current = self.tracker.get_current()
                if current is not None:
                    performer.update(current)
                self.tracker.done_replicating(worker_id)
            try:
                performer.perform(job)
            except Exception:
                # JobFailed: the work goes back for another worker, in one
                # lock (has_pending() never sees it missing from both)
                log.exception("worker %s failed job; requeueing", worker_id)
                self.tracker.requeue(worker_id)
                self.tracker.increment("jobs_failed")
                continue
            self.tracker.complete_job(worker_id, job)

    def run(self, timeout_s: float = 60.0) -> Any:
        # a fresh stop event a run: the previous run left its event set
        stop = self._stop = threading.Event()
        workers = [threading.Thread(target=self._worker_loop,
                                    args=(f"worker-{i}", stop),
                                    daemon=True)
                   for i in range(self.n_workers)]
        for w in workers:
            w.start()
        try:
            return master_pump(self.tracker, self.jobs, self.aggregator,
                               self.router, lambda: self.n_workers,
                               self.poll, timeout_s)
        finally:
            stop.set()
            for w in workers:
                w.join(timeout=5)


# ---------------------------------------------------------------------------
# IRUnit: the YARN IterativeReduce simulation
# ---------------------------------------------------------------------------

class ComputableMaster:
    """compute(worker_updates, previous) -> new global
    (ComputableMaster.java:30)."""

    def compute(self, worker_updates: List[Updateable],
                previous: Optional[Updateable]) -> Updateable:
        raise NotImplementedError

    def complete(self) -> Any:
        return None


class ComputableWorker:
    """compute(records) -> Updateable; update(master) absorbs the round's
    result (ComputableWorker.java:25)."""

    def compute(self, records: Any) -> Updateable:
        raise NotImplementedError

    def update(self, master_update: Updateable) -> None:
        pass


class IRUnitDriver:
    """A master and N workers in one process, BSP supersteps over data
    splits (IRUnitDriver.java: the IRUnit test pattern, no cluster)."""

    def __init__(self, master: ComputableMaster,
                 workers: Sequence[ComputableWorker],
                 splits: Sequence[Any], iterations: int = 1):
        if len(workers) != len(splits):
            raise ValueError(f"{len(workers)} workers for "
                             f"{len(splits)} splits")
        self.master = master
        self.workers = list(workers)
        self.splits = list(splits)
        self.iterations = iterations

    def run(self) -> Any:
        previous: Optional[Updateable] = None
        for _ in range(self.iterations):
            updates = [w.compute(split)
                       for w, split in zip(self.workers, self.splits)]
            previous = self.master.compute(updates, previous)
            for w in self.workers:       # fetch + update a superstep
                w.update(previous)
        return self.master.complete() or previous
