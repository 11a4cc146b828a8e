"""Control-plane coordinator: ``Job``, ``WorkerRecord``, ``StateTracker``.

Port of ``deeplearning4j_tpu/parallel/coordinator.py``, which imports no
JAX; the port keeps its own copy, with the reference's semantics
exactly: the reaper requeues a stale worker's job, a job that fails more
than ``max_job_retries`` times is dropped (``jobs_dropped``),
``complete_job`` discards a reaped worker's late result
(``updates_discarded``), and ``set_current`` flags every worker to
replicate.

The reference's distributed control plane is a Hazelcast-backed
parameter server (api/statetracker/StateTracker.java:43): job
assignment, worker registry + heartbeats, current global params, update
collection, counters, enable/disable switches, plus a stale-worker
reaper in the master (MasterActor.java:139-169).  Here it is thin
host-side state that orchestrates workers (threads driving the card, or
processes over ``parallel/transport.py``), routes jobs, tracks
heartbeats and buffers async updates for the Hogwild path.  The same API
works in-process and served over a socket (``parallel/transport.py``)
without changing callers.  It holds whatever the callers post: the
scale-out runners post trees of tensors in-process and numpy arrays over
the wire.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, Optional

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Job:
    """Unit of distributable work (scaleout/job/Job.java:24 parity).
    ``retries`` counts requeues after worker failure/death."""
    work: Any
    worker_id: str = ""
    result: Any = None
    retries: int = 0


@dataclasses.dataclass
class WorkerRecord:
    worker_id: str
    last_heartbeat: float
    enabled: bool = True


class StateTracker:
    """In-process StateTracker: thread-safe job/worker/update bookkeeping.

    API parity (StateTracker.java): add_update:223/updates:229,
    set_current:88/get_current:95, job_for/clear_job, heartbeats,
    worker_enabled:182, increment/count:52-54.
    """

    def __init__(self, stale_after_s: float = 120.0,
                 max_job_retries: int = 5):
        self._lock = threading.RLock()
        self._workers: Dict[str, WorkerRecord] = {}
        self._jobs: Dict[str, Job] = {}
        self._pending: List[Job] = []
        self._updates: List[Job] = []
        self._current: Any = None
        self._counters: Dict[str, int] = {}
        self._needs_replicate: Dict[str, bool] = {}
        self._done = False
        self.stale_after_s = stale_after_s
        self.max_job_retries = max_job_retries

    # -- run lifecycle (ShutdownMessage parity) -----------------------------
    def set_done(self, done: bool = True) -> None:
        """Master broadcasts end-of-run; polling workers exit their loop
        (the reference's ShutdownMessage / FinishMessage)."""
        with self._lock:
            self._done = done

    def is_done(self) -> bool:
        with self._lock:
            return self._done

    # -- worker registry + heartbeats --------------------------------------
    def add_worker(self, worker_id: str) -> None:
        with self._lock:
            self._workers[worker_id] = WorkerRecord(worker_id, time.time())
            self._needs_replicate[worker_id] = True

    def heartbeat(self, worker_id: str) -> bool:
        """Record liveness.  Returns False for an unknown worker (e.g.
        one the reaper removed) so the caller can re-register — the Akka
        cluster-membership re-join (WorkerActor.preStart:280-283)."""
        with self._lock:
            if worker_id in self._workers:
                self._workers[worker_id].last_heartbeat = time.time()
                return True
            return False

    def heartbeats(self) -> Dict[str, float]:
        with self._lock:
            return {w: r.last_heartbeat for w, r in self._workers.items()}

    def workers(self) -> List[str]:
        with self._lock:
            return list(self._workers)

    def remove_stale_workers(self) -> List[str]:
        """MasterActor reaper parity (stale >= stale_after_s; :139-169):
        drops the worker and re-queues its in-flight job."""
        now = time.time()
        removed = []
        with self._lock:
            for wid, rec in list(self._workers.items()):
                if now - rec.last_heartbeat >= self.stale_after_s:
                    removed.append(wid)
                    del self._workers[wid]
                    self._needs_replicate.pop(wid, None)
                    self._requeue_locked(wid)
        return removed

    def worker_enabled(self, worker_id: str) -> bool:
        with self._lock:
            rec = self._workers.get(worker_id)
            return bool(rec and rec.enabled)

    def enable_worker(self, worker_id: str, enabled: bool = True) -> None:
        with self._lock:
            if worker_id in self._workers:
                self._workers[worker_id].enabled = enabled

    # -- job routing --------------------------------------------------------
    def add_job(self, job: Job) -> None:
        with self._lock:
            self._pending.append(job)

    def job_for(self, worker_id: str) -> Optional[Job]:
        """Assign (or return the already-assigned) job for a worker —
        pull-based like WorkerActor.checkJobAvailable:287."""
        with self._lock:
            if worker_id in self._jobs:
                return self._jobs[worker_id]
            if not self.worker_enabled(worker_id):
                return None
            if self._pending:
                job = self._pending.pop(0)
                job.worker_id = worker_id
                self._jobs[worker_id] = job
                return job
            return None

    def clear_job(self, worker_id: str) -> None:
        with self._lock:
            self._jobs.pop(worker_id, None)

    def _requeue_locked(self, worker_id: str) -> None:
        """Requeue body; caller must hold the lock.  Resets any partial
        result so the next worker starts the job clean.  A job that keeps
        failing is DROPPED after ``max_job_retries`` requeues (counter
        ``jobs_dropped``) — otherwise one deterministically-failing job
        (bad shard, poisoned input) requeues forever, ``has_pending``
        never clears, and the whole run times out discarding every
        healthy worker's results."""
        job = self._jobs.pop(worker_id, None)
        if job is not None:
            job.worker_id = ""
            job.result = None
            job.retries += 1
            if job.retries > self.max_job_retries:
                self._counters["jobs_dropped"] = (
                    self._counters.get("jobs_dropped", 0) + 1)
                log.warning(
                    "dropping job after %d failed attempts; its work is "
                    "EXCLUDED from the aggregate (check jobs_dropped)",
                    job.retries)
                return
            self._pending.append(job)

    def requeue(self, worker_id: str) -> None:
        """Atomically move a worker's assigned job back to the pending
        queue (JobFailed parity).  Single lock acquisition so a concurrent
        ``has_pending()`` can never observe the job missing from both
        ``_jobs`` and ``_pending`` mid-requeue — which would let the master
        finish the round and drop the failed job's work."""
        with self._lock:
            self._requeue_locked(worker_id)

    def has_pending(self) -> bool:
        with self._lock:
            return bool(self._pending) or bool(self._jobs)

    def pending_counts(self) -> tuple:
        """(queued, in_flight) job counts — debuggability for timeout
        and stall reporting (the master pump's error message)."""
        with self._lock:
            return len(self._pending), len(self._jobs)

    # -- current global state (the "parameter server" role) ----------------
    def set_current(self, value: Any) -> None:
        with self._lock:
            self._current = value
            for w in self._needs_replicate:
                self._needs_replicate[w] = True

    def get_current(self) -> Any:
        with self._lock:
            return self._current

    def needs_replicate(self, worker_id: str) -> bool:
        with self._lock:
            return self._needs_replicate.get(worker_id, True)

    def done_replicating(self, worker_id: str) -> None:
        with self._lock:
            self._needs_replicate[worker_id] = False

    # -- update collection (UpdateSaver/addUpdate parity) -------------------
    def add_update(self, worker_id: str, job: Job) -> None:
        with self._lock:
            self._updates.append(job)

    def complete_job(self, worker_id: str, job: Job) -> bool:
        """Atomically post the result, clear the assignment, and count the
        completion — IF the worker still owns a job.  Closes both
        double-count windows: a worker dying between separate
        add_update/clear_job calls, and a slow-but-alive worker whose job
        the reaper already requeued to a peer (its late result is
        discarded here, since the peer's recompute is the one that
        counts).  Returns False when the update was discarded as stale."""
        with self._lock:
            if worker_id not in self._jobs:
                self._counters["updates_discarded"] = (
                    self._counters.get("updates_discarded", 0) + 1)
                return False
            self._updates.append(job)
            del self._jobs[worker_id]
            self._counters["jobs_done"] = (
                self._counters.get("jobs_done", 0) + 1)
            return True

    def updates(self) -> List[Job]:
        with self._lock:
            return list(self._updates)

    def drain_updates(self) -> List[Job]:
        with self._lock:
            out, self._updates = self._updates, []
            return out

    # -- counters -----------------------------------------------------------
    def increment(self, key: str, by: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + by

    def count(self, key: str) -> int:
        with self._lock:
            return self._counters.get(key, 0)
