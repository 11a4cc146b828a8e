"""Cross-process control plane: a socket-served StateTracker and a
multi-process distributed runner.

Port of ``deeplearning4j_tpu/parallel/transport.py``.  The reference's
Akka runtime spans OS processes: workers join a master by connection
string and share job and param state through an embedded Hazelcast
server (``DeepLearning4jDistributed.java:205,301-315``,
``BaseHazelCastStateTracker.java:495-562``).  The same split here:

- :class:`StateTrackerServer`, the embedded server: it hosts the real
  in-process :class:`StateTracker` and serves its method surface over
  ``multiprocessing.connection`` (length-prefixed pickle over TCP with
  HMAC challenge-response authentication on a shared ``authkey``, so an
  unauthenticated peer never delivers a pickle).  The master uses the
  tracker object directly; workers dial in.
- :class:`RemoteStateTracker`, the client: the same method surface, each
  call forwarded over the socket.
- :func:`worker_main`, a worker process's entry point: it joins (with
  retries and exponential backoff), heartbeats on a connection of its
  own, polls ``job_for``, replicates the current value when flagged,
  performs and posts, and exits when the master sets the done flag.
- :class:`MultiProcessRunner`: embeds the server, spawns N worker
  processes (others may join by the connection string) and drives the
  shared ``master_pump`` with the stale-worker reaper on: a killed
  worker's heartbeats stop and the reaper requeues its job.

The performer reaches a worker process as a *spec*: ``"module:callable"``
plus pickled constructor arguments (the reference's reflective
``WorkerPerformerFactory.WORKER_PERFORMER`` key).  Its device is one of
those arguments (the library performers' ``device=``); workers start with
the ``spawn`` method, so none inherits a live CUDA context.

Tensors cross the wire as CPU numpy arrays (bf16 ones, which numpy has
no type for, as CPU tensors): every call's arguments and every reply
pass through :func:`to_wire`, so no CUDA tensor is ever pickled and the
master's server thread never brings CUDA up.  A performer copies what it
receives onto its own device.
"""

from __future__ import annotations

import importlib
import logging
import multiprocessing
import dataclasses
import os
import secrets
import socket
import threading
import time
from multiprocessing.connection import Client, Connection, Listener
from typing import Any, Callable, List, Optional, Tuple, Union

from deeplearning4j_tpu_torch.parallel.coordinator import Job, StateTracker
from deeplearning4j_tpu_torch.parallel.scaleout import (
    IterativeReduceWorkRouter, JobAggregator, JobIterator, WorkerPerformer,
    master_pump)

log = logging.getLogger(__name__)

__all__ = ["MultiProcessRunner", "RemoteStateTracker", "StateTrackerServer",
           "resolve_performer_factory", "to_wire", "worker_main"]

# The tracker surface served over the wire.  Everything the worker loop
# and the pump need; underscore methods stay private to the process.
_TRACKER_METHODS = frozenset({
    "add_worker", "heartbeat", "heartbeats", "workers",
    "remove_stale_workers", "worker_enabled", "enable_worker",
    "add_job", "job_for", "clear_job", "requeue", "has_pending",
    "pending_counts",
    "set_current", "get_current", "needs_replicate", "done_replicating",
    "add_update", "complete_job", "updates", "drain_updates",
    "increment", "count", "set_done", "is_done",
})


def to_wire(obj: Any) -> Any:
    """``obj`` with every tensor in it as host memory: a numpy array (a
    bf16 tensor, which numpy has no type for, a CPU tensor), through
    dicts, lists, tuples, named tuples, :class:`Job` s and ``DataSet``
    s; anything else as it is."""
    import torch

    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(obj, dict):
        out = {k: to_wire(v) for k, v in obj.items()}
        return out if type(obj) is dict else type(obj)(out)
    if isinstance(obj, (list, tuple)):
        vals = [to_wire(v) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") \
            else type(obj)(vals)
    if isinstance(obj, Job):
        return dataclasses.replace(obj, work=to_wire(obj.work),
                                   result=to_wire(obj.result))
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    if isinstance(obj, DataSet):
        return DataSet(to_wire(obj.features), to_wire(obj.labels))
    return obj


# ---------------------------------------------------------------------------
# Server (embedded mode) — wire layer is stdlib multiprocessing.connection:
# length-prefixed pickle over TCP with HMAC challenge-response auth, so an
# unauthenticated peer can never deliver a pickle to this process.
# ---------------------------------------------------------------------------

class StateTrackerServer:
    """Serve a StateTracker on a TCP port (Hazelcast embedded-server-mode
    parity).  The hosting process keeps using ``self.tracker`` directly;
    remote processes connect with :class:`RemoteStateTracker` via
    ``connection_string`` + the shared ``authkey``."""

    def __init__(self, tracker: Optional[StateTracker] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 authkey: Optional[bytes] = None):
        self.tracker = tracker or StateTracker()
        self.authkey = authkey if authkey is not None else (
            secrets.token_bytes(16))
        self._listener = Listener((host, port), authkey=self.authkey)
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: List[threading.Thread] = []
        self._closing = False

    @property
    def connection_string(self) -> str:
        host, port = self._listener.address[:2]
        return f"{host}:{port}"

    def _serve_connection(self, conn: Connection) -> None:
        with conn:
            while True:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    return                   # client went away (or died)
                except Exception as exc:  # noqa: BLE001
                    # malformed request pickle: the frame was consumed, so
                    # the connection is still usable — reply with the error
                    reply = (False, exc)
                else:
                    try:
                        name, args, kwargs = msg
                        if name not in _TRACKER_METHODS:
                            raise AttributeError(
                                f"no tracker method {name!r}")
                        reply = (True, to_wire(getattr(
                            self.tracker, name)(*args, **kwargs)))
                    except Exception as exc:  # noqa: BLE001 — to client
                        reply = (False, exc)
                try:
                    conn.send(reply)
                except (BrokenPipeError, ConnectionError, OSError):
                    return
                except Exception:            # unpicklable payload/exception
                    try:
                        conn.send((False, RuntimeError(repr(reply[1]))))
                    except (BrokenPipeError, ConnectionError, OSError):
                        return

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):      # closed, or failed auth
                if self._closing:
                    return
                continue
            except Exception:
                if self._closing:
                    return
                log.exception("tracker server accept failed")
                continue
            # prune finished connection threads so reconnect churn (worker
            # crash/restart cycles) doesn't grow the list forever
            self._conn_threads = [t for t in self._conn_threads
                                  if t.is_alive()]
            t = threading.Thread(target=self._serve_connection,
                                 args=(conn,), daemon=True,
                                 name="tracker-conn")
            t.start()
            self._conn_threads.append(t)

    def start(self) -> "StateTrackerServer":
        if self._accept_thread is not None and self._accept_thread.is_alive():
            return self                      # idempotent: already serving
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="state-tracker-server")
        self._accept_thread.start()
        return self

    def shutdown(self) -> None:
        self._closing = True
        # closing the listener does not wake an accept() blocked in the
        # serving thread: a connection that never authenticates does
        # (its handshake fails, and the loop sees it is closing)
        try:
            socket.create_connection(self._listener.address[:2],
                                     timeout=1.0).close()
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    def __enter__(self) -> "StateTrackerServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()


# ---------------------------------------------------------------------------
# Client (worker mode)
# ---------------------------------------------------------------------------

class RemoteStateTracker:
    """StateTracker proxy over an authenticated connection: the
    client-mode counterpart of ``StateTrackerServer`` with the identical
    method surface (generated below from ``_TRACKER_METHODS``), safe for
    concurrent use from the worker loop and its heartbeat thread."""

    def __init__(self, connection_string: str,
                 authkey: Optional[bytes] = None,
                 timeout_s: float = 60.0):
        host, _, port = connection_string.rpartition(":")
        self._conn = Client((host, int(port)), authkey=authkey)
        self._lock = threading.Lock()
        self.timeout_s = timeout_s

    def _call(self, name: str, *args: Any, **kwargs: Any) -> Any:
        with self._lock:
            self._conn.send((name, to_wire(args), to_wire(kwargs)))
            # bounded wait: a hung/deadlocked master must not wedge the
            # worker forever — TimeoutError is an OSError, so the worker
            # loop treats it as a lost connection, exits, and the reaper
            # requeues its job
            if not self._conn.poll(self.timeout_s):
                # the reply stream is now out of sync — close so any later
                # call fails fast instead of reading a stale reply
                self._conn.close()
                raise TimeoutError(
                    f"no reply to {name!r} within {self.timeout_s}s")
            ok, value = self._conn.recv()
        if not ok:
            raise value
        return value

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass

    def __enter__(self) -> "RemoteStateTracker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _make_proxy(name: str):
    def proxy(self, *args, **kwargs):
        return self._call(name, *args, **kwargs)
    proxy.__name__ = name
    proxy.__qualname__ = f"RemoteStateTracker.{name}"
    proxy.__doc__ = f"Forward ``{name}`` to the remote StateTracker."
    return proxy


for _name in sorted(_TRACKER_METHODS):
    setattr(RemoteStateTracker, _name, _make_proxy(_name))
del _name


# ---------------------------------------------------------------------------
# Performer specs (reflective WORKER_PERFORMER parity)
# ---------------------------------------------------------------------------

PerformerSpec = Union[str, Tuple[str, tuple, dict],
                      Callable[[], WorkerPerformer]]


def resolve_performer_factory(spec: PerformerSpec
                              ) -> Callable[[], WorkerPerformer]:
    """``"module:callable"`` or ``("module:callable", args, kwargs)`` →
    zero-arg factory.  A plain callable passes through (in-process use).
    String specs are what cross the process boundary — the analog of the
    reference's ``WORKER_PERFORMER`` class-name key resolved reflectively
    (BaseWorkPerformerFactory parity)."""
    if callable(spec):
        return spec
    if isinstance(spec, tuple):
        path, args, kwargs = spec
    else:
        path, args, kwargs = spec, (), {}
    module, sep, attr = path.partition(":")
    if not sep or not attr:
        raise ValueError(f"performer spec {path!r} is not 'module:callable'")
    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return lambda: obj(*args, **kwargs)


# ---------------------------------------------------------------------------
# Worker process entry point (WorkerActor parity)
# ---------------------------------------------------------------------------

def _join_tracker(connection_string: str, worker_id: str,
                  authkey: Optional[bytes], retries: int,
                  backoff_s: float):
    """Open both tracker connections and register, retrying with
    exponential backoff.  A worker racing the master's listener bring-up
    (or a transient network blip on a real cluster) must not be lost for
    the whole run over one refused connect — the reference worker simply
    dies there and YARN restarts it; retrying in-process is cheaper.
    Returns (tracker, beat_tracker) or None when the budget is spent
    (master genuinely gone — exit cleanly, the reaper handles the rest).
    """
    from deeplearning4j_tpu_torch.runtime import telemetry
    from deeplearning4j_tpu_torch.runtime.metrics import resilience_metrics

    for attempt in range(retries + 1):
        tracker = None
        try:
            tracker = RemoteStateTracker(connection_string, authkey=authkey)
            tracker.add_worker(worker_id)
            telemetry.event("scaleout.worker_join", worker=worker_id,
                            attempts=attempt + 1)
            # The heartbeat gets its OWN connection: the main loop's
            # socket is held for a full RPC round-trip, so a large
            # add_update (MLN params) would otherwise block heartbeats
            # past the stale threshold and get a healthy worker reaped
            # mid-report.
            beat_tracker = RemoteStateTracker(connection_string,
                                              authkey=authkey)
            return tracker, beat_tracker
        except (EOFError, ConnectionError, OSError) as exc:
            if tracker is not None:
                tracker.close()
            if attempt >= retries:
                telemetry.event("scaleout.worker_join_failed",
                                worker=worker_id, attempts=attempt + 1)
                log.warning("worker %s could not join %s after %d "
                            "attempt(s) (%s); exiting", worker_id,
                            connection_string, attempt + 1, exc)
                return None
            delay = backoff_s * (2 ** attempt)
            resilience_metrics.note("worker_join_retries")
            telemetry.event("scaleout.worker_join_retry",
                            worker=worker_id, attempt=attempt + 1)
            log.warning("worker %s join attempt %d/%d to %s failed "
                        "(%s); retrying in %.2fs", worker_id, attempt + 1,
                        retries + 1, connection_string, exc, delay)
            time.sleep(delay)
    return None


def worker_main(connection_string: str, performer_spec: PerformerSpec,
                worker_id: Optional[str] = None,
                poll_interval_s: float = 0.01,
                heartbeat_interval_s: Optional[float] = None,
                authkey: Optional[bytes] = None,
                join_retries: int = 4,
                join_backoff_s: float = 0.25) -> None:
    """Run one worker process against a remote tracker until the master
    sets the done flag.  The loop is the reference's
    WorkerActor.checkJobAvailable:287 — poll ``job_for``, replicate
    current params if flagged, perform, ``add_update`` — plus the YARN
    worker's dedicated heartbeat thread so a long ``perform`` doesn't
    look stale, while a killed process stops heartbeating and gets its
    job requeued by the master's reaper.  Joining retries with
    exponential backoff (``join_retries`` × ``join_backoff_s``-doubling)
    so a worker racing the master's bring-up isn't lost for the run."""
    worker_id = worker_id or f"worker-{os.getpid()}"
    performer = resolve_performer_factory(performer_spec)()
    joined = _join_tracker(connection_string, worker_id, authkey,
                           join_retries, join_backoff_s)
    if joined is None:
        return
    tracker, beat_tracker = joined

    if heartbeat_interval_s is None:
        heartbeat_interval_s = 0.25
    stop_beat = threading.Event()

    def beat() -> None:
        while not stop_beat.is_set():
            try:
                if not beat_tracker.heartbeat(worker_id):
                    # reaped (e.g. a long GC-like stall) but still alive:
                    # re-join, the Akka MemberEvent re-register
                    beat_tracker.add_worker(worker_id)
            except Exception:
                return                        # master gone; main loop exits
            stop_beat.wait(heartbeat_interval_s)

    beater = threading.Thread(target=beat, daemon=True, name="heartbeat")
    beater.start()
    try:
        while not tracker.is_done():
            job = tracker.job_for(worker_id)
            if job is None:
                time.sleep(poll_interval_s)
                continue
            if tracker.needs_replicate(worker_id):
                current = tracker.get_current()
                if current is not None:
                    performer.update(current)
                tracker.done_replicating(worker_id)
            try:
                performer.perform(job)
            except Exception:
                log.exception("worker %s failed job; requeueing", worker_id)
                tracker.requeue(worker_id)
                tracker.increment("jobs_failed")
                continue
            tracker.complete_job(worker_id, job)
    except (EOFError, ConnectionError, OSError):
        log.warning("worker %s lost the tracker connection; exiting",
                    worker_id)
    finally:
        stop_beat.set()
        tracker.close()
        beat_tracker.close()


# ---------------------------------------------------------------------------
# Multi-process runner (DeepLearning4jDistributed parity)
# ---------------------------------------------------------------------------

class MultiProcessRunner:
    """Master pump + N worker *processes* over a socket-served tracker.

    The master embeds the tracker server (Hazelcast embedded-server
    parity) and runs the same ``master_pump`` as the in-process runner,
    with the stale-worker reaper ON: when a worker process dies mid-job,
    its heartbeats stop, the reaper drops it and requeues the job, and a
    surviving worker completes the work — the fault-tolerance loop of
    MasterActor.java:139-169.

    External workers (other hosts in a real deployment) can also join by
    running ``worker_main(connection_string, spec)`` — spawning here is a
    convenience for tests and single-host runs, exactly the role of the
    reference's in-process BaseTestDistributed bring-up.

    Worker processes use the ``spawn`` start method, so a script driving
    this runner must be importable: wrap the driving code in the standard
    ``if __name__ == "__main__":`` guard.
    """

    def __init__(self, job_iterator: JobIterator,
                 performer_spec: PerformerSpec,
                 aggregator: JobAggregator,
                 n_workers: int = 2,
                 router_cls=IterativeReduceWorkRouter,
                 stale_after_s: float = 2.0,
                 poll_interval_s: float = 0.01,
                 host: str = "127.0.0.1", port: int = 0,
                 authkey: Optional[bytes] = None):
        self.tracker = StateTracker(stale_after_s=stale_after_s)
        self.server = StateTrackerServer(self.tracker, host=host, port=port,
                                         authkey=authkey)
        self.jobs = job_iterator
        self.performer_spec = performer_spec
        self.aggregator = aggregator
        self.router = router_cls(self.tracker)
        self.n_workers = n_workers
        self.poll = poll_interval_s
        self.processes: List[multiprocessing.process.BaseProcess] = []

    @property
    def connection_string(self) -> str:
        return self.server.connection_string

    def spawn_workers(self, n: Optional[int] = None) -> None:
        """Start worker processes against this runner's tracker.  Uses
        the ``spawn`` start method: a fresh interpreter per worker, no
        inherited CUDA context (a forked child would copy a live one)."""
        ctx = multiprocessing.get_context("spawn")
        base = len(self.processes)
        for i in range(self.n_workers if n is None else n):
            p = ctx.Process(
                target=worker_main,
                args=(self.connection_string, self.performer_spec),
                kwargs={"worker_id": f"proc-worker-{base + i}",
                        "poll_interval_s": self.poll,
                        "authkey": self.server.authkey},
                daemon=True, name=f"proc-worker-{base + i}")
            p.start()
            self.processes.append(p)

    def _wait_for_workers(self, n: int, timeout_s: float) -> None:
        """Barrier until ``n`` workers registered (cluster-join parity:
        the reference master waits for worker cluster membership)."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if len(self.tracker.workers()) >= n:
                return
            time.sleep(0.02)
        raise TimeoutError(
            f"only {len(self.tracker.workers())}/{n} workers joined "
            f"within {timeout_s}s")

    def run(self, timeout_s: float = 120.0, min_workers: Optional[int] = None,
            spawn: bool = True, join_timeout_s: float = 30.0) -> Any:
        self.server.start()
        try:
            if spawn:
                self.spawn_workers()
            self._wait_for_workers(
                self.n_workers if min_workers is None else min_workers,
                timeout_s=min(timeout_s, join_timeout_s))
            return master_pump(
                self.tracker, self.jobs, self.aggregator, self.router,
                n_slots=lambda: max(1, len(self.tracker.workers())),
                poll=self.poll, timeout_s=timeout_s, reap=True)
        finally:
            self.tracker.set_done()
            for p in self.processes:
                p.join(timeout=join_timeout_s)
            for p in self.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
            self.server.shutdown()
