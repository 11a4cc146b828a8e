"""Fault injection for training and for the serving fleet.

Port of ``deeplearning4j_tpu/parallel/chaos.py`` (:52-141, :199-424).

The training injectors are ``ResilientFit`` ``fault_hook`` s that fire
once, at a step boundary: :class:`DeviceLossChaos` (a
``DeviceLossError`` naming ranks), :class:`HostLossChaos` (every rank of
one host: a contiguous block of the mesh's ranks for a virtual host,
``Cluster.devices_of`` for a real one) and :class:`PreemptionChaos` (a
``PreemptionGuard`` request).  In a multi-rank drill every rank
installs the same injector, so all raise at the same step.

For serving, :class:`ServingChaos` arms one-shot faults against
ONE decode replica (a ``ContinuousBatcher`` over a ``DecodeEngine``):
worker death, a poisoned dispatch, a stall, an exhausted KV page pool.
Each fires at the replica's next step boundary ON its own worker thread
(the engine and its page allocator are driven by that one thread, and
chaos must not become a second).  ``serving/chaos_gate.py`` drives it
as a drill.

``ChaosPerformer`` and ``chaos_factory`` wrap the scale-out runner's
workers, ROADMAP A7.6: importing one raises ``NotImplementedError``
naming it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

# defined beside ResilientFit, which catches it (runtime/resilience.py), and
# re-exported here beside the injectors that raise it
from deeplearning4j_tpu_torch.runtime.resilience import DeviceLossError

__all__ = ["DeviceLossChaos", "DeviceLossError", "HostLossChaos",
           "InjectedFault", "PreemptionChaos", "ServingChaos",
           "WorkerKilled"]


class DeviceLossChaos:
    """Step-boundary device-loss injector (:52-71): raises
    :class:`DeviceLossError` for ``lost_ids`` (ranks) the first time the
    step reaches ``at_step``, exactly once (the recovery re-runs the
    boundary, and a fault that fired forever would starve it)."""

    def __init__(self, at_step: int, lost_ids):
        self.at_step = at_step
        self.lost_ids = tuple(int(i) for i in lost_ids)
        self.fired = False

    def __call__(self, step: int) -> None:
        if not self.fired and step >= self.at_step:
            self.fired = True
            raise DeviceLossError(
                self.lost_ids,
                f"injected device loss at step {step}: ids "
                f"{sorted(self.lost_ids)}")


class HostLossChaos:
    """Step-boundary host-loss injector (:74-124): raises
    :class:`DeviceLossError` for every device of host ``host_index``,
    exactly once.  With ``cluster`` (more than one member) the host is a
    member and its devices are ``cluster.devices_of(host_index)`` (the
    real topology); otherwise ``devices`` (ranks; default the mesh's
    ranks, or the default group's) is cut into ``n_hosts`` contiguous
    blocks (default 2) and the host is block ``host_index``: a virtual
    host, which lets one group drill the loss of a whole host."""

    def __init__(self, at_step: int, host_index: int,
                 n_hosts: Optional[int] = None, devices=None, *,
                 mesh=None, cluster=None):
        self.at_step = at_step
        self.host_index = host_index
        self.fired = False
        if cluster is not None and cluster.process_count > 1:
            self.lost_ids = tuple(cluster.devices_of(host_index))
        else:
            if devices is None:
                devices = _default_ranks(mesh)
            devices = [int(d) for d in devices]
            n_hosts = n_hosts or 2
            per = len(devices) // n_hosts
            if per < 1:
                raise ValueError(
                    f"{len(devices)} device(s) cannot form {n_hosts} "
                    "virtual hosts")
            self.lost_ids = tuple(
                devices[host_index * per:(host_index + 1) * per])
        if not self.lost_ids:
            raise ValueError(
                f"host {host_index} owns no devices in this fleet")

    def __call__(self, step: int) -> None:
        if not self.fired and step >= self.at_step:
            self.fired = True
            raise DeviceLossError(
                self.lost_ids,
                f"injected loss of host {self.host_index} at step "
                f"{step}: device ids {sorted(self.lost_ids)}")


def _default_ranks(mesh) -> list:
    """The mesh's ranks, else the initialized default group's, else the
    one process."""
    if mesh is not None:
        return list(mesh.ranks)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


class PreemptionChaos:
    """Step-boundary preemption drill (:127-141): requests
    ``ResilientFit``'s ``PreemptionGuard`` at ``at_step`` (once), the
    signal-free way to run the final-snapshot-and-clean-exit path."""

    def __init__(self, at_step: int, guard):
        self.at_step = at_step
        self.guard = guard
        self.fired = False

    def __call__(self, step: int) -> None:
        if not self.fired and step >= self.at_step:
            self.fired = True
            self.guard.request()


class InjectedFault(RuntimeError):
    """An injected failure (:48): an ordinary error, which the batcher's
    replay path owns."""


class WorkerKilled(BaseException):
    """Injected decode-worker death (:199).  A ``BaseException`` on
    purpose: the batcher's dispatch-failure handler catches
    ``Exception`` (the replay path), and a KILL must pass it and end the
    worker thread as a death would, leaving ``worker_alive()`` False and
    the replica's requests stranded for the health monitor to evacuate.
    It is raised before the engine call, so no replay is in flight when
    the thread dies."""


_orig_thread_excepthook: Optional[Callable] = None


def _install_kill_excepthook() -> None:
    """Silence only :class:`WorkerKilled` escaping a thread (:211): an
    injected death is the drill's expected outcome.  Every other thread
    exception still reaches the previous hook.  Idempotent; installed by
    the first ``ServingChaos``."""
    global _orig_thread_excepthook
    if _orig_thread_excepthook is not None:
        return
    _orig_thread_excepthook = threading.excepthook

    def hook(args) -> None:
        if args.exc_type is not WorkerKilled:
            _orig_thread_excepthook(args)

    threading.excepthook = hook


class ServingChaos:
    """Deterministic fault injection for ONE serving replica (:229).

    Every injector ARMS a fault: it fires at the replica's next call of
    an engine step-boundary entry (``advance`` / ``advance_spec``, and
    ``can_admit`` for faults that are legal under the batcher's
    condition variable), so it runs on the replica's OWN worker thread.
    The batcher calls those entries through ``self.engine``, so patching
    the engine's attributes reaches them.

    - :meth:`kill_worker`: the next step raises :class:`WorkerKilled`;
    - :meth:`poison_dispatch`: the next ``n`` dispatches raise
      :class:`InjectedFault` (the batcher frees the slots and replays
      their requests in place);
    - :meth:`stall_dispatch`: the next dispatch sleeps first (the
      monitor's stall detector replaces the replica; the zombie worker
      then wakes into detached request handles);
    - :meth:`exhaust_pages` / :meth:`release_pages`: grab (then return)
      the replica's free KV pages: admissions wait.

    ``injected`` counts what fired; :meth:`restore` disarms what is
    still pending (a dead worker never fires an armed fault)."""

    #: entries for faults that may fire under the batcher's condition
    #: variable (``can_admit`` runs inside the admission scan)
    _ANY = ("advance", "advance_spec", "can_admit")
    #: entries for faults that must fire outside every lock (sleeps) or
    #: that are about a decode dispatch (poison)
    _DISPATCH = ("advance", "advance_spec")

    def __init__(self, batcher) -> None:
        self.batcher = batcher
        self.engine = batcher.engine
        self.injected = {"kill": 0, "poison": 0, "stall": 0,
                         "exhaust": 0, "release": 0}
        self._held_pages: list = []
        # re-entrant: page hooks fire inside the lock region (atomic
        # with the fire decision) and keep their own ``with``
        self._lock = threading.RLock()
        self._restores: list = []
        self._exhaust_restores: list = []
        _install_kill_excepthook()

    # -- arming ------------------------------------------------------------
    def _arm(self, hook: Callable, methods, times: int = 1, *,
             locked_hook: bool = False) -> Callable:
        """Wrap ``methods`` on the engine so the next ``times`` calls
        (over all of them) run ``hook(name)`` first, on the calling
        (worker) thread, then put the originals back and delegate.  A
        raising hook restores first: a fault fires its count, never
        forever.  Returns the disarm closure (idempotent).

        Every setattr (install, restore on fire, disarm) runs under
        ``self._lock``: arming runs on the host thread while faults fire
        on the worker.  ``locked_hook=True`` also runs the hook inside
        the lock, making the fire atomic with its decision (page
        bookkeeping); blocking hooks (sleeps) keep the default."""
        eng = self.engine
        state = {"left": int(times)}
        with self._lock:
            origs = {m: getattr(eng, m) for m in methods}

        def restore() -> None:
            with self._lock:
                if state["left"] == 0:
                    return
                state["left"] = 0
                for m, o in origs.items():
                    setattr(eng, m, o)

        def make(name: str, orig: Callable) -> Callable:
            def wrapped(*a, **kw):
                with self._lock:
                    fire = state["left"] > 0
                    if fire:
                        state["left"] -= 1
                        if state["left"] == 0:
                            for m, o in origs.items():
                                setattr(eng, m, o)
                        if locked_hook:
                            hook(name)
                if fire and not locked_hook:
                    hook(name)
                return orig(*a, **kw)
            return wrapped

        with self._lock:
            for m, o in origs.items():
                setattr(eng, m, make(m, o))
        self._restores.append(restore)
        return restore

    def restore(self) -> None:
        """Disarm every unfired fault and return any held pages.  Call
        only when the replica's worker is dead or quiescent (see
        :meth:`release_pages`).  Newest first: a later fault wrapped the
        earlier one's wrapper, so the engine's own methods go back
        last."""
        for r in reversed(self._restores):
            r()
        self._restores = []
        self.release_pages(armed=False)

    # -- injectors ---------------------------------------------------------
    def kill_worker(self) -> None:
        """Arm a one-shot :class:`WorkerKilled` at the next step
        boundary."""
        def hook(name: str) -> None:
            self.injected["kill"] += 1
            raise WorkerKilled(f"injected worker death (at {name})")
        self._arm(hook, self._ANY)

    def poison_dispatch(self, n: int = 1) -> None:
        """Arm :class:`InjectedFault` on the next ``n`` decode
        dispatches."""
        if n < 1:
            raise ValueError(f"poison count must be >= 1: {n}")

        def hook(name: str) -> None:
            self.injected["poison"] += 1
            raise InjectedFault(f"injected dispatch poison (at {name})")
        self._arm(hook, self._DISPATCH, times=n)

    def stall_dispatch(self, seconds: float) -> None:
        """Arm a one-shot sleep before the next dispatch: long enough,
        and the health monitor replaces the replica while this worker
        sleeps."""
        if seconds <= 0:
            raise ValueError(f"stall must be > 0 s: {seconds}")

        def hook(name: str) -> None:
            self.injected["stall"] += 1
            time.sleep(seconds)
        self._arm(hook, self._DISPATCH)

    def exhaust_pages(self, leave: int = 0) -> None:
        """Arm a one-shot grab of the replica's free KV pages (all but
        ``leave``), held by this injector: admissions wait.  The port's
        admission evicts pool-resident prefixes to make room, so their
        pages count as free: the grab evicts them first.  Paged engines
        only."""
        if self.engine._alloc is None:
            raise ValueError("exhaust_pages requires a paged engine")
        if leave < 0:
            raise ValueError(f"leave must be >= 0: {leave}")

        def hook(name: str) -> None:
            self.engine._free_residents()
            alloc = self.engine._alloc
            n = max(alloc.n_free() - int(leave), 0)
            if n:
                with self._lock:
                    self._held_pages.extend(alloc.alloc(n))
            self.injected["exhaust"] += 1
        self._exhaust_restores.append(
            self._arm(hook, self._ANY, locked_hook=True))

    def release_pages(self, armed: bool = True) -> None:
        """End the exhaustion and return every held page.

        A still-armed (unfired) exhaust is disarmed first, so a release
        racing a slow worker cannot be followed by a grab that holds the
        pool for good.  ``armed=True`` frees on the worker thread at the
        replica's next step boundary (the allocator's one thread);
        ``armed=False`` frees from the calling thread at once, legal
        only when the worker is dead or parked."""
        for r in self._exhaust_restores:
            r()
        self._exhaust_restores = []

        def hook(name: str) -> None:
            with self._lock:
                held, self._held_pages = self._held_pages, []
            alloc = self.engine._alloc
            if alloc is not None and held:
                alloc.free(held)
                self.injected["release"] += 1
        with self._lock:
            holding = bool(self._held_pages)
        if not holding:
            return                      # the grab never fired
        if armed:
            self._arm(hook, self._ANY, locked_hook=True)
        else:
            hook("direct")


def __getattr__(name: str):
    if name in ("ChaosPerformer", "chaos_factory"):
        raise NotImplementedError(
            f"parallel.chaos.{name} is not ported yet: ROADMAP A7.6 (the "
            f"scale-out runner whose workers it wraps)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
