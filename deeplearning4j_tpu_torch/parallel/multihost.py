"""The multi-process runtime's launcher and control plane.

Port of ``deeplearning4j_tpu/parallel/multihost.py`` (:82-578, :722-817):

- **Launcher**: :func:`resolve_cluster_config` merges the
  ``--coordinator/--num-processes/--process-id`` flags with the
  ``DL4J_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID`` environment trio
  (flags win per field), and :func:`initialize` joins the
  ``torch.distributed`` group (``parallel.mesh.initialize_distributed``)
  under a bounded retry with backoff and typed errors, returning the
  :class:`Cluster` over the group's store.
- **Control plane**: :class:`Cluster`'s barriers, flag OR, lost-id
  agreement, gather, exchange and broadcast ride a key-value store, not
  the mesh's collectives: they work for any subset of the processes
  (the survivors of a host loss), time out with a typed
  :class:`ClusterSyncTimeout` when a peer goes silent, and may run on
  the async checkpoint writer's thread beside the training collectives.
  :class:`InProcessKV` lets threads of one process act as hosts in
  drills; :class:`StoreKV` is the real backend, the process group's
  ``torch.distributed.Store``: a ``FileStore`` for a ``file://``
  rendezvous, a ``TCPStore`` for ``tcp://``.  A TCP store is hosted by
  rank 0 and dies with it, as the reference's coordination service dies
  with process 0: a run whose rank 0 may be lost needs the ``file://``
  rendezvous on the shared filesystem.
- **Failure detection**: :class:`HostHeartbeat`, a file a member on the
  shared checkpoint directory; a member whose file goes stale is named
  lost, in device ids (:meth:`Cluster.devices_of`).

One process drives one device in the port, so a member's devices are
``(its rank,)`` (:func:`process_device_ids`); ``device_map=`` names
virtual hosts (several ranks, or several drill threads, a host).

The data plane of the reference module (``global_data_mesh``,
``worker_store_iterator``, ``StagingMismatchError``,
``stage_global_batch``) is ROADMAP A7.4: each raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.metrics import multihost_metrics

log = logging.getLogger(__name__)

# -- cluster wiring: one source of truth ------------------------------------
ENV_COORDINATOR = "DL4J_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "DL4J_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "DL4J_TPU_PROCESS_ID"
ENV_TRIO = (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID)
FLAG_COORDINATOR = "--coordinator"
FLAG_NUM_PROCESSES = "--num-processes"
FLAG_PROCESS_ID = "--process-id"
FLAG_TRIO = (FLAG_COORDINATOR, FLAG_NUM_PROCESSES, FLAG_PROCESS_ID)


class ClusterJoinError(RuntimeError):
    """Joining the group failed for a non-timeout reason (bad address,
    duplicate rank) after the bounded retry budget."""


class ClusterJoinTimeout(ClusterJoinError):
    """The group never formed within the join deadline: some process did
    not show up (re-run the launch; other join errors mean fix the
    wiring)."""


class ClusterSyncTimeout(RuntimeError):
    """A live cluster's control-plane operation (barrier, flag sync,
    agreement) timed out: a peer stopped taking part.  ``ResilientFit``
    turns it into a host loss when the heartbeat names the peer."""


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Resolved multi-process wiring: the rendezvous address (a
    ``file://``, ``tcp://`` URL or ``host:port``), the process count and
    this process's id."""

    coordinator: str
    num_processes: int
    process_id: int

    def __post_init__(self):
        if self.num_processes < 1:
            raise ValueError(
                f"num_processes must be >= 1, got {self.num_processes}")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id {self.process_id} not in "
                f"[0, {self.num_processes})")


def resolve_cluster_config(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           env: Optional[Dict[str, str]] = None
                           ) -> Optional[ClusterConfig]:
    """Launcher flags merged with the ``DL4J_TPU_*`` environment trio,
    flags winning per field.  None when nothing is wired (one process);
    a partial trio raises ``ValueError`` naming both spellings."""
    env = os.environ if env is None else env

    def pick(flag_val, env_key, cast):
        if flag_val is not None:
            return cast(flag_val)
        raw = env.get(env_key)
        return cast(raw) if raw not in (None, "") else None

    coord = pick(coordinator, ENV_COORDINATOR, str)
    nproc = pick(num_processes, ENV_NUM_PROCESSES, int)
    pid = pick(process_id, ENV_PROCESS_ID, int)
    values = {"coordinator": coord, "num_processes": nproc,
              "process_id": pid}
    missing = [k for k, v in values.items() if v is None]
    if len(missing) == 3:
        return None
    if missing:
        raise ValueError(
            f"partial cluster wiring: {sorted(set(values) - set(missing))} "
            f"set but {missing} missing — the trio must be provided "
            f"together, either as launcher flags "
            f"({', '.join(FLAG_TRIO)}) or as environment variables "
            f"({', '.join(ENV_TRIO)}); flags override env per field")
    return ClusterConfig(coord, nproc, pid)


def initialize(config: ClusterConfig, *, attempts: int = 3,
               backoff_s: float = 2.0, timeout_s: float = 300.0,
               device=None, backend: Optional[str] = None) -> "Cluster":
    """Join the ``torch.distributed`` group of ``config`` with a bounded
    retry (:160-225): each attempt's rendezvous is bounded by
    ``timeout_s``, failures back off exponentially from ``backoff_s``,
    and a failed attempt's half-made group is torn down.  The budget
    spent raises :class:`ClusterJoinTimeout` when the last failure was a
    deadline, else :class:`ClusterJoinError`.  ``device``/``backend``
    pass to ``initialize_distributed`` (``backend="gloo"`` for several
    ranks on one card).  A one-process config joins nothing and returns
    :func:`local_cluster`."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import mesh

    if config.num_processes == 1:
        return local_cluster()
    last: Optional[BaseException] = None
    for attempt in range(1, max(attempts, 1) + 1):
        try:
            with telemetry.span("multihost.join", attempt=attempt,
                                coordinator=config.coordinator,
                                process_id=config.process_id):
                mesh.initialize_distributed(
                    config.coordinator, config.num_processes,
                    config.process_id, device=device, backend=backend,
                    timeout=timeout_s)
            multihost_metrics.note("joins")
            log.info("joined %d-process cluster at %s as process %d "
                     "(attempt %d)", config.num_processes,
                     config.coordinator, config.process_id, attempt)
            return active_cluster()
        except Exception as e:  # noqa: BLE001 — backends raise several types
            last = e
            if dist.is_available() and dist.is_initialized():
                try:
                    dist.destroy_process_group()
                except Exception:  # noqa: BLE001 — nothing to tear down
                    pass
            if attempt <= max(attempts, 1) - 1:
                delay = backoff_s * (2 ** (attempt - 1))
                multihost_metrics.note("join_retries")
                log.warning(
                    "cluster join attempt %d/%d failed (%s: %s); "
                    "retrying in %.1fs", attempt, attempts,
                    type(e).__name__, e, delay)
                time.sleep(delay)
    multihost_metrics.note("join_failures")
    msg = (f"could not join {config.num_processes}-process cluster at "
           f"{config.coordinator} as process {config.process_id} after "
           f"{attempts} attempt(s): {type(last).__name__}: {last}")
    if "deadline" in str(last).lower() or "timeout" in str(last).lower() \
            or "timed out" in str(last).lower() \
            or isinstance(last, TimeoutError):
        raise ClusterJoinTimeout(msg) from last
    raise ClusterJoinError(msg) from last


def initialize_from_env(env: Optional[Dict[str, str]] = None,
                        **retry) -> bool:
    """Join from the ``DL4J_TPU_*`` trio when it is set (``retry`` passes
    to :func:`initialize`); False, doing nothing, when it is not."""
    config = resolve_cluster_config(env=env)
    if config is None:
        return False
    initialize(config, **retry)
    return True


# ---------------------------------------------------------------------------
# key-value backends
# ---------------------------------------------------------------------------

class InProcessKV:
    """An in-memory key-value store with blocking gets, shared by the
    threads of one process: thread "hosts" run the real :class:`Cluster`
    protocols over it in drills and tests."""

    def __init__(self):
        self._data: Dict[str, str] = {}
        self._cond = threading.Condition()

    def put(self, key: str, value: str) -> None:
        with self._cond:
            self._data[key] = value
            self._cond.notify_all()

    def get(self, key: str, timeout_s: float) -> str:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while key not in self._data:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ClusterSyncTimeout(
                        f"key {key!r} not published within {timeout_s}s")
                self._cond.wait(remaining)
            return self._data[key]

    def delete(self, key: str) -> None:
        with self._cond:
            self._data.pop(key, None)


class StoreKV:
    """The real backend: a ``torch.distributed.Store`` (default: the
    default process group's, which outlives any rank for a
    ``FileStore``).  ``get`` polls ``Store.check`` until its deadline and
    then reads the key, where the reference blocks server-side: a
    ``TCPStore`` client holds its lock through a blocking ``wait``, so
    the async writer's barrier would stall the step loop's flag sync on
    the same client.  A missed deadline raises
    :class:`ClusterSyncTimeout`."""

    #: the longest sleep between two checks of a key, seconds
    POLL_S = 0.02

    def __init__(self, store=None):
        if store is None:
            import torch.distributed as dist

            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    "torch.distributed is not initialized — call "
                    "multihost.initialize (or initialize_from_env) first")
            from torch.distributed.distributed_c10d import \
                _get_default_store
            store = _get_default_store()
        self._store = store

    def put(self, key: str, value: str) -> None:
        self._store.set(key, value)

    def get(self, key: str, timeout_s: float) -> str:
        deadline = time.monotonic() + timeout_s
        pause = 0.001
        try:
            while not self._store.check([key]):
                if time.monotonic() >= deadline:
                    raise ClusterSyncTimeout(
                        f"key {key!r} not published within {timeout_s}s")
                time.sleep(pause)
                pause = min(pause * 2, self.POLL_S)
            return self._store.get(key).decode()
        except ClusterSyncTimeout:
            raise
        except Exception as e:  # noqa: BLE001 — a store that went away
            raise ClusterSyncTimeout(
                f"key {key!r} unreadable ({type(e).__name__}: {e})") from e

    def delete(self, key: str) -> None:
        try:
            self._store.delete_key(key)
        except Exception:  # noqa: BLE001 — best-effort cleanup
            pass


# ---------------------------------------------------------------------------
# Cluster: membership and host-side coordination
# ---------------------------------------------------------------------------

class Cluster:
    """This process's view of the training cluster, over a key-value
    store only: every primitive works for any subset of the original
    processes, which host-loss recovery needs (the survivors
    :meth:`shrink` to a new generation whose rounds involve only them).

    Every member makes the same sequence of cluster calls for each tag
    (the host program is SPMD too); rounds are numbered per tag, so the
    step loop's flag sync and the async writer's commit barriers, which
    run on two threads, never share a round number.  The generation id
    keeps a shrunk cluster's keys apart from its ancestor's."""

    def __init__(self, process_id: int, members: Sequence[int], kv,
                 *, timeout_s: float = 120.0, generation: int = 0,
                 namespace: str = "dl4j",
                 device_map: Optional[Dict[int, Tuple[int, ...]]] = None):
        self.process_id = int(process_id)
        self.members: Tuple[int, ...] = tuple(sorted(set(
            int(m) for m in members)))
        if self.process_id not in self.members:
            raise ValueError(
                f"process {process_id} is not a member of {self.members}")
        self.kv = kv
        self.timeout_s = timeout_s
        self.generation = generation
        self._namespace = namespace
        self._rounds: Dict[str, int] = {}
        self._lock = threading.Lock()
        #: member -> global device ids; None = one device a process, its
        #: rank (the simulated-cluster hook names virtual hosts)
        self.device_map = (None if device_map is None else
                           {int(m): tuple(int(i) for i in ids)
                            for m, ids in device_map.items()})

    # -- identity ----------------------------------------------------------
    @property
    def process_count(self) -> int:
        return len(self.members)

    @property
    def coordinator(self) -> int:
        """The lowest surviving member: a shrink re-elects without a
        message."""
        return self.members[0]

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == self.coordinator

    @property
    def member_rank(self) -> int:
        """This process's dense rank among the current members."""
        return self.members.index(self.process_id)

    def _next_round(self, tag: str) -> int:
        with self._lock:
            self._rounds[tag] = self._rounds.get(tag, 0) + 1
            return self._rounds[tag]

    def _key(self, tag: str, rnd: int, pid: int) -> str:
        return (f"{self._namespace}/g{self.generation}/{tag}/{rnd}/"
                f"p{pid}")

    def _publish(self, tag: str, rnd: int, value: str) -> None:
        """Put this member's round key and delete its key of round
        ``rnd - 2`` of the tag: a member starts round ``rnd`` only after
        every member finished reading round ``rnd - 2``."""
        if rnd > 2:
            self.kv.delete(self._key(tag, rnd - 2, self.process_id))
        self.kv.put(self._key(tag, rnd, self.process_id), value)

    # -- primitives --------------------------------------------------------
    def barrier(self, tag: str,
                timeout_s: Optional[float] = None) -> None:
        """Rendezvous of every current member; :class:`ClusterSyncTimeout`
        when one fails to show within the deadline."""
        if self.process_count == 1:
            return
        timeout = self.timeout_s if timeout_s is None else timeout_s
        rnd = self._next_round(tag)
        t0 = time.perf_counter()
        self._publish(tag, rnd, "1")
        for m in self.members:
            if m != self.process_id:
                self.kv.get(self._key(tag, rnd, m), timeout)
        multihost_metrics.note("barriers")
        multihost_metrics.note_wait((time.perf_counter() - t0) * 1e3)

    def any_flag(self, flag: bool, tag: str = "flag",
                 timeout_s: Optional[float] = None) -> bool:
        """Cluster-wide OR of a per-member boolean, the same verdict on
        every member in the same round (preemption propagation)."""
        if self.process_count == 1:
            return bool(flag)
        timeout = self.timeout_s if timeout_s is None else timeout_s
        rnd = self._next_round(tag)
        self._publish(tag, rnd, "1" if flag else "0")
        result = bool(flag)
        for m in self.members:
            if m != self.process_id:
                result = (self.kv.get(self._key(tag, rnd, m), timeout)
                          == "1") or result
        multihost_metrics.note("flag_syncs")
        return result

    def agree_lost_ids(self, local_ids: Iterable[int],
                       suspects: Iterable[int] = (),
                       timeout_s: Optional[float] = None
                       ) -> Tuple[int, ...]:
        """Union of every responsive member's lost-device view;
        ``suspects`` (members already believed dead) are not waited
        on."""
        mine = sorted(set(int(i) for i in local_ids))
        if self.process_count == 1:
            return tuple(mine)
        timeout = self.timeout_s if timeout_s is None else timeout_s
        suspects = set(int(s) for s in suspects)
        rnd = self._next_round("lost")
        self._publish("lost", rnd, json.dumps(mine))
        agreed = set(mine)
        for m in self.members:
            if m == self.process_id or m in suspects:
                continue
            agreed.update(json.loads(
                self.kv.get(self._key("lost", rnd, m), timeout)))
        return tuple(sorted(agreed))

    def gather(self, value: str, tag: str,
               timeout_s: Optional[float] = None
               ) -> Optional[Dict[int, str]]:
        """Every member publishes a blob; the coordinator gets the whole
        ``{member: blob}`` map, the others None."""
        if self.process_count == 1:
            return {self.process_id: value}
        timeout = self.timeout_s if timeout_s is None else timeout_s
        rnd = self._next_round(tag)
        self._publish(tag, rnd, value)
        if not self.is_coordinator:
            return None
        out = {self.process_id: value}
        for m in self.members:
            if m != self.process_id:
                out[m] = self.kv.get(self._key(tag, rnd, m), timeout)
        return out

    def exchange(self, value: str, tag: str,
                 timeout_s: Optional[float] = None) -> Dict[int, str]:
        """Every member publishes a blob and reads every member's."""
        if self.process_count == 1:
            return {self.process_id: value}
        timeout = self.timeout_s if timeout_s is None else timeout_s
        rnd = self._next_round(tag)
        self._publish(tag, rnd, value)
        out = {self.process_id: value}
        for m in self.members:
            if m != self.process_id:
                out[m] = self.kv.get(self._key(tag, rnd, m), timeout)
        return out

    def broadcast(self, value: str, tag: str,
                  timeout_s: Optional[float] = None) -> str:
        """The coordinator's blob, on every member (an :meth:`exchange`,
        so every member acknowledges the round)."""
        return self.exchange(value, tag, timeout_s)[self.coordinator]

    # -- device topology ---------------------------------------------------
    def devices_of(self, member: int) -> Tuple[int, ...]:
        """Global device ids (ranks) a member owns: ``device_map``'s, else
        ``(member,)``."""
        if self.device_map is not None:
            return self.device_map.get(int(member), ())
        return process_device_ids(int(member))

    def owners_of(self, device_ids: Iterable[int]) -> Tuple[int, ...]:
        """Members owning any of ``device_ids``."""
        wanted = set(int(i) for i in device_ids)
        return tuple(sorted(
            m for m in self.members
            if wanted & set(self.devices_of(m))))

    def shrink(self, lost_members: Iterable[int]) -> "Cluster":
        """The surviving cluster after a host loss: the same store, a new
        generation (fresh keys and rounds), the members minus the lost
        (the coordinator elected again).  The caller must survive."""
        lost = set(int(m) for m in lost_members)
        survivors = [m for m in self.members if m not in lost]
        if self.process_id in lost:
            raise ValueError(
                f"process {self.process_id} is itself among the lost "
                f"members {sorted(lost)} — an evicted process exits, "
                "it does not shrink")
        if not survivors:
            raise ValueError("no surviving members")
        return Cluster(self.process_id, survivors, self.kv,
                       timeout_s=self.timeout_s,
                       generation=self.generation + 1,
                       namespace=self._namespace,
                       device_map=self.device_map)


def local_cluster() -> Cluster:
    """The single-process cluster: every primitive is a no-op."""
    return Cluster(0, (0,), InProcessKV())


def active_cluster(timeout_s: float = 120.0) -> Cluster:
    """The cluster this process is in: the initialized group's ranks over
    its store, else :func:`local_cluster`."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() <= 1:
        return local_cluster()
    return Cluster(dist.get_rank(), range(dist.get_world_size()),
                   StoreKV(), timeout_s=timeout_s)


def process_device_ids(process_index: int) -> Tuple[int, ...]:
    """The devices process ``process_index`` drives: one, its rank."""
    return (int(process_index),)


# ---------------------------------------------------------------------------
# heartbeat-based host-loss detection
# ---------------------------------------------------------------------------

class HostHeartbeat:
    """Shared-filesystem heartbeats: each member's background thread
    rewrites ``<dir>/hb_p<pid>`` every ``interval_s``; a member whose file
    is ``timeout_s`` stale is presumed lost (a SIGKILL, a panic, a
    partition: failures that never say goodbye).
    :meth:`stale_members` is what ``ResilientFit`` consults when a
    control-plane operation or a collective fails;
    :meth:`lost_device_ids` names the loss in device ids."""

    def __init__(self, directory: str, cluster: Cluster,
                 interval_s: float = 2.0, timeout_s: float = 20.0):
        self.directory = directory
        self.cluster = cluster
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: grace anchor for a missing file (reset when the monitor
        #: starts): a peer whose first beat has not landed is not dead
        self._t0 = time.time()
        os.makedirs(directory, exist_ok=True)

    def _path(self, pid: int) -> str:
        return os.path.join(self.directory, f"hb_p{pid}")

    def _beat_once(self) -> None:
        path = self._path(self.cluster.process_id)
        with open(path + ".tmp", "w") as f:
            f.write(str(time.time()))
        os.replace(path + ".tmp", path)

    def _runner(self) -> None:
        while not self._stop.is_set():
            try:
                self._beat_once()
            except OSError:
                log.exception("heartbeat write failed")
            self._stop.wait(self.interval_s)

    def start(self) -> "HostHeartbeat":
        if self._thread is None:
            self._stop.clear()
            self._t0 = time.time()
            self._beat_once()          # visible before the first interval
            self._thread = threading.Thread(
                target=self._runner, name="host-heartbeat", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "HostHeartbeat":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def stale_members(self) -> Tuple[int, ...]:
        """Members (not self) whose heartbeat is older than
        ``timeout_s``, or missing a timeout after the monitor started."""
        now = time.time()
        stale = []
        for m in self.cluster.members:
            if m == self.cluster.process_id:
                continue
            try:
                age = now - os.path.getmtime(self._path(m))
            except OSError:
                age = now - self._t0
            if age > self.timeout_s:
                stale.append(m)
        if stale:
            multihost_metrics.note("heartbeat_stale_events")
        return tuple(stale)

    def lost_device_ids(self) -> Tuple[int, ...]:
        """Device ids owned by every currently stale member."""
        out = []
        for m in self.stale_members():
            out.extend(self.cluster.devices_of(m))
        return tuple(sorted(out))


# ---------------------------------------------------------------------------
# the data plane: ROADMAP A7.4
# ---------------------------------------------------------------------------

def _data_plane(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP A7.4: "
        f"the multi-host data plane)")


def global_data_mesh(model: int = 1, devices=None):
    """The data mesh spanning hosts (:492): ROADMAP A7.4."""
    raise _data_plane("global_data_mesh")


def worker_store_iterator(store, prefix: str, cluster: Cluster, **kwargs):
    """Each process's shard of a store stream (:513): ROADMAP A7.4."""
    raise _data_plane("worker_store_iterator")


def stage_global_batch(x, y, mesh, cluster: Optional[Cluster] = None):
    """Each process's rows of a global batch (:618): ROADMAP A7.4."""
    raise _data_plane("stage_global_batch")


def __getattr__(name: str):
    if name == "StagingMismatchError":
        raise _data_plane(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
