"""Self-healing training: in-step anomaly guards + checkpoint-rollback.

Port of ``deeplearning4j_tpu/runtime/resilience.py`` on one device.
Three levels of defense, cheapest first:

1. **In-step guards** (device, no host sync): the captured train step
   calls :func:`guard_update`, which checks (loss, grads) with
   :func:`tree_all_finite` and :func:`where_ok`-selects between the
   candidate update and the incoming state, so a step with a non-finite
   loss or gradient is a no-op that raises a ``skipped`` flag.  The
   select is part of the step's CUDA graph: the skip path and the
   healthy path are one capture.  :func:`note_skips` books a fit's flags
   with one host read.
2. **Host-side rollback** (:class:`ResilientFit`): periodic snapshots of
   (params, updater state) through ``runtime/checkpoint``'s
   :class:`~deeplearning4j_tpu_torch.runtime.checkpoint.AsyncCheckpointer`,
   a windowed :class:`LossSpikeDetector`, and on sustained anomaly a
   rollback to the last good checkpoint with the random streams
   re-derived, under a bounded retry budget with exponential backoff;
   ``resume`` / ``max_steps`` for bounded slices, and a
   :class:`PreemptionGuard` that turns SIGTERM/SIGINT into a final
   snapshot at the next step boundary.
3. **Aggregation hardening** (host): :func:`result_all_finite` lets an
   aggregator refuse a non-finite or corrupt worker result.

**Random streams.**  JAX folds keys; the port derives seeds.  A
``ResilientFit`` epoch's batch order is a permutation drawn from a CPU
``torch.Generator`` seeded by ``fold(seed, 7 + rollbacks, epoch)`` (the
reference's ``fold_in(fold_in(key, 7 + rollbacks), epoch)``), and each
step's dropout generator is re-seeded with ``fold(seed, rollbacks,
step)`` (the reference's ``fold_in(fold_in(key, rollbacks), step)``).
Both are pure functions of what a checkpoint's meta carries (the step
and the rollback count), so a resumed run replays them exactly with no
generator state in the snapshot, and a rollback, which bumps
``rollbacks``, reshuffles and redraws the retry.  The permutations are
not JAX's bits: runs match JAX only with ``shuffle=False`` and no
dropout.

Every skip, rollback and snapshot is counted in
``runtime.metrics.resilience_metrics`` / ``checkpoint_metrics``.

Not ported (each raises ``NotImplementedError`` naming ROADMAP A7):
``ResilientFit``'s ``mesh=`` and ``cluster=``, the distributed data
service input, a :class:`DeviceLossError` from ``fault_hook`` and the
elastic and host-loss recovery behind it (reference :773-987).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import signal
import statistics
import threading
import time
from typing import Any, Deque, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.updaters import tree_leaves, tree_map
from deeplearning4j_tpu_torch.runtime import compile_cache, telemetry
from deeplearning4j_tpu_torch.runtime.checkpoint import (AsyncCheckpointer,
                                                         CheckpointManager)
from deeplearning4j_tpu_torch.runtime.metrics import (checkpoint_metrics,
                                                      resilience_metrics)

log = logging.getLogger(__name__)

PyTree = Any


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP A7: "
        f"sharded, elastic and multi-host training)")


class DeviceLossError(RuntimeError):
    """A device dropped out of the mesh mid-run; ``lost_ids`` names the
    failed devices.  The elastic recovery that handles it is ROADMAP A7:
    ``ResilientFit`` raises ``NotImplementedError`` from it."""

    def __init__(self, lost_ids, message: Optional[str] = None):
        self.lost_ids = tuple(int(i) for i in lost_ids)
        super().__init__(
            message or f"device loss: ids {sorted(self.lost_ids)}")


# ---------------------------------------------------------------------------
# Preemption guard (SIGTERM/SIGINT -> final snapshot at a step boundary)
# ---------------------------------------------------------------------------

_GUARD_LOCK = threading.Lock()
_ACTIVE_GUARD: Optional["PreemptionGuard"] = None


def preemption_requested() -> bool:
    """One-global-read check the fit loops poll at every step boundary:
    True when an installed :class:`PreemptionGuard` has seen a
    preemption signal (or a programmatic :meth:`PreemptionGuard.request`).
    False when no guard is installed."""
    g = _ACTIVE_GUARD
    return g is not None and g.requested()


class PreemptionGuard:
    """SIGTERM/SIGINT-driven preemption flag.

    Cloud preemption is a notice, not a kill: a signal and a grace
    window.  The handler only sets a flag (async-signal-safe), and the
    training loop acts on it at the next step boundary: drain in-flight
    snapshots, write one final synchronous checkpoint, and return cleanly
    so a fresh process resumes with ``ResilienceConfig(resume=True)``.

    Use as a context manager (``ResilientFit.fit`` installs one around
    the loop when none is passed in).  Previous handlers are restored on
    exit; installation from a non-main thread, where Python forbids
    ``signal.signal``, degrades to the programmatic :meth:`request` path.
    Entering a guard that is already installed shares it (re-entrant).
    A SECOND delivery of a guarded signal while the flag is set restores
    the previous handler and re-raises, so a stuck graceful path stays
    killable."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,
                                                 signal.SIGINT)):
        self.signals = tuple(signals)
        self._requested = threading.Event()
        self._old: dict = {}
        self._installed = False
        self._prev_active: Optional["PreemptionGuard"] = None
        self._depth = 0
        self._booked = False
        self._book_lock = threading.Lock()

    def request(self) -> None:
        """Flag a preemption (the handler's body; also the programmatic
        drill hook).  The ONLY effect is ``Event.set()``: booking the
        metric, the event and the log line waits for :meth:`requested`,
        because this body runs in signal-handler context, where taking a
        lock the interrupted thread holds would deadlock."""
        self._requested.set()

    def requested(self) -> bool:
        r = self._requested.is_set()
        if r and not self._booked:
            with self._book_lock:
                if not self._booked:
                    self._booked = True
                    checkpoint_metrics.note("preemptions_requested")
                    telemetry.event("resilience.preemption_requested")
                    log.warning("preemption requested — will snapshot "
                                "and stop at the next step boundary")
        return r

    def _handler(self, signum, frame) -> None:
        if self._requested.is_set():
            # second delivery: hand the signal back so the process stays
            # killable (the default action: SIGTERM kills, SIGINT raises
            # KeyboardInterrupt).  No locks here: handler context.
            prev = self._old.get(signum)
            try:
                signal.signal(signum, prev if prev is not None
                              else signal.SIG_DFL)
            except (ValueError, TypeError):
                signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        self.request()

    def __enter__(self) -> "PreemptionGuard":
        global _ACTIVE_GUARD
        with _GUARD_LOCK:
            self._depth += 1
            if self._depth > 1 and self._installed:
                # re-entrant install: already live; re-registering would
                # capture OUR handler as the "previous" one
                return self
            # depth > 1 but not installed: first entered from a worker
            # thread; this entry may be the first on the main thread
        with _GUARD_LOCK:
            if not self._installed:
                try:
                    for s in self.signals:
                        self._old[s] = signal.signal(s, self._handler)
                    self._installed = True
                except ValueError:
                    # non-main thread: request() still works
                    for s, h in self._old.items():
                        try:
                            signal.signal(s, h)
                        except ValueError:
                            pass
                    self._old = {}
                    self._installed = False
            if _ACTIVE_GUARD is not self:
                self._prev_active = _ACTIVE_GUARD
                _ACTIVE_GUARD = self
        return self

    def __exit__(self, *exc) -> bool:
        global _ACTIVE_GUARD
        with _GUARD_LOCK:
            self._depth -= 1
            if self._depth > 0:
                return False    # outermost enter owns the teardown
        if self._installed:
            for s, h in self._old.items():
                try:
                    signal.signal(s, h)
                except ValueError:
                    # final exit on a non-main thread: the handlers stay
                    # until the process exits (safer than unguarded)
                    pass
            self._old = {}
            self._installed = False
        with _GUARD_LOCK:
            if _ACTIVE_GUARD is self:
                _ACTIVE_GUARD = self._prev_active
            else:
                # non-LIFO overlap (two fits on two threads, each with
                # its own guard): splice self out of the chain
                g = _ACTIVE_GUARD
                while g is not None and g._prev_active is not self:
                    g = g._prev_active
                if g is not None:
                    g._prev_active = self._prev_active
            self._prev_active = None
        return False


# ---------------------------------------------------------------------------
# In-step guards (used INSIDE captured steps: device ops, no host reads)
# ---------------------------------------------------------------------------

def tree_all_finite(tree: PyTree) -> torch.Tensor:
    """A 0-d bool tensor: every floating (or complex) tensor leaf is
    all-finite.  Integer and bool leaves are skipped; so are non-tensor
    leaves.  No host read, so it is safe inside a captured step."""
    checks = [torch.isfinite(leaf).all() for leaf in tree_leaves(tree)
              if isinstance(leaf, torch.Tensor)
              and (leaf.is_floating_point() or leaf.is_complex())]
    if not checks:
        dev = next((leaf.device for leaf in tree_leaves(tree)
                    if isinstance(leaf, torch.Tensor)), None)
        return torch.ones((), dtype=torch.bool, device=dev)
    return torch.stack(checks).all()


def where_ok(ok: torch.Tensor, new: PyTree, old: PyTree) -> PyTree:
    """Select ``new`` where ``ok`` (0-d bool) else ``old``, leafwise.
    The skip primitive: an elementwise select in the same graph as the
    step, never a branch.  A leaf the step left alone (``new is old``,
    e.g. AdaGrad's buffer when AdaGrad is off) needs no select."""
    return tree_map(lambda n, o: o if n is o else torch.where(ok, n, o),
                    new, old)


def guard_update(params: PyTree, ustate: PyTree, new_params: PyTree,
                 new_ustate: PyTree, *guard_values: PyTree):
    """The full in-step guard: check ``guard_values`` (typically
    ``(score, grads)``) for non-finites; on failure keep the incoming
    params and updater state.  Returns ``(params, ustate, skipped)``,
    ``skipped`` an int32 0-d tensor (1 = update dropped), so a fit sums
    its skips on the device without a host sync a step."""
    ok = tree_all_finite(guard_values)
    return (where_ok(ok, new_params, params),
            where_ok(ok, new_ustate, ustate),
            (~ok).to(torch.int32))


def note_skips(skips, where: str = "train") -> int:
    """Book guard-skipped steps into ``resilience_metrics`` with ONE host
    read for a whole fit.  ``skips`` is a list of per-step device flags
    or a flag tensor; returns the count.  The one implementation every
    guarded loop shares."""
    if skips is None:
        return 0
    if isinstance(skips, (list, tuple)):
        if not skips:
            return 0
        skips = torch.stack([torch.as_tensor(s) for s in skips])
    n = int(torch.as_tensor(skips).sum())
    if n:
        resilience_metrics.note("steps_skipped", n)
        telemetry.event("resilience.guard_skips", count=n, where=where)
        log.warning("non-finite loss/gradient: %d %s step update(s) "
                    "skipped by the in-step guard", n, where)
    return n


# ---------------------------------------------------------------------------
# Host-side checks (aggregation hardening, checkpoint validation)
# ---------------------------------------------------------------------------

def result_all_finite(result: PyTree) -> bool:
    """Host-side: a worker-posted result is a NUMERIC tree whose every
    float leaf is finite.  Non-numeric leaves (strings, objects) count as
    corrupt, as does anything that fails to flatten or materialize."""
    try:
        for leaf in tree_leaves(result):
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().cpu()
                if leaf.dtype == torch.bfloat16:
                    leaf = leaf.float()
            arr = np.asarray(leaf)
            if arr.dtype.kind not in "bifcu":
                return False
            if arr.dtype.kind in "fc" and not np.isfinite(arr).all():
                return False
        return True
    except Exception:  # noqa: BLE001 — corrupt payloads throw anything
        return False


def compiled_all_finite(tree: PyTree) -> bool:
    """Device-side all-finite reduction for HOST callers (validating a
    restored checkpoint without pulling every leaf to the host): one
    captured reduction through the compile engine and one host read.
    Shared module-wide; a new tree structure is a new signature."""
    fn = compile_cache.get_or_build(
        ("resilience_all_finite",),
        lambda: compile_cache.cached_graph(
            tree_all_finite, label="resilience.all_finite"))
    return bool(fn(tree))


# ---------------------------------------------------------------------------
# Loss-spike detection (host)
# ---------------------------------------------------------------------------

class LossSpikeDetector:
    """Windowed anomaly detector over the per-step loss stream.

    A step is *anomalous* when its loss is non-finite, or exceeds
    ``factor ×`` the median of the last ``window`` healthy losses.
    ``observe`` returns True only after ``patience`` CONSECUTIVE
    anomalies (transient bad batches are already neutralized by the
    in-step guard).  The baseline needs ``min_history`` healthy samples
    before spikes can fire at all."""

    def __init__(self, window: int = 20, factor: float = 3.0,
                 patience: int = 5, min_history: int = 5):
        self.window = window
        self.factor = factor
        self.patience = patience
        self.min_history = min_history
        self._healthy: Deque[float] = collections.deque(maxlen=window)
        self._streak = 0

    def observe(self, loss: float) -> bool:
        """Feed one step's loss; True == sustained anomaly (roll back)."""
        anomalous = not np.isfinite(loss)
        if (not anomalous and self._healthy
                and len(self._healthy) >= self.min_history):
            baseline = statistics.median(self._healthy)
            # an all-zero baseline makes any loss "a spike": require an
            # absolute floor so runs converged to zero don't fire
            anomalous = loss > max(abs(baseline) * self.factor, 1e-12) \
                and abs(baseline) > 0
        if anomalous:
            self._streak += 1
            resilience_metrics.note("spikes_detected")
        else:
            self._streak = 0
            self._healthy.append(loss)
        return self._streak >= self.patience

    def reset(self) -> None:
        """Forget the streak AND the baseline (after a rollback the run
        replays from an older loss regime)."""
        self._healthy.clear()
        self._streak = 0


# ---------------------------------------------------------------------------
# ResilientFit — checkpoint-rollback training loop
# ---------------------------------------------------------------------------

class RetryBudgetExceeded(RuntimeError):
    """Raised when sustained anomalies outlive the rollback budget."""


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs for :class:`ResilientFit`.

    ``checkpoint_every`` is in steps; ``max_rollbacks`` bounds the retry
    budget per fit call; ``backoff_s`` doubles per rollback.  ``resume``
    continues from the newest checkpoint in ``checkpoint_dir``;
    ``max_steps`` bounds how many steps THIS invocation runs before
    checkpointing and returning.  ``shuffle`` derives each epoch's batch
    order from (seed, rollbacks, epoch).

    Cadence snapshots are ASYNC by default (``checkpoint.
    AsyncCheckpointer``, at most ``max_in_flight`` pending, with
    backpressure); ``sync=True`` saves on the training thread.  The
    reference's multi-host knobs (``cluster_timeout_s``, ``hb_*``) come
    with ROADMAP A7, as does ``data_service``: True raises at ``fit``."""

    checkpoint_dir: str
    checkpoint_every: int = 50
    max_to_keep: int = 3
    spike_window: int = 20
    spike_factor: float = 3.0
    patience: int = 5
    min_history: int = 5
    max_rollbacks: int = 3
    backoff_s: float = 0.0
    resume: bool = False
    max_steps: Optional[int] = None
    shuffle: bool = True
    sync: bool = False
    max_in_flight: int = 2
    data_service: Optional[bool] = None

    def __post_init__(self) -> None:
        if self.checkpoint_every <= 0:
            raise ValueError(
                f"checkpoint_every must be a positive step count, "
                f"got {self.checkpoint_every}")
        if self.max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {self.max_in_flight}")


_MASK64 = (1 << 64) - 1


def fold(*parts: int) -> int:
    """A 63-bit seed from integers (splitmix64 over each part in turn):
    the port's counterpart of folding data into a JAX key."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = (h ^ (int(p) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        z = h
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        h = z ^ (z >> 31)
    return h >> 1


class ResilientFit:
    """Self-healing supervised training over a ``MultiLayerNetwork``: the
    per-step loop of ``fit_backprop`` plus auto-checkpointing, loss-spike
    detection, rollback, resume and preemption.

    ResilientFit consumes the network's captured engine step
    (``_backprop_machinery``), so the in-step guard and the compile
    engine's state handling apply unchanged; what it adds is host
    policy.  Checkpoints carry ``(params, updater state)`` with the step
    and rollback count in the sidecar meta, so a killed run resumes
    exactly (the momentum schedule's clock is the step; the random
    streams are derived from the step, see the module docstring).

    Engine state: the step's params, updater state and iteration counter
    are aliases of the engine's buffers, updated in place by the next
    step.  Snapshots stage their own copies (``AsyncCheckpointer``).
    Before a restore the loop drops its aliases, so the restored state
    is copied into the same, now free, state set: a rollback or resume
    costs no new capture.

    ``detector`` is injectable for tests and drills.  Cadence snapshots
    run through an :class:`AsyncCheckpointer` unless ``config.sync``.  A
    :class:`PreemptionGuard` is installed for the fit (pass
    ``preemption_guard=`` to share one): on a notice the loop stops at
    the next step boundary, drains, writes one final SYNC snapshot and
    returns with ``self.preempted = True``.  ``fault_hook(step)`` runs
    before each step (a drill hook); a :class:`DeviceLossError` from it
    raises ``NotImplementedError`` (elastic resume, ROADMAP A7), as do
    ``mesh=`` and ``cluster=``."""

    def __init__(self, net, config: ResilienceConfig,
                 detector: Optional[LossSpikeDetector] = None,
                 mesh=None, fault_hook=None,
                 preemption_guard: Optional[PreemptionGuard] = None,
                 cluster=None):
        if mesh is not None:
            raise _not_ported("ResilientFit(mesh=) sharded training")
        if cluster is not None:
            raise _not_ported("ResilientFit(cluster=) multi-host training")
        self.net = net
        self.mesh = None
        self.cluster = None
        self.config = config
        self.fault_hook = fault_hook
        self.preemption_guard = preemption_guard
        self.manager = CheckpointManager(config.checkpoint_dir,
                                         max_to_keep=config.max_to_keep)
        self.async_ckpt = None if config.sync else AsyncCheckpointer(
            self.manager, max_in_flight=config.max_in_flight)
        self.detector = detector or LossSpikeDetector(
            window=config.spike_window, factor=config.spike_factor,
            patience=config.patience, min_history=config.min_history)
        #: filled by fit(): steps run, rollbacks performed, preemption
        self.steps_run = 0
        self.rollbacks = 0
        self.preempted = False

    def _recycle_writer(self, suppress_errors: bool) -> None:
        """close() the async checkpointer (drain + stop the writer), then
        stand up a fresh one so a later ``fit(resume=True)`` works.
        ``suppress_errors``: an exception is already propagating."""
        if self.async_ckpt is None:
            return
        try:
            self.async_ckpt.close()
        except Exception:
            if not suppress_errors:
                raise
            log.exception("checkpoint writer shutdown failed while "
                          "handling a fit error")
        finally:
            self.async_ckpt = AsyncCheckpointer(
                self.manager, max_in_flight=self.config.max_in_flight)

    @contextlib.contextmanager
    def _writer_guard(self):
        """Error exits must not strand queued async snapshots uncommitted
        or leak the writer thread."""
        try:
            yield
        except BaseException:
            self._recycle_writer(suppress_errors=True)
            raise

    def _drain(self) -> None:
        """Wait for every in-flight async snapshot to COMMIT (the
        precondition for any restore and for the final snapshot)."""
        if self.async_ckpt is not None:
            self.async_ckpt.wait_until_finished()

    @staticmethod
    def _check_restored(params: PyTree, at_step) -> None:
        """A rollback target or resume point must itself be healthy
        (one captured reduction, one host read)."""
        if not compiled_all_finite(params):
            raise RuntimeError(
                f"checkpoint at step {at_step} contains non-finite "
                "params — refusing to restore a poisoned state")

    # -- deterministic schedule -------------------------------------------
    def _epoch_order(self, seed: int, rollbacks: int, epoch: int,
                     n_batches: int) -> List[int]:
        """Batch visit order for one epoch: a pure function of (seed,
        rollbacks, epoch), memoized per that key (asked once a
        step)."""
        if not self.config.shuffle or n_batches <= 1:
            return list(range(n_batches))
        memo_key = (seed, rollbacks, epoch, n_batches)
        if getattr(self, "_order_memo_key", None) != memo_key:
            g = torch.Generator().manual_seed(fold(seed, 7 + rollbacks,
                                                   epoch))
            self._order_memo_key = memo_key
            self._order_memo = torch.randperm(n_batches,
                                              generator=g).tolist()
        return self._order_memo

    # -- machinery ---------------------------------------------------------
    def _build_dispatch(self, net):
        """``(dispatch, updaters)`` over the network's captured step."""
        train_step, updaters = net._backprop_machinery(self.mesh)
        self._train_step = train_step

        def dispatch(params, ustate, it, batch, gen):
            from deeplearning4j_tpu_torch.nn.multilayer import _as_tensor
            return train_step(params, ustate, it,
                              _as_tensor(batch.features, net.device),
                              _as_tensor(batch.labels, net.device), gen)
        return dispatch, updaters

    def _make_ustate(self, updaters, params):
        """Fresh updater state by the network's own policy."""
        return self.net._init_ustate(self._train_step, updaters, params)

    def _restore_latest(self, net, updaters):
        """Restore the newest COMMITTED checkpoint (corrupt or
        uncommitted steps fall back to the previous good one) against
        fresh templates on the network's device."""
        tpl_p = [tree_map(torch.clone, p) for p in net._require_params()]
        tpl_u = self._make_ustate(updaters, tpl_p)
        (params, ustate), meta = self.manager.restore(like=(tpl_p, tpl_u))
        self._check_restored(params, meta.get("step"))
        return params, ustate, meta

    def _elastic_resume(self, err: DeviceLossError, net):
        """Re-mesh over the survivors and restore (reference :884)."""
        raise _not_ported("elastic resume after a device loss") from err

    def _counter(self, step: int, device) -> torch.Tensor:
        """The step's iteration counter (the momentum schedule's clock)
        as a fresh device tensor: the engine copies it into its state."""
        return torch.full((), step, dtype=torch.int32, device=device)

    # -- the loop ----------------------------------------------------------
    def fit(self, data, num_epochs: int = 1, seed: int = 2):
        """Train to completion (or ``max_steps``, or a preemption
        notice), healing as it goes.  Returns the network with trained
        params set; ``self.preempted`` reports a preemption stop."""
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet

        cfg = self.config
        net = self.net
        if cfg.data_service or type(data).__name__ == "DataService":
            raise _not_ported("ResilientFit over the distributed data "
                              "service")
        batches = [data] if isinstance(data, DataSet) else list(data)
        n_batches = len(batches)
        total_steps = num_epochs * n_batches
        notify = getattr(net, "_notify_fit_start", None)
        if callable(notify):
            notify()
        else:
            for ls in getattr(net, "listeners", ()):
                hook = getattr(ls, "on_fit_start", None)
                if callable(hook):
                    hook(net)

        dev = net.device
        # a caller's state: the engine copies it into its own buffers
        params = [tree_map(torch.clone, p) for p in net._require_params()]
        dispatch, updaters = self._build_dispatch(net)
        ustate = self._make_ustate(updaters, params)
        gen = torch.Generator(device=dev)

        step = 0
        rollbacks = 0
        self.preempted = False
        restored = False
        if cfg.resume:
            latest = self.manager.latest_step()
            if latest is None:
                log.warning(
                    "resume=True but no checkpoints in %s — starting "
                    "from scratch (wrong path or unmounted volume?)",
                    cfg.checkpoint_dir)
            else:
                params = ustate = None
                with telemetry.span("resilience.restore", resume=True):
                    params, ustate, meta = self._restore_latest(
                        net, updaters)
                step = int(meta["step"])
                rollbacks = int(meta.get("rollbacks", 0))
                restored = True
                telemetry.event("resilience.resume", step=step,
                                rollbacks=rollbacks)
                log.info("resumed from checkpoint at step %d "
                         "(rollbacks=%d)", step, rollbacks)
        it = self._counter(step, dev)

        def save(at_step: int, sync: bool = False) -> None:
            """Cadence snapshot: async by default, synchronous for the
            preemption / bounded-slice final snapshot."""
            meta = {"rollbacks": rollbacks}
            if self.async_ckpt is None or sync:
                with telemetry.span("resilience.checkpoint",
                                    step=at_step, mode="sync"):
                    self.manager.save(at_step, (params, ustate), meta=meta)
            else:
                with telemetry.span("resilience.checkpoint",
                                    step=at_step, mode="async"):
                    self.async_ckpt.save(at_step, (params, ustate),
                                         meta=meta)
            resilience_metrics.note("checkpoints_saved")

        if not restored:
            existing = self.manager.all_steps()
            if existing:
                # a fresh run cannot share a directory with another
                # run's snapshots: retention keys on the step number,
                # and a later resume would adopt the stale state
                raise ValueError(
                    f"checkpoint_dir {cfg.checkpoint_dir!r} already "
                    f"holds snapshots (steps {existing}); pass "
                    "resume=True to continue that run, or point at a "
                    "fresh directory")
            # THIS run's rollback target exists before the first cadence
            save(step)

        last_good = step
        skips: List[torch.Tensor] = []
        steps_this_call = 0
        guard = self.preemption_guard or PreemptionGuard()

        with self._writer_guard(), guard:
            while step < total_steps:
                if guard.requested():
                    self._drain()
                    save(step, sync=True)
                    checkpoint_metrics.note("preemption_snapshots")
                    telemetry.event("resilience.preempted", step=step)
                    log.warning("preempted at step %d: final snapshot "
                                "committed, exiting cleanly", step)
                    self.preempted = True
                    break
                if cfg.max_steps is not None \
                        and steps_this_call >= cfg.max_steps:
                    # bounded slice: persist exactly where we stop
                    self._drain()
                    save(step, sync=True)
                    break
                epoch, pos = divmod(step, n_batches)
                order = self._epoch_order(seed, rollbacks, epoch, n_batches)
                batch = batches[order[pos]]
                gen.manual_seed(fold(seed, rollbacks, step))
                try:
                    if self.fault_hook is not None:
                        self.fault_hook(step)
                except DeviceLossError as e:
                    self._elastic_resume(e, net)
                params, ustate, it, score, skipped = dispatch(
                    params, ustate, it, batch, gen)
                skips.append(skipped)
                loss = float(score)
                steps_this_call += 1
                if net.listeners:
                    for ls in net.listeners:
                        ls.iteration_done(net, step, loss)
                if self.detector.observe(loss):
                    if rollbacks >= cfg.max_rollbacks:
                        resilience_metrics.note("retry_budget_exceeded")
                        telemetry.event(
                            "resilience.retry_budget_exceeded",
                            step=step, rollbacks=rollbacks)
                        raise RetryBudgetExceeded(
                            f"loss anomaly survived {cfg.max_rollbacks} "
                            f"rollbacks (last-good step {last_good}); "
                            "refusing to burn more compute")
                    rollbacks += 1
                    resilience_metrics.note("rollbacks")
                    telemetry.event("resilience.rollback", step=step,
                                    to_step=int(last_good),
                                    rollbacks=rollbacks)
                    delay = cfg.backoff_s * (2 ** (rollbacks - 1))
                    log.warning(
                        "sustained loss anomaly at step %d; rolling back "
                        "to step %s (rollback %d/%d, backoff %.2fs)",
                        step, last_good, rollbacks, cfg.max_rollbacks,
                        delay)
                    if delay > 0:
                        time.sleep(delay)
                    self._drain()   # the rollback target must be on disk
                    # drop the step's aliases first: the restored state
                    # then lands in the same, free, state set
                    params = ustate = it = None
                    with telemetry.span("resilience.restore",
                                        step=int(last_good)):
                        params, ustate, meta = self._restore_latest(
                            net, updaters)
                    step = int(meta["step"])
                    it = self._counter(step, dev)
                    last_good = step
                    self.detector.reset()
                    continue
                step += 1
                if step % cfg.checkpoint_every == 0 and step < total_steps:
                    save(step)
                    last_good = step

        n_skipped = note_skips(skips, where="resilient-fit")
        if n_skipped and hasattr(net, "guard_skips"):
            net.guard_skips += n_skipped
        self.steps_run = steps_this_call
        self.rollbacks = rollbacks
        # trained params belong to the caller regardless of the writer's
        # health; a clone, so the step's state set is free for the next
        # fit of this conf
        net.params = [tree_map(torch.clone, p) for p in params]
        params = ustate = it = None
        # every async snapshot committed before fit returns; a fresh
        # checkpointer takes the writer's place for a later fit
        self._recycle_writer(suppress_errors=False)
        return net
