"""Replicated decode serving: least-depth routing, load shedding and the
fleet that grows, shrinks, swaps weights and heals itself.

Port of ``deeplearning4j_tpu/serving/router.py``:

- :class:`Router` holds N ``ContinuousBatcher`` front ends and submits
  each request to the least loaded (pending + in-flight depth).
- When even the least loaded replica is at ``max_queue_depth``, the
  request is shed with the typed :class:`OverloadedError`, booked in
  ``runtime.metrics.decode_metrics.requests_shed`` and, when tracing, as
  a ``decode.shed`` event: an immediate, typed rejection a client can
  retry, not a timeout.
- :meth:`Router.replicate` builds the replicas, each a
  ``DecodeEngine`` and a batcher of its own, round-robin over
  ``devices`` (default: the one card).  Several replicas on one card
  each capture their own graphs and replay them from their own worker
  thread.
- :class:`AutoscalePolicy` (:256) is a hysteresis state machine over the
  mean queue depth and the TTFT p99; :class:`AutoscalingRouter` (:370)
  spawns replicas from a FACTORY on its verdicts (and at once, on the
  submitting thread, when every replica is at the bound), drains the
  ones it retires in the background, walks a brownout ladder
  (speculation off, then prefix harvesting off) before it sheds at its
  ceiling, swaps the weights of a live fleet one replica at a time
  (:meth:`AutoscalingRouter.swap_weights`, :class:`SwapFailed`), and,
  given a :class:`ReplicaHealth`, replaces a replica whose worker died,
  keeps failing or stalls, replaying its requests on the replacement.

**Captures.**  Where the reference's factory clone hits a shared XLA
cache, every port replica captures its own CUDA graphs, bound to its own
KV state and weight buffers: a replica the factory builds costs exactly
the captures of one ``warmup()`` (its ``"compiles"``), and after that
none.  A swap, a rebind, a replay, a brownout transition and the health
monitor cost none.  A spawn captures on the thread that runs the factory
(the spawn thread, a submitting client, the monitor) while the other
replicas' workers replay their graphs: each engine captures and replays
on a CUDA stream of its own, in ``capture_error_mode="thread_local"``,
one capture at a time in the process, with cuBLAS's workspace in the
graph's own pool, and each replica replays only its own graphs on its
own buffers.

**Model groups.**  ``Router.replicate(model_degree=m > 1)`` runs SPMD
over an initialized process group of W ranks (every rank calls it with
the same arguments): the ranks form W / m consecutive groups of m, and
the replicas go round-robin over the groups, each a model-sharded
``DecodeEngine`` over its group (a mesh of its own, so two replicas on
one group share no communicator, whose collectives time out after
``ContinuousBatcher.GROUP_TIMEOUT_S``) under a ``ContinuousBatcher``
whose leader broadcasts its schedule.  The router itself runs on global rank
0, the reference's single controller: a replica on rank 0's group is
led from rank 0; a replica on another group is led from rank 0 too,
over a control group of rank 0 and the replica's group, its model rank
0 sending each op's result (admission, first token, step tokens) back.
The returned router is the controller on rank 0 and holds the
followers elsewhere (``submit`` there raises; ``close`` waits for rank
0's).
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
from deeplearning4j_tpu_torch.serving.decode import (BatcherClosed,
                                                     ContinuousBatcher,
                                                     DecodeEngine,
                                                     DecodeRequest,
                                                     _ReplayRequest)

__all__ = ["AutoscalePolicy", "AutoscalingRouter", "OverloadedError",
           "ReplicaHealth", "Router", "RouterClosed", "SwapFailed"]


class RouterClosed(RuntimeError):
    """Typed rejection for a submit racing ``close()``: a request is
    either accepted by a replica (and drains to completion) or rejected
    with this; never a hang."""


class SwapFailed(TimeoutError):
    """Typed ``swap_weights`` drain failure (:80): a replica did not
    reach depth zero within the timeout.  Carries the per-replica drain
    states (depth, worker liveness, draining flag) at the failure, so a
    WEDGED drain (depth pinned, worker dead or stalled) reads apart from
    a slow one.  A ``TimeoutError``, so existing handlers keep working.
    The fleet is left serving: swapped replicas keep the new weights,
    the rest the old."""

    def __init__(self, timeout: float,
                 drain_states: Dict[int, Dict[str, Any]],
                 swapped: int):
        super().__init__(
            f"weight swap failed: a replica did not drain within "
            f"{timeout}s ({swapped} replica(s) swapped); per-replica "
            f"drain states: {drain_states}")
        self.timeout = timeout
        self.drain_states = drain_states
        self.swapped = swapped


class ReplicaHealth:
    """Thresholds of the router's replica health monitor (:102).  Every
    signal is a host field; the monitor never touches the card:

    - ``worker_alive()`` False: the decode worker thread died, and every
      accepted request is stranded;
    - ``dispatch_error_streak >= max_error_streak``: consecutive failed
      dispatches without a successful advance;
    - ``progress_age() > stall_after_s`` while ``depth() > 0``: the
      worker has neither admitted nor advanced anything though it has
      work (a wedged dispatch or a livelocked loop)."""

    def __init__(self, poll_interval_s: float = 0.25, *,
                 max_error_streak: int = 3,
                 stall_after_s: float = 5.0):
        if poll_interval_s <= 0:
            raise ValueError(
                f"poll_interval_s must be > 0: {poll_interval_s}")
        if max_error_streak < 1:
            raise ValueError(
                f"max_error_streak must be >= 1: {max_error_streak}")
        if stall_after_s <= 0:
            raise ValueError(
                f"stall_after_s must be > 0: {stall_after_s}")
        self.poll_interval_s = float(poll_interval_s)
        self.max_error_streak = int(max_error_streak)
        self.stall_after_s = float(stall_after_s)


class OverloadedError(RuntimeError):
    """Typed load-shed rejection: every replica is at the router's
    queue-depth bound.  Carries the least depth seen, the bound and the
    replica count."""

    def __init__(self, depth: int, bound: int, replicas: int):
        super().__init__(
            f"all {replicas} decode replica(s) at queue depth >= "
            f"{bound} (least-loaded: {depth}); request shed")
        self.depth = depth
        self.bound = bound
        self.replicas = replicas


def _on_device(params: Any, dev) -> Any:
    """``params`` (a tree of tensors or numpy arrays) on ``dev``; tensors
    already there are shared, not copied."""
    import torch

    if isinstance(params, dict):
        return {k: _on_device(v, dev) for k, v in params.items()}
    if isinstance(params, torch.Tensor):
        return params.to(dev)
    if isinstance(params, np.ndarray):
        return torch.from_numpy(np.array(params)).to(dev)
    return params


class Router:
    """Least-depth dispatch over N ``ContinuousBatcher`` replicas with a
    hard queue-depth admission bound (:146)."""

    def __init__(self, batchers: Sequence[ContinuousBatcher], *,
                 max_queue_depth: int = 64):
        if not batchers:
            raise ValueError("Router needs at least one batcher")
        self._setup(batchers, max_queue_depth)

    def _setup(self, batchers, max_queue_depth: int) -> None:
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1: {max_queue_depth}")
        self.batchers = list(batchers)
        self.max_queue_depth = int(max_queue_depth)
        self._closed = False
        #: requests routed to each replica
        self.routed = [0] * len(self.batchers)
        # one pick-submit-count at a time: client threads read the same
        # depths and bump the same counts
        self._lock = threading.Lock()

    # -- construction ------------------------------------------------------
    @classmethod
    def replicate(cls, cfg, params: Any, n_replicas: Optional[int] = None,
                  *, model_degree: int = 1,
                  devices: Optional[Sequence[DeviceLike]] = None,
                  max_queue_depth: int = 64,
                  n_slots: int = 8,
                  buckets: Optional[Sequence[int]] = None,
                  prefill_chunk: Optional[int] = None,
                  default_max_tokens: int = 64,
                  warmup: bool = True,
                  device: DeviceLike = None) -> "Router":
        """N engine + batcher replicas of one model (:161), round-robin
        over ``devices`` (default ``[device]``, and ``device`` None means
        the card); ``n_replicas=None`` gives one a device.  ``params``
        is a tree of tensors or numpy arrays, placed once a device.
        Paged, prefix-store or speculative replicas are built as
        ``Router([ContinuousBatcher(DecodeEngine(...)), ...])``.
        ``model_degree=m > 1``: replicas over the model groups of the
        initialized process group (the module docstring; ``device`` is
        this rank's, ``n_replicas=None`` gives one a group); an ``m``
        the ranks cannot fill raises ``ValueError``."""
        from deeplearning4j_tpu_torch.models import gpt

        if model_degree < 1:
            raise ValueError(f"model_degree must be >= 1: {model_degree}")
        if model_degree > 1:
            return cls._replicate_groups(
                cfg, params, n_replicas, model_degree, device=device,
                max_queue_depth=max_queue_depth, n_slots=n_slots,
                buckets=buckets, prefill_chunk=prefill_chunk,
                default_max_tokens=default_max_tokens, warmup=warmup)
        devs = [resolve_device(d) for d in
                (devices if devices is not None else [device])]
        if not devs:
            raise ValueError("Router.replicate needs at least one device")
        if n_replicas is None:
            n_replicas = len(devs)
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1: {n_replicas}")
        chunk = prefill_chunk or gpt.PREFILL_CHUNK
        placed = {}
        engines = []
        for i in range(n_replicas):
            dev = devs[i % len(devs)]
            if dev not in placed:
                placed[dev] = _on_device(params, dev)
            eng = DecodeEngine(cfg, placed[dev], n_slots=n_slots,
                               buckets=buckets, prefill_chunk=chunk,
                               device=dev)
            if warmup:
                eng.warmup()
            engines.append(eng)
        return cls([ContinuousBatcher(e, default_max_tokens=default_max_tokens)
                    for e in engines], max_queue_depth=max_queue_depth)

    @classmethod
    def _replicate_groups(cls, cfg, params, n_replicas, m: int, *, device,
                          max_queue_depth, n_slots, buckets, prefill_chunk,
                          default_max_tokens, warmup) -> "Router":
        import torch.distributed as dist
        from deeplearning4j_tpu_torch.models import gpt
        from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        from deeplearning4j_tpu_torch.serving.decode import (_Channel,
                                                             _RemoteEngine)

        world = dist.get_world_size() if dist.is_initialized() else 1
        n_groups = world // m
        if n_groups < 1 or world % m:
            raise ValueError(
                f"model_degree {m} does not fill the {world} rank(s) of the "
                f"process group with whole groups: a replica needs one "
                f"whole group")
        if n_replicas is None:
            n_replicas = n_groups
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1: {n_replicas}")
        me = dist.get_rank()
        chunk = prefill_chunk or gpt.PREFILL_CHUNK
        placed = None
        batchers = []
        wait = ContinuousBatcher.GROUP_TIMEOUT_S
        for i in range(n_replicas):
            gi = i % n_groups
            members = list(range(gi * m, (gi + 1) * m))
            # every rank makes every replica's groups, in this order; a
            # model-group collective a peer never joins raises after
            # `wait` seconds
            mesh = make_mesh(MeshSpec(data=n_groups, model=m),
                             device=device, timeout=wait)
            ctrl = None
            if 0 not in members:
                group = dist.new_group(
                    [0] + members,
                    timeout=datetime.timedelta(seconds=2 * wait))
                if me == 0 or me in members:
                    ctrl = _Channel(group, 0, members[0], mesh.device, wait,
                                    mesh.timeout_s)
            if me in members:
                if placed is None:
                    placed = _on_device(params, mesh.device)
                eng = DecodeEngine(cfg, placed, n_slots=n_slots,
                                   buckets=buckets, prefill_chunk=chunk,
                                   mesh=mesh, device=mesh.device)
                if warmup:
                    eng.warmup()
                batchers.append(ContinuousBatcher(
                    eng, default_max_tokens=default_max_tokens,
                    _channel=ctrl))
            elif me == 0:
                batchers.append(ContinuousBatcher(
                    _RemoteEngine(cfg, ctrl, n_slots=n_slots,
                                  buckets=buckets, model_degree=m),
                    default_max_tokens=default_max_tokens, _channel=ctrl))
        router = cls.__new__(cls)
        router._setup(batchers, max_queue_depth)
        return router

    # -- dispatch ----------------------------------------------------------
    def depths(self) -> List[int]:
        return [b.depth() for b in self.batchers]

    def submit(self, prompt, **kw) -> DecodeRequest:
        """Route one request to the least-loaded replica; shed with
        :class:`OverloadedError` when every replica is at the bound."""
        with self._lock:
            if self._closed:
                raise RouterClosed("Router is closed")
            if not all(b.leads for b in self.batchers) or not self.batchers:
                raise RuntimeError("this rank follows its groups' "
                                   "schedules: submit on global rank 0")
            depths = self.depths()
            i = int(np.argmin(depths))
            if depths[i] >= self.max_queue_depth:
                decode_metrics.note_shed()
                telemetry.event("decode.shed", depth=depths[i],
                                bound=self.max_queue_depth,
                                replicas=len(self.batchers))
                raise OverloadedError(depths[i], self.max_queue_depth,
                                      len(self.batchers))
            req = self.batchers[i].submit(prompt, **kw)
            self.routed[i] += 1
            return req

    def generate(self, prompt, timeout: Optional[float] = 120.0,
                 **kw) -> np.ndarray:
        return self.submit(prompt, **kw).result(timeout)

    # -- lifecycle ---------------------------------------------------------
    def close(self, timeout: float = 120.0) -> None:
        with self._lock:
            self._closed = True
        for b in self.batchers:
            b.close(timeout)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AutoscalePolicy:
    """Hysteresis state machine turning live load signals into scale
    verdicts (:256).  Pure host logic, clock-injected, no I/O.

    An observation is HOT when the mean per-replica depth exceeds
    ``high_depth``, or when the TTFT p99 exceeds ``ttft_p99_slo_ms``
    (when set) WHILE there is live load (depth >= ``low_depth``: the
    p99 reservoir is cumulative, and a past spike must not pin an idle
    fleet at its ceiling); COLD when the depth is under ``low_depth``
    and it is not hot.  ``observe`` returns ``"up"`` only after
    ``up_after`` CONSECUTIVE hot observations, ``"down"`` after
    ``down_after`` consecutive cold ones (a mixed observation resets
    both streaks), and never within ``cooldown_s`` of the previous
    action, so a load oscillating around a threshold holds the fleet
    steady.  Observations closer than ``interval_s`` apart are ignored
    (the router observes on every submit).  ``"up"`` is never returned
    at ``max_replicas``, nor ``"down"`` at ``min_replicas``.

    ``ttft_p99_slo_ms`` reads the process-wide ``decode_metrics`` TTFT
    reservoir: with one router in a process it is this router's own
    signal; a process with several should scale on the depths, which
    are always this router's own."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4, *,
                 high_depth: float = 8.0, low_depth: float = 1.0,
                 ttft_p99_slo_ms: Optional[float] = None,
                 up_after: int = 2, down_after: int = 6,
                 cooldown_s: float = 5.0, interval_s: float = 0.25):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas: "
                f"{min_replicas}, {max_replicas}")
        if not 0 < low_depth < high_depth:
            # low_depth = 0 would make `cold` (depth < low) unreachable,
            # and the SLO signal's live-load guard vacuous at idle
            raise ValueError(
                f"need 0 < low_depth < high_depth: "
                f"{low_depth}, {high_depth}")
        if up_after < 1 or down_after < 1:
            raise ValueError("up_after/down_after must be >= 1")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.high_depth = float(high_depth)
        self.low_depth = float(low_depth)
        self.ttft_p99_slo_ms = ttft_p99_slo_ms
        self.up_after = int(up_after)
        self.down_after = int(down_after)
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self._hot_streak = 0
        self._cold_streak = 0
        self._last_obs: Optional[float] = None
        self._last_action: Optional[float] = None

    def due(self, now: Optional[float] = None) -> bool:
        """Would :meth:`observe` take an observation at ``now``?
        Read-only: the router checks it before paying for the metrics
        snapshot an observation reads."""
        now = time.monotonic() if now is None else now
        return self._last_obs is None \
            or now - self._last_obs >= self.interval_s

    def observe(self, mean_depth: float,
                ttft_p99_ms: Optional[float],
                n_replicas: int,
                now: Optional[float] = None) -> str:
        """One load observation -> ``"up"`` / ``"down"`` / ``"hold"``.
        Not thread-safe on its own; the router calls it under its
        lock."""
        now = time.monotonic() if now is None else now
        if self._last_obs is not None \
                and now - self._last_obs < self.interval_s:
            return "hold"
        self._last_obs = now
        slo_hot = (self.ttft_p99_slo_ms is not None
                   and ttft_p99_ms is not None
                   and ttft_p99_ms > self.ttft_p99_slo_ms
                   and mean_depth >= self.low_depth)
        hot = mean_depth > self.high_depth or slo_hot
        cold = not hot and mean_depth < self.low_depth
        if hot:
            self._hot_streak += 1
            self._cold_streak = 0
        elif cold:
            self._cold_streak += 1
            self._hot_streak = 0
        else:
            self._hot_streak = self._cold_streak = 0
        cooled = self._last_action is None \
            or now - self._last_action >= self.cooldown_s
        if hot and self._hot_streak >= self.up_after and cooled \
                and n_replicas < self.max_replicas:
            self._hot_streak = self._cold_streak = 0
            self._last_action = now
            return "up"
        if cold and self._cold_streak >= self.down_after and cooled \
                and n_replicas > self.min_replicas:
            self._hot_streak = self._cold_streak = 0
            self._last_action = now
            return "down"
        return "hold"


class AutoscalingRouter(Router):
    """Least-depth dispatch over a DYNAMIC fleet (:370): replicas come
    from ``factory``, a zero-argument callable returning a warmed
    ``ContinuousBatcher``, and retire on the policy's verdicts.

    - every ``submit`` feeds one (rate-limited) observation to the
      policy through :meth:`tick` and applies its verdict; a policy
      scale-up builds its replica on a spawn thread, off the lock;
    - a submit that finds even the least-loaded replica at
      ``max_queue_depth`` scales up AT ONCE below ``max_replicas``, on
      the submitting thread under the lock (later submitters wait rather
      than pile onto an overloaded fleet); at the ceiling it walks the
      brownout ladder, and sheds (``OverloadedError``, booked as
      ``shed_by_policy``) only from its top;
    - each replica the factory builds costs the captures of its own
      ``warmup()`` (the module docstring), and nothing after;
    - scale-down pops the newest replica and drains it on a background
      thread (accepted requests run to completion; ``close()`` joins the
      drains).

    The static router's ``routed`` counts are not kept: replicas come
    and go."""

    def __init__(self, factory: Callable[[], ContinuousBatcher],
                 policy: Optional[AutoscalePolicy] = None, *,
                 max_queue_depth: int = 64,
                 health: Optional[ReplicaHealth] = None):
        self.factory = factory
        self.policy = policy or AutoscalePolicy()
        self.health = health
        super().__init__([factory()
                          for _ in range(self.policy.min_replicas)],
                         max_queue_depth=max_queue_depth)
        # re-entrant: the emergency spawn and replace_replica run the
        # factory under it, from paths that already hold it
        self._lock = threading.RLock()
        self._drains: List[threading.Thread] = []
        self._spawning = False
        self._swapping = False
        # the brownout ladder (0 normal, 1 speculative decoding off, 2
        # prefix harvesting off too): climbed under pressure BEFORE
        # shedding, walked back down by tick() once the fleet cools
        self._brownout = 0
        # replicas out of routing (identity set): swap_weights drains
        # one replica at a time through here while the rest serve
        self._draining: set = set()
        self._monitor_stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        if health is not None:
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="dl4j-health-monitor",
                daemon=True)
            self._monitor.start()

    # -- construction ------------------------------------------------------
    @classmethod
    def replicate(cls, *a, **kw):
        """Not supported: the autoscaling router is built from a replica
        FACTORY (its constructor), not a fixed replica list."""
        raise TypeError(
            "AutoscalingRouter.replicate is not supported: construct "
            "AutoscalingRouter(factory, AutoscalePolicy(...)) with a "
            "zero-arg factory returning a warmed ContinuousBatcher "
            "(use Router.replicate for a fixed fleet)")

    # -- scaling -----------------------------------------------------------
    def n_replicas(self) -> int:
        with self._lock:
            return len(self.batchers)

    def depths(self) -> List[int]:
        with self._lock:
            batchers = list(self.batchers)
        return [b.depth() for b in batchers]

    def _retire(self, target: Callable[[], None], name: str) -> None:
        """Run ``target`` (a policy spawn, or a retired replica's
        close) on a background thread that ``close()`` joins; finished
        ones are pruned, so an oscillating fleet keeps no dead threads.
        A finished thread drops its target, so a retired replica is let
        go."""
        t = threading.Thread(target=target, name=name, daemon=True)
        with self._lock:
            self._drains = [d for d in self._drains if d.is_alive()]
            self._drains.append(t)
        t.start()

    def tick(self, now: Optional[float] = None) -> str:
        """Feed one observation to the policy and apply its verdict
        (:445).  Called by every submit; call it on its own (an idle
        loop) so a fleet scales DOWN after traffic stops and the
        brownout ladder walks back."""
        now_v = time.monotonic() if now is None else now
        with self._lock:
            # the interval gate first: the common per-submit call
            # returns here without the metrics snapshot
            if self._closed or not self.policy.due(now_v):
                return "hold"
            depths = [b.depth() for b in self.batchers]
            mean = sum(depths) / len(depths)
            ttft = decode_metrics.snapshot()["ttft_p99_ms"]
            action = self.policy.observe(mean, ttft, len(self.batchers),
                                         now=now_v)
            if action == "up":
                self._scale_up_async()
            elif action == "down":
                self._scale_down()
            if self._brownout and mean <= max(1.0,
                                              self.max_queue_depth / 4):
                # well under the pressure bound: one rung down per
                # (rate-limited) observation
                self._set_brownout(self._brownout - 1, "recovered")
        return action

    def _scale_up_async(self) -> None:
        """A policy scale-up, OFF the lock (:473): the factory's build
        and warm-up (its captures) take real time, and holding the lock
        through them would stall every submit.  One spawn at a time; a
        spawn that lands after ``close()``, or at the ceiling the
        emergency path reached meanwhile, closes its replica."""
        # under self._lock
        if self._spawning:
            return
        self._spawning = True

        def spawn():
            try:
                b = self.factory()
            except Exception:
                with self._lock:
                    self._spawning = False
                raise
            with self._lock:
                self._spawning = False
                if not self._closed \
                        and len(self.batchers) < self.policy.max_replicas:
                    self.batchers.append(b)
                    self._apply_brownout(b)
                    decode_metrics.note_replicas(added=1)
                    telemetry.event("decode.scale_up",
                                    replicas=len(self.batchers),
                                    reason="policy")
                    return
            b.close()

        self._retire(spawn, "dl4j-replica-spawn")

    def _scale_up(self, reason: str) -> ContinuousBatcher:
        """A replica from the factory, built and added under the lock
        (re-entrant from the caller's hold); returns it."""
        with self._lock:
            b = self.factory()
            self.batchers.append(b)
            self._apply_brownout(b)
            decode_metrics.note_replicas(added=1)
            telemetry.event("decode.scale_up", replicas=len(self.batchers),
                            reason=reason)
        return b

    def _scale_down(self) -> None:
        # under self._lock: the newest replica leaves routing and
        # finishes its accepted requests on a background thread
        b = self.batchers.pop()
        decode_metrics.note_replicas(removed=1)
        telemetry.event("decode.scale_down", replicas=len(self.batchers))
        self._retire(b.close, "dl4j-replica-drain")

    # -- replica health ----------------------------------------------------
    def _monitor_loop(self) -> None:
        """The health watchdog (:555): poll host-side liveness signals
        and replace whatever fails diagnosis.  It reads only host fields
        (thread liveness, error streaks, progress times, depths) and
        every wait is timed: a monitor blocked on the card could be
        wedged by the failure it exists to find."""
        while not self._monitor_stop.wait(self.health.poll_interval_s):
            if not self._check_replicas():
                return

    def _check_replicas(self) -> bool:
        """One pass of the monitor; False once the router closed.  Its
        own frame, so no replica outlives the pass in the monitor's
        locals."""
        with self._lock:
            if self._closed:
                return False
            replicas = [b for b in self.batchers
                        if b not in self._draining]
        for b in replicas:
            reason = self._diagnose(b, self.health)
            if reason is not None:
                self.replace_replica(b, reason=reason)
        return True

    @staticmethod
    def _diagnose(b: ContinuousBatcher,
                  h: ReplicaHealth) -> Optional[str]:
        """One replica's verdict: None (healthy) or the signal that
        tripped."""
        if not b.worker_alive():
            return "worker-dead"
        if b.dispatch_error_streak >= h.max_error_streak:
            return "error-streak"
        if b.depth() > 0 and b.progress_age() > h.stall_after_s:
            return "stalled"
        return None

    def replace_replica(self, batcher: ContinuousBatcher, *,
                        reason: str = "unhealthy") -> bool:
        """Retire an unhealthy replica and put a factory replacement in
        its place (:589); the replacement costs its warm-up's captures.
        Every unfinished request of the retired replica is evacuated and
        replayed on the replacement from its journal (prompt, seed,
        temperature, tokens emitted), continuing bit for bit.  Returns
        False when the replica is already gone or the router closed;
        True once the replacement serves.

        The spawn runs under the lock, like the emergency scale-up: the
        fleet is degraded, and routing into a known-bad replica while
        the replacement builds would be worse than waiting."""
        with self._lock:
            if self._closed or batcher not in self.batchers:
                return False
            self.batchers.remove(batcher)
            decode_metrics.note_replicas(removed=1)
            replacement = self._scale_up(f"replace:{reason}")
        decode_metrics.note_replica_replaced()
        telemetry.event("decode.replica_replaced", reason=reason,
                        replicas=self.n_replicas())
        replayed = 0
        for r in batcher.evacuate():
            decode_metrics.note_request_replayed()
            replayed += 1
            try:
                replacement.resubmit(_ReplayRequest(r))
            except BatcherClosed:
                # the router closed mid-replacement: resolve the
                # client's handle rather than strand it
                r._force_finish(RouterClosed(
                    "router closed during replica replacement"))
        if replayed:
            telemetry.event("decode.requests_replayed", count=replayed,
                            reason=reason)
        # close() joins a possibly wedged worker: bounded, off this
        # thread (the replica is evacuated and out of routing already)
        self._retire(lambda: batcher.close(timeout=5.0),
                     "dl4j-replica-retire")
        return True

    # -- the brownout ladder -----------------------------------------------
    def brownout_level(self) -> int:
        with self._lock:
            return self._brownout

    def _apply_brownout(self, b: ContinuousBatcher) -> None:
        # under self._lock; plain bools the worker reads each pass
        b.engine.spec_enabled = self._brownout < 1
        b.engine.harvest_enabled = self._brownout < 2

    def _set_brownout(self, level: int, reason: str) -> None:
        # under self._lock
        level = max(0, min(2, level))
        if level == self._brownout:
            return
        self._brownout = level
        for b in self.batchers:
            self._apply_brownout(b)
        decode_metrics.note_brownout(level)
        telemetry.event("decode.brownout", level=level, reason=reason)

    # -- the hot weight swap -----------------------------------------------
    def swap_weights(self, params: Any, draft_params: Any = None, *,
                     timeout: float = 120.0) -> int:
        """Flip every replica to ``params`` one at a time, dropping no
        request (:668).

        Per replica: out of routing (``_draining``), wait for its depth
        to reach zero (accepted requests finish on the OLD weights),
        ``engine.rebind_params`` and ``engine.current_params()`` (the
        cast or requantization runs HERE, on the swapping thread, never
        on a serving worker), back into routing.  The new tree costs no
        capture: its leaves are copied into the static buffers the
        replica's graphs read at each entry's next call, on its worker
        (for bf16 GPT-2 small 327,892,992 B, as ``chip_smoke.py`` phase
        15 prints it on an H100 80GB HBM3 at 700 W: ~0.1 ms at its
        3.35 TB/s).  The rest of the fleet serves meanwhile; a one-
        replica fleet first gains a temporary factory replica on the old
        weights (its warm-up's captures), which is swapped too and then
        retired.  Afterwards each distinct shared ``PrefixCache`` is
        cleared once: its entries hold the old weights' rows (the new
        params generation already keeps them from hitting).

        Returns the number of replicas swapped.  Raises the typed
        :class:`SwapFailed` when a replica does not drain within
        ``timeout`` seconds (a wedged fleet), leaving the fleet serving:
        swapped replicas on the new weights, the rest on the old."""
        deadline = time.monotonic() + float(timeout)
        with self._lock:
            if self._closed:
                raise RouterClosed("AutoscalingRouter is closed")
            if self._swapping:
                raise RuntimeError("a weight swap is already in progress")
            self._swapping = True
        temp = None
        try:
            with self._lock:
                if len(self.batchers) == 1:
                    temp = self._scale_up("swap")   # the OLD weights
            swapped: set = set()                    # id() of flipped
            while True:
                with self._lock:
                    target = next((b for b in self.batchers
                                   if id(b) not in swapped), None)
                    if target is None:
                        break
                    self._draining.add(target)
                try:
                    while True:
                        if target.depth() == 0:
                            try:
                                target.engine.rebind_params(params,
                                                            draft_params)
                                break
                            except RuntimeError:
                                # depth read 0 a beat before the worker
                                # released its last slot: retry
                                pass
                        if time.monotonic() > deadline:
                            raise SwapFailed(timeout,
                                             self._drain_states(),
                                             len(swapped))
                        time.sleep(0.005)
                    target.engine.current_params()
                    swapped.add(id(target))
                finally:
                    with self._lock:
                        self._draining.discard(target)
            with self._lock:
                batchers = list(self.batchers)
            seen: set = set()
            for b in batchers:
                store = b.engine._prefix
                if store is not None and id(store) not in seen:
                    seen.add(id(store))
                    store.clear()
            if temp is not None:
                with self._lock:
                    if temp in self.batchers:
                        self.batchers.remove(temp)
                        decode_metrics.note_replicas(removed=1)
                self._retire(temp.close, "dl4j-replica-drain")
                temp = None
            decode_metrics.note_swap()
            telemetry.event("decode.swap", replicas=len(swapped))
            return len(swapped)
        finally:
            with self._lock:
                self._swapping = False
                self._draining.clear()

    def _drain_states(self) -> Dict[int, Dict[str, Any]]:
        """Per-replica drain diagnostics for :class:`SwapFailed`."""
        with self._lock:
            batchers = list(self.batchers)
            draining = set(self._draining)
        return {i: {"depth": b.depth(),
                    "worker_alive": b.worker_alive(),
                    "draining": b in draining}
                for i, b in enumerate(batchers)}

    # -- dispatch ----------------------------------------------------------
    def submit(self, prompt, **kw) -> DecodeRequest:
        """Route one request (:783): to the least-loaded replica that is
        not draining; at the bound, scale up (below the ceiling), else
        climb the brownout ladder, else shed."""
        self.tick()
        while True:
            with self._lock:
                if self._closed:
                    # closing stops SCALING too: a racing submit must
                    # not spawn a replica close() never sees
                    raise RouterClosed("AutoscalingRouter is closed")
                live = [b for b in self.batchers
                        if b not in self._draining] or list(self.batchers)
                if self._swapping:
                    decode_metrics.note_request_during_swap()
                depths = [b.depth() for b in live]
                i = int(np.argmin(depths))
                if depths[i] >= self.max_queue_depth:
                    if len(self.batchers) < self.policy.max_replicas:
                        live.append(self._scale_up("pressure"))
                        i = len(live) - 1
                    elif self._brownout < 2:
                        # at the ceiling and over the bound: trade the
                        # throughput optimizations for headroom first
                        # (draft dispatches, then harvest reads and page
                        # references) and admit; only level 2 sheds
                        self._set_brownout(self._brownout + 1, "pressure")
                    else:
                        decode_metrics.note_shed(by_policy=True)
                        telemetry.event("decode.shed", depth=depths[i],
                                        bound=self.max_queue_depth,
                                        replicas=len(self.batchers),
                                        by_policy=True)
                        raise OverloadedError(depths[i],
                                              self.max_queue_depth,
                                              len(self.batchers))
                target = live[i]
            try:
                return target.submit(prompt, **kw)
            except RuntimeError:
                # the chosen replica was scaled down or replaced (and
                # closed) between the pick and the submit: pick again
                # from the live fleet; a replica still routed is closed
                # for real (router shutdown)
                with self._lock:
                    if target in self.batchers:
                        raise

    # -- lifecycle ---------------------------------------------------------
    def close(self, timeout: float = 120.0) -> None:
        """Stop the monitor first (no replacement races close), refuse
        new submits and scale-ups, drain every replica, join the drains
        and spawns.  Every join is timed."""
        self._monitor_stop.set()
        with self._lock:
            self._closed = True
            batchers = list(self.batchers)
            drains = list(self._drains)
        if self._monitor is not None:
            self._monitor.join(timeout)
        for b in batchers:
            b.close(timeout)
        for t in drains:
            t.join(timeout)
