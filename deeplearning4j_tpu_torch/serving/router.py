"""Replicated decode serving: least-depth routing and load shedding.

Port of ``deeplearning4j_tpu/serving/router.py`` (:1-255), the
single-router half:

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
  thread; their warm-ups run one after another before any worker
  starts, so no capture overlaps another replica's replays.

Not ported here: ``model_degree > 1`` (replicas over device groups with
model-sharded params) is ROADMAP A7; ``AutoscalePolicy``,
``AutoscalingRouter``, ``swap_weights`` / :class:`SwapFailed`,
``ReplicaHealth`` and replica replacement, and the brownout ladder are
the fleet half, ROADMAP A4b: importing one of those names raises
``NotImplementedError`` naming it.  A replica's unfinished requests move to
another by hand with ``ContinuousBatcher.evacuate`` and ``resubmit`` of
``serving.decode._ReplayRequest``.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
from deeplearning4j_tpu_torch.serving.decode import (ContinuousBatcher,
                                                     DecodeEngine,
                                                     DecodeRequest)

__all__ = ["OverloadedError", "Router", "RouterClosed"]


class RouterClosed(RuntimeError):
    """Typed rejection for a submit racing ``close()``: a request is
    either accepted by a replica (and drains to completion) or rejected
    with this; never a hang."""


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
        ``Router([ContinuousBatcher(DecodeEngine(...)), ...])``."""
        from deeplearning4j_tpu_torch.models import gpt

        if model_degree != 1:
            if model_degree < 1:
                raise ValueError(
                    f"model_degree must be >= 1: {model_degree}")
            raise NotImplementedError(
                "Router.replicate(model_degree > 1), replicas over device "
                "groups with model-sharded params, is not ported yet: "
                "ROADMAP A7 (parallelism)")
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

    # -- dispatch ----------------------------------------------------------
    def depths(self) -> List[int]:
        return [b.depth() for b in self.batchers]

    def submit(self, prompt, **kw) -> DecodeRequest:
        """Route one request to the least-loaded replica; shed with
        :class:`OverloadedError` when every replica is at the bound."""
        with self._lock:
            if self._closed:
                raise RouterClosed("Router is closed")
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


def __getattr__(name: str):
    if name in ("AutoscalePolicy", "AutoscalingRouter", "ReplicaHealth",
                "SwapFailed"):
        raise NotImplementedError(
            f"serving.router.{name} is not ported yet: ROADMAP A4b (the "
            f"serving fleet: autoscaling, the live weight swap, "
            f"health-checked replacement, the brownout ladder)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
