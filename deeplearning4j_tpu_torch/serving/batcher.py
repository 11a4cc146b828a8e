"""DynamicBatcher — coalesce concurrent requests into micro-batches.

Port of ``deeplearning4j_tpu/serving/batcher.py`` (:64-301).  A
background thread collects requests that arrive within ``max_delay_ms``
(or until ``max_batch_size`` rows are queued), concatenates them into
one bucketed engine dispatch, and resolves each caller's future with
exactly its own rows, as host numpy.

Policy knobs:
- ``max_batch_size``: flush as soon as this many rows are queued;
- ``max_delay_ms``: a lone request never waits longer than this;
- per-request ``deadline_ms``: a request still queued past its deadline
  resolves with :class:`DeadlineExceeded` instead of a forward.

Thread-safety: ``submit`` may be called from any number of threads; one
worker thread owns the queue drain and the dispatch order, so each
thread's results come back in order.  Every shared mutation happens
under ``self._cv``, and nothing blocks while holding it.

:class:`BatcherClosed` and :class:`DeadlineExceeded` are this module's
own copies: in JAX they live in ``serving/decode.py`` (:124, :1862),
which imports JAX.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.metrics import (decode_metrics,
                                                      serving_metrics)
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine


class BatcherClosed(RuntimeError):
    """Typed rejection for a submit racing ``close()``: a request is
    either accepted (and then drains to completion) or rejected with
    this; it never hangs unresolved."""


class DeadlineExceeded(RuntimeError):
    """A request's ``deadline_ms`` budget elapsed while it was queued.
    Carries ``deadline_ms``, ``elapsed_ms`` and ``tokens_emitted`` (0
    for one-shot serving), as the JAX decode batcher's does."""

    def __init__(self, deadline_ms: float, elapsed_ms: float,
                 tokens_emitted: int):
        super().__init__(
            f"request deadline exceeded: {elapsed_ms:.1f}ms elapsed > "
            f"{deadline_ms:.1f}ms budget ({tokens_emitted} tokens "
            f"emitted)")
        self.deadline_ms = deadline_ms
        self.elapsed_ms = elapsed_ms
        self.tokens_emitted = tokens_emitted


def _to_host(t: torch.Tensor) -> np.ndarray:
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.detach().cpu().numpy()


class _Request:
    __slots__ = ("x", "rows", "single", "future", "t_submit", "deadline")

    def __init__(self, x: np.ndarray, single: bool,
                 deadline_ms: Optional[float]):
        self.x = x
        self.rows = x.shape[0]
        self.single = single
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = None if deadline_ms is None \
            else self.t_submit + deadline_ms / 1e3


class DynamicBatcher:
    def __init__(self, engine: InferenceEngine, *,
                 max_batch_size: int = 64, max_delay_ms: float = 2.0,
                 params: Any = None):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.engine = engine
        self.max_batch_size = max_batch_size
        self.max_delay_s = max(max_delay_ms, 0.0) / 1e3
        self._params = params
        self._cv = threading.Condition()
        self._pending: List[_Request] = []
        self._open = True
        self._thread = threading.Thread(
            target=self._loop, name="dl4j-serving-batcher", daemon=True)
        self._thread.start()

    # -- client side -------------------------------------------------------
    def submit(self, x, *, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request batch ``[n, ...]``; returns a Future that
        resolves to its ``n`` result rows (numpy)."""
        return self._submit(np.asarray(x), single=False,
                            deadline_ms=deadline_ms)

    def submit_one(self, example, *,
                   deadline_ms: Optional[float] = None) -> Future:
        """Enqueue a single unbatched example; the future resolves to its
        unbatched result."""
        return self._submit(np.asarray(example)[None], single=True,
                            deadline_ms=deadline_ms)

    def _submit(self, x: np.ndarray, single: bool,
                deadline_ms: Optional[float] = None) -> Future:
        # reject against the engine's known input spec here, before the
        # request can join (and poison) a coalescing window
        spec = self.engine.input_spec
        if spec is not None and (x.shape[1:], np.dtype(x.dtype)) != \
                (spec[0], np.dtype(spec[1])):
            raise ValueError(
                f"request per-example shape {x.shape[1:]}/{x.dtype} does "
                f"not match the engine's {spec[0]}/{spec[1]}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0")
        req = _Request(x, single, deadline_ms)
        with self._cv:
            if not self._open:
                raise BatcherClosed("DynamicBatcher is closed")
            self._pending.append(req)
            serving_metrics.note_request(req.rows)
            serving_metrics.note_queue_depth(len(self._pending))
            depth = len(self._pending)
            self._cv.notify()
        tr = telemetry.get_tracer()
        if tr is not None:
            tr.event("serving.enqueue", rows=req.rows, queue_depth=depth)
        return req.future

    def infer(self, x, timeout: Optional[float] = 30.0):
        """Blocking convenience: submit + wait."""
        return self.submit(x).result(timeout)

    def infer_one(self, example, timeout: Optional[float] = 30.0):
        return self.submit_one(example).result(timeout)

    # -- worker side -------------------------------------------------------
    def _take_batch(self) -> List[_Request]:
        """Block for the first request, then keep the window open until
        max_delay or max_batch_size rows; pop whole requests (the first
        is always taken, however large — the engine chunks it)."""
        with self._cv:
            while self._open and not self._pending:
                self._cv.wait()
            if not self._pending:
                return []                      # closed and drained
            deadline = self._pending[0].t_submit + self.max_delay_s
            while (sum(r.rows for r in self._pending) < self.max_batch_size
                   and self._open):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            batch: List[_Request] = []
            rows = 0
            while self._pending:
                nxt = self._pending[0]
                if batch and rows + nxt.rows > self.max_batch_size:
                    break
                batch.append(self._pending.pop(0))
                rows += nxt.rows
            serving_metrics.note_queue_depth(len(self._pending))
            return batch

    def _reject_mismatched(self, batch: List[_Request]) -> List[_Request]:
        """Before warmup, split the window on the first request's
        trailing shape (after warmup ``submit`` already rejected
        mismatches against ``engine.input_spec``)."""
        spec = self.engine.input_spec
        head = (spec[0], np.dtype(spec[1])) if spec is not None \
            else (batch[0].x.shape[1:], batch[0].x.dtype)
        keep: List[_Request] = []
        for r in batch:
            if (r.x.shape[1:], np.dtype(r.x.dtype)) == head:
                keep.append(r)
            elif r.future.set_running_or_notify_cancel():
                r.future.set_exception(ValueError(
                    f"request shape {r.x.shape[1:]}/{r.x.dtype} does not "
                    f"match the batch's {head[0]}/{head[1]}"))
        return keep

    def _expire(self, batch: List[_Request]) -> List[_Request]:
        """Resolve requests whose deadline passed while queued with
        :class:`DeadlineExceeded` instead of spending a dispatch."""
        now = time.perf_counter()
        keep: List[_Request] = []
        for r in batch:
            if r.deadline is None or now <= r.deadline:
                keep.append(r)
            elif r.future.set_running_or_notify_cancel():
                elapsed_ms = (now - r.t_submit) * 1e3
                deadline_ms = (r.deadline - r.t_submit) * 1e3
                r.future.set_exception(DeadlineExceeded(
                    deadline_ms=deadline_ms, elapsed_ms=elapsed_ms,
                    tokens_emitted=0))
                decode_metrics.note_deadline_expiration()
                tr = telemetry.get_tracer()
                if tr is not None:
                    tr.event("serving.deadline_exceeded", rows=r.rows,
                             elapsed_ms=elapsed_ms)
        return keep

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return
            batch = self._expire(self._reject_mismatched(batch))
            if not batch:
                continue
            serving_metrics.note_batch(len(batch))
            tr = telemetry.get_tracer()
            if tr is not None:
                rows = sum(r.rows for r in batch)
                age_ms = (time.perf_counter()
                          - min(r.t_submit for r in batch)) * 1e3
                tr.event("serving.cohort_formed", n_requests=len(batch),
                         rows=rows, queue_age_ms=age_ms)
                cohort_sp = tr.span("serving.cohort",
                                    n_requests=len(batch), rows=rows,
                                    queue_age_ms=age_ms)
            else:
                cohort_sp = telemetry.NOOP_SPAN
            with cohort_sp:
                try:
                    xs = np.concatenate([r.x for r in batch], axis=0) \
                        if len(batch) > 1 else batch[0].x
                    # count_request=False: each client request was
                    # already counted at submit
                    out = _to_host(self.engine.infer(
                        xs, params=self._params, sync=True,
                        count_request=False))
                except Exception as e:      # resolve, never wedge clients
                    for r in batch:
                        if r.future.set_running_or_notify_cancel():
                            r.future.set_exception(e)
                    continue
                now = time.perf_counter()
                off = 0
                try:
                    for r in batch:
                        res = out[off] if r.single else out[off:off + r.rows]
                        off += r.rows
                        lat_ms = (now - r.t_submit) * 1e3
                        serving_metrics.note_latency_ms(lat_ms)
                        if tr is not None:
                            tr.event("serving.complete", rows=r.rows,
                                     latency_ms=lat_ms)
                        if r.future.set_running_or_notify_cancel():
                            r.future.set_result(res)
                except Exception as e:
                    # a distribution failure must fail this batch's
                    # unresolved futures, never kill the worker
                    for r in batch:
                        if not r.future.done() and \
                                r.future.set_running_or_notify_cancel():
                            r.future.set_exception(e)

    # -- lifecycle ---------------------------------------------------------
    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting requests, drain what's queued, join the
        worker."""
        with self._cv:
            self._open = False
            self._cv.notify_all()
        self._thread.join(timeout)

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
