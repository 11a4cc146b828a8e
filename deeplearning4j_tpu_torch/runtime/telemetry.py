"""Span tracer for the serving path.

Port of the part of ``deeplearning4j_tpu/runtime/telemetry.py``
(:79-382) that the engine and batcher use: :class:`Span`, the shared
:data:`NOOP_SPAN`, a thread-safe ring-buffer :class:`Tracer`, and the
module-level ``enable``/``disable``/``get_tracer``/``span``/``event``.
The tracer is off by default, and the off path is one global ``None``
check returning the shared no-op span.  The journal and Perfetto
exporters and the metrics registry are not ported yet.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

#: ring-buffer bound — a long serving process must not grow without bound
DEFAULT_CAPACITY = 65536


def _new_run_id() -> str:
    return "run-%s-%04x" % (
        time.strftime("%Y%m%dT%H%M%S"), os.getpid() & 0xFFFF)


class Span:
    """One live span, opened by ``Tracer.span(...)`` as a context
    manager; ``set(**attrs)`` adds attributes mid-flight."""

    __slots__ = ("_tracer", "name", "sid", "parent", "tid", "t0", "dur_s",
                 "attrs")

    def __init__(self, tracer: "Tracer", name: str, parent: Optional[int],
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.sid = next(tracer._sids)
        self.parent = parent
        self.tid = threading.get_ident()
        self.t0 = 0.0
        self.dur_s = 0.0
        self.attrs = attrs

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur_s = time.monotonic() - self.t0
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._pop(self)
        return False


class _NoopSpan:
    """The disabled-tracer fast path: one shared, allocation-free span."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self


#: the one no-op span every disabled call site shares
NOOP_SPAN = _NoopSpan()


class Tracer:
    """Run-scoped span/event recorder.  Spans nest per thread; records
    append under a lock into a bounded ring buffer (``dropped`` counts
    what fell out).  Timestamps are monotonic seconds from creation."""

    def __init__(self, run_id: Optional[str] = None,
                 capacity: int = DEFAULT_CAPACITY):
        self.run_id = run_id or _new_run_id()
        self.capacity = int(capacity)
        self._buf: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._sids = itertools.count(1)
        self._t0 = time.monotonic()
        self.wall0 = time.time()
        self.dropped = 0

    def span(self, name: str, **attrs: Any) -> Span:
        stack = getattr(self._local, "stack", None)
        parent = stack[-1].sid if stack else None
        return Span(self, name, parent, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        stack = getattr(self._local, "stack", None)
        self._append({
            "type": "event", "name": name,
            "ts": time.monotonic() - self._t0,
            "tid": threading.get_ident(),
            "parent": stack[-1].sid if stack else None,
            "attrs": attrs,
        })

    def _push(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(span)

    def _pop(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack and span in stack:       # mis-nested exit: heal
            stack.remove(span)
        self._append({
            "type": "span", "name": span.name, "sid": span.sid,
            "parent": span.parent, "tid": span.tid,
            "ts": span.t0 - self._t0,
            "dur_ms": span.dur_s * 1e3,
            "attrs": span.attrs,
        })

    def _append(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(rec)

    def records(self) -> List[Dict[str, Any]]:
        """Point-in-time copy of the buffered records."""
        with self._lock:
            return list(self._buf)


_TRACER: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    """The active tracer, or None when telemetry is off."""
    return _TRACER


def enable(run_id: Optional[str] = None,
           capacity: int = DEFAULT_CAPACITY) -> Tracer:
    """Install (and return) the process-wide tracer."""
    global _TRACER
    _TRACER = Tracer(run_id=run_id, capacity=capacity)
    return _TRACER


def disable() -> Optional[Tracer]:
    """Uninstall the tracer; returns it so callers can still read it."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def span(name: str, **attrs: Any):
    """``with telemetry.span("warmup"):`` — the shared no-op span when
    telemetry is off."""
    t = _TRACER
    if t is None:
        return NOOP_SPAN
    return t.span(name, **attrs)


def event(name: str, **attrs: Any) -> None:
    t = _TRACER
    if t is not None:
        t.event(name, **attrs)
