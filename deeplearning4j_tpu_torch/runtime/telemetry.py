"""Run telemetry: span tracer, event journal, metrics registry.

Port of ``deeplearning4j_tpu/runtime/telemetry.py``.  Three pieces, all
on the host (nothing here runs inside a captured step, reads a device
value or forces a sync):

- :class:`Tracer`: a run-scoped, thread-safe span tracer.  Spans nest
  per thread (context manager or :func:`traced` decorator), carry
  attributes, and land in a bounded ring buffer (``dropped`` counts what
  fell out).  Clocks are monotonic; ``wall0`` anchors them.
- Two exporters over the same records: an append-only JSONL **event
  journal** (:meth:`Tracer.export_journal`, :func:`read_journal`) and a
  ``chrome://tracing`` / Perfetto **trace JSON** (:func:`chrome_trace`).
- :class:`MetricsRegistry`: the module-level :data:`registry` rolls
  every counter family of ``runtime/metrics.py`` into ONE snapshot with
  deltas since ``mark()`` and the devices' memory (``peak_bytes_in_use``).
  ``compile_delta_since_mark()`` is the overhead gate: a warmed path
  captures nothing new, with the tracer on or off.

The tracer is off by default, and the off path is one module-global
``None`` check returning the shared no-op span.  Enabling it changes no
captured step.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.runtime.metrics import (checkpoint_metrics,
                                                compile_metrics,
                                                decode_metrics,
                                                device_memory_stats,
                                                dp_metrics,
                                                ingest_metrics,
                                                mfu_metrics,
                                                multihost_metrics,
                                                peak_bytes_in_use,
                                                resilience_metrics,
                                                serving_metrics)

#: default directory journals land in (gitignored); override with
#: $DL4J_TPU_TELEMETRY_DIR
DEFAULT_JOURNAL_DIR = os.environ.get("DL4J_TPU_TELEMETRY_DIR",
                                     ".dl4j_telemetry")

#: ring-buffer bound — a week-long serving process must not grow the
#: record list without bound; 64k spans ≈ a few tens of MB journal
DEFAULT_CAPACITY = 65536


def _new_run_id() -> str:
    return "run-%s-%04x" % (
        time.strftime("%Y%m%dT%H%M%S"), os.getpid() & 0xFFFF)


class Span:
    """One live span: opened by ``Tracer.span(...)`` as a context
    manager; ``set(**attrs)`` adds attributes mid-flight (e.g. byte
    counts known only after the work ran)."""

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
    """The disabled-tracer fast path: one shared, allocation-free span
    that absorbs the context-manager protocol and ``set``."""

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
    """Run-scoped span/event recorder.  Thread-safe: spans nest per
    thread (thread-local stack), records append under a lock into a
    bounded ring buffer.  All timestamps are monotonic seconds relative
    to tracer creation; ``wall0`` anchors them to absolute time."""

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

    # -- span / event API --------------------------------------------------
    def span(self, name: str, **attrs: Any) -> Span:
        """Open a span (use as ``with tracer.span("fit") as sp:``).
        Nesting is automatic: the parent is whatever span this THREAD
        currently has open."""
        stack = getattr(self._local, "stack", None)
        parent = stack[-1].sid if stack else None
        return Span(self, name, parent, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Record a point event (no duration): worker joins, rejections,
        checkpoint markers, ..."""
        stack = getattr(self._local, "stack", None)
        self._append({
            "type": "event", "name": name,
            "ts": time.monotonic() - self._t0,
            "tid": threading.get_ident(),
            "parent": stack[-1].sid if stack else None,
            "attrs": attrs,
        })

    def traced(self, name: Optional[str] = None) -> Callable:
        """Decorator form: ``@tracer.traced("load")`` wraps the call in a
        span named after the function unless overridden."""
        def deco(fn: Callable) -> Callable:
            label = name or getattr(fn, "__name__", "span")

            def wrapper(*args, **kwargs):
                with self.span(label):
                    return fn(*args, **kwargs)
            wrapper.__name__ = getattr(fn, "__name__", label)
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    # -- internals ---------------------------------------------------------
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

    # -- reading -----------------------------------------------------------
    def records(self) -> List[Dict[str, Any]]:
        """Point-in-time copy of the buffered records (journal order)."""
        with self._lock:
            return list(self._buf)

    def count(self) -> int:
        """Buffered record count without copying the ring buffer."""
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    # -- exporters ---------------------------------------------------------
    def _header(self) -> Dict[str, Any]:
        return {"type": "run", "run_id": self.run_id, "wall0": self.wall0,
                "dropped": self.dropped, "capacity": self.capacity}

    def export_journal(self, path: str,
                       snapshot: Optional[Dict[str, Any]] = None) -> str:
        """Append the run header + every buffered record (+ an optional
        registry ``snapshot``) to ``path`` as JSONL.  Append-only by
        contract: re-exporting or exporting several runs into one file
        keeps earlier lines intact (each run re-announces itself with a
        ``run`` header line)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(self._header()) + "\n")
            for rec in self.records():
                f.write(json.dumps(rec, default=str) + "\n")
            if snapshot is not None:
                f.write(json.dumps({"type": "snapshot", **snapshot},
                                   default=str) + "\n")
        return path

    def export_chrome_trace(self, path: str) -> str:
        """Write a ``chrome://tracing``/Perfetto-compatible trace JSON
        (the "JSON Array Format" with a ``traceEvents`` wrapper)."""
        payload = chrome_trace(self.records(), run_id=self.run_id)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            # default=str: same attr-value leniency as export_journal —
            # a numpy-scalar span attribute must not crash either exporter
            json.dump(payload, f, default=str)
        return path


def chrome_trace(records: List[Dict[str, Any]],
                 run_id: str = "run") -> Dict[str, Any]:
    """Convert journal records (span/event dicts) to the chrome trace
    event format Perfetto loads: complete slices (``ph: "X"``, µs
    timestamps/durations) for spans, thread-scoped instants (``ph: "i"``)
    for events, plus process/thread metadata.  Shared by the tracer's
    exporter and the reference's ``cli.py telemetry --export-trace``.

    Multi-run journals (append-only export contract) map each run
    SEGMENT to its own Perfetto process: runs restart both sids and
    relative timestamps near zero, so sharing one track would render
    their slices superimposed and mis-nested."""
    # segment records by the run headers that precede them
    seg = 0
    seg_names: Dict[int, str] = {0: run_id}
    tagged: List[tuple] = []
    for r in records:
        kind = r.get("type")
        if kind == "run":
            seg += 1
            seg_names[seg] = str(r.get("run_id") or f"{run_id}#{seg}")
        elif kind in ("span", "event"):
            tagged.append((seg, r))

    events: List[Dict[str, Any]] = []
    for s in sorted({s for s, _ in tagged}) or [0]:
        events.append({"ph": "M", "pid": s + 1, "tid": 0,
                       "name": "process_name",
                       "args": {"name": "dl4j-torch "
                                + seg_names.get(s, run_id)}})
    tid_map: Dict[tuple, int] = {}
    for s, r in tagged:
        key = (s, r.get("tid"))
        if key not in tid_map:
            tid_map[key] = len([k for k in tid_map if k[0] == s]) + 1
            events.append({"ph": "M", "pid": s + 1, "tid": tid_map[key],
                           "name": "thread_name",
                           "args": {"name": f"thread-{r.get('tid')}"}})
    for s, r in tagged:
        tid = tid_map[(s, r.get("tid"))]
        if r["type"] == "span":
            events.append({
                "ph": "X", "pid": s + 1, "tid": tid,
                "name": r["name"], "cat": r["name"].split(".")[0],
                "ts": r["ts"] * 1e6, "dur": r["dur_ms"] * 1e3,
                "args": r.get("attrs") or {},
            })
        else:
            events.append({
                "ph": "i", "s": "t", "pid": s + 1, "tid": tid,
                "name": r["name"], "cat": r["name"].split(".")[0],
                "ts": r["ts"] * 1e6,
                "args": r.get("attrs") or {},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def read_journal(path: str) -> List[Dict[str, Any]]:
    """Load a JSONL journal back into record dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# Module-level tracer: the global every instrumentation site consults
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    """The active tracer, or None when telemetry is off.  Call sites
    that build attribute dicts should guard on this so a disabled run
    allocates nothing."""
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def enable(run_id: Optional[str] = None,
           capacity: int = DEFAULT_CAPACITY) -> Tracer:
    """Install (and return) the process-wide tracer.  Re-enabling
    replaces the previous tracer — export it first if its records
    matter."""
    global _TRACER
    _TRACER = Tracer(run_id=run_id, capacity=capacity)
    return _TRACER


def disable() -> Optional[Tracer]:
    """Uninstall the tracer; returns it so callers can still export."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def span(name: str, **attrs: Any):
    """Module-level span: ``with telemetry.span("fit"):`` — the shared
    no-op span when disabled (no allocation beyond the kwargs dict;
    kwarg-heavy per-request sites should guard on :func:`get_tracer`)."""
    t = _TRACER
    if t is None:
        return NOOP_SPAN
    return t.span(name, **attrs)


def event(name: str, **attrs: Any) -> None:
    t = _TRACER
    if t is not None:
        t.event(name, **attrs)


def traced(name: Optional[str] = None) -> Callable:
    """Decorator: span the call when telemetry is enabled, plain call
    when not — resolved PER CALL, so functions decorated at import time
    honor a tracer enabled later."""
    def deco(fn: Callable) -> Callable:
        label = name or getattr(fn, "__name__", "span")

        def wrapper(*args, **kwargs):
            t = _TRACER
            if t is None:
                return fn(*args, **kwargs)
            with t.span(label):
                return fn(*args, **kwargs)
        wrapper.__name__ = getattr(fn, "__name__", label)
        wrapper.__doc__ = fn.__doc__
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# MetricsRegistry — one snapshot over every counter family
# ---------------------------------------------------------------------------

def _numeric_delta(cur: Any, base: Any) -> Any:
    """Recursive ``cur - base`` over matching numeric leaves; non-numeric
    or structurally new values pass through as their current value."""
    if isinstance(cur, dict) and isinstance(base, dict):
        return {k: _numeric_delta(v, base.get(k)) for k, v in cur.items()}
    if isinstance(cur, bool) or isinstance(base, bool):
        return cur
    if isinstance(cur, (int, float)) and isinstance(base, (int, float)):
        return round(cur - base, 6) if isinstance(cur, float) \
            or isinstance(base, float) else cur - base
    return cur


class MetricsRegistry:
    """Named sources (anything with ``.snapshot() -> dict``) rolled into
    ONE consistent snapshot.  ``mark()`` banks the current state;
    later snapshots carry ``since_mark`` counter deltas, so a bench row
    or soak assertion reads one dict instead of diffing four singletons
    by hand."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: "Dict[str, Any]" = {}
        self._marks: Optional[Dict[str, Dict[str, Any]]] = None
        self._mark_t: Optional[float] = None
        self._t0 = time.monotonic()
        self.wall0 = time.time()

    def register(self, name: str, source: Any) -> None:
        """Register/replace a counter source.  ``source.snapshot()`` must
        return a (possibly nested) dict of scalars."""
        if not callable(getattr(source, "snapshot", None)):
            raise TypeError(f"source {name!r} has no snapshot() method")
        with self._lock:
            self._sources[name] = source

    def sources(self) -> List[str]:
        with self._lock:
            return sorted(self._sources)

    def _collect(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            items = list(self._sources.items())
        return {name: src.snapshot() for name, src in items}

    def mark(self) -> None:
        """Bank the current counters; later ``snapshot()`` calls report
        ``since_mark`` deltas against this point (and
        :meth:`compile_delta_since_mark` becomes meaningful)."""
        marks = self._collect()
        with self._lock:
            self._marks = marks
            self._mark_t = time.monotonic()

    def compile_delta_since_mark(self) -> Optional[int]:
        """Compiles (CUDA-graph captures on the card, first calls of a
        signature on the CPU) since ``mark()`` — None before any mark.
        THE overhead-gate primitive: telemetry on or off, a warmed fit or
        serving path must keep this at zero."""
        with self._lock:
            marks = self._marks
        if marks is None or "compile" not in marks:
            return None
        return (compile_metrics.snapshot()["compile_count"]
                - marks["compile"]["compile_count"])

    def snapshot(self) -> Dict[str, Any]:
        """One self-describing dict: run identity, wall span, every
        registered counter family, deltas since the last ``mark()``, and
        per-device memory (peak bytes where the backend reports it, an
        ``unsupported`` marker where it doesn't)."""
        counters = self._collect()
        tracer = _TRACER
        with self._lock:
            marks, mark_t = self._marks, self._mark_t
        out: Dict[str, Any] = {
            "run_id": tracer.run_id if tracer is not None else None,
            "telemetry_enabled": tracer is not None,
            "wall0": self.wall0,
            "wall_s": round(time.monotonic() - self._t0, 3),
            "counters": counters,
        }
        if marks is not None:
            out["since_mark"] = {
                name: _numeric_delta(snap, marks.get(name, {}))
                for name, snap in counters.items()}
            out["since_mark_wall_s"] = round(
                time.monotonic() - mark_t, 3)
        mem = device_memory_stats()
        out["device_memory"] = {
            "peak_bytes_in_use": peak_bytes_in_use(mem),
            "devices": mem,
        }
        if tracer is not None:
            out["spans_recorded"] = tracer.count()
            out["spans_dropped"] = tracer.dropped
        return out


#: process-wide registry pre-wired with the counter singletons —
#: the one-stop snapshot bench rows and the CLI read
registry = MetricsRegistry()
registry.register("compile", compile_metrics)
registry.register("resilience", resilience_metrics)
registry.register("serving", serving_metrics)
registry.register("decode", decode_metrics)
registry.register("dp", dp_metrics)
registry.register("checkpoint", checkpoint_metrics)
registry.register("mfu", mfu_metrics)
registry.register("multihost", multihost_metrics)
registry.register("ingest", ingest_metrics)


# ---------------------------------------------------------------------------
# Journal summarization (what the reference's `cli.py telemetry` renders;
# tests and notebooks can call it without the CLI)
# ---------------------------------------------------------------------------

def summarize_journal(records: List[Dict[str, Any]],
                      top_k: int = 10) -> Dict[str, Any]:
    """Digest a journal's records into the summary the CLI renders:

    - ``runs``: run-header metadata lines;
    - ``tree``: spans aggregated by (depth, name) with count/total/mean,
      children nested under their parent NAME (two spans with the same
      name and parent aggregate into one node);
    - ``top``: the ``top_k`` longest individual spans;
    - ``events``: per-name event counts;
    - ``counter_deltas``: numeric delta of the LAST snapshot record
      against the FIRST (one snapshot: reported as-is under
      ``counters``)."""
    # sids restart at 1 per Tracer, and journals are append-only across
    # runs — resolve parent links within each run SEGMENT (the records
    # between consecutive `run` headers) so multi-run journals never
    # cross-contaminate span trees
    seg = 0
    seg_of: Dict[int, int] = {}
    spans, events, snaps, runs = [], [], [], []
    for r in records:
        kind = r.get("type")
        if kind == "run":
            seg += 1
            runs.append(r)
        elif kind == "span":
            seg_of[id(r)] = seg
            spans.append(r)
        elif kind == "event":
            events.append(r)
        elif kind == "snapshot":
            snaps.append(r)

    by_sid = {(seg_of[id(r)], r["sid"]): r for r in spans if "sid" in r}

    def name_path(rec: Dict[str, Any]) -> tuple:
        s = seg_of[id(rec)]
        path = [rec["name"]]
        seen = {(s, rec.get("sid"))}
        parent = rec.get("parent")
        while parent is not None and (s, parent) in by_sid \
                and (s, parent) not in seen:
            seen.add((s, parent))
            rec = by_sid[(s, parent)]
            path.append(rec["name"])
            parent = rec.get("parent")
        return tuple(reversed(path))

    tree: Dict[tuple, Dict[str, Any]] = {}
    for r in spans:
        key = name_path(r)
        node = tree.setdefault(key, {"count": 0, "total_ms": 0.0,
                                     "max_ms": 0.0})
        node["count"] += 1
        node["total_ms"] += r["dur_ms"]
        node["max_ms"] = max(node["max_ms"], r["dur_ms"])
    tree_rows = [{
        "path": list(k), "depth": len(k) - 1, "name": k[-1],
        "count": v["count"], "total_ms": round(v["total_ms"], 3),
        "mean_ms": round(v["total_ms"] / v["count"], 3),
        "max_ms": round(v["max_ms"], 3),
    } for k, v in sorted(tree.items())]

    top = sorted(spans, key=lambda r: r["dur_ms"], reverse=True)[:top_k]
    ev_counts: Dict[str, int] = {}
    for e in events:
        ev_counts[e["name"]] = ev_counts.get(e["name"], 0) + 1

    out: Dict[str, Any] = {
        "runs": runs, "n_spans": len(spans), "n_events": len(events),
        "tree": tree_rows,
        "top": [{"name": r["name"], "dur_ms": round(r["dur_ms"], 3),
                 "ts": round(r["ts"], 4), "attrs": r.get("attrs") or {}}
                for r in top],
        "events": ev_counts,
    }
    if len(snaps) >= 2:
        out["counter_deltas"] = _numeric_delta(
            snaps[-1].get("counters", {}), snaps[0].get("counters", {}))
    elif snaps:
        out["counters"] = snaps[-1].get("counters", {})
    return out
