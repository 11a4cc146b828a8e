"""Compile and serving counters.

Port of ``CompileMetrics``/``compile_metrics`` (``deeplearning4j_tpu/
runtime/metrics.py:22-80``), ``ServingMetrics``/``serving_metrics`` and
``DecodeMetrics``/``decode_metrics`` (:134-513, the decode family's
tier-1 and tier-2 counters).  The compile engine
(``runtime/compile_cache.py``) reports into ``compile_metrics``: a
"compile" is a CUDA-graph capture on the card and the first call of a
signature on the CPU.  ``mark_compiles`` banks its count, and
``compile_delta_since_mark`` in a snapshot is what was captured since.
The other counter families come with the slices that use them.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional


class CompileMetrics:
    """Process-wide counters of the compile engine
    (``runtime/compile_cache.py``):

    - ``compile_count``: signatures compiled, one per (function, input
      signature): a CUDA-graph capture on the card, the first call on
      the CPU.  Two identically configured networks sharing one engine
      entry compile ONCE;
    - ``compile_ms``: wall-clock ms of the calls that compiled (on the
      card: warm-up, capture and the first replay);
    - ``engine_builds`` / ``engine_hits``: keyed engine lookups that
      built a new entry vs reused one;
    - ``cached_dispatches``: calls served by an existing signature (a
      graph replay on the card);
    - ``traces``: compiles per label, e.g.
      ``{"multilayer.train_step": 1}``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.compile_count = 0
            self.compile_ms = 0.0
            self.engine_builds = 0
            self.engine_hits = 0
            self.cached_dispatches = 0
            self.traces: Dict[str, int] = {}

    def note_trace(self, label: str) -> None:
        with self._lock:
            self.compile_count += 1
            self.traces[label] = self.traces.get(label, 0) + 1

    def note_compile_ms(self, ms: float) -> None:
        with self._lock:
            self.compile_ms += ms

    def note_engine(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.engine_hits += 1
            else:
                self.engine_builds += 1

    def note_cached_dispatch(self) -> None:
        with self._lock:
            self.cached_dispatches += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "compile_count": self.compile_count,
                "compile_ms": round(self.compile_ms, 1),
                "engine_builds": self.engine_builds,
                "engine_hits": self.engine_hits,
                "cached_dispatches": self.cached_dispatches,
                "traces": dict(self.traces),
            }


#: process-wide singleton the compile engine reports into
compile_metrics = CompileMetrics()


def _compile_delta(out: Dict[str, Any]) -> Dict[str, Any]:
    """Add ``compile_delta_since_mark`` to a snapshot that carries a
    ``compile_mark``."""
    if out["compile_mark"] is not None:
        out["compile_delta_since_mark"] = (compile_metrics.compile_count
                                           - out["compile_mark"])
    return out


class ServingMetrics:
    """Process-wide counters for the inference engine and batcher:

    - ``requests`` / ``rows``: client requests accepted and their rows;
    - ``dispatches`` / ``rows_padded``: bucketed device dispatches and
      the padded rows they ran — ``padding_waste_ratio`` in ``snapshot``
      is ``1 - rows/rows_padded``;
    - ``batches_formed`` / ``requests_coalesced``: micro-batches the
      DynamicBatcher flushed and the requests they merged;
    - ``queue_depth`` / ``max_queue_depth``: live and high-water batcher
      queue occupancy;
    - a bounded request-latency reservoir -> ``latency_p50_ms`` /
      ``latency_p99_ms``;
    - ``compile_mark``: the engine's compile count banked by
      ``mark_compiles()`` (call it right after ``warmup()``); snapshots
      then carry ``compile_delta_since_mark``.
    """

    #: latency reservoir bound — percentiles come from the recent window
    MAX_LATENCIES = 8192

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.requests = 0
            self.rows = 0
            self.dispatches = 0
            self.rows_padded = 0
            self.batches_formed = 0
            self.requests_coalesced = 0
            self.queue_depth = 0
            self.max_queue_depth = 0
            self._latencies_ms: List[float] = []
            self._compile_mark: Optional[int] = None

    def note_request(self, rows: int) -> None:
        with self._lock:
            self.requests += 1
            self.rows += rows

    def note_dispatch(self, bucket_rows: int) -> None:
        with self._lock:
            self.dispatches += 1
            self.rows_padded += bucket_rows

    def note_batch(self, n_requests: int) -> None:
        with self._lock:
            self.batches_formed += 1
            self.requests_coalesced += n_requests

    def note_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = depth
            self.max_queue_depth = max(self.max_queue_depth, depth)

    def note_latency_ms(self, ms: float) -> None:
        with self._lock:
            self._latencies_ms.append(ms)
            if len(self._latencies_ms) > self.MAX_LATENCIES:
                del self._latencies_ms[:len(self._latencies_ms) // 2]

    def mark_compiles(self) -> None:
        """Bank the current engine compile count (call right after
        ``warmup()``); later snapshots report the delta."""
        with self._lock:
            self._compile_mark = compile_metrics.compile_count

    @staticmethod
    def _pct(sorted_ms: List[float], q: float) -> Optional[float]:
        if not sorted_ms:
            return None
        idx = min(int(q * len(sorted_ms)), len(sorted_ms) - 1)
        return sorted_ms[idx]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            lat = sorted(self._latencies_ms)
            waste = (1.0 - self.rows / self.rows_padded) \
                if self.rows_padded else 0.0
            out = {
                "requests": self.requests,
                "rows": self.rows,
                "dispatches": self.dispatches,
                "rows_padded": self.rows_padded,
                "padding_waste_ratio": max(waste, 0.0),
                "batches_formed": self.batches_formed,
                "requests_coalesced": self.requests_coalesced,
                "queue_depth": self.queue_depth,
                "max_queue_depth": self.max_queue_depth,
                "latency_p50_ms": self._pct(lat, 0.50),
                "latency_p99_ms": self._pct(lat, 0.99),
                "latency_samples": len(lat),
                "compile_mark": self._compile_mark,
            }
        return _compile_delta(out)


#: process-wide singleton the serving engine + batcher report into
serving_metrics = ServingMetrics()


class DecodeMetrics:
    """Process-wide counters of the continuous-batching decode stack
    (``serving/decode.py``), the reference's tier-1 and tier-2 families
    (``DecodeMetrics``, metrics.py:246):

    - ``requests`` / ``requests_completed``: decode requests accepted
      and finished (EOS or token budget);
    - ``prompt_tokens`` / ``tokens_out``: prompt tokens accepted and
      continuation tokens streamed back;
    - ``prefill_dispatches`` / ``decode_dispatches``: prefill chunks
      and decode steps dispatched;
    - ``joins``: requests that prefilled while other slots were
      mid-decode;
    - ``slot_steps`` / ``slot_capacity_steps``: active and total slots
      summed over decode steps; ``snapshot()["slot_occupancy"]`` is
      their ratio;
    - ``queue_depth`` / ``max_queue_depth``: the batcher's latest and
      high-water pending depth;
    - time-to-first-token and per-step latency reservoirs ->
      ``ttft_p50_ms``/``ttft_p99_ms`` and ``tok_p50_ms``/``tok_p99_ms``;
    - tier 2: ``kv_bytes_per_slot`` (gauge: KV bytes a slot of the
      newest engine's largest bucket).  The prefix-store and router
      counters come with their bookers (ROADMAP A4);
    - ``deadline_expirations``: requests whose ``deadline_ms`` passed
      while queued or mid-decode (the one-shot batcher books here too);
    - ``compile_mark``: as :class:`ServingMetrics`'s, for the decode
      stack's captures (``mark_compiles()`` after ``warmup()``).
    """

    MAX_SAMPLES = 8192

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.requests = 0
            self.requests_completed = 0
            self.prompt_tokens = 0
            self.tokens_out = 0
            self.prefill_dispatches = 0
            self.decode_dispatches = 0
            self.joins = 0
            self.slot_steps = 0
            self.slot_capacity_steps = 0
            self.queue_depth = 0
            self.max_queue_depth = 0
            self.kv_bytes_per_slot = 0
            self.deadline_expirations = 0
            self._ttft_ms: List[float] = []
            self._tok_ms: List[float] = []
            self._compile_mark: Optional[int] = None

    def note_request(self, prompt_tokens: int) -> None:
        with self._lock:
            self.requests += 1
            self.prompt_tokens += int(prompt_tokens)

    def note_join(self) -> None:
        with self._lock:
            self.joins += 1

    def note_kv_bytes_per_slot(self, nbytes: int) -> None:
        with self._lock:
            self.kv_bytes_per_slot = int(nbytes)

    def note_deadline_expiration(self) -> None:
        with self._lock:
            self.deadline_expirations += 1

    def note_complete(self, tokens: int) -> None:
        with self._lock:
            self.requests_completed += 1
            self.tokens_out += int(tokens)

    def note_prefill(self, chunks: int = 1) -> None:
        with self._lock:
            self.prefill_dispatches += int(chunks)

    def note_decode_dispatch(self, active: int, capacity: int) -> None:
        with self._lock:
            self.decode_dispatches += 1
            self.slot_steps += int(active)
            self.slot_capacity_steps += int(capacity)

    def note_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = depth
            self.max_queue_depth = max(self.max_queue_depth, depth)

    def _push(self, buf: List[float], ms: float) -> None:
        buf.append(ms)
        if len(buf) > self.MAX_SAMPLES:
            del buf[:len(buf) // 2]

    def note_ttft_ms(self, ms: float) -> None:
        with self._lock:
            self._push(self._ttft_ms, ms)

    def note_token_ms(self, ms: float) -> None:
        with self._lock:
            self._push(self._tok_ms, ms)

    def mark_compiles(self) -> None:
        with self._lock:
            self._compile_mark = compile_metrics.compile_count

    def snapshot(self) -> Dict[str, Any]:
        pct = ServingMetrics._pct
        with self._lock:
            ttft = sorted(self._ttft_ms)
            tok = sorted(self._tok_ms)
            occ = (self.slot_steps / self.slot_capacity_steps
                   if self.slot_capacity_steps else 0.0)
            out = {
                "requests": self.requests,
                "requests_completed": self.requests_completed,
                "prompt_tokens": self.prompt_tokens,
                "tokens_out": self.tokens_out,
                "prefill_dispatches": self.prefill_dispatches,
                "decode_dispatches": self.decode_dispatches,
                "joins": self.joins,
                "slot_occupancy": round(occ, 4),
                "queue_depth": self.queue_depth,
                "max_queue_depth": self.max_queue_depth,
                "kv_bytes_per_slot": self.kv_bytes_per_slot,
                "deadline_expirations": self.deadline_expirations,
                "ttft_p50_ms": pct(ttft, 0.50),
                "ttft_p99_ms": pct(ttft, 0.99),
                "tok_p50_ms": pct(tok, 0.50),
                "tok_p99_ms": pct(tok, 0.99),
                "compile_mark": self._compile_mark,
            }
        return _compile_delta(out)


#: process-wide singleton the decode engine and both batchers report into
decode_metrics = DecodeMetrics()
