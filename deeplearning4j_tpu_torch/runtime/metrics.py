"""Serving counters.

Port of ``ServingMetrics``/``serving_metrics``
(``deeplearning4j_tpu/runtime/metrics.py:134-243``) and of the one
``DecodeMetrics`` counter the batcher books
(``note_deadline_expiration``, batcher.py:203).  The compile-count mark
(``mark_compiles``, ``compile_delta_since_mark``) has no counterpart:
PyTorch runs eagerly, so serving compiles nothing.  The other counter
families come with the slices that use them.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional


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
      ``latency_p99_ms``.
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
            return {
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
            }


#: process-wide singleton the serving engine + batcher report into
serving_metrics = ServingMetrics()


class DecodeMetrics:
    """The serving-wide failure counter the batcher books: requests
    whose ``deadline_ms`` passed while queued.  The decode engine's own
    counters come with the decode slice."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.deadline_expirations = 0

    def note_deadline_expiration(self) -> None:
        with self._lock:
            self.deadline_expirations += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"deadline_expirations": self.deadline_expirations}


#: process-wide singleton the batcher's deadline sweep reports into
decode_metrics = DecodeMetrics()
