"""Counter families, MFU and memory helpers, scalar logging, profiling.

Port of ``deeplearning4j_tpu/runtime/metrics.py``.  Every counter family
of the reference is here with its singleton, so
``runtime.telemetry.registry`` lists them all:

- ``compile_metrics`` (:22-80): the compile engine
  (``runtime/compile_cache.py``) reports into it; a "compile" is a
  CUDA-graph capture on the card and the first call of a signature on
  the CPU;
- ``resilience_metrics`` (:89): guard skips, spikes, rollbacks, retry
  budgets, auto-checkpoints (``runtime/resilience.py``);
- ``serving_metrics`` and ``decode_metrics`` (:134-513): the engines and
  batchers; ``mark_compiles`` banks the compile count and
  ``compile_delta_since_mark`` in a snapshot is what was captured since;
- ``checkpoint_metrics`` (:609): the async checkpointer, the manifest
  protocol and preemption;
- ``mfu_metrics`` (:759) with :func:`chip_peak_flops` /
  :func:`estimate_mfu`, keyed on CUDA device names;
- ``dp_metrics`` (:545): booked by the data-parallel fit paths
  (``nn/multilayer``'s bundle, ``models/lm_fit.CausalLM``,
  ``parallel/data_parallel``) and ``datasets/iterator.PrefetchIterator``;
- ``multihost_metrics`` (:822): booked by ``parallel/multihost``'s
  join, barriers and flag syncs, the manager's cluster commits and
  ``ResilientFit``'s host-loss path; ``ingest_metrics`` (:890): booked
  by ``datasets/data_service.DataService``.

:func:`device_memory_stats` / :func:`peak_bytes_in_use` read
``torch.cuda.memory_stats``; :class:`ScalarsLogger`,
:class:`MetricsListener` and :class:`ThroughputMeter` are the scalar
sinks; :func:`profile_trace`, :func:`annotate` and :class:`Profiler` sit
on ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch


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


class ResilienceMetrics:
    """Process-wide counters for the self-healing layer
    (``runtime/resilience.py``), every fault the stack absorbed:

    - ``steps_skipped``: train steps whose update the in-step non-finite
      guard dropped;
    - ``spikes_detected`` / ``rollbacks`` / ``retry_budget_exceeded``:
      loss-spike detector hits, checkpoint rollbacks performed, and runs
      that exhausted the retry budget;
    - ``checkpoints_saved``: auto-checkpoints written by ResilientFit;
    - ``updates_rejected`` / ``worker_join_retries``: the scale-out
      runners' (``parallel/scaleout.WorkAccumulator`` and
      ``parallel/transport.worker_main``).

    Keys are open-ended (``note`` accepts any name)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}

    def reset(self) -> None:
        with self._lock:
            self._counters = {}

    def note(self, key: str, by: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + by

    def count(self, key: str) -> int:
        with self._lock:
            return self._counters.get(key, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)


#: process-wide singleton every guard and rollback reports into
resilience_metrics = ResilienceMetrics()


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
      newest engine's largest bucket); ``requests_shed`` (the router's
      typed load shed); ``prefix_hits`` / ``prefix_misses`` /
      ``prefill_tokens_saved`` (the prefix store, a hit saving its
      prefix's prefill);
    - tier 3: ``pages_in_use`` / ``pages_in_use_hw`` (gauge and
      high-water of allocated KV pages), ``snapshot()["page_utilization"]``
      (live token rows over allocated page rows, summed over paged
      dispatches), ``draft_proposed`` / ``draft_accepted`` and
      ``snapshot()["draft_accept_rate"]`` (speculative decoding);
    - ``requests_replayed``: in-flight requests re-dispatched as (prompt
      + tokens emitted so far) after a failed dispatch or an evacuation,
      continuing bit for bit; ``pages_leaked`` (gauge: allocator page
      references no live slot or resident prefix accounts for after the
      last release);
    - the fleet (``serving/router.AutoscalingRouter``):
      ``replicas_added`` / ``replicas_removed`` (scale events, temporary
      swap replicas and replacements included), ``shed_by_policy``
      (sheds at the replica ceiling; ``note_shed(by_policy=True)`` books
      ``requests_shed`` too), ``swaps_completed`` /
      ``requests_during_swap`` (hot weight swaps finished, and requests
      accepted while one ran), ``replicas_replaced`` (unhealthy replicas
      the health monitor retired and respawned), ``brownout_transitions``
      / ``brownout_level`` (moves of the brownout ladder and its level:
      0 normal, 1 speculative decoding off, 2 prefix harvesting off too);
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
            self.requests_shed = 0
            self.prefix_hits = 0
            self.prefix_misses = 0
            self.prefill_tokens_saved = 0
            self.pages_in_use = 0
            self.pages_in_use_hw = 0
            self.page_token_rows = 0
            self.page_capacity_rows = 0
            self.draft_proposed = 0
            self.draft_accepted = 0
            self.requests_replayed = 0
            self.pages_leaked = 0
            self.replicas_added = 0
            self.replicas_removed = 0
            self.shed_by_policy = 0
            self.swaps_completed = 0
            self.requests_during_swap = 0
            self.replicas_replaced = 0
            self.brownout_transitions = 0
            self.brownout_level = 0
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

    def note_shed(self, by_policy: bool = False) -> None:
        with self._lock:
            self.requests_shed += 1
            if by_policy:
                self.shed_by_policy += 1

    def note_replicas(self, added: int = 0, removed: int = 0) -> None:
        with self._lock:
            self.replicas_added += added
            self.replicas_removed += removed

    def note_swap(self) -> None:
        with self._lock:
            self.swaps_completed += 1

    def note_request_during_swap(self) -> None:
        with self._lock:
            self.requests_during_swap += 1

    def note_replica_replaced(self) -> None:
        with self._lock:
            self.replicas_replaced += 1

    def note_brownout(self, level: int) -> None:
        with self._lock:
            self.brownout_transitions += 1
            self.brownout_level = int(level)

    def note_prefix_hit(self, tokens_saved: int) -> None:
        with self._lock:
            self.prefix_hits += 1
            self.prefill_tokens_saved += int(tokens_saved)

    def note_prefix_miss(self) -> None:
        with self._lock:
            self.prefix_misses += 1

    def note_pages(self, in_use: int, live_rows: int,
                   page_tokens: int) -> None:
        with self._lock:
            self.pages_in_use = int(in_use)
            self.pages_in_use_hw = max(self.pages_in_use_hw, int(in_use))
            self.page_token_rows += int(live_rows)
            self.page_capacity_rows += int(in_use) * int(page_tokens)

    def note_spec(self, proposed: int, accepted: int) -> None:
        with self._lock:
            self.draft_proposed += int(proposed)
            self.draft_accepted += int(accepted)

    def note_request_replayed(self) -> None:
        with self._lock:
            self.requests_replayed += 1

    def note_pages_leaked(self, n: int) -> None:
        with self._lock:
            self.pages_leaked = int(n)

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
                "requests_shed": self.requests_shed,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefill_tokens_saved": self.prefill_tokens_saved,
                "kv_bytes_per_slot": self.kv_bytes_per_slot,
                "pages_in_use": self.pages_in_use,
                "pages_in_use_hw": self.pages_in_use_hw,
                "page_utilization": round(
                    self.page_token_rows / self.page_capacity_rows, 4)
                if self.page_capacity_rows else 0.0,
                "draft_proposed": self.draft_proposed,
                "draft_accepted": self.draft_accepted,
                "draft_accept_rate": round(
                    self.draft_accepted / self.draft_proposed, 4)
                if self.draft_proposed else 0.0,
                "deadline_expirations": self.deadline_expirations,
                "requests_replayed": self.requests_replayed,
                "pages_leaked": self.pages_leaked,
                "replicas_added": self.replicas_added,
                "replicas_removed": self.replicas_removed,
                "shed_by_policy": self.shed_by_policy,
                "swaps_completed": self.swaps_completed,
                "requests_during_swap": self.requests_during_swap,
                "replicas_replaced": self.replicas_replaced,
                "brownout_transitions": self.brownout_transitions,
                "brownout_level": self.brownout_level,
                "ttft_p50_ms": pct(ttft, 0.50),
                "ttft_p99_ms": pct(ttft, 0.99),
                "tok_p50_ms": pct(tok, 0.50),
                "tok_p99_ms": pct(tok, 0.99),
                "compile_mark": self._compile_mark,
            }
        return _compile_delta(out)


#: process-wide singleton the decode engine and both batchers report into
decode_metrics = DecodeMetrics()


class DataParallelMetrics:
    """Process-wide counters for the sharded training paths and the
    mesh-aware ingestion stage: ``bytes_staged`` / ``batches_staged`` /
    ``stage_ms`` (host->device staging), ``dispatches`` / ``steps``,
    ``accum_factor`` / ``data_degree`` of the latest dispatch.  The
    data-parallel fits book a dispatch per staged fit (its steps) or
    per streamed step, and the staging of stacked or prefetched batches
    onto a data mesh."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.bytes_staged = 0
            self.batches_staged = 0
            self.stage_ms = 0.0
            self.dispatches = 0
            self.steps = 0
            self.accum_factor = 1
            self.data_degree = 1

    def note_staged(self, nbytes: int, ms: float, batches: int = 1) -> None:
        with self._lock:
            self.bytes_staged += int(nbytes)
            self.batches_staged += batches
            self.stage_ms += ms

    def note_dispatch(self, steps: int, accum: int, data_degree: int) -> None:
        with self._lock:
            self.dispatches += 1
            self.steps += int(steps)
            self.accum_factor = int(accum)
            self.data_degree = int(data_degree)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "bytes_staged": self.bytes_staged,
                "batches_staged": self.batches_staged,
                "stage_ms": round(self.stage_ms, 3),
                "dispatches": self.dispatches,
                "steps": self.steps,
                "steps_per_dispatch": round(self.steps / self.dispatches, 2)
                if self.dispatches else 0.0,
                "accum_factor": self.accum_factor,
                "data_degree": self.data_degree,
            }


#: process-wide singleton of the data-parallel fit paths
dp_metrics = DataParallelMetrics()


class CheckpointMetrics:
    """Process-wide counters for the checkpoint layer
    (``runtime/checkpoint.py``'s ``AsyncCheckpointer`` and
    ``CheckpointManager``, and the preemption machinery of
    ``runtime/resilience.py``):

    - ``saves_async`` / ``saves_sync``: snapshots requested through the
      background writer vs written on the caller's thread;
    - ``snapshots_committed``: checkpoints whose manifest hit disk
      (``bytes_written`` / ``write_ms``: the writer's serialization and
      fsync cost, off the training thread);
    - ``in_flight`` / ``max_in_flight``: staged but not yet committed
      (live gauge + high-water), bounded by the writer's semaphore;
    - ``bytes_staged`` / ``stage_ms``: what the TRAINING thread pays to
      fork a snapshot (device clone + async copy to pinned host memory);
    - ``write_behind_lag_ms``: request-to-commit latency of the latest
      committed snapshot;
    - ``backpressure_waits``: save requests that had to block;
    - ``checksum_failures`` / ``restore_fallbacks``: manifest failures
      and restores that fell back to an older committed step;
    - ``preemptions_requested`` / ``preemption_snapshots``: preemption
      notices seen by a PreemptionGuard and the final snapshots taken;
    - ``device_losses`` / ``elastic_resumes``: losses ``ResilientFit``
      saw and the re-meshed resumes it made of them.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.saves_async = 0
            self.saves_sync = 0
            self.snapshots_committed = 0
            self.bytes_written = 0
            self.write_ms = 0.0
            self.in_flight = 0
            self.max_in_flight = 0
            self.bytes_staged = 0
            self.stage_ms = 0.0
            self.write_behind_lag_ms = 0.0
            self.backpressure_waits = 0
            self.checksum_failures = 0
            self.restore_fallbacks = 0
            self.preemptions_requested = 0
            self.preemption_snapshots = 0
            self.device_losses = 0
            self.elastic_resumes = 0

    def note_staged(self, nbytes: int, ms: float) -> None:
        """Async staging cost (training-thread side); sync saves book
        ``note("saves_sync")`` + :meth:`note_committed` instead."""
        with self._lock:
            self.bytes_staged += int(nbytes)
            self.stage_ms += ms
            self.saves_async += 1
            self.in_flight += 1
            self.max_in_flight = max(self.max_in_flight, self.in_flight)

    def note_commit_failed(self) -> None:
        """An async snapshot's save raised: it is no longer pending."""
        with self._lock:
            self.in_flight = max(0, self.in_flight - 1)

    def note_committed(self, nbytes: int, write_ms: float,
                       lag_ms: float, *, was_async: bool) -> None:
        with self._lock:
            self.snapshots_committed += 1
            self.bytes_written += int(nbytes)
            self.write_ms += write_ms
            self.write_behind_lag_ms = round(lag_ms, 3)
            if was_async:
                self.in_flight = max(0, self.in_flight - 1)

    def note(self, key: str, by: int = 1) -> None:
        """Bump a plain counter field by name."""
        with self._lock:
            setattr(self, key, getattr(self, key) + by)

    def count(self, key: str) -> int:
        with self._lock:
            return getattr(self, key)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "saves_async": self.saves_async,
                "saves_sync": self.saves_sync,
                "snapshots_committed": self.snapshots_committed,
                "bytes_written": self.bytes_written,
                "write_ms": round(self.write_ms, 3),
                "in_flight": self.in_flight,
                "max_in_flight": self.max_in_flight,
                "bytes_staged": self.bytes_staged,
                "stage_ms": round(self.stage_ms, 3),
                "write_behind_lag_ms": self.write_behind_lag_ms,
                "backpressure_waits": self.backpressure_waits,
                "checksum_failures": self.checksum_failures,
                "restore_fallbacks": self.restore_fallbacks,
                "preemptions_requested": self.preemptions_requested,
                "preemption_snapshots": self.preemption_snapshots,
                "device_losses": self.device_losses,
                "elastic_resumes": self.elastic_resumes,
            }


#: process-wide singleton the checkpoint and preemption layer reports into
checkpoint_metrics = CheckpointMetrics()


#: dense bf16 peak FLOP/s by CUDA device-name substring (lower case), the
#: denominator of every MFU estimate: the H100 SXM's published 989
#: TFLOP/s.  A card not listed gives None.
CUDA_PEAK_FLOPS = (
    ("h100 80gb hbm3", 989e12), ("h100 sxm", 989e12),
)


def chip_peak_flops(device_kind: str) -> Optional[float]:
    """bf16 peak FLOP/s for a device name as
    ``torch.cuda.get_device_name()`` gives it (None when unknown)."""
    dk = (device_kind or "").lower()
    for sub, peak in CUDA_PEAK_FLOPS:
        if sub in dk:
            return peak
    return None


def estimate_mfu(flops_per_step: float, step_s: float, device_kind: str,
                 n_dev: int = 1) -> Optional[float]:
    """Model FLOPs utilization: analytic FLOPs per step / measured step
    time / the devices' bf16 peak.  None when the peak is unknown or the
    timing is degenerate."""
    peak = chip_peak_flops(device_kind)
    if peak is None or step_s <= 0 or n_dev <= 0:
        return None
    return flops_per_step / step_s / (peak * n_dev)


class MfuMetrics:
    """Per-label MFU estimates (``note_mfu``: analytic FLOPs / measured
    step time / device peak, last value per label with its inputs) and
    open-ended counters (``note``): the attention autotuner's
    (``runtime/autotune.py``) ``sweeps``, ``candidates_timed``,
    ``consults``, ``cache_hits``, ``cache_misses`` and
    ``winners_persisted``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._counters: Dict[str, int] = {}
            self._estimates: Dict[str, Dict[str, Any]] = {}

    def note(self, key: str, by: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + by

    def count(self, key: str) -> int:
        with self._lock:
            return self._counters.get(key, 0)

    def note_mfu(self, label: str, flops_per_step: float, step_s: float,
                 device_kind: str, n_dev: int = 1) -> Optional[float]:
        est = estimate_mfu(flops_per_step, step_s, device_kind, n_dev)
        with self._lock:
            self._estimates[label] = {
                "mfu": round(est, 4) if est is not None else None,
                "tflops_per_step": round(flops_per_step / 1e12, 4),
                "step_ms": round(step_s * 1e3, 3),
                "device_kind": device_kind,
                "n_devices": int(n_dev),
            }
        return est

    def estimate(self, label: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self._estimates.get(label)
            return dict(e) if e else None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self._counters)
            out["estimates"] = {k: dict(v)
                                for k, v in self._estimates.items()}
            return out


#: process-wide singleton the MFU estimators report into
mfu_metrics = MfuMetrics()


class MultihostMetrics:
    """Counters of the multi-process runtime (``parallel/multihost.py``,
    the manager's cluster commits, ``ResilientFit``'s host-loss path):
    joins and their retries and failures, control-plane barriers and
    their wait, per-step flag syncs, cluster commits, host losses,
    evictions, stale heartbeats."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.joins = 0
            self.join_retries = 0
            self.join_failures = 0
            self.barriers = 0
            self.barrier_wait_ms = 0.0
            self.flag_syncs = 0
            self.cluster_commits = 0
            self.host_losses = 0
            self.evictions = 0
            self.heartbeat_stale_events = 0

    def note(self, key: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, key, getattr(self, key) + by)

    def note_wait(self, ms: float) -> None:
        with self._lock:
            self.barrier_wait_ms += ms

    def count(self, key: str) -> int:
        with self._lock:
            return getattr(self, key)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "joins": self.joins,
                "join_retries": self.join_retries,
                "join_failures": self.join_failures,
                "barriers": self.barriers,
                "barrier_wait_ms": round(self.barrier_wait_ms, 3),
                "flag_syncs": self.flag_syncs,
                "cluster_commits": self.cluster_commits,
                "host_losses": self.host_losses,
                "evictions": self.evictions,
                "heartbeat_stale_events": self.heartbeat_stale_events,
            }


#: process-wide singleton of the multi-process runtime
multihost_metrics = MultihostMetrics()


class IngestMetrics:
    """Counters of the distributed data service (bytes and batches
    staged, prefetch high-water, read-plan reassignments, reader-state
    round trips, shuffle-seed agreements), booked by the code that does
    the work: ``datasets/data_service.DataService`` (bytes and ms a
    staged batch, the prefetch queue's depth, seed agreements, reader
    state restores, a changed read plan)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.bytes_staged = 0
            self.batches_staged = 0
            self.stage_ms = 0.0
            self.depth_hw = 0
            self.reassignments = 0
            self.state_roundtrips = 0
            self.seed_agreements = 0

    def note(self, key: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, key, getattr(self, key) + by)

    def note_staged(self, nbytes: int, ms: float, batches: int = 1) -> None:
        with self._lock:
            self.bytes_staged += int(nbytes)
            self.batches_staged += batches
            self.stage_ms += ms

    def note_depth(self, depth: int) -> None:
        with self._lock:
            self.depth_hw = max(self.depth_hw, int(depth))

    def count(self, key: str) -> int:
        with self._lock:
            return getattr(self, key)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "bytes_staged": self.bytes_staged,
                "batches_staged": self.batches_staged,
                "stage_ms": round(self.stage_ms, 3),
                "depth_hw": self.depth_hw,
                "reassignments": self.reassignments,
                "state_roundtrips": self.state_roundtrips,
                "seed_agreements": self.seed_agreements,
            }


#: process-wide singleton of the distributed data service
ingest_metrics = IngestMetrics()


def device_memory_stats() -> Dict[str, Any]:
    """Per-device memory where the backend reports it, keyed
    ``cuda:<i>``: ``bytes_in_use`` / ``peak_bytes_in_use`` (the caching
    allocator's allocated bytes, now and at peak), ``bytes_reserved``,
    ``bytes_limit`` (the card's memory), ``num_allocs``.  Without CUDA
    the CPU gets the reference's explicit ``{"unsupported": <reason>}``
    marker, so a CPU run and a failed stats call stay apart."""
    if not torch.cuda.is_available():
        return {"cpu": {"unsupported": "cpu"}}
    stats: Dict[str, Any] = {}
    for i in range(torch.cuda.device_count()):
        try:
            s = torch.cuda.memory_stats(i)
            stats[f"cuda:{i}"] = {
                "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak",
                                               0)),
                "bytes_reserved": int(s.get("reserved_bytes.all.current",
                                            0)),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(i).total_memory),
                "num_allocs": int(s.get("allocation.all.allocated", 0)),
            }
        except Exception as e:  # noqa: BLE001 — backend-specific errors
            stats[f"cuda:{i}"] = {"unsupported": type(e).__name__}
    return stats


def peak_bytes_in_use(stats: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Optional[int]]:
    """Per-device ``peak_bytes_in_use`` out of
    :func:`device_memory_stats` (None where it is not reported)."""
    if stats is None:
        stats = device_memory_stats()
    out: Dict[str, Optional[int]] = {}
    for dev, s in stats.items():
        if isinstance(s, dict) and "unsupported" not in s:
            peak = s.get("peak_bytes_in_use")
            out[dev] = int(peak) if peak is not None else None
        else:
            out[dev] = None
    return out


# below the singletons, as in the reference (an import cycle through the
# listeners must find them bound)
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: E402
    IterationListener)


class ScalarsLogger:
    """Append-only JSONL scalars sink, one line per step:
    ``{"step": i, "wall": t, **scalars}`` (``runtime/console.py`` serves
    these files)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, **scalars: float) -> None:
        rec = {"step": step, "wall": round(time.time() - self._t0, 4)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]


class MetricsListener(IterationListener):
    """IterationListener that records score + step wall time to a
    :class:`ScalarsLogger` (and samples/sec given a batch size).  The
    step timer resets per fit (``on_fit_start``); a model's cumulative
    ``guard_skips`` rides along in every record."""

    def __init__(self, logger: ScalarsLogger, batch_size: int = 0):
        self.logger = logger
        self.batch_size = batch_size
        self._last = None

    def reset(self) -> None:
        """Forget the previous step's timestamp."""
        self._last = None

    def on_fit_start(self, model) -> None:
        self.reset()

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        scalars = {"score": score}
        if self._last is not None:
            dt = now - self._last
            scalars["step_seconds"] = dt
            if self.batch_size and dt > 0:
                scalars["samples_per_sec"] = self.batch_size / dt
        self._last = now
        skips = getattr(model, "guard_skips", None)
        if skips is not None:
            scalars["guard_skips"] = skips
        self.logger.log(iteration, **scalars)


class ThroughputMeter:
    """Windowed samples/sec; call tick(n_samples) once per step."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events: List[tuple] = []

    def tick(self, n_samples: int) -> Optional[float]:
        now = time.perf_counter()
        self._events.append((now, n_samples))
        self._events = self._events[-self.window:]
        if len(self._events) < 2:
            return None
        dt = self._events[-1][0] - self._events[0][0]
        n = sum(s for _, s in self._events[1:])
        return n / dt if dt > 0 else None


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the enclosed window with ``torch.profiler`` (host and, on
    the card, device activity) and write it to ``logdir`` as a Chrome
    trace (``trace.json``, Perfetto-viewable).  Yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region in profiler timelines (``record_function``)."""
    with torch.profiler.record_function(name):
        yield


class Profiler:
    """Profiling hooks: ``trace(logdir)`` (:func:`profile_trace`),
    ``annotate(name)`` (:func:`annotate`) and ``step_timer()``, a
    host-side wall-clock step timer (device sync is the caller's job)."""

    @staticmethod
    def trace(logdir: str):
        return profile_trace(logdir)

    @staticmethod
    def annotate(name: str):
        return annotate(name)

    @staticmethod
    def step_timer():
        class _Timer:
            def __init__(self):
                self.times = []
                self._t0 = None

            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                self.times.append(time.perf_counter() - self._t0)
                return False

            @property
            def mean_s(self):
                return sum(self.times) / len(self.times) if self.times else 0.0

        return _Timer()
