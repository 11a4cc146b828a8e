"""Continuous-batching autoregressive decode serving.

Port of ``deeplearning4j_tpu/serving/decode.py``, pinned slots:

- :class:`DecodeEngine` owns one slot-structured KV cache ``[L, S,
  T_max, NH, D]`` per cache-length bucket (S concurrent sequences, a
  powers-of-two T_max ladder) and advances every occupied slot of a
  bucket by one token per decode dispatch (``gpt.slot_decode``).
- New requests JOIN a running bucket: the prompt is prefilled into a
  free slot chunk by chunk (``gpt.slot_prefill``) between two decode
  steps; finished sequences (EOS or token budget) free their slot and
  the next pending request takes it.
- :class:`ContinuousBatcher` is the front end: one worker thread owns
  the engine, streams tokens back through :class:`DecodeRequest`
  handles, books time to first token and per-step latency into
  ``runtime.metrics.decode_metrics``, expires requests past their
  ``deadline_ms`` and drains on close.

Both dispatches run through the compile engine (``runtime/
compile_cache``, the reference's :734-738): on the card each bucket's
decode step is one CUDA graph (``decode.step``) and each bucket's
prefill chunk another (``decode.prefill``), captured by ``warmup()``
and replayed after.  A prefill's slot, start, valid length, seed and
temperature reach its graph as device scalars, so one capture serves
every slot and chunk.  The slot state is donated to both entries,
which share their buffers (``share=``), so a bucket's KV cache lives in
one place that prefill and step update in place.  The params and the
activity, temperature and seed arrays are read-only arguments, copied
in only when their version moves (a join or a release), so a steady
step copies nothing to the device; its one sync is the ``[S]`` token
fetch, outside the graph, which is the stream.

Tier 2: ``quantize="int8"|"bf16"`` serves post-training quantized
weights (``runtime/quantize.py``), quantized once per distinct params
tree and dequantized to the compute dtype at every dispatch (the port
has no fuser, so that is an extra pass over the weights);
``kv_dtype="int8"`` keeps the slot cache in int8 with per-row scales.
The prefix store (``prefix_cache=``), paged KV (``paged=``,
``n_pages=``) and speculative decoding (``draft=``) are ROADMAP A4;
``mesh=`` is A7.  Each raises ``NotImplementedError``.

Threading: ``torch.inference_mode`` is thread-local, so the engine's
entry points enter it themselves and the batcher's worker enters it for
its whole loop.  Exactly one thread drives ``start``/``advance``/
``release``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.models import gpt
from deeplearning4j_tpu_torch.models import transformer as tfm
from deeplearning4j_tpu_torch.runtime import compile_cache
from deeplearning4j_tpu_torch.runtime import quantize as qz
from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.metrics import (compile_metrics,
                                                      decode_metrics)
from deeplearning4j_tpu_torch.serving.batcher import (BatcherClosed,
                                                      DeadlineExceeded)

__all__ = ["BatcherClosed", "ContinuousBatcher", "DeadlineExceeded",
           "DecodeEngine", "DecodeRequest", "default_length_buckets"]


def default_length_buckets(max_len: int, min_bucket: int = 32
                           ) -> Tuple[int, ...]:
    """Powers-of-two cache-length ladder up to and including
    ``max_len`` (:207)."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1: {max_len}")
    ladder = [min(min_bucket, max_len)]
    while ladder[-1] < max_len:
        ladder.append(min(ladder[-1] * 2, max_len))
    return tuple(ladder)


def _not_ported(knob: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"DecodeEngine({knob}) is not ported yet: ROADMAP {item}")


class _Bucket:
    """One cache-length bucket (:383): the slot state on the device, the
    host's view of who owns which slot, and the device copies of the
    activity, temperature and seed arrays the decode step reads."""

    __slots__ = ("t_max", "slots", "active", "owners", "ran", "active_d",
                 "temps_d", "seeds_d")

    def __init__(self, t_max: int, n_slots: int, device: torch.device):
        self.t_max = t_max
        self.slots: Optional[gpt.DecodeSlots] = None    # made lazily
        self.active = np.zeros((n_slots,), np.bool_)
        self.owners: List[Any] = [None] * n_slots
        self.ran = np.zeros((n_slots,), np.bool_)
        self.active_d = torch.zeros(n_slots, dtype=torch.bool,
                                    device=device)
        self.temps_d = torch.zeros(n_slots, dtype=torch.float32,
                                   device=device)
        self.seeds_d = torch.zeros(n_slots, dtype=torch.int64,
                                   device=device)

    def free_slot(self) -> Optional[int]:
        for i, o in enumerate(self.owners):
            if o is None:
                return i
        return None

    def n_active(self) -> int:
        return int(self.active.sum())


class DecodeEngine:
    """Slot-structured KV-cache decode engine for a causal LM
    (``models/gpt.py``) on ``device`` (None = CUDA) (:429).  Not
    thread-safe: one thread (normally the :class:`ContinuousBatcher`
    worker) drives ``start``/``advance``/``release``; construction and
    ``warmup()`` come before serving.

    ``params`` may be the tree, on ``device``, or a zero-arg callable
    returning it.  ``prefill_chunk`` shrinks to the largest width that
    divides every bucket, so a near-full prompt's last slab never runs
    past the cache.
    """

    def __init__(self, cfg, params: Any, *, n_slots: int = 8,
                 buckets: Optional[Sequence[int]] = None,
                 prefill_chunk: int = gpt.PREFILL_CHUNK,
                 mesh=None,
                 quantize: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: Any = None,
                 paged: Any = False, n_pages: Optional[int] = None,
                 draft: Optional[Tuple[Any, Any]] = None,
                 device: DeviceLike = None):
        if mesh is not None:
            raise _not_ported("mesh=", "A7 (parallelism)")
        if prefix_cache:
            raise _not_ported("prefix_cache=", "A4 (the prefix store)")
        if paged or n_pages is not None:
            raise _not_ported("paged=, n_pages=", "A4 (paged KV)")
        if draft is not None:
            raise _not_ported("draft=", "A4 (speculative decoding)")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1: {n_slots}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = int(n_slots)
        self.quantize = qz.check_mode(quantize)
        self.kv_dtype = gpt._kv_dtype(kv_dtype)
        self._served = qz.ServedParams(
            params,
            (lambda raw: gpt.serving_params(cfg, raw))
            if self.quantize is None
            else (lambda raw: qz.quantize_tree(raw, self.quantize)))
        self.buckets = tuple(sorted(set(
            buckets if buckets is not None
            else default_length_buckets(cfg.max_len))))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad bucket ladder: {self.buckets}")
        if self.buckets[-1] > cfg.max_len:
            raise ValueError(
                f"bucket {self.buckets[-1]} exceeds the model's "
                f"max_len {cfg.max_len}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1: {prefill_chunk}")
        chunk = min(int(prefill_chunk), self.buckets[0])
        for t in self.buckets:
            chunk = math.gcd(chunk, t)
        self.prefill_chunk = chunk
        # outside inference_mode: the dispatches read the slot vectors
        # as read-only arguments, copied in only when their version moves
        self._buckets: Dict[int, _Bucket] = {
            t: _Bucket(t, self.n_slots, self.device) for t in self.buckets}
        prefill_fn, decode_fn = gpt.make_slot_fns(cfg)
        if self.quantize is not None:
            # dequantized to the compute dtype inside each captured
            # dispatch
            cdt = tfm.compute_dtype(cfg)
            base_prefill, base_decode = prefill_fn, decode_fn

            def prefill_fn(params, *a):
                return base_prefill(qz.dequantize_tree(params, cdt), *a)

            def decode_fn(params, *a):
                return base_decode(qz.dequantize_tree(params, cdt), *a)
        slot_prefill = prefill_fn

        def prefill_fn(params, slots, toks, scalars, temperature):
            # scalars: [slot, start, n_valid, seed] int64 on the device
            return slot_prefill(params, slots, toks, scalars[0],
                                scalars[1], scalars[2], temperature,
                                scalars[3])

        # one entry in two: both update the buckets' KV caches, which
        # live in the buffers they share
        self._prefill = compile_cache.cached_graph(
            prefill_fn, label="decode.prefill", donate_argnums=(1,))
        self._decode = compile_cache.cached_graph(
            decode_fn, label="decode.step", donate_argnums=(1,),
            share=self._prefill)
        #: KV bytes one slot of the largest bucket costs, the 'slots per
        #: card' denominator
        self.kv_bytes_per_slot = int(gpt.slots_bytes_per_slot(
            cfg, self.buckets[-1], self.kv_dtype))
        decode_metrics.note_kv_bytes_per_slot(self.kv_bytes_per_slot)

    # -- params ------------------------------------------------------------
    def current_params(self) -> Any:
        """The tree the dispatches take: quantized when ``quantize`` is
        set, else ``gpt.serving_params`` of the raw tree (the product
        weights in the compute dtype).  Static params are transformed
        once and the engine drops its reference to the raw tree; a
        live-params callable's tree is transformed again only when it
        returns a new tree object (:class:`runtime.quantize.
        ServedParams`)."""
        return self._served.get()

    # -- geometry ----------------------------------------------------------
    def pick_bucket(self, total_len: int) -> int:
        """Smallest cache-length bucket that fits prompt + budget."""
        for t in self.buckets:
            if t >= total_len:
                return t
        raise ValueError(
            f"request needs {total_len} positions; largest bucket is "
            f"{self.buckets[-1]} (model max_len {self.cfg.max_len})")

    def free_slot(self, bucket: int) -> Optional[int]:
        return self._buckets[bucket].free_slot()

    def n_active(self) -> int:
        return sum(b.n_active() for b in self._buckets.values())

    def active_buckets(self) -> List[int]:
        return [t for t, b in self._buckets.items() if b.n_active()]

    def can_admit(self, bucket: int, prompt_len: int) -> bool:
        """Room for a request in ``bucket`` now: a free slot."""
        return self._buckets[bucket].free_slot() is not None

    def check_capacity(self, prompt_len: int) -> None:
        """Pinned slots hold any prompt their bucket fits (the page-pool
        check of a paged engine is ROADMAP A4)."""

    def last_ran(self, bucket: int) -> np.ndarray:
        """``[S]`` mask of the slots the last ``advance`` moved."""
        return self._buckets[bucket].ran.copy()

    def _state(self, b: _Bucket) -> gpt.DecodeSlots:
        if b.slots is None:
            b.slots = gpt.init_slots(self.cfg, self.n_slots, b.t_max,
                                     kv_dtype=self.kv_dtype,
                                     device=self.device)
        return b.slots

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill_chunk(self, params, slots, toks: torch.Tensor, slot: int,
                       start: int, n_valid: int, temperature: float,
                       seed: int):
        """One prefill dispatch, its scalars moved to the device in two
        small copies."""
        scalars = torch.tensor([slot, start, n_valid, int(seed) & gpt._M32],
                               dtype=torch.int64).to(self.device)
        temp = torch.tensor(float(temperature),
                            dtype=torch.float32).to(self.device)
        return self._prefill(params, slots, toks, scalars, temp)

    # -- warmup ------------------------------------------------------------
    def warmup(self) -> dict:
        """Run one prefill chunk and one decode step in every bucket (on
        the card: capture both graphs of the bucket), then zero the slot
        state so serving starts from zeros.  Returns ``{"buckets": n,
        "compiles": captures booked, "warmup_ms": wall}``."""
        params = self.current_params()
        t0 = time.perf_counter()
        c0 = compile_metrics.compile_count
        with torch.inference_mode(), \
                telemetry.span("decode.warmup", buckets=len(self.buckets)):
            toks = torch.zeros(self.prefill_chunk, dtype=torch.int32,
                               device=self.device)
            for t in self.buckets:
                b = self._buckets[t]
                b.slots, _ = self._prefill_chunk(params, self._state(b),
                                                 toks, 0, 0, 1, 0.0, 0)
                b.slots, _ = self._decode(params, b.slots, b.active_d,
                                          b.temps_d, b.seeds_d)
                for buf in b.slots:
                    if buf is not None:
                        buf.zero_()
                self._sync()
        return {"buckets": len(self.buckets),
                "compiles": compile_metrics.compile_count - c0,
                "warmup_ms": (time.perf_counter() - t0) * 1e3}

    # -- serving -----------------------------------------------------------
    def start(self, prompt: np.ndarray, *, max_tokens: int,
              temperature: float = 0.0, seed: int = 0,
              owner: Any = True) -> Tuple[int, int, int]:
        """Prefill ``prompt`` ``[T_p]`` into a free slot of the bucket
        that fits ``T_p + max_tokens`` and activate it: the mid-flight
        JOIN (:1327).  Returns ``(bucket, slot, first_token)``.  Raises
        RuntimeError when the bucket has no free slot (callers gate on
        ``free_slot``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1: {max_tokens}")
        bucket = self.pick_bucket(prompt.size + max_tokens)
        b = self._buckets[bucket]
        slot = b.free_slot()
        if slot is None:
            raise RuntimeError(f"no free slot in bucket {bucket}")
        with torch.inference_mode():
            first_tok = self._start_pinned(prompt, b, bucket, slot,
                                           temperature, seed)
            b.active_d[slot] = True
            b.temps_d[slot] = float(temperature)
            b.seeds_d[slot] = int(seed) & gpt._M32
        b.active[slot] = True
        b.owners[slot] = owner
        return bucket, slot, first_tok

    def _start_pinned(self, prompt: np.ndarray, b: _Bucket, bucket: int,
                      slot: int, temperature: float, seed: int) -> int:
        params = self.current_params()
        slots = self._state(b)
        C = self.prefill_chunk
        n_chunks = -(-prompt.size // C)
        padded = np.zeros((n_chunks * C,), np.int32)
        padded[:prompt.size] = prompt
        toks = torch.from_numpy(padded).to(self.device)
        with telemetry.span("decode.prefill", bucket=bucket, slot=slot,
                            prompt_tokens=int(prompt.size),
                            chunks=n_chunks):
            # a failure leaves the other slots' rows and this slot's
            # tokens/pos untouched: the slot is simply not activated
            for c in range(n_chunks):
                lo = c * C
                slots, first = self._prefill_chunk(
                    params, slots, toks[lo:lo + C], slot, lo,
                    min(C, prompt.size - lo), temperature, seed)
            b.slots = slots
            first_tok = int(first)              # join-time sync, once
        decode_metrics.note_prefill(n_chunks)
        return first_tok

    def advance(self, bucket: int) -> np.ndarray:
        """One decode dispatch for ``bucket``: every active slot emits
        its next token (:1567).  Returns the ``[S]`` tokens (entries of
        inactive slots are stale; callers go by their ownership map)."""
        b = self._buckets[bucket]
        params = self.current_params()
        n_act = b.n_active()
        b.ran = b.active.copy()
        with torch.inference_mode(), \
                telemetry.span("decode.dispatch", bucket=bucket,
                               active=n_act):
            b.slots, out = self._decode(params, self._state(b),
                                        b.active_d, b.temps_d, b.seeds_d)
            # the per-step stream sync: the [S] tokens must reach the
            # host to stream, the one fetch a step
            toks = out.cpu().numpy()
        decode_metrics.note_decode_dispatch(n_act, self.n_slots)
        return toks

    def release(self, bucket: int, slot: int) -> None:
        """Free a finished slot (:1701).  Its cache rows need no
        scrubbing: the next occupant prefills over them, and decode never
        attends past its own position."""
        b = self._buckets[bucket]
        b.active[slot] = False
        b.owners[slot] = None
        with torch.inference_mode():
            b.active_d[slot] = False

    def close(self) -> None:
        """Nothing to stop: the prefix-harvest worker this stops in the
        reference comes with the prefix store (ROADMAP A4)."""


class DecodeRequest:
    """Handle of one in-flight decode request (:1714): tokens stream into
    a buffer as the engine emits them; ``result()`` blocks for the whole
    continuation, ``stream()`` yields tokens as they land.
    ``deadline_ms`` bounds the whole request, queue wait included: past
    it the batcher frees the slot and the handle resolves with
    :class:`DeadlineExceeded`."""

    def __init__(self, prompt: np.ndarray, max_tokens: int,
                 temperature: float, seed: int, eos_id: Optional[int],
                 deadline_ms: Optional[float] = None):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.seed = seed
        self.eos_id = eos_id
        self.deadline_ms = deadline_ms
        self.ttft_ms: Optional[float] = None
        self._t_submit = time.perf_counter()
        self._deadline: Optional[float] = (
            self._t_submit + deadline_ms / 1e3
            if deadline_ms is not None else None)
        self._tokens: List[int] = []
        self._cond = threading.Condition()
        self._done = False
        self._error: Optional[BaseException] = None

    # -- producer side (batcher worker) ------------------------------------
    def _push(self, tok: int) -> None:
        with self._cond:
            if self.ttft_ms is None:
                self.ttft_ms = (time.perf_counter()
                                - self._t_submit) * 1e3
                decode_metrics.note_ttft_ms(self.ttft_ms)
            self._tokens.append(int(tok))
            self._cond.notify_all()

    def _finish(self, error: Optional[BaseException] = None) -> None:
        with self._cond:
            self._error = error
            self._done = True
            self._cond.notify_all()

    def _expired(self, now: float) -> bool:
        return (self._deadline is not None and now > self._deadline
                and not self.done())

    # -- consumer side -----------------------------------------------------
    def done(self) -> bool:
        with self._cond:
            return self._done

    def result(self, timeout: Optional[float] = 120.0) -> np.ndarray:
        """Block until the request finishes; the generated tokens ``[n]``
        int32 (prompt excluded)."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError(
                    f"decode request not finished within {timeout}s")
            if self._error is not None:
                raise self._error
            return np.asarray(self._tokens, np.int32)

    def stream(self, timeout: Optional[float] = 120.0):
        """Yield tokens as they are generated, then raise the request's
        error, if any.  Tokens are yielded outside the request's lock, so
        a slow consumer never blocks the worker's ``_push``."""
        i = 0
        while True:
            with self._cond:
                if not self._cond.wait_for(
                        lambda: self._done or len(self._tokens) > i,
                        timeout):
                    raise TimeoutError(f"no token within {timeout}s")
                pending = self._tokens[i:]
                # _push precedes _finish: once done, the list is final
                finished = self._done
                err = self._error
            for tok in pending:
                i += 1
                yield tok
            if finished:
                if err is not None:
                    raise err
                return


class ContinuousBatcher:
    """Streaming front end over a :class:`DecodeEngine` (:1902): one
    worker thread admits pending requests into free slots (prefill joins
    between decode steps), advances every occupied bucket one token an
    iteration, recycles slots on EOS or budget, and resolves
    :class:`DecodeRequest` handles.  ``close()`` drains: accepted
    requests run to completion, then the worker exits.  A failed
    dispatch resolves the requests of its bucket with the error (replay
    on another replica comes with the router, ROADMAP A4)."""

    def __init__(self, engine: DecodeEngine, *,
                 default_max_tokens: int = 64):
        self.engine = engine
        self.default_max_tokens = int(default_max_tokens)
        self._cv = threading.Condition()
        self._pending: List[DecodeRequest] = []
        #: popped from ``_pending`` but not yet placed (``engine.start``
        #: runs outside the lock), so ``depth()`` never undercounts
        self._admitting: List[DecodeRequest] = []
        self._placed: Dict[Tuple[int, int], DecodeRequest] = {}
        self._open = True
        self._thread = threading.Thread(
            target=self._loop, name="dl4j-decode-batcher", daemon=True)
        self._thread.start()

    # -- client side -------------------------------------------------------
    def submit(self, prompt, max_tokens: Optional[int] = None,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> DecodeRequest:
        """Enqueue one prompt ``[T_p]`` of ints; returns its handle.  A
        prompt no bucket fits, an empty prompt and a bad deadline raise
        ValueError here, synchronously."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0: {deadline_ms}")
        max_tokens = int(max_tokens or self.default_max_tokens)
        self.engine.pick_bucket(prompt.size + max_tokens)
        self.engine.check_capacity(prompt.size)
        req = DecodeRequest(prompt, max_tokens, float(temperature),
                            int(seed), eos_id, deadline_ms=deadline_ms)
        with self._cv:
            if not self._open:
                raise BatcherClosed("ContinuousBatcher is closed")
            self._pending.append(req)
            decode_metrics.note_request(prompt.size)
            decode_metrics.note_queue_depth(len(self._pending))
            self._cv.notify()
        return req

    def generate(self, prompt, timeout: Optional[float] = 120.0,
                 **kw) -> np.ndarray:
        """Blocking convenience: submit and wait for the result."""
        return self.submit(prompt, **kw).result(timeout)

    def depth(self) -> int:
        """Pending, mid-admit and in-flight requests."""
        with self._cv:
            return (len(self._pending) + len(self._admitting)
                    + len(self._placed))

    # -- worker side -------------------------------------------------------
    def _admit(self) -> int:
        """Place as many pending requests as free slots allow; returns
        how many were placed."""
        admitted = 0
        while True:
            with self._cv:
                req = None
                for i, r in enumerate(self._pending):
                    bucket = self.engine.pick_bucket(
                        r.prompt.size + r.max_tokens)
                    if self.engine.can_admit(bucket, r.prompt.size):
                        req = self._pending.pop(i)
                        self._admitting.append(req)
                        break
                if req is None:
                    decode_metrics.note_queue_depth(len(self._pending))
                    return admitted
            joined = self.engine.n_active() > 0
            try:
                bucket, slot, first = self.engine.start(
                    req.prompt, max_tokens=req.max_tokens,
                    temperature=req.temperature, seed=req.seed, owner=req)
            except Exception as e:      # resolve, never wedge the client
                with self._cv:
                    self._admitting.remove(req)
                req._finish(e)
                continue
            if joined:
                decode_metrics.note_join()
            telemetry.event("decode.join", bucket=bucket, slot=slot,
                            prompt_tokens=int(req.prompt.size),
                            mid_flight=joined)
            admitted += 1
            with self._cv:
                self._admitting.remove(req)
                self._placed[(bucket, slot)] = req
            req._push(first)
            self._maybe_finish(bucket, slot, req, first,
                               n_out=len(req._tokens))

    def _maybe_finish(self, bucket: int, slot: int, req: DecodeRequest,
                      tok: int, n_out: int) -> bool:
        if (req.eos_id is not None and tok == req.eos_id) \
                or n_out >= req.max_tokens:
            self.engine.release(bucket, slot)
            with self._cv:
                self._placed.pop((bucket, slot), None)
            decode_metrics.note_complete(n_out)
            req._finish()
            telemetry.event("decode.complete", bucket=bucket, slot=slot,
                            tokens=n_out,
                            ttft_ms=round(req.ttft_ms or 0.0, 3))
            return True
        return False

    def _advance_all(self) -> None:
        for bucket in self.engine.active_buckets():
            t0 = time.perf_counter()
            try:
                toks = self.engine.advance(bucket)
            except Exception as e:
                # the bucket's requests fail with the dispatch's error;
                # their slots free, and the other buckets go on
                with self._cv:
                    failed = [(k, r) for k, r in self._placed.items()
                              if k[0] == bucket]
                    for k, _ in failed:
                        self._placed.pop(k, None)
                for (bk, slot), r in failed:
                    self.engine.release(bk, slot)
                    r._finish(e)
                continue
            decode_metrics.note_token_ms((time.perf_counter() - t0) * 1e3)
            ran = self.engine.last_ran(bucket)
            with self._cv:
                owned = [(k, r) for k, r in self._placed.items()
                         if k[0] == bucket]
            for (bk, slot), r in owned:
                if ran[slot]:
                    tok = int(toks[slot])
                    r._push(tok)
                    self._maybe_finish(bk, slot, r, tok,
                                       n_out=len(r._tokens))

    def _expire(self) -> None:
        """Resolve every request past its deadline with
        :class:`DeadlineExceeded`: queued ones leave the queue, placed
        ones free their slot."""
        now = time.perf_counter()
        with self._cv:
            exp_q = [r for r in self._pending if r._expired(now)]
            for r in exp_q:
                self._pending.remove(r)
            exp_s = [(k, r) for k, r in self._placed.items()
                     if r._expired(now)]
            for k, _ in exp_s:
                self._placed.pop(k, None)
        for (bucket, slot), _ in exp_s:
            self.engine.release(bucket, slot)
        for r in exp_q + [r for _, r in exp_s]:
            decode_metrics.note_deadline_expiration()
            r._finish(DeadlineExceeded(
                r.deadline_ms, (now - r._t_submit) * 1e3, len(r._tokens)))
            telemetry.event("decode.deadline_exceeded",
                            deadline_ms=r.deadline_ms,
                            tokens=len(r._tokens))

    def _loop(self) -> None:
        # inference mode is thread-local: the worker enters it itself
        with torch.inference_mode():
            while True:
                with self._cv:
                    while self._open and not self._pending \
                            and not self._placed:
                        self._cv.wait()
                    if not self._open and not self._pending \
                            and not self._placed:
                        return
                self._expire()
                admitted = self._admit()
                self._advance_all()
                with self._cv:
                    if self._open and not admitted and not self._placed \
                            and self._pending:
                        # nothing placed and nothing pending fits: wait
                        # (a submit or close wakes it; the timeout keeps
                        # deadlines ticking)
                        self._cv.wait(0.005)

    # -- lifecycle ---------------------------------------------------------
    def close(self, timeout: float = 120.0) -> None:
        """Stop accepting, drain accepted requests, join the worker."""
        with self._cv:
            self._open = False
            self._cv.notify_all()
        self._thread.join(timeout)
        self.engine.close()

    def __enter__(self) -> "ContinuousBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
