"""Continuous-batching autoregressive decode serving.

Port of ``deeplearning4j_tpu/serving/decode.py``:

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
  ``deadline_ms``, replays the requests of a failed dispatch and drains
  on close.  ``serving/router.Router`` puts replicas behind one front
  door.

Every dispatch runs through the compile engine (``runtime/
compile_cache``, the reference's :734-779): on the card each bucket's
decode step is one CUDA graph (``decode.step``), its prefill chunk
another (``decode.prefill``), and with a draft model the draft's prefill
chunk (``decode.draft_prefill``) and the speculative round
(``decode.spec_round``) two more (``decode`` is the engine's ``label``),
captured by ``warmup()`` and replayed after.  A prefill's slot, start,
valid length, seed and temperature reach its graph as device scalars, so
one capture serves every slot and chunk.  The engine's device state is
donated to every entry, which share their buffers (``share=``): each
entry takes ``(params, state, ...)``, so the state's leaves sit at the
same places in every signature, and the KV cache lives in one place that
every entry updates in place.  The params, the page tables and the
activity, temperature and seed arrays are read-only arguments, copied in
only when their version moves (a join, a release, a page allocation), so
a steady step copies nothing to the device; its one sync is the token
fetch, outside the graph, which is the stream.

Tier 2: ``quantize="int8"|"bf16"`` serves post-training quantized
weights (``runtime/quantize.py``), quantized once per distinct params
tree and dequantized to the compute dtype at every dispatch (the port
has no fuser, so that is an extra pass over the weights);
``kv_dtype="int8"`` keeps the cache in int8 with per-row scales.
``prefix_cache=`` attaches a content-hashed :class:`PrefixCache`: a
request whose chunk-aligned prompt prefix is stored mounts its pages
and prefills only its tail, bit-exact against a cold prefill.

Tier 3: ``paged=True`` (or ``n_pages=``) keeps the KV in one pool of
pages shared by every bucket, with a refcounted :class:`PageAllocator`
and per-slot page tables, and mounts pool-resident prefixes by
reference; ``draft=(cfg_d, params_d)`` decodes speculatively (``draft_k``
proposals a round, verified in one pass, token-identical to plain
decoding at any temperature); ``rebind_params`` swaps the weights of an
idle engine with no new capture.

``mesh=`` (the reference's model-sharded engine, :603-730) runs SPMD:
every rank of the mesh's model group builds the engine with the same
arguments and makes the same calls.  The params (the global tree)
are laid out by ``gpt.shard_specs``, and the pinned
slots' and the page pool's KV caches hold the rank's heads
(``gpt.slot_specs`` / ``paged_specs``); the cached stack sums the
row-parallel products over ``model`` (``parallel/tensor_parallel``), so
every rank samples the same tokens, the replicated engine's.  The
entries are captured only where the group's collectives can be
(``parallel.mesh.mesh_captures``: not under gloo), and always where
the rank's model group is itself alone (no collective runs then).  On a
mesh with a ``pipe`` or ``seq`` axis above 1 every rank of that group
holds the whole served tree (the reference's decode specs split only
``model``: its ``P()`` placement replicates the rest), and serves
alike: the ranks that share a data coordinate are one serving group.
``quantize=`` quantizes the GLOBAL tree, then slices each int8 payload by its leaf's
spec and each per-channel scale by ``runtime/quantize.quant_specs``, so
every scale is the replicated engine's (``rebind_params`` keeps that
order); ``kv_dtype="int8"`` takes each row's amax over every head of
the group (one small all-reduce a layer a write), so the replicated
scales are the replicated engine's; ``draft=`` lays the draft's params
out by ``gpt.shard_specs`` too and shards its KV over heads beside the
target's.  A mesh engine's prefix harvests are stored before its next
admission (``flush_harvests``), so every rank of the group sees the
same store.  :class:`ContinuousBatcher` over a mesh engine runs one
rank of the group as the leader and the others as followers of its
schedule (the class's docstring).  The fleet
over these engines (autoscaling, the weight swap of a live fleet,
health-checked replacement, the brownout ladder) is
``serving/router.AutoscalingRouter``.

Threading: ``torch.inference_mode`` is thread-local, so the engine's
entry points enter it themselves and the batcher's worker enters it for
its whole loop.  On the card each engine runs on a CUDA stream of its own
(its entries enter it, after the caller's stream): its graphs are
captured and replayed there, so several replicas on one card overlap
instead of queueing on the default stream.  Exactly one thread drives
``start``/``advance``/``advance_spec``/``release``; the prefix harvester
runs on a thread of its own and touches only the copies the serving
thread hands it.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import math
import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.models import gpt
from deeplearning4j_tpu_torch.models import transformer as tfm
from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                    check_mesh_axes,
                                                    mesh_captures,
                                                    mesh_signature,
                                                    model_degree)
from deeplearning4j_tpu_torch.runtime import compile_cache
from deeplearning4j_tpu_torch.runtime import quantize as qz
from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
from deeplearning4j_tpu_torch.serving.batcher import (BatcherClosed,
                                                      DeadlineExceeded)

__all__ = ["BatcherClosed", "ContinuousBatcher", "DeadlineExceeded",
           "DecodeEngine", "DecodeRequest", "KVPagesExhausted",
           "KV_PAGE_TOKENS", "PageAllocator", "PrefixCache",
           "default_length_buckets"]

#: tokens per KV page: the prefill chunk, so every prefill chunk is one
#: page write and stored prefix pages mount page-aligned (:101)
KV_PAGE_TOKENS = gpt.PREFILL_CHUNK


class KVPagesExhausted(RuntimeError):
    """Typed page-pool exhaustion (:104): an admit or extension needed
    more KV pages than the pool has free.  The batcher admits only what
    ``DecodeEngine.can_admit`` has reserved room for, so through it this
    reaches a request only when a prompt alone exceeds the whole pool.
    A caller driving ``start`` / ``advance`` directly sees it when no
    slot of a bucket can grow (``slot`` names the one holding the most
    pages)."""

    def __init__(self, needed: int, free: int, total: int,
                 bucket: Optional[int] = None, slot: Optional[int] = None):
        super().__init__(
            f"KV page pool exhausted: need {needed} page(s), "
            f"{free} free of {total}")
        self.needed = needed
        self.free = free
        self.total = total
        self.bucket = bucket
        self.slot = slot


class PageAllocator:
    """Host-side refcounted free list over a page pool's ids (:143).
    Page 0 is reserved (the trash page) and never handed out.  ``alloc``
    is all or nothing (:class:`KVPagesExhausted` on a shortfall),
    ``share`` adds references for prefix mounts by reference, ``free``
    drops one and reclaims the page at zero.  Driven by the engine's one
    driver thread."""

    def __init__(self, n_pages: int, n_reserved: int = 1):
        if n_pages <= n_reserved:
            raise ValueError(
                f"n_pages must exceed the {n_reserved} reserved page(s): "
                f"{n_pages}")
        self.n_pages = int(n_pages)
        self.n_reserved = int(n_reserved)
        self._free: List[int] = list(range(n_pages - 1, n_reserved - 1, -1))
        self._refs: Dict[int, int] = {}

    def n_free(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        return self.n_pages - self.n_reserved - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n < 0:
            raise ValueError(f"alloc count must be >= 0: {n}")
        if n > len(self._free):
            raise KVPagesExhausted(n, len(self._free), self.n_pages)
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def share(self, pids: Sequence[int]) -> None:
        for p in pids:
            if p not in self._refs:
                raise ValueError(f"page {p} is not allocated")
            self._refs[p] += 1

    def free(self, pids: Sequence[int]) -> None:
        for p in pids:
            refs = self._refs.get(p)
            if refs is None:
                raise ValueError(f"page {p} is not allocated")
            if refs == 1:
                del self._refs[p]
                self._free.append(p)
            else:
                self._refs[p] = refs - 1

    def refcount(self, pid: int) -> int:
        return self._refs.get(pid, 0)

    def total_refs(self) -> int:
        """Every outstanding page reference: the leak audit's numerator."""
        return sum(self._refs.values())


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


# ---------------------------------------------------------------------------
# the prefix store
# ---------------------------------------------------------------------------

def _owned_copy(p: np.ndarray) -> np.ndarray:
    """``p`` copied into memory of its own: page-locked when a card is
    present, so a hit mounts with non-blocking host-to-device copies and
    no host copy before them (the memory comes from PyTorch's caching
    host allocator, which rounds a block up to a power of two)."""
    if not torch.cuda.is_available():
        return np.array(p, copy=True)
    held = torch.empty(p.nbytes, dtype=torch.uint8, pin_memory=True)
    out = held.numpy().view(p.dtype).reshape(p.shape)
    out[...] = p
    return out


class _PrefixEntry:
    """One stored prefix (:220): its tokens, the KV space that produced
    its pages, the pages (``[L, m, NH, D]`` k/v, plus ``[L, m]`` scales
    for an int8 cache) in memory of their own, and its alias keys."""

    __slots__ = ("tokens", "space", "pages", "nbytes", "alias_keys")

    def __init__(self, tokens: np.ndarray, space: Any,
                 pages: Tuple[np.ndarray, ...]):
        self.tokens = tokens
        self.space = space
        # a slice of a larger array would keep the whole base alive
        # while nbytes counted the slice
        self.pages = tuple(_owned_copy(p) for p in pages)
        self.nbytes = int(tokens.nbytes
                          + sum(p.nbytes for p in self.pages))
        self.alias_keys: List[bytes] = []


class PrefixCache:
    """Content-hashed store of chunk-aligned prompt-prefix KV pages
    (:243).

    - Keys are SHA-1 digests of the KV *space* (the engine's config,
      quantization modes and params generation) and the prefix's token
      bytes at every chunk boundary, from one incremental hasher; a
      digest match is checked against the stored tokens and space, so a
      collision costs a miss, never a wrong hit.
    - An entry is stored once under its longest boundary, with alias
      keys for every shorter one (a multimap: several entries may cover
      a boundary, and evicting one keeps it for the rest).
    - LRU under ``max_bytes``; thread-safe; shared by engines and
      replicas of one model, pinned and paged alike.
    - Pages are host numpy arrays in the reference's row format (bf16
      rows as their ``uint16`` bits, numpy having no bf16), exact copies
      of what prefill wrote, so a hit continues bit-exactly.  An entry's
      copies are page-locked when a card is present.

    Pages are valid only for the params that wrote them: an engine's
    ``rebind_params`` moves its space to a new generation, and
    ``clear()`` drops everything.
    """

    def __init__(self, max_bytes: int = 256 << 20):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1: {max_bytes}")
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, _PrefixEntry]" = OrderedDict()
        self._alias: Dict[bytes, "OrderedDict[bytes, int]"] = {}
        self._bytes = 0

    @staticmethod
    def _boundary_digests(tokens: np.ndarray, chunk: int, n: int,
                          space: Any) -> List[bytes]:
        """Digests of ``tokens[:k * chunk]`` for k = 1..n."""
        tokens = np.ascontiguousarray(tokens, np.int32)
        hasher = hashlib.sha1(repr(space).encode() + b"\x00")
        out = []
        for k in range(1, n + 1):
            hasher.update(tokens[(k - 1) * chunk:k * chunk].tobytes())
            out.append(hasher.digest())
        return out

    def lookup(self, prompt: np.ndarray, chunk: int, space: Any = None
               ) -> Optional[Tuple[int, Tuple[np.ndarray, ...]]]:
        """The longest stored chunk-aligned STRICT prefix of ``prompt``
        in ``space`` (one chunk at least is left to prefill: it gives the
        first token's logits): ``(length, pages)`` or None."""
        prompt = np.asarray(prompt, np.int32)
        digs = self._boundary_digests(prompt, chunk,
                                      (prompt.size - 1) // chunk, space)
        for k in range(len(digs), 0, -1):
            m = k * chunk
            with self._lock:
                refs = self._alias.get(digs[k - 1])
                if not refs:
                    continue
                for full_key in reversed(list(refs)):   # newest first
                    e = self._entries.get(full_key)
                    if (e is None or refs[full_key] != m
                            or e.space != space or e.tokens.size < m
                            or not np.array_equal(e.tokens[:m],
                                                  prompt[:m])):
                        continue
                    self._entries.move_to_end(full_key)
                    return m, tuple(p[:, :m] for p in e.pages)
        return None

    def insert(self, prefix: np.ndarray, pages: Tuple[np.ndarray, ...],
               chunk: int, space: Any = None) -> bool:
        """Store ``pages`` for ``prefix`` (a chunk multiple long) in
        ``space``, with an alias key at every boundary.  False when the
        prefix is stored already or alone exceeds ``max_bytes``."""
        prefix = np.ascontiguousarray(prefix, np.int32)
        m = prefix.size
        if m < chunk or m % chunk:
            raise ValueError(
                f"prefix length {m} is not a positive multiple of the "
                f"prefill chunk {chunk}")
        entry = _PrefixEntry(prefix, space, pages)
        if entry.nbytes > self.max_bytes:
            return False
        digs = self._boundary_digests(prefix, chunk, m // chunk, space)
        full_key = digs[-1]
        with self._lock:
            if full_key in self._entries:
                return False
            while self._bytes + entry.nbytes > self.max_bytes \
                    and self._entries:
                evicted_key, old = self._entries.popitem(last=False)
                for a in old.alias_keys:
                    refs = self._alias.get(a)
                    if refs is not None:
                        refs.pop(evicted_key, None)
                        if not refs:
                            del self._alias[a]
                self._bytes -= old.nbytes
            self._entries[full_key] = entry
            self._bytes += entry.nbytes
            for k in range(1, m // chunk + 1):
                h = digs[k - 1]
                refs = self._alias.setdefault(h, OrderedDict())
                refs[full_key] = k * chunk
                refs.move_to_end(full_key)      # the newest registrant wins
                entry.alias_keys.append(h)
        return True

    def clear(self) -> None:
        """Drop every entry (after a weight update)."""
        with self._lock:
            self._entries.clear()
            self._alias.clear()
            self._bytes = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes}


def _host_rows(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the store's numpy rows: bf16 as its bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _torch_rows(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Stored rows back as a CPU tensor of ``dtype`` over the same
    memory where the dtypes allow (a 2-byte row of a bf16 cache, the
    reference's ml_dtypes bf16 too, is read as bits); ``a`` may be a
    strided view (a shorter prefix's slice of an entry)."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a).to(dtype)


class _Harvester:
    """The prefix-harvest worker (:1133, design: the serving thread
    never waits on it).  The serving thread copies a prefix's rows into
    fresh device buffers in stream order, right after the prefill that
    wrote them, records an event and queues ``(buffers, event, prefix,
    chunk, paged)``; this thread waits on the event, copies the rows to
    host on a stream of its own through reused pinned buffers, and
    inserts them into the store.  It holds the queue and the store,
    never the engine.  A failed harvest is dropped: harvesting is
    opportunistic."""

    def __init__(self, store: PrefixCache, device: torch.device):
        self.q: "queue.Queue" = queue.Queue(maxsize=4)
        self.store = store
        self.device = device
        self.thread: Optional[threading.Thread] = None

    def ensure(self) -> None:
        if self.thread is not None and self.thread.is_alive():
            return
        q, store, dev = self.q, self.store, self.device

        def loop():
            stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                      else None)
            staging: Dict[int, torch.Tensor] = {}
            while True:
                item = q.get()
                try:
                    if item is None:
                        return
                    bufs, event, prefix, chunk, space, paged = item
                    host = _fetch(bufs, event, stream, staging)
                    rows = []
                    for a in host:
                        if paged:           # [L, n, C, ...] -> [L, n*C, ...]
                            a = a.reshape((a.shape[0], a.shape[1] * a.shape[2])
                                          + a.shape[3:])
                        rows.append(a[:, :prefix.size])
                    store.insert(prefix, tuple(rows), chunk, space)
                except Exception:   # noqa: BLE001 -- opportunistic path
                    pass
                finally:
                    q.task_done()

        self.thread = threading.Thread(target=loop,
                                       name="dl4j-prefix-harvest",
                                       daemon=True)
        self.thread.start()

    def put(self, bufs, event, prefix: np.ndarray, chunk: int, space: Any,
            paged: bool) -> None:
        self.ensure()
        try:
            self.q.put_nowait((bufs, event, prefix, chunk, space, paged))
        except queue.Full:
            pass                            # backpressure: dropped

    def flush(self) -> None:
        self.q.join()

    def close(self) -> None:
        t = self.thread
        if t is not None and t.is_alive():
            self.q.put(None)
            t.join()
        self.thread = None


def _fetch(bufs, event, stream, staging: Dict[int, torch.Tensor]):
    """Device buffers -> host numpy rows.  On the card: wait on the
    serving thread's event on this thread's stream, copy into a pinned
    buffer (one a leaf position, grown as needed), wait for that
    stream only."""
    if stream is None:
        return [_host_rows(b) for b in bufs]
    out = []
    with torch.cuda.stream(stream):
        stream.wait_event(event)
        views = []
        for i, b in enumerate(bufs):
            nbytes = b.numel() * b.element_size()
            flat = staging.get(i)
            if flat is None or flat.numel() < nbytes:
                flat = staging[i] = torch.empty(nbytes, dtype=torch.uint8,
                                                pin_memory=True)
            v = flat[:nbytes].view(b.dtype).view(b.shape)
            v.copy_(b, non_blocking=True)
            views.append(v)
        stream.synchronize()
    for v in views:
        out.append(_host_rows(v))
    return out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class _Bucket:
    """One cache-length bucket (:383): the pinned device state, the
    host's view of who owns which slot, the host mirrors of each slot's
    current token and position, the device copies of the activity,
    temperature and seed arrays, and for a paged engine the page table
    (host, and its device copy, refreshed when it changed)."""

    __slots__ = ("t_max", "bi", "state", "active", "owners", "ran",
                 "active_d", "temps_d", "seeds_d", "tokens_h", "pos_h",
                 "ptab", "n_pages", "max_pages", "ptab_d", "ptab_dirty",
                 "run_d", "run_h")

    def __init__(self, t_max: int, bi: int, n_slots: int,
                 device: torch.device, page_tokens: Optional[int]):
        self.t_max = t_max
        self.bi = bi
        self.state = None                       # pinned: made lazily
        self.active = np.zeros((n_slots,), np.bool_)
        self.owners: List[Any] = [None] * n_slots
        self.ran = np.zeros((n_slots,), np.bool_)
        self.active_d = torch.zeros(n_slots, dtype=torch.bool,
                                    device=device)
        self.temps_d = torch.zeros(n_slots, dtype=torch.float32,
                                   device=device)
        self.seeds_d = torch.zeros(n_slots, dtype=torch.int64,
                                   device=device)
        self.tokens_h = np.zeros((n_slots,), np.int32)
        self.pos_h = np.zeros((n_slots,), np.int32)
        self.ptab = self.n_pages = self.max_pages = None
        self.ptab_d = self.run_d = None
        self.run_h = None
        self.ptab_dirty = False
        if page_tokens is not None:
            tbl = t_max // page_tokens
            self.ptab = np.zeros((n_slots, tbl), np.int32)
            self.n_pages = np.zeros((n_slots,), np.int32)
            # the most pages each slot's request can come to hold
            self.max_pages = np.zeros((n_slots,), np.int32)
            self.ptab_d = torch.zeros((n_slots, tbl), dtype=torch.int32,
                                      device=device)
            # the mask a paged dispatch runs: active slots whose pages
            # could be allocated
            self.run_d = torch.zeros(n_slots, dtype=torch.bool,
                                     device=device)
            self.run_h = np.zeros((n_slots,), np.bool_)

    def free_slot(self) -> Optional[int]:
        for i, o in enumerate(self.owners):
            if o is None:
                return i
        return None

    def n_active(self) -> int:
        return int(self.active.sum())


def _on_engine_stream(wait: bool = False):
    """Run an engine entry on the engine's own CUDA stream: its graphs
    are captured and replayed there, so replicas on one card run side by
    side instead of one after another on the default stream.  ``wait``:
    after the caller's stream's work so far, for an entry that takes
    tensors the caller made (the params)."""
    def deco(method):
        @functools.wraps(method)
        def run(self, *args, **kwargs):
            with self._on_stream(wait):
                return method(self, *args, **kwargs)
        return run
    return deco


def _leaves(tree) -> List[torch.Tensor]:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _kv_leaves(cache) -> List[torch.Tensor]:
    """The K/V buffers of slots or a pool, scales last when int8: the
    order of the store's pages."""
    if cache.k_scale is None:
        return [cache.k, cache.v]
    return [cache.k, cache.v, cache.k_scale, cache.v_scale]


class DecodeEngine:
    """Slot-structured KV-cache decode engine for a causal LM
    (``models/gpt.py``) on ``device`` (None = CUDA) (:429).  Not
    thread-safe: one thread (normally the :class:`ContinuousBatcher`
    worker) drives ``start``/``advance``/``advance_spec``/``release``;
    construction and ``warmup()`` come before serving.

    ``params`` may be the tree, on ``device``, or a zero-arg callable
    returning it.  ``prefill_chunk`` shrinks to the largest width that
    divides every bucket, so a near-full prompt's last slab never runs
    past the cache; a paged engine's page width is that chunk.
    ``prefix_cache`` is True (a private store) or a shared
    :class:`PrefixCache`; ``paged``/``n_pages`` select the page pool
    (by default ``n_slots * (largest bucket // chunk) + 1`` pages, the
    pinned capacity plus the trash page); ``draft=(cfg_d, params_d)``
    with ``draft_k`` proposals a round turns on speculative decoding
    (the draft stays in full precision).  ``label`` prefixes the capture
    labels (``{label}.prefill``, ``.step``, ``.draft_prefill``,
    ``.spec_round``).
    """

    def __init__(self, cfg, params: Any, *, n_slots: int = 8,
                 buckets: Optional[Sequence[int]] = None,
                 prefill_chunk: int = gpt.PREFILL_CHUNK,
                 label: str = "decode", mesh=None,
                 quantize: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: Any = None,
                 paged: Any = False, n_pages: Optional[int] = None,
                 draft: Optional[Tuple[Any, Any]] = None,
                 draft_k: int = 4,
                 device: DeviceLike = None):
        check_mesh_axes(mesh)
        #: the model group's size and this rank's group (None: replicated
        #: over the mesh: every other axis holds the whole tree)
        self.mesh = mesh
        self.model_degree = model_degree(mesh)
        self._tp = tpar.model_group(mesh)
        if self._tp is not None:
            m_deg = self.model_degree
            if cfg.n_heads % m_deg:
                raise ValueError(
                    f"n_heads={cfg.n_heads} not divisible by model "
                    f"degree {m_deg}: the slot KV cache "
                    f"shards over heads (gpt.slot_specs)")
            if draft is not None and draft[0].n_heads % m_deg:
                raise ValueError(
                    f"draft n_heads={draft[0].n_heads} not divisible "
                    f"by model degree {m_deg}: the draft KV shards "
                    f"over heads alongside the target's")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1: {n_slots}")
        self.cfg = cfg
        self.label = label
        self.device = resolve_device(device)
        #: the engine's own stream on the card (None on the CPU): every
        #: entry runs on it (``_on_engine_stream``)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.n_slots = int(n_slots)
        self.quantize = qz.check_mode(quantize)
        self.kv_dtype = gpt._kv_dtype(kv_dtype)
        self.paged = bool(paged) or n_pages is not None
        self.draft = draft
        self.draft_k = int(draft_k)
        if draft is not None and self.draft_k < 1:
            raise ValueError(f"draft_k must be >= 1: {draft_k}")
        #: the brownout knobs (:472-479): run speculative rounds (with a
        #: draft), and harvest prompt prefixes into the store and the
        #: resident registry.  Plain bools the router's brownout ladder
        #: writes and the batcher's worker reads each pass; a torn read
        #: costs one pass at the old setting, and both settings give the
        #: same tokens (they change cost only), so no lock is needed
        self.spec_enabled = True
        self.harvest_enabled = True
        self._transform = (
            (lambda raw: gpt.serving_params(cfg, self._shard(cfg, raw)))
            if self.quantize is None
            else (lambda raw: self._shard(cfg, qz.quantize_tree(
                raw, self.quantize), raw)))
        self._served = qz.ServedParams(params, self._transform)
        if prefix_cache is True:
            prefix_cache = PrefixCache()
        self._prefix: Optional[PrefixCache] = prefix_cache or None
        # the KV space of the engine's pages: a shared store serves hits
        # only between engines whose pages are interchangeable (config,
        # quantization modes, params generation; pinned and paged alike)
        self._params_gen = 0
        self._prefix_space = self._space()
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
        self.page_tokens = chunk if self.paged else None
        self.n_kv_pages: Optional[int] = None
        self._alloc: Optional[PageAllocator] = None
        self._pstate = None                     # paged device state
        #: digest -> (prefix tokens, page ids): pool-resident prefixes
        self._resident: "OrderedDict[bytes, Tuple[np.ndarray, tuple]]" = \
            OrderedDict()
        if self.paged:
            default = self.n_slots * (self.buckets[-1] // chunk) + 1
            self.n_kv_pages = int(n_pages or default)
            self._alloc = PageAllocator(self.n_kv_pages)
            self._resident_max = max(self.n_kv_pages // 2, 1)
        self._draft_cfg = None
        self._draft_served = None
        if draft is not None:
            cfg_d, params_d = draft
            if not getattr(cfg_d, "causal", False):
                raise ValueError("draft config must be causal")
            if cfg_d.max_len < self.buckets[-1]:
                raise ValueError(
                    f"draft max_len {cfg_d.max_len} < largest bucket "
                    f"{self.buckets[-1]}: the draft mirrors target "
                    f"positions")
            self._draft_cfg = cfg_d
            self._draft_served = qz.ServedParams(
                params_d, self._draft_transform)
        # outside inference_mode: the dispatches read the slot vectors
        # as read-only arguments, copied in only when their version moves
        self._buckets: Dict[int, _Bucket] = {
            t: _Bucket(t, i, self.n_slots, self.device, self.page_tokens)
            for i, t in enumerate(self.buckets)}
        self._build_entries()
        #: KV bytes one slot of the largest bucket costs, the 'slots per
        #: card' denominator
        self.kv_bytes_per_slot = int(gpt.slots_bytes_per_slot(
            cfg, self.buckets[-1], self.kv_dtype, self.model_degree))
        decode_metrics.note_kv_bytes_per_slot(self.kv_bytes_per_slot)
        #: bytes of the page pools (target and draft), the paged
        #: engine's memory denominator
        self.pool_bytes = 0
        if self.paged:
            self.pool_bytes = gpt.pages_bytes(cfg, self.n_kv_pages, chunk,
                                              self.kv_dtype,
                                              self.model_degree)
            if draft is not None:
                self.pool_bytes += gpt.pages_bytes(
                    self._draft_cfg, self.n_kv_pages, chunk, self.kv_dtype,
                    self.model_degree)
        self._harvester = (_Harvester(self._prefix, self.device)
                           if self._prefix is not None else None)
        #: pinned host staging of prefix mounts, one buffer a leaf
        #: position, the rows the last upload copied from, and its event
        self._stage: Dict[int, torch.Tensor] = {}
        self._uploading: Sequence[np.ndarray] = ()
        self._stage_event = None
        self._live_params = callable(params)
        if self._stream is not None:    # the buffers made above
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    @contextlib.contextmanager
    def _on_stream(self, wait: bool = False):
        """The engine's stream (a no-op on the CPU).  ``wait``, or live
        params (a callable's trees are the caller's at every entry):
        after the caller's stream's work so far.  A step does not wait:
        an event on the default stream at every step would hold the
        replicas of a card back."""
        if self._stream is None:
            yield
            return
        if wait or self._live_params:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            yield

    # -- the captured entries ----------------------------------------------
    def _build_entries(self) -> None:
        """The compile-engine entries.  Each takes ``(params, state,
        ...)``: pinned, a bucket's ``(slots, draft slots or None)``;
        paged, the engine's ``(pool, draft pool or None, tokens [NB, S],
        pos [NB, S])``, one pool for every bucket (``bi`` picks the
        bucket's row of tokens and positions)."""
        cfg, cfg_d, k = self.cfg, self._draft_cfg, self.draft_k
        tp = self._tp
        cdt = tfm.compute_dtype(cfg)
        deq = ((lambda p: p) if self.quantize is None
               else (lambda p: qz.dequantize_tree(p, cdt)))
        if self.paged:
            def prefill_fn(params, state, ptab, toks, scalars, temperature,
                           bi):
                pool, _, tokens, pos = state
                sel = scalars[0].reshape(1)
                _, first = gpt.paged_prefill(
                    cfg, deq(params), pool, ptab.index_select(0, sel)[0],
                    toks, scalars[1], scalars[2], temperature, scalars[3],
                    tp=tp)
                tokens[bi].index_put_((sel,), first.to(tokens.dtype
                                                       ).reshape(1))
                pos[bi].index_put_((sel,), (scalars[1] + scalars[2]).to(
                    pos.dtype).reshape(1))
                return state, first

            def decode_fn(params, state, ptab, active, temps, seeds, bi):
                pool, _, tokens, pos = state
                _, out = gpt.paged_decode(cfg, deq(params), pool, ptab,
                                          tokens[bi], pos[bi], active,
                                          temps, seeds, tp=tp)
                return state, out

            def draft_prefill_fn(params, state, ptab, toks, scalars,
                                 params_d, bi):
                dpool = state[1]
                gpt.paged_prefill(cfg_d, params_d, dpool,
                                  ptab.index_select(0, scalars[0].reshape(
                                      1))[0], toks, scalars[1], scalars[2],
                                  0.0, 0, tp=tp)
                return state

            def spec_fn(params, state, ptab, active, temps, seeds,
                        params_d, bi):
                pool, dpool, tokens, pos = state
                tok, ps = tokens[bi], pos[bi]
                # the draft starts from the committed frontier (:1667),
                # a device-to-device copy inside the round
                _, props = gpt.paged_draft_propose(
                    cfg_d, params_d, dpool, ptab, tok.clone(), ps.clone(),
                    active, k, tp=tp)
                _, t, n_commit = gpt.paged_verify(
                    cfg, deq(params), pool, ptab, tok, ps, active, temps,
                    seeds, props, tp=tp)
                return state, torch.cat([t, n_commit[:, None].to(t.dtype)],
                                        dim=1)
        else:
            def prefill_fn(params, state, toks, scalars, temperature):
                slots, dslots = state
                _, first = gpt.slot_prefill(
                    cfg, deq(params), slots, toks, scalars[0], scalars[1],
                    scalars[2], temperature, scalars[3], tp=tp)
                return state, first

            def decode_fn(params, state, active, temps, seeds):
                _, out = gpt.slot_decode(cfg, deq(params), state[0], active,
                                         temps, seeds, tp=tp)
                return state, out

            def draft_prefill_fn(params, state, toks, scalars, params_d):
                gpt.slot_prefill(cfg_d, params_d, state[1], toks, scalars[0],
                                 scalars[1], scalars[2], 0.0, 0, tp=tp)
                return state

            def spec_fn(params, state, active, temps, seeds, params_d):
                slots, dslots = state
                # the draft's tokens/pos are overwritten with the
                # verified frontier (:1667): rows below it hold the
                # committed tokens' K/V, so no re-sync dispatch
                dslots.tokens.copy_(slots.tokens)
                dslots.pos.copy_(slots.pos)
                _, props = gpt.draft_propose(cfg_d, params_d, dslots, active,
                                             k, tp=tp)
                _, t, n_commit = gpt.slot_verify(cfg, deq(params), slots,
                                                 active, temps, seeds, props,
                                                 tp=tp)
                return state, torch.cat([t, n_commit[:, None].to(t.dtype)],
                                        dim=1)

        # one entry in four: all update the engine's state, which lives
        # in the buffers they share; without a model group the entries
        # run no collective, so they capture on any mesh
        cap = mesh_captures(self.mesh) or self._tp is None
        self._prefill = compile_cache.cached_graph(
            prefill_fn, label=f"{self.label}.prefill", donate_argnums=(1,),
            capture=cap)
        self._decode = compile_cache.cached_graph(
            decode_fn, label=f"{self.label}.step", donate_argnums=(1,),
            share=self._prefill, capture=cap)
        self._draft_prefill = self._spec = None
        if self.draft is not None:
            self._draft_prefill = compile_cache.cached_graph(
                draft_prefill_fn, label=f"{self.label}.draft_prefill",
                donate_argnums=(1,), share=self._prefill, capture=cap)
            self._spec = compile_cache.cached_graph(
                spec_fn, label=f"{self.label}.spec_round",
                donate_argnums=(1,), share=self._prefill, capture=cap)

    # -- params ------------------------------------------------------------
    def _space(self):
        return (repr(self.cfg), self.quantize, self.kv_dtype,
                self._params_gen, mesh_signature(self.mesh))

    def _shard(self, cfg, tree: Any, raw: Any = None) -> Any:
        """This rank's slice of a global params tree of ``cfg``
        (``gpt.shard_specs``); ``raw``: the tree ``tree`` was quantized
        from (its int8 payloads and scales then slice by
        ``runtime/quantize.quant_specs``)."""
        if self._tp is None:
            return tree
        specs = gpt.shard_specs(cfg, self.model_degree)
        if raw is not None:
            specs = qz.quant_specs(specs, raw, self.quantize)
        return tpar.shard_tree(tree, specs, self.mesh)

    def _draft_transform(self, raw: Any) -> Any:
        cfg_d = self._draft_cfg
        return gpt.serving_params(cfg_d, self._shard(cfg_d, raw))

    def current_params(self) -> Any:
        """The tree the dispatches take: quantized when ``quantize`` is
        set, else ``gpt.serving_params`` of the raw tree (the product
        weights in the compute dtype).  Static params are transformed
        once and the engine drops its reference to the raw tree; a
        live-params callable's tree is transformed again only when it
        returns a new tree object (:class:`runtime.quantize.
        ServedParams`)."""
        return self._served.get()

    def _draft_params(self) -> Any:
        return self._draft_served.get()

    @_on_engine_stream(wait=True)
    def rebind_params(self, params: Any, draft_params: Any = None) -> None:
        """Swap the weights of an IDLE engine (:1098; a busy engine
        raises): the new tree is transformed (quantized or cast) here,
        on the calling thread, and its leaves are copied into the same
        static buffers the captured dispatches read, so a tree of the
        same shapes and dtypes costs no new capture.  The prefix space
        moves to a new generation, so a shared store's pages of the old
        weights never serve the new ones, and the resident registry's
        page references are freed.  A draft's params may be swapped too
        (``draft_params``)."""
        if self.n_active():
            raise RuntimeError(
                f"rebind_params on a busy engine ({self.n_active()} "
                f"active slot(s)): drain first")
        if draft_params is not None and self.draft is None:
            raise ValueError("engine built without draft=")
        self._live_params = callable(params)
        self._served = qz.ServedParams(params, self._transform)
        self.current_params()
        if draft_params is not None:
            self._draft_served = qz.ServedParams(draft_params,
                                                 self._draft_transform)
            self._draft_params()
        self._params_gen += 1
        self._prefix_space = self._space()
        if self.paged:
            self._free_residents()

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

    def can_admit(self, bucket: int, prompt_len: int,
                  max_tokens: int) -> bool:
        """Room for a request in ``bucket`` now (:936): a free slot and,
        paged, the most pages the request can come to hold, over and
        above the pages the placed requests may still claim, so a placed
        request never stalls; resident prefixes are evicted, oldest
        first, to make that room."""
        b = self._buckets[bucket]
        if b.free_slot() is None:
            return False
        if not self.paged:
            return True
        needed = self._most_pages(b, prompt_len, max_tokens)
        while self._alloc.n_free() - self._reserved() < needed \
                and self._resident:
            _, (_, ids) = self._resident.popitem(last=False)
            self._alloc.free(ids)
        return self._alloc.n_free() - self._reserved() >= needed

    def _most_pages(self, b: _Bucket, prompt_len: int,
                    max_tokens: int) -> int:
        """The most pages a request can hold: its prompt's, or those
        through the last position a step or a round can write, ``prompt
        + max_tokens - 2`` (the last token is emitted, not consumed) plus
        a round's ``draft_k``."""
        k = self.draft_k if self.draft is not None else 0
        last = prompt_len + max_tokens - 2 + k
        return min(max(-(-prompt_len // self.page_tokens),
                       last // self.page_tokens + 1), b.ptab.shape[1])

    def _reserved(self) -> int:
        """Pages placed requests may still claim."""
        return int(sum(np.maximum(bb.max_pages - bb.n_pages, 0)[
            bb.active].sum() for bb in self._buckets.values()))

    def check_capacity(self, prompt_len: int) -> None:
        """Raise :class:`KVPagesExhausted` when a prompt can never fit
        the pool: the synchronous check of an oversize paged admit."""
        if not self.paged:
            return
        needed = -(-prompt_len // self.page_tokens) + 1
        total = self.n_kv_pages - self._alloc.n_reserved
        if needed > total:
            raise KVPagesExhausted(needed, total, self.n_kv_pages)

    def last_ran(self, bucket: int) -> np.ndarray:
        """``[S]`` mask of the slots the last ``advance`` or
        ``advance_spec`` moved (a paged slot stalls when its next page
        cannot be allocated; its entries are stale)."""
        return self._buckets[bucket].ran.copy()

    # -- device state ------------------------------------------------------
    def _state(self, b: _Bucket):
        """A pinned bucket's ``(slots, draft slots or None)``."""
        if b.state is None:
            slots = gpt.init_slots(self.cfg, self.n_slots, b.t_max,
                                   kv_dtype=self.kv_dtype,
                                   device=self.device,
                                   model_degree=self.model_degree)
            dslots = None
            if self.draft is not None:
                dslots = gpt.init_slots(self._draft_cfg, self.n_slots,
                                        b.t_max, kv_dtype=self.kv_dtype,
                                        device=self.device,
                                        model_degree=self.model_degree)
            b.state = (slots, dslots)
        return b.state

    def _pool_state(self):
        """The paged engine's ``(pool, draft pool or None, tokens, pos)``:
        one pool (and one draft pool, indexed by the same page tables)
        for every bucket."""
        if self._pstate is None:
            C, P, S = self.page_tokens, self.n_kv_pages, self.n_slots
            pool = gpt.init_pages(self.cfg, P, C, self.kv_dtype,
                                  self.device, self.model_degree)
            dpool = (gpt.init_pages(self._draft_cfg, P, C, self.kv_dtype,
                                    self.device, self.model_degree)
                     if self.draft is not None else None)
            nb = len(self.buckets)
            self._pstate = (pool, dpool,
                            torch.zeros((nb, S), dtype=torch.int32,
                                        device=self.device),
                            torch.zeros((nb, S), dtype=torch.int32,
                                        device=self.device))
        return self._pstate

    def _sync_ptab(self, b: _Bucket) -> None:
        """Copy a changed page table to its device twin."""
        if b.ptab_dirty:
            b.ptab_d.copy_(torch.from_numpy(b.ptab))
            b.ptab_dirty = False

    def _set_run(self, b: _Bucket, run: np.ndarray) -> None:
        """The mask a paged dispatch runs, copied when it changed."""
        if not np.array_equal(run, b.run_h):
            b.run_d.copy_(torch.from_numpy(run))
            b.run_h = run.copy()

    def _drop_state(self, b: Optional[_Bucket] = None) -> None:
        """After a failed dispatch (:1009): a pinned bucket's state, or
        the whole paged state, re-initializes to zeros on next use (its
        rows may be half written), and with the pool the resident
        registry, whose pages no longer hold their prefixes."""
        if not self.paged:
            b.state = None
            return
        self._pstate = None
        self._free_residents()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _scalars(self, slot: int, start: int, n_valid: int, seed: int):
        """A prefill's ``[slot, start, n_valid, seed]`` on the device."""
        return torch.tensor([slot, start, n_valid, int(seed) & gpt._M32],
                            dtype=torch.int64).to(self.device)

    def _prefill_chunk(self, params, state, toks: torch.Tensor, b: _Bucket,
                       slot: int, start: int, n_valid: int,
                       temperature: float, seed: int, draft: bool = False):
        """One prefill dispatch of the target (or, ``draft``, of the
        draft model) for one chunk; its scalars reach the device in two
        small copies."""
        scalars = self._scalars(slot, start, n_valid, seed)
        if draft:
            if self.paged:
                return self._draft_prefill(params, state, b.ptab_d, toks,
                                           scalars, self._draft_params(),
                                           b.bi), None
            return self._draft_prefill(params, state, toks, scalars,
                                       self._draft_params()), None
        temp = torch.tensor(float(temperature),
                            dtype=torch.float32).to(self.device)
        if self.paged:
            return self._prefill(params, state, b.ptab_d, toks, scalars,
                                 temp, b.bi)
        return self._prefill(params, state, toks, scalars, temp)

    # -- paged pages -------------------------------------------------------
    def _live_rows(self) -> int:
        return int(sum(int(bb.pos_h[bb.active].sum())
                       for bb in self._buckets.values()))

    def _ensure_pages(self, b: _Bucket, span: int) -> np.ndarray:
        """Grow each active slot's page table to cover writes through
        ``pos + span`` (:968).  A slot whose pages cannot be allocated
        stalls (out of this dispatch, retried next); when no active slot
        can run, :class:`KVPagesExhausted` names a victim, the slot
        holding the most pages.  Returns the runnable mask."""
        run = b.active.copy()
        C = self.page_tokens
        for s in np.flatnonzero(b.active):
            need = min(int(b.pos_h[s] + span) // C + 1, b.ptab.shape[1])
            short = need - int(b.n_pages[s])
            if short <= 0:
                continue
            try:
                ids = self._alloc.alloc(short)
            except KVPagesExhausted:
                run[s] = False
                continue
            b.ptab[s, int(b.n_pages[s]):need] = ids
            b.n_pages[s] = need
            b.ptab_dirty = True
        if b.active.any() and not run.any():
            victim = int(max(np.flatnonzero(b.active),
                             key=lambda s: int(b.n_pages[s])))
            raise KVPagesExhausted(1, self._alloc.n_free(),
                                   self.n_kv_pages, bucket=b.t_max,
                                   slot=victim)
        return run

    def _release_pages(self, b: _Bucket, slot: int) -> None:
        n = int(b.n_pages[slot])
        if n:
            self._alloc.free(int(p) for p in b.ptab[slot, :n])
        b.ptab[slot, :] = 0
        b.n_pages[slot] = 0
        b.max_pages[slot] = 0
        b.ptab_dirty = True
        decode_metrics.note_pages(self._alloc.in_use(), 0, 0)
        decode_metrics.note_pages_leaked(self.pages_unaccounted())

    def pages_unaccounted(self) -> int:
        """Allocator references no live slot's page table and no
        resident prefix explains (:1023): nonzero means a reclaim path
        leaked (the ``pages_leaked`` gauge)."""
        if not self.paged:
            return 0
        accounted = sum(int(bb.n_pages.sum())
                        for bb in self._buckets.values())
        accounted += sum(len(ids) for _, ids in self._resident.values())
        return self._alloc.total_refs() - accounted

    # -- pool-resident prefixes ----------------------------------------------
    def _resident_lookup(self, prompt: np.ndarray):
        """The longest pool-resident chunk-aligned strict prefix of
        ``prompt`` (:1036): ``(length, page ids)``, mounted by reference
        (no copy, no dispatch).  Writes never reach those pages: the
        slot's own rows start at the next page boundary, and its release
        only drops its references."""
        C = self.page_tokens
        n = (prompt.size - 1) // C
        if n < 1 or not self._resident:
            return 0, None
        digs = PrefixCache._boundary_digests(prompt, C, n,
                                             self._prefix_space)
        for k in range(n, 0, -1):
            ent = self._resident.get(digs[k - 1])
            if ent is not None and np.array_equal(ent[0], prompt[:k * C]):
                self._resident.move_to_end(digs[k - 1])
                return k * C, ent[1]
        return 0, None

    def _resident_register(self, prompt: np.ndarray, b: _Bucket,
                           slot: int) -> None:
        """Register the slot's prefix pages as resident at every chunk
        boundary (:1057), the registry holding a reference of its own on
        each page; LRU bounded at half the pool."""
        C = self.page_tokens
        m = C * ((prompt.size - 1) // C)
        if m < C:
            return
        digs = PrefixCache._boundary_digests(prompt, C, m // C,
                                             self._prefix_space)
        for k in range(1, m // C + 1):
            ids = tuple(int(p) for p in b.ptab[slot, :k])
            old = self._resident.pop(digs[k - 1], None)
            if old is not None:
                self._alloc.free(old[1])
            self._alloc.share(ids)
            self._resident[digs[k - 1]] = (prompt[:k * C].copy(), ids)
        while (sum(len(v[1]) for v in self._resident.values())
               > self._resident_max and self._resident):
            _, (_, ids) = self._resident.popitem(last=False)
            self._alloc.free(ids)

    def _free_residents(self) -> None:
        while self._resident:
            _, (_, ids) = self._resident.popitem(last=False)
            self._alloc.free(ids)

    def drop_residents(self) -> None:
        """Evict every resident prefix, releasing the registry's page
        references (:1083); pages live slots share survive until those
        release.  After a drain plus this, ``_alloc.in_use()`` is 0.
        Call from the driver thread, or while the engine is idle."""
        if self.paged:
            self._free_residents()
            decode_metrics.note_pages_leaked(self.pages_unaccounted())

    # -- prefix harvesting -------------------------------------------------
    def _harvest(self, bufs, prefix: np.ndarray, paged: bool) -> None:
        """Queue ``bufs`` (fresh device copies of the prefix rows, made
        in stream order after the prefill that wrote them) for the
        harvester, with an event it waits on."""
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._harvester.put(bufs, event, prefix, self.prefill_chunk,
                            self._prefix_space, paged)
        if self.mesh is not None:
            # every rank of the serving group must find the same entries
            # at its next lookup, so a mesh engine's store is not
            # eventually consistent
            self._harvester.flush()

    def flush_harvests(self) -> None:
        """Block until every queued harvest is stored: read-your-writes
        on the store, for callers and tests (serving itself is eventually
        consistent)."""
        if self._harvester is not None:
            self._harvester.flush()

    def close(self) -> None:
        """Stop the harvest worker (queued harvests complete first).  The
        engine keeps serving; a later harvest respawns the worker."""
        if self._harvester is not None:
            self._harvester.close()

    def _upload(self, pages: Sequence[np.ndarray], like: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
        """Stored host rows onto the device in the dtypes of ``like``.
        On the card every copy is non-blocking.  Page-locked rows (a
        store entry's) are copied straight from the entry, one copy a
        leaf or, for a shorter prefix's strided slice, one a layer;
        other rows (pageable arrays handed to the store) go through
        reused pinned staging buffers first.  The staging buffers, and
        the rows copied from, are let go only after the previous
        upload's event."""
        rows = [_torch_rows(a, t.dtype) for a, t in zip(pages, like)]
        if self.device.type != "cuda":
            return [r.contiguous() for r in rows]
        if self._stage_event is not None:
            self._stage_event.synchronize()
        out = []
        for i, r in enumerate(rows):
            if not r.is_pinned():
                nbytes = r.numel() * r.element_size()
                flat = self._stage.get(i)
                if flat is None or flat.numel() < nbytes:
                    flat = self._stage[i] = torch.empty(
                        nbytes, dtype=torch.uint8, pin_memory=True)
                v = flat[:nbytes].view(r.dtype).view(r.shape)
                v.copy_(r)
                r = v
            dst = torch.empty(r.shape, dtype=r.dtype, device=self.device)
            if r.is_contiguous():
                dst.copy_(r, non_blocking=True)
            else:                       # each layer's rows are contiguous
                for layer in range(r.shape[0]):
                    dst[layer].copy_(r[layer], non_blocking=True)
            out.append(dst)
        self._uploading = pages
        self._stage_event = torch.cuda.Event()
        self._stage_event.record()
        return out

    # -- warmup ------------------------------------------------------------
    @_on_engine_stream(wait=True)
    def warmup(self) -> dict:
        """Run every entry once in every bucket (on the card: capture
        each graph) on an all-inactive state, then zero the state so
        serving starts from zeros.  A paged warm-up runs with zero page
        tables: every write lands in the trash page, and the allocator
        is untouched.  Returns ``{"buckets": n, "compiles": this engine's
        new captures, "warmup_ms": wall}`` (its own entries' count, so
        another engine warming up in another thread does not add to
        it)."""
        if self.n_active():
            raise RuntimeError("warmup on a busy engine: drain first")
        params = self.current_params()
        t0 = time.perf_counter()
        c0 = self._captures()
        if self.paged:
            self._free_residents()          # their pages are zeroed below
        with torch.inference_mode(), \
                telemetry.span("decode.warmup", buckets=len(self.buckets)):
            toks = torch.zeros(self.prefill_chunk, dtype=torch.int32,
                               device=self.device)
            states = []
            for t in self.buckets:
                b = self._buckets[t]
                state = self._pool_state() if self.paged else self._state(b)
                state, _ = self._prefill_chunk(params, state, toks, b, 0, 0,
                                               1, 0.0, 0)
                if self.draft is not None:
                    state, _ = self._prefill_chunk(params, state, toks, b,
                                                   0, 0, 1, 0.0, 0,
                                                   draft=True)
                    state, _ = self._spec_dispatch(params, state, b)
                state, _ = self._step_dispatch(params, state, b)
                self._keep(b, state)
                states.append(state)
            for state in states:
                for buf in _leaves(state):
                    buf.zero_()
            self._sync()
        decode_metrics.mark_compiles()
        return {"buckets": len(self.buckets),
                "compiles": self._captures() - c0,
                "warmup_ms": (time.perf_counter() - t0) * 1e3}

    def _captures(self) -> int:
        """Signatures this engine's entries hold (captures on the card,
        first calls on the CPU)."""
        return sum(e.signatures() for e in (self._prefill, self._decode,
                                            self._draft_prefill, self._spec)
                   if e is not None)

    def _keep(self, b: _Bucket, state) -> None:
        if self.paged:
            self._pstate = state
        else:
            b.state = state

    def _step_dispatch(self, params, state, b: _Bucket):
        if self.paged:
            self._sync_ptab(b)
            return self._decode(params, state, b.ptab_d, b.run_d, b.temps_d,
                                b.seeds_d, b.bi)
        return self._decode(params, state, b.active_d, b.temps_d, b.seeds_d)

    def _spec_dispatch(self, params, state, b: _Bucket):
        if self.paged:
            self._sync_ptab(b)
            return self._spec(params, state, b.ptab_d, b.run_d, b.temps_d,
                              b.seeds_d, self._draft_params(), b.bi)
        return self._spec(params, state, b.active_d, b.temps_d, b.seeds_d,
                          self._draft_params())

    # -- serving -----------------------------------------------------------
    @_on_engine_stream()
    def start(self, prompt: np.ndarray, *, max_tokens: int,
              temperature: float = 0.0, seed: int = 0,
              owner: Any = True) -> Tuple[int, int, int]:
        """Prefill ``prompt`` ``[T_p]`` into a free slot of the bucket
        that fits ``T_p + max_tokens`` and activate it: the mid-flight
        JOIN (:1327).  Returns ``(bucket, slot, first_token)``.  Raises
        RuntimeError when the bucket has no free slot (callers gate on
        ``can_admit``)."""
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
            if self.paged:
                first_tok = self._start_paged(prompt, b, bucket, slot,
                                              temperature, seed, max_tokens)
            else:
                first_tok = self._start_pinned(prompt, b, bucket, slot,
                                               temperature, seed)
            b.active_d[slot] = True
            b.temps_d[slot] = float(temperature)
            b.seeds_d[slot] = int(seed) & gpt._M32
        b.tokens_h[slot] = first_tok
        b.pos_h[slot] = prompt.size
        b.active[slot] = True
        b.owners[slot] = owner
        return bucket, slot, first_tok

    def _chunks(self, prompt: np.ndarray) -> Tuple[torch.Tensor, int]:
        C = self.prefill_chunk
        n_chunks = -(-prompt.size // C)
        padded = np.zeros((n_chunks * C,), np.int32)
        padded[:prompt.size] = prompt
        return torch.from_numpy(padded).to(self.device), n_chunks

    def _note_prefix(self, hit_len: int, bucket: int, slot: int,
                     **kw) -> None:
        if hit_len:
            decode_metrics.note_prefix_hit(hit_len)
            telemetry.event("decode.prefix_hit", bucket=bucket, slot=slot,
                            tokens_saved=hit_len, **kw)
        else:
            decode_metrics.note_prefix_miss()

    def _start_pinned(self, prompt: np.ndarray, b: _Bucket, bucket: int,
                      slot: int, temperature: float, seed: int) -> int:
        params = self.current_params()
        state = self._state(b)
        C = self.prefill_chunk
        toks, n_chunks = self._chunks(prompt)
        hit_len, pages = 0, None
        if self._prefix is not None:
            hit = self._prefix.lookup(prompt, C, self._prefix_space)
            if hit is not None:
                hit_len, pages = hit
        with telemetry.span("decode.prefill", bucket=bucket, slot=slot,
                            prompt_tokens=int(prompt.size),
                            chunks=n_chunks, prefix_hit_tokens=hit_len):
            try:
                if hit_len:
                    # the stored rows over the slot's first hit_len rows,
                    # then chunked prefill from the first uncached chunk:
                    # bit-exact against running those chunks
                    slots = state[0]
                    gpt.slot_write_pages(slots, slot, *self._upload(
                        pages, _kv_leaves(slots)))
                for c in range(hit_len // C, n_chunks):
                    lo = c * C
                    state, first = self._prefill_chunk(
                        params, state, toks[lo:lo + C], b, slot, lo,
                        min(C, prompt.size - lo), temperature, seed)
                if self.draft is not None:
                    # the draft prefills the whole prompt: the store holds
                    # no draft rows
                    for c in range(n_chunks):
                        lo = c * C
                        state, _ = self._prefill_chunk(
                            params, state, toks[lo:lo + C], b, slot, lo,
                            min(C, prompt.size - lo), 0.0, 0, draft=True)
            except Exception:
                self._drop_state(b)
                raise
            b.state = state
            first_tok = int(first)              # join-time sync, once
        decode_metrics.note_prefill(n_chunks - hit_len // C)
        if self._prefix is not None:
            self._note_prefix(hit_len, bucket, slot)
            m_store = C * ((prompt.size - 1) // C)
            if m_store > hit_len and m_store >= C and self.harvest_enabled:
                # harvest this prompt's chunk-aligned prefix, partial hits
                # included (a growing conversation then hits at full
                # depth next turn)
                self._harvest(gpt.slot_read_pages(state[0], slot, m_store),
                              prompt[:m_store].copy(), paged=False)
        return first_tok

    def _start_paged(self, prompt: np.ndarray, b: _Bucket, bucket: int,
                     slot: int, temperature: float, seed: int,
                     max_tokens: int) -> int:
        self.check_capacity(prompt.size)
        params = self.current_params()
        state = self._pool_state()
        C = self.page_tokens
        toks, n_chunks = self._chunks(prompt)
        # prefix reuse, best first: pool-resident pages mount into the
        # page table by reference; else the host store's pages are
        # copied into fresh pool pages
        hit_len, hit_ids = self._resident_lookup(prompt)
        resident = hit_len > 0
        host_pages = None
        if not resident and self._prefix is not None:
            hit = self._prefix.lookup(prompt, C, self._prefix_space)
            if hit is not None:
                hit_len, host_pages = hit
        h = hit_len // C
        with telemetry.span("decode.prefill", bucket=bucket, slot=slot,
                            prompt_tokens=int(prompt.size),
                            chunks=n_chunks, prefix_hit_tokens=hit_len):
            if resident:
                self._alloc.share(hit_ids)
                b.ptab[slot, :h] = hit_ids
            n_fresh = n_chunks - h if resident else n_chunks
            try:
                fresh = self._alloc.alloc(n_fresh)
            except KVPagesExhausted:
                if resident:
                    self._alloc.free(hit_ids)
                    b.ptab[slot, :h] = 0
                raise
            b.ptab[slot, n_chunks - n_fresh:n_chunks] = fresh
            b.n_pages[slot] = n_chunks
            b.max_pages[slot] = self._most_pages(b, prompt.size,
                                                 max_tokens)
            b.ptab_dirty = True
            self._sync_ptab(b)
            try:
                if host_pages is not None:
                    pool = state[0]
                    L = host_pages[0].shape[0]
                    paged_rows = [
                        p.reshape((L, h, C) + p.shape[2:])
                        for p in host_pages]
                    gpt.paged_write_pages(
                        pool, torch.from_numpy(b.ptab[slot, :h].copy()),
                        *self._upload(paged_rows, _kv_leaves(pool)))
                for c in range(h, n_chunks):
                    lo = c * C
                    state, first = self._prefill_chunk(
                        params, state, toks[lo:lo + C], b, slot, lo,
                        min(C, prompt.size - lo), temperature, seed)
                if self.draft is not None:
                    # every chunk: a host hit carries no draft rows, and a
                    # resident page's draft rows are rewritten with the
                    # values they hold
                    for c in range(n_chunks):
                        lo = c * C
                        state, _ = self._prefill_chunk(
                            params, state, toks[lo:lo + C], b, slot, lo,
                            min(C, prompt.size - lo), 0.0, 0, draft=True)
            except Exception:
                # this slot's references go back first: the failure lost
                # the KV bytes, not the allocator's bookkeeping
                self._release_pages(b, slot)
                self._drop_state()
                raise
            self._pstate = state
            first_tok = int(first)              # join-time sync, once
        decode_metrics.note_prefill(n_chunks - h)
        self._note_prefix(hit_len, bucket, slot, resident=resident)
        m_store = C * ((prompt.size - 1) // C)
        if m_store > hit_len and m_store >= C and self.harvest_enabled:
            self._resident_register(prompt, b, slot)
            if self._prefix is not None:
                self._harvest(gpt.paged_read_pages(
                    state[0], torch.from_numpy(
                        b.ptab[slot, :m_store // C].copy())),
                    prompt[:m_store].copy(), paged=True)
        decode_metrics.note_pages(self._alloc.in_use(), 0, 0)
        return first_tok

    @_on_engine_stream()
    def advance(self, bucket: int) -> np.ndarray:
        """One decode dispatch for ``bucket``: every active (and, paged,
        runnable) slot emits its next token (:1567).  Returns the ``[S]``
        tokens (entries of other slots are stale; callers go by
        ``last_ran`` and their ownership map)."""
        b = self._buckets[bucket]
        params = self.current_params()
        if self.paged:
            run = self._ensure_pages(b, 0)
            self._set_run(b, run)
        else:
            run = b.active.copy()
        b.ran = run
        with torch.inference_mode(), \
                telemetry.span("decode.dispatch", bucket=bucket,
                               active=int(run.sum())):
            state = self._pool_state() if self.paged else self._state(b)
            try:
                state, out = self._step_dispatch(params, state, b)
            except Exception:
                self._drop_state(b)
                raise
            self._keep(b, state)
            # the per-step stream sync: the [S] tokens must reach the
            # host to stream, the one fetch a step
            toks = out.cpu().numpy()
        b.tokens_h[run] = toks[run]
        b.pos_h[run] += 1
        decode_metrics.note_decode_dispatch(int(run.sum()), self.n_slots)
        if self.paged:
            decode_metrics.note_pages(self._alloc.in_use(),
                                      self._live_rows(), self.page_tokens)
        return toks

    @_on_engine_stream()
    def advance_spec(self, bucket: int) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative round for ``bucket`` (:1622): the draft's
        ``draft_k`` greedy steps and the target's verify of the k + 1
        positions, one replay; the proposals never leave the device and
        the host reads ``(out, n_commit)`` once.  Returns ``(out [S, k +
        1], n_commit [S])``: slot s committed ``out[s, :n_commit[s]]``
        (0 for inactive or stalled slots).  Token-identical to plain
        decoding at any temperature: the sampling keys fold the
        position, not the step."""
        if self._spec is None:
            raise RuntimeError("engine built without draft=")
        b = self._buckets[bucket]
        params = self.current_params()
        k = self.draft_k
        if self.paged:
            run = self._ensure_pages(b, k)
            self._set_run(b, run)
        else:
            run = b.active.copy()
        b.ran = run
        with torch.inference_mode(), \
                telemetry.span("decode.spec_round", bucket=bucket,
                               active=int(run.sum()), k=k):
            state = self._pool_state() if self.paged else self._state(b)
            try:
                state, packed = self._spec_dispatch(params, state, b)
            except Exception:
                self._drop_state(b)
                raise
            self._keep(b, state)
            packed = packed.cpu().numpy()       # the round's one fetch
        toks, n_c = packed[:, :k + 1], packed[:, k + 1].astype(np.int64)
        idx = np.flatnonzero(n_c)
        b.tokens_h[idx] = toks[idx, n_c[idx] - 1]
        b.pos_h += n_c.astype(np.int32)
        n_run = int(run.sum())
        decode_metrics.note_decode_dispatch(n_run, self.n_slots)
        decode_metrics.note_spec(k * n_run, int(np.maximum(n_c - 1, 0).sum()))
        if self.paged:
            decode_metrics.note_pages(self._alloc.in_use(),
                                      self._live_rows(), self.page_tokens)
        return toks, n_c

    @_on_engine_stream()
    def release(self, bucket: int, slot: int) -> None:
        """Free a finished slot (:1701).  Its cache rows need no
        scrubbing: the next occupant prefills over them, and decode never
        attends past its own position.  A paged slot returns its page
        references (resident prefix pages survive: the registry holds
        its own)."""
        b = self._buckets[bucket]
        b.active[slot] = False
        b.owners[slot] = None
        b.tokens_h[slot] = 0
        b.pos_h[slot] = 0
        with torch.inference_mode():
            b.active_d[slot] = False
        if self.paged:
            self._release_pages(b, slot)


class DecodeRequest:
    """Handle of one in-flight decode request (:1714): tokens stream into
    a buffer as the engine emits them; ``result()`` blocks for the whole
    continuation, ``stream()`` yields tokens as they land.
    ``deadline_ms`` bounds the whole request, queue wait included: past
    it the batcher frees the slot and the handle resolves with
    :class:`DeadlineExceeded`.

    The handle is also the replay journal: prompt, seed, temperature and
    the tokens emitted so far are all a replica needs to continue the
    request bit for bit (the sampling keys fold seed and position)."""

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
        # a detached (evacuated) request drops its old worker's pushes;
        # the replay budget stops a deterministic failure requeueing
        # forever
        self._migrated = False
        self._replays = 0

    # -- producer side (batcher worker) ------------------------------------
    def _push(self, tok: int) -> None:
        with self._cond:
            if self._migrated:
                return
            self._append(tok)

    def _append(self, tok: int) -> None:
        if self.ttft_ms is None:
            self.ttft_ms = (time.perf_counter() - self._t_submit) * 1e3
            decode_metrics.note_ttft_ms(self.ttft_ms)
        self._tokens.append(int(tok))
        self._cond.notify_all()

    def _finish(self, error: Optional[BaseException] = None) -> None:
        with self._cond:
            if self._migrated:
                return
            self._error = error
            self._done = True
            self._cond.notify_all()

    # -- the replay journal --------------------------------------------------
    def _snapshot_tokens(self) -> np.ndarray:
        with self._cond:
            return np.asarray(self._tokens, np.int32)

    def _detach(self) -> None:
        """Cut the old worker off: later pushes and finishes through this
        handle are dropped; only the adopting replica's
        :class:`_ReplayRequest` forwards into it."""
        with self._cond:
            self._migrated = True

    def _force_push(self, tok: int) -> None:
        with self._cond:
            if not self._done:
                self._append(tok)

    def _force_finish(self, error: Optional[BaseException] = None) -> None:
        with self._cond:
            if self._done:
                return
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


class _ReplayRequest(DecodeRequest):
    """An evacuated request re-submitted on another replica (:1869): it
    carries the original's journal (prompt, sampling identity, tokens
    streamed), so the adopting batcher prefills prompt + emitted and
    continues from the next position with the same keys; every token
    and the finish forward into the original handle, the one the client
    holds."""

    def __init__(self, orig: DecodeRequest):
        super().__init__(orig.prompt, orig.max_tokens, orig.temperature,
                         orig.seed, orig.eos_id)
        self._orig = orig
        # the absolute deadline: migration does not extend a budget
        self.deadline_ms = orig.deadline_ms
        self._deadline = orig._deadline
        self._t_submit = orig._t_submit
        self.ttft_ms = orig.ttft_ms
        self._tokens = [int(t) for t in orig._snapshot_tokens()]
        self._replays = orig._replays + 1

    def _push(self, tok: int) -> None:
        super()._push(tok)
        self._orig._force_push(tok)

    def _finish(self, error: Optional[BaseException] = None) -> None:
        super()._finish(error)
        self._orig._force_finish(error)


# ---------------------------------------------------------------------------
# the schedule of a serving group
# ---------------------------------------------------------------------------

#: the ops of a group's schedule
_OP_NOP, _OP_STOP, _OP_CAN_ADMIT, _OP_START, _OP_ADVANCE, _OP_SPEC, \
    _OP_RELEASE = range(7)

#: int64 words of a schedule header: op, four arguments, the
#: temperature's bits, the harvest knob, the prompt's length
_HEADER = 8


class GroupDispatchFailed(RuntimeError):
    """A dispatch of a model-sharded engine failed on another rank of
    its group: every rank treats it as failed (the slots it touched are
    dropped and their requests replayed, as for a local failure)."""


class GroupBroken(GroupDispatchFailed):
    """A dispatch failed partway on some rank of a model group: its ranks
    started different numbers of the group's collectives (a rank failed
    before one that the others then waited on until the mesh's timeout),
    so the group's communicator is out of step.  Every rank's worker
    stops; the leader resolves every unfinished request with this
    error."""


def _bits(x: float) -> int:
    return int(np.array(x, np.float64).view(np.int64))


def _unbits(w: int) -> float:
    return float(np.array(w, np.int64).view(np.float64))


class _Channel:
    """The schedule channel of a group, on a process group of its own
    (no other code runs collectives on it): ``src`` (a global rank)
    sends each op's header (and a start's prompt) to every member by
    broadcast; every member takes part in each op's failure agreement;
    for a remote replica ``result_src`` (the group's model rank 0)
    broadcasts the op's result back.  Tensors live on the CPU under
    gloo, on the card under NCCL.  Every wait on the channel is bounded
    by ``timeout_s`` (then it raises): an idle source sends no-ops
    (``ContinuousBatcher.GROUP_BEAT_S`` apart), so a member waits that
    long only when the source is gone.  The agreement waits
    ``op_timeout_s`` longer, the bound of the engine's own collectives
    (its mesh's ``timeout_s``): a member that failed before one of them
    waits there while the others wait that long inside it."""

    def __init__(self, group, src: int, result_src: Optional[int],
                 device: torch.device, timeout_s: float,
                 op_timeout_s: float = 0.0):
        import torch.distributed as dist
        self.dist = dist
        self.group = group
        self.src = int(src)
        self.result_src = result_src
        self.device = (device if dist.get_backend(group) == "nccl"
                       else torch.device("cpu"))
        self.timeout_s = float(timeout_s)
        self.op_timeout_s = float(op_timeout_s)
        self.me = dist.get_rank()

    @property
    def leads(self) -> bool:
        return self.me == self.src

    def _wait(self, work, extra_s: float = 0.0) -> None:
        import datetime
        work.wait(timeout=datetime.timedelta(seconds=self.timeout_s
                                             + extra_s))

    def send(self, op: int, *args: int, temperature: float = 0.0,
             harvest: bool = True, prompt: Optional[np.ndarray] = None
             ) -> None:
        hdr = [op] + [int(a) for a in args] + [0] * (4 - len(args))
        n = 0 if prompt is None else int(prompt.size)
        hdr += [_bits(temperature), int(harvest), n]
        t = torch.tensor(hdr, dtype=torch.int64, device=self.device)
        self._wait(self.dist.broadcast(t, self.src, group=self.group,
                                       async_op=True))
        if n:
            p = torch.from_numpy(prompt.astype(np.int64)).to(self.device)
            self._wait(self.dist.broadcast(p, self.src, group=self.group,
                                           async_op=True))

    def recv(self):
        """``(op, args [4], temperature, harvest, prompt or None)``."""
        t = torch.zeros(_HEADER, dtype=torch.int64, device=self.device)
        self._wait(self.dist.broadcast(t, self.src, group=self.group,
                                       async_op=True))
        hdr = t.tolist()
        prompt = None
        if hdr[7]:
            p = torch.zeros(hdr[7], dtype=torch.int64, device=self.device)
            self._wait(self.dist.broadcast(p, self.src, group=self.group,
                                           async_op=True))
            prompt = p.cpu().numpy().astype(np.int32)
        return hdr[0], hdr[1:5], _unbits(hdr[5]), bool(hdr[6]), prompt

    def agree(self, failed: bool, issued: Optional[int]) -> Tuple[bool, bool]:
        """``(failed, in_step)``: whether the op failed on any member,
        and whether every member that ran it started as many collectives
        of the engine's model group (``issued``; None for a source that
        ran nothing)."""
        lo = -(1 << 62)
        t = torch.tensor([int(failed), 0 if issued is None else issued,
                          lo if issued is None else -issued],
                         dtype=torch.int64, device=self.device)
        self._wait(self.dist.all_reduce(t, op=self.dist.ReduceOp.MAX,
                                        group=self.group, async_op=True),
                   self.op_timeout_s)
        failed, most, least = t.tolist()
        return bool(failed), most == -least

    def result(self, values: Optional[np.ndarray], n: int) -> np.ndarray:
        """A remote replica's op result, ``n`` int64 words, sent by
        ``result_src`` (``values``) and returned on every member."""
        t = (torch.from_numpy(np.asarray(values, np.int64).reshape(-1))
             .to(self.device) if self.me == self.result_src
             else torch.zeros(n, dtype=torch.int64, device=self.device))
        self._wait(self.dist.broadcast(t, self.result_src, group=self.group,
                                       async_op=True))
        return t.cpu().numpy()


def _undo(engine: "DecodeEngine", bucket: int,
          slot: Optional[int] = None) -> None:
    """After a dispatch that failed on some rank of the group, every
    rank leaves the engine as the failing one did: the slot the op
    placed (a start) released, the bucket's (a pinned) or the pool's (a
    paged) state dropped."""
    b = engine._buckets[bucket]
    if slot is not None and b.active[slot]:
        engine.release(bucket, slot)
    engine._drop_state(b)


def _engine_group(engine):
    """The model group a model-sharded engine's dispatches run their
    collectives on (None: a remote replica's view, or no mesh)."""
    mesh = getattr(engine, "mesh", None)
    if mesh is None or getattr(engine, "model_degree", 1) <= 1:
        return None
    return mesh.groups["model"]


def _agreed(chan: _Channel, engine, fn, bucket: int,
            slot: Optional[int] = None):
    """``fn()`` (an engine op with dispatches), failed on every rank
    when it failed on any: the rank's own error, or
    :class:`GroupDispatchFailed`; :class:`GroupBroken` when the ranks
    started different numbers of the model group's collectives (a
    failure partway, after which the group cannot run another)."""
    group = _engine_group(engine)
    before = collectives.issued(group) if group is not None else 0
    out, err = None, None
    try:
        out = fn()
    except Exception as e:          # noqa: BLE001 — agreed, then raised
        err = e
    # a rank whose model group is itself ran none (a pipe or seq peer); a
    # source that ran nothing (a remote replica's view) counts as None
    issued = (None if engine is None
              else collectives.issued(group) - before if group is not None
              else 0)
    failed, in_step = chan.agree(err is not None, issued)
    if not failed:
        return out
    if not in_step:
        raise GroupBroken(
            f"a dispatch of bucket {bucket} failed partway on a rank of the "
            f"model group (its ranks started different numbers of the "
            f"group's collectives): the group is out of step and stops"
        ) from err
    if engine is not None:
        _undo(engine, bucket, slot)
    raise err or GroupDispatchFailed(
        f"a dispatch of bucket {bucket} failed on another rank of the "
        f"model group")


class _GroupOps:
    """The engine's ops as the group's leader makes them: each is sent
    to the group first, then made here (on the local engine, or, for a
    remote replica, by the group, whose result comes back); ops with
    dispatches are agreed (:func:`_agreed`).  The batcher reads the
    engine's host state (buckets, active slots) from the engine itself:
    the group's ranks hold it alike."""

    def __init__(self, engine, chan: _Channel):
        self.engine = engine
        self.chan = chan

    def heartbeat(self) -> None:
        self.chan.send(_OP_NOP)

    def stop(self) -> None:
        self.chan.send(_OP_STOP)

    def _op(self, fn, bucket: int, slot: Optional[int] = None):
        """An op with dispatches, agreed over the group; a remote
        replica's result is received after the agreement."""
        if isinstance(self.engine, _RemoteEngine):
            _agreed(self.chan, None, lambda: None, bucket)
            return fn()
        return _agreed(self.chan, self.engine, fn, bucket, slot)

    def can_admit(self, bucket: int, prompt_len: int,
                  max_tokens: int) -> bool:
        self.chan.send(_OP_CAN_ADMIT, bucket, prompt_len, max_tokens)
        return self.engine.can_admit(bucket, prompt_len, max_tokens)

    def start(self, prompt: np.ndarray, *, max_tokens: int,
              temperature: float = 0.0, seed: int = 0, owner: Any = True):
        eng = self.engine
        self.chan.send(_OP_START, max_tokens, int(seed) & gpt._M32,
                       temperature=temperature,
                       harvest=eng.harvest_enabled, prompt=prompt)
        bucket = eng.pick_bucket(prompt.size + max_tokens)
        return self._op(lambda: eng.start(
            prompt, max_tokens=max_tokens, temperature=temperature,
            seed=seed, owner=owner), bucket, eng.free_slot(bucket))

    def advance(self, bucket: int) -> np.ndarray:
        self.chan.send(_OP_ADVANCE, bucket)
        return self._op(lambda: self.engine.advance(bucket), bucket)

    def advance_spec(self, bucket: int):
        self.chan.send(_OP_SPEC, bucket)
        return self._op(lambda: self.engine.advance_spec(bucket), bucket)

    def release(self, bucket: int, slot: int) -> None:
        self.chan.send(_OP_RELEASE, bucket, slot)
        self.engine.release(bucket, slot)


def _follow(engine: "DecodeEngine", chan: _Channel) -> None:
    """A follower's loop: make every op of the source's schedule on this
    rank's engine, in its order, until the stop; the group's model rank
    0 of a remote replica (which serves no draft) sends each result back
    to the source."""
    remote = chan.result_src is not None
    sends = remote and chan.me == chan.result_src
    try:
        _follow_ops(engine, chan, remote, sends)
    except GroupBroken:
        pass                        # every rank of the group stops
    finally:
        engine.close()


def _follow_ops(engine, chan: _Channel, remote: bool, sends: bool) -> None:
    with torch.inference_mode():
        while True:
            op, a, temperature, harvest, prompt = chan.recv()
            if op == _OP_STOP:
                return
            if op == _OP_NOP:
                continue
            if op == _OP_RELEASE:
                engine.release(a[0], a[1])
                continue
            if op == _OP_CAN_ADMIT:
                res = [int(engine.can_admit(a[0], a[1], a[2]))]
            elif op == _OP_START:
                engine.harvest_enabled = harvest
                bucket = engine.pick_bucket(prompt.size + a[0])
                try:
                    res = _agreed(chan, engine, lambda: engine.start(
                        prompt, max_tokens=a[0], temperature=temperature,
                        seed=a[1]), bucket, engine.free_slot(bucket))
                except GroupBroken:
                    raise
                except Exception:   # noqa: BLE001 — the source replays
                    continue
            else:
                bucket = a[0]
                step = (engine.advance_spec if op == _OP_SPEC
                        else engine.advance)
                try:
                    out = _agreed(chan, engine, lambda: step(bucket), bucket)
                except GroupBroken:
                    raise
                except Exception:   # noqa: BLE001 — the source replays
                    continue
                res = (np.concatenate([out, engine.last_ran(bucket)])
                       if op == _OP_ADVANCE else None)
            if remote:
                res = np.asarray(res, np.int64)
                chan.result(res if sends else None, res.size)


def _group_ranks(engine) -> Optional[List[int]]:
    """The global ranks that serve with this rank: the mesh's ranks at
    its data coordinate (its model, pipe, seq and expert lines; the
    grid is data-major), or None where that is this rank alone."""
    mesh = getattr(engine, "mesh", None)
    if mesh is None:
        return None
    import torch.distributed as dist
    ranks = tuple(mesh.ranks)
    k = len(ranks) // int(mesh.shape.get(DATA_AXIS, 1))
    if k <= 1:
        return None
    start = ranks.index(dist.get_rank()) // k * k
    return sorted(ranks[start:start + k])


def _group_channel(engine, ranks: List[int], timeout_s: float) -> _Channel:
    """The schedule channel of a mesh engine's serving group
    (:func:`_group_ranks`), on a process group of its own over those
    ranks (made by them alone): the lowest, the group's model rank 0 at
    pipe and seq 0, sends."""
    import datetime

    import torch.distributed as dist
    mesh = engine.mesh
    group = dist.new_group(
        ranks, use_local_synchronization=True,
        timeout=datetime.timedelta(seconds=timeout_s + mesh.timeout_s))
    return _Channel(group, ranks[0], None, mesh.device, timeout_s,
                    mesh.timeout_s)


class _RemoteEngine:
    """The source's view of a replica whose group does not hold the
    source (``Router.replicate`` on rank 0): the host bookkeeping a
    batcher reads (buckets, the active slots, the last run mask) and
    ops sent to the group, their results received from it.  Pinned
    engines only (what ``Router.replicate`` builds)."""

    paged = False
    draft = None
    spec_enabled = False

    def __init__(self, cfg, chan: _Channel, *, n_slots: int,
                 buckets: Optional[Sequence[int]], model_degree: int):
        self.cfg = cfg
        self.chan = chan
        self.n_slots = int(n_slots)
        self.model_degree = int(model_degree)
        self.harvest_enabled = True
        self.buckets = tuple(sorted(set(
            buckets if buckets is not None
            else default_length_buckets(cfg.max_len))))
        self._active: Dict[int, np.ndarray] = {
            t: np.zeros(self.n_slots, bool) for t in self.buckets}
        self._ran: Dict[int, np.ndarray] = {
            t: np.zeros(self.n_slots, bool) for t in self.buckets}

    def pick_bucket(self, total_len: int) -> int:
        for t in self.buckets:
            if t >= total_len:
                return t
        raise ValueError(
            f"request needs {total_len} positions; largest bucket is "
            f"{self.buckets[-1]} (model max_len {self.cfg.max_len})")

    def check_capacity(self, prompt_len: int) -> None:
        return None

    def free_slot(self, bucket: int) -> Optional[int]:
        free = np.flatnonzero(~self._active[bucket])
        return int(free[0]) if free.size else None

    def n_active(self) -> int:
        return int(sum(a.sum() for a in self._active.values()))

    def active_buckets(self) -> List[int]:
        return [t for t, a in self._active.items() if a.any()]

    def last_ran(self, bucket: int) -> np.ndarray:
        return self._ran[bucket].copy()

    def can_admit(self, bucket: int, prompt_len: int,
                  max_tokens: int) -> bool:
        return bool(self.chan.result(None, 1)[0])

    def start(self, prompt, *, max_tokens, temperature=0.0, seed=0,
              owner=True):
        bucket, slot, first = (int(v) for v in self.chan.result(None, 3))
        self._active[bucket][slot] = True
        return bucket, slot, first

    def advance(self, bucket: int) -> np.ndarray:
        res = self.chan.result(None, 2 * self.n_slots)
        self._ran[bucket] = res[self.n_slots:].astype(bool)
        return res[:self.n_slots].astype(np.int32)

    def advance_spec(self, bucket: int):
        raise NotImplementedError("a remote replica serves no draft")

    def release(self, bucket: int, slot: int) -> None:
        self._active[bucket][slot] = False

    def close(self) -> None:
        return None


class ContinuousBatcher:
    """Streaming front end over a :class:`DecodeEngine` (:1902): one
    worker thread admits pending requests into free slots (prefill joins
    between decode steps), advances every occupied bucket an iteration
    (a speculative round when the engine has a draft), recycles slots on
    EOS or budget, and resolves :class:`DecodeRequest` handles.
    ``close()`` drains: accepted requests run to completion, then the
    worker exits.  A failed dispatch frees its slots (and pages) and
    replays its requests as prompt + emitted, up to ``MAX_REPLAYS``
    times each; ``evacuate()`` hands every unfinished request back for
    ``resubmit`` on another replica.

    **Over a mesh engine** (``DecodeEngine(mesh=)``, SPMD) the ranks that
    share a data coordinate serve as one group: the model group, and
    with it every rank of the ``pipe`` and ``seq`` lines, which hold the
    whole served tree.  Every rank of the group builds its batcher over
    its engine, and the group's lowest rank (model rank 0 at pipe and
    seq 0) is the leader: it takes the requests and keeps the queue,
    admission, expiry and replays.  Before each engine op
    (an admission check, a start, a step or a round, a release) it
    broadcasts a fixed-layout header over the group (op, bucket, slot,
    budget, seed, temperature, the harvest knob, and a start's prompt);
    the other ranks' workers follow, making the same engine calls in the
    same order, so every rank samples the same tokens and none travel
    back.  An op with dispatches fails on every rank when it fails on
    any (one all-reduce of a flag; the others raise
    :class:`GroupDispatchFailed` and drop the same state), so the
    replays and the replay budget stay in step.  A failure partway,
    which leaves the ranks' model-group collectives out of step, stops
    every rank's worker instead (:class:`GroupBroken`; the leader
    resolves every unfinished request with it).  The schedule travels on
    a process group of its own, and the worker holds the engine mesh's
    model group (``collectives.claim``): a collective on it from another
    thread, or a second batcher over an engine of that mesh, raises
    until ``close()``.  An idle leader sends a no-op every
    ``GROUP_BEAT_S``; a follower waits at most ``GROUP_TIMEOUT_S`` for
    its next header, and a failure agreement that long past the mesh's
    ``timeout_s``, then its worker stops with the error; a leader whose
    channel fails stops likewise, resolving its requests.  ``close()``
    on the leader drains and then stops the group; a follower's
    ``close()`` waits for that stop.  ``submit`` is the leader's."""

    #: replays of a request after failed dispatches before its error
    #: resolves it
    MAX_REPLAYS = 2
    #: seconds between an idle group leader's no-ops, and the most a
    #: follower waits for a header
    GROUP_BEAT_S = 0.05
    GROUP_TIMEOUT_S = 120.0

    def __init__(self, engine: DecodeEngine, *,
                 default_max_tokens: int = 64, _channel=None):
        self._thread = threading.Thread(target=self._run,
                                        name="dl4j-decode-batcher",
                                        daemon=True)
        #: the engine's model group, the worker's alone while it runs
        self._held = _engine_group(engine)
        if self._held is not None:
            collectives.claim(self._held, self._thread)
        chan = _channel
        ranks = _group_ranks(engine) if chan is None else None
        if ranks is not None:
            chan = _group_channel(engine, ranks, self.GROUP_TIMEOUT_S)
        self._chan = chan
        #: the engine ops of the worker: the engine itself, or the
        #: leader's schedule over the group
        self._ops = (engine if chan is None or not chan.leads
                     else _GroupOps(engine, chan))
        self.engine = engine
        self.default_max_tokens = int(default_max_tokens)
        self._cv = threading.Condition()
        self._pending: List[DecodeRequest] = []
        #: popped from ``_pending`` but not yet placed (``engine.start``
        #: runs outside the lock), so ``depth()`` never undercounts
        self._admitting: List[DecodeRequest] = []
        self._placed: Dict[Tuple[int, int], DecodeRequest] = {}
        self._open = True
        #: consecutive failed dispatches, and when the worker last
        #: admitted or advanced anything
        self.dispatch_error_streak = 0
        self._last_progress = time.perf_counter()
        self._thread.start()

    def _run(self) -> None:
        try:
            if self.leads:
                self._loop()
            else:
                _follow(self.engine, self._chan)
        finally:
            if self._held is not None:
                collectives.release(self._held, self._thread)

    @property
    def leads(self) -> bool:
        """Whether this batcher takes requests: not a follower of a
        group's schedule."""
        return self._chan is None or self._chan.leads

    # -- client side -------------------------------------------------------
    def submit(self, prompt, max_tokens: Optional[int] = None,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> DecodeRequest:
        """Enqueue one prompt ``[T_p]`` of ints; returns its handle.  A
        prompt no bucket fits, an empty prompt, a bad deadline and (paged)
        a prompt larger than the whole pool raise here, synchronously."""
        if not self.leads:
            raise RuntimeError("a follower of a serving group's schedule "
                               "takes no requests: submit on the group's "
                               "model rank 0 (its lowest rank)")
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
        self._enqueue(req)
        decode_metrics.note_request(prompt.size)
        return req

    def resubmit(self, req: DecodeRequest) -> None:
        """Adopt a journaled request (the router's replay path, :1976):
        no validation (its first submit validated it against an engine of
        the same geometry); its emitted tokens fold into its re-prefill.
        Pass ``_ReplayRequest(r)`` for a request another batcher
        evacuated."""
        self._enqueue(req)

    def _enqueue(self, req: DecodeRequest) -> None:
        with self._cv:
            if not self._open:
                raise BatcherClosed("ContinuousBatcher is closed")
            if not self._pending and not self._placed:
                self._last_progress = time.perf_counter()
            self._pending.append(req)
            decode_metrics.note_queue_depth(len(self._pending))
            self._cv.notify()

    def generate(self, prompt, timeout: Optional[float] = 120.0,
                 **kw) -> np.ndarray:
        """Blocking convenience: submit and wait for the result."""
        return self.submit(prompt, **kw).result(timeout)

    def depth(self) -> int:
        """Pending, mid-admit and in-flight requests: the router's
        dispatch and shed signal."""
        with self._cv:
            return (len(self._pending) + len(self._admitting)
                    + len(self._placed))

    def worker_alive(self) -> bool:
        return self._thread.is_alive()

    def progress_age(self) -> float:
        """Seconds since the worker last admitted or advanced anything."""
        return time.perf_counter() - self._last_progress

    def evacuate(self) -> List[DecodeRequest]:
        """Stop intake and hand back every unfinished request, queued and
        mid-decode, detached from this worker, for ``resubmit`` (wrapped
        in ``_ReplayRequest``) on another replica (:2018).  The engine's
        state is left as it is: this replica is being retired, and its
        worker is its only driver."""
        with self._cv:
            self._open = False
            reqs = (list(self._pending) + list(self._admitting)
                    + list(self._placed.values()))
            self._pending.clear()
            self._admitting.clear()
            self._placed.clear()
            self._cv.notify_all()
        out = []
        for r in reqs:
            if not r.done():
                r._detach()
                out.append(r)
        return out

    # -- worker side -------------------------------------------------------
    def _admit(self) -> int:
        """Place as many pending requests as free slots (and pages)
        allow; returns how many were placed.  A replayed request
        re-prefills prompt + emitted, in the same bucket (emitted tokens
        move from the budget to the prompt one for one)."""
        admitted = 0
        while True:
            with self._cv:
                req = None
                for i, r in enumerate(self._pending):
                    bucket = self.engine.pick_bucket(
                        r.prompt.size + r.max_tokens)
                    if self._ops.can_admit(
                            bucket, r.prompt.size + len(r._tokens),
                            r.max_tokens - len(r._tokens)):
                        req = self._pending.pop(i)
                        self._admitting.append(req)
                        break
                if req is None:
                    decode_metrics.note_queue_depth(len(self._pending))
                    return admitted
            joined = self.engine.n_active() > 0
            emitted = req._snapshot_tokens()
            prompt = (np.concatenate([req.prompt, emitted])
                      if emitted.size else req.prompt)
            try:
                bucket, slot, first = self._ops.start(
                    prompt, max_tokens=req.max_tokens - emitted.size,
                    temperature=req.temperature, seed=req.seed, owner=req)
            except GroupBroken:
                raise
            except Exception as e:      # resolve, never wedge the client
                with self._cv:
                    if req in self._admitting:
                        self._admitting.remove(req)
                req._finish(e)
                continue
            if joined:
                decode_metrics.note_join()
            telemetry.event("decode.join", bucket=bucket, slot=slot,
                            prompt_tokens=int(prompt.size),
                            mid_flight=joined, replayed=bool(emitted.size))
            admitted += 1
            with self._cv:
                self._last_progress = time.perf_counter()
                if req in self._admitting:      # evacuate() may have
                    self._admitting.remove(req)  # taken it mid-start
                self._placed[(bucket, slot)] = req
            req._push(first)
            self._maybe_finish(bucket, slot, req, first,
                               n_out=len(req._tokens))

    def _maybe_finish(self, bucket: int, slot: int, req: DecodeRequest,
                      tok: int, n_out: int) -> bool:
        if (req.eos_id is not None and tok == req.eos_id) \
                or n_out >= req.max_tokens:
            self._ops.release(bucket, slot)
            with self._cv:
                self._placed.pop((bucket, slot), None)
            decode_metrics.note_complete(n_out)
            req._finish()
            telemetry.event("decode.complete", bucket=bucket, slot=slot,
                            tokens=n_out,
                            ttft_ms=round(req.ttft_ms or 0.0, 3))
            return True
        return False

    def _failed(self, bucket: int, e: BaseException) -> None:
        """A failed dispatch (:2142): a pinned bucket's slots fail alone,
        a paged failure drops the shared pool and so every paged slot.
        The slots free (their pages return) and their requests replay as
        prompt + emitted, bit-identically; past ``MAX_REPLAYS`` the error
        resolves them."""
        self.dispatch_error_streak += 1
        with self._cv:
            affected = [(k, r) for k, r in self._placed.items()
                        if self.engine.paged or k[0] == bucket]
            for k, _ in affected:
                self._placed.pop(k, None)
        replay = []
        for (bk, slot), r in affected:
            self._ops.release(bk, slot)
            if r._replays >= self.MAX_REPLAYS:
                r._finish(e)
            else:
                r._replays += 1
                replay.append(r)
                decode_metrics.note_request_replayed()
        if replay:
            with self._cv:
                self._pending[:0] = replay

    def _advance_all(self) -> None:
        # the brownout ladder's first rung turns speculation off between
        # passes: plain steps give the same tokens
        spec = self.engine.draft is not None and self.engine.spec_enabled
        for bucket in self.engine.active_buckets():
            t0 = time.perf_counter()
            try:
                if spec:
                    out, n_c = self._ops.advance_spec(bucket)
                else:
                    toks = self._ops.advance(bucket)
            except GroupBroken:
                raise
            except Exception as e:
                self._failed(bucket, e)
                continue
            decode_metrics.note_token_ms((time.perf_counter() - t0) * 1e3)
            self.dispatch_error_streak = 0
            ran = self.engine.last_ran(bucket)
            with self._cv:
                self._last_progress = time.perf_counter()
                owned = [(k, r) for k, r in self._placed.items()
                         if k[0] == bucket]
            for (bk, slot), r in owned:
                if not ran[slot]:
                    continue        # stalled on pages; retried next pass
                if spec:
                    for j in range(int(n_c[slot])):
                        tok = int(out[slot, j])
                        r._push(tok)
                        if self._maybe_finish(bk, slot, r, tok,
                                              n_out=len(r._tokens)):
                            break
                else:
                    tok = int(toks[slot])
                    r._push(tok)
                    self._maybe_finish(bk, slot, r, tok,
                                       n_out=len(r._tokens))

    def _expire(self) -> None:
        """Resolve every request past its deadline with
        :class:`DeadlineExceeded`: queued ones leave the queue, placed
        ones free their slot and pages."""
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
            self._ops.release(bucket, slot)
        for r in exp_q + [r for _, r in exp_s]:
            decode_metrics.note_deadline_expiration()
            r._finish(DeadlineExceeded(
                r.deadline_ms, (now - r._t_submit) * 1e3, len(r._tokens)))
            telemetry.event("decode.deadline_exceeded",
                            deadline_ms=r.deadline_ms,
                            tokens=len(r._tokens))

    def _break(self, e: BaseException) -> None:
        """The group can serve no more (:class:`GroupBroken`, or its
        channel failed): stop intake and resolve every unfinished
        request with the error."""
        for r in self.evacuate():
            r._force_finish(e)
        telemetry.event("decode.group_stopped", error=repr(e)[:200])

    def _loop(self) -> None:
        if self._chan is None:
            return self._serve()
        try:
            self._serve()
        except Exception as e:      # noqa: BLE001 — resolved, not wedged
            self._break(e)

    def _serve(self) -> None:
        # inference mode is thread-local: the worker enters it itself
        beat = self.GROUP_BEAT_S if self._chan is not None else None
        with torch.inference_mode():
            while True:
                idle = False
                with self._cv:
                    while self._open and not self._pending \
                            and not self._placed:
                        if not self._cv.wait(beat) and beat is not None:
                            idle = True     # a group's leader beats
                            break
                    if not idle and not self._open and not self._pending \
                            and not self._placed:
                        if self._chan is not None:
                            self._ops.stop()
                        return
                if idle:
                    self._ops.heartbeat()
                    continue
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
        """Stop accepting, drain accepted requests, join the worker, stop
        the engine's harvester (the engine stays usable)."""
        with self._cv:
            self._open = False
            self._cv.notify_all()
        self._thread.join(timeout)
        if self.leads:
            self.engine.close()     # a follower's closes on the stop

    def __enter__(self) -> "ContinuousBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
