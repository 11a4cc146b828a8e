"""Shared compile engine of the port: CUDA graphs.

Port of ``deeplearning4j_tpu/runtime/compile_cache.py``.  Where the JAX
package sends every hot step through ``jax.jit`` (one XLA program per
input signature, shared between instances with the same key), the port
sends it through :func:`cached_graph`: on the card each new signature is
captured once as a CUDA graph (``torch.cuda.CUDAGraph``) and every later
call replays it, so a step costs one graph launch instead of hundreds of
kernel launches behind Python.  Both services report into
``runtime.metrics.compile_metrics``:

- :func:`cached_graph` wraps ``fn``.  A compile (one per signature and
  ``label``) bumps ``compile_count`` and books its wall time into
  ``compile_ms``; a call served by an existing signature counts as a
  ``cached_dispatches``.  With ``key=`` the wrapper is shared MODULE-WIDE
  through :func:`get_or_build`: two identically configured networks
  capture once per signature.  Only pass ``key`` when ``fn`` is fully
  determined by the key (a canonical conf JSON), never when it closes
  over data.  ``call.fn`` is the raw function (the eager comparator).
- :func:`get_or_build` shares any engine bundle by key (LRU bounded by
  :data:`MAX_ENTRIES`).

**Signatures.**  The arguments are flattened with ``torch.utils.
_pytree`` (tuples, lists, dicts, named tuples).  A signature is the tree
structure, the shape, stride, dtype and device of every tensor, the
device of every ``torch.Generator``, and the value of every other leaf
(a conf, a bucket, a flag).  So a value that changes from call to call
must reach ``fn`` as a tensor: a learning rate that decays, an
iteration, a position, a slot, a seed, a chunk offset.  ``fn`` never
reads a tensor's value on the host: no ``.item()``, ``.tolist()``,
``.cpu()``, no Python branch on a tensor's value (a graph replays the
branch taken at capture).

**On the card**, a new signature is (1) run ``WARMUP_RUNS`` times on a
side stream, on clones of the donated buffers and with every generator
state saved and restored, so warm-up advances neither the training state
nor a random stream; (2) captured with ``capture_error_mode=
"thread_local"`` (a batcher's worker and the caller's thread both use
the card), into one memory pool per entry that all its signatures share
(an entry replays one graph at a time, under its lock); (3) kept with its
static input and output buffers, and replayed for this call.  A later
call copies its tensors into the static inputs, skipping those that
already hold them, replays, and hands back the outputs.  A capture that
fails raises, naming the label and the signature: nothing runs eagerly
on the card in its place.  ``share=`` makes entries one entry for all of
this (one lock, pool and set of buffers): a decode engine's prefill and
step update the same KV cache.

**On the CPU** (the tests) ``fn`` runs directly; the first call of each
signature counts as its compile, as JAX traces on the CPU.

**Arguments.**

- *Donated* arguments (``donate_argnums``) are the step's state.  ``fn``
  may update them in place and return them.  The engine keeps the state
  in buffers of its own, one *state set* of buffers a state that is
  alive, and hands back aliases of them (tensors that share their
  memory).  A state the engine did not hand back (a fit's first state,
  a caller's own) is copied into a free set and never written; a
  returned state passed back is updated in place, with no copy, and is
  consumed by that call (as a donated JAX buffer: use what the call
  returns).  A returned state stays valid while other states run
  through the entry: while its aliases are alive its set is not free,
  so another state gets a set, and a capture, of its own.  So every
  state reads and writes only its own memory, on the card as on the CPU
  (where a state the entry did not hand back is cloned before ``fn``
  runs).  Drop an alias (a step counter, a per-epoch sum) once it is
  done with, or its set stays busy and the next state costs a capture.
- Other tensors are read-only.  They are copied into engine-owned
  buffers, and the copy is skipped while the caller passes the same
  tensor at the same version (served params cost one copy, not one a
  request).  An inference tensor has no version, so it is copied at
  every call: make weights that are served outside ``inference_mode``.
  ``fn`` must not write a read-only tensor: a capture (or the CPU's
  first call) that changes one raises.
- A ``torch.Generator`` gets a static twin that the graph draws from; the
  caller's state is copied into it before a replay and back after, so
  replays draw what an eager run would draw, and advance the caller's
  generator as it would.

**The API boundary** (the counterpart of the reference's donation
contract and copy-on-entry guard).  A returned donated state belongs to
its holder until it is passed back; every other output is cloned before
it is returned, under the entry's lock, so a caller may keep it.  An API
entry point that hands a state to a user for good (``fit`` leaving
trained params on a network, word vectors) clones it there, so the
fit's set is free for the next fit.

**Launch counters.**  A replay runs no Python, so a kernel wrapper's
launch counter would stop at the capture.  Kernel modules register their
counters (:func:`register_launch_counters`); the engine notes what each
capture launched, takes warm-up and capture back out, and adds the
capture's launches at every replay.  Launches by another thread during
a capture would be booked to it.
"""

from __future__ import annotations

import gc
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

#: LRU bound of the shared entries
MAX_ENTRIES = 256
#: LRU bound of the graphs one entry keeps (each pins its static buffers)
MAX_SIGNATURES = 64
#: eager runs on a side stream before a capture (lazy initialisation of
#: cuBLAS, autograd's streams and the allocator happens there)
WARMUP_RUNS = 2

_LOCK = threading.RLock()
_ENGINES: "OrderedDict[Hashable, Any]" = OrderedDict()

_COUNTERS: List[Tuple[Callable[[], Dict[str, int]],
                      Callable[[Dict[str, int]], None]]] = []


def register_launch_counters(read: Callable[[], Dict[str, int]],
                             add: Callable[[Dict[str, int]], None]) -> None:
    """A kernel module's launch counters: ``read()`` gives ``{name:
    count}`` and ``add({name: n})`` adds to them (``n`` may be negative)."""
    _COUNTERS.append((read, add))


def _read_counters() -> List[Dict[str, int]]:
    return [read() for read, _ in _COUNTERS]


def _add_counters(delta: List[Dict[str, int]], sign: int = 1) -> None:
    for (_, add), d in zip(_COUNTERS, delta):
        if any(d.values()):
            add({k: sign * n for k, n in d.items()})


def _diff(after, before) -> List[Dict[str, int]]:
    return [{k: a[k] - b.get(k, 0) for k in a} for a, b in zip(after, before)]


def _version(t: torch.Tensor) -> Optional[int]:
    """``t``'s version counter, None for an inference tensor (which has
    none)."""
    return None if t.is_inference() else t._version


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# -- the card's primitives (a test may stand in for them on the CPU) -------

def _graphs_on(device: torch.device) -> bool:
    """Whether calls with tensors on ``device`` are captured."""
    return device.type == "cuda"


def _new_pool():
    return torch.cuda.graph_pool_handle()


def _record(fn: Callable, args, kwargs, warm_args: Callable, gens,
            device: torch.device, pool):
    """Warm ``fn`` up on a side stream (``warm_args()`` gives each run
    its arguments), then capture ``fn(*args, **kwargs)``: ``(graph,
    out)``.  ``gens`` are the static generators the graph draws from."""
    saved = [g.get_state() for g in gens]
    default_state = torch.cuda.get_rng_state(device)
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for _ in range(WARMUP_RUNS):
            a, kw = warm_args()
            fn(*a, **kw)
            for g, st in zip(gens, saved):
                g.set_state(st)
            torch.cuda.set_rng_state(default_state, device)
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for g in gens:
        graph.register_generator_state(g)
    # no garbage collection inside the capture: collecting a dead
    # entry's graph there destroys it (cudaGraphExecDestroy, cudaFree),
    # which invalidates the capture
    gc_on = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=side,
                              capture_error_mode="thread_local"):
            out = fn(*args, **kwargs)
    finally:
        if gc_on:
            gc.enable()
    return graph, out


# -- state -----------------------------------------------------------------

class _StateSet:
    """Engine-owned buffers of one donated state, by (leaf index, leaf
    meta), and the aliases of them that calls handed back."""

    __slots__ = ("bufs", "aliases")

    def __init__(self):
        self.bufs: Dict[Hashable, torch.Tensor] = {}
        self.aliases: Dict[Hashable, Any] = {}

    def holder(self, key) -> Optional[torch.Tensor]:
        """The live alias of ``key``'s buffer, None when nobody holds it."""
        r = self.aliases.get(key)
        return None if r is None else r()

    def alias(self, key) -> torch.Tensor:
        a = self.holder(key)
        if a is None:
            a = self.bufs[key].detach()
            self.aliases[key] = weakref.ref(a)
        return a


class _Shared:
    """What entries joined by ``share=`` have in common."""

    def __init__(self):
        self.lock = threading.RLock()
        self.pool = None
        self.sets: List[_StateSet] = []
        #: (leaf index, meta) -> static read-only tensor
        self.buffers: Dict[Hashable, torch.Tensor] = {}
        #: static buffer key -> (weakref to the source, its version) of
        #: the last read-only copy-in
        self.copied: Dict[Hashable, Tuple[Any, Optional[int]]] = {}
        self.gens: Dict[torch.device, torch.Generator] = {}
        #: donated tensors a CPU call handed back, by id
        self.returned: Dict[int, Any] = {}
        #: bytes copied into static buffers
        self.copied_bytes = 0

    def pick(self, don) -> _StateSet:
        """The set a call's donated leaves ``[(key, tensor)]`` run on:
        among the sets where every key is free or held by the tensor
        passed for it, the one that already holds most of them; a new
        set when none qualifies."""
        best, best_hits = None, -1
        for z in self.sets:
            hits = 0
            for key, src in don:
                h = z.holder(key)
                if h is src:
                    hits += 1
                elif h is not None:
                    break
            else:
                if hits > best_hits:
                    best, best_hits = z, hits
        if best is None:
            best = _StateSet()
            self.sets.append(best)
        return best

    def static_gen(self, dev: torch.device) -> torch.Generator:
        g = self.gens.get(dev)
        if g is None:
            g = self.gens[dev] = torch.Generator(device=dev)
        return g


class _Graph:
    """One captured signature on one state set: the graph, its static
    inputs and outputs, and the kernel launches one replay makes."""

    __slots__ = ("graph", "statics", "out_spec", "outs", "launched")

    def __init__(self, graph, statics, out_spec, outs, launched):
        self.graph = graph
        self.statics = statics
        self.out_spec = out_spec
        #: per output leaf: ("in", key) for a donated buffer it returns,
        #: ("out", static tensor) or ("c", value)
        self.outs = outs
        self.launched = launched


def _meta(leaf, donated: bool):
    if isinstance(leaf, torch.Tensor):
        # a size-1 dim's stride addresses nothing (numpy's x[..., None]
        # gives it 0, a stack gives it 1): one signature for both
        stride = tuple(0 if n == 1 else st
                       for n, st in zip(leaf.shape, leaf.stride()))
        return ("T", tuple(leaf.shape), stride, leaf.dtype,
                leaf.device, donated)
    if isinstance(leaf, torch.Generator):
        return ("G", leaf.device)
    return ("C", leaf)


class GraphFn:
    """The callable :func:`cached_graph` returns (see the module
    docstring).  ``fn`` is the raw function, ``label`` the name its
    compiles are booked under."""

    def __init__(self, fn: Callable, label: str, donate_argnums=(),
                 share: Optional["GraphFn"] = None):
        self.fn = fn
        self.label = label
        self.donate = frozenset(donate_argnums)
        self._sh = share._sh if share is not None else _Shared()
        self._graphs: "OrderedDict[Hashable, _Graph]" = OrderedDict()
        self._seen: "OrderedDict[Hashable, bool]" = OrderedDict()

    @property
    def copied_bytes(self) -> int:
        """Bytes the entry (with those it shares with) copied into its
        static buffers: read-only arguments that changed, and states it
        did not hand back."""
        return self._sh.copied_bytes

    # -- signature ---------------------------------------------------------
    def _signature(self, args, kwargs):
        leaves: list = []
        specs = []
        metas = []
        for i, a in enumerate(list(args) + [kwargs]):
            lv, spec = pytree.tree_flatten(a)
            specs.append(spec)
            leaves.extend(lv)
            metas.extend(_meta(x, i in self.donate and i < len(args))
                         for x in lv)
        try:
            sig = (tuple(specs), tuple(metas))
            hash(sig)
        except TypeError as e:
            raise TypeError(
                f"{self.label}: every non-tensor argument must be hashable "
                f"(it is part of the signature): {e}") from None
        return sig, specs, leaves, metas

    @staticmethod
    def _call_args(specs, leaves):
        out, n = [], 0
        for spec in specs:
            out.append(pytree.tree_unflatten(
                leaves[n:n + spec.num_leaves], spec))
            n += spec.num_leaves
        return tuple(out[:-1]), out[-1]

    # -- call --------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        sig, specs, leaves, metas = self._signature(args, kwargs)
        devs = [m[4] for m in metas if m[0] == "T"]
        if not any(_graphs_on(d) for d in devs):
            return self._call_cpu(sig, specs, leaves, metas)
        sh = self._sh
        with sh.lock:
            don = [((i, m), leaf) for i, (leaf, m)
                   in enumerate(zip(leaves, metas)) if m[0] == "T" and m[5]]
            z = sh.pick(don)
            gkey = (sig, id(z))
            g = self._graphs.get(gkey)
            if g is None:
                t0 = time.perf_counter()
                g = self._capture(sig, specs, leaves, metas, z)
                self._graphs[gkey] = g
                while len(self._graphs) > MAX_SIGNATURES:
                    self._graphs.popitem(last=False)
                # the capture copied this call's tensors in already
                out = self._replay(g, z, leaves, metas, copy=False)
                compile_metrics.note_trace(self.label)
                compile_metrics.note_compile_ms(
                    (time.perf_counter() - t0) * 1e3)
            else:
                self._graphs.move_to_end(gkey)
                out = self._replay(g, z, leaves, metas)
                compile_metrics.note_cached_dispatch()
        return out

    def _call_cpu(self, sig, specs, leaves, metas):
        sh = self._sh
        with sh.lock:
            first = sig not in self._seen
            if first:
                self._seen[sig] = True
                while len(self._seen) > MAX_SIGNATURES:
                    self._seen.popitem(last=False)
            # a donated tensor this entry did not hand back is the
            # caller's: fn updates a clone of it
            leaves = list(leaves)
            don = set()
            for i, (leaf, m) in enumerate(zip(leaves, metas)):
                if m[0] == "T" and m[5]:
                    r = sh.returned.get(id(leaf))
                    if r is None or r() is not leaf:
                        leaves[i] = leaf.detach().clone()
                    don.add(id(leaves[i]))
        t0 = time.perf_counter()
        ro = [(leaf, _version(leaf)) for leaf, m in zip(leaves, metas)
              if m[0] == "T" and not m[5]]
        a, kw = self._call_args(specs, leaves)
        out = self.fn(*a, **kw)
        if first:
            self._check_read_only(ro)
        with sh.lock:
            if len(sh.returned) > 4096:
                sh.returned = {k: r for k, r in sh.returned.items()
                               if r() is not None}
            for t in pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor) and id(t) in don:
                    sh.returned[id(t)] = weakref.ref(t)
        if first:
            compile_metrics.note_trace(self.label)
            compile_metrics.note_compile_ms((time.perf_counter() - t0) * 1e3)
        else:
            compile_metrics.note_cached_dispatch()
        return out

    def _check_read_only(self, ro) -> None:
        for leaf, ver in ro:
            if ver is not None and leaf._version != ver:
                raise RuntimeError(
                    f"{self.label}: the function wrote a tensor argument "
                    f"that is not donated (shape {tuple(leaf.shape)}); "
                    f"donate it (donate_argnums) or leave it alone")

    # -- the card ----------------------------------------------------------
    def _statics(self, leaves, metas, z: _StateSet):
        """The static input of every leaf: a donated tensor's buffer in
        ``z``, a read-only one's shared buffer of its (index, meta), both
        made on first sight (:meth:`_copy_in` fills them); a generator
        the device's static twin; any other leaf itself."""
        sh = self._sh
        statics = []
        for i, (leaf, m) in enumerate(zip(leaves, metas)):
            if m[0] == "G":
                statics.append(sh.static_gen(leaf.device))
            elif m[0] == "C":
                statics.append(leaf)
            else:
                bufs = z.bufs if m[5] else sh.buffers
                buf = bufs.get((i, m))
                if buf is None:
                    buf = bufs[(i, m)] = torch.empty_like(leaf)
                statics.append(buf)
        return statics

    def _copy_in(self, statics, z: _StateSet, leaves, metas) -> None:
        sh = self._sh
        for i, (src, dst, m) in enumerate(zip(leaves, statics, metas)):
            if m[0] != "T" or src is dst:
                continue
            key = (i, m)
            if m[5]:
                if z.holder(key) is not src:
                    dst.copy_(src)
                    sh.copied_bytes += _nbytes(src)
                continue
            ref, ver = sh.copied.get(key, (None, None))
            v = _version(src)
            if ref is not None and ref() is src and v is not None \
                    and v == ver:
                continue
            dst.copy_(src)
            sh.copied_bytes += _nbytes(src)
            sh.copied[key] = (weakref.ref(src), v)

    def _capture(self, sig, specs, leaves, metas, z) -> _Graph:
        sh = self._sh
        dev = next(m[4] for m in metas if m[0] == "T" and _graphs_on(m[4]))
        counters0 = _read_counters()
        try:
            statics = self._statics(leaves, metas, z)
            self._copy_in(statics, z, leaves, metas)
            gens = [(leaf, statics[i]) for i, (leaf, m)
                    in enumerate(zip(leaves, metas)) if m[0] == "G"]
            for caller, static in gens:
                static.set_state(caller.get_state())
            if sh.pool is None:
                sh.pool = _new_pool()
            ro = [(s, _version(s)) for s, m in zip(statics, metas)
                  if m[0] == "T" and not m[5]]

            def warm_args():
                return self._call_args(
                    specs, [s.clone() if m[0] == "T" and m[5] else s
                            for s, m in zip(statics, metas)])

            before = [{}] * len(_COUNTERS)
            a, kw = self._call_args(specs, statics)

            def fn(*a, **kw):
                before[:] = _read_counters()
                return self.fn(*a, **kw)

            graph, out = _record(fn, a, kw, warm_args,
                                 [s for _, s in gens], dev, sh.pool)
            after = _read_counters()
            self._check_read_only(ro)
        except Exception as e:
            _add_counters(_diff(_read_counters(), counters0), -1)
            raise RuntimeError(
                f"{self.label}: CUDA-graph capture failed for the signature "
                f"{_describe(sig)}: {type(e).__name__}: {e}") from e
        # warm-up and capture launched nothing that counts: replays do
        _add_counters(_diff(after, counters0), -1)
        out_leaves, out_spec = pytree.tree_flatten(out)
        by_id = {id(s): (i, m) for i, (s, m) in enumerate(zip(statics, metas))
                 if m[0] == "T" and m[5]}
        outs = []
        for t in out_leaves:
            if isinstance(t, torch.Tensor) and id(t) in by_id:
                outs.append(("in", by_id[id(t)]))
            elif isinstance(t, torch.Tensor):
                outs.append(("out", t))
            elif isinstance(t, torch.Generator):
                raise RuntimeError(f"{self.label}: a captured function may "
                                   f"not return a generator")
            else:
                outs.append(("c", t))
        return _Graph(graph, statics, out_spec, outs, _diff(after, before))

    def _replay(self, g: _Graph, z: _StateSet, leaves, metas,
                copy: bool = True):
        if copy:
            self._copy_in(g.statics, z, leaves, metas)
        gens = [i for i, m in enumerate(metas) if m[0] == "G"]
        for i in gens:
            g.statics[i].set_state(leaves[i].get_state())
        g.graph.replay()
        for i in gens:
            leaves[i].set_state(g.statics[i].get_state())
        _add_counters(g.launched)
        vals = [z.alias(ref) if kind == "in"
                else ref.clone() if kind == "out" else ref
                for kind, ref in g.outs]
        return pytree.tree_unflatten(vals, g.out_spec)

    # -- introspection -----------------------------------------------------
    def signatures(self) -> int:
        """Graphs this entry holds on the card (one a signature and
        state set), first calls seen on the CPU."""
        with self._sh.lock:
            return len(self._graphs) + len(self._seen)


def _describe(sig) -> str:
    parts, consts = [], []
    for m in sig[1]:
        if m[0] == "G":
            parts.append(f"Generator({m[1]})")
        elif m[0] == "C":
            consts.append(repr(m[1])[:40])
        else:
            parts.append(f"{str(m[3]).replace('torch.', '')}"
                         f"{list(m[1])}{'(donated)' if m[5] else ''}")
    shown = ", ".join(parts[:8]) + (f", ... ({len(parts)} in all)"
                                    if len(parts) > 8 else "")
    return f"tensors {shown}; constants {', '.join(consts[:8])}"


def cached_graph(fn: Callable, *, key: Optional[Hashable] = None,
                 label: Optional[str] = None,
                 donate_argnums: Tuple[int, ...] = (),
                 share: Optional[GraphFn] = None) -> GraphFn:
    """``fn`` through the engine: the counterpart of ``cached_jit``
    (see the module docstring).  Without ``key`` the wrapper is private
    to the caller but still instrumented; with ``key`` it is shared
    module-wide and the lookup counts as an engine hit or build.
    ``share`` joins another wrapper's lock, pool and buffers."""
    label = label or getattr(fn, "__name__", "graph")
    if key is None:
        return GraphFn(fn, label, donate_argnums, share)
    return get_or_build(("graph", key),
                        lambda: GraphFn(fn, label, donate_argnums, share))


def get_or_build(key: Hashable, builder: Callable[[], Any]) -> Any:
    """Shared engine entry: the first caller's ``builder()`` result wins;
    every later caller with an equal key gets the SAME object."""
    with _LOCK:
        entry = _ENGINES.get(key)
        if entry is not None:
            _ENGINES.move_to_end(key)
            compile_metrics.note_engine(hit=True)
            return entry
    # builders only construct wrappers: captures happen at first call
    built = builder()
    with _LOCK:
        entry = _ENGINES.setdefault(key, built)
        compile_metrics.note_engine(hit=entry is not built)
        _ENGINES.move_to_end(key)
        while len(_ENGINES) > MAX_ENTRIES:
            _ENGINES.popitem(last=False)
        return entry


def clear() -> None:
    """Drop every SHARED entry (mostly for tests).  Counters in
    ``compile_metrics`` are reset separately; wrappers already handed
    out keep their graphs."""
    with _LOCK:
        _ENGINES.clear()


def size() -> int:
    with _LOCK:
        return len(_ENGINES)
