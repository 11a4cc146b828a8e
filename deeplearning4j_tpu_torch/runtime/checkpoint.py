"""Checkpoint / resume.

Port of ``deeplearning4j_tpu/runtime/checkpoint.py``: pytree
serialization (arrays into one ``.npz`` keyed ``a0 .. aN`` in flatten
order, each leaf's path and the caller's meta in a sidecar JSON), the
rolling, crash-safe :class:`CheckpointManager` (a manifest of per-file
crc32s is the commit marker), the background :class:`AsyncCheckpointer`,
the rotating :class:`ModelSaver` and the ``MultiLayerNetwork``
portability pair :func:`save_model` / :func:`load_model`.

**The format is the reference's, so a checkpoint written by either
package restores in the other:**

- ``<path>`` is an ``.npz`` of ``a0 .. aN`` in the tree's flatten order;
- ``<path>.json`` holds ``"paths"`` (each leaf's tree path joined with
  ``"/"``), ``"meta"`` and ``"format": 1``;
- a manager's ``ckpt_<step>.npz.manifest.json`` holds ``{"format": 1,
  "step": N, "files": {name: {"crc32", "bytes"}}}``.

Flatten order is JAX's: dict keys sorted, a named tuple's fields by
name in declaration order, sequence items by index, ``None`` an empty
subtree.  A bf16 leaf is written as numpy writes JAX's (raw ``|V2``,
the same bytes) and read back as ``torch.bfloat16`` (through the
template's dtype when there is one).

Templates (``like=``) are the port's trees: tensors (restored with the
template's dtype and device), numpy arrays, Python numbers.  Without a
template, leaves come back as CPU tensors in nested dicts keyed by path
segment (sequence indices stay string keys, as in the reference).

Not ported (each raises ``NotImplementedError`` naming ROADMAP A7):
``save_pytree_sharded`` / ``load_pytree_sharded``, the manager's
``cluster=`` commit protocol and ``OrbaxCheckpointManager`` (whose
counterpart for sharded state is ``torch.distributed.checkpoint``).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import queue
import re
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.updaters import tree_leaves, tree_map

log = logging.getLogger(__name__)

PyTree = Any

_SEP = "/"
#: numpy's dtype for a bf16 array it has no type for: two raw bytes
_BF16_NP = np.dtype("V2")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP A7: "
        f"sharded and multi-host state)")


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed checksum verification (or its files are
    truncated/unreadable).  ``CheckpointManager.restore(step=None)``
    catches this and falls back to the previous good step; an explicit
    ``step=`` request surfaces it to the caller."""


class StructureMismatchError(ValueError):
    """The ``like`` template's flatten order doesn't match the saved
    paths — a CALLER bug (renamed layer, wrong conf), not disk
    corruption.  ``restore()``'s fallback walk re-raises it immediately
    instead of "failing" every step in the directory."""


def load_numpy_tree(path: str) -> Dict[str, Any]:
    """The tree saved at ``path`` as nested dicts of ``np.ndarray`` keyed
    by path segment (sequence indices stay string keys, as in
    ``load_pytree`` without a template)."""
    with open(path + ".json") as f:
        paths = json.load(f)["paths"]
    root: Dict[str, Any] = {}
    with np.load(path) as data:
        if len(data.files) != len(paths):
            raise ValueError(f"{path} holds {len(data.files)} arrays but "
                             f"its sidecar names {len(paths)} paths")
        for i, p in enumerate(paths):
            node = root
            parts = p.split(_SEP)
            for seg in parts[:-1]:
                node = node.setdefault(seg, {})
            node[parts[-1]] = data[f"a{i}"]
    return root


def _crc32_file(path: str, chunk: int = 1 << 20) -> Tuple[int, int]:
    """(crc32, size_bytes) of a file, streamed."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
            size += len(buf)
    return crc & 0xFFFFFFFF, size


def _replace_with_fsync(tmp: str, dst: str) -> None:
    """fsync(tmp), atomically rename it into place, then fsync the
    parent directory: the rename is the commit, and both halves must be
    durable before a save reports success."""
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, dst)
    dfd = os.open(os.path.dirname(os.path.abspath(dst)), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(node, keys: List[str], out: List[Tuple[str, Any]]) -> None:
    # module level, not a closure: a recursive nested function is a
    # reference cycle, and it would keep the leaves alive until the next
    # garbage collection (a donated state's aliases among them, whose
    # state set then stays busy and costs the next state a capture)
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], keys + [str(k)], out)
    elif _is_namedtuple(node):
        for name in node._fields:
            _walk(getattr(node, name), keys + [name], out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, keys + [str(i)], out)
    else:
        out.append((_SEP.join(keys), node))


def _flatten_with_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in JAX's flatten order: dict keys sorted, a
    named tuple's fields by name, sequence items by index, None empty."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, [], out)
    return out


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        vals = {k: _build(node[k], it) for k in sorted(node)}
        return {k: vals[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*(_build(getattr(node, n), it)
                            for n in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def _unflatten_like(like: PyTree, leaves: List[Any]) -> PyTree:
    """A tree of ``like``'s structure over ``leaves`` given in
    :func:`_flatten_with_paths` order (dicts keep the template's key
    order)."""
    return _build(like, iter(leaves))


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array ``np.savez`` writes: a tensor's bytes on the
    host (bf16 as raw ``V2``, as numpy writes JAX's bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(_BF16_NP)
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, tpl=None):
    """A saved array as the template leaf's kind: a tensor of its dtype on
    its device, a numpy array of its dtype, a Python number; a CPU tensor
    without a template."""
    if arr.dtype == _BF16_NP:
        # two raw bytes a value: only bf16 is written so
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    elif tpl is None or isinstance(tpl, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
    else:
        t = None
    if tpl is None:
        return t
    if isinstance(tpl, torch.Tensor):
        return t.to(dtype=tpl.dtype, device=tpl.device)
    if isinstance(tpl, np.ndarray):
        src = t.float().numpy() if t is not None else arr
        return np.asarray(src, dtype=tpl.dtype)
    if isinstance(tpl, (bool, int, float)):
        return type(tpl)(np.asarray(arr).item())
    return arr


def save_pytree(path: str, tree: PyTree,
                meta: Optional[Dict] = None) -> Dict[str, Dict]:
    """Write ``path`` (.npz) + ``path + '.json'`` (paths/meta).

    Both files go through tmp-file + fsync + ``os.replace``, sidecar
    FIRST and the ``.npz`` LAST: the step becomes visible (globs key on
    the ``.npz``) only once every byte of both files is durable.
    Returns ``{filename: {"crc32", "bytes"}}`` for the two files, the
    manifest input ``CheckpointManager`` commits alongside."""
    items = _flatten_with_paths(tree)
    arrays = {f"a{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(items)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def commit(write_fn, dst: str) -> Dict[str, int]:
        # stream into the tmp file, then crc it with one sequential
        # re-read before the replace (np.savez's zipfile seeks back while
        # writing, so the crc cannot ride along the stream)
        tmp = dst + ".tmp"
        with open(tmp, "wb") as f:
            write_fn(f)
        crc, size = _crc32_file(tmp)
        _replace_with_fsync(tmp, dst)
        return {"crc32": crc, "bytes": size}

    sidecar = {
        "paths": [p for p, _ in items],
        "meta": meta or {},
        "format": 1,
    }
    side_json = json.dumps(sidecar, indent=1).encode()
    side_entry = commit(lambda f: f.write(side_json), path + ".json")
    npz_entry = commit(lambda f: np.savez(f, **arrays), path)
    return {os.path.basename(path): npz_entry,
            os.path.basename(path) + ".json": side_entry}


def load_pytree(path: str, like: Optional[PyTree] = None
                ) -> Tuple[PyTree, Dict]:
    """Restore (tree, meta).  With ``like``, leaves are matched
    positionally against the template's flatten order (and path-checked)
    and take each template leaf's dtype and device; without it, a nested
    dict of CPU tensors keyed by path segment is built."""
    with open(path + ".json") as f:
        sidecar = json.load(f)
    with np.load(path) as data:
        leaves = [data[f"a{i}"] for i in range(len(sidecar["paths"]))]

    if like is not None:
        tpl_items = _flatten_with_paths(like)
        if [p for p, _ in tpl_items] != sidecar["paths"]:
            raise StructureMismatchError(
                "checkpoint structure mismatch:\n saved: "
                f"{sidecar['paths'][:5]}...\n template: "
                f"{[p for p, _ in tpl_items][:5]}...")
        vals = [_from_numpy(a, t) for a, (_, t) in zip(leaves, tpl_items)]
        return _unflatten_like(like, vals), sidecar["meta"]

    root: Dict[str, Any] = {}
    for p, leaf in zip(sidecar["paths"], leaves):
        node = root
        parts = p.split(_SEP)
        for seg in parts[:-1]:
            node = node.setdefault(seg, {})
        node[parts[-1]] = _from_numpy(leaf)
    return root, sidecar["meta"]


def save_pytree_sharded(path: str, tree: PyTree,
                        meta: Optional[Dict] = None, **kwargs):
    """Per-process shard save (reference :191): ROADMAP A7."""
    raise _not_ported("save_pytree_sharded (per-process shards)")


def load_pytree_sharded(path: str, like: Optional[PyTree] = None):
    """Restore with resharding (reference :312): ROADMAP A7."""
    raise _not_ported("load_pytree_sharded (restore with resharding)")


class CheckpointManager:
    """Rolling checkpoints: ``<dir>/ckpt_<step>.npz`` keeping the newest
    ``max_to_keep``.

    Crash-safe commit protocol: the ``.npz``/sidecar pair lands via
    tmp-file + fsync + ``os.replace`` (``save_pytree``), then a
    ``ckpt_<step>.npz.manifest.json`` holding a per-file crc32 table is
    replaced into place LAST: the manifest is the commit marker.
    ``restore()`` (no explicit step) verifies the newest step's
    checksums and falls back to the previous good step when the newest
    is corrupt or uncommitted (a kill mid-save costs one checkpoint
    cadence, never the run); ``restore(step=K)`` verifies and RAISES
    :class:`CorruptCheckpointError` instead.

    ``cluster=`` (the multi-host commit protocol) raises
    ``NotImplementedError`` (ROADMAP A7)."""

    _PAT = re.compile(r"ckpt_(\d+)\.npz$")
    _PAT_SHARDS = re.compile(r"ckpt_(\d+)\.shards$")

    def __init__(self, directory: str, max_to_keep: int = 3,
                 cluster=None):
        if cluster is not None:
            raise _not_ported("CheckpointManager(cluster=) cluster commits")
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)
        # crash recovery: a kill mid-save leaves ckpt_N.*.tmp behind, and
        # if step N is never saved again nothing else removes it
        for f in glob.glob(os.path.join(directory, "ckpt_*.tmp")) + \
                glob.glob(os.path.join(directory, "ckpt_*.shards",
                                       "*.tmp")):
            try:
                os.remove(f)
                log.info("swept orphaned checkpoint tmp file %s", f)
            except OSError:
                pass

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    def _shards_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.shards")

    def _manifest_path(self, step: int) -> str:
        return self._path(step) + ".manifest.json"

    def all_steps(self) -> List[int]:
        steps = set()
        for f in glob.glob(os.path.join(self.directory, "ckpt_*.npz")):
            m = self._PAT.search(f)
            if m:
                steps.add(int(m.group(1)))
        for f in glob.glob(os.path.join(self.directory, "ckpt_*.shards")):
            m = self._PAT_SHARDS.search(f)
            if m and os.path.isdir(f):
                steps.add(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: PyTree, meta: Optional[Dict] = None,
             *, _t_req: Optional[float] = None,
             _was_async: bool = False) -> str:
        """Save + commit (manifest included).  The async path
        (:class:`AsyncCheckpointer`) routes through here on its writer
        thread, so there is ONE commit protocol; the private kwargs carry
        its request timestamp for write-behind-lag accounting."""
        from deeplearning4j_tpu_torch.runtime.metrics import (
            checkpoint_metrics)

        t0 = time.perf_counter()
        meta = dict(meta or {})
        meta.update({"step": step, "time": time.time()})
        files = save_pytree(self._path(step), tree, meta)
        self._commit_manifest(step, files)
        self._gc()
        now = time.perf_counter()
        if not _was_async:
            checkpoint_metrics.note("saves_sync")
        checkpoint_metrics.note_committed(
            sum(v["bytes"] for v in files.values()),
            (now - t0) * 1e3,
            (now - (_t_req if _t_req is not None else t0)) * 1e3,
            was_async=_was_async)
        return self._path(step)

    def _commit_manifest(self, step: int, files: Dict[str, Dict]) -> None:
        manifest = {"format": 1, "step": step, "files": files}
        man_tmp = self._manifest_path(step) + ".tmp"
        with open(man_tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        _replace_with_fsync(man_tmp, self._manifest_path(step))

    def verify(self, step: int) -> None:
        """Raise :class:`CorruptCheckpointError` unless ``step``'s files
        match its committed manifest.  A missing manifest on an existing
        ``.npz`` means the commit never completed (crash mid-save)."""
        from deeplearning4j_tpu_torch.runtime.metrics import (
            checkpoint_metrics)

        mpath = self._manifest_path(step)
        if not os.path.exists(mpath):
            raise CorruptCheckpointError(
                f"checkpoint step {step} in {self.directory} has no "
                "manifest — uncommitted (crash mid-save?) or pre-manifest")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            for fname, want in manifest["files"].items():
                crc, size = _crc32_file(
                    os.path.join(self.directory, fname))
                if crc != want["crc32"] or size != want["bytes"]:
                    raise CorruptCheckpointError(
                        f"checkpoint file {fname} fails its manifest "
                        f"checksum (got crc32={crc}/{size}B, manifest "
                        f"says {want['crc32']}/{want['bytes']}B)")
        except CorruptCheckpointError:
            checkpoint_metrics.note("checksum_failures")
            raise
        except Exception as e:   # unreadable manifest / missing file
            checkpoint_metrics.note("checksum_failures")
            raise CorruptCheckpointError(
                f"checkpoint step {step} unverifiable: "
                f"{type(e).__name__}: {e}") from e

    def restore(self, step: Optional[int] = None,
                like: Optional[PyTree] = None) -> Tuple[PyTree, Dict]:
        from deeplearning4j_tpu_torch.runtime.metrics import (
            checkpoint_metrics)

        if step is not None:
            if os.path.exists(self._manifest_path(step)):
                self.verify(step)
            return self._load_snapshot(step, like)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        # committed (manifest-bearing) steps outrank manifest-less ones:
        # a missing manifest on the newest step is the crash-mid-save
        # signature; manifest-less steps still restore when nothing
        # committed exists (pre-manifest directories)
        desc = steps[::-1]
        committed = [s for s in desc
                     if os.path.exists(self._manifest_path(s))]
        legacy = [s for s in desc
                  if not os.path.exists(self._manifest_path(s))]
        last_err: Optional[Exception] = None
        for s in committed + legacy:
            try:
                if os.path.exists(self._manifest_path(s)):
                    self.verify(s)
                out = self._load_snapshot(s, like)
                if s != desc[0]:
                    checkpoint_metrics.note("restore_fallbacks")
                    log.warning(
                        "restored checkpoint step %d (newer step(s) "
                        "%s corrupt or uncommitted) in %s", s,
                        [x for x in desc if x > s], self.directory)
                return out
            except Exception as e:  # noqa: BLE001 — corrupt files throw
                #                     anything (zip, json, ValueError)
                if isinstance(e, (StructureMismatchError,
                                  NotImplementedError)):
                    # a caller bug or an unported layout: every step
                    # would fail the same way
                    raise
                last_err = e
                log.warning("checkpoint step %d unrestorable (%s: %s); "
                            "falling back", s, type(e).__name__, e)
        raise CorruptCheckpointError(
            f"no restorable checkpoint in {self.directory} "
            f"(tried steps {desc})") from last_err

    def _load_snapshot(self, step: int, like: Optional[PyTree]
                       ) -> Tuple[PyTree, Dict]:
        if os.path.exists(self._path(step)):
            return load_pytree(self._path(step), like)
        if os.path.isdir(self._shards_dir(step)):
            raise _not_ported(f"restoring the sharded step {step}")
        raise FileNotFoundError(
            f"no checkpoint files for step {step} in {self.directory}")

    def _gc(self) -> None:
        """Retention sweep; tolerates concurrently deleted files."""
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            for suffix in (".manifest.json", ".json", ""):
                try:
                    os.remove(self._path(s) + suffix)
                except OSError:
                    pass
            shutil.rmtree(self._shards_dir(s), ignore_errors=True)


class SnapshotHandle:
    """Future-like handle for one in-flight async snapshot."""

    def __init__(self, step: int):
        self.step = step
        self.path: Optional[str] = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> str:
        """Block until committed; returns the checkpoint path or raises
        the writer-side error."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"snapshot for step {self.step} not committed within "
                f"{timeout}s")
        if self.error is not None:
            raise self.error
        assert self.path is not None
        return self.path


def _host_empty(shape, dtype) -> torch.Tensor:
    """A host buffer for a staged leaf: pinned where a card can copy
    into it asynchronously."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.cuda.is_available())


class PinnedPool:
    """Host buffers kept between snapshots, so only the first snapshot of
    a state (or :meth:`AsyncCheckpointer.reserve`, before training) pays
    their allocation: pinned host memory is slow to allocate (a 1.49 GB
    state's took 378-711 ms on an H100 80GB HBM3 host), and the training
    thread stages.

    A *set* holds the buffers of one snapshot, keyed by (shape, dtype),
    a list each (a tree has several leaves of one shape).  A snapshot
    takes a free set and the writer gives it back after the commit, so
    at most ``max_in_flight`` sets exist.  ``allocations`` and
    ``nbytes`` count what the pool allocated."""

    def __init__(self):
        self._free: List[Dict[Tuple, List[torch.Tensor]]] = []
        self._lock = threading.Lock()
        self.allocations = 0
        self.nbytes = 0

    def take(self) -> Dict[Tuple, List[torch.Tensor]]:
        with self._lock:
            return self._free.pop() if self._free else {}

    def give(self, bufset: Dict[Tuple, List[torch.Tensor]]) -> None:
        with self._lock:
            self._free.append(bufset)

    def buffers(self, bufset, leaves: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
        """A buffer of each leaf's shape and dtype from ``bufset``, the
        missing ones allocated (and kept in the set)."""
        used: Dict[Tuple, int] = {}
        out = []
        for leaf in leaves:
            key = (tuple(leaf.shape), leaf.dtype)
            i = used.get(key, 0)
            used[key] = i + 1
            have = bufset.setdefault(key, [])
            if i == len(have):
                have.append(_host_empty(leaf.shape, leaf.dtype))
                with self._lock:
                    self.allocations += 1
                    self.nbytes += leaf.numel() * leaf.element_size()
            out.append(have[i])
        return out


class _Staged:
    """One staged snapshot: the host tree the writer serializes, the
    device clones it was copied from, the side-stream events the writer
    waits on before touching the host tree, and the pool's buffer set
    the host tree lives in."""

    __slots__ = ("host", "clones", "events", "bufset")

    def __init__(self, host, clones, events, bufset):
        self.host = host
        self.clones = clones
        self.events = events
        self.bufset = bufset

    def wait(self) -> PyTree:
        for ev in self.events:
            ev.synchronize()
        # the copies are done: the device memory goes back now, not when
        # the commit ends
        self.clones = []
        self.events = []
        return self.host


class AsyncCheckpointer:
    """Background snapshots: fork the device->host copy off the training
    step, serialize + fsync + commit on a writer thread.

    The training thread pays only :meth:`save`'s staging cost.  A CUDA
    leaf is cloned on the current stream (the next step updates the live
    buffers in place, since the compile engine hands back aliases of its
    state, so the snapshot must own its own copy, ordered after the step
    that produced it), and the clone is copied into pinned host memory
    on a side stream behind an event; neither waits for the card.  The
    writer thread waits on the events, frees the clones, and commits
    through ``CheckpointManager.save``: ONE commit protocol for sync and
    async paths.

    The host buffers come from a :class:`PinnedPool` the checkpointer
    keeps: one set per in-flight snapshot, reused by the next, so a
    state's snapshots after the first allocate no host memory;
    :meth:`reserve` allocates the sets from a template state up front,
    so the first does not either.

    In-flight snapshots are bounded by ``max_in_flight`` (which also
    bounds the extra device memory to that many copies of the state): a
    save request finding the bound exhausted BLOCKS (backpressure;
    ``checkpoint_metrics.backpressure_waits`` counts it).  Writer-side
    failures are kept on the per-snapshot handle AND re-raised by the
    next :meth:`wait_until_finished`."""

    def __init__(self, manager: CheckpointManager, max_in_flight: int = 2):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self.manager = manager
        self.max_in_flight = max_in_flight
        self._sem = threading.BoundedSemaphore(max_in_flight)
        self._q: "queue.Queue" = queue.Queue()
        self._pending: List[SnapshotHandle] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._streams: Dict[torch.device, Any] = {}
        self.pool = PinnedPool()

    def reserve(self, template: PyTree) -> int:
        """Allocate the host buffers of ``max_in_flight`` snapshots of
        ``template`` (a state of the shapes and dtypes the saves will
        stage) now, before training, instead of on the training thread
        at the first save.  Returns the bytes the pool holds."""
        leaves = [x for x in tree_leaves(template)
                  if isinstance(x, torch.Tensor)]
        sets = [self.pool.take() for _ in range(self.max_in_flight)]
        for bufset in sets:
            self.pool.buffers(bufset, leaves)
        for bufset in sets:
            self.pool.give(bufset)
        return self.pool.nbytes

    # -- staging (training thread) ------------------------------------------
    def _side_stream(self, dev: torch.device):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def _stage(self, tree: PyTree) -> Tuple[_Staged, int]:
        """Decouple the snapshot from live buffers: a CUDA tensor is
        cloned on the current stream (after the step that wrote it),
        then each device's side stream waits for all the clones and
        copies them into the pool's pinned buffers; a host tensor is
        copied into a pool buffer, a numpy array gets a host copy.
        Returns (staged, nbytes)."""
        nbytes = [0]
        clones: List[torch.Tensor] = []
        hosts_in: List[torch.Tensor] = []

        def clone(leaf):
            if isinstance(leaf, torch.Tensor):
                nbytes[0] += leaf.numel() * leaf.element_size()
                if leaf.device.type == "cuda":
                    c = leaf.detach().clone()
                    clones.append(c)
                    return c
                hosts_in.append(leaf)
                return leaf
            if isinstance(leaf, np.ndarray):
                c = np.array(leaf)
                nbytes[0] += c.nbytes
                return c
            return leaf
        cloned = tree_map(clone, tree)
        bufset = self.pool.take()
        try:
            bufs = self.pool.buffers(bufset, hosts_in + clones)
        except BaseException:
            self.pool.give(bufset)
            raise
        hosts: Dict[int, torch.Tensor] = {}
        for leaf, h in zip(hosts_in, bufs):
            h.copy_(leaf.detach())
            hosts[id(leaf)] = h
        events = []
        dev_bufs = bufs[len(hosts_in):]
        for dev in {c.device for c in clones}:
            side = self._side_stream(dev)
            # after EVERY clone: a copy may not read a clone in flight
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for c, h in zip(clones, dev_bufs):
                    if c.device != dev:
                        continue
                    h.copy_(c, non_blocking=True)
                    c.record_stream(side)
                    hosts[id(c)] = h
            ev = torch.cuda.Event()
            ev.record(side)
            events.append(ev)
        host = tree_map(lambda x: hosts.get(id(x), x)
                        if isinstance(x, torch.Tensor) else x, cloned)
        return _Staged(host, clones, events, bufset), nbytes[0]

    def save(self, step: int, tree: PyTree,
             meta: Optional[Dict] = None) -> SnapshotHandle:
        from deeplearning4j_tpu_torch.runtime.metrics import (
            checkpoint_metrics)

        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncCheckpointer is closed")
        t_req = time.perf_counter()
        if not self._sem.acquire(blocking=False):
            checkpoint_metrics.note("backpressure_waits")
            self._sem.acquire()
        try:
            staged, nbytes = self._stage(tree)
        except BaseException:
            # a failed staging copy (e.g. device OOM) never reaches the
            # writer's release
            self._sem.release()
            raise
        checkpoint_metrics.note_staged(
            nbytes, (time.perf_counter() - t_req) * 1e3)
        handle = SnapshotHandle(step)
        with self._lock:
            # re-check + enqueue atomically with the closed flag, so no
            # job lands behind the writer's stop sentinel
            if self._closed:
                self._sem.release()
                checkpoint_metrics.note_commit_failed()
                raise RuntimeError("AsyncCheckpointer is closed")
            self._pending.append(handle)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._writer, name="ckpt-writer", daemon=True)
                self._thread.start()
            # unbounded queue (bounded upstream by the semaphore): put()
            # never blocks; under the lock to order against close()
            self._q.put((handle, staged, meta, t_req))
        return handle

    # -- writer thread ------------------------------------------------------
    def _writer(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            handle, staged, meta, t_req = job
            try:
                host = staged.wait()
                handle.path = self.manager.save(
                    handle.step, host, meta, _t_req=t_req, _was_async=True)
            except BaseException as e:  # noqa: BLE001 — kept on handle
                from deeplearning4j_tpu_torch.runtime.metrics import (
                    checkpoint_metrics)
                handle.error = e
                checkpoint_metrics.note_commit_failed()
                log.error("async checkpoint for step %d failed: %s: %s",
                          handle.step, type(e).__name__, e)
            finally:
                # the commit has read the host buffers: the next snapshot
                # may reuse them
                self.pool.give(staged.bufset)
                del staged
                host = None
                self._sem.release()
                handle._done.set()

    # -- synchronization ----------------------------------------------------
    def wait_until_finished(self, timeout: Optional[float] = None) -> None:
        """Block until every requested snapshot is committed; raises the
        first writer-side error seen (each error raises once).
        ``timeout`` is an OVERALL deadline across all pending snapshots."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._lock:
            pending, self._pending = self._pending, []
        err: Optional[BaseException] = None
        for h in pending:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if not h._done.wait(remaining):
                with self._lock:
                    # re-queue the unfinished AND the errored handles, so
                    # a seen writer error still raises next call
                    self._pending.extend(
                        x for x in pending
                        if not x.done() or x.error is not None)
                raise TimeoutError(
                    f"snapshot for step {h.step} not committed within "
                    f"{timeout}s")
            if err is None and h.error is not None:
                err = h.error
        if err is not None:
            raise err

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain and stop the writer thread (idempotent); the writer
        stops even when the drain raises."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self.wait_until_finished(timeout)
        finally:
            if self._thread is not None:
                self._q.put(None)
                self._thread.join(timeout)

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class ModelSaver:
    """DefaultModelSaver parity: save to a fixed path, rotating the previous
    file to ``<path>.<millis>`` (DefaultModelSaver.java:66-80)."""

    def __init__(self, path: str):
        self.path = path

    def save(self, tree: PyTree, meta: Optional[Dict] = None) -> None:
        if os.path.exists(self.path):
            stamp = int(time.time() * 1000)
            os.replace(self.path, f"{self.path}.{stamp}")
            if os.path.exists(self.path + ".json"):
                os.replace(self.path + ".json", f"{self.path}.{stamp}.json")
        save_pytree(self.path, tree, meta)

    def load(self, like: Optional[PyTree] = None) -> Tuple[PyTree, Dict]:
        return load_pytree(self.path, like)


# -- MultiLayerNetwork portability (conf JSON + flat params, ctor :93-97) ---

def save_model(path: str, net) -> None:
    """conf JSON + flat fp32 param vector: the reference's portable
    format, which either package loads."""
    flat = net.params_flat().detach().float().cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".conf.json", "w") as f:
        f.write(net.conf.to_json())
    np.save(path + ".params.npy", flat)


def load_model(path: str, device=None):
    """The network :func:`save_model` (of either package) wrote, on
    ``device`` (None = CUDA)."""
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    with open(path + ".conf.json") as f:
        conf = MultiLayerConfiguration.from_json(f.read())
    net = MultiLayerNetwork(conf, device=device)
    net.init()
    net.set_params_flat(torch.from_numpy(np.load(path + ".params.npy")))
    return net


class OrbaxCheckpointManager:
    """The reference's Orbax-backed manager (:1015).  Its counterpart for
    sharded state is ``torch.distributed.checkpoint``, which comes with
    the sharded fit: ROADMAP A7."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        raise _not_ported("OrbaxCheckpointManager (torch.distributed."
                          "checkpoint)")
