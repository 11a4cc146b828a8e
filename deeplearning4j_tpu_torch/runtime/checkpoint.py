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

Sharded state (reference :191-402): :func:`save_pytree_sharded` writes
each rank's pieces of a tree laid out by ``tensor_parallel`` specs in the
reference's format 2, and :func:`load_pytree_sharded` restores each
rank's slice of any layout.  The manager's ``cluster=`` commit protocol
takes that layout for model-sharded state.  :class:`OrbaxCheckpointManager`
keeps the reference's name for its counterpart over
``torch.distributed.checkpoint``.
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


# -- per-rank sharded checkpoints (reference :191-402) -----------------------

def _leaf_specs(tree: PyTree, specs: PyTree, out: List[Any]) -> None:
    """The spec of each leaf of ``tree``, in :func:`_flatten_with_paths`
    order: ``specs`` mirrors the tree down to a ``PartitionSpec`` (or
    None), which covers the whole subtree under it."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import is_spec

    if tree is None:
        return
    if specs is None or is_spec(specs):
        out.extend([specs] * len(_flatten_with_paths(tree)))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _leaf_specs(tree[k], specs[k], out)
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            _leaf_specs(v, s, out)
    else:
        out.append(None)


def _splits(spec, mesh) -> List[Tuple[int, str, int, int]]:
    """``[(dim, axis, degree, coordinate)]``: each dimension ``spec``
    splits over an axis of ``mesh`` above 1 (``model``, ``pipe`` or
    ``expert``, as ``tensor_parallel.shard_tree`` splits them)."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import \
        _split_dims

    if spec is None or mesh is None:
        return []
    out = []
    for d, axis in _split_dims(spec):
        n = int(mesh.shape.get(axis, 1))
        if n > 1:
            out.append((d, axis, n, int(mesh.coords.get(axis, 0))))
    return out


def _dtype_name(leaf) -> str:
    """The saved dtype's name, as numpy names JAX's (``bfloat16`` for
    bf16, whose pieces are raw two-byte records)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _np_dtype(name: str) -> np.dtype:
    return _BF16_NP if name == "bfloat16" else np.dtype(name)


def _writes_replica(spec, mesh) -> bool:
    """Whether this rank writes its piece of a leaf laid out by ``spec``:
    the reference's ``replica_id == 0``, the rank whose index is 0 on
    every axis above 1 that does not split the leaf."""
    from deeplearning4j_tpu_torch.parallel.mesh import ALL_AXES

    split = {axis for _, axis, _, _ in _splits(spec, mesh)}
    return all(int(mesh.coords.get(a, 0)) == 0 for a in ALL_AXES
               if a not in split and int(mesh.shape.get(a, 1)) > 1)


def save_pytree_sharded(path: str, tree: PyTree,
                        meta: Optional[Dict] = None, *,
                        mesh=None, specs: PyTree = None,
                        sync: bool = True,
                        process_index: Optional[int] = None,
                        process_count: Optional[int] = None,
                        writers: Optional[Sequence[int]] = None,
                        write_index: Optional[bool] = None
                        ) -> Dict[str, Dict]:
    """Per-rank shard save: each rank writes only the pieces it holds,
    so no rank gathers a model-sharded tree.  The layout is the
    reference's, so either package restores the other's: ``path`` is a
    directory with ``index.json`` (``"format": 2``, the tree's paths,
    global shapes and dtypes, ``n_procs``, ``writers``, meta, written by
    the first writer) and, per writer ``k``, ``shards_p<k>.npz`` with a
    ``shards_p<k>.json`` piece table (``{"leaf", "start", "shape"}``:
    each piece's global offset).

    ``tree`` is this rank's share: with ``mesh`` and ``specs`` (a spec
    tree as ``tensor_parallel.shard_tree`` takes) a leaf split over
    ``model``, ``pipe`` or ``expert`` is this rank's block of the global
    leaf; replicas are written once, by the rank whose index is 0 on
    every other axis of the mesh above 1 (the reference's ``replica_id
    == 0``).  A leaf with no split (and every leaf without a mesh) is
    written whole by the first writer.

    ``sync=False`` skips the trailing barrier over the mesh's ranks (the
    manager's cluster commit barriers on its control plane instead);
    ``process_index`` (default: this process's global rank), ``writers``
    (default: ``range(process_count)`` or the group's ranks) and
    ``write_index`` let a shrunk cluster name its files and index.
    Returns ``{filename: {"crc32", "bytes"}}`` for the files this rank
    wrote."""
    import torch.distributed as dist

    items = _flatten_with_paths(tree)
    leaf_specs: List[Any] = []
    _leaf_specs(tree, specs, leaf_specs)
    up = dist.is_available() and dist.is_initialized()
    pid = (process_index if process_index is not None
           else dist.get_rank() if up else 0)
    if writers is not None:
        writers = sorted(int(w) for w in writers)
    else:
        n = process_count if process_count is not None else (
            dist.get_world_size() if up else 1)
        writers = list(range(n))
    if write_index is None:
        write_index = pid == writers[0]
    os.makedirs(path, exist_ok=True)
    pieces: Dict[str, np.ndarray] = {}
    table: Dict[str, Dict] = {}
    shapes = []
    for i, ((_, leaf), spec) in enumerate(zip(items, leaf_specs)):
        split = (_splits(spec, mesh) if isinstance(leaf, torch.Tensor)
                 else [])
        shape = list(np.shape(leaf) if not isinstance(leaf, torch.Tensor)
                     else leaf.shape)
        start = [0] * len(shape)
        for d, _, n, c in split:
            start[d] = c * shape[d]
            shape[d] *= n
        shapes.append(shape)
        mine = (_writes_replica(spec, mesh) if split
                else pid == writers[0])
        if mine:
            data = _to_numpy(leaf)
            pieces[f"l{i}_s0"] = data
            table[f"l{i}_s0"] = {"leaf": i, "start": start,
                                 "shape": list(data.shape)}

    files: Dict[str, Dict] = {}

    def commit(write_fn, name: str) -> None:
        # save_pytree's tmp + fsync + replace + crc re-read: the table is
        # the manifest input of the cluster commit
        dst = os.path.join(path, name)
        tmp = dst + ".tmp"
        with open(tmp, "wb") as f:
            write_fn(f)
        crc, size = _crc32_file(tmp)
        _replace_with_fsync(tmp, dst)
        files[name] = {"crc32": crc, "bytes": size}

    commit(lambda f: f.write(json.dumps(table).encode()),
           f"shards_p{pid}.json")
    commit(lambda f: np.savez(f, **pieces), f"shards_p{pid}.npz")
    if write_index:
        index = {
            "format": 2,
            "paths": [p for p, _ in items],
            "shapes": shapes,
            "dtypes": [_dtype_name(leaf) for _, leaf in items],
            "n_procs": len(writers),
            "writers": writers,
            "meta": meta or {},
        }
        commit(lambda f: f.write(json.dumps(index, indent=1).encode()),
               "index.json")
    if sync and up and dist.get_world_size() > 1:
        dist.barrier(group=None if mesh is None else mesh.world)
    return files


def _assemble(target_index, shape, dtype, pieces):
    """The slice ``target_index`` (a tuple of slices over the global
    array) materialized from whatever saved pieces overlap it;
    ``pieces`` = ``[(start, shape, load_fn)]`` for this leaf."""
    starts = [0 if s.start is None else int(s.start) for s in target_index]
    stops = [shape[d] if s.stop is None else int(s.stop)
             for d, s in enumerate(target_index)]
    out = np.zeros([b - a for a, b in zip(starts, stops)], dtype)
    for p_start, p_shape, load in pieces:
        lo = [max(a, pa) for a, pa in zip(starts, p_start)]
        hi = [min(b, pa + ps) for b, pa, ps in zip(stops, p_start, p_shape)]
        if any(l_ >= h for l_, h in zip(lo, hi)):
            continue
        dst = tuple(slice(l_ - a, h - a) for l_, h, a in zip(lo, hi, starts))
        src = tuple(slice(l_ - pa, h - pa)
                    for l_, h, pa in zip(lo, hi, p_start))
        out[dst] = load()[src]
    return out


def _restore_leaves(paths, shapes, dtypes, leaf_pieces, like, mesh, specs):
    """``like``'s leaves read from saved pieces: each leaf split by its
    spec over ``mesh`` gets this rank's block only; every other leaf is
    assembled whole.  Each takes its template leaf's kind, dtype and
    device."""
    tpl_items = _flatten_with_paths(like)
    if [p for p, _ in tpl_items] != list(paths):
        raise StructureMismatchError(
            "checkpoint structure mismatch:\n saved: "
            f"{list(paths)[:5]}...\n template: "
            f"{[p for p, _ in tpl_items][:5]}...")
    leaf_specs: List[Any] = []
    _leaf_specs(like, specs, leaf_specs)
    out = []
    for i, ((_, tpl), spec) in enumerate(zip(tpl_items, leaf_specs)):
        idx = [slice(0, s) for s in shapes[i]]
        if isinstance(tpl, torch.Tensor):
            for d, _, n, c in _splits(spec, mesh):
                block = shapes[i][d] // n
                idx[d] = slice(c * block, (c + 1) * block)
        arr = _assemble(tuple(idx), shapes[i], dtypes[i],
                        leaf_pieces.get(i, []))
        out.append(_from_numpy(arr, tpl))
    return out


def load_pytree_sharded(path: str, like: Optional[PyTree] = None, *,
                        mesh=None, specs: PyTree = None
                        ) -> Tuple[PyTree, Dict]:
    """Restore a :func:`save_pytree_sharded` checkpoint (of either
    package).  With ``like`` (the TARGET layout: with ``mesh`` and
    ``specs`` each template leaf is this rank's block, else the global
    leaf) each rank assembles only the slices it holds, so the saving
    layout and the restoring one may differ (restore with resharding);
    leaves take the template's dtype and device.  Without ``like``, full
    numpy arrays come back as nested dicts (a bf16 leaf as raw two-byte
    records, ``np.dtype("V2")``).

    Refused, as in the reference: a writer's missing file
    (``FileNotFoundError``), and pieces that do not cover a leaf
    (``ValueError``)."""
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    # read exactly the files this save's writers wrote: a missing one is
    # a hard error, and stale files of an earlier, wider save are ignored
    writer_ids = index.get("writers",
                           list(range(index.get("n_procs", 1))))
    files = [os.path.join(path, f"shards_p{k}.json") for k in writer_ids]
    missing = [f for f in files if not os.path.exists(f)]
    if missing:
        raise FileNotFoundError(
            f"sharded checkpoint at {path} is incomplete: expected "
            f"{len(writer_ids)} per-process shard files, "
            f"missing {missing}")
    leaf_pieces: Dict[int, list] = {}
    opened = []
    try:
        for tf in files:
            data = np.load(tf[:-len(".json")] + ".npz")
            opened.append(data)
            with open(tf) as f:
                table = json.load(f)
            for key, info in table.items():
                leaf_pieces.setdefault(info["leaf"], []).append(
                    (info["start"], info["shape"],
                     (lambda d=data, k=key: d[k])))
        paths, shapes = index["paths"], index["shapes"]
        dtypes = [_np_dtype(d) for d in index["dtypes"]]
        # the pieces must tile each leaf (disjoint by construction, so
        # coverage is the sum of their volumes): a truncated table would
        # otherwise restore its missing regions as zeros
        for i, shp in enumerate(shapes):
            total = int(np.prod(shp)) if shp else 1
            got = sum(int(np.prod(ps)) for _, ps, _ in
                      leaf_pieces.get(i, []))
            if got != total:
                raise ValueError(
                    f"sharded checkpoint at {path} has incomplete "
                    f"coverage for leaf {paths[i]!r}: pieces cover {got} "
                    f"of {total} elements (truncated piece table?)")
        if like is None:
            root: Dict[str, Any] = {}
            for i, p in enumerate(paths):
                node = root
                parts = p.split(_SEP)
                for seg in parts[:-1]:
                    node = node.setdefault(seg, {})
                node[parts[-1]] = _assemble(
                    tuple(slice(0, s) for s in shapes[i]), shapes[i],
                    dtypes[i], leaf_pieces.get(i, []))
            return root, index["meta"]
        leaves = _restore_leaves(paths, shapes, dtypes, leaf_pieces, like,
                                 mesh, specs)
        return _unflatten_like(like, leaves), index["meta"]
    finally:
        for data in opened:
            data.close()


def _load_npz_into(path: str, like: PyTree, mesh, specs
                   ) -> Tuple[PyTree, Dict]:
    """A :func:`save_pytree` file restored into templates laid out by
    ``specs`` over ``mesh`` (each rank's block of a split leaf): the
    file as one writer's pieces, each covering its whole leaf."""
    with open(path + ".json") as f:
        sidecar = json.load(f)
    with np.load(path) as data:
        arrs = [data[f"a{i}"] for i in range(len(sidecar["paths"]))]
    pieces = {i: [([0] * a.ndim, list(a.shape), (lambda a=a: a))]
              for i, a in enumerate(arrs)}
    leaves = _restore_leaves(sidecar["paths"], [list(a.shape) for a in arrs],
                             [a.dtype for a in arrs], pieces, like, mesh,
                             specs)
    return _unflatten_like(like, leaves), sidecar["meta"]


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

    Cluster commits (``cluster=`` a ``parallel.multihost.Cluster`` of
    more than one member, reference :405-750): a snapshot is committed
    only once every member's data files are durable.  Data files first
    on every member, one control-plane barrier, the manifest (with a
    ``cluster`` block) written last by the coordinator, a second barrier
    so no member reports a commit before the manifest exists.  Two
    layouts, chosen per save:

    - *replicated* (no leaf split over ranks): the coordinator alone
      writes the one state every member holds, through ``save_pytree``;
    - *sharded* (:meth:`set_layout` names a mesh and specs that split a
      leaf over ranks): each member writes its own pieces into
      ``ckpt_<step>.shards/`` (:func:`save_pytree_sharded`) and
      publishes their crc table over the control plane; the coordinator
      merges the tables into the manifest.  A restore reads each rank's
      slice only, on any mesh shape (:func:`load_pytree_sharded`).

    The barriers ride the cluster's key-value store, not the mesh's
    collectives: they work from the async writer's thread and for the
    survivors of a host loss (a silent member raises
    ``ClusterSyncTimeout``).  A single-member cluster (and
    ``cluster=None``) keeps the single-process path."""

    _PAT = re.compile(r"ckpt_(\d+)\.npz$")
    _PAT_SHARDS = re.compile(r"ckpt_(\d+)\.shards$")

    def __init__(self, directory: str, max_to_keep: int = 3,
                 cluster=None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.cluster = cluster
        #: the layout of the trees this manager saves and restores under
        #: a cluster (:meth:`set_layout`): None = global trees
        self.mesh = None
        self.specs = None
        self._save_seq = 0
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

    def set_layout(self, mesh, specs: PyTree) -> None:
        """Trees this manager saves (under a cluster) and restores are
        laid out by ``specs`` over ``mesh``: each rank's leaves are its
        blocks of the split ones (``tensor_parallel.shard_tree``).
        ``mesh=None`` (or no split) means global trees."""
        self.mesh, self.specs = mesh, specs

    @property
    def _multi(self) -> bool:
        return (self.cluster is not None
                and self.cluster.process_count > 1)

    def _needs_shards(self) -> bool:
        """Whether the layout splits a leaf over ranks: such state is
        serialized piecewise (no rank holds it whole)."""
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import \
            map_specs

        if self.mesh is None or self.specs is None:
            return False
        found = []
        map_specs(lambda s: found.append(bool(_splits(s, self.mesh))),
                  self.specs)
        return any(found)

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
        if self._multi:
            files = self._save_cluster(step, tree, meta)
        else:
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

    def _commit_manifest(self, step: int, files: Dict[str, Dict],
                         cluster_info: Optional[Dict] = None) -> None:
        manifest = {"format": 1, "step": step, "files": files}
        if cluster_info:
            manifest["cluster"] = cluster_info
        man_tmp = self._manifest_path(step) + ".tmp"
        with open(man_tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        _replace_with_fsync(man_tmp, self._manifest_path(step))

    def _save_cluster(self, step: int, tree: PyTree,
                      meta: Dict) -> Dict[str, Dict]:
        """The cluster-commit protocol (class docstring), in the
        reference's order.  Barrier tags carry a per-manager save number:
        every member makes the same saves in the same order."""
        from deeplearning4j_tpu_torch.runtime.metrics import (
            multihost_metrics)

        cl = self.cluster
        self._save_seq += 1
        seq = self._save_seq
        if self._needs_shards():
            sdir = self._shards_dir(step)
            mine = save_pytree_sharded(
                sdir, tree, meta, mesh=self.mesh, specs=self.specs,
                sync=False, process_index=cl.process_id,
                writers=cl.members, write_index=cl.is_coordinator)
            rel = os.path.basename(sdir)
            mine = {f"{rel}/{k}": v for k, v in mine.items()}
            tables = cl.gather(json.dumps(mine), f"ckptcrc_{seq}")
            files: Dict[str, Dict] = {}
            if cl.is_coordinator:
                for blob in tables.values():
                    files.update(json.loads(blob))
            layout = "sharded"
        else:
            # one state every member holds: the coordinator writes it
            files = (save_pytree(self._path(step), tree, meta)
                     if cl.is_coordinator else {})
            layout = "replicated"
        cl.barrier(f"ckpt_data_{seq}")
        if cl.is_coordinator:
            self._commit_manifest(step, files, cluster_info={
                "layout": layout, "members": list(cl.members),
                "coordinator": cl.coordinator})
        cl.barrier(f"ckpt_commit_{seq}")
        multihost_metrics.note("cluster_commits")
        if cl.is_coordinator:
            self._gc()
        else:
            # the committed manifest's files: what the cluster wrote
            try:
                with open(self._manifest_path(step)) as f:
                    files = json.load(f)["files"]
            except OSError:
                files = {}
        return files

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
                if isinstance(e, StructureMismatchError):
                    # a caller bug (a renamed layer): every step would
                    # fail the same way
                    raise
                last_err = e
                log.warning("checkpoint step %d unrestorable (%s: %s); "
                            "falling back", s, type(e).__name__, e)
        raise CorruptCheckpointError(
            f"no restorable checkpoint in {self.directory} "
            f"(tried steps {desc})") from last_err

    def _load_snapshot(self, step: int, like: Optional[PyTree]
                       ) -> Tuple[PyTree, Dict]:
        """Either layout, whichever this step was written as (both can
        sit in one directory across a cluster shrink); templates in the
        manager's layout (:meth:`set_layout`) get each rank's slice."""
        sharded = self.mesh is not None and self._needs_shards()
        if os.path.exists(self._path(step)):
            if like is not None and sharded:
                return _load_npz_into(self._path(step), like, self.mesh,
                                      self.specs)
            return load_pytree(self._path(step), like)
        if os.path.isdir(self._shards_dir(step)):
            if sharded:
                return load_pytree_sharded(self._shards_dir(step), like,
                                           mesh=self.mesh, specs=self.specs)
            return load_pytree_sharded(self._shards_dir(step), like)
        raise FileNotFoundError(
            f"no checkpoint files for step {step} in {self.directory}")

    def _gc(self) -> None:
        """Retention sweep; tolerates concurrently deleted files.  In a
        cluster only the coordinator sweeps (the shared filesystem makes
        its sweep everyone's)."""
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
    """The counterpart of the reference's Orbax-backed manager
    (:1015-1073): the same surface (``save``, ``all_steps``,
    ``latest_step``, ``restore(like=)`` with the meta, ``close``) over
    ``torch.distributed.checkpoint`` (DCP).  A step is the directory
    ``<dir>/<step>`` (DCP's ``.metadata`` and one ``.distcp`` file a
    rank) with the meta beside it in ``meta.json``; the state dict's keys
    are the tree's paths.

    With ``mesh`` and ``specs`` (as ``tensor_parallel.shard_tree`` takes
    them) a leaf split over ranks enters the state dict as a DTensor over
    the mesh (placements from its spec), so each rank writes only its
    block and a replica is written once; a restore reads the blocks the
    template's layout needs (restore with resharding), and a restore
    with ``mesh=None`` assembles global tensors.  Every rank of the
    mesh (of the default group without one) calls ``save`` and
    ``restore``."""

    _META = "meta.json"

    def __init__(self, directory: str, max_to_keep: int = 3, *,
                 mesh=None, specs: PyTree = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh, self.specs = mesh, specs
        self._dmesh = None
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _group(self):
        return None if self.mesh is None else self.mesh.world

    def _lead(self) -> bool:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return True
        return dist.get_rank(self._group()) == 0

    def _barrier(self) -> None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.barrier(group=self._group())

    def _device_mesh(self, device_type: str):
        """The mesh as a DTensor ``DeviceMesh`` over its ranks (axes
        ``ALL_AXES``), naming coordinates only: DCP plans over the
        process group, so the device mesh makes no groups."""
        from torch.distributed.device_mesh import DeviceMesh

        from deeplearning4j_tpu_torch.parallel.mesh import ALL_AXES

        if self._dmesh is None or self._dmesh.device_type != device_type:
            grid = torch.tensor(self.mesh.ranks).reshape(
                tuple(self.mesh.shape[a] for a in ALL_AXES))
            self._dmesh = DeviceMesh(device_type, grid,
                                     mesh_dim_names=ALL_AXES,
                                     _init_backend=False)
        return self._dmesh

    def _state_dict(self, tree: PyTree) -> Dict[str, Any]:
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from deeplearning4j_tpu_torch.parallel.mesh import ALL_AXES

        leaf_specs: List[Any] = []
        _leaf_specs(tree, self.specs, leaf_specs)
        out: Dict[str, Any] = {}
        for (path, leaf), spec in zip(_flatten_with_paths(tree),
                                      leaf_specs):
            split = (_splits(spec, self.mesh)
                     if isinstance(leaf, torch.Tensor) else [])
            if not split:
                out[path] = leaf
                continue
            shape = list(leaf.shape)
            place = [Replicate()] * len(ALL_AXES)
            for d, axis, n, _ in split:
                shape[d] *= n
                place[ALL_AXES.index(axis)] = Shard(d)
            stride = torch.empty(shape, device="meta").stride()
            out[path] = DTensor.from_local(
                leaf.detach().contiguous(),
                self._device_mesh(leaf.device.type), place,
                run_check=False, shape=torch.Size(shape), stride=stride)
        return out

    def save(self, step: int, tree: PyTree,
             meta: Optional[Dict] = None) -> None:
        import torch.distributed.checkpoint as dcp

        d = self._step_dir(step)
        dcp.save(self._state_dict(tree), checkpoint_id=d,
                 process_group=self._group())
        if self._lead():
            tmp = os.path.join(d, self._META + ".tmp")
            with open(tmp, "w") as f:
                json.dump(meta or {}, f)
            _replace_with_fsync(tmp, os.path.join(d, self._META))
            steps = self.all_steps()
            for s in steps[:-self.max_to_keep] if self.max_to_keep > 0 \
                    else []:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
        self._barrier()

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, ".metadata")))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                like: Optional[PyTree] = None) -> Tuple[PyTree, Dict]:
        import torch.distributed.checkpoint as dcp
        from torch.distributed.tensor import DTensor

        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        if like is None:
            # global CPU tensors of the saved sizes, in nested dicts
            md = dcp.FileSystemReader(d).read_metadata()
            sd = {k: (torch.empty(v.size, dtype=v.properties.dtype)
                      if hasattr(v, "size") else None)
                  for k, v in md.state_dict_metadata.items()}
            dcp.load(sd, checkpoint_id=d, process_group=self._group())
            tree: Any = {}
            for k, v in sd.items():
                node = tree
                parts = k.split(_SEP)
                for seg in parts[:-1]:
                    node = node.setdefault(seg, {})
                node[parts[-1]] = v
        else:
            sd = self._state_dict(tree_map(
                lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                like))
            dcp.load(sd, checkpoint_id=d, process_group=self._group())
            vals = [v.to_local() if isinstance(v, DTensor) else v
                    for v in sd.values()]
            tree = _unflatten_like(like, vals)
        with open(os.path.join(d, self._META)) as f:
            meta = json.load(f)
        return tree, meta

    def close(self) -> None:
        """Nothing to release: every save is complete when it returns."""
