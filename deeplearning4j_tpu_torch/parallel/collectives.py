"""Collectives over a mesh's axes, on ``torch.distributed``.

Port of ``deeplearning4j_tpu/parallel/collectives.py``.  The reference's
wrappers run inside ``shard_map`` and name the axis; the port has no
ambient axis, so ``axis`` is one of

- a :class:`~deeplearning4j_tpu_torch.parallel.mesh.Mesh`: its data
  axis's process group;
- ``(mesh, name)``: the group of the named axis (any of ``"data"``,
  ``"model"``, ``"pipe"``, ``"seq"``, ``"expert"``), or of a tuple of
  them: the token group for ``("data", "expert")`` (the axes an
  expert-parallel batch and its routing statistics span), the sequence
  group for ``("data", "seq")`` (the axes a sequence-parallel loss sums
  over), the whole mesh for every axis above 1;
- the string ``"data"``: the default group.

An axis of size 1 (the model axis of a data-only mesh) is this rank
alone: its collectives return a copy of their input.

Every function runs its collective whatever the group's size: a group
of one rank still calls NCCL (or gloo), so one card exercises the same
calls as many.  Inside a captured step (``runtime/compile_cache``) the
NCCL calls are part of the CUDA graph.

:func:`psum` (and :func:`pmean`, :func:`grad_share`,
:func:`param_average`) take a tensor or a tree of tensors and return new
tensors.  A tensor that requires grad goes through an autograd function
whose backward sums the cotangent over the axis too, as the transpose of
JAX's ``psum``: batch norm's global moments (``nn/layers/extras.
bn_collective``) are differentiated through it.  :func:`all_gather` and
:func:`reduce_scatter` compute the reference's tiled results from an
all-gather or an all-reduce, which every backend has.
:func:`ring_permute` is ``lax.ppermute``'s ring shift: one send and one
receive a rank (``batch_isend_irecv``), each block moved once, inside an
autograd function whose backward is the shift the other way; the
pipeline's stage-to-stage send (``parallel/pipeline.py``) and ring
attention's K/V rotation (``parallel/ring_attention.py``) ride it.
:func:`all_to_all` is the expert axis's dispatch (and Ulysses
attention's): one ``all_to_all_single`` over contiguous blocks, each
block moved once, inside an autograd function whose backward is the
inverse exchange.

Every collective this module runs on a group of more than one rank is
booked in one place (:func:`_booked`): :data:`stats` counts its calls
and bytes, in all and by kind (:data:`KINDS`), and, under :func:`timed`,
its host seconds after a device synchronize; :func:`issued` counts the
collectives this process started on a group (a model group's ranks are
in step when they started as many).  :func:`claim` gives one thread a
group: another thread's collective on it raises instead of interleaving
with the owner's (a batcher's worker over a model-sharded engine claims
the engine's model group).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.ops.updaters import (tree_leaves, tree_map,
                                                    tree_unflatten)
from deeplearning4j_tpu_torch.parallel.mesh import (ALL_AXES, DATA_AXIS,
                                                    PLANES, check_mesh_axes)

PyTree = Any

#: the group of an axis of size 1: this rank alone
SELF = object()


def _group(axis):
    """The process group of ``axis`` (None = the default group,
    :data:`SELF` = this rank alone)."""
    if isinstance(axis, str):
        if axis != DATA_AXIS:
            raise ValueError(
                f"a collective over the {axis!r} axis by name alone has no "
                f"group in the PyTorch package (it has no ambient axis): "
                f"name the mesh too, (mesh, {axis!r})")
        return None
    if isinstance(axis, tuple):
        mesh, name = axis
        check_mesh_axes(mesh)
        names = name if isinstance(name, tuple) else (name,)
        for a in names:
            if a not in ALL_AXES:
                raise ValueError(f"unknown mesh axis {a!r}: the axes are "
                                 f"{ALL_AXES}")
        # the axes the group really spans: those above 1
        live = tuple(a for a in ALL_AXES
                     if a in names and mesh.shape.get(a, 1) > 1)
        every = tuple(a for a in ALL_AXES if mesh.shape.get(a, 1) > 1)
        if not live:
            return SELF
        if len(live) == 1:
            return mesh.groups[live[0]]
        if live == every:
            return mesh.world
        if live in PLANES:
            return mesh.groups[live]
        raise NotImplementedError(
            f"collectives over the axes {live} of a mesh with axes {every} "
            f"have no group: the mesh makes one an axis, one a plane of "
            f"{PLANES} and the whole mesh's")
    check_mesh_axes(axis)
    return axis.group


def _size(group) -> int:
    return 1 if group is SELF else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is SELF else dist.get_rank(group)


def axis_size(axis) -> int:
    return _size(_group(axis))


def axis_index(axis) -> int:
    """This process's index on the axis."""
    return _rank(_group(axis))


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

#: the kinds of collective :data:`stats` keeps apart
KINDS = ("all_reduce", "all_gather", "all_to_all", "ring_permute")


class _Stats:
    """Calls, bytes sent and (under :func:`timed`) host seconds of every
    collective of this module, process-wide: in all, by kind in
    ``by_kind``, and in ``one_rank`` those on a group of one rank (the
    data axis of ``data=1`` beside another axis still runs its
    collectives)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.timing = False
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0
        self.by_kind = {k: {"calls": 0, "bytes": 0, "seconds": 0.0}
                        for k in KINDS}
        self.one_rank = {"calls": 0, "bytes": 0, "seconds": 0.0}

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            return {"calls": self.calls, "bytes": self.bytes,
                    "seconds": self.seconds,
                    "by_kind": {k: dict(v) for k, v in self.by_kind.items()},
                    "one_rank": dict(self.one_rank)}


stats = _Stats()

#: collectives started on each group, and the thread that holds a group
_issued: Dict[Any, int] = {}
_claims: Dict[Any, threading.Thread] = {}


@contextlib.contextmanager
def timed():
    """Time every collective on the host clock, the device synchronized
    before and after each, into ``stats.seconds`` (the synchronizes cost
    the overlap they remove; use it to measure, not to train)."""
    stats.timing = True
    try:
        yield stats
    finally:
        stats.timing = False


def issued(group) -> int:
    """How many collectives this process has started on ``group``."""
    with stats.lock:
        return _issued.get(group, 0)


def _held_by_other(group, thread: threading.Thread) -> None:
    """Raise when another live thread holds ``group`` (under the lock)."""
    held = _claims.get(group)
    if held is not None and held is not thread and held.is_alive():
        raise RuntimeError(
            f"this process group is held by thread {held.name!r} (a "
            f"batcher's worker over a model-sharded engine): close that "
            f"batcher first, or give this engine a mesh of its own (each "
            f"make_mesh makes fresh groups)")


def claim(group, thread: threading.Thread) -> None:
    """Give ``group`` to ``thread``: a collective on it from any other
    thread raises until :func:`release`.  A group held by another live
    thread raises here."""
    with stats.lock:
        _held_by_other(group, thread)
        _claims[group] = thread


def release(group, thread: threading.Thread) -> None:
    with stats.lock:
        if _claims.get(group) is thread:
            del _claims[group]


def _booked(kind: str, group, ts, fn):
    """``fn()``, a collective of ``kind`` over the tensors ``ts`` (a
    tensor or a list; their bytes are booked) on ``group``, booked in
    :data:`stats` and :func:`issued`."""
    ts = [ts] if isinstance(ts, torch.Tensor) else list(ts)
    with stats.lock:
        _held_by_other(group, threading.current_thread())
        _issued[group] = _issued.get(group, 0) + 1
    timing = stats.timing
    dev = ts[0].device
    sync = timing and dev.type == "cuda"
    if sync:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize(dev)
    n = sum(t.numel() * t.element_size() for t in ts)
    dt = time.perf_counter() - t0 if timing else 0.0
    with stats.lock:
        stats.calls += 1
        stats.bytes += n
        stats.seconds += dt
        for k in ((stats.by_kind[kind], stats.one_rank)
                  if dist.get_world_size(group) == 1
                  else (stats.by_kind[kind],)):
            k["calls"] += 1
            k["bytes"] += n
            k["seconds"] += dt
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangent likewise."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


def _reduced(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A contiguous copy of ``x`` reduced over the group (NCCL takes
    contiguous buffers only; a gradient of a transposed or unbound
    weight may not be one)."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    if group is not SELF:
        _booked("all_reduce", group, y,
                lambda: dist.all_reduce(y, op=op, group=group))
    return y


def _sum_leaf(x: torch.Tensor, group) -> torch.Tensor:
    if x.requires_grad and torch.is_grad_enabled():
        return _AllReduceSum.apply(x, group)
    return _reduced(x, group)


def psum(x, axis):
    """The sum over the axis of a tensor or of every leaf of a tree."""
    group = _group(axis)
    return tree_map(lambda t: _sum_leaf(t, group), x)


def pmean(x, axis):
    """The mean over the axis of a tensor or of every leaf."""
    n = float(axis_size(axis))
    return tree_map(lambda t: t / n, psum(x, axis))


def pmax(x, axis):
    """The elementwise maximum over the axis of a tensor or of every
    leaf (not differentiable)."""
    group = _group(axis)
    return tree_map(lambda t: _reduced(t, group, dist.ReduceOp.MAX), x)


def grad_share(grads: PyTree, axis="data") -> PyTree:
    """Mean-allreduce gradients over the data axis (:19-23): averaging
    gradients each step is the reference's synchronous parameter
    averaging."""
    return pmean(grads, axis)


def param_average(params: PyTree, axis="data") -> PyTree:
    """Mean-allreduce parameters (:26-29): average after local training."""
    return pmean(params, axis)


def _gather(x: torch.Tensor, group) -> list:
    x = x.detach().contiguous()
    if group is SELF:
        return [x.clone()]
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    _booked("all_gather", group, x,
            lambda: dist.all_gather(parts, x, group=group))
    return parts


def all_gather(x: torch.Tensor, axis, *, tiled: bool = True,
               gather_axis: int = 0) -> torch.Tensor:
    """Every rank's ``x``, concatenated (``tiled``) or stacked along
    ``gather_axis`` in rank order."""
    parts = _gather(x, _group(axis))
    if tiled:
        return torch.cat(parts, dim=gather_axis)
    return torch.stack(parts, dim=gather_axis)


def reduce_scatter(x: torch.Tensor, axis, *,
                   scatter_axis: int = 0) -> torch.Tensor:
    """This rank's block of the sum over the axis, split along
    ``scatter_axis`` (the tiled ``psum_scatter``)."""
    group = _group(axis)
    total = _sum_leaf(x, group)
    return torch.chunk(total, _size(group), dim=scatter_axis)[_rank(group)]


def _shift_many(xs, group, shift: int) -> list:
    """The ring shift itself: each tensor of ``xs`` sent to rank ``(r +
    shift) mod n`` and the block of rank ``(r - shift) mod n`` received,
    by one ``isend`` and one ``irecv`` a tensor in one
    ``batch_isend_irecv``, booked once with their bytes.  gloo's
    point-to-point calls take host memory only (unlike its collectives,
    which copy CUDA tensors themselves), so under gloo a CUDA tensor is
    staged through the host and back; NCCL sends from the card."""
    n = _size(group)
    if group is SELF or shift % n == 0:
        return [x.detach().clone() for x in xs]
    dev = xs[0].device
    staged = dev.type != "cpu" and dist.get_backend(group) == "gloo"
    sends = [(x.detach().cpu() if staged else x.detach()).contiguous()
             for x in xs]
    recvs = [torch.empty_like(x) for x in sends]
    r = dist.get_rank(group)
    dst, src = ((r + shift) % n, (r - shift) % n)
    if group is not None:
        dst = dist.get_global_rank(group, dst)
        src = dist.get_global_rank(group, src)

    def run():
        ops = [op for x, y in zip(sends, recvs)
               for op in (dist.P2POp(dist.isend, x, dst, group),
                          dist.P2POp(dist.irecv, y, src, group))]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    _booked("ring_permute", group, xs, run)
    return [y.to(dev) for y in recvs] if staged else recvs


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """One tensor's ring shift (:func:`_shift_many`)."""
    return _shift_many([x], group, shift)[0]


class _RingPermute(torch.autograd.Function):
    """The ring shift of every tensor of a tree at once; the backward
    shifts their cotangents back (``lax.ppermute``'s transpose), again
    in one batch, so a step's shifts run in one order on every rank."""

    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.args = (group, shift)
        out = _shift_many(xs, group, shift)
        ctx.mark_non_differentiable(*(y for y in out
                                      if not y.is_floating_point()))
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        group, shift = ctx.args
        live = [i for i, g in enumerate(gs) if ctx.needs_input_grad[2 + i]]
        back = _shift_many([gs[i] for i in live], group, -shift)
        out = [None] * len(gs)
        for i, g in zip(live, back):
            out[i] = g
        return (None, None, *out)


def ring_permute(x, axis, shift: int = 1):
    """The ``x`` of rank ``(r - shift) mod n``: each shard sent to its
    ring neighbour ``shift`` ahead (:50-55), one send and one receive a
    rank, each block moved once.  ``x`` is a tensor or a tree of them
    (its leaves move in one batch).  Differentiable: the backward is the
    shift by ``-shift``.  Every rank of the axis must call it, and when
    a leaf requires grad on one rank it must on all of them (the
    backward is a collective too)."""
    return _permute(x, _group(axis), shift)


def _permute(x, group, shift: int):
    """:func:`ring_permute` over a resolved group."""
    leaves = tree_leaves(x)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        out = _RingPermute.apply(group, shift, *leaves)
    else:
        out = _shift_many(leaves, group, shift)
    return tree_unflatten(x, list(out)) if not isinstance(
        x, torch.Tensor) else out[0]


def _exchange(x: torch.Tensor, group, split_axis: int,
              concat_axis: int) -> torch.Tensor:
    """The all-to-all itself: ``x`` cut into n contiguous blocks along
    ``split_axis``, block j sent to rank j in one ``all_to_all_single``,
    the n received blocks concatenated along ``concat_axis`` in rank
    order."""
    if group is SELF:
        return x.detach().clone()
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"dimension {split_axis} of size "
                         f"{x.shape[split_axis]} does not split over {n} "
                         f"ranks")
    # [n, s / n, rest...]: block j is send[j], contiguous
    send = x.detach().movedim(split_axis, 0)
    moved = list(send.shape)
    send = send.reshape([n, moved[0] // n] + moved[1:]).contiguous()
    # gloo takes CUDA tensors here itself (through host memory), as it
    # does for its other collectives (chip_smoke.py phase 20 (a))
    recv = torch.empty_like(send)
    _booked("all_to_all", group, send,
            lambda: dist.all_to_all_single(recv, send, group=group))
    # recv[j] is rank j's block for this rank, in the moved layout
    blocks = recv.movedim(1, split_axis + 1)      # [n, *block]
    out = blocks.movedim(0, concat_axis)
    bshape = list(blocks.shape[1:])
    bshape[concat_axis] *= n
    return out.reshape(bshape)


class _AllToAll(torch.autograd.Function):
    """The exchange; the backward is the inverse exchange of the
    cotangent (split along the concatenated axis, concatenate along the
    split one)."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _exchange(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _exchange(g, group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, axis, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """The tiled ``lax.all_to_all``: ``x`` split into n blocks along
    ``split_axis``, block ``j`` to rank ``j``, the received blocks
    concatenated along ``concat_axis`` in rank order.  Each block moves
    once (``all_to_all_single``); differentiable, the backward being the
    inverse all-to-all."""
    group = _group(axis)
    if x.requires_grad and torch.is_grad_enabled():
        return _AllToAll.apply(x, group, split_axis, concat_axis)
    return _exchange(x, group, split_axis, concat_axis)
