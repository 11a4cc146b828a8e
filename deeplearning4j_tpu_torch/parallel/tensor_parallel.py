"""The model axis's collectives: tensor parallelism written out by hand.

This module has no file counterpart in ``deeplearning4j_tpu/``.  The
reference writes one global-view step, lays its params out with
``PartitionSpec`` s (``models/transformer.param_specs``) and lets XLA's
GSPMD partitioner insert the collectives the layout implies.  PyTorch has
no such partitioner, so the port runs the SPMD program explicitly, one
process a rank, and this module holds the collectives GSPMD would have
inserted on the ``model`` axis, in the standard (Megatron) layout:

- :func:`copy_to_model`: identity forward, sum over ``model`` backward,
  at the input of a column-parallel product (``wq``/``wk``/``wv`` split
  on heads, ``w1`` on the ffn axis, BERT's MLM transform);
- :func:`reduce_from_model`: sum over ``model`` forward, identity
  backward, after a row-parallel product (``wo``, ``w2``);
- :func:`gather_last`: the shards of a column-parallel output
  concatenated on the last axis (backward: this rank's slice), for the
  vocab-sharded logits and BERT's transform output;
- :func:`vocab_embed`: the lookup in a vocab-sharded table, a masked
  local lookup summed over ``model``.

With these at their places every replicated leaf gets the same gradient
on every model rank, so only the data axis all-reduces gradients.

The specs themselves (:class:`PartitionSpec`) and :func:`shard_tree` /
:func:`gather_tree` (this rank's slice of a global tree, and the global
tree back, over the ``model``, ``pipe`` and ``expert`` axes) live here
too: a stacked ``[n_layers, ...]`` leaf with a leading ``pipe`` entry
is split into the contiguous layers of each stage, the port's
counterpart of the reference's ``pipeline.stage_param_sharding``.  The model code takes a rank's group as
``tp=`` (a :class:`ModelGroup`, None on a model axis of one), in
training and decoding alike.

The collectives themselves are ``parallel/collectives``' over the model
axis's group (the contiguous copy included), booked there with every
other collective (:data:`stats` and :func:`timed` are
``collectives``').  Under gloo the collectives take CUDA tensors
directly (gloo copies them through host memory itself); nothing here
stages them.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel.mesh import (EXPERT_AXIS, MODEL_AXIS,
                                                    PIPE_AXIS)

Tensor = torch.Tensor
PyTree = Any


class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec``: one entry a
    dimension, an axis name or None (replicated along it)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


class ModelGroup:
    """The model axis of one rank: its process group, size and index."""

    __slots__ = ("group", "size", "rank", "backend")

    def __init__(self, group, size: int, rank: int, backend: str):
        self.group = group
        self.size = int(size)
        self.rank = int(rank)
        self.backend = backend

    def __repr__(self) -> str:
        return (f"ModelGroup(size={self.size}, rank={self.rank}, "
                f"backend={self.backend})")


def model_group(mesh) -> Optional[ModelGroup]:
    """``mesh``'s model axis as a :class:`ModelGroup`; None without a
    mesh or where the axis is this rank alone (``collectives.SELF``):
    the model code then runs no collective at all."""
    return _axis_group(mesh, MODEL_AXIS)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

#: the one count of every collective, re-exported: ``collectives.stats``
stats = collectives.stats
timed = collectives.timed


def _all_reduce(x: Tensor, tp: ModelGroup) -> Tensor:
    """A contiguous copy of ``x`` summed over the model group."""
    return collectives._reduced(x, tp.group)


def max_over_model(x: Tensor, tp: Optional[ModelGroup]) -> Tensor:
    """The elementwise maximum of ``x`` over the model group (not
    differentiable): an int8 KV row's amax over every head."""
    if tp is None:
        return x
    return collectives._reduced(x, tp.group, dist.ReduceOp.MAX)


def _all_gather_last(x: Tensor, tp: ModelGroup) -> Tensor:
    """Every model rank's ``x``, concatenated on the last axis."""
    return torch.cat(collectives._gather(x, tp.group), dim=-1)


# ---------------------------------------------------------------------------
# the autograd functions
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        ctx.width = x.shape[-1]
        return _all_gather_last(x, tp)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g.narrow(-1, ctx.tp.rank * w, w).contiguous(), None


def _differentiable(x: Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def copy_to_model(x: Tensor, tp: Optional[ModelGroup]) -> Tensor:
    """``x`` (replicated over ``model``) at the input of a
    column-parallel product: its gradient is summed over ``model``."""
    if tp is None or not _differentiable(x):
        return x
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: Tensor, tp: Optional[ModelGroup]) -> Tensor:
    """The partial sums of a row-parallel product, summed over
    ``model``."""
    if tp is None:
        return x
    if _differentiable(x):
        return _ReduceFromModel.apply(x, tp)
    return _all_reduce(x, tp)


def gather_last(x: Tensor, tp: Optional[ModelGroup]) -> Tensor:
    """A column-parallel output's shards, concatenated on the last axis
    in model-rank order."""
    if tp is None:
        return x
    if _differentiable(x):
        return _GatherLast.apply(x, tp)
    return _all_gather_last(x, tp)


def vocab_embed(table: Tensor, ids: Tensor,
                tp: Optional[ModelGroup]) -> Tensor:
    """``table[ids]`` for a table of ``vocab / M`` rows a rank (rank
    ``r`` holds rows ``[r V/M, (r+1) V/M)``): the rows this rank holds,
    zeros for the others, summed over ``model``."""
    if tp is None:
        raise ValueError("a vocab slice of the token table is read with "
                         "its model group (tp=)")
    rows = table.shape[0]
    local = ids.long() - tp.rank * rows
    hit = (local >= 0) & (local < rows)
    x = table[torch.where(hit, local, torch.zeros_like(local))]
    x = x * hit[..., None].to(x.dtype)
    return reduce_from_model(x, tp)


# ---------------------------------------------------------------------------
# the layout of a tree
# ---------------------------------------------------------------------------

#: the axes a param spec may split over, and the mesh coordinate of each
_PARAM_AXES = (MODEL_AXIS, PIPE_AXIS, EXPERT_AXIS)


def _split_dims(spec):
    """``[(dim, axis)]``: each dimension a spec splits over ``model``,
    ``pipe`` or ``expert`` (an entry naming one of them, alone or in a
    tuple)."""
    out = []
    for i, a in enumerate(spec):
        names = a if isinstance(a, tuple) else (a,)
        for name in _PARAM_AXES:
            if name in names:
                out.append((i, name))
    return out


def _model_dim(spec) -> Optional[int]:
    """The dimension a spec splits over ``model`` (None: replicated)."""
    for i, name in _split_dims(spec):
        if name == MODEL_AXIS:
            return i
    return None


def _spec_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (dicts and
    tuples; a spec is a leaf)."""
    if is_spec(specs) or specs is None:
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_spec_map(fn, v, s)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_spec_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def _degree(mesh, axis: str) -> int:
    return 1 if mesh is None else int(mesh.shape.get(axis, 1))


def _coord(mesh, axis: str) -> int:
    return 0 if mesh is None else int(mesh.coords.get(axis, 0))


def shard_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """This rank's slice of a global tree laid out by ``specs``: each
    leaf split over ``model`` (``pipe``, ``expert``) takes block
    ``mesh.model_rank`` (``mesh.pipe_rank``, ``mesh.expert_rank``) of its
    split dimension (a copy); every other leaf is returned as it is.  The carry-over of a
    global tree into the sharded layout: ``params_from_numpy`` of the
    JAX params, then this."""

    def one(leaf, spec):
        if spec is None or not isinstance(leaf, torch.Tensor):
            return leaf
        out = leaf
        for d, axis in _split_dims(spec):
            m = _degree(mesh, axis)
            if m == 1:
                continue
            n = out.shape[d]
            if n % m:
                raise ValueError(f"dimension {d} of size {n} does not split "
                                 f"over a {axis} axis of {m} (spec {spec})")
            out = out.narrow(d, _coord(mesh, axis) * (n // m), n // m)
        return out if out is leaf else out.clone()

    return _spec_map(one, tree, specs)


def _axis_group(mesh, axis: str) -> Optional[ModelGroup]:
    """``mesh``'s ``axis`` (``model``, ``pipe`` or ``expert``) as a
    :class:`ModelGroup`; None where it is this rank alone."""
    if mesh is None:
        return None
    group = collectives._group((mesh, axis))
    if group is collectives.SELF:
        return None
    return ModelGroup(group, mesh.shape[axis], _coord(mesh, axis),
                      mesh.backend)


def gather_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """The global tree back from every rank's :func:`shard_tree` slice:
    one all-gather over ``model`` (``pipe``, ``expert``) a split
    dimension (every rank of the group calls it); replicated leaves are
    returned as they are."""
    groups = {axis: _axis_group(mesh, axis) for axis in _PARAM_AXES}

    def one(leaf, spec):
        if spec is None or not isinstance(leaf, torch.Tensor):
            return leaf
        out = leaf
        for d, axis in _split_dims(spec):
            grp = groups[axis]
            if grp is None:
                continue
            x = out.detach().movedim(d, -1)
            out = _all_gather_last(x, grp).movedim(-1, d).contiguous()
        return out

    return _spec_map(one, tree, specs)


def map_specs(fn, specs: PyTree) -> PyTree:
    """``fn(spec)`` over every spec of a spec tree."""
    return _spec_map(lambda _, s: fn(s), specs, specs)


__all__ = ["P", "PartitionSpec", "ModelGroup", "model_group", "stats",
           "timed", "copy_to_model", "reduce_from_model", "gather_last",
           "max_over_model", "vocab_embed", "shard_tree", "gather_tree",
           "map_specs"]
