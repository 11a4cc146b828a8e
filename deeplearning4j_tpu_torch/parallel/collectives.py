"""Collectives over a mesh's axes, on ``torch.distributed``.

Port of ``deeplearning4j_tpu/parallel/collectives.py``.  The reference's
wrappers run inside ``shard_map`` and name the axis; the port has no
ambient axis, so ``axis`` is one of

- a :class:`~deeplearning4j_tpu_torch.parallel.mesh.Mesh`: its data
  axis's process group;
- ``(mesh, name)``: the group of the named axis, ``"data"`` or
  ``"model"``, or of the whole mesh for ``("data", "model")``;
- the string ``"data"``: the default group.

A ``pipe``, ``seq`` or ``expert`` axis raises naming its ROADMAP item
(A7.1b, A7.5).  An axis of size 1 (the model axis of a data-only mesh)
is this rank alone: its collectives return a copy of their input.

Every function runs its collective whatever the group's size: a group
of one rank still calls NCCL (or gloo), so one card exercises the same
calls as many.  Inside a captured step (``runtime/compile_cache``) the
NCCL calls are part of the CUDA graph.

:func:`psum` (and :func:`pmean`, :func:`grad_share`,
:func:`param_average`) take a tensor or a tree of tensors and return new
tensors.  A tensor that requires grad goes through an autograd function
whose backward sums the cotangent over the axis too, as the transpose of
JAX's ``psum``: batch norm's global moments (``nn/layers/extras.
bn_collective``) are differentiated through it.  :func:`all_gather`,
:func:`reduce_scatter`, :func:`ring_permute` and :func:`all_to_all`
compute the reference's tiled results from an all-gather or an
all-reduce, which every backend has; nothing on the training path calls
them.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.ops.updaters import tree_map
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                    check_mesh_axes)

PyTree = Any

#: the group of an axis of size 1: this rank alone
SELF = object()


def _group(axis):
    """The process group of ``axis`` (None = the default group,
    :data:`SELF` = this rank alone)."""
    if isinstance(axis, str):
        if axis != DATA_AXIS:
            raise NotImplementedError(
                f"collectives over the {axis!r} axis by name alone are not "
                f"ported to the PyTorch package (ROADMAP A7.1b): name the "
                f"mesh too, (mesh, {axis!r})")
        return None
    if isinstance(axis, tuple):
        mesh, name = axis
        check_mesh_axes(mesh)
        if name == (DATA_AXIS, MODEL_AXIS):
            return mesh.world
        if name not in (DATA_AXIS, MODEL_AXIS):
            raise NotImplementedError(
                f"collectives over the {name!r} axis are not ported to the "
                f"PyTorch package yet (ROADMAP A7.1b)")
        if mesh.shape[name] == 1:
            return SELF
        return mesh.groups[name]
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
        dist.all_reduce(y, op=op, group=group)
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
    dist.all_gather(parts, x, group=group)
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


def ring_permute(x: torch.Tensor, axis, shift: int = 1) -> torch.Tensor:
    """The ``x`` of rank ``(r - shift) mod n``: each shard sent to its
    ring neighbour ``shift`` ahead."""
    group = _group(axis)
    return _gather(x, group)[(_rank(group) - shift) % _size(group)]


def all_to_all(x: torch.Tensor, axis, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Ulysses-style resharding: ``x`` split into n blocks along
    ``split_axis``, block ``j`` to rank ``j``, the received blocks
    concatenated along ``concat_axis`` in rank order."""
    group = _group(axis)
    n, r = _size(group), _rank(group)
    return torch.cat([torch.chunk(p, n, dim=split_axis)[r]
                      for p in _gather(x, group)], dim=concat_axis)
