"""Pipeline parallelism: the GPipe microbatched SPMD pipeline over a
mesh's ``pipe`` axis.

Port of ``deeplearning4j_tpu/parallel/pipeline.py`` (:1-216).  The net
is split into ``n_stages`` equal stages laid out over the ``pipe``
axis, one a rank; at each tick every rank applies its stage to the
activation it holds, then the activations move one stage on by
``collectives.ring_permute`` (one send and one receive a rank).
Microbatches enter at stage 0 one a tick and leave the last stage after
``n_stages - 1`` ticks of fill: ``n_micro + n_stages - 1`` ticks in all
(the GPipe bubble).  Reverse-mode autograd through the shifts gives the
mirrored backward pipeline, as in the reference: each shift's backward
sends the activation's gradient one stage back.

Where the reference runs one SPMD program under ``shard_map`` and
computes every stage at every tick, the port runs one process a rank and
skips a stage's compute at a tick where it holds no microbatch (the
activation passes through unchanged).  Every rank makes the same shifts
in the same order, forward and backward: each tick's tree of
activations moves in one shift, the stage-0 input is selected with
``torch.where`` (so the shifted state stays in the graph on every rank)
and the last tick's activation is the *anchor* that keeps every rank's
backward walking every shift (:func:`pipeline_forward` hangs it on its
output; a caller of :func:`run_schedule` adds it, times zero, to its
objective).

- :func:`pipeline_forward` (:47-104): the tick loop, the last stage's
  outputs summed over ``pipe`` so every rank returns them (the sum's
  backward is the identity: every rank holds the same loss of them).
- :func:`run_schedule`: the tick loop with the stage-0 input and the
  last stage's outputs left to the caller (``models/lm_fit.CausalLM``
  on a pipe mesh embeds at stage 0 and takes the loss at the last).
- :func:`to_microbatches`, :func:`from_microbatches`,
  :func:`stack_stage_params` and :func:`split_layers_into_stages`
  (:107-126, :196-216), with the reference's errors.
- :func:`make_pipeline_fn` (:129-163): a rank takes its own stage's row
  of the stacked ``[n_stages, ...]`` tree, after the reference's
  leading-dimension check, and its data index's rows of each
  microbatch; the outputs are gathered over ``data``.
- :func:`make_pipeline_train_step` (:166-203), with SGD or one of the
  port's optimizers (``ops/updaters``); the gradients are summed over
  ``pipe`` and ``data``, so every rank takes the same update.

The reference's ``stage_param_sharding`` (:206-210, a ``NamedSharding``
of ``P("pipe")`` on every leaf) has no function here: its counterpart is
the spec ``P("pipe")`` that ``tensor_parallel.shard_tree`` /
``gather_tree`` apply to a stacked tree, each rank holding its stage's
row.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.ops.updaters import (apply_updates, tree_leaves,
                                                   tree_map, tree_unflatten)
from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS

Tensor = torch.Tensor
PyTree = Any
StageFn = Callable[[PyTree, PyTree], PyTree]


class _Tied(torch.autograd.Function):
    """Zeros that depend, for autograd, on ``sources`` (their gradient
    is zero): the start state of a schedule.  Every rank's shifts then
    lie on a path to the caller's grad inputs, so ``torch.autograd.
    grad`` runs each shift's backward on every rank (it skips a node
    that leads to no requested input, and a skipped collective would
    leave its peer waiting)."""

    @staticmethod
    def forward(ctx, like, *sources):
        ctx.sources = [(t.shape, t.dtype, t.device) for t in sources]
        return torch.zeros_like(like)

    @staticmethod
    def backward(ctx, g):
        return (None, *(torch.zeros(shape, dtype=dtype, device=device)
                        for shape, dtype, device in ctx.sources))


def _start_state(like: PyTree, tie: PyTree) -> PyTree:
    """Zeros shaped as ``like``; when grad is on, each floating one is
    tied to ``tie``'s tensors that require grad (or is a leaf requiring
    grad when none does), so every rank's first shift is an autograd
    node on the caller's path."""
    grad = torch.is_grad_enabled()
    sources = [t for t in tree_leaves(tie)
               if isinstance(t, torch.Tensor) and t.requires_grad]

    def start(t):
        if not (grad and t.is_floating_point()):
            return torch.zeros_like(t)
        if sources:
            return _Tied.apply(t, *sources)
        return torch.zeros_like(t).requires_grad_(True)

    return tree_map(start, like)


def run_schedule(stage_fn: Callable[[int, PyTree], PyTree], n_micro: int,
                 axis, inject: Callable[[int], PyTree], like: PyTree,
                 emit: Optional[Callable[[int, PyTree], None]] = None,
                 tie: PyTree = None) -> PyTree:
    """The GPipe tick loop over ``axis`` (e.g. ``(mesh, "pipe")``).
    Tick ``t``: stage ``s`` applies ``stage_fn(i, x)`` to microbatch
    ``i = t - s`` when it is in range (else ``x`` passes through); stage
    0 takes ``inject(t)`` as its input for ``t < n_micro``; the last
    stage hands each output to ``emit(i, y)``; then the tree moves one
    stage on.  ``like`` is a tree shaped as one stage input (the start
    state), ``tie`` the tensors the caller takes gradients of (the
    start state is tied to them, :class:`_Tied`).  Returns the last
    tick's tree, the anchor: a caller whose objective does not reach
    every shift adds ``0 * sum(anchor)`` to it, so every rank's backward
    runs every shift's."""
    group = collectives._group(axis)
    n, s = collectives._size(group), collectives._rank(group)
    state = _start_state(like, tie)
    n_ticks = n_micro + n - 1
    y = state
    for t in range(n_ticks):
        i = t - s
        x = state
        if s == 0 and t < n_micro:
            inj = inject(t)
            yes = torch.ones((), dtype=torch.bool,
                             device=tree_leaves(inj)[0].device)
            x = tree_map(lambda a, b: torch.where(yes, a, b), inj, state)
        valid = 0 <= i < n_micro
        y = stage_fn(i, x) if valid else x
        if valid and s == n - 1 and emit is not None:
            emit(i, y)
        if t < n_ticks - 1 and n > 1:
            state = collectives.ring_permute(y, axis, 1)
    return y


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every rank: forward the sum over the
    pipe group of the outputs (zeros on the other stages); backward the
    identity, since every rank holds the same loss of the same outputs.
    The anchor enters as a second input whose gradient is zero, tying
    every rank's schedule to the outputs' graph."""

    @staticmethod
    def forward(ctx, out, anchor, group):
        ctx.anchor = (anchor.shape, anchor.dtype, anchor.device)
        if group is collectives.SELF:
            return out.detach().clone()
        return collectives._reduced(out, group)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.anchor
        return g, torch.zeros(shape, dtype=dtype, device=device), None


def pipeline_forward(stage_fn: StageFn, stage_params: PyTree,
                     microbatches: PyTree, axis) -> PyTree:
    """SPMD pipelined forward (:47-104): every rank of ``axis`` (e.g.
    ``(mesh, "pipe")``) holds its own ``stage_params`` and the same
    ``microbatches``, a ``[n_micro, mb, ...]`` tensor or a tree of them
    (everything a stage needs that varies by microbatch, e.g. an
    attention mask, rides the ring beside the activations); returns the
    same structure of ``[n_micro, mb, ...]`` outputs, equal on every
    rank.  ``stage_fn(stage_params, x)`` maps its input tree to one of
    the same structure and shapes."""
    group = collectives._group(axis)
    n, s = collectives._size(group), collectives._rank(group)
    n_micro = tree_leaves(microbatches)[0].shape[0]
    outs = [None] * n_micro

    def keep(i, y):
        outs[i] = y

    anchor = run_schedule(lambda i, x: stage_fn(stage_params, x), n_micro,
                          axis, lambda t: tree_map(lambda m: m[t],
                                                   microbatches),
                          tree_map(lambda m: m[0], microbatches), keep,
                          tie=(stage_params, microbatches))
    if s != n - 1:
        outs = [tree_map(torch.zeros_like, tree_map(lambda m: m[0],
                                                    microbatches))] * n_micro
    stacked = tree_map(lambda *ys: torch.stack(ys), *outs)
    tie = sum(a.float().sum() for a in tree_leaves(anchor)
              if a.is_floating_point())
    if not torch.is_grad_enabled() or not tie.requires_grad:
        return tree_map(lambda o: collectives._reduced(o, group)
                        if group is not collectives.SELF else o, stacked)
    return tree_map(lambda o: _FromLast.apply(o, tie, group)
                    if o.is_floating_point()
                    else collectives._reduced(o, group), stacked)


def to_microbatches(x: PyTree, n_micro: int) -> PyTree:
    """``[B, ...]`` -> ``[n_micro, B / n_micro, ...]`` on every leaf
    (:107-114)."""
    def split(leaf):
        b = leaf.shape[0]
        if b % n_micro != 0:
            raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
        return leaf.reshape((n_micro, b // n_micro) + tuple(leaf.shape[1:]))
    return tree_map(split, x)


def from_microbatches(x: PyTree) -> PyTree:
    """``[n_micro, mb, ...]`` -> ``[n_micro * mb, ...]`` (:117-119)."""
    return tree_map(lambda t: t.reshape((t.shape[0] * t.shape[1],)
                                        + tuple(t.shape[2:])), x)


def stack_stage_params(per_stage: Sequence[PyTree]) -> PyTree:
    """Per-stage param trees -> one stacked ``[n_stages, ...]`` tree
    (:122-126); its leading axis is what splits over ``pipe``."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage)


def split_layers_into_stages(stacked_layer_params: PyTree,
                             n_stages: int) -> PyTree:
    """A ``[n_layers, ...]`` stacked-blocks tree -> ``[n_stages,
    layers_per_stage, ...]`` (:196-216), so each stage walks its own run
    of blocks."""
    def resh(p):
        n_layers = p.shape[0]
        if n_layers % n_stages != 0:
            raise ValueError(
                f"n_layers={n_layers} not divisible by n_stages={n_stages}")
        return p.reshape((n_stages, n_layers // n_stages)
                         + tuple(p.shape[1:]))
    return tree_map(resh, stacked_layer_params)


def _data_shard(mesh, data_sharded: bool):
    """``(n, index)`` of the data axis the microbatch rows split over."""
    if data_sharded and int(mesh.shape.get(DATA_AXIS, 1)) > 1:
        return int(mesh.shape[DATA_AXIS]), int(mesh.rank)
    return 1, 0


class _GatherRows(torch.autograd.Function):
    """Every data rank's ``[n_micro, mb / n, ...]`` rows concatenated on
    axis 1; backward: this rank's rows of the cotangent (every rank
    holds the same loss of the gathered outputs)."""

    @staticmethod
    def forward(ctx, x, group, n, idx):
        ctx.args = (n, idx, x.shape[1])
        return torch.cat(collectives._gather(x, group), dim=1)

    @staticmethod
    def backward(ctx, g):
        n, idx, w = ctx.args
        return g.narrow(1, idx * w, w).contiguous(), None, None, None


def make_pipeline_fn(mesh, stage_fn: StageFn, n_micro: int,
                     data_sharded: bool = True):
    """``f(stacked_params, batch) -> out`` running the GPipe pipeline
    over ``mesh``'s ``pipe`` axis (:129-163), the microbatch rows split
    over ``data`` when ``data_sharded`` and the axis is above 1.  Every
    rank calls it with the same global arguments: ``stacked_params``
    leaves have leading dim ``n_stages = mesh.shape["pipe"]`` and a rank
    runs its stage's row; ``batch`` is ``[B, ...]`` (a tensor or a
    tree) with ``B`` divisible by ``n_micro`` and the microbatch by the
    data degree.  ``out`` is the global ``[B, ...]`` output on every
    rank."""
    n_stages = int(mesh.shape[PIPE_AXIS])
    n_data, d_idx = _data_shard(mesh, data_sharded)
    axis = (mesh, PIPE_AXIS)
    data_group = collectives._group((mesh, DATA_AXIS))

    def apply(stacked_params, batch):
        for leaf in tree_leaves(stacked_params):
            if leaf.shape[0] != n_stages:
                raise ValueError(
                    f"stacked params leading dim {leaf.shape[0]} != pipe "
                    f"degree {n_stages}; each shard must own exactly one "
                    f"stage (use split_layers_into_stages for deeper nets)")
        own = tree_map(lambda p: p[mesh.pipe_rank], stacked_params)
        micro = to_microbatches(batch, n_micro)
        if n_data > 1:
            def rows(m):
                if m.shape[1] % n_data:
                    raise ValueError(
                        f"microbatch of {m.shape[1]} rows does not split "
                        f"over a data axis of {n_data}")
                w = m.shape[1] // n_data
                return m.narrow(1, d_idx * w, w)
            micro = tree_map(rows, micro)
        out = pipeline_forward(stage_fn, own, micro, axis)
        if n_data > 1:
            out = tree_map(lambda o: _GatherRows.apply(o, data_group,
                                                       n_data, d_idx), out)
        return from_microbatches(out)

    return apply


def make_pipeline_train_step(mesh, stage_fn: StageFn,
                             loss_fn: Callable[[Tensor, Tensor], Tensor],
                             n_micro: int, optimizer=None,
                             learning_rate: float = 1e-2):
    """The data x pipe training step (:166-203): the pipelined forward,
    ``loss_fn(out, targets)``, gradients through the mirrored backward
    pipeline, an SGD (or ``optimizer``'s) update.  Returns
    ``(init_opt_state, step)`` with ``step(params, opt_state, batch,
    targets) -> (params, opt_state, loss)``; ``params`` is the global
    stacked ``[n_stages, ...]`` tree on every rank.  A rank's gradient
    holds its stage's row from its data rows; summed over ``pipe`` and
    ``data`` it is the global gradient, so every rank takes the same
    update and the replicas stay equal.  ``optimizer`` is one of
    ``ops.updaters``' gradient transformations."""
    fwd = make_pipeline_fn(mesh, stage_fn, n_micro)
    world = (mesh, (DATA_AXIS, PIPE_AXIS))

    def value_and_grad(params, batch, targets):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = loss_fn(fwd(live, batch), targets)
        grads = torch.autograd.grad(loss, tree_leaves(live),
                                    allow_unused=True,
                                    materialize_grads=True)
        grads = collectives.psum(tree_unflatten(params, list(grads)), world)
        return loss.detach(), grads

    if optimizer is None:
        def init_opt(params):
            return ()

        def step(params, opt_state, batch, targets):
            loss, grads = value_and_grad(params, batch, targets)
            params = tree_map(lambda p, g: p - learning_rate * g,
                              params, grads)
            return params, opt_state, loss
        return init_opt, step

    def init_opt(params):
        return optimizer.init(params)

    def step(params, opt_state, batch, targets):
        loss, grads = value_and_grad(params, batch, targets)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss
    return init_opt, step


__all__ = ["pipeline_forward", "run_schedule", "to_microbatches",
           "from_microbatches", "stack_stage_params",
           "split_layers_into_stages", "make_pipeline_fn",
           "make_pipeline_train_step"]
