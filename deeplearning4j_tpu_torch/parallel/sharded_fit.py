"""The sharded-fit steps: one captured step, replayed for a fit.

Port of ``deeplearning4j_tpu/parallel/sharded_fit.py``, the junction the
data-parallel ``MultiLayerNetwork`` bundle, ``models/lm_fit.CausalLM``
and ``parallel/data_parallel.DataParallelTrainer`` meet at.  Each hands
a per-shard step ``shard_step(params, ustate, batch, gen, it) ->
(params, ustate, score, skipped)`` to the functions here:

- :func:`build_sharded_step` wraps it as the engine step
  ``step(params, ustate, it, batch, gen) -> (params, ustate, it, score,
  skipped)`` through ``runtime/compile_cache``: on the card one CUDA
  graph a batch signature, the params, the updater state and the
  iteration counter donated and updated in place.  The step owns its
  collectives (``parallel/collectives`` over the mesh's data axis),
  which the graph captures with the rest (NCCL calls capture into a
  CUDA graph; a group of one rank still calls them).
- :func:`build_scanned_epochs` is the port's form of the reference's
  "one dispatch a fit" double ``lax.scan``: the caller stages the
  stacked batches on the device once, and the epochs function replays
  the captured step for every (epoch, batch), returning the
  ``[num_epochs, NB]`` scores and guard-skip flags as device tensors
  (one host read a fit, when the caller books the skips).

With ``mesh=None`` the step runs on one device (gradient accumulation
and mixed precision need no mesh).  Under a mesh each rank calls the
functions with the same step; ``batch`` holds this rank's row slice.
The guard's skip verdict is taken from values after the all-reduce, so
every rank skips the same step and the replicas never diverge; on a
mesh with a model, pipe or expert axis, where a rank's gradients are
those of its own param slice, the verdict is reduced over the whole
mesh besides (:func:`agree_over_mesh`), so one rank's non-finite shard
skips the step on every rank of every axis.  A ``pipe`` or ``seq`` axis
the caller's step does not split replicates it over that axis, as the
reference's ``shard_map`` replicates what its specs leave out.

``param_specs`` / ``ustate_specs`` (the reference's GSPMD mode) name
the layout the caller gave the params and the updater state
(``models/transformer.shard_specs``): the port's step is written against
a rank's slice (``tensor_parallel.shard_tree``), so the specs are
checked against the mesh (:func:`validate_specs_against_mesh`) and kept
on the step (``step.param_specs``) for the caller to gather with.  A
step over a gloo group runs eagerly (``mesh.mesh_captures``).

Mixed precision (the policy half of ``mixed_precision="bf16"``): the
steps cast fp32 masters to bf16 inside the differentiated function
(:func:`mp_cast`), so gradients and every updater accumulator stay
fp32, and thread the dynamic loss scale (:func:`init_loss_scale`,
:func:`next_loss_scale`) through the updater state.  The transitions
are ``torch.where`` selects on device tensors: no host read a step.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Hashable, NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.ops.updaters import (copy_into, tree_leaves,
                                                   tree_map)
from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar
from deeplearning4j_tpu_torch.parallel.mesh import (ALL_AXES,
                                                    check_mesh_axes,
                                                    expert_degree,
                                                    mesh_captures,
                                                    model_degree, pipe_degree,
                                                    shard_rows)
from deeplearning4j_tpu_torch.runtime import compile_cache, resilience, \
    telemetry

PyTree = Any
#: shard_step(params, ustate, batch, gen, it) -> (params, ustate, score,
#: skipped), written against this rank's rows, collectives over the mesh
ShardStep = Callable[..., Any]

#: a uniform batch list up to this size is staged on the device once
#: and replayed from there; above it the callers move batch by batch
SCAN_MAX_DATASET_BYTES = 256 * 1024 * 1024

#: initial dynamic loss scale (2^15)
LOSS_SCALE_INIT = 2.0 ** 15
#: floor and cap the dynamic scale walks between
LOSS_SCALE_MIN = 1.0
LOSS_SCALE_MAX = 2.0 ** 24
#: consecutive finite steps before the scale doubles
LOSS_SCALE_GROWTH_INTERVAL = 200


def init_loss_scale(device=None) -> dict:
    """Fresh dynamic-loss-scale state on ``device``: the scale and the
    count of consecutive good (not skipped) steps since its last
    change."""
    return {"scale": torch.full((), LOSS_SCALE_INIT, dtype=torch.float32,
                                device=device),
            "good_steps": torch.zeros((), dtype=torch.int32, device=device)}


def next_loss_scale(state: dict, skipped) -> dict:
    """One transition from a step's guard verdict (``skipped``: a 0-d
    int or bool tensor, 1 = update dropped): halve on a skip (floored),
    double after ``LOSS_SCALE_GROWTH_INTERVAL`` consecutive good steps
    (capped).  ``torch.where`` selects only, as the reference's
    ``jnp.where`` (:107-128)."""
    scale, good_steps = state["scale"], state["good_steps"]
    bad = torch.as_tensor(skipped, device=scale.device) > 0
    good = torch.where(bad, torch.zeros_like(good_steps), good_steps + 1)
    grow = good >= LOSS_SCALE_GROWTH_INTERVAL
    new = torch.where(
        bad, torch.clamp(scale * 0.5, min=LOSS_SCALE_MIN),
        torch.where(grow, torch.clamp(scale * 2.0, max=LOSS_SCALE_MAX),
                    scale))
    return {"scale": new,
            "good_steps": torch.where(grow, torch.zeros_like(good),
                                      good).to(torch.int32)}


def mp_cast(tree: PyTree, dtype: torch.dtype = torch.bfloat16) -> PyTree:
    """The compute-dtype view of an fp32 master tree: fp32 tensor leaves
    cast to ``dtype``, every other leaf unchanged.  Differentiating
    through the cast keeps the gradients fp32 (:131-141)."""
    return tree_map(lambda a: a.to(dtype) if isinstance(a, torch.Tensor)
                    and a.dtype == torch.float32 else a, tree)


class BatchSharding(NamedTuple):
    """The placement of one global batch (the reference's
    ``NamedSharding(mesh, P("data"))``): this rank's row block, on
    ``device``."""
    mesh: Any
    device: torch.device

    def place(self, arr) -> torch.Tensor:
        return shard_rows(arr, self.mesh).to(self.device)


def batch_sharding(mesh, device=None) -> BatchSharding:
    """:class:`BatchSharding` of ``mesh`` onto ``device`` (default: the
    mesh's)."""
    return BatchSharding(mesh, torch.device(device) if device is not None
                         else mesh.device)


def spec_axis_names(specs: PyTree) -> set:
    """Every mesh axis name a ``PartitionSpec`` tree names (:173-184)."""
    names = set()

    def note(s):
        for entry in s or ():
            if entry is None:
                continue
            names.update(entry if isinstance(entry, tuple) else (entry,))
        return s

    tpar.map_specs(note, specs)
    return names


def validate_specs_against_mesh(mesh, specs: PyTree,
                                what: str = "param_specs") -> None:
    """Every axis a spec tree names must be an axis of ``mesh``
    (:187-202), checked when the step is built."""
    missing = sorted(spec_axis_names(specs) - set(mesh.axis_names))
    if missing:
        raise ValueError(
            f"{what} names mesh axes {missing} that the mesh does not "
            f"declare (mesh axes: {tuple(mesh.axis_names)}) — build the "
            f"mesh with those axes (parallel/mesh.make_mesh declares "
            f"all of data/model/pipe/seq/expert) or drop them from the "
            f"specs")


def _check_specs(mesh, param_specs, ustate_specs) -> None:
    check_mesh_axes(mesh)
    for what, tree in (("param_specs", param_specs),
                       ("ustate_specs", ustate_specs)):
        if tree is None:
            continue
        if mesh is None:
            raise ValueError(f"{what} lay the params out over a mesh: "
                             f"pass the mesh too")
        validate_specs_against_mesh(mesh, tree, what)


def agree_over_mesh(mesh):
    """The guard's agreement over ``mesh``: ``agree(ok) -> ok`` where
    the returned verdict holds only if it holds on every rank (one
    all-reduce of the 0-d flag over the whole mesh).  None without a
    model, pipe or expert axis: there the verdict comes from values
    already summed over the data (and seq) axes, the same on every
    rank."""
    if (model_degree(mesh) == 1 and expert_degree(mesh) == 1
            and pipe_degree(mesh) == 1):
        return None
    from deeplearning4j_tpu_torch.parallel import collectives

    def agree(ok):
        bad = collectives.psum((~ok).to(torch.float32), (mesh, ALL_AXES))
        return bad == 0

    return agree


def build_sharded_step(shard_step: ShardStep, mesh, *, label: str,
                       engine_key: Optional[Hashable] = None,
                       donate: bool = True, param_specs: PyTree = None,
                       ustate_specs: PyTree = None):
    """The per-batch engine step ``step(params, ustate, it, batch, gen)
    -> (params, ustate, it, score, skipped)``: ``shard_step`` through
    the compile engine under ``label`` (shared module-wide when
    ``engine_key`` is given).  ``it`` is the 0-d int32 step counter
    (the momentum schedule's clock), ``batch`` any tree of this rank's
    tensors, ``gen`` a generator on the batch's device (or None).  With
    ``donate`` the params, updater state and counter are updated in
    place (the engine's donation contract); without it the step returns
    new tensors and leaves its arguments alone.  Each call opens a
    ``dp.dispatch`` span when a tracer is on."""
    _check_specs(mesh, param_specs, ustate_specs)

    def step(params, ustate, it, batch, gen):
        new_p, new_u, score, skipped = shard_step(params, ustate, batch,
                                                  gen, it)
        if not donate:
            return new_p, new_u, it + 1, score, skipped
        with torch.no_grad():
            copy_into(params, new_p)
            copy_into(ustate, new_u)
            it.add_(1)
        return params, ustate, it, score, skipped

    graph = compile_cache.cached_graph(
        step, key=engine_key, label=label,
        donate_argnums=(0, 1, 2) if donate else (),
        capture=mesh_captures(mesh))

    def dispatch(params, ustate, it, batch, gen=None):
        tr = telemetry.get_tracer()
        if tr is None:
            return graph(params, ustate, it, batch, gen)
        with tr.span("dp.dispatch", label=label, scanned=False):
            return graph(params, ustate, it, batch, gen)

    dispatch.graph = graph
    dispatch.fn = step
    dispatch.param_specs = param_specs
    dispatch.ustate_specs = ustate_specs
    return dispatch


def build_scanned_epochs(shard_step: ShardStep, mesh, *, label: str,
                         engine_key: Optional[Hashable] = None,
                         donate: bool = True, param_specs: PyTree = None,
                         ustate_specs: PyTree = None, step=None):
    """The staged fit ``epochs(params, ustate, it, batches, gen,
    num_epochs) -> (params, ustate, it, scores, skips)``: ``batches`` is
    a tree of stacked ``[NB, ...]`` device tensors, and every (epoch,
    batch) replays the step of :func:`build_sharded_step` (``step=``
    reuses one already built) on ``batch[j]``.  ``scores`` and
    ``skips`` are ``[num_epochs, NB]`` device tensors.  A preemption
    notice (``resilience.preemption_requested``) stops the loop at the
    next step boundary; the results then hold the steps that ran, as a
    flat ``[steps]`` tensor."""
    if step is None:
        step = build_sharded_step(shard_step, mesh, label=label,
                                  engine_key=engine_key, donate=donate,
                                  param_specs=param_specs,
                                  ustate_specs=ustate_specs)
    else:
        _check_specs(mesh, param_specs, ustate_specs)

    def epochs(params, ustate, it, batches, gen, num_epochs: int):
        leaves = [t for t in tree_leaves(batches)
                  if isinstance(t, torch.Tensor)]
        nb = int(leaves[0].shape[0])
        scores, skips = [], []
        stopped = False
        tr = telemetry.get_tracer()
        with (tr.span("dp.dispatch", label=label, scanned=True,
                      steps=num_epochs * nb) if tr is not None
              else contextlib.nullcontext()):
            for _ in range(num_epochs):
                for j in range(nb):
                    if resilience.preemption_requested():
                        telemetry.event("dp.preempt_stop", label=label)
                        stopped = True
                        break
                    params, ustate, it, score, skipped = step.graph(
                        params, ustate, it, tree_map(lambda b: b[j],
                                                     batches), gen)
                    scores.append(score)
                    skips.append(skipped)
                if stopped:
                    break
        if not scores:
            empty = torch.zeros((0,), device=leaves[0].device)
            return params, ustate, it, empty, empty.to(torch.int32)
        scores, skips = torch.stack(scores), torch.stack(skips)
        if not stopped:
            scores = scores.reshape(num_epochs, nb)
            skips = skips.reshape(num_epochs, nb)
        return params, ustate, it, scores, skips

    epochs.step = step
    return epochs
