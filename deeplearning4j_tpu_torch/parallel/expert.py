"""Mixture-of-Experts: top-k routing with capacity, and expert
parallelism over a mesh.

Port of ``deeplearning4j_tpu/parallel/expert.py``: ``MoEConfig``,
``init_moe_params``, ``compute_capacity``, ``route_topk`` (:62-109),
``_expert_ffn``, ``moe_ffn`` with ``axis_name=`` / ``stat_axes=``
(:120-157), ``expert_param_specs``, ``make_moe_layer`` and
``make_gspmd_moe_ffn`` (:160-238).  The reference's axes are names
inside a ``shard_map``; the port runs SPMD, one process a rank, so an
axis is a collectives axis naming its mesh, ``(mesh, "expert")`` or
``(mesh, ("data", "expert"))`` (``parallel/collectives``).

**Routing** (:func:`route`) is the reference's, exactly: the top-k of
the gates with ties to the lower expert index (``lax.top_k``; here a
stable descending sort, since ``torch.topk`` promises no order among
equal values), the top-k weights normalised in the gates' dtype, and
each choice's slot in its expert an integer count, choice-major (every
token's first choice before any second choice, GShard's priority), so
bf16 gates never collide two tokens in one slot.  A choice whose slot
is at or past the capacity ``C`` is dropped.

**Dispatch.**  The reference moves tokens with dense one-hot einsums
over ``[N, E, C]`` (a TPU design: no scatters).  At GPT-2 small's
widths (N = 8192, E = 8, C = 2560) that tensor is 168 M entries a
layer, and its einsums cost more than the experts.  :func:`moe_ffn`
computes the same function from the slot indices instead: each slot of
the ``[E, C, d]`` inbox gathers its token (a slot holds at most one, so
the selection is exact), the experts run as one batched product, and
each token gathers its k outputs back, weighted.  The shapes are fixed
(``E * C`` slots and one zero row that empty slots and dropped choices
point at), with no host read, so the step is captured as one CUDA
graph.  :func:`route_topk` still returns the dense ``(dispatch,
combine, aux)``, built from the same routing.

**Expert parallelism.**  With ``axis_name`` the params hold this
rank's ``E / ep`` experts (``expert_param_specs``: the tables split on
their expert axis over ``expert``) and ``x`` its own tokens: the
``[E, C, d]`` inbox goes through :func:`collectives.all_to_all` (split
0, concat 1) to ``[E / ep, ep C, d]``, the rank's experts run, and the
results come back through the inverse exchange (split 1, concat 0).
The capacity is the shard's own (``C`` from its ``N``), so at a tight
capacity a sharded run drops other tokens than one device does.  The
load-balance statistics ``f_e`` and ``p_e`` are averaged over the token
shards (``stat_axes``) before the aux loss is formed, which makes the
sharded aux the pooled one exactly.

:func:`make_moe_layer` takes a rank's expert slice and its token block
(tokens shard over ``data`` x ``expert``).  :func:`make_gspmd_moe_ffn`,
the per-layer hook ``models/lm_fit.CausalLM`` threads through
``models/moe.encode``, takes tokens replicated over the rank's
``expert`` (and ``model``) group, as GSPMD sees them there: on an
``expert`` axis the router runs on every token, each rank routes its
block of them, and the outputs are gathered back (the backward of the
block cut gathers the cotangents, the gather's keeps the rank's block),
so everything outside the layer stays replicated over the group and
its gradients need no sum over ``expert``; on a ``model`` axis without
an ``expert`` axis (the reference's expert tables then split over
``model``) each rank runs its ``E / m`` experts on every token, and
the combine's sum over experts is one all-reduce over ``model``, the
collective GSPMD inserts for the reference.

**Products.**  The reference's router and expert products take bf16
tokens with the fp32 weights and ask for fp32 results; JAX promotes the
operands to fp32, so the products are fp32 products of the bf16-rounded
tokens.  So are the port's (full fp32 on the card: TF32 is off).  The
expert's GELU is the tanh approximation, on the fp32 product.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                                    MODEL_AXIS, TOKEN_AXES)

Tensor = torch.Tensor
P = tpar.P


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    d_model: int = 64
    d_ff: int = 256
    aux_loss_weight: float = 1e-2


def init_moe_params(generator: torch.Generator, cfg: MoEConfig,
                    device: DeviceLike = None) -> dict:
    """``router`` ``[d, E]`` at std 0.02, ``wi`` ``[E, d, f]`` at
    ``1/sqrt(d)``, ``wo`` ``[E, f, d]`` at ``1/sqrt(f)`` (:46-53).
    ``generator`` must live on ``device``; the draws are not JAX's."""
    dev = resolve_device(device)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    return {"router": normal(d, E) * 0.02,
            "wi": normal(E, d, f) * (1.0 / d ** 0.5),
            "wo": normal(E, f, d) * (1.0 / f ** 0.5)}


def compute_capacity(n_tokens: int, n_experts: int, top_k: int,
                     capacity_factor: float) -> int:
    c = int(capacity_factor * top_k * n_tokens / n_experts)
    return max(c, 1)


class Routing(NamedTuple):
    """One routing of N tokens: per token and choice (``[N, k]``) the
    expert, its normalised gate weight (the gates' dtype, differentiable)
    and the slot in the expert; ``keep`` marks the choices within the
    capacity; ``aux`` is the fp32 load-balance loss."""
    expert: Tensor
    weight: Tensor
    slot: Tensor
    keep: Tensor
    aux: Tensor
    capacity: int


def route(gates: Tensor, top_k: int, capacity: int,
          stat_mean: Optional[Callable[[Tensor], Tensor]] = None
          ) -> Routing:
    """Top-k routing with per-expert capacity (:62-109), as indices.
    ``stat_mean`` averages the routing statistics ``f_e`` and ``p_e``
    over the token shards before the aux is formed (None: this shard's
    tokens are all the tokens)."""
    N, E = gates.shape
    # lax.top_k: the k largest, ties to the lower index (a stable sort)
    expert = torch.sort(gates.detach(), dim=-1, descending=True,
                        stable=True).indices[:, :top_k]
    weight = torch.gather(gates, 1, expert)
    weight = weight / torch.clamp(weight.sum(-1, keepdim=True), min=1e-9)
    # slots are counts: an integer cumsum, choice-major, each expert's
    # column scanned as one contiguous row ([E, k N]: a scan down the
    # outer dim of [k N, E] runs ~20x slower on the card)
    flat = expert.t().reshape(1, -1)                       # [1, k N]
    masks = (flat == torch.arange(E, device=gates.device)[:, None]).long()
    pos = torch.cumsum(masks, dim=1) - masks
    slot = torch.gather(pos, 0, flat).reshape(top_k, N).t()
    # Switch aux: E * sum_e (token fraction to e) * (mean gate of e), f32
    f_e = masks.sum(dim=1).float() / (N * top_k)
    p_e = gates.float().mean(dim=0)
    if stat_mean is not None:
        f_e, p_e = stat_mean(f_e), stat_mean(p_e)
    aux = E * torch.sum(f_e * p_e)
    return Routing(expert, weight, slot, slot < capacity, aux, capacity)


def _stat_mean(stat_axes) -> Optional[Callable[[Tensor], Tensor]]:
    """The mean over the token shards of ``stat_axes`` (a collectives
    axis naming its mesh), or None for ``()``."""
    if not stat_axes:
        return None
    if isinstance(stat_axes, str) or (
            isinstance(stat_axes, tuple)
            and all(isinstance(a, str) for a in stat_axes)):
        raise ValueError(
            f"stat_axes={stat_axes!r} names axes without their mesh: pass "
            f"(mesh, names), e.g. (mesh, ('data', 'expert'))")
    return lambda t: collectives.pmean(t, stat_axes)


def route_topk(gates: Tensor, top_k: int, capacity: int,
               stat_axes=()) -> Tuple[Tensor, Tensor, Tensor]:
    """The reference's dense form: ``(dispatch [N, E, C] {0, 1}, combine
    [N, E, C] gate-weighted, aux)``, in the gates' dtype.  ``stat_axes``
    (a collectives axis, ``(mesh, ("data", "expert"))``) averages the
    aux's statistics over the token shards."""
    r = route(gates, top_k, capacity, _stat_mean(stat_axes))
    E = gates.shape[1]
    dispatch = gates.new_zeros((gates.shape[0], E, capacity))
    combine = gates.new_zeros((gates.shape[0], E, capacity))
    for j in range(top_k):
        sel = F.one_hot(r.expert[:, j], E) * r.keep[:, j, None]
        slot_oh = F.one_hot(torch.where(r.keep[:, j], r.slot[:, j], 0),
                            capacity)
        d_j = (sel[:, :, None] * slot_oh[:, None, :]).to(gates.dtype)
        dispatch = dispatch + d_j
        combine = combine + d_j * r.weight[:, j, None, None]
    return dispatch, combine, r.aux


def _dest(r: Routing, n_experts: int) -> Tensor:
    """``[N, k]`` flat slot ``expert * C + slot`` of each kept choice;
    ``E * C`` (the zero row) for a dropped one."""
    C = r.capacity
    return torch.where(r.keep, r.expert * C + r.slot, n_experts * C)


def _owner(dest: Tensor, n_slots: int) -> Tensor:
    """``[n_slots]`` flat choice ``n * k + j`` held by each slot;
    ``N * k`` (the zero row) for an empty one.  ``dest`` ``[N, k]``
    names each choice's slot, ``n_slots`` for none."""
    n_choices = dest.numel()
    owner = torch.full((n_slots + 1,), n_choices, dtype=torch.long,
                       device=dest.device)
    # dropped choices all land in the last entry, which is cut off
    owner.scatter_(0, dest.reshape(-1),
                   torch.arange(n_choices, device=dest.device))
    return owner[:-1]


class _RowGather(torch.autograd.Function):
    """``src [M, d]`` rows picked by ``idx [S]`` (``M`` picks a zero
    row), where ``inv [M, m]`` lists, for each source row, the outputs
    that picked it (``S`` for none): the two maps are inverse, as slots
    and kept choices are.  The backward gathers too: each source row
    sums its ``m`` outputs' gradients (fp32, then the source's dtype),
    so no index is accumulated into and nothing depends on the order
    of atomics."""

    @staticmethod
    def forward(ctx, src: Tensor, idx: Tensor, inv: Tensor) -> Tensor:
        ctx.save_for_backward(inv)
        pad = torch.cat([src, src.new_zeros((1, src.shape[1]))])
        return pad[idx]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: Tensor):
        (inv,) = ctx.saved_tensors
        pad = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        rows = pad[inv]
        if inv.shape[1] > 1:
            rows = rows.float().sum(1).to(g.dtype)
        else:
            rows = rows[:, 0]
        return rows, None, None


def dispatch(x: Tensor, r: Routing, n_experts: int) -> Tensor:
    """Tokens ``[N, d]`` -> the experts' inbox ``[E, C, d]``: each slot
    gathers its token, an empty slot the zero row (the reference's
    ``einsum("nec,nd->ecd", dispatch, x)``)."""
    return _gather_inbox(x, _dest(r, n_experts), n_experts * r.capacity
                         ).reshape(n_experts, r.capacity, x.shape[1])


def _gather_inbox(x: Tensor, dest: Tensor, n_slots: int) -> Tensor:
    """``[n_slots, d]``: each slot's token, the zero row for an empty
    slot (``dest``: each choice's slot, ``n_slots`` for none)."""
    N, k = dest.shape
    owner = _owner(dest, n_slots)
    token = torch.where(owner < N * k, owner // k, N)
    return _RowGather.apply(x, token, dest)


def _gather_outputs(out: Tensor, dest: Tensor, weight: Tensor) -> Tensor:
    """Each token's k outputs from ``out`` ``[n_slots, d]`` (the zero row
    for a dropped or absent choice), weighted and summed in fp32."""
    owner = _owner(dest, out.shape[0])
    got = _RowGather.apply(out, dest.reshape(-1), owner[:, None]
                           ).reshape(*dest.shape, out.shape[1])
    return torch.sum(weight.float()[..., None] * got.float(), dim=1)


def combine(out: Tensor, r: Routing) -> Tensor:
    """Expert outputs ``[E, C, d]`` -> tokens ``[N, d]``: each token's k
    outputs weighted and summed in fp32, then the outputs' dtype (the
    reference's ``einsum("nec,ecd->nd", combine, out)``).  A dropped
    choice reads the zero row."""
    E, C, d = out.shape
    return _gather_outputs(out.reshape(E * C, d), _dest(r, E),
                           r.weight).to(out.dtype)


def _expert_ffn(wi: Tensor, wo: Tensor, x: Tensor) -> Tensor:
    """Batched expert FFN: x ``[E, C, d]`` through per-expert weights,
    fp32 products of x's values, tanh GELU, back to x's dtype."""
    h = F.gelu(torch.bmm(x.float(), wi.float()), approximate="tanh")
    return torch.bmm(h.to(x.dtype).float(), wo.float()).to(x.dtype)


def router_gates(params: dict, x: Tensor) -> Tensor:
    """The router's softmax of ``x @ router`` (fp32), in x's dtype."""
    return torch.softmax(x.float() @ params["router"].float(),
                         dim=-1).to(x.dtype)


def moe_ffn(params: dict, x: Tensor, cfg: MoEConfig,
            axis_name=None, stat_axes=()) -> Tuple[Tensor, Tensor]:
    """MoE FFN over tokens x ``[N, d]`` -> ``(y [N, d], aux)`` in the
    index form (module docstring).  ``axis_name`` (``(mesh,
    "expert")``): ``x`` holds this shard's tokens and ``params`` its
    ``E / ep`` experts, dispatched across the axis by two all-to-alls;
    the router table is replicated.  ``stat_axes`` (``(mesh, ("data",
    "expert"))``): the token shards the aux's statistics are averaged
    over, so the aux is the pooled one on every shard."""
    return _moe(params, x, cfg, axis_name, _stat_mean(stat_axes))


def _moe(params: dict, x: Tensor, cfg: MoEConfig, axis_name,
         stat_mean, gates: Optional[Tensor] = None
         ) -> Tuple[Tensor, Tensor]:
    E = cfg.n_experts
    C = compute_capacity(x.shape[0], E, cfg.top_k, cfg.capacity_factor)
    if gates is None:
        gates = router_gates(params, x)
    r = route(gates, cfg.top_k, C, stat_mean)
    inbox = dispatch(x, r, E)
    if axis_name is None:
        out = _expert_ffn(params["wi"], params["wo"], inbox)
    else:
        # [E, C, d] -> [E / ep, ep C, d]: the rank's experts, every
        # shard's slots for them (blocked by source shard), and back
        inbox = collectives.all_to_all(inbox, axis_name, 0, 1)
        out = _expert_ffn(params["wi"], params["wo"], inbox)
        out = collectives.all_to_all(out, axis_name, 1, 0)
    return combine(out, r), r.aux.float()


def expert_param_specs(cfg: MoEConfig) -> dict:
    """The reference's specs (:160-162): the expert tables split on
    their expert axis over ``expert``, the router replicated."""
    return {"router": P(), "wi": P(EXPERT_AXIS), "wo": P(EXPERT_AXIS)}


def _degree(mesh, axis: str) -> int:
    """The size of ``mesh``'s ``axis``: 1 without a mesh; a mesh is
    anything with a ``shape`` mapping of axis sizes (as a JAX mesh) or
    such a mapping itself."""
    if mesh is None:
        return 1
    shape = getattr(mesh, "shape", mesh)
    return int(dict(shape).get(axis, 1))


def _check_divides(cfg: MoEConfig, ep: int) -> None:
    if cfg.n_experts % ep != 0:
        raise ValueError(f"n_experts={cfg.n_experts} not divisible by "
                         f"expert degree {ep}")


def _token_axes(mesh):
    """The collectives axis of the token shards: ``(mesh, ("data",
    "expert"))`` over the axes above 1, or () when tokens do not
    shard."""
    live = tuple(a for a in TOKEN_AXES if _degree(mesh, a) > 1)
    return (mesh, live) if live else ()


def _need_mesh(mesh, what: str) -> None:
    if not hasattr(mesh, "groups"):
        raise ValueError(
            f"{what} over an expert or model axis above 1 runs on a "
            f"parallel.mesh.Mesh (make_mesh(MeshSpec(...))), not on "
            f"{type(mesh).__name__}")


def make_moe_layer(mesh, cfg: MoEConfig):
    """``f(params, x) -> (y, aux)`` (:165-199).  Without a mesh or with
    an ``expert`` axis of 1, :func:`moe_ffn` on one device.  Above 1,
    SPMD: every rank of the mesh calls it with its slice of the params
    (``tensor_parallel.shard_tree(params, expert_param_specs(cfg),
    mesh)``) and its block of the tokens, which shard over ``data`` x
    ``expert`` (rank ``(d, e)`` holds block ``d * ep + e``); it returns
    the block's outputs and the pooled aux."""
    ep = _degree(mesh, EXPERT_AXIS)
    _check_divides(cfg, ep)
    if ep == 1:
        def apply(params, x):
            return moe_ffn(params, x, cfg)
        return apply
    _need_mesh(mesh, "make_moe_layer")
    axis, stats = (mesh, EXPERT_AXIS), _token_axes(mesh)

    def apply(params, x):
        return moe_ffn(params, x, cfg, axis_name=axis, stat_axes=stats)

    return apply


class _ReplicaStatMean(torch.autograd.Function):
    """The mean of a routing statistic over the token shards of
    replicated tokens: forward the sum over the token group divided by
    its size; backward the cotangent (the same on every rank of a data
    index's expert group) summed over ``data`` only, divided likewise,
    so each shard's share of the objective counts once."""

    @staticmethod
    def forward(ctx, t, token_group, data_group, n):
        ctx.args = (data_group, n)
        return collectives._reduced(t, token_group) / n

    @staticmethod
    def backward(ctx, g):
        data_group, n = ctx.args
        return collectives._reduced(g, data_group) / n, None, None, None


class _ScatterRows(torch.autograd.Function):
    """This rank's block of rows of a tensor replicated over ``grp``; the
    backward gathers every rank's block of the cotangent."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        n = x.shape[0] // grp.size
        return x.narrow(0, grp.rank * n, n)

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.grp), None


class _GatherRows(torch.autograd.Function):
    """Every rank's block of rows, concatenated; the backward keeps this
    rank's block of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        ctx.n = x.shape[0]
        return _gather_rows(x, grp)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.grp.rank * ctx.n, ctx.n).contiguous(), None


def _gather_rows(x: Tensor, grp) -> Tensor:
    return torch.cat(collectives._gather(x, grp.group), dim=0)


def _scatter(x: Tensor, grp) -> Tensor:
    if x.requires_grad and torch.is_grad_enabled():
        return _ScatterRows.apply(x, grp)
    n = x.shape[0] // grp.size
    return x.narrow(0, grp.rank * n, n)


def _gather(x: Tensor, grp) -> Tensor:
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(x, grp)
    return _gather_rows(x, grp)


def _expert_axis_ffn(mesh, cfg: MoEConfig):
    """The hook on an ``expert`` axis (tokens replicated over the rank's
    expert group, module docstring)."""
    _need_mesh(mesh, "make_gspmd_moe_ffn")
    grp = tpar._axis_group(mesh, EXPERT_AXIS)
    token = collectives._group((mesh, TOKEN_AXES))
    data = collectives._group((mesh, DATA_AXIS))
    n = float(_degree(mesh, DATA_AXIS) * grp.size)
    axis = (mesh, EXPERT_AXIS)

    def stat_mean(t):
        if t.requires_grad and torch.is_grad_enabled():
            return _ReplicaStatMean.apply(t, token, data, n)
        return collectives._reduced(t, token) / n

    def apply(params, tok):
        if tok.shape[0] % grp.size:
            raise ValueError(f"{tok.shape[0]} tokens do not split over an "
                             f"expert axis of {grp.size}")
        gates = router_gates(params, tok)
        y, aux = _moe(params, _scatter(tok, grp), cfg, axis, stat_mean,
                      _scatter(gates, grp))
        return _gather(y, grp), aux

    return apply


def _model_axis_ffn(mesh, cfg: MoEConfig):
    """The hook on a ``model`` axis with no ``expert`` axis: each rank
    runs its ``E / m`` experts (their tables split over ``model``) on
    every token; the gates, the routing and the aux are replicated, the
    tokens and the routing weights enter the rank's experts through
    ``copy_to_model`` and the outputs' sum over experts leaves through
    ``reduce_from_model``."""
    tp = tpar.model_group(mesh)
    E = cfg.n_experts
    if E % tp.size:
        raise ValueError(
            f"n_experts={E} not divisible by model degree {tp.size} — "
            f"expert tables shard their expert axis over `model`")
    El = E // tp.size
    e0 = tp.rank * El

    def apply(params, tok):
        N, d = tok.shape
        C = compute_capacity(N, E, cfg.top_k, cfg.capacity_factor)
        r = route(router_gates(params, tok), cfg.top_k, C)
        dest = _dest(r, E)
        mine = (dest >= e0 * C) & (dest < (e0 + El) * C)
        dest = torch.where(mine, dest - e0 * C, El * C)
        inbox = _gather_inbox(tpar.copy_to_model(tok, tp), dest, El * C)
        out = _expert_ffn(params["wi"], params["wo"],
                          inbox.reshape(El, C, d))
        y = _gather_outputs(out.reshape(El * C, d), dest,
                            tpar.copy_to_model(r.weight, tp))
        return tpar.reduce_from_model(y, tp).to(out.dtype), r.aux.float()

    return apply


def make_gspmd_moe_ffn(mesh, cfg: MoEConfig):
    """The per-layer dispatch hook of the sharded fit (:202-238), as
    ``models/moe.encode(..., ffn_fn=...)`` takes it: ``(layer_params,
    tok) -> (y, aux)`` with ``layer_params = {"router", "wi", "wo"}``
    (this rank's slice, ``models/moe.shard_specs``) and ``tok`` ``[N,
    H]`` replicated over the rank's expert and model groups (the rows of
    its data index).  Without an ``expert`` or ``model`` axis it is
    :func:`moe_ffn`; on an ``expert`` axis the all-to-all dispatch over
    the rank's block of the tokens; on a ``model`` axis alone the rank's
    experts over every token, summed over ``model`` (module docstring).
    The aux comes back pooled over the token shards."""
    ep = _degree(mesh, EXPERT_AXIS)
    _check_divides(cfg, ep)
    if ep > 1:
        return _expert_axis_ffn(mesh, cfg)
    if _degree(mesh, MODEL_AXIS) > 1:
        _need_mesh(mesh, "make_gspmd_moe_ffn")
        return _model_axis_ffn(mesh, cfg)

    def apply(params, x):
        return moe_ffn(params, x, cfg)

    return apply
