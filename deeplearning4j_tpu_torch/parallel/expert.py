"""Mixture-of-Experts: top-k routing with capacity, one device.

Port of the one-device half of ``deeplearning4j_tpu/parallel/expert.py``:
``MoEConfig``, ``init_moe_params``, ``compute_capacity``, ``route_topk``
(:62-109), ``_expert_ffn`` and ``moe_ffn``, and ``make_moe_layer`` /
``make_gspmd_moe_ffn`` for no mesh or a mesh whose ``expert`` axis is
1.  Expert parallelism (an ``expert`` axis above 1, ``axis_name=``,
``stat_axes``, ``expert_param_specs``) raises ``NotImplementedError``
naming ROADMAP A7.1b.

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

**Products.**  The reference's router and expert products take bf16
tokens with the fp32 weights and ask for fp32 results; JAX promotes the
operands to fp32, so the products are fp32 products of the bf16-rounded
tokens.  So are the port's (full fp32 on the card: TF32 is off).  The
expert's GELU is the tanh approximation, on the fp32 product.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import DeviceLike, resolve_device

Tensor = torch.Tensor

#: the mesh axis experts shard over in the reference
EXPERT_AXIS = "expert"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet: expert "
        f"parallelism comes with the mesh's expert axis (ROADMAP A7.1b)")


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


def route(gates: Tensor, top_k: int, capacity: int) -> Routing:
    """Top-k routing with per-expert capacity (:62-109), as indices."""
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
    aux = E * torch.sum(f_e * p_e)
    return Routing(expert, weight, slot, slot < capacity, aux, capacity)


def route_topk(gates: Tensor, top_k: int, capacity: int,
               stat_axes: Tuple[str, ...] = ()
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """The reference's dense form: ``(dispatch [N, E, C] {0, 1}, combine
    [N, E, C] gate-weighted, aux)``, in the gates' dtype.  ``stat_axes``
    (token shards) comes with the mesh's expert axis (ROADMAP A7.1b)."""
    if stat_axes:
        raise _not_ported("route_topk over token shards (stat_axes)")
    r = route(gates, top_k, capacity)
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


def _owner(r: Routing, dest: Tensor, n_experts: int) -> Tensor:
    """``[E * C]`` flat choice ``n * k + j`` held by each slot; ``N * k``
    (the zero row) for an empty one."""
    n_choices = dest.numel()
    owner = torch.full((n_experts * r.capacity + 1,), n_choices,
                       dtype=torch.long, device=dest.device)
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
    N, d = x.shape
    k = r.expert.shape[1]
    dest = _dest(r, n_experts)
    owner = _owner(r, dest, n_experts)
    token = torch.where(owner < N * k, owner // k, N)
    inbox = _RowGather.apply(x, token, dest)
    return inbox.reshape(n_experts, r.capacity, d)


def combine(out: Tensor, r: Routing) -> Tensor:
    """Expert outputs ``[E, C, d]`` -> tokens ``[N, d]``: each token's k
    outputs weighted and summed in fp32, then the outputs' dtype (the
    reference's ``einsum("nec,ecd->nd", combine, out)``).  A dropped
    choice reads the zero row."""
    E, C, d = out.shape
    dest = _dest(r, E)
    owner = _owner(r, dest, E)
    got = _RowGather.apply(out.reshape(E * C, d), dest.reshape(-1),
                           owner[:, None]).reshape(*dest.shape, d)
    y = torch.sum(r.weight.float()[..., None] * got.float(), dim=1)
    return y.to(out.dtype)


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
            axis_name: Optional[str] = None,
            stat_axes: Tuple[str, ...] = ()) -> Tuple[Tensor, Tensor]:
    """MoE FFN over tokens x ``[N, d]`` -> ``(y [N, d], aux)`` on one
    device, in the index form (module docstring).  ``axis_name`` /
    ``stat_axes`` (the all_to_all path) are ROADMAP A7.1b."""
    if axis_name is not None or stat_axes:
        raise _not_ported("moe_ffn across expert shards (axis_name=)")
    E = cfg.n_experts
    C = compute_capacity(x.shape[0], E, cfg.top_k, cfg.capacity_factor)
    r = route(router_gates(params, x), cfg.top_k, C)
    out = _expert_ffn(params["wi"], params["wo"], dispatch(x, r, E))
    return combine(out, r), r.aux.float()


def expert_param_specs(cfg: MoEConfig):
    """The reference's PartitionSpecs of the expert tables (ROADMAP A7.1b)."""
    raise _not_ported("expert_param_specs (experts sharded over a mesh)")


def _expert_degree(mesh) -> int:
    """The size of ``mesh``'s ``expert`` axis: 1 without a mesh; a mesh
    is anything with a ``shape`` mapping of axis sizes (as a JAX mesh)
    or such a mapping itself."""
    if mesh is None:
        return 1
    shape = getattr(mesh, "shape", mesh)
    return int(dict(shape).get(EXPERT_AXIS, 1))


def _one_device_layer(mesh, cfg: MoEConfig):
    ep = _expert_degree(mesh)
    if ep > 1:
        raise _not_ported(f"an expert axis of {ep}")

    def apply(params, x):
        return moe_ffn(params, x, cfg)

    return apply


def make_moe_layer(mesh, cfg: MoEConfig):
    """``f(params, x) -> (y, aux)`` for tokens ``x [N, d]`` (:159-199):
    without a mesh or with an ``expert`` axis of 1, :func:`moe_ffn`; a
    larger expert axis raises (ROADMAP A7.1b)."""
    return _one_device_layer(mesh, cfg)


def make_gspmd_moe_ffn(mesh, cfg: MoEConfig):
    """The per-layer dispatch hook of the sharded fit (:202-238), as
    ``models/moe.encode(..., ffn_fn=...)`` takes it: on one device it is
    :func:`moe_ffn`; an ``expert`` axis above 1 raises (ROADMAP A7.1b)."""
    return _one_device_layer(mesh, cfg)
