"""Mixture-of-Experts causal LM in PyTorch.

Port of ``deeplearning4j_tpu/models/moe.py``: the same config, the same
parameter tree (stacked ``[L, ...]`` blocks whose FFN is ``router``
``[L, H, E]``, ``wi`` ``[L, E, H, F]`` and ``wo_e`` ``[L, E, F, H]``;
an embedding of token and position tables with no type table), the
same post-LN causal block (the transformer's attention sublayer, then
the MoE FFN of ``parallel/expert.py``), the tied readout, the
next-token loss plus the weighted load-balance aux (the mean over
layers), and the one-device training step.

As in ``models/transformer.py``, the stacked leaves are walked with one
``torch.unbind`` each; with ``cfg.remat`` set and grad enabled each
block runs under ``torch.utils.checkpoint`` (non-reentrant), returning
``(x, aux)``.  The training step's default attention is
``ops/flash_attention.make_attn_fn("auto")``: on the card each layer
launches B1 twice a step (forward and the recompute) and B2 and B3
once.

**Expert parallelism** (the reference's :106-172 and :252-323):
:func:`param_specs` (the expert tables split on their expert axis over
``expert``) and :func:`shard_specs` (the same over ``expert``, or over
``model`` when the mesh has no expert axis; heads over ``model``; the
token table over vocab when the degree divides it) lay the tree out;
``tensor_parallel.shard_tree`` carries a global tree into a rank's
slice and ``gather_tree`` back.  :func:`make_train_step` with ``mesh=``
is the reference's data x expert step, run SPMD: tokens shard over
(``data``, ``expert``), the MoE dispatch crosses the expert axis by
all-to-all, the loss is averaged over the token shards, the gradients
of replicated leaves are summed over every token shard and those of the
expert tables over ``data`` only (the all-to-all's backward has
already brought every shard's contribution to the rank holding the
expert), and the AdamW state of the expert tables stays split.  A
``pipe`` or ``seq`` axis above 1 replicates that step over it; the
pipeline stages of the family (``shard_specs(pipe_degree=)``,
:func:`run_blocks`) train through ``models/lm_fit.CausalLM``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as _checkpoint

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.models import transformer as tfm
from deeplearning4j_tpu_torch.ops import updaters
from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar
from deeplearning4j_tpu_torch.parallel.expert import (MoEConfig,
                                                      _check_divides,
                                                      _token_axes, moe_ffn)
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                                    MODEL_AXIS, TOKEN_AXES)

Tensor = torch.Tensor
Params = Dict[str, Any]

#: the training state ``(params, opt_state, step)`` (moe.py:258)
TrainState = tfm.TrainState


@dataclasses.dataclass(frozen=True)
class MoETransformerConfig:
    vocab_size: int = 256
    max_len: int = 128
    hidden: int = 64
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 128                 # per-expert FFN width
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    layer_norm_eps: float = 1e-12
    compute_dtype: str = "bfloat16"
    remat: bool = True
    causal: bool = True             # LM convention
    dropout: float = 0.0            # shared attention sublayer contract

    @property
    def head_dim(self) -> int:
        if self.hidden % self.n_heads:
            raise ValueError(f"hidden {self.hidden} is not divisible by "
                             f"n_heads {self.n_heads}")
        return self.hidden // self.n_heads

    @property
    def moe(self) -> MoEConfig:
        return MoEConfig(n_experts=self.n_experts, top_k=self.top_k,
                         capacity_factor=self.capacity_factor,
                         d_model=self.hidden, d_ff=self.d_ff,
                         aux_loss_weight=self.aux_loss_weight)


#: leaf names of the two groups (moe.py:84-106)
_TREE = {
    "embed": ("tok", "pos", "ln_g", "ln_b"),
    "blocks": ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo", "ln1_g",
               "ln1_b", "ln2_g", "ln2_b", "router", "wi", "wo_e"),
}


def init_params(generator: torch.Generator, cfg: MoETransformerConfig,
                device: DeviceLike = None) -> Params:
    """The reference's tree (:84-106): truncated normals at 0.02, the
    experts' ``wi`` at ``1/sqrt(H)`` and ``wo_e`` at ``1/sqrt(F)``.
    ``generator`` must live on ``device``; the draws are not JAX's
    (carry JAX's params with :func:`params_from_numpy`)."""
    dev = resolve_device(device)
    H, L, NH, D = cfg.hidden, cfg.n_layers, cfg.n_heads, cfg.head_dim
    E, Fd = cfg.n_experts, cfg.d_ff

    def tn(*shape):
        return tfm._trunc_normal(shape, generator, dev)

    def normal(*shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    embed = {"tok": tn(cfg.vocab_size, H), "pos": tn(cfg.max_len, H),
             "ln_g": ones(H), "ln_b": zeros(H)}
    blocks = {
        "wq": tn(L, H, NH, D), "wk": tn(L, H, NH, D), "wv": tn(L, H, NH, D),
        "wo": tn(L, NH, D, H),
        "bq": zeros(L, NH, D), "bk": zeros(L, NH, D), "bv": zeros(L, NH, D),
        "bo": zeros(L, H),
        "ln1_g": ones(L, H), "ln1_b": zeros(L, H),
        "ln2_g": ones(L, H), "ln2_b": zeros(L, H),
        "router": tn(L, H, E),
        "wi": normal(L, E, H, Fd, std=1.0 / H ** 0.5),
        "wo_e": normal(L, E, Fd, H, std=1.0 / Fd ** 0.5),
    }
    return {"embed": embed, "blocks": blocks}


P = tpar.P

#: the expert tables: the leaves expert parallelism splits
EXPERT_LEAVES = ("wi", "wo_e")


def param_specs(cfg: MoETransformerConfig) -> Params:
    """The reference's shard_map specs (:109-122): the expert tables
    split on their expert axis over ``expert``, everything else
    replicated."""
    blocks = {k: P() for k in _TREE["blocks"] if k not in EXPERT_LEAVES}
    blocks["wi"] = P(None, EXPERT_AXIS)
    blocks["wo_e"] = P(None, EXPERT_AXIS)
    return {"embed": {k: P() for k in _TREE["embed"]}, "blocks": blocks}


def shard_specs(cfg: MoETransformerConfig, model_degree: int = 1,
                pipe_degree: int = 1, expert_degree: int = 1) -> Params:
    """The reference's data x model (x expert) specs (:125-172): the
    expert tables split their expert axis over ``expert`` when
    ``expert_degree > 1``, else over ``model``; attention heads over
    ``model``; the token table over vocab when the model degree divides
    it; above a ``pipe_degree`` of 1 the stacked blocks split into
    contiguous stages over ``pipe`` (``transformer.pipe_stage_specs``)."""
    m = MODEL_AXIS if model_degree > 1 else None
    if model_degree > 1:
        if expert_degree == 1 and cfg.n_experts % model_degree:
            raise ValueError(
                f"n_experts={cfg.n_experts} not divisible by model "
                f"degree {model_degree} — expert tables shard their "
                f"expert axis over `model`")
        if cfg.n_heads % model_degree:
            raise ValueError(
                f"n_heads={cfg.n_heads} not divisible by model degree "
                f"{model_degree} — attention heads shard over `model`")
    e = m
    if expert_degree > 1:
        if cfg.n_experts % expert_degree:
            raise ValueError(
                f"n_experts={cfg.n_experts} not divisible by expert "
                f"degree {expert_degree} — expert tables shard their "
                f"expert axis over `expert`")
        e = EXPERT_AXIS
    blocks = {
        "wq": P(None, None, m, None), "wk": P(None, None, m, None),
        "wv": P(None, None, m, None), "wo": P(None, m, None, None),
        "bq": P(None, m, None), "bk": P(None, m, None),
        "bv": P(None, m, None), "bo": P(None, None),
        "ln1_g": P(None, None), "ln1_b": P(None, None),
        "ln2_g": P(None, None), "ln2_b": P(None, None),
        "router": P(None, None, None),
        "wi": P(None, e, None, None), "wo_e": P(None, e, None, None),
    }
    tok = (P(m, None) if model_degree > 1
           and cfg.vocab_size % model_degree == 0 else P(None, None))
    embed = {"tok": tok, "pos": P(None, None), "ln_g": P(None),
             "ln_b": P(None)}
    if pipe_degree > 1:
        blocks = tfm.pipe_stage_specs(blocks, cfg, pipe_degree)
    return {"embed": embed, "blocks": blocks}


def _block(cfg: MoETransformerConfig, x: Tensor, p: Dict[str, Tensor],
           attn_fn=tfm.attention, ffn_fn: Optional[Callable] = None,
           tp=None) -> Tuple[Tensor, Tensor]:
    """One post-LN causal block with an MoE FFN (:194-224): x ``[b, T,
    H]`` fp32 -> ``(x', aux)``.  ``ffn_fn(layer_params, tok) -> (y,
    aux)``, with ``layer_params = {"router", "wi", "wo"}`` and ``tok``
    ``[N, H]``, replaces the dispatch (the reference's hook).  ``tp``:
    the model group of a rank holding a head shard."""
    cdt = tfm.compute_dtype(cfg)
    x = tfm._attention_sublayer(cfg, x, p, None, None, attn_fn, tp=tp)
    b, T, H = x.shape
    tok = x.reshape(b * T, H).to(cdt)
    lp = {"router": p["router"], "wi": p["wi"], "wo": p["wo_e"]}
    if ffn_fn is not None:
        y, aux = ffn_fn(lp, tok)
    else:
        y, aux = moe_ffn(lp, tok, cfg.moe)
    x = tfm.layer_norm(x + y.reshape(b, T, H).float(), p["ln2_g"],
                       p["ln2_b"], cfg.layer_norm_eps)
    return x, aux


def encode(cfg: MoETransformerConfig, params: Params, token_ids: Tensor,
           attn_fn=tfm.attention, ffn_fn: Optional[Callable] = None,
           tp=None, position_offset: int = 0) -> Tuple[Tensor, Tensor]:
    """ids ``[b, T]`` -> ``(hidden [b, T, H] fp32, mean aux over
    layers)`` (:227-244): token + position embedding and LayerNorm (the
    transformer's, with no type table), then :func:`run_blocks`.
    ``tp``: this rank's model group when ``params`` is its shard (heads,
    a vocab slice of the token table)."""
    x = tfm.embed(cfg, params, token_ids, None, position_offset, tp=tp)
    x, auxs = run_blocks(cfg, params["blocks"], x, attn_fn, ffn_fn, tp)
    return x, auxs.mean()


def run_blocks(cfg: MoETransformerConfig, blocks: Params, x: Tensor,
               attn_fn=tfm.attention, ffn_fn: Optional[Callable] = None,
               tp=None) -> Tuple[Tensor, Tensor]:
    """The stacked blocks ``blocks`` (every layer, or one pipeline
    stage's) over hidden ``x``: ``(x', [l] aux of each layer)``, each
    block under ``torch.utils.checkpoint`` when ``cfg.remat`` is set
    and grad is enabled."""
    layers = zip(*(torch.unbind(w) for w in blocks.values()))
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for ws in layers:
        p = dict(zip(blocks, ws))
        if remat:
            x, aux = _checkpoint.checkpoint(
                _block, cfg, x, p, attn_fn, ffn_fn, tp, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, aux = _block(cfg, x, p, attn_fn, ffn_fn, tp)
        auxs.append(aux)
    return x, torch.stack(auxs)


def lm_loss(cfg: MoETransformerConfig, params: Params, token_ids: Tensor,
            attn_fn=tfm.attention, ffn_fn: Optional[Callable] = None
            ) -> Tensor:
    """Next-token cross-entropy over the tied readout (fp32 logits of
    compute-dtype operands) plus ``aux_loss_weight`` times the mean aux
    (:247-265)."""
    hidden, aux = encode(cfg, params, token_ids, attn_fn, ffn_fn)
    logits = tfm._matmul(hidden[:, :-1], params["embed"]["tok"].t(),
                         tfm.compute_dtype(cfg))
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, token_ids[:, 1:].long()[..., None])[..., 0]
    return -ll.mean() + cfg.aux_loss_weight * aux


def make_train_step(cfg: MoETransformerConfig, mesh=None, optimizer=None,
                    attn_fn=None,
                    device: DeviceLike = None) -> Tuple[Callable, Callable]:
    """``(init_fn(generator) -> TrainState, step_fn(state, token_ids) ->
    (state, loss))`` (:274-321): ``optimizer`` defaults to
    ``updaters.adamw(1e-3, weight_decay=0.01)``, ``attn_fn=None`` to the
    causal flash kernels on CUDA; without a mesh the step is one CUDA
    graph a batch shape (``transformer.make_train_step`` has the engine
    contract).  ``mesh=`` (data x expert, run SPMD: every rank builds
    the step and calls it with the same global batch) is the reference's
    shard_map step (module docstring): the state is this rank's slice of
    the tree laid out by :func:`param_specs` (``init_fn`` keeps it; a
    carried global state goes in through ``tensor_parallel.
    shard_tree``), ``step_fn.specs`` is that layout, and the loss is the
    global batch's on every rank."""
    if mesh is None:
        def loss_fn(c, params, token_ids, generator, attn):
            return lm_loss(c, params, token_ids, attn)

        return tfm.make_train_step(cfg, init_params, loss_fn, 1e-3, None,
                                   optimizer, attn_fn, device=device,
                                   label="moe.train_step")
    return _mesh_train_step(cfg, mesh, optimizer, attn_fn, device)


def _mesh_train_step(cfg: MoETransformerConfig, mesh, optimizer, attn_fn,
                     device: DeviceLike):
    from deeplearning4j_tpu_torch.ops.flash_attention import make_attn_fn
    from deeplearning4j_tpu_torch.parallel.mesh import (check_mesh_axes,
                                                        mesh_captures)
    from deeplearning4j_tpu_torch.runtime import compile_cache

    check_mesh_axes(mesh)
    if int(mesh.shape.get(MODEL_AXIS, 1)) > 1:
        raise ValueError("moe.make_train_step(mesh=) is the data x expert "
                         "step: a model axis trains through "
                         "lm_fit.CausalLM")
    ep = int(mesh.shape.get(EXPERT_AXIS, 1))
    _check_divides(cfg.moe, ep)
    dev = resolve_device(device) if device is not None else mesh.device
    attn_fn = attn_fn or make_attn_fn("auto",
                                      mesh=tfm._local_attention_mesh(mesh))
    optimizer = optimizer or updaters.adamw(1e-3, weight_decay=0.01)
    specs = param_specs(cfg)
    tok_axes = _token_axes(mesh)
    n_shards = int(mesh.shape[DATA_AXIS]) * ep
    shard = (mesh.coords.get(DATA_AXIS, 0) * ep
             + mesh.coords.get(EXPERT_AXIS, 0))
    axis = (mesh, EXPERT_AXIS) if ep > 1 else None

    def ffn_fn(lp, tok):
        return moe_ffn(lp, tok, cfg.moe, axis_name=axis, stat_axes=tok_axes)

    def init_fn(generator: torch.Generator) -> TrainState:
        params = tpar.shard_tree(init_params(generator, cfg, dev), specs,
                                 mesh)
        return TrainState(params, optimizer.init(params), 0)

    def reduce(g, spec):
        # an expert table's gradient sums over data only, every other
        # leaf's over every token shard
        return collectives.psum(g, (mesh, DATA_AXIS if EXPERT_AXIS in spec
                                    else TOKEN_AXES))

    def graph_step(params, opt_state, ids):
        B = ids.shape[0]
        if B % n_shards:
            raise ValueError(f"batch of {B} does not split over "
                             f"{n_shards} token shards (data x expert)")
        rows = B // n_shards
        local = ids.narrow(0, shard * rows, rows)
        # this shard's loss over the shard count: the objectives of the
        # shards sum to the global batch's loss
        loss, grads = tfm.value_and_grad(
            lambda p: lm_loss(cfg, p, local, attn_fn, ffn_fn) / n_shards,
            params)
        grads = tpar._spec_map(reduce, grads, specs)
        loss = collectives.psum(loss, (mesh, TOKEN_AXES))
        updates, new_opt = optimizer.update(grads, opt_state, params)
        new_params = updaters.apply_updates(params, updates)
        with torch.no_grad():
            updaters.copy_into(params, new_params)
            updaters.copy_into(opt_state, new_opt)
        return params, opt_state, loss

    graph = compile_cache.cached_graph(graph_step, label="moe.train_step",
                                       donate_argnums=(0, 1),
                                       capture=mesh_captures(mesh))

    def step_fn(state: TrainState, token_ids):
        params, opt_state, loss = graph(state.params, state.opt_state,
                                        token_ids)
        return TrainState(params, opt_state, state.step + 1), loss

    step_fn.graph = graph
    step_fn.specs = specs
    step_fn.mesh = mesh
    return init_fn, step_fn


def synthetic_ids(seed: int, cfg: MoETransformerConfig, batch: int,
                  seq_len: int, device: DeviceLike = None) -> Tensor:
    """Seeded uniform ids ``[batch, seq_len]`` int32 (:326-329), drawn
    on the CPU so a seed gives the same ids on every device."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=gen,
                         dtype=torch.int32).to(dev)


def params_from_numpy(tree: Mapping[str, Any],
                      device: DeviceLike = None) -> Params:
    """A JAX MoE param tree as numpy (``jax.tree.map(np.asarray,
    params)`` or ``runtime.checkpoint.load_numpy_tree``) -> the port's
    on ``device``, layouts unchanged.  Raises ``KeyError`` naming any
    missing leaf."""
    dev = resolve_device(device)
    missing = [f"{grp}/{leaf}" for grp, leaves in _TREE.items()
               for leaf in leaves
               if grp not in tree or leaf not in tree[grp]]
    if missing:
        raise KeyError(f"param tree lacks {missing}")
    return {grp: {leaf: torch.from_numpy(np.array(tree[grp][leaf])).to(dev)
                  for leaf in leaves}
            for grp, leaves in _TREE.items()}
