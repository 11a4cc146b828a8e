"""Mixture-of-Experts causal LM in PyTorch, on one device.

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
once.  The expert-parallel half (``param_specs``, ``shard_specs``, a
``mesh=`` with an ``expert`` axis) is ROADMAP A7.1b.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as _checkpoint

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.models import transformer as tfm
from deeplearning4j_tpu_torch.parallel.expert import MoEConfig, moe_ffn

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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet: expert "
        f"parallelism comes with the mesh's expert axis (ROADMAP A7.1b)")


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


def param_specs(cfg: MoETransformerConfig):
    """The reference's shard_map specs (:109-122): ROADMAP A7.1b."""
    raise _not_ported("param_specs (expert tables sharded over a mesh)")


def shard_specs(cfg: MoETransformerConfig, model_degree: int = 1,
                pipe_degree: int = 1, expert_degree: int = 1):
    """The reference's GSPMD specs (:125-191): ROADMAP A7.1b."""
    raise _not_ported("shard_specs (the sharded MoE layout)")


def _block(cfg: MoETransformerConfig, x: Tensor, p: Dict[str, Tensor],
           attn_fn=tfm.attention,
           ffn_fn: Optional[Callable] = None) -> Tuple[Tensor, Tensor]:
    """One post-LN causal block with an MoE FFN (:194-224): x ``[b, T,
    H]`` fp32 -> ``(x', aux)``.  ``ffn_fn(layer_params, tok) -> (y,
    aux)``, with ``layer_params = {"router", "wi", "wo"}`` and ``tok``
    ``[N, H]``, replaces the dispatch (the reference's hook)."""
    cdt = tfm.compute_dtype(cfg)
    x = tfm._attention_sublayer(cfg, x, p, None, None, attn_fn)
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
           attn_fn=tfm.attention,
           ffn_fn: Optional[Callable] = None) -> Tuple[Tensor, Tensor]:
    """ids ``[b, T]`` -> ``(hidden [b, T, H] fp32, mean aux over
    layers)`` (:227-244): token + position embedding and LayerNorm (the
    transformer's, with no type table), then each block."""
    x = tfm.embed(cfg, params, token_ids)
    blocks = params["blocks"]
    layers = zip(*(torch.unbind(w) for w in blocks.values()))
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for ws in layers:
        p = dict(zip(blocks, ws))
        if remat:
            x, aux = _checkpoint.checkpoint(
                _block, cfg, x, p, attn_fn, ffn_fn, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, aux = _block(cfg, x, p, attn_fn, ffn_fn)
        auxs.append(aux)
    return x, torch.stack(auxs).mean()


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
    (state, loss))`` on one device (:274-321): ``optimizer`` defaults to
    ``updaters.adamw(1e-3, weight_decay=0.01)``, ``attn_fn=None`` to the
    causal flash kernels on CUDA; the step is one CUDA graph a batch
    shape (``transformer.make_train_step`` has the engine contract).
    ``mesh=`` (the dp x ep shard_map step) raises: ROADMAP A7.1b."""
    if mesh is not None:
        raise _not_ported("the mesh-sharded MoE train step (mesh=)")

    def loss_fn(c, params, token_ids, generator, attn):
        return lm_loss(c, params, token_ids, attn)

    return tfm.make_train_step(cfg, init_params, loss_fn, 1e-3, None,
                               optimizer, attn_fn, device=device,
                               label="moe.train_step")


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
