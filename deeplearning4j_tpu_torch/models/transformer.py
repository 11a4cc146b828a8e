"""Transformer encoder in PyTorch.

Port of ``deeplearning4j_tpu/models/transformer.py``: the same config,
the same parameter tree (leaf names, shapes and layouts, stacked over a
leading ``[n_layers, ...]`` axis) and the same post-LN encoder block.
Where JAX scans one block body over the stacked layers (``lax.scan``,
:290-303), this walks them with a Python loop over one ``torch.unbind``
of each stacked leaf, so the backward stacks each leaf's gradient once.
With ``cfg.remat`` set and grad enabled, each block runs under
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``, :302): its
activations are recomputed in the backward instead of kept.

Numerics, site by site, against the JAX forward:

- Matrix products take their operands in ``cfg.compute_dtype`` and,
  where JAX asks for an fp32 result (``preferred_element_type``), return
  fp32 unrounded (:func:`_matmul`); where JAX's product returns the
  compute dtype (the MLM transform, bert.py:120) so does the port's.
  What remains is summation order.  In fp32 the products are full fp32
  (``resolve_device`` turns TF32 off).  Their gradients follow JAX's
  transpose rule: each is cast to the operand's compute dtype.
- GELU is the tanh approximation (``jax.nn.gelu``'s default).
- LayerNorm runs in fp32 with biased variance, as at :181.
- Plain attention masks with -1e9 as at :202 (the flash kernel uses
  -1e5; they agree on every row with at least one live key).

Dropout takes an explicit ``torch.Generator``; serving passes none.
Everything here is differentiable, so the training steps
(``bert.make_train_step``, ``gpt.make_train_step``) take gradients
with ``torch.autograd`` through the same forward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _checkpoint

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.ops import updaters

Tensor = torch.Tensor
Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522          # BERT wordpiece vocab
    max_len: int = 512
    type_vocab_size: int = 2
    hidden: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    compute_dtype: str = "bfloat16"
    remat: bool = True               # recompute each block in the backward
    causal: bool = False             # BERT is bidirectional; GPT-style sets True

    @property
    def head_dim(self) -> int:
        if self.hidden % self.n_heads:
            raise ValueError(f"hidden {self.hidden} is not divisible by "
                             f"n_heads {self.n_heads}")
        return self.hidden // self.n_heads


def compute_dtype(cfg) -> torch.dtype:
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"compute_dtype must be one of {tuple(_DTYPES)}, "
                         f"got {cfg.compute_dtype!r}") from None


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _trunc_normal(shape, generator: torch.Generator, device: torch.device,
                  stddev: float = 0.02) -> Tensor:
    """stddev * N(0, 1) truncated to [-2, 2], as ``_trunc_normal`` (:67)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, std=stddev, a=-2 * stddev,
                                       b=2 * stddev, generator=generator)


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device: DeviceLike = None) -> Params:
    """Stacked-block parameter tree with the leaf names and shapes of
    ``init_params`` (:71-101).  ``generator`` must live on ``device``.
    The draws differ from JAX's (threefry vs Philox); parity tests carry
    JAX's params over with ``bert.params_from_numpy`` instead."""
    dev = resolve_device(device)
    H, L, Fd, NH, D = (cfg.hidden, cfg.n_layers, cfg.ffn_dim, cfg.n_heads,
                       cfg.head_dim)

    def tn(*shape):
        return _trunc_normal(shape, generator, dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    embed = {"tok": tn(cfg.vocab_size, H), "pos": tn(cfg.max_len, H),
             "type": tn(cfg.type_vocab_size, H),
             "ln_g": ones(H), "ln_b": zeros(H)}
    blocks = {
        "wq": tn(L, H, NH, D), "wk": tn(L, H, NH, D), "wv": tn(L, H, NH, D),
        "wo": tn(L, NH, D, H),
        "bq": zeros(L, NH, D), "bk": zeros(L, NH, D), "bv": zeros(L, NH, D),
        "bo": zeros(L, H),
        "ln1_g": ones(L, H), "ln1_b": zeros(L, H),
        "w1": tn(L, H, Fd), "b1": zeros(L, Fd),
        "w2": tn(L, Fd, H), "b2": zeros(L, H),
        "ln2_g": ones(L, H), "ln2_b": zeros(L, H),
    }
    return {"embed": embed, "blocks": blocks}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def layer_norm(x: Tensor, g: Tensor, b: Tensor, eps: float) -> Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), g, b, eps)


def _mm_fp32(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` of two compute-dtype operands with an fp32 result:
    products of bf16 values are exact in fp32 and summed in fp32.  On
    CUDA that is cuBLAS's bf16 product with an fp32 output
    (``out_dtype``); PyTorch's CPU build lacks that, and the CPU
    computes the same function as an fp32 product of the bf16 values."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.device.type == "cuda":
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


class _MixedMatmul(torch.autograd.Function):
    """:func:`_mm_fp32` with JAX's transpose rule for ``dot_general``
    with ``preferred_element_type`` (``lax._dot_general_transpose_lhs``
    and ``_rhs``): each operand's gradient is the fp32 cotangent's
    product with the other operand, cast to the operand's (compute)
    dtype; the caller's ``.to(cdt)`` then carries it back to the fp32
    master weight.  The product runs on the compute-dtype cotangent,
    as XLA feeds the TPU's matrix unit at default precision."""

    @staticmethod
    def forward(ctx, x: Tensor, w: Tensor) -> Tensor:
        ctx.save_for_backward(x, w)
        return _mm_fp32(x, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: Tensor):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _mm_fp32(g, w.t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = _mm_fp32(x.reshape(-1, x.shape[-1]).t(),
                          g.reshape(-1, g.shape[-1])).to(w.dtype)
        return gx, gw


def _matmul(x: Tensor, w: Tensor, cdt: torch.dtype) -> Tensor:
    """``x @ w`` with both cast to the compute dtype and an fp32 result,
    as JAX's ``preferred_element_type=float32`` products (w ``[K, N]``).
    Differentiable: in bf16 through :class:`_MixedMatmul` (PyTorch has
    no derivative for ``mm(out_dtype=)``), in fp32 as a plain fp32
    product."""
    x, w = x.to(cdt), w.to(cdt)
    if cdt == torch.float32:
        return torch.matmul(x, w)
    return _MixedMatmul.apply(x, w)


def attention(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor],
              causal: bool = False) -> Tensor:
    """Plain attention ``[B, T, NH, D] -> [B, T, NH, D]`` (:188): fp32
    logits and softmax; p cast to the input dtype before p.V with an
    fp32 sum, as JAX's ``preferred_element_type`` products."""
    cdt = q.dtype
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        # mask: [B, Tk] attention (1 = keep) -> additive
        logits = logits + (1.0 - mask.float()[:, None, None, :]) * -1e9
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(cm, logits, torch.full_like(logits, -1e9))
    probs = torch.softmax(logits, dim=-1).to(cdt)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(cdt)


def _dropout(x: Tensor, rate: float,
             generator: Optional[torch.Generator]) -> Tensor:
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    draw = torch.rand(x.shape, generator=generator, device=x.device)
    return x * (draw < keep) / keep


def _attention_sublayer(cfg, x: Tensor, p: Dict[str, Tensor],
                        mask: Optional[Tensor],
                        generator: Optional[torch.Generator],
                        attn_fn=attention) -> Tensor:
    """Attention + residual + post-LN, the first half of a block (:212)."""
    cdt = compute_dtype(cfg)
    B, T, H = x.shape
    NH, D = p["wq"].shape[1], p["wq"].shape[2]

    def proj(w, b):
        return _matmul(x, w.reshape(H, NH * D), cdt).reshape(B, T, NH, D) + b

    q = proj(p["wq"], p["bq"])
    k = proj(p["wk"], p["bk"])
    v = proj(p["wv"], p["bv"])
    a = attn_fn(q.to(cdt), k.to(cdt), v.to(cdt), mask, cfg.causal)
    a = _matmul(a.reshape(B, T, NH * D), p["wo"].reshape(NH * D, H),
                cdt) + p["bo"]
    a = _dropout(a, cfg.dropout, generator)
    return layer_norm(x + a, p["ln1_g"], p["ln1_b"], cfg.layer_norm_eps)


def _block(cfg: TransformerConfig, x: Tensor, p: Dict[str, Tensor],
           mask: Optional[Tensor], generator: Optional[torch.Generator],
           attn_fn=attention) -> Tensor:
    """One post-LN encoder block (:244): x ``[B, T, H]`` fp32."""
    cdt = compute_dtype(cfg)
    x = _attention_sublayer(cfg, x, p, mask, generator, attn_fn)
    f = _matmul(x, p["w1"], cdt) + p["b1"]
    f = F.gelu(f, approximate="tanh").to(cdt)
    f = _matmul(f, p["w2"], cdt) + p["b2"]
    f = _dropout(f, cfg.dropout, generator)
    return layer_norm(x + f, p["ln2_g"], p["ln2_b"], cfg.layer_norm_eps)


#: leaf names of the encoder groups, and of BERT's heads (models/bert.py)
_ENCODER_TREE = {
    "embed": ("tok", "pos", "type", "ln_g", "ln_b"),
    "blocks": ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo", "ln1_g",
               "ln1_b", "w1", "b1", "w2", "b2", "ln2_g", "ln2_b"),
}
_HEAD_TREE = {
    "mlm": ("w", "b", "ln_g", "ln_b", "out_b"),
    "pooler": ("w", "b"),
}


def params_from_numpy(tree: Mapping[str, Any],
                      device: DeviceLike = None) -> Params:
    """A JAX param tree as numpy arrays (from
    ``runtime.checkpoint.load_numpy_tree`` or ``jax.tree.map(np.asarray,
    params)``) -> the port's params on ``device``.  The encoder groups
    (``embed``, ``blocks``) are required; BERT's ``mlm`` and ``pooler``
    are carried when the tree has them, leaf by leaf (a GPT tree has
    neither).  Layouts stay JAX's, with no transposes (``wq`` ``[L, H,
    NH, D]``, ``wo`` ``[L, NH, D, H]``, ``w1`` ``[L, H, F]``), so the
    products read the same in both packages.  Raises ``KeyError``
    naming any missing leaf."""
    dev = resolve_device(device)
    groups = dict(_ENCODER_TREE)
    groups.update({grp: leaves for grp, leaves in _HEAD_TREE.items()
                   if grp in tree})
    missing = [f"{grp}/{leaf}" for grp, leaves in groups.items()
               for leaf in leaves
               if grp not in tree or leaf not in tree[grp]]
    if missing:
        raise KeyError(f"param tree lacks {missing}")
    return {grp: {leaf: torch.from_numpy(np.array(tree[grp][leaf]))
                  .to(dev) for leaf in leaves}
            for grp, leaves in groups.items()}


def value_and_grad(loss_fn: Callable[[Params], Tensor], params: Params):
    """``jax.value_and_grad`` over a param tree: ``(loss, grads)`` with
    the grads in the params' structure, the loss detached.  A leaf the
    loss does not read (BERT's pooler under the MLM loss) gets zeros,
    as in JAX."""
    live = updaters.tree_map(lambda p: p.detach().requires_grad_(True),
                             params)
    loss = loss_fn(live)
    grads = torch.autograd.grad(loss, updaters.tree_leaves(live),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), updaters.tree_unflatten(params, grads)


def embed(cfg: TransformerConfig, params: Params, token_ids: Tensor,
          type_ids: Optional[Tensor] = None) -> Tensor:
    """``[B, T]`` ids -> ``[B, T, H]`` fp32 (tok + pos + type, LN) (:263).
    The sequence-parallel ``position_offset`` comes with the parallel
    slice."""
    e = params["embed"]
    T = token_ids.shape[-1]
    x = e["tok"][token_ids.long()]
    x = x + e["pos"][torch.arange(T, device=token_ids.device)]
    if type_ids is not None:
        x = x + e["type"][type_ids.long()]
    return layer_norm(x, e["ln_g"], e["ln_b"], cfg.layer_norm_eps)


def encode(cfg: TransformerConfig, params: Params, token_ids: Tensor,
           mask: Optional[Tensor] = None, type_ids: Optional[Tensor] = None,
           generator: Optional[torch.Generator] = None,
           attn_fn=attention) -> Tensor:
    """Full encoder: ids ``[B, T]`` -> hidden ``[B, T, H]`` fp32 (:280),
    one block per layer of the stacked ``[L, ...]`` params, each under
    :func:`_remat_block` when ``cfg.remat`` is set and grad is enabled
    (a training step then runs each block's forward twice: B1 launches
    2 L times a step, B2 and B3 L times)."""
    x = embed(cfg, params, token_ids, type_ids)
    blocks = params["blocks"]
    # one unbind per leaf: its backward stacks the L slices' gradients
    # once, where w[layer] would build a full-size zero gradient per layer
    layers = zip(*(torch.unbind(w) for w in blocks.values()))
    remat = cfg.remat and torch.is_grad_enabled()
    for ws in layers:
        p = dict(zip(blocks, ws))
        if remat:
            x = _remat_block(cfg, x, p, mask, generator, attn_fn)
        else:
            x = _block(cfg, x, p, mask, generator, attn_fn)
    return x


def _remat_block(cfg: TransformerConfig, x: Tensor, p: Dict[str, Tensor],
                 mask: Optional[Tensor],
                 generator: Optional[torch.Generator], attn_fn) -> Tensor:
    """:func:`_block` under ``torch.utils.checkpoint``: the backward runs
    the block's forward again.  Checkpoint restores only the global RNG
    states, not an explicit generator, so the block draws its dropout
    masks from a layer generator started from the caller's state before
    the block (the port's ``jax.random.split(dropout_key, L)``, :293):
    the recompute starts a new one from the same state and draws the same
    masks.  The caller's generator moves once, to where the block left
    the layer generator, as if the block had drawn from it."""
    if generator is None:
        return _checkpoint.checkpoint(_block, cfg, x, p, mask, None, attn_fn,
                                      use_reentrant=False)
    start = generator.get_state()
    ends = []

    def body(x, p):
        layer_gen = torch.Generator(device=generator.device)
        layer_gen.set_state(start)
        out = _block(cfg, x, p, mask, layer_gen, attn_fn)
        ends.append(layer_gen.get_state())
        return out

    x = _checkpoint.checkpoint(body, x, p, use_reentrant=False)
    generator.set_state(ends[0])
    return x


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    """``(params, opt_state, step)`` of a training step (bert.py:144,
    gpt.py:109); ``step`` counts the optimizer steps taken."""
    params: Params
    opt_state: Any
    step: int


def make_train_step(cfg: TransformerConfig, init_params_fn: Callable,
                    loss_fn: Callable, learning_rate: float, mesh=None,
                    optimizer=None, attn_fn=None, n_steps: int = 1,
                    device: DeviceLike = None):
    """The one-device training step BERT and GPT share (bert.py:175-241,
    gpt.py:115-160): ``(init_fn(generator) -> TrainState,
    step_fn(state, batch, generator=None) -> (state, loss))``.

    ``init_params_fn(generator, cfg, device)`` makes the params and
    ``loss_fn(cfg, params, batch, generator, attn_fn)`` is the model's
    loss.  ``optimizer`` defaults to ``updaters.adamw(learning_rate,
    weight_decay=0.01)``; ``attn_fn=None`` takes
    ``ops.flash_attention.make_attn_fn("auto")``, so on CUDA each layer's
    forward launches B1 (again in the backward under ``cfg.remat``) and
    its backward B2 and B3.  ``n_steps > 1`` runs
    that many optimizer steps per call and returns the ``[n_steps]``
    losses, as JAX's scan does.  ``generator`` draws the dropout masks,
    on the batch's device; a config with dropout needs one, as JAX's
    step needs its key.  ``mesh=`` raises ``NotImplementedError``: it
    comes with the parallel slice.  The step is eager; nothing is
    compiled or donated, and the state it returns holds new tensors."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded training is not ported yet: it comes with the "
            "parallel slice of the port (ROADMAP Queue A)")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    dev = resolve_device(device)
    if attn_fn is None:
        from deeplearning4j_tpu_torch.ops.flash_attention import make_attn_fn
        attn_fn = make_attn_fn("auto")
    if optimizer is None:
        optimizer = updaters.adamw(learning_rate, weight_decay=0.01)

    def init_fn(generator: torch.Generator) -> TrainState:
        params = init_params_fn(generator, cfg, dev)
        return TrainState(params, optimizer.init(params), 0)

    def one_step(state: TrainState, batch, generator):
        if cfg.dropout > 0.0 and generator is None:
            raise ValueError(
                f"cfg.dropout={cfg.dropout}: pass step_fn a torch.Generator "
                f"on the batch's device for the dropout draws, or train a "
                f"config with dropout=0.0")
        loss, grads = value_and_grad(
            lambda p: loss_fn(cfg, p, batch, generator, attn_fn),
            state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = updaters.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    def step_fn(state: TrainState, batch, generator=None):
        if n_steps == 1:
            return one_step(state, batch, generator)
        losses = []
        for _ in range(n_steps):
            state, loss = one_step(state, batch, generator)
            losses.append(loss)
        return state, torch.stack(losses)

    return init_fn, step_fn
