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

**The model axis.**  :func:`param_specs` / :func:`shard_specs` are the
reference's layout rules (:104-169): heads and the ffn axis over
``model``, the token embedding over vocab when the degree divides it.
A rank holds its slice (:func:`shard_tree`), and the same block runs on
it: the head count is read from ``wq``'s shape, and the
``tensor_parallel`` collectives sit where GSPMD puts the reference's
(``tp``: the rank's ``ModelGroup``, None without a model axis).

Dropout takes an explicit ``torch.Generator``; serving passes none.
Everything here is differentiable, so the training steps
(``bert.make_train_step``, ``gpt.make_train_step``) take gradients
with ``torch.autograd`` through the same forward.  Weights and training
state cross between the packages through numpy trees:
:func:`params_from_numpy`, and :func:`train_state_from_numpy` /
:func:`train_state_to_numpy` for a whole ``TrainState`` (optax's AdamW
chain on the JAX side).
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
from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                    PIPE_AXIS)
from deeplearning4j_tpu_torch.parallel.tensor_parallel import P
from deeplearning4j_tpu_torch.runtime import compile_cache

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
# the model axis's layout
# ---------------------------------------------------------------------------

def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """The reference's layout rules (:104-123): heads (``wq``/``wk``/
    ``wv`` and their biases, ``wo``'s head axis) and the ffn axis
    (``w1``, ``b1``, ``w2``'s input axis) over ``model``; everything
    else replicated."""
    m = MODEL_AXIS
    embed = {"tok": P(None, None), "pos": P(None, None),
             "type": P(None, None), "ln_g": P(None), "ln_b": P(None)}
    blocks = {
        "wq": P(None, None, m, None), "wk": P(None, None, m, None),
        "wv": P(None, None, m, None), "wo": P(None, m, None, None),
        "bq": P(None, m, None), "bk": P(None, m, None),
        "bv": P(None, m, None), "bo": P(None, None),
        "ln1_g": P(None, None), "ln1_b": P(None, None),
        "w1": P(None, None, m), "b1": P(None, m),
        "w2": P(None, m, None), "b2": P(None, None),
        "ln2_g": P(None, None), "ln2_b": P(None, None),
    }
    return {"embed": embed, "blocks": blocks}


def pipe_stage_specs(block_specs, cfg, pipe_degree: int):
    """The stacked ``[n_layers, ...]`` block leaves over ``pipe``
    (:126-143), checked as the reference checks them: each stage holds
    ``n_layers / pipe_degree`` contiguous layers (``shard_tree`` cuts
    them), the trailing dimensions keep their model split."""
    if cfg.n_layers % pipe_degree:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pipe degree "
            f"{pipe_degree} — stacked layers split into equal "
            f"contiguous pipeline stages over `pipe`")
    return tpar.map_specs(lambda s: P(PIPE_AXIS, *tuple(s)[1:]),
                          block_specs)


def shard_specs(cfg: TransformerConfig, model_degree: int = 1,
                pipe_degree: int = 1) -> Dict[str, Any]:
    """The data x model (x pipe) layout of the params (:146-169):
    :func:`param_specs`, with the token embedding (and through the tied
    readout the logits) over vocab when ``model_degree`` divides the
    vocabulary, and above a ``pipe_degree`` of 1 the stacked blocks
    stage-major over ``pipe`` (:func:`pipe_stage_specs`), checked up
    front with the reference's errors."""
    if model_degree > 1:
        if cfg.n_heads % model_degree:
            raise ValueError(
                f"n_heads={cfg.n_heads} not divisible by model degree "
                f"{model_degree} — attention heads shard over `model`")
        if cfg.ffn_dim % model_degree:
            raise ValueError(
                f"ffn_dim={cfg.ffn_dim} not divisible by model degree "
                f"{model_degree} — the MLP hidden shards over `model`")
    specs = param_specs(cfg)
    if model_degree > 1 and cfg.vocab_size % model_degree == 0:
        specs["embed"]["tok"] = P(MODEL_AXIS, None)
    if pipe_degree > 1:
        specs["blocks"] = pipe_stage_specs(specs["blocks"], cfg, pipe_degree)
    return specs


#: this rank's slice of a global tree, and the global tree back
shard_tree = tpar.shard_tree
gather_tree = tpar.gather_tree


def vocab_sharded(cfg, params) -> bool:
    """Whether ``params`` holds a vocab slice of the token table."""
    return params["embed"]["tok"].shape[0] != cfg.vocab_size


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def layer_norm(x: Tensor, g: Tensor, b: Tensor, eps: float) -> Tensor:
    """fp32 LayerNorm; gains and biases in another dtype (the bf16
    serving mode casts the stacked ``[L, H]`` ones) are promoted to fp32,
    as JAX's arithmetic promotes them."""
    return F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(),
                        eps)


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
             generator: Optional[torch.Generator],
             kept: Optional[Tensor] = None) -> Tensor:
    """Inverted dropout of ``x``: the kept entries are ``kept`` (a bool
    mask drawn before, see :func:`_dropout_masks`) or a fresh draw of
    ``torch.rand(x.shape) < 1 - rate`` from ``generator``."""
    if kept is None and (generator is None or rate <= 0.0):
        return x
    keep = 1.0 - rate
    if kept is None:
        kept = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
    return x * kept / keep


def _dropout_masks(cfg, x: Tensor, generator: Optional[torch.Generator]):
    """A block's two dropout masks (attention output, then FFN output),
    drawn from ``generator`` in the order :func:`_block` draws them, so
    the same bits as the block drawing them itself; None without
    dropout."""
    if generator is None or cfg.dropout <= 0.0:
        return None
    keep = 1.0 - cfg.dropout
    return tuple(torch.rand(x.shape, generator=generator,
                            device=x.device) < keep for _ in range(2))


def _attention_sublayer(cfg, x: Tensor, p: Dict[str, Tensor],
                        mask: Optional[Tensor],
                        generator: Optional[torch.Generator],
                        attn_fn=attention,
                        kept: Optional[Tensor] = None, tp=None) -> Tensor:
    """Attention + residual + post-LN, the first half of a block (:212).
    On a model rank ``p`` holds the rank's heads; the head count comes
    from ``wq``'s shape."""
    cdt = compute_dtype(cfg)
    B, T, H = x.shape
    NH, D = p["wq"].shape[1], p["wq"].shape[2]
    h = tpar.copy_to_model(x, tp)

    def proj(w, b):
        return _matmul(h, w.reshape(H, NH * D), cdt).reshape(B, T, NH, D) + b

    q = proj(p["wq"], p["bq"])
    k = proj(p["wk"], p["bk"])
    v = proj(p["wv"], p["bv"])
    a = attn_fn(q.to(cdt), k.to(cdt), v.to(cdt), mask, cfg.causal)
    a = _matmul(a.reshape(B, T, NH * D), p["wo"].reshape(NH * D, H), cdt)
    a = tpar.reduce_from_model(a, tp) + p["bo"]
    a = _dropout(a, cfg.dropout, generator, kept)
    return layer_norm(x + a, p["ln1_g"], p["ln1_b"], cfg.layer_norm_eps)


def _block(cfg: TransformerConfig, x: Tensor, p: Dict[str, Tensor],
           mask: Optional[Tensor], generator: Optional[torch.Generator],
           attn_fn=attention, masks=None, tp=None) -> Tensor:
    """One post-LN encoder block (:244): x ``[B, T, H]`` fp32.  Dropout
    draws from ``generator``, or takes ``masks`` (from
    :func:`_dropout_masks`) when given.  Dropout acts on the replicated
    sums after ``wo`` and ``w2``, so model ranks given equal generators
    draw equal masks."""
    cdt = compute_dtype(cfg)
    kept_a, kept_f = masks if masks is not None else (None, None)
    x = _attention_sublayer(cfg, x, p, mask, generator, attn_fn, kept_a, tp)
    f = _matmul(tpar.copy_to_model(x, tp), p["w1"], cdt) + p["b1"]
    f = F.gelu(f, approximate="tanh").to(cdt)
    f = tpar.reduce_from_model(_matmul(f, p["w2"], cdt), tp) + p["b2"]
    f = _dropout(f, cfg.dropout, generator, kept_f)
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


def train_state_from_numpy(tree: Mapping[str, Any],
                           device: DeviceLike = None) -> "TrainState":
    """A JAX ``TrainState`` read as a tree (``runtime.checkpoint.
    load_numpy_tree``, or ``load_pytree`` without a template) -> the
    port's :class:`TrainState` on ``device``.  The JAX tree holds
    ``params/...``, optax's AdamW chain ``(ScaleByAdamState, EmptyState,
    EmptyState)`` as ``opt_state/0/count``, ``opt_state/0/mu/...`` and
    ``opt_state/0/nu/...``, and ``step``; the port's ``AdamWState`` is
    ``(count, mu, nu)``.  Params and moments go through
    :func:`params_from_numpy` (same layouts)."""
    dev = resolve_device(device)
    adam = tree["opt_state"]["0"]
    count = torch.from_numpy(np.array(adam["count"], dtype=np.int32)).to(dev)
    opt = updaters.AdamWState(count=count,
                              mu=params_from_numpy(adam["mu"], dev),
                              nu=params_from_numpy(adam["nu"], dev))
    return TrainState(params_from_numpy(tree["params"], dev), opt,
                      int(np.asarray(tree["step"])))


def train_state_to_numpy(state: "TrainState") -> "TrainState":
    """The port's :class:`TrainState` as numpy arrays in JAX's tree
    order: ``runtime.checkpoint.save_pytree`` of the result writes the
    paths JAX's ``TrainState`` flattens to (``params/...``,
    ``opt_state/0/count``, ``opt_state/0/mu/...``, ``opt_state/0/nu/...``,
    ``step``), so the JAX package restores it with ``like=`` its state;
    bf16 leaves come out as numpy's raw ``V2``, as JAX's are written."""
    from deeplearning4j_tpu_torch.runtime.checkpoint import _to_numpy

    opt = state.opt_state
    if not isinstance(opt, updaters.AdamWState):
        raise TypeError(f"train_state_to_numpy carries an AdamW state, "
                        f"not {type(opt).__name__}")
    adam = updaters.AdamWState(
        count=np.asarray(_to_numpy(opt.count), dtype=np.int32),
        mu=updaters.tree_map(_to_numpy, opt.mu),
        nu=updaters.tree_map(_to_numpy, opt.nu))
    # optax's chain: scale_by_adam, then two stateless transformations
    return TrainState(updaters.tree_map(_to_numpy, state.params),
                      (adam, (), ()), np.asarray(state.step, np.int32))


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


def token_embed(cfg: TransformerConfig, params: Params, token_ids: Tensor,
                tp=None) -> Tensor:
    """The token table's rows for ``token_ids``: a vocab-sharded table
    is read with ``tensor_parallel.vocab_embed`` over ``tp``."""
    tok = params["embed"]["tok"]
    if vocab_sharded(cfg, params):
        return tpar.vocab_embed(tok, token_ids, tp)
    return tok[token_ids.long()]


def embed(cfg: TransformerConfig, params: Params, token_ids: Tensor,
          type_ids: Optional[Tensor] = None,
          position_offset: int = 0, tp=None) -> Tensor:
    """``[B, T]`` ids -> ``[B, T, H]`` fp32 (tok + pos + type, LN) (:263).
    The ids sit at positions ``position_offset + [0, T)``: a KV-cache
    prefill chunk (``gpt._prefill_chunk``) or one decode step embeds its
    tokens at their absolute positions (:func:`token_embed` reads a
    vocab-sharded table)."""
    e = params["embed"]
    T = token_ids.shape[-1]
    x = token_embed(cfg, params, token_ids, tp)
    idx = torch.arange(T, device=token_ids.device) + position_offset
    x = x + e["pos"][idx]
    if type_ids is not None:
        x = x + e["type"][type_ids.long()]
    return layer_norm(x, e["ln_g"], e["ln_b"], cfg.layer_norm_eps)


def encode(cfg: TransformerConfig, params: Params, token_ids: Tensor,
           mask: Optional[Tensor] = None, type_ids: Optional[Tensor] = None,
           generator: Optional[torch.Generator] = None,
           attn_fn=attention, tp=None, position_offset: int = 0) -> Tensor:
    """Full encoder: ids ``[B, T]`` -> hidden ``[B, T, H]`` fp32 (:280):
    :func:`embed` at ``position_offset``, then :func:`run_blocks` over
    the stacked ``[L, ...]`` params (each block under
    :func:`_remat_block` when ``cfg.remat`` is set and grad is enabled:
    a training step then runs each block's forward twice, B1 launching
    2 L times a step, B2 and B3 L times).  ``tp``: this rank's model
    group when ``params`` is its shard (None: the whole model)."""
    x = embed(cfg, params, token_ids, type_ids, position_offset, tp=tp)
    return run_blocks(cfg, params["blocks"], x, mask, generator, attn_fn,
                      tp)


def run_blocks(cfg: TransformerConfig, blocks: Params, x: Tensor,
               mask: Optional[Tensor] = None,
               generator: Optional[torch.Generator] = None,
               attn_fn=attention, tp=None, masks=None) -> Tensor:
    """The stacked blocks ``blocks`` (``[l, ...]`` leaves: every layer,
    or one pipeline stage's) over hidden ``x`` ``[B, T, H]``.  Dropout
    draws from ``generator`` layer by layer, or takes ``masks`` (one
    pair a layer from :func:`_dropout_masks`) when given."""
    # one unbind per leaf: its backward stacks the l slices' gradients
    # once, where w[layer] would build a full-size zero gradient per layer
    layers = zip(*(torch.unbind(w) for w in blocks.values()))
    remat = cfg.remat and torch.is_grad_enabled()
    for i, ws in enumerate(layers):
        p = dict(zip(blocks, ws))
        m = masks[i] if masks is not None else None
        if remat:
            x = _remat_block(cfg, x, p, mask, generator, attn_fn, tp, m)
        elif m is not None:
            x = _block(cfg, x, p, mask, None, attn_fn, m, tp)
        else:
            x = _block(cfg, x, p, mask, generator, attn_fn, tp=tp)
    return x


def _remat_block(cfg: TransformerConfig, x: Tensor, p: Dict[str, Tensor],
                 mask: Optional[Tensor],
                 generator: Optional[torch.Generator], attn_fn,
                 tp=None, masks=None) -> Tensor:
    """:func:`_block` under ``torch.utils.checkpoint``: the backward runs
    the block's forward again.  The block's dropout masks are drawn
    before the checkpoint, from the caller's generator in the order the
    block would draw them (:func:`_dropout_masks`), and enter it as
    inputs, so the recompute applies the masks the forward applied (the
    port's ``jax.random.split(dropout_key, L)``, :293).  Nothing random
    happens inside the checkpoint (``preserve_rng_state=False``), and
    no generator state is read or set on the host, so the step can be
    captured as a CUDA graph: the masks cost a bool tensor of ``x``'s
    shape twice a layer, kept to the backward.  ``masks`` given (drawn
    ahead by the caller) are taken instead of a draw."""
    if masks is None:
        masks = _dropout_masks(cfg, x, generator)
    return _checkpoint.checkpoint(_block, cfg, x, p, mask, None, attn_fn,
                                  masks, tp, use_reentrant=False,
                                  preserve_rng_state=False)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    """``(params, opt_state, step)`` of a training step (bert.py:144,
    gpt.py:109); ``step`` counts the optimizer steps taken."""
    params: Params
    opt_state: Any
    step: int


def _local_attention_mesh(mesh):
    """The mesh a replicated step's attention dispatches on: ``mesh``,
    or None above a ``seq`` degree of 1, where ``make_attn_fn`` would
    take the ring, and the step holds whole sequences."""
    from deeplearning4j_tpu_torch.parallel.mesh import seq_degree
    return mesh if seq_degree(mesh) == 1 else None


def make_train_step(cfg: TransformerConfig, init_params_fn: Callable,
                    loss_fn: Callable, learning_rate: float, mesh=None,
                    optimizer=None, attn_fn=None, n_steps: int = 1,
                    device: DeviceLike = None,
                    label: str = "transformer.train_step",
                    specs_fn: Optional[Callable] = None,
                    weight_fn: Optional[Callable] = None):
    """The training step BERT and GPT share (bert.py:175-241,
    gpt.py:115-160): ``(init_fn(generator) -> TrainState,
    step_fn(state, batch, generator=None) -> (state, loss))``.

    ``init_params_fn(generator, cfg, device)`` makes the params and
    ``loss_fn(cfg, params, batch, generator, attn_fn)`` is the model's
    loss.  ``optimizer`` defaults to ``updaters.adamw(learning_rate,
    weight_decay=0.01)``; ``attn_fn=None`` takes
    ``ops.flash_attention.make_attn_fn("auto", mesh=mesh)``, so on CUDA
    each layer's forward launches B1 (again in the backward under
    ``cfg.remat``) and its backward B2 and B3.  ``n_steps > 1`` runs
    that many optimizer steps per call and returns the ``[n_steps]``
    losses, as JAX's scan does.  ``generator`` draws the dropout masks,
    on the batch's device; a config with dropout needs one, as JAX's
    step needs its key.

    **On a mesh** (``data x model``, run SPMD: every rank builds the
    step and calls it with the same global batch; a ``pipe`` or ``seq``
    axis above 1 replicates the step over it, every rank of a data index
    computing the same rows with the whole sequence, as the reference
    replicates what its specs do not split; BERT's pipeline and
    sequence-parallel steps are ``bert.make_pipeline_train_step`` and
    ``bert.make_sp_train_step``) the params and the
    optimizer state are laid out by ``specs_fn(cfg, model_degree)``
    (default :func:`shard_specs`): ``init_fn`` draws the global params
    and keeps this rank's slice, and a carried global state goes in
    through :func:`shard_tree`.  A rank trains on its data index's row
    block; ``loss_fn`` is called with ``tp=`` (the rank's model group)
    and its loss is weighted by ``weight_fn(rows)`` over the data axis's
    total (default: the row count), so the sum over the data axis is the
    loss of the global batch, which the step returns on every rank.
    Gradients are summed over the data axis only; the model axis's
    collectives are inside the forward.  ``step_fn.specs`` is the
    layout (``gather_tree(state.params, step_fn.specs, mesh)`` is the
    global tree back).  Seed ``generator`` from the data index for
    independent dropout masks a data shard.

    The optimizer step runs through the compile engine
    (``runtime/compile_cache``, as ``label``): on the card it is one
    CUDA graph a batch shape, B1-B3 inside it, unless the mesh's
    collectives cannot be captured (``parallel.mesh.mesh_captures``:
    gloo), when it runs eagerly.  The state is donated to it: a state
    the step did not return (``init_fn``'s, or one the caller made) is
    copied into the engine's buffers and never changes; a returned
    state is updated in place by the step it is passed to, and stays as
    it is while other states step (each live state has buffers of its
    own).  ``step_fn.graph`` is the engine entry (``.fn`` the raw
    step)."""
    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.parallel.mesh import (check_mesh_axes,
                                                        mesh_captures,
                                                        model_degree,
                                                        shard_rows)

    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    check_mesh_axes(mesh)
    dev = resolve_device(device) if mesh is None or device is not None \
        else mesh.device
    if attn_fn is None:
        from deeplearning4j_tpu_torch.ops.flash_attention import make_attn_fn
        attn_fn = make_attn_fn("auto", mesh=_local_attention_mesh(mesh))
    if optimizer is None:
        optimizer = updaters.adamw(learning_rate, weight_decay=0.01)
    specs = None
    tp = None
    extra = {}
    n_data = 1
    if mesh is not None:
        specs = (specs_fn or shard_specs)(cfg, model_degree(mesh))
        tp = tpar.model_group(mesh)
        extra = {"tp": tp}
        n_data = int(mesh.shape[DATA_AXIS])

    def init_fn(generator: torch.Generator) -> TrainState:
        params = init_params_fn(generator, cfg, dev)
        if specs is not None:
            params = shard_tree(params, specs, mesh)
        return TrainState(params, optimizer.init(params), 0)

    def objective(p, batch, generator):
        """This rank's share of the global batch's loss."""
        loss = loss_fn(cfg, p, batch, generator, attn_fn, **extra)
        if n_data == 1:
            return loss
        w = (weight_fn(batch) if weight_fn is not None else torch.full(
            (), float(updaters.tree_leaves(batch)[0].shape[0]),
            device=loss.device)).float().detach()
        total = collectives.psum(w, mesh)
        return loss * (w / torch.clamp(total, min=1.0))

    def graph_step(params, opt_state, batch, generator):
        if mesh is not None and n_data > 1:
            batch = updaters.tree_map(lambda t: shard_rows(t, mesh), batch)
        loss, grads = value_and_grad(
            lambda p: objective(p, batch, generator), params)
        if n_data > 1:
            loss, grads = collectives.psum((loss, grads), mesh)
        updates, new_opt = optimizer.update(grads, opt_state, params)
        new_params = updaters.apply_updates(params, updates)
        with torch.no_grad():
            updaters.copy_into(params, new_params)
            updaters.copy_into(opt_state, new_opt)
        return params, opt_state, loss

    graph = compile_cache.cached_graph(graph_step, label=label,
                                       donate_argnums=(0, 1),
                                       capture=mesh_captures(mesh))

    def one_step(state: TrainState, batch, generator):
        if cfg.dropout > 0.0 and generator is None:
            raise ValueError(
                f"cfg.dropout={cfg.dropout}: pass step_fn a torch.Generator "
                f"on the batch's device for the dropout draws, or train a "
                f"config with dropout=0.0")
        params, opt_state, loss = graph(state.params, state.opt_state,
                                        batch, generator)
        return TrainState(params, opt_state, state.step + 1), loss

    def step_fn(state: TrainState, batch, generator=None):
        if n_steps == 1:
            return one_step(state, batch, generator)
        losses = []
        for _ in range(n_steps):
            state, loss = one_step(state, batch, generator)
            losses.append(loss)
        return state, torch.stack(losses)

    step_fn.graph = graph
    step_fn.specs = specs
    step_fn.mesh = mesh
    return init_fn, step_fn
