"""BERT masked-language model in PyTorch: fill-mask serving forward.

Port of ``deeplearning4j_tpu/models/bert.py``: configs, params (the
same tree, so JAX weights carry over with :func:`params_from_numpy`),
the MLM head over tied token embeddings, the MLM loss, synthetic
batches, and the serving forward.  The training steps (:175-430) come
with the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.models import transformer as tfm
from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

Tensor = torch.Tensor
Params = Dict[str, Any]


def bert_base() -> TransformerConfig:
    return TransformerConfig(vocab_size=30522, max_len=512, hidden=768,
                             n_layers=12, n_heads=12, ffn_dim=3072)


def bert_tiny(vocab_size: int = 1024, max_len: int = 128) -> TransformerConfig:
    """Test-sized config (same code path, toy shapes)."""
    return TransformerConfig(vocab_size=vocab_size, max_len=max_len,
                             hidden=64, n_layers=2, n_heads=4, ffn_dim=128,
                             dropout=0.0)


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device: DeviceLike = None) -> Params:
    """Encoder params plus the MLM head and pooler (:48-60)."""
    dev = resolve_device(device)
    params = tfm.init_params(generator, cfg, dev)
    H = cfg.hidden

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    params["mlm"] = {
        # transform before the tied-embedding projection (BERT convention)
        "w": tfm._trunc_normal((H, H), generator, dev),
        "b": zeros(H),
        "ln_g": torch.ones(H, device=dev), "ln_b": zeros(H),
        "out_b": zeros(cfg.vocab_size),
    }
    params["pooler"] = {"w": tfm._trunc_normal((H, H), generator, dev),
                        "b": zeros(H)}
    return params


#: leaf names the forward, the MLM head and the pooler read
_TREE = {
    "embed": ("tok", "pos", "type", "ln_g", "ln_b"),
    "blocks": ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo", "ln1_g",
               "ln1_b", "w1", "b1", "w2", "b2", "ln2_g", "ln2_b"),
    "mlm": ("w", "b", "ln_g", "ln_b", "out_b"),
    "pooler": ("w", "b"),
}


def params_from_numpy(tree: Mapping[str, Any],
                      device: DeviceLike = None) -> Params:
    """The JAX BERT param tree as numpy arrays (from
    ``runtime.checkpoint.load_numpy_tree`` or ``jax.tree.map(np.asarray,
    params)``) -> the port's params on ``device``.  Layouts stay JAX's,
    with no transposes (``wq`` ``[L, H, NH, D]``, ``wo`` ``[L, NH, D,
    H]``, ``w1`` ``[L, H, F]``), so the products read the same in both
    packages.  Raises ``KeyError`` naming any missing leaf."""
    dev = resolve_device(device)
    missing = [f"{grp}/{leaf}" for grp, leaves in _TREE.items()
               for leaf in leaves
               if grp not in tree or leaf not in tree[grp]]
    if missing:
        raise KeyError(f"BERT param tree lacks {missing}")
    return {grp: {leaf: torch.from_numpy(np.array(tree[grp][leaf]))
                  .to(dev) for leaf in leaves}
            for grp, leaves in _TREE.items()}


class Batch(NamedTuple):
    """MLM batch. ``mlm_mask`` marks the (already-corrupted) predict
    positions; ``labels`` holds original ids everywhere (ignored where
    mask == 0)."""
    token_ids: Tensor       # [B, T] integer — corrupted input
    attention_mask: Tensor  # [B, T] float32, 1 = real token
    type_ids: Tensor        # [B, T] integer
    labels: Tensor          # [B, T] integer — original ids
    mlm_mask: Tensor        # [B, T] float32, 1 = position to predict


def forward_hidden(cfg: TransformerConfig, params: Params, batch: Batch,
                   generator: Optional[torch.Generator] = None,
                   attn_fn=tfm.attention) -> Tensor:
    return tfm.encode(cfg, params, batch.token_ids, batch.attention_mask,
                      batch.type_ids, generator, attn_fn=attn_fn)


def mlm_logits(cfg: TransformerConfig, params: Params,
               hidden: Tensor) -> Tensor:
    """``[B, T, H]`` -> ``[B, T, vocab]`` fp32 via the transform and the
    tied embeddings (:116-125).  JAX's transform product (``@``) returns
    the compute dtype before its fp32 bias, as this one does."""
    cdt = tfm.compute_dtype(cfg)
    m = params["mlm"]
    h = torch.matmul(hidden.to(cdt), m["w"].to(cdt)).float() + m["b"]
    h = F.gelu(h, approximate="tanh")
    h = tfm.layer_norm(h, m["ln_g"], m["ln_b"], cfg.layer_norm_eps)
    logits = tfm._matmul(h, params["embed"]["tok"].t(), cdt)
    return logits + m["out_b"]


def mlm_loss_from_hidden(cfg: TransformerConfig, params: Params,
                         hidden: Tensor, batch: Batch) -> Tensor:
    logits = mlm_logits(cfg, params, hidden)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, batch.labels.long()[..., None])[..., 0]
    denom = torch.clamp(batch.mlm_mask.sum(), min=1.0)
    return -(ll * batch.mlm_mask).sum() / denom


def synthetic_batch(seed: int, cfg: TransformerConfig, batch_size: int,
                    seq_len: int, mask_prob: float = 0.15,
                    mask_token: int = 103,
                    device: DeviceLike = None) -> Batch:
    """A random MLM batch drawn with ``np.random.default_rng(seed)``
    (the JAX version draws from a key, so the two differ by design)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    labels = rng.integers(5, cfg.vocab_size, (batch_size, seq_len),
                          dtype=np.int32)
    mlm = (rng.random((batch_size, seq_len)) < mask_prob).astype(np.float32)
    token_ids = np.where(mlm > 0, mask_token, labels).astype(np.int32)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return Batch(token_ids=t(token_ids),
                 attention_mask=t(np.ones((batch_size, seq_len), np.float32)),
                 type_ids=t(np.zeros((batch_size, seq_len), np.int32)),
                 labels=t(labels), mlm_mask=t(mlm))


def make_serving_apply(cfg: TransformerConfig, attn_fn=None):
    """``apply_fn(params, token_ids)`` for ``serving.engine.InferenceEngine``:
    token ids ``[B, T]`` (on the params' device) -> MLM logits ``[B, T,
    vocab]`` fp32, full attention mask, single segment (:452-466).

    The one deliberate difference from the JAX serving forward: attention
    goes through ``ops.flash_attention.make_attn_fn("auto")``, so on CUDA
    every layer launches the hand-written flash kernel.  JAX leaves the
    plain attention to XLA's fusion; the port has no fuser, and the plain
    attention would write the ``[B, NH, T, T]`` scores to device memory.
    ``attn_fn`` overrides that (references pass the plain attention).
    There is no cache key: PyTorch runs eagerly, nothing is compiled."""
    if attn_fn is None:
        from deeplearning4j_tpu_torch.ops.flash_attention import make_attn_fn
        attn_fn = make_attn_fn("auto")

    def apply_fn(params: Params, token_ids: Tensor) -> Tensor:
        B, T = token_ids.shape
        dev = token_ids.device
        zeros = torch.zeros((B, T), dtype=torch.int32, device=dev)
        ones = torch.ones((B, T), dtype=torch.float32, device=dev)
        batch = Batch(token_ids=token_ids, attention_mask=ones,
                      type_ids=zeros, labels=zeros, mlm_mask=ones)
        return mlm_logits(cfg, params,
                          forward_hidden(cfg, params, batch, attn_fn=attn_fn))

    return apply_fn
