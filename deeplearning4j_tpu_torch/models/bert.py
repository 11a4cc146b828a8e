"""BERT masked-language model in PyTorch: MLM training and fill-mask
serving.

Port of ``deeplearning4j_tpu/models/bert.py``: configs, params (the
same tree, so JAX weights carry over with :func:`params_from_numpy`),
the MLM head over tied token embeddings, the MLM loss, synthetic
batches, the one-device training step (:175-241) and the serving
forward.  The pipeline and sequence-parallel steps (:248-430) come with
the parallel slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

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


#: the JAX BERT tree -> the port's params (``transformer.params_from_numpy``)
params_from_numpy = tfm.params_from_numpy


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


def mlm_loss(cfg: TransformerConfig, params: Params, batch: Batch,
             generator: Optional[torch.Generator] = None,
             attn_fn=tfm.attention) -> Tensor:
    hidden = forward_hidden(cfg, params, batch, generator, attn_fn)
    return mlm_loss_from_hidden(cfg, params, hidden, batch)


#: the training state ``(params, opt_state, step)`` (:144)
TrainState = tfm.TrainState


def make_train_step(cfg: TransformerConfig, mesh=None, optimizer=None,
                    attn_fn=None, n_steps: int = 1,
                    device: DeviceLike = None) -> Tuple[Callable, Callable]:
    """``(init_fn(generator) -> TrainState, step_fn(state, batch,
    generator=None) -> (state, loss))`` for the MLM loss on one device,
    after ``make_train_step`` (:175-241): ``optimizer`` defaults to
    ``updaters.adamw(1e-4, weight_decay=0.01)`` (JAX's ``optax.adamw(1e-4,
    weight_decay=0.01)``), ``attn_fn=None`` to the flash kernels on CUDA
    (``transformer.make_train_step`` has the rest); the batch lives on
    ``device`` (``None`` means ``"cuda"``)."""
    return tfm.make_train_step(cfg, init_params, mlm_loss, 1e-4, mesh,
                               optimizer, attn_fn, n_steps, device,
                               label="bert.train_step")


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
