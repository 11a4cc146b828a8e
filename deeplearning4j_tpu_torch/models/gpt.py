"""GPT-style causal language model in PyTorch: training.

Port of the training half of ``deeplearning4j_tpu/models/gpt.py``
(:35-160): the same configs, the same parameter tree (the transformer
encoder's, run with ``causal=True``; no MLM head or pooler, one token
type), the tied-embedding readout, the next-token loss and the
one-device training step.  KV-cache decoding (:167 onwards) comes with
the serving slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch import DeviceLike
from deeplearning4j_tpu_torch.models import transformer as tfm
from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

Tensor = torch.Tensor
Params = Dict[str, Any]

#: the JAX GPT tree -> the port's params (``transformer.params_from_numpy``)
params_from_numpy = tfm.params_from_numpy

#: the training state ``(params, opt_state, step)`` (:109)
TrainState = tfm.TrainState


def gpt_config(vocab_size: int = 50257, max_len: int = 1024,
               hidden: int = 768, n_layers: int = 12, n_heads: int = 12
               ) -> TransformerConfig:
    """GPT-2 small by default (:35)."""
    return TransformerConfig(vocab_size=vocab_size, max_len=max_len,
                             hidden=hidden, n_layers=n_layers,
                             n_heads=n_heads, ffn_dim=4 * hidden,
                             causal=True, type_vocab_size=1)


def gpt_tiny(vocab_size: int = 256, max_len: int = 128) -> TransformerConfig:
    """Test-sized config (same code path, toy shapes)."""
    return TransformerConfig(vocab_size=vocab_size, max_len=max_len,
                             hidden=64, n_layers=2, n_heads=4, ffn_dim=128,
                             dropout=0.0, causal=True, type_vocab_size=1)


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device: DeviceLike = None) -> Params:
    if not cfg.causal:
        raise ValueError("GPT config must be causal")
    return tfm.init_params(generator, cfg, device)


def lm_logits(cfg: TransformerConfig, params: Params,
              hidden: Tensor) -> Tensor:
    """Tied-embedding readout ``[B, T, H]`` -> ``[B, T, vocab]`` fp32
    (:84)."""
    return tfm._matmul(hidden, params["embed"]["tok"].t(),
                       tfm.compute_dtype(cfg))


def lm_loss(cfg: TransformerConfig, params: Params, token_ids: Tensor,
            mask: Optional[Tensor] = None,
            generator: Optional[torch.Generator] = None,
            attn_fn=tfm.attention) -> Tensor:
    """Next-token cross-entropy (:92): predict ``token_ids[:, 1:]`` from
    positions ``[:, :-1]``; with ``mask`` ``[B, T]`` the mean is over
    the targets ``mask[:, 1:]`` keeps."""
    hidden = tfm.encode(cfg, params, token_ids, mask, None, generator,
                        attn_fn=attn_fn)
    logits = lm_logits(cfg, params, hidden[:, :-1])
    targets = token_ids[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    if mask is not None:
        w = mask[:, 1:].float()
        return -(ll * w).sum() / torch.clamp(w.sum(), min=1.0)
    return -ll.mean()


def make_train_step(cfg: TransformerConfig, mesh=None, optimizer=None,
                    attn_fn=None,
                    device: DeviceLike = None) -> Tuple[Callable, Callable]:
    """``(init_fn(generator) -> TrainState, step_fn(state, token_ids,
    generator=None) -> (state, loss))`` for the next-token loss on one
    device, after ``make_train_step`` (:115-160): ``optimizer`` defaults
    to ``updaters.adamw(3e-4, weight_decay=0.01)``, ``attn_fn=None`` to
    the causal flash kernels on CUDA (``transformer.make_train_step``
    has the rest)."""

    def loss_fn(c, params, token_ids, generator, attn):
        return lm_loss(c, params, token_ids, None, generator, attn)

    return tfm.make_train_step(cfg, init_params, loss_fn, 3e-4, mesh,
                               optimizer, attn_fn, device=device)
