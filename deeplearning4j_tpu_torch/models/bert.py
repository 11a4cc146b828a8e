"""BERT masked-language model in PyTorch: MLM training and fill-mask
serving.

Port of ``deeplearning4j_tpu/models/bert.py``: configs, params (the
same tree, so JAX weights carry over with :func:`params_from_numpy`),
the MLM head over tied token embeddings, the MLM loss, synthetic
batches, the one-device training step (:175-241) and the serving
forward.  On a ``data x model`` mesh (:func:`shard_specs`) the encoder
is the transformer's tensor-parallel one and the MLM transform is
column-parallel, its output gathered before its LayerNorm.  The
pipeline step (:func:`make_pipeline_train_step`, :248-344) stages the
blocks over ``pipe`` through ``parallel/pipeline.pipeline_forward``;
the sequence-parallel step (:func:`make_sp_train_step`, :347-430) runs
the encoder on a rank's block of each sequence with ring attention
(``parallel/ring_attention.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.models import transformer as tfm
from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar
from deeplearning4j_tpu_torch.parallel.mesh import MODEL_AXIS
from deeplearning4j_tpu_torch.parallel.tensor_parallel import P

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


def param_specs(cfg: TransformerConfig) -> Params:
    """The reference's degree-free rules (:62-68): the encoder's, with
    the MLM head and the pooler replicated."""
    specs = tfm.param_specs(cfg)
    specs["mlm"] = {"w": P(None, None), "b": P(None), "ln_g": P(None),
                    "ln_b": P(None), "out_b": P(None)}
    specs["pooler"] = {"w": P(None, None), "b": P(None)}
    return specs


def shard_specs(cfg: TransformerConfig, model_degree: int = 1,
                pipe_degree: int = 1) -> Params:
    """The data x model layout of the BERT family (:71-90): the
    encoder's (``transformer.shard_specs``), the MLM transform
    column-parallel (``w`` ``P(None, model)``, ``b`` over ``model``),
    its output bias over vocab alongside the tied projection when the
    degree divides the vocabulary; LayerNorms and the pooler
    replicated."""
    specs = tfm.shard_specs(cfg, model_degree, pipe_degree)
    m = MODEL_AXIS if model_degree > 1 else None
    vocab_ok = model_degree > 1 and cfg.vocab_size % model_degree == 0
    specs["mlm"] = {"w": P(None, m), "b": P(m), "ln_g": P(None),
                    "ln_b": P(None),
                    "out_b": P(MODEL_AXIS) if vocab_ok else P(None)}
    specs["pooler"] = {"w": P(None, None), "b": P(None)}
    return specs


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
                   attn_fn=tfm.attention, tp=None) -> Tensor:
    return tfm.encode(cfg, params, batch.token_ids, batch.attention_mask,
                      batch.type_ids, generator, attn_fn=attn_fn, tp=tp)


def mlm_logits(cfg: TransformerConfig, params: Params,
               hidden: Tensor, tp=None) -> Tensor:
    """``[B, T, H]`` -> ``[B, T, vocab]`` fp32 via the transform and the
    tied embeddings (:116-125).  JAX's transform product (``@``) returns
    the compute dtype before its fp32 bias, as this one does.  On a
    model rank (``tp``) the transform's columns are the rank's, gathered
    before the LayerNorm, and a vocab-sharded table gives the rank's
    logit columns, gathered after the bias."""
    cdt = tfm.compute_dtype(cfg)
    m = params["mlm"]
    x = tpar.copy_to_model(hidden, tp)
    h = torch.matmul(x.to(cdt), m["w"].to(cdt)).float() + m["b"]
    h = tpar.gather_last(F.gelu(h, approximate="tanh"),
                         tp if m["w"].shape[1] != cfg.hidden else None)
    h = tfm.layer_norm(h, m["ln_g"], m["ln_b"], cfg.layer_norm_eps)
    if not tfm.vocab_sharded(cfg, params):
        return tfm._matmul(h, params["embed"]["tok"].t(), cdt) + m["out_b"]
    local = tfm._matmul(tpar.copy_to_model(h, tp),
                        params["embed"]["tok"].t(), cdt) + m["out_b"]
    return tpar.gather_last(local, tp)


def mlm_loss_from_hidden(cfg: TransformerConfig, params: Params,
                         hidden: Tensor, batch: Batch, tp=None) -> Tensor:
    logits = mlm_logits(cfg, params, hidden, tp)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, batch.labels.long()[..., None])[..., 0]
    denom = torch.clamp(batch.mlm_mask.sum(), min=1.0)
    return -(ll * batch.mlm_mask).sum() / denom


def mlm_loss(cfg: TransformerConfig, params: Params, batch: Batch,
             generator: Optional[torch.Generator] = None,
             attn_fn=tfm.attention, tp=None) -> Tensor:
    hidden = forward_hidden(cfg, params, batch, generator, attn_fn, tp)
    return mlm_loss_from_hidden(cfg, params, hidden, batch, tp)


#: the training state ``(params, opt_state, step)`` (:144)
TrainState = tfm.TrainState


def make_train_step(cfg: TransformerConfig, mesh=None, optimizer=None,
                    attn_fn=None, n_steps: int = 1,
                    device: DeviceLike = None) -> Tuple[Callable, Callable]:
    """``(init_fn(generator) -> TrainState, step_fn(state, batch,
    generator=None) -> (state, loss))`` for the MLM loss, after
    ``make_train_step`` (:175-241): ``optimizer`` defaults to
    ``updaters.adamw(1e-4, weight_decay=0.01)`` (JAX's ``optax.adamw(1e-4,
    weight_decay=0.01)``), ``attn_fn=None`` to the flash kernels on CUDA
    (``transformer.make_train_step`` has the rest); the batch lives on
    ``device`` (``None`` means ``"cuda"``, or the mesh's device).  On a
    ``data x model`` mesh the state is laid out by :func:`shard_specs`,
    and a data shard's loss weighs by its count of predicted
    positions, so the step's loss is the global batch's."""
    return tfm.make_train_step(cfg, init_params, mlm_loss, 1e-4, mesh,
                               optimizer, attn_fn, n_steps, device,
                               label="bert.train_step", specs_fn=shard_specs,
                               weight_fn=lambda b: b.mlm_mask.sum())


def _local_rows(batch: Batch, mesh) -> Batch:
    """This rank's data index's rows of a global batch."""
    from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, shard_rows
    if int(mesh.shape[DATA_AXIS]) == 1:
        return batch
    return Batch(*(shard_rows(t, mesh) for t in batch))


def _step_fns(init_params_fn, optimizer, specs, mesh, dev, grads_of):
    """``(init_fn, step_fn)`` around ``grads_of(params, batch) -> (loss,
    grads)``: the params laid out by ``specs`` (None: replicated), the
    update ``optimizer``'s, run eagerly (the steps' point-to-point shifts
    stay out of CUDA graphs)."""
    def init_fn(generator: torch.Generator) -> TrainState:
        params = init_params_fn(generator, dev)
        if specs is not None:
            params = tfm.shard_tree(params, specs, mesh)
        return TrainState(params, optimizer.init(params), 0)

    def step_fn(state: TrainState, batch: Batch):
        from deeplearning4j_tpu_torch.ops import updaters
        loss, grads = grads_of(state.params, batch)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = updaters.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    step_fn.specs = specs
    step_fn.mesh = mesh
    return init_fn, step_fn


def make_pipeline_train_step(cfg: TransformerConfig, mesh, n_micro: int,
                             optimizer=None, device: DeviceLike = None
                             ) -> Tuple[Callable, Callable]:
    """The GPipe data x pipe step on BERT (:248-344): ``(init_fn(
    generator) -> TrainState, step_fn(state, batch) -> (state, loss))``,
    every rank calling them with the same global batch.  The blocks
    split into ``mesh.shape["pipe"]`` stages (``shard_specs(...,
    pipe_degree)``: a rank holds its stage's contiguous layers, the
    model split kept on a model axis); the embedding, the pooler and the
    MLM head are replicated over ``pipe``.  A rank embeds its data
    rows, ``parallel/pipeline.pipeline_forward`` runs the blocks over
    ``n_micro`` microbatches with the attention mask riding the ring
    beside the activations, and the last stage takes the masked MLM loss
    (over the global count of predicted positions).  The replicated
    leaves' gradients (stage 0's lookup, the last stage's head) are
    summed over ``pipe``, every gradient over ``data``; the loss is the
    global batch's on every rank.  ``optimizer`` defaults to
    ``updaters.adamw(1e-4, weight_decay=0.01)``.  A config with dropout
    raises, as the reference's does."""
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.ops.flash_attention import make_attn_fn
    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.parallel import pipeline as pl
    from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                        PIPE_AXIS,
                                                        model_degree)

    optimizer = optimizer or updaters.adamw(1e-4, weight_decay=0.01)
    n_stages = int(mesh.shape[PIPE_AXIS])
    if cfg.n_layers % n_stages != 0:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pipe "
                         f"degree {n_stages}")
    if cfg.dropout != 0.0:
        raise ValueError(
            f"pipeline train step is dropout-free; got cfg.dropout="
            f"{cfg.dropout} (use dataclasses.replace(cfg, dropout=0.0))")
    dev = resolve_device(device) if device is not None else mesh.device
    specs = shard_specs(cfg, model_degree(mesh), n_stages)
    tp = tpar.model_group(mesh)
    attn = make_attn_fn("auto", mesh=mesh)
    axis = (mesh, PIPE_AXIS)
    last = mesh.pipe_rank == n_stages - 1

    def stage_fn(blocks, xm):
        x, mask = xm
        return tfm.run_blocks(cfg, blocks, x, mask, None, attn, tp), mask

    def objective(params, batch: Batch):
        x = tfm.embed(cfg, params, batch.token_ids, batch.type_ids, tp=tp)
        micro = pl.to_microbatches((x, batch.attention_mask.float()),
                                   n_micro)
        hidden, _ = pl.from_microbatches(
            pl.pipeline_forward(stage_fn, params["blocks"], micro, axis))
        den = collectives.psum(batch.mlm_mask.sum(), mesh)
        if not last:
            # every rank's backward walks the schedule's shifts
            return 0.0 * hidden.sum(), den
        logits = mlm_logits(cfg, params, hidden, tp)
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, batch.labels.long()[..., None])[..., 0]
        return -(ll * batch.mlm_mask).sum() / torch.clamp(den, min=1.0), den

    def grads_of(params, batch: Batch):
        batch = _local_rows(batch, mesh)
        loss, grads = tfm.value_and_grad(
            lambda p: objective(p, batch)[0], params)
        rest = {k: v for k, v in grads.items() if k != "blocks"}
        grads = dict(collectives.psum(rest, axis), blocks=grads["blocks"])
        if int(mesh.shape[DATA_AXIS]) > 1:
            grads = collectives.psum(grads, mesh)
        loss = collectives.psum(loss, (mesh, (DATA_AXIS, PIPE_AXIS)))
        return loss, grads

    return _step_fns(lambda g, d: init_params(g, cfg, d), optimizer, specs,
                     mesh, dev, grads_of)


def make_sp_train_step(cfg: TransformerConfig, mesh, optimizer=None,
                       device: DeviceLike = None
                       ) -> Tuple[Callable, Callable]:
    """The data x seq step on BERT (:347-430): ``(init_fn(generator) ->
    TrainState, step_fn(state, batch) -> (state, loss))``, every rank
    calling them with the same global batch.  A rank holds ``[B / dp,
    T / sp]`` tokens, embeds them at ``position_offset = seq_index * T /
    sp``, and attention is ring attention over ``(mesh, "seq")`` (B1-B3
    as its block step on the card); the masked MLM loss sums its
    numerator and denominator over ``("data", "seq")``.  The params are
    replicated and their gradients summed over ``("data", "seq")``.
    ``optimizer`` defaults to ``updaters.adamw(1e-4, weight_decay=
    0.01)``; a config with dropout raises, as the reference's does."""
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.parallel.mesh import (SEQ_AXIS,
                                                        SEQ_TOKEN_AXES)
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        make_ring_attn_fn

    optimizer = optimizer or updaters.adamw(1e-4, weight_decay=0.01)
    if cfg.dropout != 0.0:
        raise ValueError(
            f"sp train step is dropout-free; got cfg.dropout="
            f"{cfg.dropout} (use dataclasses.replace(cfg, dropout=0.0))")
    dev = resolve_device(device) if device is not None else mesh.device
    sp = int(mesh.shape[SEQ_AXIS])
    ring = make_ring_attn_fn((mesh, SEQ_AXIS))
    tokens = (mesh, SEQ_TOKEN_AXES)

    def local(batch: Batch) -> Batch:
        batch = _local_rows(batch, mesh)
        T = batch.token_ids.shape[1]
        if T % sp:
            raise ValueError(f"sequence of {T} tokens does not split over "
                             f"a seq axis of {sp}")
        tl = T // sp
        return Batch(*(t.narrow(1, mesh.seq_rank * tl, tl) for t in batch))

    def grads_of(params, batch: Batch):
        batch = local(batch)
        off = mesh.seq_rank * batch.token_ids.shape[1]

        def objective(p):
            hidden = tfm.encode(cfg, p, batch.token_ids, batch.attention_mask,
                                batch.type_ids, None, attn_fn=ring,
                                position_offset=off)
            logits = mlm_logits(cfg, p, hidden)
            logp = torch.log_softmax(logits, dim=-1)
            ll = torch.gather(logp, -1, batch.labels.long()[..., None])[..., 0]
            den = collectives.psum(batch.mlm_mask.sum(), tokens)
            return -(ll * batch.mlm_mask).sum() / torch.clamp(den, min=1.0)

        loss, grads = tfm.value_and_grad(objective, params)
        return collectives.psum((loss, grads), tokens)

    return _step_fns(lambda g, d: init_params(g, cfg, d), optimizer, None,
                     mesh, dev, grads_of)


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
