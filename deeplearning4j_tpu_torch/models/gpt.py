"""GPT-style causal language model in PyTorch: training, KV-cache
generation, the continuous-batching slot substrate and scoring.

Port of ``deeplearning4j_tpu/models/gpt.py``: the same configs, the same
parameter tree (the transformer encoder's, run with ``causal=True``; no
MLM head or pooler, one token type), the tied-embedding readout, the
next-token loss and the one-device training step (:35-160); the dense
and int8 KV caches, chunked prefill, the decode step, sampling and
``generate`` (:167-440); the slot state ``serving/decode.DecodeEngine``
drives (:442-700); and the scoring forward (:1053).

Decoding differs from JAX's in three deliberate ways:

- **In place.**  JAX returns a new cache from every step and relies on
  donation to update it in place.  Here each step writes its K/V rows
  straight into the preallocated ``[L, B, T_max, NH, D]`` tensors (a
  slot's prefill through the ``k[:, slot]`` view) and returns the same
  cache object; nothing is restacked.
- **Dropped writes.**  ``slot_decode`` stores at ``(slot, pos[slot])``;
  a slot at ``pos >= T_max`` must write nothing (JAX's ``mode="drop"``).
  The port stores the row's old value back there instead of the new
  one, so the attended row ``T_max - 1`` is never overwritten.
- **Sampling keys.**  JAX's threefry draws cannot be reproduced in
  PyTorch.  The port keeps their contract: the key of a draw folds the
  request seed and the position of the logits row, never the slot or
  the step (:495), so a request gives the same tokens in any batch, on
  any slot and at any join time.  The draw is Gumbel-max over a
  counter-based integer hash of (key, vocabulary index)
  (:func:`sample_token`): integer tensor ops only up to the noise, so
  the noise is the same on the CPU and the card.  ``generate`` uses the
  same keys, so a request served by the engine and a solo ``generate``
  with its seed sample alike.

Rounding points follow JAX's decode path (:229-266): q, k and v in fp32
plus their bias, then the compute dtype; fp32 scores masked with -1e9;
an fp32 softmax cast to the compute dtype before P.V; tanh GELU; fp32
tied-embedding logits.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.models import transformer as tfm
from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar
from deeplearning4j_tpu_torch.parallel.mesh import MODEL_AXIS
from deeplearning4j_tpu_torch.parallel.tensor_parallel import P
from deeplearning4j_tpu_torch.runtime import quantize as qz

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


def shard_specs(cfg: TransformerConfig, model_degree: int = 1,
                pipe_degree: int = 1) -> Params:
    """The data x model layout of the GPT family (:56-79): the GPT tree
    is the transformer's, so ``transformer.shard_specs`` (heads and the
    ffn axis over ``model``, the tied embedding over vocab when the
    degree divides it)."""
    return tfm.shard_specs(cfg, model_degree, pipe_degree)


def slot_specs(cfg: TransformerConfig, kv_dtype: Optional[str] = None):
    """The layout of a model-sharded engine's :class:`DecodeSlots`
    (:81-100): the cache's head axis over ``model``, tokens, positions
    and int8 scales replicated."""
    h = P(None, None, None, MODEL_AXIS, None)
    if kv_dtype == "int8":
        return DecodeSlots(k=h, v=h, tokens=P(), pos=P(), k_scale=P(),
                           v_scale=P())
    return DecodeSlots(k=h, v=h, tokens=P(), pos=P())


def paged_specs(cfg: TransformerConfig, kv_dtype: Optional[str] = None):
    """The layout of a model-sharded page pool (:744-752): heads over
    ``model``, scales replicated."""
    h = P(None, None, None, MODEL_AXIS, None)
    if kv_dtype == "int8":
        return PagedKV(k=h, v=h, k_scale=P(), v_scale=P())
    return PagedKV(k=h, v=h)


def lm_logits(cfg: TransformerConfig, params: Params,
              hidden: Tensor, tp=None) -> Tensor:
    """Tied-embedding readout ``[B, T, H]`` -> ``[B, T, vocab]`` fp32
    (:84).  A vocab-sharded table (``shard_specs`` at a degree that
    divides the vocabulary) gives this rank's vocab columns, gathered
    over ``tp`` into the full logits."""
    cdt = tfm.compute_dtype(cfg)
    tok = params["embed"]["tok"]
    if not tfm.vocab_sharded(cfg, params):
        return tfm._matmul(hidden, tok.t(), cdt)
    local = tfm._matmul(tpar.copy_to_model(hidden, tp), tok.t(), cdt)
    return tpar.gather_last(local, tp)


def lm_loss(cfg: TransformerConfig, params: Params, token_ids: Tensor,
            mask: Optional[Tensor] = None,
            generator: Optional[torch.Generator] = None,
            attn_fn=tfm.attention, tp=None) -> Tensor:
    """Next-token cross-entropy (:92): predict ``token_ids[:, 1:]`` from
    positions ``[:, :-1]``; with ``mask`` ``[B, T]`` the mean is over
    the targets ``mask[:, 1:]`` keeps.  ``tp``: this rank's model group
    when ``params`` is its shard."""
    hidden = tfm.encode(cfg, params, token_ids, mask, None, generator,
                        attn_fn=attn_fn, tp=tp)
    logits = lm_logits(cfg, params, hidden[:, :-1], tp)
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
    generator=None) -> (state, loss))`` for the next-token loss, after
    ``make_train_step`` (:115-160): ``optimizer`` defaults to
    ``updaters.adamw(3e-4, weight_decay=0.01)``, ``attn_fn=None`` to
    the causal flash kernels on CUDA.  On a ``data x model`` mesh the
    params and the AdamW moments are laid out by :func:`shard_specs`
    (``transformer.make_train_step`` has the rest)."""

    def loss_fn(c, params, token_ids, generator, attn, tp=None):
        return lm_loss(c, params, token_ids, None, generator, attn, tp)

    return tfm.make_train_step(cfg, init_params, loss_fn, 3e-4, mesh,
                               optimizer, attn_fn, device=device,
                               label="gpt.train_step", specs_fn=shard_specs)


# ---------------------------------------------------------------------------
# KV-cache decoding
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Dense cache, ``[L, B, T_max, NH, D]`` each, in the compute dtype
    (:167)."""
    k: Tensor
    v: Tensor


class QKVCache(NamedTuple):
    """int8 cache (:172): the geometry of :class:`KVCache` in symmetric
    int8, with one fp32 scale per written token row (amax over its heads
    and head dims), ``k_scale``/``v_scale`` ``[L, B, T_max]``.
    Attention dequantizes the rows it reads to the compute dtype."""
    k: Tensor
    v: Tensor
    k_scale: Tensor
    v_scale: Tensor


def _kv_quant(x: Tensor, tp=None) -> Tuple[Tensor, Tensor]:
    """Fresh K/V rows ``[..., NH, D]`` -> (int8 rows, fp32 scales
    ``[...]``), one symmetric scale a row on the weight quantizer's grid
    (``runtime/quantize.QMAX``, ``SCALE_EPS``) (:186).  ``tp``: the
    model group of a rank holding a head shard; the row's amax is taken
    over every head of the group (one all-reduce), so the scale is the
    replicated engine's."""
    x = x.float()
    amax = tpar.max_over_model(x.abs().amax(dim=(-2, -1)), tp)
    scale = torch.clamp(amax, min=qz.SCALE_EPS) / qz.QMAX
    q = torch.clamp(torch.round(x / scale[..., None, None]),
                    -qz.QMAX, qz.QMAX).to(torch.int8)
    return q, scale


def _kv_load(q: Tensor, scale: Tensor, cdt: torch.dtype) -> Tensor:
    """Cache rows back to the compute dtype (:201)."""
    return (q.float() * scale[..., None, None]).to(cdt)


def _kv_dtype(kv_dtype: Optional[str]) -> Optional[str]:
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8': {kv_dtype!r}")
    return kv_dtype


def init_cache(cfg: TransformerConfig, batch: int,
               max_len: Optional[int] = None,
               kv_dtype: Optional[str] = None,
               device: DeviceLike = None, model_degree: int = 1):
    """A zeroed :class:`KVCache` (``kv_dtype=None``) or
    :class:`QKVCache` (``"int8"``) of ``max_len`` rows (default
    ``cfg.max_len``) on ``device`` (:207); a model rank's holds its
    ``n_heads / model_degree`` heads."""
    dev = resolve_device(device)
    T = max_len or cfg.max_len
    shape = (cfg.n_layers, batch, T, cfg.n_heads // model_degree,
             cfg.head_dim)
    if _kv_dtype(kv_dtype) is None:
        cdt = tfm.compute_dtype(cfg)
        return KVCache(torch.zeros(shape, dtype=cdt, device=dev),
                       torch.zeros(shape, dtype=cdt, device=dev))
    sshape = shape[:3]
    return QKVCache(torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(sshape, dtype=torch.float32, device=dev),
                    torch.zeros(sshape, dtype=torch.float32, device=dev))


def _store(buf: Tensor, index, val: Tensor,
           drop: Optional[Tensor]) -> None:
    """``buf[index] = val``; where ``drop`` (one flag a leading row of
    ``val``) is set, the old value is stored back instead."""
    if drop is not None:
        keep = drop.reshape(drop.shape + (1,) * (val.ndim - drop.ndim))
        val = torch.where(keep, buf[index], val)
    buf[index] = val


def _store_kv(cache, layer: int, index, k1: Tensor, v1: Tensor,
              cdt: torch.dtype, drop: Optional[Tensor] = None,
              tp=None) -> None:
    """Store a layer's fresh fp32 K/V rows at ``index`` of the layer's
    rows (quantized with their scales for an int8 cache, else cast to
    ``cdt``); ``cache`` is any tuple with ``k``/``v`` (and
    ``k_scale``/``v_scale``) fields: slots, a dense cache, a page pool.
    ``tp``: the model group whose heads share an int8 row's scale."""
    k_scale = getattr(cache, "k_scale", None)
    if k_scale is None:
        _store(cache.k[layer], index, k1.to(cdt), drop)
        _store(cache.v[layer], index, v1.to(cdt), drop)
        return
    for buf, sbuf, x in ((cache.k, k_scale, k1),
                         (cache.v, cache.v_scale, v1)):
        q, s = _kv_quant(x, tp)
        _store(buf[layer], index, q, drop)
        _store(sbuf[layer], index, s, drop)


def _read_kv(cache, layer: int, cdt: torch.dtype, rows=None
             ) -> Tuple[Tensor, Tensor]:
    """A layer's K/V in ``cdt`` for attention: every leading row, or
    ``rows(t)`` of each buffer (an index or gather of its leading
    axes)."""
    k_scale = getattr(cache, "k_scale", None)
    pick = rows or (lambda t: t)
    if k_scale is None:
        return pick(cache.k[layer]), pick(cache.v[layer])
    return (_kv_load(pick(cache.k[layer]), pick(k_scale[layer]), cdt),
            _kv_load(pick(cache.v[layer]), pick(cache.v_scale[layer]), cdt))


def _write_kv(cache, layer: int, index, k1: Tensor, v1: Tensor,
              cdt: torch.dtype, drop: Optional[Tensor] = None,
              select: Optional[Tensor] = None,
              tp=None) -> Tuple[Tensor, Tensor]:
    """Store a layer's fresh fp32 K/V rows at ``index`` of its ``[B,
    T_max]`` rows (quantized for an int8 cache, else cast to ``cdt``)
    and return the layer's K/V in ``cdt`` for attention: every row, or
    the leading rows ``select`` (an index tensor)."""
    _store_kv(cache, layer, index, k1, v1, cdt, drop, tp)
    return _read_kv(cache, layer, cdt, None if select is None
                    else (lambda t: t.index_select(0, select)))


def _heads_fp32(x: Tensor) -> Tensor:
    """``[B, T, NH, D]`` -> ``[B, NH, T, D]`` fp32, contiguous: one pass
    that converts and lays out, so the batched products below read it as
    ``[B * NH, T, D]`` without another copy."""
    return x.transpose(1, 2).to(torch.float32,
                                memory_format=torch.contiguous_format)


def _cache_attention(q: Tensor, k: Tensor, v: Tensor,
                     masked: Tensor) -> Tensor:
    """q ``[B, C, NH, D]`` over the cached k, v ``[B, T, NH, D]``, all in
    the compute dtype; ``masked`` (True = not attended) broadcasts to
    ``[B, NH, C, T]``.  fp32 scores masked with -1e9, fp32 softmax cast
    to the compute dtype, fp32 P.V (:247-252).  Returns fp32 ``[B, NH,
    C, D]``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(_heads_fp32(q), _heads_fp32(k).transpose(-1, -2))
    probs = torch.softmax((s * scale).masked_fill(masked, -1e9),
                          dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), _heads_fp32(v))


def _cached_stack(cfg: TransformerConfig, params: Params, x: Tensor,
                  write: Callable, masked: Tensor, tp=None) -> Tensor:
    """Every block over ``x`` ``[B, C, H]`` fp32 at cached positions:
    ``write(layer, k1, v1)`` stores the fresh fp32 K/V ``[B, C, NH, D]``
    and returns the layer's cached K/V to attend (:229-264).  ``tp``:
    the model group of a rank holding a head shard."""
    cdt = tfm.compute_dtype(cfg)
    B, C, H = x.shape
    blocks = serving_params(cfg, params)["blocks"]
    # a model rank's heads (its share of wq's head axis); the products
    # after wo and w2 are partial sums, summed over tp
    NH, D, eps = blocks["wq"].shape[2], cfg.head_dim, cfg.layer_norm_eps
    for layer, ws in enumerate(zip(*(torch.unbind(w)
                                     for w in blocks.values()))):
        p = dict(zip(blocks, ws))
        h = x.to(cdt)                       # once for q, k and v

        def proj(w, b):
            return tfm._matmul(h, w.reshape(H, NH * D),
                               cdt).reshape(B, C, NH, D) + b

        q = proj(p["wq"], p["bq"])
        k_read, v_read = write(layer, proj(p["wk"], p["bk"]),
                               proj(p["wv"], p["bv"]))
        a = _cache_attention(q.to(cdt), k_read, v_read, masked)
        a = a.transpose(1, 2).to(cdt, memory_format=torch.contiguous_format)
        a = tfm._matmul(a.reshape(B, C, NH * D),
                        p["wo"].reshape(NH * D, H), cdt)
        a = tpar.reduce_from_model(a, tp) + p["bo"]
        x = tfm.layer_norm(x + a, p["ln1_g"], p["ln1_b"], eps)
        f = tfm._matmul(x, p["w1"], cdt) + p["b1"]
        f = F.gelu(f, approximate="tanh").to(cdt)
        f = tpar.reduce_from_model(tfm._matmul(f, p["w2"], cdt), tp) \
            + p["b2"]
        x = tfm.layer_norm(x + f, p["ln2_g"], p["ln2_b"], eps)
    return x


#: the block leaves every product casts to the compute dtype
_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w1", "w2")


def serving_params(cfg: TransformerConfig, params: Params) -> Params:
    """``params`` with the block product weights in the compute dtype:
    one cast of each stacked ``[L, ...]`` leaf in place of one a layer
    and a dispatch.  The products see the same values (``_matmul`` casts
    to the compute dtype either way); embeddings, gains and biases keep
    their dtype.  A tree already in the compute dtype comes back as it
    is, so a caller that keeps the result pays the casts once."""
    cdt = tfm.compute_dtype(cfg)
    blocks = params["blocks"]
    if all(blocks[n].dtype == cdt for n in _MATMUL_LEAVES):
        return params
    cast = dict(blocks)
    for n in _MATMUL_LEAVES:
        cast[n] = blocks[n].to(cdt)
    return {**params, "blocks": cast}


def _decode_step(cfg: TransformerConfig, params: Params, cache,
                 token: Tensor, pos: int):
    """One token a row through the stack at position ``pos`` (a host
    int), writing its K/V into ``cache`` (:214).  token ``[B]``.
    Returns ``(cache, logits [B, vocab] fp32)``; the cache is updated
    in place."""
    cdt = tfm.compute_dtype(cfg)
    T_max = cache.k.shape[2]
    x = tfm.embed(cfg, params, token[:, None], None, pos)
    masked = torch.arange(T_max, device=x.device) > pos
    x = _cached_stack(cfg, params, x, lambda layer, k1, v1: _write_kv(
        cache, layer, (slice(None), pos), k1[:, 0], v1[:, 0], cdt),
        masked)
    return cache, lm_logits(cfg, params, x)[:, 0, :]


def _prefill_chunk(cfg: TransformerConfig, params: Params, cache,
                   toks: Tensor, start: int):
    """One dense prefill chunk (:269): ``toks`` ``[B, C]`` at positions
    ``start + [0, C)`` through the stack, their K/V written into the
    cache as a C-wide slab, causal attention over the cached prefix and
    the chunk.  ``cache`` may be a :class:`QKVCache`.  Returns ``(cache,
    logits [B, C, vocab])``; the cache is updated in place.  Padding
    rows after the real ones are never attended by a real row."""
    cdt = tfm.compute_dtype(cfg)
    C = toks.shape[1]
    T_max = cache.k.shape[2]
    if start + C > T_max:
        raise ValueError(f"prefill chunk at {start} + {C} runs past the "
                         f"cache's {T_max} rows")
    x = tfm.embed(cfg, params, toks, None, start)
    cols = torch.arange(T_max, device=x.device)
    masked = cols[None, :] > (start + torch.arange(C, device=x.device)
                              )[:, None]
    x = _cached_stack(cfg, params, x, lambda layer, k1, v1: _write_kv(
        cache, layer, (slice(None), slice(start, start + C)), k1, v1, cdt),
        masked)
    return cache, lm_logits(cfg, params, x)


#: default dense-prefill chunk width (positions a slab); prompts are
#: right-padded to whole chunks (:355)
PREFILL_CHUNK = 32


def prefill_cache(cfg: TransformerConfig, params: Params, cache,
                  prompt: Tensor, chunk: int = PREFILL_CHUNK):
    """Chunked dense prefill (:360): ``prompt`` ``[B, T_p]`` into
    ``cache`` in ``min(chunk, T_p)``-wide slabs, right-padded.  Returns
    ``(cache, logits [B, vocab])`` at the last prompt position, from the
    last valid row of the last chunk."""
    T_p = prompt.shape[1]
    C = min(chunk, T_p)
    n_chunks = -(-T_p // C)
    toks = F.pad(prompt, (0, n_chunks * C - T_p))
    for c in range(n_chunks):
        cache, logits = _prefill_chunk(cfg, params, cache,
                                       toks[:, c * C:(c + 1) * C], c * C)
    return cache, logits[:, T_p - (n_chunks - 1) * C - 1]


# -- sampling ---------------------------------------------------------------

_M32 = 0xFFFFFFFF
_HASH_MUL = 0x45D9F3B           # odd, < 2**27: products stay below 2**59
_VOCAB_SALT = 0x68E31DA4
_vocab_hash_cache: Dict[Tuple[int, str], Tensor] = {}


def _hash32(x):
    """A bijective 32-bit integer mixer, for Python ints or int64
    tensors holding values in ``[0, 2**32)``: shifts, xors and products
    by an odd constant below ``2**27``, so no int64 intermediate reaches
    ``2**63`` and the CPU and the card compute the same bits."""
    x = ((x >> 16) ^ x) * _HASH_MUL & _M32
    x = ((x >> 16) ^ x) * _HASH_MUL & _M32
    return (x >> 16) ^ x


def _slot_key(seed, pos):
    """The sampling key of (request seed, position of the logits row)
    (:495): Python ints in, a Python int out; int64 tensors in, a
    tensor out.  Never the slot or the step."""
    return _hash32(_hash32(seed & _M32) ^ (pos & _M32))


def _vocab_hash(vocab: int, device: torch.device) -> Tensor:
    key = (vocab, str(device))
    h = _vocab_hash_cache.get(key)
    if h is None:
        idx = torch.arange(vocab, dtype=torch.int64, device=device)
        h = _vocab_hash_cache[key] = _hash32(idx + _VOCAB_SALT)
    return h


def _gumbel(key, vocab: int, device: torch.device) -> Tensor:
    """Gumbel noise ``[..., vocab]`` fp64 for int key(s) ``[...]``: one
    32-bit counter hash a (key, vocabulary index), mapped to a uniform
    in (0, 1)."""
    if isinstance(key, Tensor):
        key = key[..., None]
    bits = _hash32(_vocab_hash(vocab, device) ^ key)
    u = (bits.double() + 0.5) * 2.0 ** -32
    return -torch.log(-torch.log(u))


def sample_token(logits: Tensor, key, temperature) -> Tensor:
    """One draw ``[..., vocab]`` -> ``[...]`` int32 (:388): categorical at
    ``temperature > 0`` (Gumbel-max of ``logits / temperature`` with the
    noise of ``key`` from :func:`_slot_key`), greedy argmax (first index
    on ties) at ``temperature <= 0``.  ``key`` and ``temperature`` are
    host scalars or tensors of ``logits``' leading shape."""
    greedy = logits.argmax(dim=-1)
    if not isinstance(temperature, Tensor) and temperature <= 0.0:
        return greedy.to(torch.int32)
    g = _gumbel(key, logits.shape[-1], logits.device)
    if isinstance(temperature, Tensor):
        t = torch.clamp(temperature, min=1e-6).double()[..., None]
    else:
        t = max(float(temperature), 1e-6)
    sampled = (logits.double() / t + g).argmax(dim=-1)
    if isinstance(temperature, Tensor):
        sampled = torch.where(temperature > 0.0, sampled, greedy)
    return sampled.to(torch.int32)


@torch.inference_mode()
def generate(cfg: TransformerConfig, params: Params, prompt: Tensor,
             n_tokens: int, seed: int = 0, temperature: float = 1.0,
             max_len: Optional[int] = None,
             prefill_chunk: int = PREFILL_CHUNK,
             kv_dtype: Optional[str] = None, return_logits: bool = False):
    """``n_tokens`` continuations of ``prompt`` ``[B, T_p]`` (on the
    params' device): chunked dense prefill, then one decode step a token
    (:400).  ``temperature <= 0`` decodes greedily.  Row ``b`` samples
    with the keys of ``seed ^ _hash32(b)`` (:func:`_slot_key`), so the
    rows draw independent noise, as JAX's batched categorical does, and
    row 0 (``_hash32(0) == 0``) samples as a request of ``seed`` does in
    ``serving/decode.DecodeEngine``.  Returns the tokens
    ``[B, n_tokens]`` int32 and, with ``return_logits``, the fp32 logits
    ``[B, n_tokens, vocab]`` each token was drawn from."""
    B, T_p = prompt.shape
    T_max = max_len or cfg.max_len
    if T_p + n_tokens > T_max:
        raise ValueError(f"prompt {T_p} + {n_tokens} exceeds max {T_max}")
    params = serving_params(cfg, params)
    cache = init_cache(cfg, B, T_max, kv_dtype, prompt.device)
    cache, logits = prefill_cache(cfg, params, cache, prompt,
                                  chunk=prefill_chunk)
    seeds = (seed & _M32) ^ _hash32(
        torch.arange(B, dtype=torch.int64, device=prompt.device))
    toks, seen = [], []
    for i in range(n_tokens):
        pos = T_p - 1 + i                       # the logits row's position
        key = _slot_key(seeds, pos) if temperature > 0.0 else None
        nxt = sample_token(logits, key, temperature)
        toks.append(nxt)
        if return_logits:
            seen.append(logits)
        if i + 1 < n_tokens:
            cache, logits = _decode_step(cfg, params, cache, nxt, pos + 1)
    out = torch.stack(toks, dim=1)
    return (out, torch.stack(seen, dim=1)) if return_logits else out


def forward_logits(cfg: TransformerConfig, params: Params,
                   token_ids: Tensor, attn_fn=tfm.attention) -> Tensor:
    """Dense forward without a cache, ``[B, T]`` -> ``[B, T, vocab]`` fp32
    (:431), with the plain attention unless ``attn_fn`` says otherwise."""
    return lm_logits(cfg, params,
                     tfm.encode(cfg, params, token_ids, attn_fn=attn_fn))


def make_serving_apply(cfg: TransformerConfig, attn_fn=None):
    """``apply_fn(params, token_ids)`` for ``serving.engine.
    InferenceEngine``: ids ``[B, T]`` -> next-token logits ``[B, T,
    vocab]`` fp32 through the dense causal forward (:1053).  As
    ``bert.make_serving_apply``, attention goes through
    ``ops.flash_attention.make_attn_fn("auto")``, so on CUDA every layer
    launches the flash kernel with the causal mask; ``attn_fn``
    overrides that."""
    if attn_fn is None:
        from deeplearning4j_tpu_torch.ops.flash_attention import make_attn_fn
        attn_fn = make_attn_fn("auto")

    def apply_fn(params: Params, token_ids: Tensor) -> Tensor:
        return forward_logits(cfg, params, token_ids, attn_fn)

    return apply_fn


# ---------------------------------------------------------------------------
# slot-structured decoding (the continuous-batching substrate)
# ---------------------------------------------------------------------------

class DecodeSlots(NamedTuple):
    """Decode state of S concurrent sequences (:442), updated in place:

    - ``k``/``v``: the slot cache ``[L, S, T_max, NH, D]``, in the
      compute dtype, or int8 with ``k_scale``/``v_scale`` ``[L, S,
      T_max]`` fp32 (``init_slots(kv_dtype="int8")``);
    - ``tokens`` ``[S]`` int32: each slot's current token, sampled but
      not yet written to the cache;
    - ``pos`` ``[S]`` int32: the position that token will take.
    """
    k: Tensor
    v: Tensor
    tokens: Tensor
    pos: Tensor
    k_scale: Optional[Tensor] = None
    v_scale: Optional[Tensor] = None


def init_slots(cfg: TransformerConfig, n_slots: int,
               max_len: Optional[int] = None,
               kv_dtype: Optional[str] = None,
               device: DeviceLike = None,
               model_degree: int = 1) -> DecodeSlots:
    """Zeroed :class:`DecodeSlots` of ``max_len`` rows (:462), a model
    rank's heads of them (:func:`slot_specs`)."""
    c = init_cache(cfg, n_slots, max_len, kv_dtype, device, model_degree)
    dev = c.k.device
    idx = (torch.zeros(n_slots, dtype=torch.int32, device=dev),
           torch.zeros(n_slots, dtype=torch.int32, device=dev))
    if isinstance(c, QKVCache):
        return DecodeSlots(c.k, c.v, *idx, k_scale=c.k_scale,
                           v_scale=c.v_scale)
    return DecodeSlots(c.k, c.v, *idx)


def slots_bytes_per_slot(cfg: TransformerConfig, t_max: int,
                         kv_dtype: Optional[str] = None,
                         model_degree: int = 1) -> int:
    """KV bytes one slot of a ``t_max`` bucket costs (:481), the scale
    rows of an int8 cache included; on a model rank, its heads'."""
    elems = (cfg.n_layers * t_max * (cfg.n_heads // model_degree)
             * cfg.head_dim)
    if _kv_dtype(kv_dtype) == "int8":
        return 2 * elems + 2 * cfg.n_layers * t_max * 4
    return 2 * elems * torch.empty((), dtype=tfm.compute_dtype(cfg)
                                   ).element_size()


def slot_prefill(cfg: TransformerConfig, params: Params,
                 slots: DecodeSlots, toks: Tensor, slot, start, n_valid,
                 temperature, seed, tp=None):
    """Prefill one chunk ``toks`` ``[C]`` of a prompt into ``slot`` at
    positions ``start + [0, n_valid)`` (rows past ``n_valid`` are
    padding), writing the slot's cache rows while the other slots stay
    untouched (:503).  Samples the slot's next token from the last valid
    row (meaningful for a prompt's last chunk) with the key of ``(seed,
    start + n_valid - 1)`` and records it with ``pos = start +
    n_valid``.  ``slot``, ``start``, ``n_valid`` and ``seed`` are ints
    or 0-d integer tensors on the cache's device, ``temperature`` a
    float or a 0-d fp32 tensor: as tensors, one CUDA graph serves every
    slot and chunk (``serving/decode.DecodeEngine`` passes them so).
    ``tp``: the model group of a head-sharded engine.  Returns
    ``(slots, first_token)``, a 0-d int32 tensor."""
    cdt = tfm.compute_dtype(cfg)
    dev = toks.device
    C = toks.shape[0]
    T_max = slots.k.shape[2]
    if not isinstance(start, Tensor) and start + C > T_max:
        raise ValueError(f"prefill chunk at {start} + {C} runs past the "
                         f"cache's {T_max} rows")
    sel = torch.as_tensor(slot, device=dev).long().reshape(1)
    start = torch.as_tensor(start, device=dev).long()
    n_valid = torch.as_tensor(n_valid, device=dev).long()
    rows = start + torch.arange(C, device=dev)
    x = tfm.embed(cfg, params, toks[None, :], None, start, tp)
    masked = torch.arange(T_max, device=dev)[None, :] > rows[:, None]
    index = (sel[:, None], rows[None, :])
    x = _cached_stack(cfg, params, x, lambda layer, k1, v1: _write_kv(
        slots, layer, index, k1, v1, cdt, select=sel, tp=tp), masked, tp)
    logits = lm_logits(cfg, params, x, tp)[0]
    end = start + n_valid
    last = logits.index_select(0, (n_valid - 1).reshape(1))[0]
    first = sample_token(last, _slot_key(seed, end - 1), temperature)
    slots.tokens.index_put_((sel,), first.reshape(1))
    slots.pos.index_put_((sel,), end.to(slots.pos.dtype).reshape(1))
    return slots, first


def slot_decode(cfg: TransformerConfig, params: Params,
                slots: DecodeSlots, active: Tensor, temperature: Tensor,
                seeds: Tensor, return_logits: bool = False, tp=None):
    """Advance every slot one token in one pass (:547): slot s feeds its
    token at ``pos[s]``, stores its K/V at ``(s, pos[s])`` and attends
    its rows ``<= pos[s]``; it samples at ``temperature[s]`` with the
    key of ``(seeds[s], pos[s])`` (``seeds`` int64).  Inactive slots
    compute alongside, and their tokens and positions stay; their writes
    land where the slot's next occupant writes before it reads.  A slot
    at ``pos >= T_max`` writes nothing.  ``tp``: the model group of a
    head-sharded engine.  Returns ``(slots, tokens [S])``: the new
    tokens of active slots, the current ones of the rest."""
    cdt = tfm.compute_dtype(cfg)
    S = slots.tokens.shape[0]
    T_max = slots.k.shape[2]
    pos = slots.pos.long()
    index = (torch.arange(S, device=pos.device),
             torch.clamp(pos, max=T_max - 1))
    drop = pos >= T_max
    out, logits = _decode_rows(
        cfg, params, slots.tokens, slots.pos,
        lambda layer, k1, v1: _write_kv(slots, layer, index, k1[:, 0],
                                        v1[:, 0], cdt, drop, tp=tp),
        T_max, active, temperature, seeds, tp)
    return (slots, out, logits) if return_logits else (slots, out)


def make_slot_fns(cfg: TransformerConfig):
    """``(prefill_fn, decode_fn)`` for ``serving/decode.DecodeEngine``
    (:682): :func:`slot_prefill` and :func:`slot_decode` with the config
    bound."""
    def prefill_fn(params, slots, toks, slot, start, n_valid,
                   temperature, seed):
        return slot_prefill(cfg, params, slots, toks, slot, start,
                            n_valid, temperature, seed)

    def decode_fn(params, slots, active, temperature, seeds):
        return slot_decode(cfg, params, slots, active, temperature, seeds)

    return prefill_fn, decode_fn


def slot_read_pages(slots: DecodeSlots, slot, m: Optional[int] = None):
    """A copy of one slot's first ``m`` cache rows (default all) for
    the prefix store (:643): ``(k, v)`` ``[L, m, NH, D]``, plus
    ``(k_scale, v_scale)`` ``[L, m]`` for an int8 cache.  ``slot`` is an
    int or a 0-d integer tensor.  A pure read into fresh buffers: later
    dispatches that update the slots in place cannot reach the copy."""
    sel = torch.as_tensor(slot, device=slots.k.device).long().reshape(1)
    m = slots.k.shape[2] if m is None else int(m)
    leaves = (slots.k, slots.v) if slots.k_scale is None else (
        slots.k, slots.v, slots.k_scale, slots.v_scale)
    return tuple(t[:, :, :m].index_select(1, sel)[:, 0] for t in leaves)


def slot_write_pages(slots: DecodeSlots, slot, k: Tensor, v: Tensor,
                     k_scale: Optional[Tensor] = None,
                     v_scale: Optional[Tensor] = None) -> DecodeSlots:
    """Copy stored prefix rows ``[L, m, NH, D]`` (and ``[L, m]`` scales
    for an int8 cache) over ``slot``'s first ``m`` rows, in place: the
    prefix HIT path (:661).  The slot's later rows keep what they held;
    a row is attended only at positions ``<= pos``, and every position
    up to ``pos`` past the prefix is written by the remaining prefill
    chunks and decode steps before it is reached.  ``tokens``/``pos``
    are untouched (the last prefill chunk sets them)."""
    m = k.shape[1]
    sel = torch.as_tensor(slot, device=slots.k.device).long()
    pairs = [(slots.k, k), (slots.v, v)]
    if slots.k_scale is not None:
        pairs += [(slots.k_scale, k_scale), (slots.v_scale, v_scale)]
    for dst, src in pairs:
        dst[:, :, :m].index_copy_(1, sel.reshape(1),
                                  src.to(dst.device, non_blocking=True
                                         )[:, None])
    return slots


# ---------------------------------------------------------------------------
# paged KV storage
# ---------------------------------------------------------------------------

class PagedKV(NamedTuple):
    """A pool of fixed-size KV pages ``[L, P, C, NH, D]``, C tokens a
    page (:704).  A slot's cache is a host-side page table mapping its
    chunk-aligned position ranges onto pool pages, so memory holds only
    the pages live tokens occupy.  Page 0 is the reserved trash page:
    unused table entries point at it and writes of inactive slots and
    out-of-range positions land in it, so a freed page can go to another
    slot without scrubbing.  int8 pools carry per-row scales ``[L, P,
    C]`` (the grid of :class:`QKVCache`)."""
    k: Tensor
    v: Tensor
    k_scale: Optional[Tensor] = None
    v_scale: Optional[Tensor] = None


def init_pages(cfg: TransformerConfig, n_pages: int, page_tokens: int,
               kv_dtype: Optional[str] = None,
               device: DeviceLike = None,
               model_degree: int = 1) -> PagedKV:
    """A zeroed pool of ``n_pages`` pages of ``page_tokens`` rows
    (:723), a model rank's heads of them (:func:`paged_specs`)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_tokens,
             cfg.n_heads // model_degree, cfg.head_dim)
    if _kv_dtype(kv_dtype) is None:
        cdt = tfm.compute_dtype(cfg)
        return PagedKV(torch.zeros(shape, dtype=cdt, device=dev),
                       torch.zeros(shape, dtype=cdt, device=dev))
    sshape = shape[:3]
    return PagedKV(torch.zeros(shape, dtype=torch.int8, device=dev),
                   torch.zeros(shape, dtype=torch.int8, device=dev),
                   torch.zeros(sshape, dtype=torch.float32, device=dev),
                   torch.zeros(sshape, dtype=torch.float32, device=dev))


def pages_bytes(cfg: TransformerConfig, n_pages: int, page_tokens: int,
                kv_dtype: Optional[str] = None,
                model_degree: int = 1) -> int:
    """Bytes of a pool (:737), the paged engine's memory denominator
    (the gathered attention views are transient)."""
    return n_pages * slots_bytes_per_slot(cfg, page_tokens, kv_dtype,
                                          model_degree)


def _paged_view(pool: PagedKV, ptab: Tensor, layer: int, cdt: torch.dtype
                ) -> Tuple[Tensor, Tensor]:
    """One layer's slot-structured view ``[S, TBL*C, NH, D]`` in ``cdt``
    of the pages ``ptab`` ``[S, TBL]`` names (:758).  The reference
    gathers every layer at once; here the view is one layer's, built
    right after the layer's fresh rows are scattered into the pool
    (:func:`_paged_write`), so the transient is one layer, not L.  At 8
    slots x bucket 1024 in bf16 GPT-2 small's gather reads and writes
    25.2 MB a layer, about 604 MB a decode step."""
    S, TBL = ptab.shape
    idx = ptab.long()

    def rows(t):
        g = t[idx]                              # [S, TBL, C, ...]
        return g.reshape((S, TBL * g.shape[2]) + g.shape[3:])

    return _read_kv(pool, layer, cdt, rows)


def _paged_write(pool: PagedKV, ptab: Tensor, posw: Tensor, ok: Tensor,
                 cdt: torch.dtype, tp=None) -> Callable:
    """The ``write`` callback of :func:`_cached_stack` over a pool
    (:772, ``_pool_write_back``): slot s's fresh row w goes to page
    ``ptab[s, posw[s, w] // C]`` at offset ``posw % C``, or to the trash
    page where ``ok`` is False or the position is past the table (a
    freed page may already belong to another live slot, so a stale write
    is not harmless here); then the layer's view is gathered."""
    C = pool.k.shape[2]
    TBL = ptab.shape[1]
    pw = torch.clamp(posw, 0, TBL * C - 1)
    ok = ok & (posw >= 0) & (posw < TBL * C)
    pids = torch.where(ok, torch.gather(ptab.long(), 1, pw // C),
                       torch.zeros_like(pw))
    index = (pids, pw % C)

    def write(layer, k1, v1):
        _store_kv(pool, layer, index, k1, v1, cdt, tp=tp)
        return _paged_view(pool, ptab, layer, cdt)

    return write


def _row_inputs(cfg: TransformerConfig, params: Params, toks: Tensor,
                posw: Tensor, tp=None) -> Tensor:
    """Embeddings ``[S, W, H]`` of tokens ``toks`` at positions ``posw``
    (both ``[S, W]``), positions clamped to the table."""
    e = params["embed"]
    x = (tfm.token_embed(cfg, params, toks, tp)
         + e["pos"][torch.clamp(posw, 0, cfg.max_len - 1)])
    return tfm.layer_norm(x, e["ln_g"], e["ln_b"], cfg.layer_norm_eps)


def paged_prefill(cfg: TransformerConfig, params: Params, pool: PagedKV,
                  ptab_s: Tensor, toks: Tensor, start, n_valid,
                  temperature, seed, tp=None):
    """:func:`slot_prefill` over a pool (:814): one chunk ``toks``
    ``[C]`` (C is the page width; the engine aligns its prefill chunk to
    it) of the slot whose page table is ``ptab_s`` ``[TBL]``, at a
    chunk-aligned ``start``: the chunk's K/V rows are exactly page
    ``ptab_s[start // C]``.  Returns ``(pool, first_token)``; the pool
    is updated in place."""
    cdt = tfm.compute_dtype(cfg)
    dev = toks.device
    C = toks.shape[0]
    start = torch.as_tensor(start, device=dev).long()
    n_valid = torch.as_tensor(n_valid, device=dev).long()
    rows = start + torch.arange(C, device=dev)
    ptab = ptab_s.reshape(1, -1)
    x = tfm.embed(cfg, params, toks[None, :], None, start, tp)
    masked = torch.arange(ptab.shape[1] * C, device=dev)[None, :] \
        > rows[:, None]
    write = _paged_write(pool, ptab, rows[None, :],
                         torch.ones((1, C), dtype=torch.bool, device=dev),
                         cdt, tp)
    x = _cached_stack(cfg, params, x, write, masked, tp)
    logits = lm_logits(cfg, params, x, tp)[0]
    last = logits.index_select(0, (n_valid - 1).reshape(1))[0]
    first = sample_token(last, _slot_key(seed, start + n_valid - 1),
                         temperature)
    return pool, first


def _decode_rows(cfg: TransformerConfig, params: Params, tokens: Tensor,
                 pos: Tensor, write: Callable, t_view: int, active: Tensor,
                 temperature: Tensor, seeds: Tensor, tp=None):
    """The body of :func:`slot_decode` and :func:`paged_decode`: every
    slot's current token at its position through the stack (``write``
    stores the fresh rows and returns the layer's view of ``t_view``
    rows), one draw a slot, ``tokens``/``pos`` advanced in place for the
    active slots.  Returns ``(out [S], logits [S, vocab])``."""
    dev = tokens.device
    pos64 = pos.long()
    x = _row_inputs(cfg, params, tokens[:, None], pos64[:, None], tp)
    masked = (torch.arange(t_view, device=dev)[None, :]
              > pos64[:, None])[:, None, None, :]
    x = _cached_stack(cfg, params, x, write, masked, tp)
    logits = lm_logits(cfg, params, x, tp)[:, 0, :]
    nxt = sample_token(logits, _slot_key(seeds, pos64), temperature)
    out = torch.where(active, nxt, tokens)
    tokens.copy_(out)
    pos.add_(active.to(pos.dtype))
    return out, logits


def paged_decode(cfg: TransformerConfig, params: Params, pool: PagedKV,
                 ptab: Tensor, tokens: Tensor, pos: Tensor, active: Tensor,
                 temperature: Tensor, seeds: Tensor,
                 return_logits: bool = False, tp=None):
    """:func:`slot_decode` over a pool (:856): each active slot's row
    goes to its page, inactive slots write to the trash page, and every
    layer attends its gathered view.  ``tokens``/``pos`` ``[S]`` are the
    slots' current tokens and positions on the device (the reference
    tracks them on the host) and advance in place.  Returns ``(pool,
    tokens [S])`` (and the ``[S, vocab]`` logits)."""
    cdt = tfm.compute_dtype(cfg)
    write = _paged_write(pool, ptab, pos.long()[:, None], active[:, None],
                         cdt, tp)
    out, logits = _decode_rows(cfg, params, tokens, pos, write,
                               ptab.shape[1] * pool.k.shape[2], active,
                               temperature, seeds, tp)
    return (pool, out, logits) if return_logits else (pool, out)


def paged_read_pages(pool: PagedKV, pids: Tensor):
    """A copy of pages ``pids`` ``[n]`` of the pool (:866): ``(k, v)``
    ``[L, n, C, NH, D]`` (plus ``[L, n, C]`` scales for int8)."""
    idx = pids.to(pool.k.device).long()
    leaves = pool if pool.k_scale is not None else pool[:2]
    return tuple(t.index_select(1, idx) for t in leaves)


def paged_write_pages(pool: PagedKV, pids: Tensor, k: Tensor, v: Tensor,
                      k_scale: Optional[Tensor] = None,
                      v_scale: Optional[Tensor] = None) -> PagedKV:
    """Scatter prefix pages ``[L, n, C, ...]`` into pool pages ``pids``
    ``[n]``, in place (:876): the host-store hit of a paged engine."""
    idx = pids.to(pool.k.device).long()
    srcs = (k, v) if pool.k_scale is None else (k, v, k_scale, v_scale)
    for dst, src in zip(pool, srcs):
        dst.index_copy_(1, idx, src.to(dst.device, non_blocking=True))
    return pool


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

def _verify_rows(cfg: TransformerConfig, params: Params, tokens: Tensor,
                 pos: Tensor, drafts: Tensor, write: Callable, t_view: int,
                 active: Tensor, temperature: Tensor, seeds: Tensor,
                 tp=None):
    """The body of :func:`slot_verify` and :func:`paged_verify`.
    Returns ``(t [S, W], n_commit [S], logits [S, W, vocab])`` and
    advances ``tokens``/``pos`` in place."""
    dev = tokens.device
    S, k = drafts.shape
    W = k + 1
    posw = pos.long()[:, None] + torch.arange(W, device=dev)
    toks_w = torch.cat([tokens[:, None], drafts.to(tokens.dtype)], dim=1)
    x = _row_inputs(cfg, params, toks_w, posw, tp)
    masked = (torch.arange(t_view, device=dev)[None, None, :]
              > posw[:, :, None])[:, None]
    x = _cached_stack(cfg, params, x, write, masked, tp)
    logits = lm_logits(cfg, params, x, tp)                # [S, W, V]
    keys = _slot_key(seeds.long()[:, None], posw)
    t = sample_token(logits, keys, temperature[:, None].expand(S, W))
    matches = (t[:, :k] == drafts.to(t.dtype)).long()
    n_acc = torch.cumprod(matches, dim=1).sum(dim=1)
    n_commit = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
    last = torch.gather(t, 1, n_acc[:, None])[:, 0]
    tokens.copy_(torch.where(active, last, tokens))
    pos.add_(n_commit.to(pos.dtype))
    return t, n_commit, logits


def slot_verify(cfg: TransformerConfig, params: Params, slots: DecodeSlots,
                active: Tensor, temperature: Tensor, seeds: Tensor,
                drafts: Tensor, return_logits: bool = False, tp=None):
    """Target-model verify (:883): every slot's current token plus its
    k draft proposals ``drafts`` ``[S, k]``, W = k + 1 rows a slot, in
    one pass.  Row w consumes the token at ``pos + w`` and draws the
    target's own token t_w with the key of ``(seed, pos + w)``, the key
    plain decoding uses at that position, so the committed chain is the
    plain chain at any temperature.  With n_acc the count of leading
    drafts equal to t, tokens t_0..t_{n_acc} commit (``n_commit = n_acc
    + 1``, 0 for inactive slots).  Rows past the accepted ones hold
    rejected tokens' K/V, rewritten before they are attended.  Writes
    past ``T_max`` drop: the rows are stored one w at a time, so a
    dropped row never races a real one at the clamped index.  ``tp``:
    the model group of a head-sharded engine.  Returns ``(slots, t [S,
    W], n_commit [S])`` (and the ``[S, W, vocab]`` logits); the slots
    are updated in place."""
    cdt = tfm.compute_dtype(cfg)
    S = slots.tokens.shape[0]
    T_max = slots.k.shape[2]
    dev = slots.tokens.device
    W = drafts.shape[1] + 1
    posw = slots.pos.long()[:, None] + torch.arange(W, device=dev)
    rows = torch.arange(S, device=dev)

    def write(layer, k1, v1):
        for w in range(W):
            p = posw[:, w]
            _store_kv(slots, layer, (rows, torch.clamp(p, max=T_max - 1)),
                      k1[:, w], v1[:, w], cdt, p >= T_max, tp)
        return _read_kv(slots, layer, cdt)

    t, n_commit, logits = _verify_rows(cfg, params, slots.tokens, slots.pos,
                                       drafts, write, T_max, active,
                                       temperature, seeds, tp)
    return ((slots, t, n_commit, logits) if return_logits
            else (slots, t, n_commit))


def paged_verify(cfg: TransformerConfig, params: Params, pool: PagedKV,
                 ptab: Tensor, tokens: Tensor, pos: Tensor, active: Tensor,
                 temperature: Tensor, seeds: Tensor, drafts: Tensor,
                 tp=None):
    """:func:`slot_verify` over a pool (:971): the W rows of each active
    slot go to its pages (the engine allocates them through ``pos + k``
    first, so rejected rows stay in the slot's own pages).
    ``tokens``/``pos`` advance in place.  Returns ``(pool, t [S, W],
    n_commit [S])``."""
    cdt = tfm.compute_dtype(cfg)
    W = drafts.shape[1] + 1
    posw = pos.long()[:, None] + torch.arange(W, device=pos.device)
    write = _paged_write(pool, ptab, posw, active[:, None].expand(-1, W),
                         cdt, tp)
    t, n_commit, _ = _verify_rows(cfg, params, tokens, pos, drafts, write,
                                  ptab.shape[1] * pool.k.shape[2], active,
                                  temperature, seeds, tp)
    return pool, t, n_commit


def _greedy_args(tokens: Tensor):
    S = tokens.shape[0]
    return (torch.zeros(S, dtype=torch.float32, device=tokens.device),
            torch.zeros(S, dtype=torch.int64, device=tokens.device))


def draft_propose(cfg_d: TransformerConfig, params_d: Params,
                  dslots: DecodeSlots, active: Tensor, n_steps: int,
                  tp=None):
    """The draft's proposals (:1004): ``n_steps`` greedy
    :func:`slot_decode` steps from the draft's mirror of the committed
    stream, a Python loop over a static count (the reference scans).
    Its rows at accepted positions consumed exactly the committed
    tokens, so once ``tokens``/``pos`` are reset to the commit frontier
    every row below it is right.  ``tp``: the model group of a
    head-sharded draft.  Returns ``(dslots, proposals [S, n_steps])``;
    the proposals stay on the device."""
    temps, seeds = _greedy_args(dslots.tokens)
    props = []
    for _ in range(n_steps):
        dslots, t = slot_decode(cfg_d, params_d, dslots, active, temps,
                                seeds, tp=tp)
        props.append(t)
    return dslots, torch.stack(props, dim=1)


def paged_draft_propose(cfg_d: TransformerConfig, params_d: Params,
                        dpool: PagedKV, ptab: Tensor, tokens: Tensor,
                        pos: Tensor, active: Tensor, n_steps: int,
                        tp=None):
    """:func:`draft_propose` over the draft's pool, which shares the
    target's page tables (:1029): same positions, same page ids, one
    allocator for both.  ``tokens``/``pos`` are the draft's working
    copies of the frontier and advance in place.  Returns ``(dpool,
    proposals [S, n_steps])``."""
    temps, seeds = _greedy_args(tokens)
    props = []
    for _ in range(n_steps):
        dpool, t = paged_decode(cfg_d, params_d, dpool, ptab, tokens, pos,
                                active, temps, seeds, tp=tp)
        props.append(t)
    return dpool, torch.stack(props, dim=1)
