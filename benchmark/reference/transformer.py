"""Plain float32 reference of the transformers the benchmark runs.

Written from the model equations, in plain PyTorch: no kernel, cache or
batching of the program under test, and nothing imported from it.  It
reads the same weight tree the benchmark hands the program (the leaf
names and layouts below) and the same inputs.

The architecture is the one the program runs for both configurations:
a post-LN encoder block, ``x = LN(x + Attn(x)); x = LN(x + MLP(x))``,
after an embedding sum with its own LayerNorm.  Departures from the
published descriptions, noted once here:

- GPT-2 (Radford et al. 2019; ``openai-community/gpt2``) is pre-LN, with
  a final LayerNorm and no LayerNorm on the embeddings.  The program's
  GPT family is the encoder block above run causally, with a tied
  readout and no final LayerNorm, so this reference is too; the widths,
  the vocabulary, the learned positions, tanh GELU and the tied readout
  are GPT-2's.
- BERT (Devlin et al. 2019; ``google-bert/bert-base-uncased``) uses the
  exact erf GELU; the program uses the tanh approximation everywhere,
  so this reference does too.  BERT's next-sentence head is not
  trained: the loss is the masked-token loss alone.
- Dropout is 0 in every configuration the benchmark runs.

Products take a ``mm`` argument: :func:`mm_fp32` is the reference (TF32
off, see :func:`exact_fp32`); :func:`mm_fp8` is the control, the same
products computed in float8 e4m3 (each operand rounded under a
per-tensor scale, the sums in float32, as float8 tensor cores take them),
in the forward and in the backward alike: one precision below the
bfloat16 the configurations state.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch

Tensor = torch.Tensor
MM = Callable[[Tensor, Tensor], Tensor]

#: float8 e4m3's largest finite value
_FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """Full float32 products (TF32 off) inside the block, restored
    after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def mm_fp32(a: Tensor, b: Tensor) -> Tensor:
    return torch.matmul(a, b)


def fp8_round(x: Tensor) -> Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude onto e4m3's largest), back in float32.  The rounding is
    passed straight through in the backward."""
    with torch.no_grad():
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = _FP8_MAX / amax
        q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


class _Fp8Grad(torch.autograd.Function):
    """The identity forward; the gradient rounded to float8 e4m3 on its
    way back, so a backward product takes it in float8 too."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g).detach()


def mm_fp8(a: Tensor, b: Tensor) -> Tensor:
    return _Fp8Grad.apply(torch.matmul(fp8_round(a), fp8_round(b)))


def layer_norm(x: Tensor, g: Tensor, b: Tensor, eps: float) -> Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def gelu_tanh(x: Tensor) -> Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def attention(q: Tensor, k: Tensor, v: Tensor, key_mask: Optional[Tensor],
              causal: bool, mm: MM) -> Tensor:
    """``[B, T, NH, D]`` each -> ``[B, T, NH, D]``: softmax(q k^T /
    sqrt(D)) v, keys masked out where ``key_mask`` is 0 and, when causal,
    after the query."""
    D = q.shape[-1]
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    s = mm(qh, kh.transpose(-1, -2)) / math.sqrt(D)
    T = s.shape[-1]
    if key_mask is not None:
        s = s.masked_fill(key_mask[:, None, None, :] <= 0, float("-inf"))
    if causal:
        future = torch.ones(T, T, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(future, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return mm(p, vh).permute(0, 2, 1, 3)


def block(x: Tensor, p: Dict[str, Tensor], key_mask: Optional[Tensor],
          causal: bool, eps: float, mm: MM) -> Tensor:
    B, T, H = x.shape
    NH, D = p["wq"].shape[1], p["wq"].shape[2]

    def proj(w, b):
        return (mm(x, w.reshape(H, NH * D)).reshape(B, T, NH, D) + b)

    a = attention(proj(p["wq"], p["bq"]), proj(p["wk"], p["bk"]),
                  proj(p["wv"], p["bv"]), key_mask, causal, mm)
    a = mm(a.reshape(B, T, NH * D), p["wo"].reshape(NH * D, H)) + p["bo"]
    x = layer_norm(x + a, p["ln1_g"], p["ln1_b"], eps)
    f = gelu_tanh(mm(x, p["w1"]) + p["b1"])
    f = mm(f, p["w2"]) + p["b2"]
    return layer_norm(x + f, p["ln2_g"], p["ln2_b"], eps)


def encode(params: Dict, ids: Tensor, type_ids: Optional[Tensor],
           key_mask: Optional[Tensor], causal: bool, eps: float,
           mm: MM) -> Tensor:
    """Token ids ``[B, T]`` -> hidden ``[B, T, H]``."""
    e = params["embed"]
    T = ids.shape[1]
    x = e["tok"][ids.long()] + e["pos"][:T]
    if type_ids is not None:
        x = x + e["type"][type_ids.long()]
    x = layer_norm(x, e["ln_g"], e["ln_b"], eps)
    blocks = params["blocks"]
    for i in range(blocks["wq"].shape[0]):
        x = block(x, {n: w[i] for n, w in blocks.items()}, key_mask, causal,
                  eps, mm)
    return x


def gpt_logits(params: Dict, ids: Tensor, eps: float, mm: MM) -> Tensor:
    """Causal LM logits ``[B, T, V]``: the tied readout of every
    position."""
    h = encode(params, ids, None, None, True, eps, mm)
    return mm(h, params["embed"]["tok"].t())


def gpt_loss_sum(params: Dict, ids: Tensor, eps: float, mm: MM) -> Tensor:
    """Summed next-token negative log-likelihood of rows ``ids``:
    positions ``[:-1]`` predict ``ids[:, 1:]``."""
    logits = gpt_logits(params, ids[:, :-1], eps, mm)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, ids[:, 1:].long()[..., None]).sum()


def bert_loss_sum(params: Dict, batch: Dict[str, Tensor], eps: float,
                  mm: MM) -> Tensor:
    """Summed masked-token negative log-likelihood of the rows of
    ``batch`` (``token_ids``, ``attention_mask``, ``type_ids``,
    ``labels``, ``mlm_mask``): the transform (dense, GELU, LayerNorm)
    and the tied readout with its output bias."""
    h = encode(params, batch["token_ids"], batch["type_ids"],
               batch["attention_mask"], False, eps, mm)
    m = params["mlm"]
    t = layer_norm(gelu_tanh(mm(h, m["w"]) + m["b"]), m["ln_g"], m["ln_b"],
                   eps)
    logits = mm(t, params["embed"]["tok"].t()) + m["out_b"]
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    return -(ll * batch["mlm_mask"]).sum()
