"""Operation and byte counts of the work a cell asks for, and the card's
peaks: the yardstick the per-layer shares are taken against.

Counts follow from the shapes alone, never from how the program does the
work, so a later change to the program cannot move them:

- :func:`train_step_flops`: a transformer training step's matrix-product
  FLOPs (6 N-style: forward x 3), as the repo's chip rehearsal counted
  them (QKV and out, the MLP, scores and values, the vocabulary readout
  over every position), with the causal score term halved, since a
  causal model needs only the lower triangle.  BERT's MLM transform
  (768 x 768 a position) is left out, as there.  Recomputation under
  remat is not counted: it is waste, and the share should show it.
- :func:`attention_bound_s`: the least time of the attention function a
  layer's training step needs (forward and backward together): the
  larger of its FLOPs over the bf16 peak and its bytes (q, k, v, o, dO,
  dq, dk, dv, the log-sum-exp and the key mask, each once) over the
  memory rate.  It counts the function's work, not a kernel's, so a
  kernel that recomputes does not raise its own bound.
"""

from __future__ import annotations

#: published dense peaks of one H100 SXM at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def train_step_flops(layers: int, hidden: int, ffn: int, vocab: int,
                     batch: int, seq: int, causal: bool) -> float:
    """Matrix-product FLOPs of one training step, forward x 3.

    Per layer: 8 B T h^2 (q, k, v, out), 4 B T h f (the MLP), 4 B T^2 h
    (scores and values; half of it when causal); plus the readout,
    2 B T h V."""
    tokens = batch * seq
    scores = 4.0 * batch * seq * seq * hidden * (0.5 if causal else 1.0)
    per_layer = 8.0 * tokens * hidden * hidden + 4.0 * tokens * hidden * ffn
    forward = layers * (per_layer + scores) + 2.0 * tokens * hidden * vocab
    return 3.0 * forward


def attention_flops(batch: int, heads: int, seq: int, head_dim: int,
                    causal: bool) -> float:
    """FLOPs of one layer's attention forward (4 B H T^2 D) and backward
    (8 B H T^2 D), halved when causal."""
    return 12.0 * batch * heads * seq * seq * head_dim * (
        0.5 if causal else 1.0)


def attention_bytes(batch: int, heads: int, seq: int, head_dim: int,
                    itemsize: int, key_mask: bool) -> float:
    """Bytes one layer's attention forward and backward must move: q, k,
    v, o, dO, dq, dk, dv at ``itemsize``, the fp32 log-sum-exp, and the
    fp32 key mask where the batch has one, each once."""
    act = 8.0 * batch * seq * heads * head_dim * itemsize
    lse = 4.0 * batch * heads * seq
    mask = 4.0 * batch * seq if key_mask else 0.0
    return act + lse + mask


def attention_bound_s(batch: int, heads: int, seq: int, head_dim: int,
                      causal: bool, key_mask: bool, itemsize: int = 2):
    """``(seconds, "operations" | "bytes")``: the least time of one
    layer's attention forward and backward on the card."""
    t_ops = attention_flops(batch, heads, seq, head_dim,
                            causal) / PEAK_BF16_FLOPS
    t_bytes = attention_bytes(batch, heads, seq, head_dim, itemsize,
                              key_mask) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
