"""Ring attention and Ulysses attention over a mesh's ``seq`` axis.

Port of ``deeplearning4j_tpu/parallel/ring_attention.py`` (:1-149).
Every rank holds its block ``[B, T/n, H, D]`` of q, k and v (rank ``r``
of the ``seq`` axis holds positions ``[r T/n, (r+1) T/n)``):

- :func:`ring_attention` (:49-103) keeps q where it is and rotates K/V
  and the key mask around the ring with ``collectives.ring_permute``
  (one send and one receive a rank a step, over ``axis``, e.g. ``(mesh,
  "seq")``), merging each block into the output by the online softmax.
  Causality goes by absolute block position: rank ``r`` attends to the
  blocks ``j <= r``, the diagonal one under the triangular mask.
- :func:`make_ring_attn_fn` (:106-110) is the adapter with
  ``transformer.attention``'s signature.
- :func:`ulysses_attention` (:113-149) trades the ring for two
  all-to-alls (``collectives.all_to_all``): heads scatter and
  the sequence gathers, each rank attends over the whole sequence for
  ``H / n`` heads, and the output goes back to sequence blocks; the key
  mask is all-gathered.

**The block step** has two forms behind :func:`ring_attention`'s
``block``:

- ``"plain"`` (the CPU, and any shape the kernel does not take): the
  reference's ``_block_attend`` (:30-46), fp32 logits with the mask at
  -1e9, its ``(numerator, row max, row sum)`` merged as at :79-103 and
  differentiated by autograd through the ring (the K/V shifts' backward
  shifts their gradients back).
- ``"flash"`` (``"auto"`` on CUDA where the kernel takes the shape):
  :class:`_FlashRing`, whose forward runs B1 (``csrc/flash_fwd.cu``) on
  each block and merges the ``(o, lse)`` pairs by lse.  A future block
  of a causal ring is skipped, the diagonal one runs causal and an
  earlier one full.  Its backward rings K/V again, each with its fp32
  dK/dV accumulator, and runs B2 and B3 (``flash_bwd_heads``) on every
  block given the merged O and the global lse, which is exactly what
  their p = exp(s - lse) rebuild needs; after n shifts each
  accumulator is home.  On the CPU the same form runs the kernels'
  plain twins (``block="flash"``).

The two forms differ on one kind of row only: a row whose every key is
masked.  B1 masks with ``MASK_VAL = -1e5`` (a fully masked row keeps a
finite lse the backward can rebuild p from, ROADMAP "Specs that still
bind the twins"), so such a row's output is the softmax of its raw
scores; the plain form's -1e9 swamps the scores in fp32 and the row is
the mean of the values.  Every row with at least one live key agrees.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel import collectives

Tensor = torch.Tensor

#: the plain block's additive mask value (the reference's -1e9)
PLAIN_MASK_VAL = -1e9

BLOCKS = ("auto", "flash", "plain")


def _block_attend(q: Tensor, k: Tensor, v: Tensor, mask_k: Optional[Tensor],
                  logit_bias: Optional[Tensor] = None):
    """One (local q, K block) tile with fp32 logits (:30-46): returns
    ``(numerator [B, Tq, H, D] fp32, row max [B, H, Tq], row sum)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask_k is not None:
        logits = logits + (1.0 - mask_k.float()[:, None, None, :]) \
            * PLAIN_MASK_VAL
    if logit_bias is not None:
        logits = logits + logit_bias
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    num = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return num, m, p.sum(dim=-1)


def _causal_bias(my: int, j: int, tq: int, tk: int, device) -> Tensor:
    """``[1, 1, Tq, Tk]``: 0 where key ``j tk + c`` is at or before query
    ``my tq + r``, -1e9 where it lies in the future."""
    iq = my * tq + torch.arange(tq, device=device)[:, None]
    ik = j * tk + torch.arange(tk, device=device)[None, :]
    zero = torch.zeros((), device=device)
    return torch.where(ik <= iq, zero, zero + PLAIN_MASK_VAL)[None, None]


def _ring_plain(q, k, v, mask, causal, group, n, my):
    """The reference's ring (:49-103), differentiated by autograd."""
    B, Tq, H, D = q.shape
    kv = torch.stack((k, v))
    mm = mask
    acc_num = acc_max = acc_den = None
    for i in range(n):
        j = (my - i) % n
        bias = _causal_bias(my, j, Tq, kv.shape[2], q.device) \
            if causal else None
        num, m, l_ = _block_attend(q, kv[0], kv[1], mm, bias)
        if acc_num is None:
            acc_num, acc_max, acc_den = num, m, l_
        else:
            new_max = torch.maximum(acc_max, m)
            c_old = torch.exp(acc_max - new_max)
            c_new = torch.exp(m - new_max)
            acc_num = (acc_num * c_old.transpose(1, 2)[..., None]
                       + num * c_new.transpose(1, 2)[..., None])
            acc_den = acc_den * c_old + l_ * c_new
            acc_max = new_max
        if i < n - 1:
            # K and V travel as one tensor: one shift (and in the
            # backward one shift back) a step, in the same order on
            # every rank
            kv = collectives._permute(kv, group, 1)
            if mm is not None:
                mm = collectives._shift(mm, group, 1)
    den = torch.clamp(acc_den, min=1e-30).transpose(1, 2)[..., None]
    return (acc_num / den).to(q.dtype)


def _flash_bias(mm: Optional[Tensor]) -> Optional[Tensor]:
    from deeplearning4j_tpu_torch.ops.flash_attention import MASK_VAL
    if mm is None:
        return None
    return ((1.0 - mm.float()) * MASK_VAL).contiguous()


def _visible(causal: bool, my: int, j: int) -> bool:
    """Whether rank ``my``'s queries see key block ``j`` at all."""
    return not causal or j <= my


class _FlashRing(torch.autograd.Function):
    """The ring with B1 as its forward block step and B2/B3 as its
    backward one (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, group, n, my):
        from deeplearning4j_tpu_torch.ops.flash_attention import \
            flash_fwd_heads

        B, Tq, H, _ = q.shape
        kv = torch.stack((k, v))
        mm = mask
        o_acc = lse_acc = None
        for i in range(n):
            j = (my - i) % n
            if _visible(causal, my, j):
                o_b, lse_b = flash_fwd_heads(q, kv[0], kv[1],
                                             _flash_bias(mm),
                                             causal and j == my)
                if o_acc is None:
                    o_acc, lse_acc = o_b.float(), lse_b
                else:
                    lse_new = torch.logaddexp(lse_acc, lse_b)

                    def w(lse):
                        # [B*H, Tq] -> [B, Tq, H, 1]
                        return torch.exp(lse - lse_new).reshape(
                            B, H, Tq).transpose(1, 2)[..., None]

                    o_acc = o_acc * w(lse_acc) + o_b.float() * w(lse_b)
                    lse_acc = lse_new
            if i < n - 1:
                kv = collectives._shift(kv, group, 1)
                if mm is not None:
                    mm = collectives._shift(mm, group, 1)
        o = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, mask, o, lse_acc.contiguous())
        ctx.args = (causal, group, n, my)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        from deeplearning4j_tpu_torch.ops.flash_attention import \
            flash_bwd_heads

        q, k, v, mask, o, lse = ctx.saved_tensors
        causal, group, n, my = ctx.args
        do = do.contiguous()
        kv = torch.stack((k, v))
        mm = mask
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for i in range(n):
            j = (my - i) % n
            if _visible(causal, my, j):
                dq_b, dk_b, dv_b = flash_bwd_heads(
                    q, kv[0], kv[1], _flash_bias(mm), o, lse, do,
                    causal and j == my)
                dq += dq_b.float()
                dkv[0] += dk_b.float()
                dkv[1] += dv_b.float()
            if i < n - 1:
                kv = collectives._shift(kv, group, 1)
                if mm is not None:
                    mm = collectives._shift(mm, group, 1)
            # the accumulator travels with its block: n shifts bring it
            # back to the block's owner
            dkv = collectives._shift(dkv, group, 1)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None, None)


def _flash_takes(q: Tensor, k: Tensor) -> bool:
    from deeplearning4j_tpu_torch.ops.flash_attention import kernel_supports
    return kernel_supports(q.shape[1], k.shape[1], q.shape[-1], q.dtype)


def ring_attention(q: Tensor, k: Tensor, v: Tensor,
                   mask: Optional[Tensor] = None, causal: bool = False,
                   axis=None, *, block: str = "auto") -> Tensor:
    """Sequence-parallel attention: every rank of ``axis`` (e.g. ``(mesh,
    "seq")``) holds ``[B, T/n, H, D]`` blocks of q, k, v and its
    ``[B, T/n]`` key mask (1 = attend, or None), and gets its block of
    the output.  ``block`` picks the block step (module docstring):
    ``"auto"`` takes B1-B3 on CUDA tensors the kernel takes and the
    plain block otherwise; ``"flash"`` forces the kernels (their plain
    twins on the CPU), ``"plain"`` the plain block.  Differentiable in
    q, k and v; every rank of the axis must call it."""
    if block not in BLOCKS:
        raise ValueError(f"block must be one of {BLOCKS}, got {block!r}")
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"ring attention takes q, k, v of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    group = collectives._group(axis)
    n, my = collectives._size(group), collectives._rank(group)
    flash = block == "flash" or (
        block == "auto" and q.device.type == "cuda" and _flash_takes(q, k))
    if not flash:
        return _ring_plain(q, k, v, mask, causal, group, n, my)
    if mask is not None:
        mask = mask.float().contiguous()
    return _FlashRing.apply(q, k, v, mask, causal, group, n, my)


def make_ring_attn_fn(axis):
    """``attn(q, k, v, mask, causal=False)``: :func:`ring_attention`
    over ``axis`` with ``transformer.attention``'s signature (:106-110).
    The reference names the axis alone; the port takes ``(mesh,
    "seq")``."""
    def attn(q, k, v, mask, causal=False):
        return ring_attention(q, k, v, mask, causal, axis)
    return attn


def _full_causal_bias(t: int, device) -> Tensor:
    return _causal_bias(0, 0, t, t, device)


def ulysses_attention(q: Tensor, k: Tensor, v: Tensor,
                      mask: Optional[Tensor] = None, causal: bool = False,
                      axis=None, *, block: str = "auto") -> Tensor:
    """DeepSpeed-Ulysses attention (:113-149): an all-to-all gives each
    rank the whole sequence for ``H / n`` heads, it attends locally (the
    flash kernels on CUDA where they take the shape, as ``block``
    picks; the plain attention of :func:`_block_attend` otherwise), and
    a second all-to-all brings the output back to sequence blocks.  The
    key mask is all-gathered.  Needs ``n_heads % n == 0``;
    differentiable (each all-to-all's backward is the inverse
    exchange)."""
    if block not in BLOCKS:
        raise ValueError(f"block must be one of {BLOCKS}, got {block!r}")
    n = collectives.axis_size(axis)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"n_heads={H} not divisible by seq degree {n}: "
                         f"Ulysses scatters heads over the axis")

    def scatter_heads(x):
        # [B, T/n, H, D] -> [B, T, H/n, D]
        return collectives.all_to_all(x, axis, split_axis=2, concat_axis=1)

    qg, kg, vg = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    full_mask = (collectives.all_gather(mask.float(), axis, gather_axis=1)
                 if mask is not None else None)
    flash = block == "flash" or (
        block == "auto" and q.device.type == "cuda" and _flash_takes(qg, kg))
    if flash:
        from deeplearning4j_tpu_torch.ops.flash_attention import \
            flash_attention
        out = flash_attention(qg, kg, vg, full_mask, causal)
    else:
        num, _, l_ = _block_attend(
            qg, kg, vg, full_mask,
            _full_causal_bias(qg.shape[1], q.device) if causal else None)
        out = (num / torch.clamp(l_, min=1e-30).transpose(1, 2)[..., None]
               ).to(q.dtype)
    # [B, T, H/n, D] -> [B, T/n, H, D]
    return collectives.all_to_all(out, axis, split_axis=1, concat_axis=2)


__all__ = ["ring_attention", "make_ring_attn_fn", "ulysses_attention"]
