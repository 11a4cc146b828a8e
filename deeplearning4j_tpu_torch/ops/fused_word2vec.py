"""Word2vec skip-gram chunk update: kernel B4 and its plain twin.

Port of ``deeplearning4j_tpu/ops/pallas_word2vec.py``.  Kernel B4,
``csrc/word2vec_chunk.cu``, replaces the Pallas kernel ``_kernel`` (:91)
that ``fused_chunk_update`` (:207) launches and the apply after it
(:272-278): one chunk of hierarchical softmax over the Huffman paths plus
K negatives, with both objectives reading the chunk-start tables, then
``syn += sum / max(count, 1)`` on every row the chunk touched.  It buckets
the chunk's hits by destination row and sums each row in one warp
(``csrc/row_segments.cuh``), so a row is written once and no dense
``[V, D+1]`` accumulator exists.

- :func:`fused_chunk_update` keeps the JAX signature (less ``block`` and
  ``interpret``, which sized and interpreted the TPU grid) and JAX's
  functional contract: it returns updated copies of ``(syn0, syn1,
  syn1neg)`` and leaves its inputs alone.  CPU tensors run the plain twin;
  CUDA tensors launch B4 on copies, or raise.
- :func:`fused_chunk_update_cuda` launches B4 on CUDA tensors of any width
  (rows wider than 512 floats take the kernel's wide path) and updates the
  tables IN PLACE; it returns the same three tensors.  The training
  engines call it, or the plain twin, directly and carry the returned
  tensors as their state; every fit starts from tables of its own, so a
  ``WordVectors`` of an earlier fit does not change.
- :func:`fused_chunk_update_plain` is the same function in plain
  PyTorch on any device, returning new tensors: the algebra of
  ``nlp/word2vec._hs_update`` and ``_neg_update`` (:98, :129),
  :func:`hs_update` and :func:`neg_update` here, with syn0's two deltas
  summed as the plain path sums them (``word2vec.py:248-261``).
- ``launches`` counts B4 launches, one per update call (the call's phases
  are several kernels behind one C entry point; never plain-twin calls).

The TPU kernel cast the tables to bf16 and moved rows through one-hot
matrix products over VMEM-resident tables; B4 gathers fp32 rows from HBM,
so it is closer to the JAX plain path than the TPU kernel was.  A row's
hits are summed in no fixed order.  The plain twin, like JAX's
``.at[].add``, adds each of a row's terms into the table itself, so at a
row hit thousands of times (the Huffman root) its rounding grows with the
table's magnitude; B4 adds a row's mean once, and is the more accurate of
the two there.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.ops import cuda_build

Tensor = torch.Tensor

#: B4 launches since the process started (or the caller reset them)
launches = 0
_launch_lock = threading.Lock()

_lib = None

#: hits a segment of B4's row reductions holds at most: a row with more is
#: split across warps whose partials meet in scratch
SEGMENT = 32


def reset_launches() -> None:
    global launches
    with _launch_lock:
        launches = 0


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def _row_mean_add(table: Tensor, rows: Tensor, upd: Tensor,
                  hit: Tensor) -> Tensor:
    """``table.at[rows].add(upd / max(count, 1)[rows])`` with count the
    hits per row: the per-row mean normalisation of ``_hs_update``."""
    cnt = torch.zeros(table.shape[0], dtype=table.dtype, device=table.device)
    cnt.index_add_(0, rows, hit)
    return table.index_add(0, rows, upd / cnt.clamp_min(1.0)[rows][:, None])


def hs_update(syn0: Tensor, syn1: Tensor, inputs: Tensor, codes: Tensor,
              points: Tensor, mask: Tensor, alpha) -> Tuple[Tensor, Tensor]:
    """One batched hierarchical-softmax update (``_hs_update``, :98):
    inputs ``[B]`` rows of syn0, codes/points/mask ``[B, L]`` the
    centers' Huffman paths (padded pairs carry mask 0).  Returns the new
    ``(syn0, syn1)``."""
    inputs, points = inputs.long(), points.long()
    l1 = syn0[inputs]                                     # [B, D]
    s1 = syn1[points]                                     # [B, L, D]
    f = torch.sigmoid(torch.einsum("bd,bld->bl", l1, s1))
    g = (1.0 - codes.float() - f) * alpha * mask
    neu1e = torch.einsum("bl,bld->bd", g, s1)
    B, L, D = s1.shape
    dsyn1 = (g[:, :, None] * l1[:, None, :]).reshape(B * L, D)
    syn1 = _row_mean_add(syn1, points.reshape(B * L), dsyn1,
                         mask.reshape(B * L))
    row_mask = (mask.sum(1) > 0).to(syn0.dtype)
    return _row_mean_add(syn0, inputs, neu1e, row_mask), syn1


def neg_update(syn0: Tensor, syn1neg: Tensor, inputs: Tensor,
               targets: Tensor, negatives: Tensor, pair_mask: Tensor,
               alpha) -> Tuple[Tensor, Tensor]:
    """Negative sampling (``_neg_update``, :129): the target with label
    1, K negatives with label 0, a negative equal to its target masked.
    Returns the new ``(syn0, syn1neg)``."""
    inputs, targets, negatives = inputs.long(), targets.long(), \
        negatives.long()
    l1 = syn0[inputs]
    rows = torch.cat([targets[:, None], negatives], dim=1)      # [B, K+1]
    labels = torch.zeros(rows.shape, dtype=l1.dtype, device=l1.device)
    labels[:, 0] = 1.0
    sn = syn1neg[rows]                                          # [B, K+1, D]
    f = torch.sigmoid(torch.einsum("bd,bkd->bk", l1, sn))
    valid = torch.cat([torch.ones_like(labels[:, :1]),
                       (negatives != targets[:, None]).to(l1.dtype)], dim=1)
    g = (labels - f) * alpha * valid * pair_mask[:, None]
    neu1e = torch.einsum("bk,bkd->bd", g, sn)
    B, K1, D = sn.shape
    dneg = (g[:, :, None] * l1[:, None, :]).reshape(B * K1, D)
    hit = (valid * pair_mask[:, None]).reshape(B * K1)
    syn1neg = _row_mean_add(syn1neg, rows.reshape(B * K1), dneg, hit)
    return _row_mean_add(syn0, inputs, neu1e, pair_mask), syn1neg


def fused_chunk_update_plain(syn0: Tensor, syn1: Tensor, syn1neg: Tensor,
                             inputs: Tensor, targets: Tensor, codes: Tensor,
                             points: Tensor, mask: Tensor, negs: Tensor,
                             pmask: Tensor, alpha, *, use_hs: bool,
                             negative: int
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """B4's function in plain PyTorch, on any device: both objectives
    read the chunk-start tables and syn0's two deltas are summed."""
    pmask = pmask.to(syn0.dtype)
    syn0_in = syn0
    if use_hs:
        hs0, syn1 = hs_update(syn0_in, syn1, inputs, codes, points,
                              mask.to(syn0.dtype) * pmask[:, None], alpha)
        syn0 = syn0 + (hs0 - syn0_in)
    if negative > 0:
        ng0, syn1neg = neg_update(syn0_in, syn1neg, inputs, targets, negs,
                                  pmask, alpha)
        syn0 = syn0 + (ng0 - syn0_in)
    return syn0, syn1, syn1neg


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _library():
    global _lib
    if _lib is None:
        # 10 pointers + scratch; B, L, K, D, V0, V1, Vn, use_hs, seg;
        # alpha; stream
        _lib = cuda_build.bind("w2v_chunk", {
            "w2v_chunk": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p]})
    return _lib


def _as(x: Tensor, dtype: torch.dtype, what: str, device) -> Tensor:
    if x.device != device:
        raise ValueError(f"B4 needs every tensor on {device}; {what} is on "
                         f"{x.device}")
    return x.to(dtype).contiguous()


def fused_chunk_update_cuda(syn0: Tensor, syn1: Tensor, syn1neg: Tensor,
                            inputs: Tensor, targets: Tensor, codes: Tensor,
                            points: Tensor, mask: Tensor, negs: Tensor,
                            pmask: Tensor, alpha, *, use_hs: bool,
                            negative: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch B4 on CUDA tensors of any width: ``syn += sum / max(count,
    1)`` per objective on every row the chunk touches (:272-278), IN
    PLACE; returns ``(syn0, syn1, syn1neg)``, the tensors it was given.
    The tables must be contiguous fp32.  Raises for anything the kernel
    does not take, CPU tensors included.  ``alpha`` is a Python or numpy
    float."""
    dev = syn0.device
    if dev.type != "cuda":
        raise ValueError(f"B4 needs CUDA tensors; syn0 is on {dev} (CPU "
                         f"tensors take fused_chunk_update, which runs the "
                         f"plain twin there)")
    V0, D = syn0.shape
    B = inputs.shape[0]
    K = int(negative)
    tabs = {"syn0": syn0, "syn1": syn1 if use_hs else None,
            "syn1neg": syn1neg if K > 0 else None}
    for name, t in tabs.items():
        if t is None:                  # never read: a dummy is fine
            continue
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != D
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous fp32 [V, {D}] on "
                             f"{dev}; got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    inputs = _as(inputs, torch.int32, "inputs", dev)
    targets = _as(targets, torch.int32, "targets", dev)
    pmask = _as(pmask, torch.float32, "pmask", dev)
    if use_hs:
        L = codes.shape[1]
        if codes.shape != (B, L) or points.shape != (B, L) \
                or mask.shape != (B, L):
            raise ValueError(f"codes/points/mask must be [B={B}, L]; got "
                             f"{tuple(codes.shape)}, {tuple(points.shape)}, "
                             f"{tuple(mask.shape)}")
        codes = _as(codes, torch.float32, "codes", dev)
        points = _as(points, torch.int32, "points", dev)
        mask = _as(mask, torch.float32, "mask", dev)
    else:
        L = 0
    if K > 0:
        if negs.shape != (B, K):
            raise ValueError(f"negs must be [B={B}, K={K}]; got "
                             f"{tuple(negs.shape)}")
        negs = _as(negs, torch.int32, "negs", dev)
    V1, Vn = syn1.shape[0], syn1neg.shape[0]

    def ptr(t, live):
        return t.data_ptr() if live else None

    lib = _library()
    with torch.cuda.device(dev):
        scratch = cuda_build.scratch(lib, "w2v_chunk_scratch_bytes", dev, B,
                                     L, K, D, V0, V1, Vn, SEGMENT)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.w2v_chunk(
            syn0.data_ptr(), ptr(syn1, use_hs), ptr(syn1neg, K > 0),
            inputs.data_ptr(), targets.data_ptr(), pmask.data_ptr(),
            ptr(codes, use_hs), ptr(points, use_hs), ptr(mask, use_hs),
            ptr(negs, K > 0), scratch.data_ptr(), B, L, K, D, V0, V1, Vn,
            int(use_hs), SEGMENT, float(alpha), stream)
    cuda_build.raise_on_error(lib, "w2v_chunk", "w2v_chunk", err)
    global launches
    with _launch_lock:
        launches += 1
    return syn0, syn1, syn1neg


def fused_chunk_update(syn0: Tensor, syn1: Tensor, syn1neg: Tensor,
                       inputs: Tensor, targets: Tensor, codes: Tensor,
                       points: Tensor, mask: Tensor, negs: Tensor,
                       pmask: Tensor, alpha, *, use_hs: bool,
                       negative: int) -> Tuple[Tensor, Tensor, Tensor]:
    """One training chunk (``fused_chunk_update``, :207): inputs/targets
    ``[B]``; codes/points/mask ``[B, L]`` (``[B, 1]`` dummies when
    ``use_hs`` is off); negs ``[B, K]`` already mapped through the
    unigram table; pmask ``[B]`` the combined pad and window mask; alpha
    a float.  Returns updated copies of ``(syn0, syn1, syn1neg)``; the
    inputs are not changed.  CPU tensors run the plain twin; CUDA tensors
    launch B4 on copies of the tables, or raise."""
    if syn0.device.type == "cpu":
        return fused_chunk_update_plain(
            syn0, syn1, syn1neg, inputs, targets, codes, points, mask, negs,
            pmask, alpha, use_hs=use_hs, negative=negative)
    fresh = torch.contiguous_format
    return fused_chunk_update_cuda(
        syn0.clone(memory_format=fresh), syn1.clone(memory_format=fresh),
        syn1neg.clone(memory_format=fresh), inputs, targets, codes,
        points, mask, negs, pmask, alpha, use_hs=use_hs, negative=negative)
