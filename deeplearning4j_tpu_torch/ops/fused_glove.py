"""GloVe chunk accumulation: kernel B5 and its plain twin.

Port of ``deeplearning4j_tpu/ops/pallas_glove.py``.  Kernel B5,
``csrc/glove_chunk.cu``, replaces the Pallas kernel ``_kernel`` (:64)
that ``fused_glove_chunk`` (:118) launches.  The biases fold into
extended tables so that a pair's score is one row dot::

    wext[i]  = (w[i]  | b[i] | 1)          [V, D+2]
    wtext[j] = (wt[j] | 1 | bt[j])         [V, D+2]

and per side the kernel sums ``(g*p | (g*p)^2 | hits)`` over the D+1
update columns into ``[V, 2D+3]`` accumulators, plus the loss sums
``[1, 2]``.  :func:`apply_chunk` (:164-175) takes the AdaGrad step from
them in plain PyTorch, as JAX does outside the kernel.

- :func:`fused_glove_chunk` keeps the JAX signature (less ``block`` and
  ``interpret``).  CPU tensors run :func:`fused_glove_chunk_plain`; CUDA
  tensors launch B5 or raise.  The epoch loop calls
  :func:`fused_glove_chunk_cuda` or the plain twin directly.
- ``launches`` counts B5 launches (never plain-twin calls).

B5 accumulates the squared-gradient columns in fp32 where the TPU
kernel's bf16 one-hot products rounded them, so the port sits closer to
the JAX plain path (``nlp/glove._glove_update``) than the TPU kernel
did.  Its atomics sum in no fixed order.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.ops import cuda_build

Tensor = torch.Tensor

#: B5 launches since the process started (or the caller reset them)
launches = 0
_launch_lock = threading.Lock()

_lib = None


def reset_launches() -> None:
    global launches
    with _launch_lock:
        launches = 0


def fused_glove_chunk_plain(wext: Tensor, wtext: Tensor, rows: Tensor,
                            cols: Tensor, x: Tensor, mask: Tensor, *,
                            x_max: float, power: float
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """B5's function in plain PyTorch, on any device: returns ``(accw,
    accwt, loss_sums)`` as the kernel does (:64-113)."""
    V, E = wext.shape
    D = E - 2
    rows, cols = rows.long(), cols.long()
    x, mask = x.float(), mask.float()
    wi, wj = wext[rows], wtext[cols]                         # [B, E]
    diff = (wi * wj).sum(1) - torch.log(x.clamp_min(1e-12))
    fx = ((x / x_max) ** power).clamp_max(1.0)
    g = fx * diff * mask
    loss = torch.stack([0.5 * (fx * diff * diff * mask).sum(), mask.sum()])

    def accumulate(idx, partner):
        grad = g[:, None] * partner                          # [B, D+1]
        payload = torch.cat([grad, grad * grad, mask[:, None]], dim=1)
        acc = torch.zeros((V, 2 * D + 3), dtype=payload.dtype,
                          device=payload.device)
        return acc.index_add_(0, idx, payload)

    accw = accumulate(rows, wj[:, :D + 1])                   # (wt_j | 1)
    accwt = accumulate(cols, torch.cat([wi[:, :D], wi[:, D + 1:]], dim=1))
    return accw, accwt, loss[None, :]


def _library():
    global _lib
    if _lib is None:
        # 9 pointers; B, D, V; x_max, power; stream
        _lib = cuda_build.bind("glove_chunk", {
            "glove_chunk": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]})
    return _lib


def fused_glove_chunk_cuda(wext: Tensor, wtext: Tensor, rows: Tensor,
                           cols: Tensor, x: Tensor, mask: Tensor, *,
                           x_max: float, power: float
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch B5 on CUDA tensors of any width (extended rows wider than
    512 take the kernel's wide path); raises for anything it does not
    take, CPU tensors included."""
    dev = wext.device
    if dev.type != "cuda":
        raise ValueError(f"B5 needs CUDA tensors; wext is on {dev} (CPU "
                         f"tensors take fused_glove_chunk, which runs the "
                         f"plain twin there)")
    V, E = wext.shape
    D = E - 2
    if D <= 0:
        raise ValueError(f"B5 needs D >= 1, got extended width {E}")
    for name, t in (("wext", wext), ("wtext", wtext)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (V, E)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous fp32 [{V}, {E}] "
                             f"on {dev}; got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    B = rows.shape[0]
    args = []
    for name, t, dtype in (("rows", rows, torch.int32),
                           ("cols", cols, torch.int32),
                           ("x", x, torch.float32),
                           ("mask", mask, torch.float32)):
        if t.device != dev or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be [{B}] on {dev}; got "
                             f"{tuple(t.shape)} on {t.device}")
        args.append(t.to(dtype).contiguous())
    accw = torch.zeros((V, 2 * D + 3), dtype=torch.float32, device=dev)
    accwt = torch.zeros_like(accw)
    loss = torch.zeros((1, 2), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.glove_chunk(
            *(t.data_ptr() for t in args), wext.data_ptr(),
            wtext.data_ptr(), accw.data_ptr(), accwt.data_ptr(),
            loss.data_ptr(), B, D, V, float(x_max), float(power), stream)
    cuda_build.raise_on_error(lib, "glove_chunk", "glove_chunk", err)
    global launches
    with _launch_lock:
        launches += 1
    return accw, accwt, loss


def fused_glove_chunk(wext: Tensor, wtext: Tensor, rows: Tensor,
                      cols: Tensor, x: Tensor, mask: Tensor, *,
                      x_max: float, power: float
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """One chunk's accumulators (``fused_glove_chunk``, :118): ``(accw,
    accwt, loss_sums)``, acc* ``[V, 2D+3]`` = (grad sums [D+1] |
    grad-square sums [D+1] | hit count), loss_sums ``[1, 2]`` =
    (weighted squared-error sum, mask sum).  CPU tensors run the plain
    twin; CUDA tensors launch B5 or raise."""
    fn = (fused_glove_chunk_plain if wext.device.type == "cpu"
          else fused_glove_chunk_cuda)
    return fn(wext, wtext, rows, cols, x, mask, x_max=x_max, power=power)


def apply_chunk(table_b: Tensor, gsq_b: Tensor, acc: Tensor,
                alpha) -> Tuple[Tensor, Tensor]:
    """One side's AdaGrad step (:164-175) on (weights|bias) ``[V, D+1]``
    and its state ``[V, D+1]``: per-occurrence grads are ``g*p/k`` for k
    row hits, so ``gsq += sum_sq / k^2`` and ``step = alpha * (sum/k) /
    sqrt(gsq + 1e-8)`` — the algebra of ``_glove_update``'s scatter."""
    d1 = table_b.shape[1]
    cnt = acc[:, 2 * d1:2 * d1 + 1].clamp_min(1.0)
    grad = acc[:, :d1] / cnt
    gsq_b = gsq_b + acc[:, d1:2 * d1] / (cnt * cnt)
    return table_b - alpha * grad / torch.sqrt(gsq_b + 1e-8), gsq_b
