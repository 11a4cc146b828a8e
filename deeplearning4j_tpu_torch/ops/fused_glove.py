"""GloVe chunk update: kernel B5 and its plain twins.

Port of ``deeplearning4j_tpu/ops/pallas_glove.py``.  Kernel B5,
``csrc/glove_chunk.cu``, replaces the Pallas kernel ``_kernel`` (:64)
that ``fused_glove_chunk`` (:118) launches, and the AdaGrad step
``apply_chunk`` (:164-175) that follows it.  The biases fold into
extended tables so that a pair's score is one row dot::

    wext[i]  = (w[i]  | b[i] | 1)          [V, D+2]
    wtext[j] = (wt[j] | 1 | bt[j])         [V, D+2]

and per side each touched row sums ``(g*p | (g*p)^2 | hits)`` over its
D+1 update columns, plus the loss sums ``[1, 2]``.  B5 buckets the
chunk's hits by destination row and sums each row in one warp
(``csrc/row_segments.cuh``); no dense ``[V, 2D+3]`` accumulator exists
on the training path.

- :func:`glove_chunk_step_cuda` is the epoch loop's chunk: B5 on CUDA
  tensors, then the AdaGrad step on every touched row IN PLACE (the
  weight, bias and AdaGrad tables it is given); returns those tensors
  and the loss sums.  :func:`glove_chunk_step_plain` is the same function
  in plain PyTorch, returning new tensors: :func:`fused_glove_chunk_plain`
  followed by :func:`apply_chunk` for each side.
- :func:`fused_glove_chunk` keeps the JAX signature (less ``block`` and
  ``interpret``) and returns ``(accw, accwt, loss_sums)``.  CPU tensors
  run :func:`fused_glove_chunk_plain`; CUDA tensors launch B5 in its
  accumulator mode (:func:`fused_glove_chunk_cuda`), which writes the
  touched rows of zeroed accumulators, or raise.
- ``launches`` counts B5 launches, one per chunk on either entry (never
  plain-twin calls).

B5 sums the squared-gradient columns in fp32 where the TPU kernel's
bf16 one-hot products rounded them, so the port sits closer to the JAX
plain path (``nlp/glove._glove_update``) than the TPU kernel did.  A
row's hits are summed in no fixed order.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.runtime import compile_cache

Tensor = torch.Tensor

#: B5 launches since the process started (or the caller reset them)
launches = 0
_launch_lock = threading.Lock()

_lib = None

#: hits a segment of B5's row reductions holds at most
SEGMENT = 16


def reset_launches() -> None:
    global launches
    with _launch_lock:
        launches = 0


def _add_launches(counts) -> None:
    """Book a CUDA-graph replay's launches."""
    global launches
    with _launch_lock:
        launches += counts["launches"]


compile_cache.register_launch_counters(lambda: {"launches": launches},
                                       _add_launches)


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
        # 11 pointers + scratch; B, D, V, seg; x_max, power, alpha; step;
        # stream
        _lib = cuda_build.bind("glove_chunk", {
            "glove_chunk": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]})
    return _lib


def _check_tables(**tables) -> None:
    """Each named table must be a contiguous fp32 tensor of its shape on
    the device of the first."""
    dev = next(iter(tables.values()))[0].device
    for name, (t, shape) in tables.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous fp32 {list(shape)} "
                             f"on {dev}; got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def _launch(wext: Tensor, wtext: Tensor, rows: Tensor, cols: Tensor,
            x: Tensor, mask: Tensor, x_max, power, alpha, gext=None,
            gtext=None, accw=None, accwt=None) -> Tensor:
    """One B5 launch: the AdaGrad step in place when ``gext``/``gtext``
    are given, else the touched rows of the zeroed ``accw``/``accwt``.
    Returns the loss sums ``[1, 2]``."""
    dev = wext.device
    if dev.type != "cuda":
        raise ValueError(f"B5 needs CUDA tensors; wext is on {dev} (CPU "
                         f"tensors take the plain twins)")
    V, E = wext.shape
    D = E - 2
    if D <= 0:
        raise ValueError(f"B5 needs D >= 1, got extended width {E}")
    _check_tables(wext=(wext, (V, E)), wtext=(wtext, (V, E)))
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
    step = gext is not None
    loss = torch.empty((1, 2), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        scratch = cuda_build.scratch(lib, "glove_chunk_scratch_bytes", dev, B,
                                     D, V, SEGMENT)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.glove_chunk(
            *(t.data_ptr() for t in args), wext.data_ptr(), wtext.data_ptr(),
            *((gext.data_ptr(), gtext.data_ptr(), None, None) if step
              else (None, None, accw.data_ptr(), accwt.data_ptr())),
            loss.data_ptr(), scratch.data_ptr(), B, D, V, SEGMENT,
            float(x_max), float(power), float(alpha), int(step), stream)
    cuda_build.raise_on_error(lib, "glove_chunk", "glove_chunk", err)
    global launches
    with _launch_lock:
        launches += 1
    return loss


def fused_glove_chunk_cuda(wext: Tensor, wtext: Tensor, rows: Tensor,
                           cols: Tensor, x: Tensor, mask: Tensor, *,
                           x_max: float, power: float
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """B5's accumulator mode on CUDA tensors of any width (extended rows
    wider than 512 take the kernel's wide path): ``(accw, accwt,
    loss_sums)`` as :func:`fused_glove_chunk_plain` returns them, the
    tables unchanged.  Raises for anything it does not take, CPU tensors
    included."""
    V, E = wext.shape
    accw = torch.zeros((V, 2 * E - 1), dtype=torch.float32,
                       device=wext.device)
    accwt = torch.zeros_like(accw)
    loss = _launch(wext, wtext, rows, cols, x, mask, x_max, power, 0.0,
                   accw=accw, accwt=accwt)
    return accw, accwt, loss


def glove_chunk_step_cuda(wext: Tensor, wtext: Tensor, gext: Tensor,
                          gtext: Tensor, rows: Tensor, cols: Tensor,
                          x: Tensor, mask: Tensor, alpha, *, x_max: float,
                          power: float):
    """One training chunk on CUDA tensors: B5, then each side's AdaGrad
    step (:func:`apply_chunk`) on every touched row, IN PLACE.  ``wext``
    / ``wtext`` ``[V, D+2]`` are :func:`nlp.glove.to_extended`'s tables,
    ``gext`` / ``gtext`` ``[V, D+1]`` their AdaGrad sums, all contiguous
    fp32.  Returns ``(wext, wtext, gext, gtext, loss_sums)``, the first
    four the tensors it was given."""
    V, E = wext.shape
    _check_tables(wext=(wext, (V, E)), gext=(gext, (V, E - 1)),
                  gtext=(gtext, (V, E - 1)))
    loss = _launch(wext, wtext, rows, cols, x, mask, x_max, power, alpha,
                   gext=gext, gtext=gtext)
    return wext, wtext, gext, gtext, loss


def glove_chunk_step_plain(wext: Tensor, wtext: Tensor, gext: Tensor,
                           gtext: Tensor, rows: Tensor, cols: Tensor,
                           x: Tensor, mask: Tensor, alpha, *, x_max: float,
                           power: float):
    """:func:`glove_chunk_step_cuda`'s function in plain PyTorch, on any
    device, returning new tensors: :func:`fused_glove_chunk_plain`, then
    :func:`apply_chunk` on (w|b) and on (wt|bt)."""
    D = wext.shape[1] - 2
    accw, accwt, loss = fused_glove_chunk_plain(
        wext, wtext, rows, cols, x, mask, x_max=x_max, power=power)
    wb, gext = apply_chunk(wext[:, :D + 1], gext, accw, alpha)
    wtb, gtext = apply_chunk(torch.cat([wtext[:, :D], wtext[:, D + 1:]], 1),
                             gtext, accwt, alpha)
    wext = torch.cat([wb, wext[:, D + 1:]], 1)
    wtext = torch.cat([wtb[:, :D], wtext[:, D:D + 1], wtb[:, D:]], 1)
    return wext, wtext, gext, gtext, loss


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
