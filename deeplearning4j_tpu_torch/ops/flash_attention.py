"""Flash-attention forward: a hand-written CUDA kernel and its plain twin.

Port of ``deeplearning4j_tpu/ops/pallas_attention.py``.  The kernel
(``csrc/flash_fwd.cu``) replaces the Pallas forward ``_fwd_kernel``
(:83, launched by ``_fwd`` at :145): online softmax over key tiles with
fp32 statistics, an additive per-key bias, optional causal masking, and
the fp32 logsumexp saved beside the output for the backward kernels.

- :func:`flash_attention_fwd` on ``[BH, T, D]`` (the layout of ``_fwd``)
  returns ``(o, lse)``.  On CPU tensors it runs
  :func:`flash_attention_fwd_plain`; on CUDA tensors it launches the
  kernel through :func:`flash_attention_fwd_cuda` or raises.  There is
  no fallback from a CUDA tensor to the plain twin.
- :func:`flash_attention` on ``[B, T, NH, D]`` (:374-403) keeps the JAX
  layout: the kernel reads and writes it through strides, and indexes
  the ``[B, Tk]`` mask bias by ``bh // NH`` instead of repeating it.
- :func:`make_attn_fn` is the dispatch every transformer forward takes
  (:446-623), through ``kernel_select.resolve_attn_kernel``.

``launches`` counts kernel launches (never plain-twin calls), so a run
can show that its path went through the kernel.

Only the forward is ported here; the backward kernels (``_bwd_dkv_kernel``
and ``_bwd_dq_kernel``) come with the training slice.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import kernel_select as ks

Tensor = torch.Tensor

#: additive mask value, as in the JAX kernel: NOT -inf or -1e9, because
#: the backward rebuilds p = exp(s - lse) from the saved fp32 lse, and a
#: fully masked row has to keep log(Tk) beside it (ulp(1e5) = 0.008)
MASK_VAL = -1e5

#: kernel launches since the process started (or the caller reset it)
launches = 0
_launch_lock = threading.Lock()

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_MAX_GRID_Y = 65535


def _note_launch() -> None:
    global launches
    with _launch_lock:
        launches += 1


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q4: Tensor, k4: Tensor, v4: Tensor,
                              bias: Optional[Tensor] = None,
                              causal: bool = False) -> Tuple[Tensor, Tensor]:
    """The kernel's arithmetic in plain PyTorch, on any device: q4
    ``[BH, Tq, D]``, k4/v4 ``[BH, Tk, D]``, bias ``[R, Tk]`` fp32 with
    ``BH % R == 0`` (row ``bh // (BH // R)``), or None.  Returns ``o``
    in q4's dtype and ``lse`` fp32 ``[BH, Tq]``.  Scores and sums are
    fp32; p is cast to v's dtype before p.V, as in the kernel."""
    BH, Tq, D = q4.shape
    Tk = k4.shape[1]
    s = torch.matmul(q4.float(), k4.float().transpose(1, 2)) \
        * (1.0 / math.sqrt(D))
    if bias is not None:
        rows = bias.float().repeat_interleave(BH // bias.shape[0], dim=0)
        s = s + rows[:, None, :]
    if causal:
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full_like(s, MASK_VAL))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)    # fully masked rows
    o = torch.matmul(p.to(v4.dtype).float(), v4.float()) / l
    return o.to(q4.dtype), (m + torch.log(l))[..., 0]


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        from deeplearning4j_tpu_torch.ops import cuda_build

        lib = cuda_build.load("flash_fwd")
        lib.flash_fwd.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_supports(Tq: int, Tk: int, D: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes this shape and dtype: bf16 or fp32, head
    dim a multiple of 8 up to 256 (``_aligned_for_tpu``, :406-410)."""
    return (dtype in _KERNEL_DTYPES and D % 8 == 0 and 0 < D <= 256
            and Tq > 0 and Tk > 0)


def _check_common(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                  t_axis: int) -> None:
    if q.dim() != k.dim() or k.shape != v.shape:
        raise ValueError(f"q/k/v shapes disagree: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (q.shape[:t_axis] != k.shape[:t_axis]
            or q.shape[t_axis + 1:] != k.shape[t_axis + 1:]):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"differ outside the sequence axis")
    if causal and q.shape[t_axis] != k.shape[t_axis]:
        raise ValueError(f"causal flash attention requires Tq == Tk, got "
                         f"{q.shape[t_axis]} != {k.shape[t_axis]}")


def _launch(q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor],
            causal: bool, heads_layout: bool) -> Tuple[Tensor, Tensor]:
    """Validate and launch.  ``heads_layout``: tensors are
    ``[B, T, NH, D]`` (else ``[BH, T, D]``).  Raises on anything the
    kernel does not take; CPU tensors included."""
    t_axis = 1
    _check_common(q, k, v, causal, t_axis)
    if heads_layout:
        if q.dim() != 4:
            raise ValueError(f"expected [B, T, NH, D], got {tuple(q.shape)}")
        B, Tq, NH, D = q.shape
        BH = B * NH
    else:
        if q.dim() != 3:
            raise ValueError(f"expected [BH, T, D], got {tuple(q.shape)}")
        BH, Tq, D = q.shape
        NH = 1
    Tk = k.shape[1]
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not kernel_supports(Tq, Tk, D, q.dtype):
        raise ValueError(
            f"the flash kernel takes bf16/fp32 with D % 8 == 0, D <= 256 "
            f"and T > 0; got {q.dtype}, Tq={Tq}, Tk={Tk}, D={D}")
    if BH > _MAX_GRID_Y:
        raise ValueError(f"batch*heads {BH} exceeds the grid's "
                         f"{_MAX_GRID_Y}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(
                f"the flash kernel needs q/k/v on one CUDA device; {name} "
                f"is on {x.device} (CPU tensors take flash_attention_fwd, "
                f"which runs the plain twin there)")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]):
            raise ValueError(f"{name} needs a unit last stride and the "
                             f"others multiples of 8, got {x.stride()}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    bias_nh = NH
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.dim() != 2
                or bias.shape[1] != Tk or BH % bias.shape[0]
                or not bias.is_contiguous() or bias.device != q.device):
            raise ValueError(
                f"bias must be a contiguous fp32 [R, Tk] on {q.device} "
                f"with BH % R == 0; got {bias.dtype} {tuple(bias.shape)} "
                f"on {bias.device}")
        bias_nh = BH // bias.shape[0]

    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=q.device)

    def bht(x: Tensor):      # element strides of (batch, head, token)
        if heads_layout:
            return x.stride(0), x.stride(2), x.stride(1)
        return x.stride(0), 0, x.stride(1)

    strides = (ctypes.c_longlong * 12)(*bht(q), *bht(k), *bht(v), *bht(o))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            o.data_ptr(), lse.data_ptr(), ctypes.addressof(strides),
            int(q.dtype == torch.bfloat16), BH, NH, bias_nh, Tq, Tk, D,
            int(causal), 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: "
            f"{lib.flash_fwd_error_string(err).decode()} ({err})")
    _note_launch()
    return o, lse


def flash_attention_fwd_cuda(q4: Tensor, k4: Tensor, v4: Tensor,
                             bias: Optional[Tensor] = None,
                             causal: bool = False) -> Tuple[Tensor, Tensor]:
    """Launch the kernel on ``[BH, T, D]`` CUDA tensors; raises for
    anything it does not take, CPU tensors included."""
    return _launch(q4, k4, v4, bias, causal, heads_layout=False)


def flash_attention_fwd(q4: Tensor, k4: Tensor, v4: Tensor,
                        bias: Optional[Tensor] = None,
                        causal: bool = False) -> Tuple[Tensor, Tensor]:
    """``_fwd`` (:145): q4 ``[BH, Tq, D]``, k4/v4 ``[BH, Tk, D]``, bias
    ``[B, Tk]`` fp32 (row ``bh // NH``) or None -> ``(o, lse)``.  Tq and
    Tk may differ when not causal.  CPU tensors run the plain twin;
    CUDA tensors launch the kernel or raise."""
    if q4.device.type == "cpu":
        _check_common(q4, k4, v4, causal, 1)
        return flash_attention_fwd_plain(q4, k4, v4, bias, causal)
    return flash_attention_fwd_cuda(q4, k4, v4, bias, causal)


def flash_attention(q: Tensor, k: Tensor, v: Tensor,
                    mask: Optional[Tensor] = None,
                    causal: bool = False) -> Tensor:
    """Flash attention ``[B, T, NH, D] -> [B, T, NH, D]``, a drop-in for
    ``models/transformer.attention`` (mask ``[B, Tk]``, 1 = attend)."""
    B, Tq, NH, D = q.shape
    bias = None if mask is None else (1.0 - mask.float()) * MASK_VAL
    if q.device.type == "cpu":
        _check_common(q, k, v, causal, 1)

        def to_bhtd(x: Tensor) -> Tensor:
            return x.permute(0, 2, 1, 3).reshape(B * NH, x.shape[1], D)

        o4, _ = flash_attention_fwd_plain(to_bhtd(q), to_bhtd(k),
                                          to_bhtd(v), bias, causal)
        return o4.reshape(B, NH, Tq, D).permute(0, 2, 1, 3)
    o, _ = _launch(q, k, v, bias, causal, heads_layout=True)
    return o


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDecision:
    """What the attention dispatch decided for one shape: ``impl`` is
    what runs (``"cuda"`` or ``"plain"``), ``source`` why (``"forced"``,
    ``"heuristic"``, or the reason the kernel was passed over)."""
    impl: str
    source: str


def make_attn_fn(kernel: str = "auto", mesh=None):
    """An ``attn(q, k, v, mask=None, causal=False)`` drop-in for
    ``models/transformer.attention`` that dispatches per call through
    ``kernel_select.resolve_attn_kernel``: ``"plain"`` forces the plain
    attention, ``"cuda"`` forces the kernel and raises where it cannot
    run, ``"auto"`` takes the kernel on CUDA for every supported shape.
    ``attn.describe(q_shape, k_shape, causal, device=, dtype=)`` returns
    the :class:`AttnDecision` without running anything.  ``mesh=`` (the
    shard_map placement of ``:446-623``) comes with the parallel slice.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh-placed attention is not ported yet: it comes with the "
            "parallel slice of the port (ROADMAP Queue A)")
    if kernel not in ks.ATTN_KERNELS:
        raise ValueError(
            f"kernel must be one of {ks.ATTN_KERNELS}, got {kernel!r}")

    def describe(q_shape, k_shape, causal: bool = False, *,
                 device="cuda", dtype=torch.bfloat16) -> AttnDecision:
        _, Tq, _, D = q_shape
        Tk = k_shape[1]
        on_cuda = torch.device(device).type == "cuda"
        aligned = kernel_supports(Tq, Tk, D, dtype)
        impl = ks.resolve_attn_kernel(kernel, aligned=aligned,
                                      on_cuda=on_cuda,
                                      desc="transformer attention")
        if kernel != "auto":
            source = "forced"
        elif impl == "cuda":
            source = "heuristic"
        else:
            source = ("shape or dtype not supported by the kernel"
                      if not aligned else "off-cuda")
        return AttnDecision(impl=impl, source=source)

    def attn(q, k, v, mask=None, causal=False):
        d = describe(q.shape, k.shape, causal, device=q.device,
                     dtype=q.dtype)
        if d.impl == "cuda":
            return flash_attention(q, k, v, mask, causal)
        from deeplearning4j_tpu_torch.models import transformer as tfm
        return tfm.attention(q, k, v, mask, causal)

    attn.describe = describe
    return attn
