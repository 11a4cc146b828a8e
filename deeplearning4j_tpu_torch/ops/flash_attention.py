"""Flash attention: hand-written CUDA kernels and their plain twins.

Port of ``deeplearning4j_tpu/ops/pallas_attention.py``.  Three kernels
replace the three Pallas kernels there:

- B1, ``csrc/flash_fwd.cu``: the forward ``_fwd_kernel`` (:83, launched
  by ``_fwd`` at :145): online softmax over key tiles with fp32
  statistics, an additive per-key bias, optional causal masking, and
  the fp32 logsumexp saved beside the output for the backward kernels;
- B2 and B3, ``csrc/flash_bwd.cu``: the backward ``_bwd_dkv_kernel``
  (:188) and ``_bwd_dq_kernel`` (:240), launched by ``_bwd`` (:281),
  which rebuild p = exp(s - lse) from the saved lse.

The C entry points of both route bf16 with D = 64 or 128 to Hopper
kernels (wgmma + TMA), other bf16 to mma.sync kernels and fp32 to
CUDA-core ones (:func:`fwd_route` and :func:`bwd_route` report the
choice).

Entry points:

- :func:`flash_attention_fwd` and :func:`flash_attention_bwd` on
  ``[BH, T, D]`` (the layout of ``_fwd`` and ``_bwd``).  On CPU tensors
  they run :func:`flash_attention_fwd_plain` and
  :func:`flash_attention_bwd_plain`; on CUDA tensors they launch the
  kernels or raise.  There is no fallback from a CUDA tensor to a plain
  twin.
- :func:`flash_attention` on ``[B, T, NH, D]`` (:374-403) keeps the JAX
  layout: the kernels read and write it through strides, and index the
  ``[B, Tk]`` mask bias by ``bh // NH`` instead of repeating it.  It is
  differentiable through :class:`FlashAttentionFn`, the counterpart of
  ``_flash_bhtd``'s ``custom_vjp`` (:356-371).
- :func:`make_attn_fn` is the dispatch every transformer forward takes
  (:446-623), through ``kernel_select.resolve_kernel``.

``launches`` (B1), ``launches_dkv`` (B2) and ``launches_dq`` (B3) count
kernel launches (never plain-twin calls), so a run can show that its
path went through each kernel.  A launch recorded in a CUDA graph
counts once at every replay (``runtime/compile_cache`` books it).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.ops import kernel_select as ks
from deeplearning4j_tpu_torch.runtime import compile_cache

Tensor = torch.Tensor

#: additive mask value, as in the JAX kernel: NOT -inf or -1e9, because
#: the backward rebuilds p = exp(s - lse) from the saved fp32 lse, and a
#: fully masked row has to keep log(Tk) beside it (ulp(1e5) = 0.008)
MASK_VAL = -1e5

#: the forward kernel's key tile (``kFlashKeyTile`` in
#: ``csrc/flash_common.cuh``): under causal masking B1 skips every key
#: tile past the one that holds a row's 64-row tile, and B2/B3 rebuild p
#: over exactly those tiles.  The plain twins follow it with
#: ``causal_tile=CAUSAL_TILE``.
CAUSAL_TILE = 64

#: kernel launches since the process started (or the caller reset them):
#: B1 (forward), B2 (dK/dV) and B3 (dQ)
launches = 0
launches_dkv = 0
launches_dq = 0
_COUNTERS = ("launches", "launches_dkv", "launches_dq")
_launch_lock = threading.Lock()

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_MAX_GRID_Y = 65535


def _note_launch(counter: str) -> None:
    with _launch_lock:
        globals()[counter] += 1


def launch_counts() -> Dict[str, int]:
    """``{"launches": B1, "launches_dkv": B2, "launches_dq": B3}``."""
    with _launch_lock:
        return {name: globals()[name] for name in _COUNTERS}


def reset_launches() -> None:
    """Set the three launch counters to 0."""
    with _launch_lock:
        for name in _COUNTERS:
            globals()[name] = 0


def _add_launches(counts: Dict[str, int]) -> None:
    """Book ``{counter: n}`` launches (a CUDA-graph replay's)."""
    with _launch_lock:
        for name, n in counts.items():
            globals()[name] += n


compile_cache.register_launch_counters(launch_counts, _add_launches)


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def _causal_tiles_skipped(Tq: int, Tk: int, causal_tile: Optional[int],
                          device) -> Optional[Tensor]:
    """``[Tq, Tk]`` True where key // causal_tile > row // causal_tile:
    the pairs the kernels never score under causal masking (None when
    ``causal_tile`` is None)."""
    if causal_tile is None:
        return None
    rows = torch.arange(Tq, device=device) // causal_tile
    keys = torch.arange(Tk, device=device) // causal_tile
    return keys[None, :] > rows[:, None]


def flash_attention_fwd_plain(q4: Tensor, k4: Tensor, v4: Tensor,
                              bias: Optional[Tensor] = None,
                              causal: bool = False,
                              causal_tile: Optional[int] = None
                              ) -> Tuple[Tensor, Tensor]:
    """The kernel's arithmetic in plain PyTorch, on any device: q4
    ``[BH, Tq, D]``, k4/v4 ``[BH, Tk, D]``, bias ``[R, Tk]`` fp32 with
    ``BH % R == 0`` (row ``bh // (BH // R)``), or None.  Returns ``o``
    in q4's dtype and ``lse`` fp32 ``[BH, Tq]``.  Scores and sums are
    fp32; p is cast to v's dtype before p.V, as in the kernel.  With
    ``causal`` and ``causal_tile`` (e.g. :data:`CAUSAL_TILE`) the keys of
    tiles past a row's own drop out of its softmax, as in the kernel: the
    two then agree on every row, a causal row whose every key is masked
    included."""
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
        skipped = _causal_tiles_skipped(Tq, Tk, causal_tile, s.device)
        if skipped is not None:
            s = s.masked_fill(skipped, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)    # fully masked rows
    o = torch.matmul(p.to(v4.dtype).float(), v4.float()) / l
    return o.to(q4.dtype), (m + torch.log(l))[..., 0]


def _bwd_plain_p_ds(q4: Tensor, k4: Tensor, v4: Tensor,
                    bias: Optional[Tensor], o: Tensor, lse: Tensor,
                    do: Tensor, causal: bool,
                    causal_tile: Optional[int] = None
                    ) -> Tuple[Tensor, Tensor]:
    """p = exp(s - lse) and dS = p * (dO V^T - delta) * scale, fp32
    ``[BH, Tq, Tk]``, with delta = rowsum(dO * O); with ``causal`` and
    ``causal_tile``, p = 0 where key // causal_tile > row // causal_tile,
    as in B2 and B3."""
    BH, Tq, D = q4.shape
    Tk = k4.shape[1]
    scale = 1.0 / math.sqrt(D)
    s = torch.matmul(q4.float(), k4.float().transpose(1, 2)) * scale
    if bias is not None:
        rows = bias.float().repeat_interleave(BH // bias.shape[0], dim=0)
        s = s + rows[:, None, :]
    if causal:
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full_like(s, MASK_VAL))
    p = torch.exp(s - lse[..., None])
    if causal:
        skipped = _causal_tiles_skipped(Tq, Tk, causal_tile, p.device)
        if skipped is not None:
            p = p.masked_fill(skipped, 0.0)
    delta = (do.float() * o.float()).sum(-1)
    dp = torch.matmul(do.float(), v4.float().transpose(1, 2))
    return p, p * (dp - delta[..., None]) * scale


def flash_attention_bwd_dkv_plain(q4: Tensor, k4: Tensor, v4: Tensor,
                                  bias: Optional[Tensor], o: Tensor,
                                  lse: Tensor, do: Tensor,
                                  causal: bool = False,
                                  causal_tile: Optional[int] = None
                                  ) -> Tuple[Tensor, Tensor]:
    """B2's plain twin: ``(dk, dv)``; p is cast to dO's dtype before
    P^T dO and dS to the input dtype before dS^T Q, with fp32 sums."""
    p, ds = _bwd_plain_p_ds(q4, k4, v4, bias, o, lse, do, causal,
                            causal_tile)
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do.float())
    dk = torch.matmul(ds.to(q4.dtype).float().transpose(1, 2), q4.float())
    return dk.to(k4.dtype), dv.to(v4.dtype)


def flash_attention_bwd_dq_plain(q4: Tensor, k4: Tensor, v4: Tensor,
                                 bias: Optional[Tensor], o: Tensor,
                                 lse: Tensor, do: Tensor,
                                 causal: bool = False,
                                 causal_tile: Optional[int] = None) -> Tensor:
    """B3's plain twin: ``dq``; dS is cast to the input dtype before
    dS K, with an fp32 sum."""
    _, ds = _bwd_plain_p_ds(q4, k4, v4, bias, o, lse, do, causal,
                            causal_tile)
    return torch.matmul(ds.to(k4.dtype).float(), k4.float()).to(q4.dtype)


def flash_attention_bwd_plain(q4: Tensor, k4: Tensor, v4: Tensor,
                              bias: Optional[Tensor], o: Tensor, lse: Tensor,
                              do: Tensor, causal: bool = False,
                              causal_tile: Optional[int] = None
                              ) -> Tuple[Tensor, Tensor, Tensor]:
    """``_bwd``'s arithmetic (:281-349) in plain PyTorch, on any device:
    the inputs of :func:`flash_attention_fwd_plain` plus its ``o`` and
    ``lse`` and the output gradient ``do`` ``[BH, Tq, D]``.  Returns
    ``(dq, dk, dv)`` in the input dtype, rebuilt from p = exp(s - lse)
    as the kernels do.  By default it skips no causal tiles, and differs
    from B2 and B3 only on a causal row whose every key is masked, whose
    lse depends on the tiles the forward walked; ``causal_tile`` (e.g.
    :data:`CAUSAL_TILE`) skips the kernels' tiles and agrees with them
    there too."""
    dk, dv = flash_attention_bwd_dkv_plain(q4, k4, v4, bias, o, lse, do,
                                           causal, causal_tile)
    dq = flash_attention_bwd_dq_plain(q4, k4, v4, bias, o, lse, do, causal,
                                      causal_tile)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

#: ctypes argument types of each library's entry points
_ARGTYPES = {
    # q, k, v, bias, o, lse, strides; is_bf16, bh, nh, bias_nh, tq, tk, d,
    # causal; scale; stream
    "flash_fwd": {"flash_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                  + [ctypes.c_float, ctypes.c_void_p],
                  # is_bf16, d / d
                  "flash_fwd_route": [ctypes.c_int] * 2,
                  "flash_fwd_wgmma_smem": [ctypes.c_int]},
    # q, k, v, dout, bias, lse, delta, dq, dk, dv, strides; the same ints;
    # scale; stream
    "flash_bwd": {**{fn: [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                     + [ctypes.c_float, ctypes.c_void_p]
                     for fn in ("flash_bwd_dkv", "flash_bwd_dq")},
                  # is_bf16, d / kernel (0: B2, 1: B3), d
                  "flash_bwd_route": [ctypes.c_int] * 2,
                  "flash_bwd_wgmma_smem": [ctypes.c_int] * 2},
}
#: flash_fwd_route's and flash_bwd_route's answers: which kernels run
ROUTES = {2: "wgmma", 1: "mma.sync", 0: "cuda-cores"}
_libs: Dict[str, ctypes.CDLL] = {}


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = cuda_build.bind(name, _ARGTYPES[name])
    return lib


def fwd_route(dtype: torch.dtype, D: int) -> str:
    """Which kernel B1 runs for ``dtype`` and head dim ``D``, as the C
    entry point chooses (the library is built if needed, so this needs
    nvcc): ``"wgmma"`` (bf16 with D = 64 or 128: wgmma + TMA),
    ``"mma.sync"`` (other bf16) or ``"cuda-cores"`` (fp32)."""
    lib = _library("flash_fwd")
    return ROUTES[lib.flash_fwd_route(int(dtype == torch.bfloat16), D)]


def fwd_wgmma_smem(D: int) -> int:
    """Dynamic shared memory (bytes) of the wgmma B1 at head dim ``D``
    (0 where the case takes another route)."""
    return _library("flash_fwd").flash_fwd_wgmma_smem(D)


def bwd_route(dtype: torch.dtype, D: int) -> str:
    """Which kernels B2 and B3 run for ``dtype`` and head dim ``D``, as
    the C entry points choose (the library is built if needed, so this
    needs nvcc): ``"wgmma"`` (bf16 with D = 64 or 128: wgmma + TMA),
    ``"mma.sync"`` (other bf16) or ``"cuda-cores"`` (fp32)."""
    lib = _library("flash_bwd")
    return ROUTES[lib.flash_bwd_route(int(dtype == torch.bfloat16), D)]


def bwd_wgmma_smem(D: int) -> Tuple[int, int]:
    """Dynamic shared memory (bytes) of the wgmma B2 and B3 at head dim
    ``D`` (0 where the case takes another route)."""
    lib = _library("flash_bwd")
    return lib.flash_bwd_wgmma_smem(0, D), lib.flash_bwd_wgmma_smem(1, D)


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


def _strides_ok(x: Tensor) -> bool:
    """Strides the kernels take: a unit last stride, the others multiples
    of 8 elements, and a 16-byte aligned start."""
    return (x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:-1])
            and x.data_ptr() % 16 == 0)


def _check_kernel_inputs(q: Tensor, k: Tensor, v: Tensor,
                         bias: Optional[Tensor], causal: bool,
                         heads_layout: bool):
    """Validate what every kernel takes; returns ``(BH, NH, Tq, Tk, D,
    bias_nh)``.  Raises on anything the kernels do not take, CPU tensors
    included.  ``heads_layout``: tensors are ``[B, T, NH, D]`` (else
    ``[BH, T, D]``)."""
    _check_common(q, k, v, causal, 1)
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
        if not _strides_ok(x):
            raise ValueError(f"{name} needs a unit last stride, the others "
                             f"multiples of 8 and a 16-byte aligned start, "
                             f"got {x.stride()}")
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
    return BH, NH, Tq, Tk, D, bias_nh


def _bht(x: Tensor, heads_layout: bool):
    """Element strides of (batch, head, token)."""
    if heads_layout:
        return x.stride(0), x.stride(2), x.stride(1)
    return x.stride(0), 0, x.stride(1)


def _launch(q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor],
            causal: bool, heads_layout: bool) -> Tuple[Tensor, Tensor]:
    """Validate and launch B1; returns ``(o, lse)``."""
    BH, NH, Tq, Tk, D, bias_nh = _check_kernel_inputs(q, k, v, bias, causal,
                                                       heads_layout)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for x in (q, k, v, o) for s in _bht(x, heads_layout)))
    lib = _library("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            o.data_ptr(), lse.data_ptr(), ctypes.addressof(strides),
            int(q.dtype == torch.bfloat16), BH, NH, bias_nh, Tq, Tk, D,
            int(causal), 1.0 / math.sqrt(D), stream)
    cuda_build.raise_on_error(lib, "flash_fwd", "flash_fwd", err)
    _note_launch("launches")
    return o, lse


def _launch_bwd(q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor],
                o: Tensor, lse: Tensor, do: Tensor, causal: bool,
                heads_layout: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """Validate and launch B2 then B3; returns ``(dq, dk, dv)`` in the
    input dtype.  delta = rowsum(dO * O) is a plain reduction, as JAX
    computes it outside Pallas (:290).  A ``do`` with strides the
    kernels do not take is made contiguous first."""
    BH, NH, Tq, Tk, D, bias_nh = _check_kernel_inputs(q, k, v, bias, causal,
                                                       heads_layout)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} must match q ({tuple(q.shape)} {q.dtype} on "
                f"{q.device}); got {tuple(x.shape)} {x.dtype} on {x.device}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (BH, Tq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous fp32 [{BH}, {Tq}] on "
                         f"{q.device}; got {lse.dtype} {tuple(lse.shape)}")
    if not _strides_ok(do):
        do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1)
    if heads_layout:                                   # [B, Tq, NH]
        delta = delta.permute(0, 2, 1)
    delta = delta.reshape(BH, Tq).contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    strides = (ctypes.c_longlong * 21)(
        *(s for x in (q, k, v, do, dq, dk, dv)
          for s in _bht(x, heads_layout)))
    lib = _library("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), ctypes.addressof(strides),
                int(q.dtype == torch.bfloat16), BH, NH, bias_nh, Tq, Tk, D,
                int(causal), 1.0 / math.sqrt(D), stream)
        for fn, counter in (("flash_bwd_dkv", "launches_dkv"),
                            ("flash_bwd_dq", "launches_dq")):
            cuda_build.raise_on_error(lib, "flash_bwd", fn,
                                      getattr(lib, fn)(*args))
            _note_launch(counter)
    return dq, dk, dv


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


def flash_attention_bwd_cuda(q4: Tensor, k4: Tensor, v4: Tensor,
                             bias: Optional[Tensor], o: Tensor, lse: Tensor,
                             do: Tensor, causal: bool = False
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch B2 then B3 on ``[BH, T, D]`` CUDA tensors; raises for
    anything they do not take, CPU tensors included."""
    return _launch_bwd(q4, k4, v4, bias, o, lse, do, causal,
                       heads_layout=False)


def flash_attention_bwd(q4: Tensor, k4: Tensor, v4: Tensor,
                        bias: Optional[Tensor], o: Tensor, lse: Tensor,
                        do: Tensor, causal: bool = False
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """``_bwd`` (:281): the inputs and outputs of
    :func:`flash_attention_fwd` and the output gradient ``do`` ->
    ``(dq, dk, dv)``.  CPU tensors run the plain twin; CUDA tensors
    launch the kernels or raise."""
    if q4.device.type == "cpu":
        _check_common(q4, k4, v4, causal, 1)
        return flash_attention_bwd_plain(q4, k4, v4, bias, o, lse, do,
                                         causal)
    return flash_attention_bwd_cuda(q4, k4, v4, bias, o, lse, do, causal)


def _to_bhtd(x: Tensor) -> Tensor:
    B, T, NH, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * NH, T, D)


def _from_bhtd(x: Tensor, B: int, NH: int) -> Tensor:
    _, T, D = x.shape
    return x.reshape(B, NH, T, D).permute(0, 2, 1, 3)


def flash_fwd_heads(q: Tensor, k: Tensor, v: Tensor,
                    bias: Optional[Tensor] = None,
                    causal: bool = False) -> Tuple[Tensor, Tensor]:
    """B1 on ``[B, T, NH, D]`` (the kernel reads the layout through
    strides): ``(o [B, Tq, NH, D], lse [B*NH, Tq] fp32)``, row ``b * NH
    + h`` of lse for head ``h`` of batch row ``b``; bias ``[B, Tk]``
    fp32 or None.  CPU tensors run the plain twin; CUDA tensors launch
    the kernel or raise."""
    if q.device.type == "cpu":
        _check_common(q, k, v, causal, 1)
        o4, lse = flash_attention_fwd_plain(_to_bhtd(q), _to_bhtd(k),
                                            _to_bhtd(v), bias, causal)
        return _from_bhtd(o4, q.shape[0], q.shape[2]), lse
    return _launch(q, k, v, bias, causal, heads_layout=True)


def flash_bwd_heads(q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor],
                    o: Tensor, lse: Tensor, do: Tensor,
                    causal: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """B2 then B3 on ``[B, T, NH, D]``: ``(dq, dk, dv)`` from the
    forward's inputs, an output ``o`` and its lse (those of
    :func:`flash_fwd_heads`, or a merge of several, as ring attention
    passes) and the output gradient ``do``.  CPU tensors run the plain
    twin; CUDA tensors launch the kernels or raise."""
    if q.device.type == "cpu":
        grads = flash_attention_bwd_plain(
            _to_bhtd(q), _to_bhtd(k), _to_bhtd(v), bias, _to_bhtd(o), lse,
            _to_bhtd(do), causal)
        return tuple(_from_bhtd(g, q.shape[0], q.shape[2]) for g in grads)
    return _launch_bwd(q, k, v, bias, o, lse, do, causal, heads_layout=True)


class FlashAttentionFn(torch.autograd.Function):
    """``_flash_bhtd``'s ``custom_vjp`` (:356-371) on ``[B, T, NH, D]``.
    The forward (:func:`flash_fwd_heads`) saves q, k, v, the bias, o
    and lse; the backward (:func:`flash_bwd_heads`) returns no gradient
    for the bias, as at :349."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor,
                bias: Optional[Tensor], causal: bool) -> Tensor:
        o, lse = flash_fwd_heads(q, k, v, bias, causal)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do: Tensor):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_heads(q, k, v, bias, o, lse, do, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor,
                    mask: Optional[Tensor] = None,
                    causal: bool = False) -> Tensor:
    """Flash attention ``[B, T, NH, D] -> [B, T, NH, D]``, a drop-in for
    ``models/transformer.attention`` (mask ``[B, Tk]``, 1 = attend),
    differentiable in q, k and v through :class:`FlashAttentionFn`."""
    bias = None if mask is None else (1.0 - mask.float()) * MASK_VAL
    return FlashAttentionFn.apply(q, k, v, bias, causal)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDecision:
    """What the attention dispatch decided for one shape: ``impl`` is
    what runs (``"ring"``, ``"cuda"`` or ``"plain"``), ``source`` why
    (``"forced"``, ``"heuristic"``, ``"autotuned"``, ``"seq-sharded
    ..."``, or the reason the kernel was passed over)."""
    impl: str
    source: str


def make_attn_fn(kernel: str = "auto", mesh=None, *, autotune: bool = False):
    """An ``attn(q, k, v, mask=None, causal=False)`` drop-in for
    ``models/transformer.attention`` that dispatches per call through
    ``kernel_select.resolve_kernel``: ``"plain"`` forces the plain
    attention, ``"cuda"`` forces the kernel and raises where it cannot
    run, ``"auto"`` takes the kernel on CUDA for every supported shape.
    ``autotune=True`` opts in to the autotuner's cache
    (``runtime/autotune.lookup_attention``): where it holds a winner for
    this card and this shape's buckets (rows = batch x heads, sequence
    lengths), that winner runs and the source is ``"autotuned"``.  The
    cache is consulted only for shapes the kernel supports on CUDA, once
    per shape and dtype (as the reference consults at trace time); by
    default nothing is read and no file decides the route.
    ``attn.describe(q_shape, k_shape, causal, device=, dtype=)`` returns
    the :class:`AttnDecision` without running anything.

    ``mesh=`` (the reference's ``shard_map`` placement, :470-623): on a
    ``data x model`` (or ``x pipe``, ``x expert``) mesh every rank
    calls the function on its own rows and its own heads, so the
    dispatch is this same per-call one on the rank's local shapes, the
    decision and the autotune lookup keyed on local rows (batch x local
    heads); attention stays local to a rank's tokens.  On a mesh whose
    ``seq`` axis is above 1 a rank holds a block of every sequence and
    ``"auto"`` (or ``"ring"``) runs ring attention over ``(mesh,
    "seq")`` (``parallel/ring_attention.ring_attention``: B1-B3 as its
    block step where the kernel takes the shape, the plain block
    otherwise; a forced ``"plain"`` runs the ring over plain blocks); a
    forced ``"cuda"`` there raises, as does a forced ``"ring"`` without
    such an axis (``kernel_select.resolve_attn_kernel``).  A missing
    mask is a mask of ones, as at :589-590.
    """
    from deeplearning4j_tpu_torch.parallel.mesh import seq_degree

    if kernel not in ks.ATTN_KERNELS:
        raise ValueError(
            f"kernel must be one of {ks.ATTN_KERNELS}, got {kernel!r}")
    sp = seq_degree(mesh)
    decisions: Dict[tuple, AttnDecision] = {}

    def describe(q_shape, k_shape, causal: bool = False, *,
                 device="cuda", dtype=torch.bfloat16) -> AttnDecision:
        B, Tq, NH, D = q_shape
        Tk = k_shape[1]
        dev = torch.device(device)
        memo = (B * NH, Tq, Tk, D, bool(causal), str(dev), dtype)
        d = decisions.get(memo)
        if d is not None:
            return d
        on_cuda = dev.type == "cuda"
        aligned = kernel_supports(Tq, Tk, D, dtype)
        record = None
        # a decision asked for a card this process cannot see (a CPU
        # host describing a CUDA shape) has no card name to look up
        if (autotune and kernel == "auto" and aligned and on_cuda
                and sp == 1 and torch.cuda.is_available()):
            from deeplearning4j_tpu_torch.runtime import autotune as at
            record = at.lookup_attention(Tq, Tk, D, causal, rows=B * NH,
                                         kind=at.device_kind(dev))
        impl = ks.resolve_attn_kernel(kernel, aligned=aligned,
                                      on_cuda=on_cuda, seq_degree=sp,
                                      autotuned=record["impl"] if record
                                      else None)
        if kernel != "auto":
            source = "forced"
        elif impl == "ring":
            source = f"seq-sharded (seq={sp}: ring owns the axis)"
        elif record is not None:
            source = "autotuned"
        elif impl == "cuda":
            source = "heuristic"
        else:
            source = ("shape or dtype not supported by the kernel"
                      if not aligned else "off-cuda")
        d = decisions[memo] = AttnDecision(impl=impl, source=source)
        return d

    def attn(q, k, v, mask=None, causal=False):
        d = describe(q.shape, k.shape, causal, device=q.device,
                     dtype=q.dtype)
        if d.impl == "ring":
            from deeplearning4j_tpu_torch.parallel.ring_attention import \
                ring_attention
            if mask is None:
                mask = torch.ones(q.shape[0], k.shape[1],
                                  dtype=torch.float32, device=q.device)
            return ring_attention(q, k, v, mask, causal, (mesh, "seq"),
                                  block="plain" if kernel == "plain"
                                  else "auto")
        if d.impl == "cuda":
            return flash_attention(q, k, v, mask, causal)
        from deeplearning4j_tpu_torch.models import transformer as tfm
        return tfm.attention(q, k, v, mask, causal)

    attn.describe = describe
    return attn
