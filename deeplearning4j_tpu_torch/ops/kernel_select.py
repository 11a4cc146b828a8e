"""Hand-kernel-vs-plain selection policy for attention, word2vec and GloVe.

Port of ``deeplearning4j_tpu/ops/kernel_select.py:resolve_attn_kernel``
(:29-87) and ``resolve_kernel``/``kernel_name`` (:90-118), with the
same contract: ``"auto"`` degrades silently to the
plain PyTorch attention, and an explicit kernel request raises where
the kernel cannot run rather than falling back.  The modes are spelled
``("auto", "cuda", "plain")``: ``"cuda"`` stands where the JAX package
has ``"pallas"`` and ``"plain"`` where it has ``"xla"``.  The port has
no interpreter, so a forced ``"cuda"`` on CPU tensors raises (the JAX
policy runs Pallas interpreted there).  ``"ring"`` comes with the
parallel slice.  The TPU's measured crossover (``FLASH_MIN_SEQ``) is
not carried over: on CUDA, auto takes the kernel for every shape it
supports, unless the caller opted in to the autotuner
(``make_attn_fn(autotune=True)``, ``runtime/autotune.py``) and it
measured the plain attention faster on this card at this shape bucket
(``autotuned="plain"``).

For word2vec and GloVe the TPU policy also held a VMEM budget: the
Pallas kernels kept the whole tables in VMEM, so ``choose_block``
(``pallas_word2vec.py:65``, ``pallas_glove.py:49``),
``VMEM_BUDGET_BYTES`` and the ``probe_compile`` guards (:284, :181)
decided whether a vocabulary fit at all.  On the H100 the tables stay
in HBM and the kernels gather rows, so none of that carries over: both
kernels take tables of any width (rows wider than 512 columns take a
wide path that strides over them), so the engines pass ``aligned=True``
and :func:`resolve_kernel` takes the kernel for every CUDA tensor.  The
name it returns (``"cuda"`` or ``"plain"``) is what a fit records as
``kernel_used``, the role of ``kernel_name``.
"""

from __future__ import annotations

from typing import Optional

KERNELS = ("auto", "cuda", "plain")


def resolve_kernel(kernel: str, *, aligned: bool, on_cuda: bool,
                   desc: str = "flash attention",
                   autotuned: Optional[str] = None) -> str:
    """The implementation (``"cuda"`` or ``"plain"``) for a requested
    ``kernel`` mode.  ``aligned`` is the kernel's verdict on the shape
    and dtype, ``on_cuda`` whether the tensors lie on a CUDA device,
    ``autotuned`` a measured winner for ``"auto"`` to follow (None when
    nothing was measured)."""
    if kernel not in KERNELS:
        raise ValueError(
            f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel == "plain":
        return "plain"
    if kernel == "cuda":
        if not on_cuda:
            raise ValueError(
                f"kernel='cuda' but {desc} got CPU tensors — never a "
                f"silent fallback on an explicit request")
        if not aligned:
            raise ValueError(
                f"kernel='cuda' but {desc} cannot run the CUDA kernel: "
                f"shape or dtype not supported — never a silent fallback "
                f"on an explicit request")
        return "cuda"
    if not (aligned and on_cuda):
        return "plain"
    return "plain" if autotuned == "plain" else "cuda"

