"""Hand-kernel-vs-plain selection policy for attention, word2vec and GloVe.

Port of ``deeplearning4j_tpu/ops/kernel_select.py:resolve_attn_kernel``
(:29-87) and ``resolve_kernel``/``kernel_name`` (:90-118), with the
same contract: ``"auto"`` degrades silently to the
plain PyTorch attention, and an explicit kernel request raises where
the kernel cannot run rather than falling back.  The modes are spelled
``("auto", "cuda", "plain")``: ``"cuda"`` stands where the JAX package
has ``"pallas"`` and ``"plain"`` where it has ``"xla"``.  The port has
no interpreter, so a forced ``"cuda"`` on CPU tensors raises (the JAX
policy runs Pallas interpreted there).  Attention adds ``"ring"``
(:data:`ATTN_KERNELS`, :func:`resolve_attn_kernel`): on a mesh whose
``seq`` axis is above 1 ring attention (``parallel/ring_attention.py``)
owns the sequence, as in the reference (:23-73).  The TPU's measured crossover (``FLASH_MIN_SEQ``) is
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

#: the attention modes: the shared vocabulary plus ``"ring"``
#: (sequence-parallel ring attention)
ATTN_KERNELS = KERNELS + ("ring",)


def resolve_attn_kernel(kernel: str, *, aligned: bool, on_cuda: bool,
                        seq_degree: int = 1,
                        desc: str = "transformer attention",
                        autotuned: Optional[str] = None) -> str:
    """The attention implementation (``"ring"``, ``"cuda"`` or
    ``"plain"``) for a requested mode, the reference's
    ``resolve_attn_kernel`` (:29-87).  ``seq_degree`` is the mesh's
    sequence-parallel degree: above 1 ring attention owns the axis, so
    ``"auto"`` and ``"plain"`` take ``"ring"`` (a forced ``"plain"``
    runs the ring over plain blocks), a forced ``"cuda"`` raises, and a
    forced ``"ring"`` without it raises.  A rank holds a block of each
    sequence there, so no autotuned winner turns the ring into a local
    attention (the ring's block step picks the kernel or the plain
    form).  Below that it is :func:`resolve_kernel`."""
    if kernel not in ATTN_KERNELS:
        raise ValueError(
            f"kernel must be one of {ATTN_KERNELS}, got {kernel!r}")
    if kernel == "ring":
        if seq_degree <= 1:
            raise ValueError(
                f"kernel='ring' but {desc} cannot run ring attention: no "
                f"sharded sequence axis (seq degree {seq_degree}) — never "
                f"a silent fallback on an explicit request")
        return "ring"
    if seq_degree > 1:
        if kernel == "cuda":
            raise ValueError(
                f"kernel='cuda' but {desc} runs under sequence "
                f"parallelism (seq degree {seq_degree}) — ring attention "
                f"owns a sharded sequence axis; request kernel='ring' or "
                f"'auto'")
        return "ring"
    return resolve_kernel(kernel, aligned=aligned, on_cuda=on_cuda,
                          desc=desc, autotuned=autotuned)


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

