"""Hand-kernel-vs-plain selection policy for attention.

Port of ``deeplearning4j_tpu/ops/kernel_select.py:resolve_attn_kernel``
(:29-87), with the same contract: ``"auto"`` degrades silently to the
plain PyTorch attention, and an explicit kernel request raises where
the kernel cannot run rather than falling back.  The modes are spelled
``("auto", "cuda", "plain")``: ``"cuda"`` stands where the JAX package
has ``"pallas"`` and ``"plain"`` where it has ``"xla"``.  The port has
no interpreter, so a forced ``"cuda"`` on CPU tensors raises (the JAX
policy runs Pallas interpreted there).  ``"ring"`` comes with the
parallel slice.  The TPU's measured crossover (``FLASH_MIN_SEQ``) is
not carried over: on CUDA, auto takes the kernel for every shape it
supports until the H100 crossover is measured.
"""

from __future__ import annotations

ATTN_KERNELS = ("auto", "cuda", "plain")


def resolve_attn_kernel(kernel: str, *, aligned: bool, on_cuda: bool,
                        desc: str = "flash attention") -> str:
    """The implementation (``"cuda"`` or ``"plain"``) for a requested
    ``kernel`` mode.  ``aligned`` is the kernel's verdict on the shape
    and dtype, ``on_cuda`` whether the tensors lie on a CUDA device."""
    if kernel not in ATTN_KERNELS:
        raise ValueError(
            f"kernel must be one of {ATTN_KERNELS}, got {kernel!r}")
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
    return "cuda" if (aligned and on_cuda) else "plain"
