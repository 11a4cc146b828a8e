"""PyTorch and CUDA port of ``deeplearning4j_tpu`` for an NVIDIA H100.

The JAX package beside it is the reference; this package mirrors its
sub-package and module names (``models/bert.py`` here is the counterpart
of ``deeplearning4j_tpu/models/bert.py``) and imports neither JAX nor
anything of the JAX package.  Every TPU kernel the port has reached is a
hand-written CUDA kernel under ``csrc/``; plain tensor code is PyTorch.

Devices: every entry point takes ``device=None``, which means
``"cuda"``, and raises when CUDA is absent.  It never drops to the CPU
on its own: the CPU runs only when the caller passes ``device="cpu"``
(the tests do).  On the CPU each kernel wrapper runs its plain PyTorch
twin; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``: None means ``"cuda"``.  Raises
    when CUDA is asked for and absent.  On CUDA it also pins fp32
    matrix products and convolutions to full fp32 (no TF32), which the
    JAX reference's fp32 results assume."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU (its kernels then run their plain PyTorch "
                "twins)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402,F401
