"""Random draws on an explicit ``torch.Generator``.

Port of the dropout part of ``deeplearning4j_tpu/ops/random.py``.  The
reference threads ``jax.random`` keys (``KeyStream`` splits them on the
host); here a caller seeds a ``torch.Generator`` on the tensors' device
and each draw takes it.  Threefry and Philox never agree, so the draws
match the reference in distribution, not bit for bit.  The RBM's
Bernoulli and Gaussian samplers come with the RBM (ROADMAP A5).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def keep_mask(gen: torch.Generator, keep: float, shape, device) -> Tensor:
    """Boolean mask, each entry True with probability ``keep``."""
    return torch.rand(shape, generator=gen, device=device) < keep


def dropout(gen: torch.Generator, x: Tensor, rate: float) -> Tensor:
    """Inverted dropout: zero with probability ``rate``, scale the rest
    by 1 / (1 - rate), so inference needs no correction."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = keep_mask(gen, keep, x.shape, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))
