"""Random draws on an explicit ``torch.Generator``.

Port of ``deeplearning4j_tpu/ops/random.py``.  The reference threads
``jax.random`` keys (``KeyStream`` splits them on the host); here a
caller seeds a ``torch.Generator`` on the tensors' device and each draw
takes it.  Threefry and Philox never agree, so the draws match the
reference in distribution, not bit for bit.  The samplers come in two
halves: the draw (uniforms, normals) from the generator, and a pure
function of the draw, so a caller can hand over another source's draws
(the tests give JAX's: ``jax.random.bernoulli(key, p)`` is
``jax.random.uniform(key, p.shape) < p``).
"""

from __future__ import annotations

from typing import Optional, Union

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


def bernoulli_sample(gen: Optional[torch.Generator], p: Tensor,
                     u: Optional[Tensor] = None) -> Tensor:
    """Sample {0,1} with probability p (RBM binary units,
    BinomialSamplingPreProcessor parity), in ``p``'s dtype; ``u`` gives
    the uniforms in [0, 1) instead of ``gen``."""
    if u is None:
        u = torch.rand(p.shape, generator=gen, device=p.device)
    return (u < p).to(p.dtype)


def gaussian_sample(gen: Optional[torch.Generator], mean: Tensor,
                    std: Union[float, Tensor] = 1.0,
                    z: Optional[Tensor] = None) -> Tensor:
    """``mean + std * N(0, 1)``; ``z`` gives the standard normals
    instead of ``gen``."""
    if z is None:
        z = torch.randn(mean.shape, generator=gen, device=mean.device,
                        dtype=mean.dtype)
    return mean + std * z
