"""AdamW written out to optax's semantics (``optax.adamw``: eps_root 0,
no mask, the decay added to the update before the learning rate):

    mu = b1 mu + (1 - b1) g;   nu = b2 nu + (1 - b2) g^2;   t += 1
    u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
    p  = p - lr u

Plain float32 over flat lists of leaves.
"""

from __future__ import annotations

from typing import List

import torch

Tensor = torch.Tensor


class AdamW:
    def __init__(self, params: List[Tensor], learning_rate: float,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = (
            learning_rate, weight_decay, b1, b2, eps)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, params: List[Tensor], grads: List[Tensor]) -> None:
        """Update ``params`` in place from ``grads``."""
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.wd * p
            p.sub_(self.lr * u)
