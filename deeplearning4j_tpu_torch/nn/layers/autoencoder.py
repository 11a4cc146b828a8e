"""Denoising autoencoder.

Port of the ``AutoEncoderLayer`` of
``deeplearning4j_tpu/nn/layers/autoencoder.py`` (:34-67;
``models/featuredetectors/autoencoder/AutoEncoder.java``): tied weights
(encode with W, decode with Wᵀ), masking corruption at
``corruption_level`` (none at level 0), a sigmoid decode and the
reconstruction cross-entropy through ``ops/losses``.  Its gradient is
``torch.autograd.grad`` of that loss, as the reference's is
``jax.value_and_grad``.  The corruption mask is the layer's draw
(:meth:`AutoEncoderLayer.draw`, None at level 0), so a caller can hand
over another source's mask.  The recursive autoencoder is ROADMAP A5b.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch import DeviceLike
from deeplearning4j_tpu_torch.nn import params as P
from deeplearning4j_tpu_torch.nn.conf.configuration import LayerKind
from deeplearning4j_tpu_torch.nn.layers.base import (PretrainLayer,
                                                     register_layer)
from deeplearning4j_tpu_torch.ops import losses as L
from deeplearning4j_tpu_torch.ops.random import keep_mask

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@register_layer(LayerKind.AUTOENCODER)
class AutoEncoderLayer(PretrainLayer):
    def init(self, gen: torch.Generator, device: DeviceLike = None) -> Params:
        return P.pretrain_params(gen, self.conf, device)

    def encode(self, params: Params, x: Tensor) -> Tensor:
        return self.activation(x @ params["W"] + params["b"])

    def decode(self, params: Params, h: Tensor) -> Tensor:
        # tied weights (W.T), sigmoid output for cross-entropy reconstruction
        return torch.sigmoid(h @ params["W"].T + params["vb"])

    def draw(self, gen: Optional[torch.Generator], x: Tensor
             ) -> Optional[Tensor]:
        """The corruption mask (True keeps an input, with probability
        1 - corruption_level), None at level 0."""
        lvl = self.conf.corruption_level
        if lvl <= 0.0:
            return None
        return keep_mask(gen, 1.0 - lvl, x.shape, x.device)

    def corrupt(self, mask: Optional[Tensor], x: Tensor) -> Tensor:
        """Masking corruption at ``corruptionLevel`` (denoising AE)."""
        if self.conf.corruption_level <= 0.0:
            return x
        return torch.where(mask, x, torch.zeros_like(x))

    def reconstruction_loss(self, params: Params, mask: Optional[Tensor],
                            x: Tensor) -> Tensor:
        xc = self.corrupt(mask, x)
        recon = self.decode(params, self.encode(params, xc))
        # L2 is handled by the updater chain, not the loss (no double-count).
        return L.score(x, L.LossFunction.RECONSTRUCTION_CROSSENTROPY, recon)

    def pretrain_core(self, params: Params, draws: Optional[Tensor],
                      x: Tensor) -> Tuple[Tensor, Params]:
        live = {key: p.detach().requires_grad_(True)
                for key, p in params.items()}
        with torch.enable_grad():
            loss = self.reconstruction_loss(live, draws, x)
        keys = sorted(live)
        grads = torch.autograd.grad(loss, [live[key] for key in keys])
        return loss.detach(), dict(zip(keys, grads))

    def reconstruct(self, params: Params, x: Tensor) -> Tensor:
        return self.decode(params, self.encode(params, x))

    def activate(self, params, x, gen=None, train=False):
        return self.encode(params, x)
