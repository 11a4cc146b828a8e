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
over another source's mask.

``RecursiveAutoEncoderLayer`` is the reference's (:70-124,
``RecursiveAutoEncoder.java``'s left fold over tree leaves): over an
item axis ``[B, T, D]`` it merges the running representation with the
next item through the encoder ``W`` ``[2D, D]``, decodes the merge with
``U`` ``[D, 2D]`` and sums each merge's mean squared reconstruction
error.  The fold is a Python loop over T (the reference's ``lax.scan``);
its gradient is autograd's.  It has no random draws, so it plugs into
``MultiLayerNetwork.pretrain`` as the other pretrain layers do.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
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
        return _grads_of(
            lambda p: self.reconstruction_loss(p, draws, x), params)

    def reconstruct(self, params: Params, x: Tensor) -> Tensor:
        return self.decode(params, self.encode(params, x))

    def activate(self, params, x, gen=None, train=False):
        return self.encode(params, x)


def _grads_of(objective, params: Params) -> Tuple[Tensor, Params]:
    """``(value, grads)`` of ``objective(params)`` by autograd, the
    counterpart of ``jax.value_and_grad``; ``params`` are not written."""
    live = {key: p.detach().requires_grad_(True)
            for key, p in params.items()}
    with torch.enable_grad():
        loss = objective(live)
    keys = sorted(live)
    grads = torch.autograd.grad(loss, [live[key] for key in keys])
    return loss.detach(), dict(zip(keys, grads))


@register_layer(LayerKind.RECURSIVE_AUTOENCODER)
class RecursiveAutoEncoderLayer(PretrainLayer):
    """Greedy recursive autoencoder over an item axis (see the module
    docstring)."""

    def init(self, gen: torch.Generator, device: DeviceLike = None) -> Params:
        # encoder [2D -> D], decoder [D -> 2D]
        d = self.conf.n_in
        dev, dtype = resolve_device(device), getattr(torch, self.conf.dtype)
        return {
            "W": P.init_weight(gen, (2 * d, d), self.conf.weight_init,
                               self.conf.dist, dtype).to(dev),
            "b": torch.zeros((d,), dtype=dtype, device=dev),
            "U": P.init_weight(gen, (d, 2 * d), self.conf.weight_init,
                               self.conf.dist, dtype).to(dev),
            "c": torch.zeros((2 * d,), dtype=dtype, device=dev),
        }

    def fold(self, params: Params, xs: Tensor) -> Tuple[Tensor, Tensor]:
        """xs ``[B, T, D]`` -> (root ``[B, D]``, total reconstruction
        loss)."""
        rep = xs[:, 0, :]
        loss = torch.zeros((), dtype=torch.float32, device=xs.device)
        for t in range(1, xs.shape[1]):
            pair = torch.cat([rep, xs[:, t, :]], dim=-1)
            rep = self.activation(pair @ params["W"] + params["b"])
            recon = rep @ params["U"] + params["c"]
            loss = loss + torch.mean((recon - pair) ** 2)
        return rep, loss

    def draw(self, gen: Optional[torch.Generator], x: Tensor) -> None:
        return None

    def pretrain_core(self, params: Params, draws: None, x: Tensor
                      ) -> Tuple[Tensor, Params]:
        return _grads_of(lambda p: self.fold(p, x)[1], params)

    def activate(self, params, x, gen=None, train=False):
        return self.fold(params, x)[0]

    def out_features(self, in_features: int) -> int:
        return self.conf.n_in
