"""Restricted Boltzmann Machine with CD-k — the reference's workhorse
pretraining unit.

Port of ``deeplearning4j_tpu/nn/layers/rbm.py`` (``RBM.java:66``):
visible/hidden unit kinds (BINARY/GAUSSIAN/SOFTMAX/RECTIFIED/LINEAR),
``contrastiveDivergence:105``, ``gradient:114`` (positive and negative
phase over the Gibbs chain ``gibbhVh:269``), ``propUp:321`` /
``propDown:354``, ``sampleHiddenGivenVisible:220``.

The reference's chain is a ``lax.scan`` over k Gibbs steps; here it is a
Python loop over the static ``k``, which a captured step unrolls.  The
CD gradient is the explicit estimator (v0ᵀh0 − vkᵀhk): it is not the
gradient of any scalar loss, matching the reference; the reported score
is the mean squared reconstruction error.

Random draws: :meth:`RBMLayer.draw` makes the chain's noise (uniforms
behind each binary unit's Bernoulli, standard normals behind each
Gaussian or rectified unit, nothing for softmax or linear units) and
:meth:`RBMLayer.pretrain_core` is a pure function of it.  The draws are
``(h0, [v_1 .. v_k], [h_1 .. h_k])``, in the order of the reference's
keys: ``key_h0, key_chain = split(key)``, ``split(key_chain, k)``, and
each step's key split into its visible and hidden keys (:106-116).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch import DeviceLike
from deeplearning4j_tpu_torch.nn import params as P
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    HiddenUnit, LayerKind, VisibleUnit)
from deeplearning4j_tpu_torch.nn.layers.base import (PretrainLayer,
                                                     register_layer)
from deeplearning4j_tpu_torch.ops.random import (bernoulli_sample,
                                                 gaussian_sample)

Tensor = torch.Tensor
Params = Dict[str, Tensor]
Draws = Tuple[Optional[Tensor], List[Optional[Tensor]],
              List[Optional[Tensor]]]

#: the noise behind a unit kind's sample (none: the sample is the mean)
_NOISE = {"binary": "uniform", "gaussian": "normal", "rectified": "normal"}


def _noise(unit, gen, shape, device) -> Optional[Tensor]:
    kind = _NOISE.get(unit.value)
    if kind == "uniform":
        return torch.rand(shape, generator=gen, device=device)
    if kind == "normal":
        return torch.randn(shape, generator=gen, device=device)
    return None


@register_layer(LayerKind.RBM)
class RBMLayer(PretrainLayer):
    def init(self, gen: torch.Generator, device: DeviceLike = None) -> Params:
        return P.pretrain_params(gen, self.conf, device)

    # -- propagation (propUp:321 / propDown:354) ---------------------------
    def prop_up(self, params: Params, v: Tensor) -> Tensor:
        """P(h|v) mean under the hidden-unit type."""
        z = v @ params["W"] + params["b"]
        h = self.conf.hidden_unit
        if h is HiddenUnit.BINARY:
            return torch.sigmoid(z)
        if h is HiddenUnit.RECTIFIED:
            return torch.relu(z)
        if h is HiddenUnit.GAUSSIAN:
            return z
        if h is HiddenUnit.SOFTMAX:
            return torch.softmax(z, dim=-1)
        raise ValueError(h)

    def prop_down(self, params: Params, h: Tensor) -> Tensor:
        """P(v|h) mean under the visible-unit type."""
        z = h @ params["W"].T + params["vb"]
        v = self.conf.visible_unit
        if v is VisibleUnit.BINARY:
            return torch.sigmoid(z)
        if v in (VisibleUnit.GAUSSIAN, VisibleUnit.LINEAR):
            return z
        if v is VisibleUnit.SOFTMAX:
            return torch.softmax(z, dim=-1)
        raise ValueError(v)

    def sample_h_given_v(self, params: Params, v: Tensor,
                         noise: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        """(mean, sample) — sampleHiddenGivenVisible:220; ``noise`` is
        this sample's draw (see the module docstring)."""
        mean = self.prop_up(params, v)
        h = self.conf.hidden_unit
        if h is HiddenUnit.BINARY:
            sample = bernoulli_sample(None, mean, u=noise)
        elif h is HiddenUnit.GAUSSIAN:
            sample = gaussian_sample(None, mean, z=noise)
        elif h is HiddenUnit.RECTIFIED:
            # NReLU: max(0, z + N(0, sigmoid(z))), as in Nair & Hinton
            sample = torch.relu(gaussian_sample(
                None, mean, torch.sqrt(torch.sigmoid(mean)), z=noise))
        else:  # SOFTMAX: the mean (the reference uses the probabilities)
            sample = mean
        return mean, sample

    def sample_v_given_h(self, params: Params, h: Tensor,
                         noise: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        mean = self.prop_down(params, h)
        v = self.conf.visible_unit
        if v is VisibleUnit.BINARY:
            sample = bernoulli_sample(None, mean, u=noise)
        elif v is VisibleUnit.GAUSSIAN:
            sample = gaussian_sample(None, mean, z=noise)
        else:
            sample = mean
        return mean, sample

    # -- draws -------------------------------------------------------------
    def draw(self, gen: Optional[torch.Generator], x: Tensor) -> Draws:
        """The noise of one CD-k chain on the batch ``x``."""
        k = max(int(self.conf.k), 1)
        n, dev = x.shape[0], x.device
        hs, vs = (n, self.conf.n_out), (n, self.conf.n_in)
        h_unit, v_unit = self.conf.hidden_unit, self.conf.visible_unit
        h0 = _noise(h_unit, gen, hs, dev)
        v_noise, h_noise = [], []
        for _ in range(k):
            v_noise.append(_noise(v_unit, gen, vs, dev))
            h_noise.append(_noise(h_unit, gen, hs, dev))
        return h0, v_noise, h_noise

    # -- CD-k (contrastiveDivergence:105 / gradient:114) -------------------
    def contrastive_divergence(self, params: Params, draws: Draws,
                               v0: Tensor) -> Tuple[Tensor, Params]:
        """Returns (reconstruction-error score, CD-k ASCENT gradients)."""
        k = max(int(self.conf.k), 1)
        h0_noise, v_noise, h_noise = draws
        h0_mean, h_sample = self.sample_h_given_v(params, v0, h0_noise)
        for s in range(k):
            vk_mean, vk_sample = self.sample_v_given_h(params, h_sample,
                                                       v_noise[s])
            hk_mean, h_sample = self.sample_h_given_v(params, vk_sample,
                                                      h_noise[s])
        n = v0.shape[0]
        # positive phase uses mean activations (RBM.gradient:114)
        w_grad = (v0.T @ h0_mean - vk_sample.T @ hk_mean) / n
        hb_grad = torch.mean(h0_mean - hk_mean, dim=0)
        vb_grad = torch.mean(v0 - vk_sample, dim=0)
        if self.conf.sparsity > 0.0:
            # sparsity target: push mean hidden activation toward `sparsity`
            hb_grad = hb_grad + self.conf.sparsity - torch.mean(h0_mean, dim=0)
        score = torch.mean((v0 - vk_mean) ** 2)
        return score, {"W": w_grad, "b": hb_grad, "vb": vb_grad}

    def pretrain_core(self, params: Params, draws: Draws, x: Tensor
                      ) -> Tuple[Tensor, Params]:
        with torch.no_grad():
            score, ascent = self.contrastive_divergence(params, draws, x)
        # Solver convention: gradients to DESCEND on; CD maximizes log-lik.
        return score, {key: -g for key, g in ascent.items()}

    def reconstruct(self, params: Params, v: Tensor) -> Tensor:
        return self.prop_down(params, self.prop_up(params, v))

    # activate = prop_up mean (hidden representation feeds the next layer)
    def activate(self, params, x, gen=None, train=False):
        return self.prop_up(params, x)
