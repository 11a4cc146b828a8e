"""Output layer: the classifier head and its loss.

Port of ``deeplearning4j_tpu/nn/layers/output.py``.  The loss is a
function of the pre-activation logits: the pairs (softmax, mcxent or
negativeloglikelihood) and (sigmoid, xent) take the fused stable forms
(``output.py:34-60``); any other pair scores the activated output.  L2
is not added here: ``dl4j_updater`` applies it once.
"""

from __future__ import annotations

from typing import Dict

import torch

from deeplearning4j_tpu_torch import DeviceLike
from deeplearning4j_tpu_torch.nn import params as P
from deeplearning4j_tpu_torch.nn.conf.configuration import LayerKind
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.ops import losses as L

Tensor = torch.Tensor
Params = Dict[str, Tensor]

_SOFTMAX_PAIR = (L.LossFunction.MCXENT, L.LossFunction.NEGATIVELOGLIKELIHOOD)


@register_layer(LayerKind.OUTPUT)
class OutputLayer(Layer):
    def init(self, gen: torch.Generator, device: DeviceLike = None) -> Params:
        return P.default_params(gen, self.conf, device)

    def per_example_loss_from_logits(self, z: Tensor,
                                     labels: Tensor) -> Tensor:
        """Unreduced ``[B]`` row losses of the logits ``z``."""
        lf = L.LossFunction(self.conf.loss_function)
        act = self.conf.activation
        if act == "softmax" and lf in _SOFTMAX_PAIR:
            return L.per_example_softmax_cross_entropy_with_logits(labels, z)
        if act == "sigmoid" and lf is L.LossFunction.XENT:
            return L.per_example_sigmoid_binary_cross_entropy_with_logits(
                labels, z)
        return L.per_example_score(labels, lf, self.activation(z))

    def loss_from_logits(self, z: Tensor, labels: Tensor) -> Tensor:
        """The mean of :meth:`per_example_loss_from_logits`."""
        lf = L.LossFunction(self.conf.loss_function)
        act = self.conf.activation
        if act == "softmax" and lf in _SOFTMAX_PAIR:
            return L.softmax_cross_entropy_with_logits(labels, z)
        if act == "sigmoid" and lf is L.LossFunction.XENT:
            return L.sigmoid_binary_cross_entropy_with_logits(labels, z)
        return L.score(labels, lf, self.activation(z))

    def per_example_loss(self, params: Params, x: Tensor,
                         labels: Tensor) -> Tensor:
        return self.per_example_loss_from_logits(self.pre_output(params, x),
                                                 labels)

    def loss(self, params: Params, x: Tensor, labels: Tensor) -> Tensor:
        """Score on (input, labels) (OutputLayer.java:68-92)."""
        return self.loss_from_logits(self.pre_output(params, x), labels)
