"""Dense (fully connected) layer: ``z = x W + b``, a named activation,
optional dropout (port of ``deeplearning4j_tpu/nn/layers/dense.py``)."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch import DeviceLike
from deeplearning4j_tpu_torch.nn import params as P
from deeplearning4j_tpu_torch.nn.conf.configuration import LayerKind
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@register_layer(LayerKind.DENSE)
class DenseLayer(Layer):
    def init(self, gen: torch.Generator, device: DeviceLike = None):
        return P.default_params(gen, self.conf, device)
