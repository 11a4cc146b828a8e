"""Layer protocol and factory registry.

Port of ``deeplearning4j_tpu/nn/layers/base.py``.  A layer is a
stateless description built from a ``NeuralNetConfiguration``; its
params are a dict of tensors passed in and out, so backprop through a
stack is autograd of the network's loss.

- ``init(gen, device) -> params``;
- ``pre_output(params, x) -> z``, ``x W + b`` computed in the layer's
  ``compute_dtype``, bias included, and returned in fp32 (as the
  reference rounds it, ``base.py:75-81``);
- ``activate(params, x, gen=None, train=False) -> y``: dropout and
  DropConnect draw from ``gen`` when training;
- pretrain layers (:class:`PretrainLayer`, the RBM and the autoencoder)
  add ``pretrain_value_and_grad(params, gen, x) -> (score, grads)`` for
  greedy layer-wise pretraining, in two halves: ``draw(gen, x)`` makes
  the random tensors one evaluation uses (the uniforms behind each
  Bernoulli, the normals behind each Gaussian, a corruption mask) and
  ``pretrain_core(params, draws, x)`` is a pure function of them, so a
  caller can hand over another source's draws (the tests give JAX's,
  rebuilt from its keys).  The grads are the direction to descend on.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Type

import torch

from deeplearning4j_tpu_torch import DeviceLike
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    LayerKind, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.ops import random as dl4j_random
from deeplearning4j_tpu_torch.ops.registry import get_activation

Tensor = torch.Tensor
Params = Dict[str, Tensor]

_LAYER_REGISTRY: Dict[LayerKind, Type["Layer"]] = {}

#: the ROADMAP item that ports each layer kind this package lacks
_NOT_PORTED = {
    LayerKind.RECURSIVE_AUTOENCODER: "A5b",
    LayerKind.LSTM: "A5b",
    LayerKind.EMBEDDING: "A6",
    LayerKind.BATCH_NORM: "A6",
}


def register_layer(kind: LayerKind):
    def deco(cls: Type["Layer"]):
        _LAYER_REGISTRY[kind] = cls
        cls.kind = kind
        return cls
    return deco


def make_layer(conf: NeuralNetConfiguration) -> "Layer":
    """The layer for ``conf.kind``; raises ``NotImplementedError`` for a
    kind the port does not have yet, naming its ROADMAP item."""
    try:
        return _LAYER_REGISTRY[conf.kind](conf)
    except KeyError:
        item = _NOT_PORTED.get(conf.kind)
        if item is None:
            raise ValueError(f"no layer registered for kind {conf.kind}")
        raise NotImplementedError(
            f"layer kind {conf.kind.value!r} is not ported yet (ROADMAP "
            f"{item}); the port has "
            f"{sorted(k.value for k in _LAYER_REGISTRY)}") from None


class Layer:
    """Base layer: affine pre-output, named activation, dropout."""

    kind: LayerKind

    def __init__(self, conf: NeuralNetConfiguration):
        self.conf = conf
        self.activation = get_activation(conf.activation)

    def init(self, gen: torch.Generator, device: DeviceLike = None) -> Params:
        raise NotImplementedError

    def pre_output(self, params: Params, x: Tensor) -> Tensor:
        """``x W + b`` (BaseLayer.preOutput:177) in the compute dtype,
        returned in fp32."""
        cdt = getattr(torch, self.conf.compute_dtype)
        z = x.to(cdt) @ params["W"].to(cdt) + params["b"].to(cdt)
        return z.float()

    def activate(self, params: Params, x: Tensor,
                 gen: Optional[torch.Generator] = None,
                 train: bool = False) -> Tensor:
        if (train and gen is not None and self.conf.drop_connect
                and self.conf.dropout > 0.0):
            # DropConnect: mask the weights, not the activations, with
            # inverted scaling
            keep = 1.0 - self.conf.dropout
            w = params["W"]
            mask = dl4j_random.keep_mask(gen, keep, w.shape, w.device)
            params = dict(params, W=w * mask.to(w.dtype) / keep)
            return self.activation(self.pre_output(params, x))
        y = self.activation(self.pre_output(params, x))
        if train and self.conf.dropout > 0.0 and gen is not None:
            y = dl4j_random.dropout(gen, y, self.conf.dropout)
        return y

    def out_features(self, in_features: int) -> int:
        return self.conf.n_out

    def __repr__(self):
        return (f"{type(self).__name__}(n_in={self.conf.n_in}, "
                f"n_out={self.conf.n_out})")


class PretrainLayer(Layer):
    """A layer trainable unsupervised (RBM/AutoEncoder family)."""

    is_pretrainable = True

    def draw(self, gen: Optional[torch.Generator], x: Tensor) -> Any:
        """The random tensors one evaluation of the pretrain objective on
        ``x`` uses, drawn from ``gen`` on ``x``'s device."""
        raise NotImplementedError

    def pretrain_core(self, params: Params, draws: Any, x: Tensor
                      ) -> Tuple[Tensor, Params]:
        """``(score, grads)`` of the pretrain objective with the given
        draws; the grads are the direction to descend on."""
        raise NotImplementedError

    def pretrain_value_and_grad(self, params: Params,
                                gen: Optional[torch.Generator], x: Tensor
                                ) -> Tuple[Tensor, Params]:
        return self.pretrain_core(params, self.draw(gen, x), x)
