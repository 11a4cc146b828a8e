"""The embedding and batch-normalization layers.

Port of ``deeplearning4j_tpu/nn/layers/extras.py``.  The batch-norm
layer carries its running statistics in its params as leaves no loss
reads (their gradient is zero); the train step
(``nn/multilayer.MultiLayerNetwork._train_step``) refreshes them from
the training forward's own batch moments, as the reference's (:520-563).

:func:`bn_collective`, the reference's cross-replica context for the
data-parallel step, comes with that step (ROADMAP A7).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nn import params as P
from deeplearning4j_tpu_torch.nn.conf.configuration import LayerKind
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer

Tensor = torch.Tensor
Params = Dict[str, Tensor]

#: the variance floor of the normalization (extras.py:111)
BN_EPS = 1e-5


def bn_collective(axis_name, mask):
    """Cross-replica batch norm (reference :26-50) belongs to the
    data-parallel train step, which is ROADMAP A7."""
    raise NotImplementedError(
        "bn_collective (cross-replica batch norm for the data-parallel "
        "step) is not ported to the PyTorch package yet (ROADMAP A7)")


def batch_moments(x: Tensor):
    """(mean, biased variance) of ``x`` over every axis but the last, in
    ``x``'s dtype, as ``jnp.mean`` / ``jnp.var`` (the variance is the
    mean of the squared deviations)."""
    dims = tuple(range(x.ndim - 1))
    mean = x.mean(dim=dims)
    return mean, ((x - mean) ** 2).mean(dim=dims)


@register_layer(LayerKind.EMBEDDING)
class EmbeddingLayer(Layer):
    """Token-id lookup: ``[B, ...]`` ids -> ``[B, ..., n_out]`` rows of
    ``W`` ``[n_in, n_out]`` (:53-64)."""

    def init(self, gen: torch.Generator, device: DeviceLike = None):
        dev = resolve_device(device)
        w = P.init_weight(gen, (self.conf.n_in, self.conf.n_out),
                          self.conf.weight_init, self.conf.dist,
                          getattr(torch, self.conf.dtype))
        return {P.W_KEY: w.to(dev)}

    def activate(self, params: Params, x: Tensor,
                 gen: Optional[torch.Generator] = None,
                 train: bool = False) -> Tensor:
        return params[P.W_KEY][x.long()]


@register_layer(LayerKind.BATCH_NORM)
class BatchNormLayer(Layer):
    """Batch normalization over the last axis (:66-122), in the input's
    dtype: biased batch moments in training, the running statistics at
    inference; then ``* scale + bias``."""

    def init(self, gen: torch.Generator, device: DeviceLike = None):
        dev = resolve_device(device)
        n = self.conf.n_out or self.conf.n_in

        def full(v):
            return torch.full((n,), v, dtype=torch.float32, device=dev)

        return {"scale": full(1.0), "bias": full(0.0),
                "running_mean": full(0.0), "running_var": full(1.0)}

    def activate(self, params: Params, x: Tensor,
                 gen: Optional[torch.Generator] = None,
                 train: bool = False) -> Tensor:
        if train:
            mean, var = batch_moments(x)
        else:
            mean, var = params["running_mean"], params["running_var"]
        xn = (x - mean) / torch.sqrt(var + BN_EPS)
        return xn * params["scale"] + params["bias"]

    def out_features(self, in_features: int) -> int:
        return in_features
