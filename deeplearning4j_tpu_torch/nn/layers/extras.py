"""The embedding and batch-normalization layers.

Port of ``deeplearning4j_tpu/nn/layers/extras.py``.  The batch-norm
layer carries its running statistics in its params as leaves no loss
reads (their gradient is zero); the train step
(``nn/multilayer.MultiLayerNetwork._train_step``) refreshes them from
the training forward's own batch moments, as the reference's (:520-563).

:func:`bn_collective` is the reference's cross-replica context (:27-50):
the data-parallel step (``MultiLayerNetwork``'s DP bundle) runs its
training forward inside it, and every batch-norm layer then normalizes
with the masked moments of the GLOBAL batch: padded rows excluded, the
sums taken in fp32 and summed over the mesh's data axis.
"""

from __future__ import annotations

import contextlib
import threading
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


#: the context the data-parallel step installs around its training
#: forward (thread-local: the forward runs on the caller's thread)
_BN_CTX = threading.local()


@contextlib.contextmanager
def bn_collective(axis, mask: Tensor):
    """Cross-replica batch norm (reference :27-50): inside the context a
    training forward's batch-norm layers normalize with masked GLOBAL
    moments.  ``mask`` ``[rows]`` weights each row (0 for a padded row);
    ``axis`` is None (this process's rows only), a data ``Mesh``,
    ``"data"`` or ``(mesh, name)`` (the sums go through
    ``collectives.psum`` over that axis, differentiably).  Another axis
    named without its mesh has no group and raises."""
    if axis is not None:
        from deeplearning4j_tpu_torch.parallel.collectives import _group
        _group(axis)
    prev = getattr(_BN_CTX, "ctx", None)
    _BN_CTX.ctx = (axis, mask)
    try:
        yield
    finally:
        _BN_CTX.ctx = prev


def _collective_moments(x: Tensor, axis, mask: Tensor):
    """fp32 (mean, biased variance) of the masked rows of ``x`` over the
    data axis, as E[x^2] - E[x]^2 of fp32 sums (the reference's :83-105:
    at bf16 the difference of squares would cancel)."""
    red = tuple(range(x.ndim - 1))
    xf = x.float()
    m = mask.float().reshape(mask.shape + (1,) * (x.ndim - 1))
    spatial = 1.0
    for s in x.shape[1:-1]:
        spatial *= float(s)
    s1 = (xf * m).sum(dim=red)
    s2 = (xf * xf * m).sum(dim=red)
    cnt = mask.float().sum() * spatial
    if axis is not None:
        from deeplearning4j_tpu_torch.parallel.collectives import psum
        s1, s2, cnt = psum((s1, s2, cnt), axis)
    cnt = torch.clamp(cnt, min=1.0)
    mean = s1 / cnt
    return mean, torch.clamp(s2 / cnt - mean * mean, min=0.0)


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
        ctx = getattr(_BN_CTX, "ctx", None) if train else None
        if ctx is not None:
            # normalize in fp32, return in the input's dtype
            mean, var = _collective_moments(x, *ctx)
            xn = ((x.float() - mean) * torch.rsqrt(var + BN_EPS)).to(x.dtype)
            return xn * params["scale"] + params["bias"]
        if train:
            mean, var = batch_moments(x)
        else:
            mean, var = params["running_mean"], params["running_var"]
        xn = (x - mean) / torch.sqrt(var + BN_EPS)
        return xn * params["scale"] + params["bias"]

    def out_features(self, in_features: int) -> int:
        return in_features
