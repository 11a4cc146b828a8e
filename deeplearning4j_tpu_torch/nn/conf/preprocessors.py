"""Input/output pre-processors at layer boundaries.

Port of ``deeplearning4j_tpu/nn/conf/preprocessors.py``: each
preprocessor is a function ``(x, gen=None) -> x`` built from a JSON spec
``{"name": ..., **kwargs}``, so ``MultiLayerConfiguration`` stays
serializable.  A stochastic one draws from the ``torch.Generator`` it is
given and is the identity without one (the evaluation path).  Shapes
are NHWC, as in the reference: ``flatten`` of an image ``[B, H, W, C]``
orders its features H, W, C.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

Tensor = torch.Tensor
PreProcessor = Callable[[Tensor, Optional[torch.Generator]], Tensor]

_REGISTRY: Dict[str, Callable[..., PreProcessor]] = {}


def register_preprocessor(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def make_preprocessor(spec: Dict[str, Any]) -> PreProcessor:
    spec = dict(spec)
    name = spec.pop("name")
    try:
        return _REGISTRY[name](**spec)
    except KeyError:
        raise ValueError(f"unknown preprocessor '{name}'; known "
                         f"{sorted(_REGISTRY)}") from None


@register_preprocessor("reshape")
def _reshape(shape) -> PreProcessor:
    shape = tuple(shape)

    def fn(x, gen=None):
        return x.reshape((x.shape[0],) + shape)
    return fn


@register_preprocessor("flatten")
def _flatten() -> PreProcessor:
    def fn(x, gen=None):
        return x.reshape(x.shape[0], -1)
    return fn


@register_preprocessor("binomial_sampling")
def _binomial() -> PreProcessor:
    """BinomialSamplingPreProcessor: sample Bernoulli(x)."""
    def fn(x, gen=None):
        if gen is None:
            return x
        return torch.bernoulli(torch.clamp(x, 0.0, 1.0), generator=gen)
    return fn


@register_preprocessor("unit_variance")
def _unit_variance() -> PreProcessor:
    def fn(x, gen=None):
        return x / (torch.std(x, dim=-1, correction=0, keepdim=True) + 1e-8)
    return fn


@register_preprocessor("zero_mean_unit_variance")
def _zero_mean_unit_variance() -> PreProcessor:
    def fn(x, gen=None):
        mu = torch.mean(x, dim=-1, keepdim=True)
        sd = torch.std(x, dim=-1, correction=0, keepdim=True) + 1e-8
        return (x - mu) / sd
    return fn


@register_preprocessor("zero_mean")
def _zero_mean() -> PreProcessor:
    def fn(x, gen=None):
        return x - torch.mean(x, dim=-1, keepdim=True)
    return fn


@register_preprocessor("convolution_input")
def _convolution_input(rows: int, cols: int,
                       channels: int = 1) -> PreProcessor:
    """ConvolutionInputPreProcessor: ``[B, rows*cols*ch]`` -> NHWC."""
    def fn(x, gen=None):
        return x.reshape(x.shape[0], rows, cols, channels)
    return fn


@register_preprocessor("composable")
def _composable(specs) -> PreProcessor:
    fns = [make_preprocessor(s) for s in specs]

    def fn(x, gen=None):
        for f in fns:
            x = f(x, gen)
        return x
    return fn
