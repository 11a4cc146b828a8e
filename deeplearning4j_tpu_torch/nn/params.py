"""Parameter initialization and packing.

Port of ``deeplearning4j_tpu/nn/params.py``.  A layer's params are a
dict of fp32 tensors in the reference's layouts: a dense ``W`` is
``[in, out]``, a conv ``W`` is HWIO ``[kh, kw, Cin, Cout]``, each ``b``
is ``[out]``.  The layouts are kept so that a JAX param tree carries
across as a plain copy (:func:`params_from_numpy`) and a flat vector
(:func:`pack_params`) moves between the packages unchanged; the conv
layer permutes at the call.

Draws come from a CPU ``torch.Generator`` and the tensors are then
moved to the device, so a seed gives the same weights on every device
(not the reference's: threefry and Philox never agree).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    NeuralNetConfiguration, WeightInit)

Tensor = torch.Tensor
Params = Dict[str, Tensor]

# Canonical parameter keys (DefaultParamInitializer.W_KEY / B_KEY, and
# PretrainParamInitializer's visible bias).
W_KEY = "W"
B_KEY = "b"
VISIBLE_BIAS_KEY = "vb"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_weight(gen: torch.Generator, shape: Sequence[int],
                scheme: WeightInit,
                dist: Tuple[str, float, float] = ("normal", 0.0, 0.01),
                dtype: torch.dtype = torch.float32) -> Tensor:
    """One weight tensor under a named scheme, drawn on the CPU.

    fan_in / fan_out are the last two dims (``[in, out]``), except for
    an HWIO conv filter, where fan_in = Cin kh kw and fan_out =
    Cout kh kw.
    """
    shape = tuple(shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    fan_out = shape[-1]
    if len(shape) == 4:  # HWIO conv filter
        receptive = shape[0] * shape[1]
        fan_in, fan_out = shape[2] * receptive, shape[3] * receptive

    def uniform(lo, hi):
        return torch.empty(shape, dtype=dtype).uniform_(lo, hi,
                                                        generator=gen)

    def normal():
        return torch.randn(shape, generator=gen, dtype=dtype)

    if scheme is WeightInit.ZERO:
        return torch.zeros(shape, dtype=dtype)
    if scheme is WeightInit.UNIFORM:
        a = 1.0 / max(fan_in, 1)
        return uniform(-a, a)
    if scheme in (WeightInit.VI, WeightInit.XAVIER):
        # Glorot: uniform within +/- sqrt(6 / (fan_in + fan_out))
        a = math.sqrt(6.0 / max(fan_in + fan_out, 1))
        return uniform(-a, a)
    if scheme is WeightInit.SIZE:
        return math.sqrt(2.0 / max(fan_in + fan_out, 1)) * normal()
    if scheme is WeightInit.NORMALIZED:
        return uniform(-0.5, 0.5) / max(fan_in, 1)
    if scheme is WeightInit.DISTRIBUTION:
        name, p0, p1 = dist
        if name == "normal":
            return p0 + p1 * normal()
        if name == "uniform":
            return uniform(p0, p1)
        raise ValueError(f"unknown distribution '{name}'")
    if scheme is WeightInit.HE:
        return math.sqrt(2.0 / max(fan_in, 1)) * normal()
    if scheme is WeightInit.LECUN:
        return math.sqrt(1.0 / max(fan_in, 1)) * normal()
    raise ValueError(f"unknown WeightInit {scheme}")


def default_params(gen: torch.Generator, conf: NeuralNetConfiguration,
                   device: DeviceLike = None) -> Params:
    """DefaultParamInitializer: W ``[n_in, n_out]`` + b ``[n_out]``."""
    dev, dtype = resolve_device(device), _dtype(conf.dtype)
    return {
        W_KEY: init_weight(gen, (conf.n_in, conf.n_out), conf.weight_init,
                           conf.dist, dtype).to(dev),
        B_KEY: torch.zeros((conf.n_out,), dtype=dtype, device=dev),
    }


def pretrain_params(gen: torch.Generator, conf: NeuralNetConfiguration,
                    device: DeviceLike = None) -> Params:
    """PretrainParamInitializer: adds the visible bias ``vb`` ``[n_in]``
    for the RBM and the autoencoder."""
    p = default_params(gen, conf, device)
    p[VISIBLE_BIAS_KEY] = torch.zeros((conf.n_in,), dtype=_dtype(conf.dtype),
                                      device=p[W_KEY].device)
    return p


def convolution_params(gen: torch.Generator, conf: NeuralNetConfiguration,
                       device: DeviceLike = None) -> Params:
    """ConvolutionParamInitializer: HWIO filter + per-filter bias."""
    dev, dtype = resolve_device(device), _dtype(conf.dtype)
    kh, kw = conf.kernel_size
    return {
        W_KEY: init_weight(gen, (kh, kw, conf.n_channels, conf.n_filters),
                           conf.weight_init, conf.dist, dtype).to(dev),
        B_KEY: torch.zeros((conf.n_filters,), dtype=dtype, device=dev),
    }


def _layers(params) -> List[Params]:
    """A network's list of layer dicts, or one layer's dict as a list of
    one (the solver packs a single layer: ``finetune``'s output layer,
    ``pretrain``'s layer ``i``)."""
    return [params] if isinstance(params, Mapping) else list(params)


def param_leaves(params) -> List[Tensor]:
    """The reference's ``jax.tree.leaves`` order: layers in order, each
    dict's keys sorted (``W`` before ``b`` before ``vb``); a subsampling
    layer's empty dict gives none.  ``params`` is a list of layer dicts
    or one layer's dict."""
    return [layer[key] for layer in _layers(params) for key in sorted(layer)]


def num_params(params) -> int:
    return sum(int(p.numel()) for p in param_leaves(params))


def pack_params(params) -> Tensor:
    """All leaves flattened into one vector, in :func:`param_leaves`
    order (``MultiLayerNetwork.pack``, MultiLayerNetwork.java:773)."""
    leaves = param_leaves(params)
    if not leaves:
        return torch.zeros((0,))
    return torch.cat([p.reshape(-1) for p in leaves])


def unpack_params(flat: Tensor, like):
    """Inverse of :func:`pack_params` on ``like``'s structure, shapes,
    dtypes and device (``unPack:817``): a list of layer dicts, or one
    dict.  The leaves are views of ``flat`` where no conversion is
    needed."""
    total = num_params(like)
    if flat.numel() != total:
        raise ValueError(f"flat vector holds {flat.numel()} values, the "
                         f"network {total}")
    out, i = [], 0
    for layer in _layers(like):
        new = {}
        for key in sorted(layer):
            leaf = layer[key]
            n = leaf.numel()
            new[key] = flat[i:i + n].reshape(leaf.shape).to(
                device=leaf.device, dtype=leaf.dtype)
            i += n
        out.append(new)
    return out[0] if isinstance(like, Mapping) else out


def params_from_numpy(tree: Sequence[Mapping[str, Any]],
                      device: DeviceLike = None) -> List[Params]:
    """A JAX ``MultiLayerNetwork``'s params as numpy (``jax.tree.map(
    np.asarray, net.params)``, or ``runtime.checkpoint.load_numpy_tree``
    with its ``"0"``, ``"1"``, ... keys in order) -> the port's, on
    ``device``.  The layouts are the same, so this is a copy of every
    key, the RBM's and autoencoder's visible bias ``vb`` included."""
    dev = resolve_device(device)
    return [{key: torch.tensor(np.asarray(val), device=dev)
             for key, val in layer.items()} for layer in tree]
