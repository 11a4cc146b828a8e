"""Convolution and subsampling layers.

Port of ``deeplearning4j_tpu/nn/layers/convolution.py``.  The public
layout stays the reference's: activations NHWC ``[B, H, W, C]``, filters
HWIO ``[kh, kw, Cin, Cout]``.  ``x.permute(0, 3, 1, 2)`` of a contiguous
NHWC tensor is already an NCHW view in channels-last memory, the layout
cuDNN prefers on Hopper, so the conv runs on that view and its result
is permuted back; pooling works on NHWC windows.  ``flatten`` after them
then orders features H, W, C, as the reference's dense weights expect.

Rounding follows the reference (``convolution.py:44-50``): the conv
runs with both operands in ``compute_dtype`` and its output rounded to
that dtype, then it is cast to fp32 and the fp32 bias added.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import DeviceLike
from deeplearning4j_tpu_torch.nn import params as P
from deeplearning4j_tpu_torch.nn.conf.configuration import LayerKind
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.ops import random as dl4j_random

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim as (before, after):
    the output has ceil(size / stride) positions and an odd total pad
    puts its extra row or column after (bottom, right)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(x: Tensor, w: Tensor, stride: Sequence[int],
                padding: str) -> Tensor:
    """``lax.conv_general_dilated(x, w, stride, padding, ("NHWC", "HWIO",
    "NHWC"))`` through ``F.conv2d``, in ``x``'s dtype."""
    sh, sw = stride
    kh, kw = w.shape[0], w.shape[1]
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    if padding == "VALID":
        pad = (0, 0)
    elif padding == "SAME":
        (top, bottom) = same_padding(x.shape[1], kh, sh)
        (left, right) = same_padding(x.shape[2], kw, sw)
        if (top, left) == (bottom, right):
            pad = (top, left)
        else:
            # F.conv2d pads symmetrically only: pad the input itself
            xc = F.pad(xc, (left, right, top, bottom))
            pad = (0, 0)
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    return F.conv2d(xc, wc, stride=(sh, sw), padding=pad).permute(0, 2, 3, 1)


@register_layer(LayerKind.CONVOLUTION)
class ConvolutionLayer(Layer):
    """2-D convolution, NHWC ``[B, H, W, C]`` -> ``[B, H', W', n_filters]``."""

    def init(self, gen: torch.Generator, device: DeviceLike = None) -> Params:
        return P.convolution_params(gen, self.conf, device)

    def pre_output(self, params: Params, x: Tensor) -> Tensor:
        cdt = getattr(torch, self.conf.compute_dtype)
        y = conv2d_nhwc(x.to(cdt), params["W"].to(cdt), self.conf.stride,
                        self.conf.padding)
        return y.float() + params["b"].float()

    def activate(self, params, x, gen=None, train=False):
        y = self.activation(self.pre_output(params, x))
        if train and self.conf.dropout > 0.0 and gen is not None:
            y = dl4j_random.dropout(gen, y, self.conf.dropout)
        return y

    def out_features(self, in_features: int) -> int:
        return self.conf.n_filters


def pool_windows(x: Tensor, ph: int, pw: int) -> Tensor:
    """NHWC ``x`` -> ``[B, H // ph, W // pw, C, ph * pw]``: each ``VALID``
    window (stride = window) with its entries in row-major order."""
    B, H, W, C = x.shape
    Ho, Wo = H // ph, W // pw
    xw = x[:, :Ho * ph, :Wo * pw, :].reshape(B, Ho, ph, Wo, pw, C)
    return xw.permute(0, 1, 3, 5, 2, 4).reshape(B, Ho, Wo, C, ph * pw)


@register_layer(LayerKind.SUBSAMPLING)
class SubsamplingLayer(Layer):
    """Max or average pooling, ``VALID`` with the window as its stride.

    Max pooling sends a window's gradient to its first largest entry in
    row-major order, as XLA's ``select_and_scatter`` (the reference's
    ``reduce_window`` gradient) does, on every device:
    ``torch.max(dim=...)`` returns the first maximal index.
    ``F.max_pool2d``'s CUDA kernel broke ties otherwise (LeNet's first
    pooling on an H100), and ties are common after relu on images with
    flat regions."""

    def init(self, gen: torch.Generator, device: DeviceLike = None) -> Params:
        return {}

    def activate(self, params, x, gen=None, train=False):
        ph, pw = self.conf.pool_size
        windows = pool_windows(x, ph, pw)
        if self.conf.pool_type == "max":
            return windows.max(dim=-1).values
        if self.conf.pool_type == "avg":
            # the window's sum over ph * pw, as the reference divides
            return windows.sum(dim=-1) / (ph * pw)
        raise ValueError(f"unknown pool_type {self.conf.pool_type}")

    def out_features(self, in_features: int) -> int:
        return in_features
