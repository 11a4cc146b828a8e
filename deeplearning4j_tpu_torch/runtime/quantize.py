"""Post-training weight quantization for serving: per-channel int8 and
bf16.

Port of ``deeplearning4j_tpu/runtime/quantize.py``: the same modes, grid
and leaf rules, over the port's parameter trees (nested dicts, lists
and tuples of tensors).

- ``quantize_tree(params, "int8")`` maps each >= 2-D floating leaf to a
  :class:`QTensor`: int8 values at the leaf's shape and fp32 scales, one
  per last-axis channel (per (stack, channel) for stacked >= 3-D leaves,
  so the layers of a ``blocks`` tree never share a range).  1-D leaves
  and bias or normalization leaves, by their tree names (``b*``,
  ``*_b``, ``*_g``, ``*ln*``, ``*norm*``, ``*bias*``, gamma/beta), stay
  as they are: the stacked ``[L, H]`` gains would otherwise share one
  scale across layers and a small layer would round to zeros.
- ``"bf16"`` casts each >= 2-D floating leaf to bfloat16; ``None``
  passes the tree through.
- ``dequantize_tree`` is the inverse.  The JAX package calls it inside a
  jitted forward, where the multiply fuses into the consuming products;
  the port runs eagerly, so a serving engine dequantizes the tree once
  per dispatch, an extra pass over the weights.

``quant_specs`` (the sharded layout of a quantized tree) comes with the
parallel slice.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

Tensor = torch.Tensor

#: quantization modes the serving engines accept
MODES = (None, "int8", "bf16")

#: symmetric int8 grid: values land on [-127, 127] (-128 unused, so the
#: grid is symmetric and dequantization needs no zero point)
QMAX = 127.0

#: floor for per-channel scales: an all-zero channel must not divide by
#: zero (its quantized values are zero either way)
SCALE_EPS = 1e-12


class QTensor(NamedTuple):
    """One quantized weight: ``q`` int8 at the leaf's shape, ``scale``
    fp32 per channel, ``(C,)`` for 2-D leaves and ``(d0, C)`` for
    stacked >= 3-D leaves (the first axis is the stack)."""
    q: Tensor
    scale: Tensor


def check_mode(mode: Optional[str]) -> Optional[str]:
    if mode not in MODES:
        raise ValueError(f"quantize mode must be one of {MODES}: {mode!r}")
    return mode


def _quantizable(leaf: Any) -> bool:
    return (isinstance(leaf, Tensor) and leaf.ndim >= 2
            and leaf.dtype.is_floating_point)


def _skip_int8_name(name: str) -> bool:
    """Bias and normalization leaves, by their conventional tree names,
    stay out of int8 (see the module docstring)."""
    n = name.lower()
    return (n.startswith("b") or n.endswith("_b") or n.endswith("_g")
            or "ln" in n or "norm" in n or "bias" in n
            or n in ("gamma", "beta", "g"))


def _scale_axes(ndim: int):
    """The axes the per-channel amax reduces: all but the last (channel)
    axis and, for stacked >= 3-D leaves, the first (stack) axis."""
    keep = {ndim - 1} if ndim == 2 else {0, ndim - 1}
    return tuple(a for a in range(ndim) if a not in keep)


def _scale_bshape(ndim: int, scale: Tensor):
    """The shape that broadcasts a reduced scale against its leaf."""
    if ndim == 2:
        return (1, scale.shape[-1])
    return (scale.shape[0],) + (1,) * (ndim - 2) + (scale.shape[-1],)


def quantize_leaf(w: Tensor) -> QTensor:
    """Symmetric per-channel int8: ``scale = amax / 127`` per channel,
    ``q = round(w / scale)`` (half to even, as ``jnp.round``) clipped to
    the grid.  The round trip is off by at most ``scale / 2``."""
    w32 = w.float()
    amax = w32.abs().amax(dim=_scale_axes(w32.ndim))
    scale = torch.clamp(amax, min=SCALE_EPS) / QMAX
    sb = scale.reshape(_scale_bshape(w32.ndim, scale))
    q = torch.clamp(torch.round(w32 / sb), -QMAX, QMAX).to(torch.int8)
    return QTensor(q, scale)


def dequantize_leaf(qt: QTensor, dtype: torch.dtype = torch.float32
                    ) -> Tensor:
    """Inverse of :func:`quantize_leaf`: ``q * scale`` in fp32, then
    ``dtype``."""
    sb = qt.scale.reshape(_scale_bshape(qt.q.ndim, qt.scale))
    return (qt.q.float() * sb).to(dtype)


def _map_named(fn: Callable[[str, Any], Any], tree: Any,
               name: str = "") -> Any:
    """``fn(name, leaf)`` over a tree of dicts, lists and tuples, where
    ``name`` is the innermost dict key on the leaf's path (as the JAX
    module's ``_leaf_name``).  A :class:`QTensor` is a leaf."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, QTensor):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def quantize_tree(params: Any, mode: Optional[str]) -> Any:
    """Post-training quantization of a params tree: ``None`` returns it,
    ``"bf16"`` casts >= 2-D floating leaves, ``"int8"`` maps them to
    :class:`QTensor`, except bias and normalization leaves by name (bf16
    keeps those too; its range covers them)."""
    check_mode(mode)
    if mode is None:
        return params

    def f(name, w):
        if not _quantizable(w):
            return w
        if mode == "bf16":
            return w.to(torch.bfloat16)
        if _skip_int8_name(name):
            return w
        return quantize_leaf(w)

    return _map_named(f, params)


def dequantize_tree(tree: Any, dtype: torch.dtype = torch.float32) -> Any:
    """:class:`QTensor` leaves back to ``dtype``; every other leaf
    (bf16-cast ones too: the models cast to their compute dtype) passes
    through."""
    return _map_named(
        lambda _, x: dequantize_leaf(x, dtype) if isinstance(x, QTensor)
        else x, tree)


class QuantMemo:
    """A one-shot transform memoized on the source tree's identity: it
    holds the source and compares with ``is``, so a weight swap always
    recomputes and a recycled ``id()`` never serves stale weights."""

    __slots__ = ("_src", "_out")

    def __init__(self):
        self._src = None
        self._out = None

    def get(self, tree: Any, transform: Callable[[Any], Any]) -> Any:
        if self._out is None or self._src is not tree:
            self._out = transform(tree)
            self._src = tree
        return self._out


class ServedParams:
    """The tree a serving engine dispatches with: ``params`` (a tree or
    a zero-arg callable returning one) through ``transform`` (quantize,
    cast; None passes through), under ``no_grad`` (not
    ``inference_mode``: the compile engine skips the copy of a read-only
    tensor whose version has not moved, and an inference tensor has no
    version).  A static
    tree is transformed once and the raw reference dropped; a
    callable's trees are transformed again only when it returns a new
    tree object (:class:`QuantMemo`).  ``get(params)`` serves an
    explicit tree or callable instead, through the same memo."""

    __slots__ = ("_params", "_transform", "_static_done", "_memo")

    def __init__(self, params: Any,
                 transform: Optional[Callable[[Any], Any]] = None):
        self._params = params
        self._transform = transform
        self._static_done = transform is None
        self._memo = QuantMemo()

    def get(self, params: Any = None) -> Any:
        if params is None and not callable(self._params):
            if not self._static_done and self._params is not None:
                with torch.no_grad():
                    self._params = self._transform(self._params)
                self._static_done = True
            return self._params
        p = self._params if params is None else params
        if callable(p):
            p = p()
        if self._transform is None or p is None:
            return p
        with torch.no_grad():
            return self._memo.get(p, self._transform)


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor leaf (a QTensor counts payload and
    scales)."""
    total = [0]

    def add(_, x):
        if isinstance(x, QTensor):
            total[0] += sum(t.numel() * t.element_size() for t in x)
        elif isinstance(x, Tensor):
            total[0] += x.numel() * x.element_size()
        return x

    _map_named(add, tree)
    return total[0]
