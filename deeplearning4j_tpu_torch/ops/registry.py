"""Named activation registry with derivative dispatch.

Port of ``deeplearning4j_tpu/ops/registry.py``: the same names, each a
pure elementwise ``torch`` function.  A derivative not given in closed
form is derived with autograd from the activation itself, as the
reference derives it with ``jax.grad``.  Each function matches JAX's at
the points where frameworks differ: ``relu``'s gradient at 0 is 0,
``leakyrelu`` takes the identity branch at 0 (``x >= 0``), ``gelu`` is
the tanh approximation (``jax.nn.gelu``'s default, term for term) and ``softplus`` is
``logaddexp(x, 0)`` with no linear cut-off.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_ACTIVATIONS: Dict[str, Callable[[Tensor], Tensor]] = {}
_DERIVATIVES: Dict[str, Callable[[Tensor], Tensor]] = {}


def _autograd_derivative(fn: Callable[[Tensor], Tensor]
                         ) -> Callable[[Tensor], Tensor]:
    """d/dx_i sum(fn(x)) == fn'(x_i) for an elementwise ``fn``."""
    def derivative(x: Tensor) -> Tensor:
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(fn(xg).sum(), xg)
        return g
    return derivative


def register_activation(
    name: str,
    fn: Callable[[Tensor], Tensor],
    derivative: Callable[[Tensor], Tensor] | None = None,
) -> None:
    """Register a named activation; without ``derivative`` it is derived
    with autograd (correct for any elementwise ``fn``)."""
    _ACTIVATIONS[name] = fn
    _DERIVATIVES[name] = derivative or _autograd_derivative(fn)


def get_activation(name: str) -> Callable[[Tensor], Tensor]:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{name}'. Known: {sorted(_ACTIVATIONS)}"
        ) from None


def get_activation_derivative(name: str) -> Callable[[Tensor], Tensor]:
    """The derivative with respect to the pre-activation ``z``."""
    try:
        return _DERIVATIVES[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation derivative '{name}'. Known: "
            f"{sorted(_DERIVATIVES)}") from None


def list_activations() -> list[str]:
    return sorted(_ACTIVATIONS)


def _softmax(x: Tensor) -> Tensor:
    return torch.softmax(x, dim=-1)


def _softmax_derivative(x: Tensor) -> Tensor:
    # the diagonal of the softmax Jacobian, s * (1 - s), as nd4j's
    # SoftMaxDerivative
    s = torch.softmax(x, dim=-1)
    return s * (1.0 - s)


def _gelu(x: Tensor) -> Tensor:
    # jax.nn.gelu(approximate=True) term for term: 1 + tanh(.) cancels
    # for large negative x, so the order of operations shows
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                  * (x + 0.044715 * (x ** 3))))
    return x * cdf


def _softplus(x: Tensor) -> Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


register_activation("sigmoid", torch.sigmoid,
                    lambda z: torch.sigmoid(z) * (1.0 - torch.sigmoid(z)))
register_activation("tanh", torch.tanh, lambda z: 1.0 - torch.tanh(z) ** 2)
register_activation("relu", torch.relu, lambda z: (z > 0).to(z.dtype))
register_activation("leakyrelu", lambda z: torch.where(z >= 0, z, 0.01 * z))
register_activation("softplus", _softplus, torch.sigmoid)
register_activation("linear", lambda z: z, torch.ones_like)
register_activation("identity", lambda z: z, torch.ones_like)
register_activation("exp", torch.exp, torch.exp)
register_activation("hardtanh", lambda z: torch.clamp(z, -1.0, 1.0),
                    lambda z: ((z > -1.0) & (z < 1.0)).to(z.dtype))
register_activation("softmax", _softmax, _softmax_derivative)
register_activation("softsign", F.softsign)
register_activation("gelu", _gelu)
register_activation("silu", F.silu)
register_activation("abs", torch.abs, torch.sign)
register_activation("round", torch.round, torch.zeros_like)
register_activation("sqrt", torch.sqrt)
register_activation("maxout", torch.relu)  # the reference's "maxout" without pieces
