"""Gradient container (``nn/gradient/DefaultGradient.java`` parity).

Port of ``deeplearning4j_tpu/nn/gradient.py``: an ordered name -> tensor
map.  Gradients are dicts shaped like the params; this class exists for
the API and for code that wants them flattened in one order.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import torch

Tensor = torch.Tensor


class Gradient:
    def __init__(self, grads: Optional[Dict[str, Any]] = None):
        self._grads: Dict[str, Any] = dict(grads or {})

    def gradient_for_variable(self, name: str) -> Any:
        return self._grads[name]

    def set_gradient_for(self, name: str, value: Any) -> None:
        self._grads[name] = value

    def gradient(self) -> Tensor:
        """Every tensor flattened into one vector, in the order of
        ``nn.params.pack_params`` (keys sorted), as the reference's
        ``pack_params`` of the dict (DefaultGradient.gradient())."""
        from deeplearning4j_tpu_torch.nn.params import pack_params
        return pack_params(self._grads)

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._grads.items())

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._grads)
