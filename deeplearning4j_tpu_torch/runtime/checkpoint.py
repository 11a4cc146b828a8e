"""Numpy-only reader for the JAX package's checkpoint format.

Counterpart of ``deeplearning4j_tpu/runtime/checkpoint.py``: reads what
``save_pytree`` (:112-186) writes, so weights trained or initialised in
JAX carry over to the port without JAX.  The format:

- ``<path>`` is an ``.npz`` whose arrays are named ``a0 .. aN`` in the
  tree's flatten order;
- ``<path>.json`` holds ``"paths"``, each leaf's tree path joined with
  ``"/"`` (``_SEP``, :41), in the same order, and ``"meta"``.

Writing, managers and sharded checkpoints are not ported yet.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

_SEP = "/"


def load_numpy_tree(path: str) -> Dict[str, Any]:
    """The tree saved at ``path`` as nested dicts of ``np.ndarray`` keyed
    by path segment (sequence indices stay string keys, as in
    ``load_pytree`` without a template)."""
    with open(path + ".json") as f:
        paths = json.load(f)["paths"]
    root: Dict[str, Any] = {}
    with np.load(path) as data:
        if len(data.files) != len(paths):
            raise ValueError(f"{path} holds {len(data.files)} arrays but "
                             f"its sidecar names {len(paths)} paths")
        for i, p in enumerate(paths):
            node = root
            parts = p.split(_SEP)
            for seg in parts[:-1]:
                node = node.setdefault(seg, {})
            node[parts[-1]] = data[f"a{i}"]
    return root
