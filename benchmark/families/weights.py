"""Seeded weights made on the device in one draw.

A family lists its leaves as ``(group, name, shape, kind)``; one
``torch.randn`` from a ``torch.Generator`` on the device fills a flat
buffer for all of them, and each leaf is a view of it: matrices and
biases at standard deviation ``std`` (the embedding tables at
``embed_std``), LayerNorm gains at 1 + ``std`` n, so that no bias or
gain sits at a value that would hide its own omission.  A cell's
workload file sets both (``"weights"``).  Values are
rounded to bfloat16, the type the products are served in, and kept as
float32, so the program's casts are exact and both sides read the same
numbers.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, str, Tuple[int, ...], str]


def make(leaves: List[Leaf], seed: int, device, std: float = 0.02,
         embed_std: float = None) -> Dict[str, Dict[str, torch.Tensor]]:
    total = sum(math.prod(shape) for _, _, shape, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    at = 0
    for group, name, shape, kind in leaves:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        at += n
        table = group == "embed" and kind == "matrix"
        leaf.mul_(embed_std if table and embed_std is not None else std)
        if kind == "gain":
            leaf.add_(1.0)
        tree.setdefault(group, {})[name] = leaf
    flat.copy_(flat.to(torch.bfloat16).float())
    return tree


def clone(tree):
    return {g: {n: t.detach().clone() for n, t in leaves.items()}
            for g, leaves in tree.items()}


def flat_leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    return [(f"{g}/{n}", t) for g, leaves in tree.items()
            for n, t in leaves.items()]
