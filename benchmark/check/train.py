"""The comparison that decides ``correct`` in a training cell.

The program's first three steps, as the window's own call made them
from the benchmark's weights and batches, against the plain reference
(``benchmark/reference``) following the same three steps in float32
with TF32 off:

- ``loss``: the largest relative gap of a step's loss;
- ``grad``: the first gradient as the optimizer got it (its first
  moment after one step over 1 - b1), by the worst leaf: the gap
  between the program's norm and the reference's, over the larger of
  the reference's norm of that leaf and of the median leaf;
- ``change``: the parameters' change after three steps, by the worst
  leaf, measured the same way.  Leaves whose reference gradient is
  under a thousandth of the median leaf's are left out: their true
  gradient is nought (a key bias under softmax, an unused table), and
  Adam moves them by round-off alone;
- ``grad_dir``: ``grad`` with each side's leaf norms first divided by
  that side's whole gradient norm, so a scale common to every leaf (the
  bfloat16 rounding of the loss's 1 / count, which moves with the count
  of predicted positions and which Adam divides out) does not count,
  while a gradient of the wrong shape does; ``grad_scale``, that common
  scale: the program's whole norm over the reference's, less 1;
- ``loss_first``, ``grad_median``, ``change_median``: the first step's
  loss gap and the median leaf's gaps, steadier from seed to seed where
  the worst leaf is one small leaf's rounding.

A cell's workload file gives each number its limit; a number whose
limit is null is printed and not compared.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

from benchmark.families import weights
from benchmark.reference import transformer as ref
from benchmark.reference.adamw import AdamW

#: leaves under this share of the median leaf's reference gradient
#: norm are left out of the change
DEAD_LEAF = 1e-3


def reference_steps(fam, params0, batches: Sequence, opt_conf: Dict,
                    eps: float, mm, row_block: int) -> Dict:
    """Three (or ``len(batches)``) AdamW steps of the plain reference from
    ``params0``: ``{"losses", "grads" (the first step's, by leaf name),
    "params" (after the last step)}``; the batch is taken ``row_block``
    rows at a time, its gradient summed."""
    tree = weights.clone(params0)
    names = [n for n, _ in weights.flat_leaves(tree)]
    leaves = [t.requires_grad_(True) for _, t in weights.flat_leaves(tree)]
    opt = AdamW(leaves, opt_conf["learning_rate"], opt_conf["weight_decay"],
                opt_conf.get("b1", 0.9), opt_conf.get("b2", 0.999),
                opt_conf.get("eps", 1e-8))
    losses: List[float] = []
    first = None
    with ref.exact_fp32():
        for k, batch in enumerate(batches):
            count = fam.targets(batch)
            grads = [torch.zeros_like(p) for p in leaves]
            total = 0.0
            for r in range(0, fam.n_rows(batch), row_block):
                loss = fam.reference_loss_sum(
                    tree, batch, slice(r, r + row_block), eps, mm) / count
                gs = torch.autograd.grad(loss, leaves, allow_unused=True)
                for acc, g in zip(grads, gs):
                    if g is not None:
                        acc.add_(g)
                total += float(loss.detach())
                del loss, gs
            losses.append(total)
            if k == 0:
                first = {n: g.clone() for n, g in zip(names, grads)}
            opt.step(leaves, grads)
            del grads
    params = {n: p.detach() for n, p in zip(names, leaves)}
    return {"losses": losses, "grads": first, "params": params}


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in
            tree.items()}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    """``|got_l - want_l| / max(want_l, median want)`` for each of
    ``leaves``."""
    med = statistics.median(want[n] for n in leaves)
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30)
            for n in leaves}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   leaves: Sequence[str]) -> Dict:
    """The largest of :func:`leaf_gaps`, and its leaf."""
    gaps = leaf_gaps(got, want, leaves)
    at = max(gaps, key=gaps.get)
    return {"value": gaps[at], "leaf": at}


def median_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                    leaves: Sequence[str]) -> Dict:
    """The median of :func:`leaf_gaps`: steady from seed to seed where
    one small leaf's rounding sets the worst."""
    return {"value": statistics.median(
        leaf_gaps(got, want, leaves).values())}


def _whole(norms: Dict[str, float]) -> float:
    return sum(v * v for v in norms.values()) ** 0.5


def _shares(norms: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's norm over the whole gradient's (0 for a gradient of
    nothing but zeros)."""
    whole = _whole(norms)
    return {n: (v / whole if whole > 0 else 0.0) for n, v in norms.items()}


def compare(prog: Dict, refr: Dict, params0: Dict[str, torch.Tensor]
            ) -> Dict[str, Dict]:
    """The numbers, each ``{"value", ...}``.  ``prog`` and
    ``refr`` hold ``losses`` (per step), ``grads`` (first step, by leaf
    name) and ``params`` (after the last step), both as flat name ->
    tensor maps."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    refr["losses"]))
    g_ref = _norms(refr["grads"])
    g_prog = _norms(prog["grads"])
    names = list(g_ref)
    med = statistics.median(g_ref.values())
    live = [n for n in names if g_ref[n] >= DEAD_LEAF * med]
    d_ref = _norms({n: refr["params"][n] - params0[n] for n in names})
    d_prog = _norms({n: prog["params"][n] - params0[n] for n in names})
    first = abs(prog["losses"][0] - refr["losses"][0]) / abs(
        refr["losses"][0])
    return {"loss": {"value": loss}, "loss_first": {"value": first},
            "grad": worst_leaf_gap(g_prog, g_ref, names),
            "grad_median": median_leaf_gap(g_prog, g_ref, names),
            "grad_dir": worst_leaf_gap(_shares(g_prog), _shares(g_ref),
                                       names),
            "grad_scale": {"value": _whole(g_prog) / _whole(g_ref) - 1.0},
            "change": worst_leaf_gap(d_prog, d_ref, live),
            "change_median": median_leaf_gap(d_prog, d_ref, live),
            "_dead_leaves": [n for n in names if n not in live]}
