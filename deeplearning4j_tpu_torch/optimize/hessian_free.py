"""Stochastic Hessian-free optimization (Martens 2010).

Port of ``deeplearning4j_tpu/optimize/hessian_free.py``
(``optimize/solvers/StochasticHessianFree.java:42``, with the
Gauss-Newton machinery of ``MultiLayerNetwork.backPropGradient2:856`` /
``getBackPropRGradient:678`` and the CG pieces ``conjGradient:87`` /
``cgBackTrack:184``).

The Gauss-Newton vector product Gv = Jᵀ·H_L·J·v is three autodiff
primitives, as in the reference: ``torch.func.jvp`` through the network
for J·v, a jvp of the convex loss head's gradient for H_L·(J·v), and
``torch.func.vjp`` back through the network.  Every op of the dense
stacks and output heads this runs on has a forward-mode rule, so no
double-vjp stand-in is needed.  The structure the paper (and the
reference) care about is kept:

- CG on the damped system (G + λI)x = -g, warm-started from the previous
  step's solution scaled by ``x0_decay``;
- CG-backtracking: intermediate CG iterates are recorded and the
  OBJECTIVE (not the quadratic model) picks the best one;
- Levenberg-Marquardt damping adaptation from the reduction ratio ρ.

The CG loop runs on the host, as the reference's: one host read a CG
iteration, of pᵀAp and the new rᵀr together (the step from a pᵀAp <= 0
is computed and dropped, where the reference stops before taking it).
``value``, ``value_and_grad`` and the damped product each go through the
compile engine (captured once per shape on the card), λ as a 0-d tensor
so its adaptation needs no new capture.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.ops.updaters import tree_leaves, tree_map
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.optimize.solver import value_and_grad
from deeplearning4j_tpu_torch.runtime import compile_cache

log = logging.getLogger(__name__)

Tensor = torch.Tensor
Params = Any


def _tadd(a, b):
    return tree_map(torch.add, a, b)


def _tscale(a, s):
    return tree_map(lambda x: x * s, a)


def _tdot(a, b) -> Tensor:
    return sum(torch.sum(x * y) for x, y in
               zip(tree_leaves(a), tree_leaves(b)))


@dataclasses.dataclass
class GNObjective:
    """A model factored as convex-loss-of-logits, which is what makes the
    Gauss-Newton matrix PSD (Schraudolph 2002).

    logits_fn(params) -> logits        (the network)
    loss_from_logits(logits) -> scalar (convex head, labels closed over)
    """
    logits_fn: Callable[[Params], Tensor]
    loss_from_logits: Callable[[Tensor], Tensor]

    def value(self, params: Params) -> Tensor:
        return self.loss_from_logits(self.logits_fn(params))

    def value_and_grad(self, params: Params) -> Tuple[Tensor, Params]:
        return value_and_grad(self.value)(params)

    def gnvp(self, params: Params, v: Params) -> Params:
        """Gauss-Newton vector product Jᵀ·H_L·J·v."""
        logits, jv = torch.func.jvp(self.logits_fn, (params,), (v,))
        grad_head = torch.func.grad(self.loss_from_logits)
        _, h_jv = torch.func.jvp(grad_head, (logits,), (jv,))
        _, vjp = torch.func.vjp(self.logits_fn, params)
        (gv,) = vjp(h_jv)
        return gv


class StochasticHessianFree:
    """HF driver: per iteration, one gradient + one CG solve + backtrack.

    Not a per-parameter-scaled method like the GradientDescent path, so it
    plugs into MultiLayerNetwork at the whole-network level (the reference
    does the same: HF lives in finetune, not per-layer pretrain).
    """

    def __init__(self, objective: GNObjective, num_iterations: int = 10,
                 max_cg_iters: int = 50, initial_lambda: float = 1.0,
                 x0_decay: float = 0.95, backtrack_every: int = 5,
                 cg_tol: float = 1e-10,
                 listeners: Sequence[IterationListener] = ()):
        self.obj = objective
        self.num_iterations = num_iterations
        self.max_cg_iters = max_cg_iters
        self.lam = initial_lambda
        self.x0_decay = x0_decay
        self.backtrack_every = max(backtrack_every, 1)
        self.cg_tol = cg_tol
        self.listeners = list(listeners)
        self.score_history: List[float] = []
        #: λ before each outer iteration's CG solve, and the CG
        #: iterations each solve ran
        self.lambda_history: List[float] = []
        self.cg_iterations: List[int] = []

        # through the compile engine for the compile counters; no
        # donation — params/iterates are re-read across the CG solve —
        # and no cross-instance key (the objective closes over the data)
        self._value = compile_cache.cached_graph(
            objective.value, label="hf.value")
        self._value_and_grad = compile_cache.cached_graph(
            objective.value_and_grad, label="hf.value_and_grad")
        # λ enters as a 0-d tensor so adaptation needs no new capture
        self._damped_mv = compile_cache.cached_graph(
            lambda p, v, lam: _tadd(objective.gnvp(p, v), _tscale(v, lam)),
            label="hf.damped_mv")

    def _lam(self, lam: float, like: Params) -> Tensor:
        return torch.tensor(lam, dtype=torch.float32,
                            device=tree_leaves(like)[0].device)

    # -- CG with iterate recording (conjGradient:87 parity) ----------------
    def _cg(self, params: Params, b: Params, x0: Params, lam: float
            ) -> List[Params]:
        lam_t = self._lam(lam, params)
        x = x0
        r = _tadd(b, _tscale(self._damped_mv(params, x, lam_t), -1.0))
        p = r
        rs = _tdot(r, r)
        iterates: List[Params] = []
        n = 0
        for i in range(self.max_cg_iters):
            n = i + 1
            ap = self._damped_mv(params, p, lam_t)
            pap = _tdot(p, ap)
            alpha = rs / pap
            x_new = _tadd(x, _tscale(p, alpha))
            r_new = _tadd(r, _tscale(ap, -alpha))
            rs_new = _tdot(r_new, r_new)
            # one host read an iteration, for both tests
            pap_h, rs_new_h = torch.stack([pap, rs_new]).tolist()
            if pap_h <= 0:     # numerical loss of PSD; stop trusting CG
                break
            x, r = x_new, r_new
            if (i + 1) % self.backtrack_every == 0 or rs_new_h < self.cg_tol:
                iterates.append(x)
            if rs_new_h < self.cg_tol:
                break
            p = _tadd(r, _tscale(p, rs_new / rs))
            rs = rs_new
        self.cg_iterations.append(n)
        if not iterates:
            iterates.append(x)
        return iterates

    # -- outer loop --------------------------------------------------------
    def optimize(self, params: Params) -> Params:
        prev_x: Optional[Params] = None
        old_score = float("inf")
        for it in range(self.num_iterations):
            score, grad = self._value_and_grad(params)
            score = float(score)
            b = _tscale(grad, -1.0)
            x0 = (_tscale(prev_x, self.x0_decay) if prev_x is not None
                  else _tscale(grad, 0.0))
            self.lambda_history.append(self.lam)
            iterates = self._cg(params, b, x0, self.lam)

            # cgBackTrack: walk iterates from the LAST (largest quadratic
            # decrease) backwards; take the first that beats the current
            # objective, preferring later iterates on ties.
            best_x, best_val = None, score
            for x in reversed(iterates):
                val = float(self._value(_tadd(params, x)))
                if val < best_val:
                    best_x, best_val = x, val
                    break

            if best_x is not None:
                # LM damping from the reduction ratio on the FULL step
                x_full = iterates[-1]
                q = float(_tdot(grad, x_full)
                          + 0.5 * _tdot(x_full, self._damped_mv(
                              params, x_full, self._lam(0.0, params))))
                rho = (best_val - score) / q if q < 0 else 0.0
                if rho > 0.75:
                    self.lam *= 2.0 / 3.0
                elif rho < 0.25:
                    self.lam *= 1.5
                params = _tadd(params, best_x)
                prev_x = best_x
                new_score = best_val
            else:
                # no CG iterate improved: damp harder, keep params
                self.lam *= 1.5
                prev_x = None
                new_score = score

            self.score_history.append(new_score)
            for ls in self.listeners:
                ls.iteration_done(self, it, new_score)
            if abs(old_score - new_score) < 1e-12:
                break
            old_score = new_score
        return params
