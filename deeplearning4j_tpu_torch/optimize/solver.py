"""Solver — ConvexOptimizer dispatch + implementations.

Port of ``deeplearning4j_tpu/optimize/solver.py``:
- ``Solver`` (optimize/Solver.java:34) dispatches on OptimizationAlgorithm
  (:51-59) to gradient descent, conjugate gradient, L-BFGS, or (for
  HESSIAN_FREE at layer level) conjugate gradient;
- ``BaseOptimizer.optimize`` (optimize/solvers/BaseOptimizer.java:128):
  gradientAndScore -> GradientAdjustment -> BackTrackLineSearch ->
  listeners -> terminations, per iteration.

Each iteration's device work runs through the compile engine
(``runtime/compile_cache.cached_graph``), captured once per signature on
the card, under the reference's labels (``solver.gd_step``,
``solver.linesearch_step``, ``solver.cg_step``, ``solver.lbfgs_step``)
and with no engine key: the objective closes over data, so two solvers
never share an entry.  Gradient descent is one captured step.  The
line-search solvers cannot be one, because a graph cannot run the
search's data-dependent loop (``optimize/line_search.py``): each of
their iterations is three captured functions over one donated work
state (joined by ``share=``, so they update the same buffers):

1. *start*: value and gradient, the direction (CG's Polak-Ribiere beta,
   L-BFGS's two-loop recursion), the slope, the first trial;
2. *trial*: shrink the step and evaluate again, replayed while the
   reference's ``cond`` holds, which the host reads once a trial;
3. *finish*: accept or fall back, the in-step guard, and CG's or
   L-BFGS's state update (L-BFGS's second value and gradient too).

Every trial of one iteration sees the same random draws, as the
reference's per-iteration key (``solver.py:162``): an objective with
randomness (an RBM's Gibbs chain) declares ``draw(gen)``, called once an
iteration on the host, and its functions take the draws as tensors.
Values that change between iterations (the iteration, the step size)
live in device tensors, so a replay never needs a new capture.  The host
reads one score and gradient norm an iteration for the listeners and
terminations, as the reference's ``float(score)`` does.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.configuration import (
    NeuralNetConfiguration, OptimizationAlgorithm)
from deeplearning4j_tpu_torch.nn.params import pack_params, unpack_params
from deeplearning4j_tpu_torch.ops.updaters import (apply_descent, copy_into,
                                                   dl4j_updater, tree_leaves,
                                                   tree_map, tree_unflatten)
from deeplearning4j_tpu_torch.optimize import line_search as ls
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.optimize.terminations import (
    EpsTermination, InvalidScore, TerminationCondition, ZeroDirection)
from deeplearning4j_tpu_torch.runtime import compile_cache, resilience

log = logging.getLogger(__name__)

Tensor = torch.Tensor
Params = Any


def value_and_grad(fn: Callable[..., Tensor]) -> Callable:
    """``jax.value_and_grad`` of ``fn(params, *args)`` for a tree (dicts,
    lists) of tensors: ``(value, grads)``, the grads in ``params``'
    structure (zeros for a leaf the value does not use)."""
    def vag(params, *args):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            value = fn(live, *args)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return value.detach(), tree_unflatten(live, grads)
    return vag


@dataclasses.dataclass
class Objective:
    """What a model hands the solver (Model.gradientAndScore parity).

    value_and_grad(params, draws) -> (score, grads)  [grads = descent direction]
    value(params, draws) -> score                     [for line searches]
    draw(gen) -> draws: the iteration's random tensors, drawn once an
    iteration from the solver's generator (None: a deterministic
    objective, whose functions get ``draws=None``).
    """
    value_and_grad: Callable[[Params, Any], Tuple[Tensor, Params]]
    value: Callable[[Params, Any], Tensor]
    batch_size: int = 1
    draw: Optional[Callable[[Optional[torch.Generator]], Any]] = None


def _sq_norm(tree) -> Tensor:
    """Sum of squares over the leaves of a (dict) tree, keys sorted as
    JAX flattens them."""
    leaves = ([tree[k] for k in sorted(tree)] if isinstance(tree, dict)
              else tree_leaves(tree))
    return sum(torch.sum(g * g) for g in leaves)


class BaseOptimizer:
    """Python loop over captured steps, with listeners + terminations."""

    def __init__(self, conf: NeuralNetConfiguration, objective: Objective,
                 listeners: Sequence[IterationListener] = (),
                 terminations: Optional[Sequence[TerminationCondition]] = None):
        self.conf = conf
        self.objective = objective
        self.listeners = list(listeners)
        self.terminations = (list(terminations) if terminations is not None
                             else [EpsTermination(), ZeroDirection(),
                                   InvalidScore()])
        self.score_history: List[float] = []
        #: evaluations of the line search, per iteration (line-search
        #: solvers only)
        self.trials_history: List[int] = []

    def optimize(self, params: Params,
                 gen: Optional[torch.Generator] = None) -> Params:
        raise NotImplementedError

    def _draws(self, gen: Optional[torch.Generator]):
        draw = self.objective.draw
        return None if draw is None else draw(gen)

    def _notify(self, iteration: int, score: float):
        self.score_history.append(score)
        for ls_ in self.listeners:
            ls_.iteration_done(self, iteration, score)

    def _should_stop(self, new: float, old: float, gnorm: float) -> bool:
        return any(t.terminate(new, old, gnorm) for t in self.terminations)

    @staticmethod
    def _read(score: Tensor, gnorm: Tensor) -> Tuple[float, float]:
        """The iteration's score and gradient norm on the host: one read."""
        s, g = torch.stack([score, gnorm]).tolist()
        return s, g

    @staticmethod
    def _note_skips(skips) -> None:
        """Book guard-skipped solver steps (ONE sync at optimize() end,
        never per iteration); shared impl in runtime/resilience.py."""
        resilience.note_skips(skips, where="solver")


class GradientDescentOptimizer(BaseOptimizer):
    """SGD with the reference's GradientAdjustment chain
    (AdaGrad-or-lr, momentum schedule, L2, unit-norm, ÷batch)."""

    def __init__(self, conf, objective, **kw):
        super().__init__(conf, objective, **kw)
        self.updater = updater = dl4j_updater(
            lr=conf.lr, momentum=conf.momentum,
            momentum_schedule=conf.momentum_after,
            use_adagrad=conf.use_adagrad, l2=conf.l2,
            use_regularization=conf.use_regularization,
            constrain_unit_norm=conf.constrain_gradient_to_unit_norm,
        )

        def step(params, ustate, iteration, draws):
            score, grads = objective.value_and_grad(params, draws)
            with torch.no_grad():
                updates, new_ustate = updater.update(
                    ustate, grads, params, iteration, objective.batch_size)
                # in-step anomaly guard: a non-finite score/gradient drops
                # the update (params AND optimizer state) and raises the
                # skip flag — the same graph on the healthy path
                new_params, new_ustate, skipped = resilience.guard_update(
                    params, ustate, apply_descent(params, updates),
                    new_ustate, (score, grads))
                gnorm = torch.sqrt(_sq_norm(grads))
                copy_into(params, new_params)
                copy_into(ustate, new_ustate)
                iteration.add_(1)
            return params, ustate, iteration, score, gnorm, skipped

        # params, updater state and the device iteration update in place
        # (donated); the engine copies the caller's params in and never
        # writes them
        self._step = compile_cache.cached_graph(
            step, label="solver.gd_step", donate_argnums=(0, 1, 2))

    def optimize(self, params: Params,
                 gen: Optional[torch.Generator] = None) -> Params:
        dev = tree_leaves(params)[0].device
        ustate = self.updater.init(params)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        old_score = float("inf")
        skips = []
        for i in range(self.conf.num_iterations):
            params, ustate, it, score, gnorm, skipped = self._step(
                params, ustate, it, self._draws(gen))
            skips.append(skipped)
            score, gnorm = self._read(score, gnorm)
            self._notify(i, score)
            if self._should_stop(score, old_score, gnorm):
                break
            old_score = score
        self._note_skips(skips)
        # the API boundary: the step's params are the engine's buffers
        return tree_map(torch.clone, params)


def _put(work: Dict[str, Tensor], **vals: Tensor) -> None:
    """Write ``vals`` into the donated work state's buffers."""
    for key, val in vals.items():
        work[key].copy_(val)


class _LineSearchOptimizer(BaseOptimizer):
    """An iteration as three captured functions over one donated work
    state (see the module docstring).  Subclasses give ``LABEL``,
    ``_fields(n, dev)`` (the work state beyond the search's own) and
    ``_functions(template) -> (start, finish)``."""

    LABEL = ""

    def __init__(self, conf, objective, **kw):
        super().__init__(conf, objective, **kw)
        self._fns = None

    def _value(self, template, draws):
        objective = self.objective
        return lambda x: objective.value(unpack_params(x, template), draws)

    def _vag(self, template, flat, draws):
        score, grads = self.objective.value_and_grad(
            unpack_params(flat, template), draws)
        return score, pack_params(grads)

    def _search_start(self, work, template, draws, direction, f0, slope,
                      initial_step):
        """Write the direction and the first trial into ``work``; the
        loop's flag."""
        t, f, it = ls.search_start(self._value(template, draws), work["flat"],
                                   direction, initial_step)
        _put(work, dn=direction, f0=f0, slope=slope, t=t, f=f, it=it)
        return ls.search_continue(f, f0, slope, t, it)

    def _build(self, template):
        start, finish = self._functions(template)

        def trial(work, draws):
            with torch.no_grad():
                t, f, it = ls.search_trial(self._value(template, draws),
                                           work["flat"], work["dn"],
                                           work["t"], work["it"])
                _put(work, t=t, f=f, it=it)
                cont = ls.search_continue(f, work["f0"], work["slope"], t, it)
            return work, cont

        first = compile_cache.cached_graph(start, label=self.LABEL,
                                           donate_argnums=(0,))
        return (first,
                compile_cache.cached_graph(trial, label=self.LABEL,
                                           donate_argnums=(0,), share=first),
                compile_cache.cached_graph(finish, label=self.LABEL,
                                           donate_argnums=(0,), share=first))

    def _work(self, flat: Tensor) -> Dict[str, Tensor]:
        n, dev = flat.numel(), flat.device

        def scalar(dtype=torch.float32):
            return torch.zeros((), dtype=dtype, device=dev)

        work = {"flat": flat, "dn": torch.zeros(n, device=dev),
                "f0": scalar(), "slope": scalar(), "t": scalar(),
                "f": scalar(), "it": scalar(torch.int32), "gnorm": scalar()}
        work.update(self._fields(n, dev))
        return work

    def _fields(self, n: int, dev) -> Dict[str, Tensor]:
        return {}

    def optimize(self, params: Params,
                 gen: Optional[torch.Generator] = None) -> Params:
        template = params
        if self._fns is None:
            self._fns = self._build(template)
        start, trial, finish = self._fns
        work = self._work(pack_params(params))
        old_score = float("inf")
        skips = []
        for i in range(self.conf.num_iterations):
            draws = self._draws(gen)
            work, cont = start(work, draws)
            trials = 1
            while bool(cont):             # one host read a trial
                work, cont = trial(work, draws)
                trials += 1
            work, score, gnorm, skipped = finish(work, draws)
            skips.append(skipped)
            self.trials_history.append(trials)
            score, gnorm = self._read(score, gnorm)
            self._notify(i, score)
            if self._should_stop(score, old_score, gnorm):
                break
            old_score = score
        self._note_skips(skips)
        return tree_map(torch.clone, unpack_params(work["flat"], template))


class LineSearchGradientDescent(_LineSearchOptimizer):
    """GradientAscent.java equivalent (steepest descent + backtracking
    line search each iteration)."""

    LABEL = "solver.linesearch_step"

    def _functions(self, template):
        def start(work, draws):
            score, g = self._vag(template, work["flat"], draws)
            with torch.no_grad():
                d = -g
                slope = torch.dot(g, d)
                work["gnorm"].copy_(torch.linalg.norm(g))
                cont = self._search_start(work, template, draws, d, score,
                                          slope, self.conf.lr)
            return work, cont

        def finish(work, draws):
            with torch.no_grad():
                flat = work["flat"]
                t, f_new = ls.search_result(work["f0"], work["t"], work["f"])
                flat_new = flat + t * work["dn"]
                # guard: a non-finite step result keeps the incoming iterate
                ok = resilience.tree_all_finite((f_new, flat_new))
                flat.copy_(torch.where(ok, flat_new, flat))
            return work, f_new, work["gnorm"].clone(), (~ok).to(torch.int32)

        return start, finish


class ConjugateGradientOptimizer(_LineSearchOptimizer):
    """Polak-Ribiere nonlinear CG with restarts
    (optimize/solvers/ConjugateGradient.java parity)."""

    LABEL = "solver.cg_step"

    def _fields(self, n, dev):
        return {"g_prev": torch.zeros(n, device=dev),
                "d": torch.zeros(n, device=dev),
                "g": torch.zeros(n, device=dev)}

    def _functions(self, template):
        def start(work, draws):
            f0, g = self._vag(template, work["flat"], draws)
            with torch.no_grad():
                g_prev, d = work["g_prev"], work["d"]
                # Polak-Ribiere beta with restart (max(0, .))
                denom = torch.dot(g_prev, g_prev)
                beta = torch.where(
                    denom > 0,
                    torch.clamp(torch.dot(g, g - g_prev) / (denom + 1e-30),
                                min=0.0),
                    0.0)
                d_new = -g + beta * d
                slope = torch.dot(g, d_new)
                # restart to steepest descent if not a descent direction
                d_new = torch.where(slope < 0, d_new, -g)
                slope = torch.minimum(slope, torch.dot(g, d_new))
                _put(work, g=g, gnorm=torch.linalg.norm(g))
                cont = self._search_start(work, template, draws, d_new, f0,
                                          slope, self.conf.lr)
            return work, cont

        def finish(work, draws):
            with torch.no_grad():
                flat, g, d_new = work["flat"], work["g"], work["dn"]
                t, f_new = ls.search_result(work["f0"], work["t"], work["f"])
                flat_new = flat + t * d_new
                # guard: drop the whole CG state transition on
                # non-finites — a NaN gradient would otherwise poison
                # beta/d for every later iteration
                ok = resilience.tree_all_finite((f_new, flat_new, g))
                _put(work, flat=torch.where(ok, flat_new, flat),
                     g_prev=torch.where(ok, g, work["g_prev"]),
                     d=torch.where(ok, d_new, work["d"]))
            return work, f_new, work["gnorm"].clone(), (~ok).to(torch.int32)

        return start, finish


class LBFGSOptimizer(_LineSearchOptimizer):
    """L-BFGS with two-loop recursion (optimize/solvers/LBFGS.java parity).

    History lives in fixed-size device buffers (``[m, n]`` ring buffers,
    newest last); the two-loop recursion is unrolled over the ``m``
    slots with masks for the empty ones, so it has no branch."""

    LABEL = "solver.lbfgs_step"

    def __init__(self, conf, objective, history: int = 10, **kw):
        super().__init__(conf, objective, **kw)
        self.m = history

    def _fields(self, n, dev):
        m = self.m
        return {"S": torch.zeros((m, n), device=dev),
                "Y": torch.zeros((m, n), device=dev),
                "rho": torch.zeros((m,), device=dev),
                "count": torch.zeros((), dtype=torch.int32, device=dev),
                "g": torch.zeros(n, device=dev)}

    def _two_loop(self, g, S, Y, rho, count):
        """Classic two-loop recursion over the ring buffer."""
        m = self.m
        q = g
        alphas = [None] * m
        for i in range(m):
            idx = m - 1 - i  # newest -> oldest
            valid = idx >= (m - count)
            alpha = torch.where(valid, rho[idx] * torch.dot(S[idx], q), 0.0)
            q = q - alpha * Y[idx] * valid.to(torch.float32)
            alphas[idx] = alpha
        # initial Hessian scaling gamma = s·y / y·y of newest pair
        sy = torch.dot(S[m - 1], Y[m - 1])
        yy = torch.dot(Y[m - 1], Y[m - 1])
        gamma = torch.where((count > 0) & (yy > 0), sy / (yy + 1e-30), 1.0)
        r = gamma * q
        for idx in range(m):  # oldest -> newest
            valid = idx >= (m - count)
            beta = torch.where(valid, rho[idx] * torch.dot(Y[idx], r), 0.0)
            r = r + (alphas[idx] - beta) * S[idx] * valid.to(torch.float32)
        return r

    def _functions(self, template):
        m = self.m

        def start(work, draws):
            f0, g = self._vag(template, work["flat"], draws)
            with torch.no_grad():
                d = -self._two_loop(g, work["S"], work["Y"], work["rho"],
                                    work["count"])
                slope = torch.dot(g, d)
                d = torch.where(slope < 0, d, -g)
                slope = torch.minimum(slope, torch.dot(g, d))
                _put(work, g=g, gnorm=torch.linalg.norm(g))
                cont = self._search_start(work, template, draws, d, f0,
                                          slope, 1.0)
            return work, cont

        def finish(work, draws):
            flat, g = work["flat"], work["g"]
            with torch.no_grad():
                t, f_new = ls.search_result(work["f0"], work["t"], work["f"])
                flat_new = flat + t * work["dn"]
            _, g_new = self._vag(template, flat_new, draws)
            with torch.no_grad():
                s, y = flat_new - flat, g_new - g
                sy = torch.dot(s, y)
                # guard BEFORE the ring-buffer append: a non-finite step
                # keeps the incoming iterate and history untouched
                ok = resilience.tree_all_finite((f_new, flat_new, g_new))
                append = (sy > 1e-10) & ok
                S, Y, rho, count = (work["S"], work["Y"], work["rho"],
                                    work["count"])
                _put(work,
                     S=torch.where(append, torch.cat([S[1:], s[None]]), S),
                     Y=torch.where(append, torch.cat([Y[1:], y[None]]), Y),
                     rho=torch.where(append, torch.cat(
                         [rho[1:], (1.0 / (sy + 1e-30))[None]]), rho),
                     count=torch.where(append,
                                       torch.clamp(count + 1, max=m), count),
                     flat=torch.where(ok, flat_new, flat))
            return work, f_new, work["gnorm"].clone(), (~ok).to(torch.int32)

        return start, finish


class Solver:
    """Dispatch on OptimizationAlgorithm (Solver.java:51-59 parity)."""

    _DISPATCH = {
        OptimizationAlgorithm.GRADIENT_DESCENT: GradientDescentOptimizer,
        OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT:
            GradientDescentOptimizer,
        OptimizationAlgorithm.CONJUGATE_GRADIENT: ConjugateGradientOptimizer,
        OptimizationAlgorithm.LBFGS: LBFGSOptimizer,
        # HESSIAN_FREE is provided at the network level (Gauss-Newton
        # vector products need the full model); Solver falls back to CG
        OptimizationAlgorithm.HESSIAN_FREE: ConjugateGradientOptimizer,
    }

    def __init__(self, conf: NeuralNetConfiguration, objective: Objective,
                 listeners: Sequence[IterationListener] = (),
                 terminations: Optional[Sequence[TerminationCondition]] = None):
        cls = self._DISPATCH[conf.optimization_algo]
        self.optimizer: BaseOptimizer = cls(
            conf, objective, listeners=listeners, terminations=terminations)

    def optimize(self, params: Params,
                 gen: Optional[torch.Generator] = None) -> Params:
        return self.optimizer.optimize(params, gen)
