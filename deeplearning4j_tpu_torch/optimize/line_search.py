"""Backtracking line search — parity with ``BackTrackLineSearch.java``.

Port of ``deeplearning4j_tpu/optimize/line_search.py``.  The reference
runs the whole search as a ``lax.while_loop`` inside its jitted solver
step.  A CUDA graph cannot branch on the device (a replay takes the
branch of its capture), so the port splits the search into pieces that
each run inside a captured step with no branch, and the host decides
whether to go on:

- :func:`search_start`: the first trial at ``initial_step``;
- :func:`search_trial`: shrink the step and evaluate again;
- :func:`search_continue`: the reference's ``cond`` (:40-43) as a 0-d
  bool tensor, read on the host once a trial;
- :func:`search_result`: the ``f_new <= f0`` fallback (:54-56).

So a search evaluates exactly the trials the reference's loop does, one
host read a trial, and never the trials it would not.
:func:`backtrack_line_search` composes the pieces on the host; the
solvers (``optimize/solver.py``) put them into their captured start,
trial and finish functions.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

Tensor = torch.Tensor

#: the reference's defaults (line_search.py:27-30)
C1, SHRINK, MAX_STEPS, MIN_STEP = 1e-4, 0.5, 16, 1e-10


def search_start(value_fn: Callable[[Tensor], Tensor], x: Tensor,
                 direction: Tensor, initial_step: float = 1.0
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """The first trial: ``(step, f, it)`` with step = initial_step as an
    fp32 0-d tensor, f = value_fn(x + step d), it = 0 (int32)."""
    step = torch.full((), initial_step, dtype=torch.float32, device=x.device)
    f = value_fn(x + step * direction)
    return step, f, torch.zeros((), dtype=torch.int32, device=x.device)


def search_trial(value_fn: Callable[[Tensor], Tensor], x: Tensor,
                 direction: Tensor, step: Tensor, it: Tensor,
                 shrink: float = SHRINK) -> Tuple[Tensor, Tensor, Tensor]:
    """One more trial (the loop's body, :45-49): the step shrunk, its
    value, the trial count + 1."""
    step = step * shrink
    return step, value_fn(x + step * direction), it + 1


def search_continue(f: Tensor, f0: Tensor, slope: Tensor, step: Tensor,
                    it: Tensor, c1: float = C1, max_steps: int = MAX_STEPS,
                    min_step: float = MIN_STEP) -> Tensor:
    """Whether the loop takes another trial: no sufficient decrease yet,
    trials left and the step above ``min_step`` (:40-43)."""
    insufficient = f > f0 + c1 * step * slope
    return insufficient & (it < max_steps) & (step > min_step)


def search_result(f0: Tensor, step: Tensor, f: Tensor
                  ) -> Tuple[Tensor, Tensor]:
    """``(step, f_new)``; a zero step and ``f0`` when even the last
    trial increased the loss (:54-56)."""
    ok = f <= f0
    return torch.where(ok, step, 0.0), torch.where(ok, f, f0)


def backtrack_line_search(
    value_fn: Callable[[Tensor], Tensor],
    x: Tensor,
    direction: Tensor,
    f0: Tensor,
    slope: Tensor,
    initial_step: float = 1.0,
    c1: float = C1,
    shrink: float = SHRINK,
    max_steps: int = MAX_STEPS,
    min_step: float = MIN_STEP,
) -> Tuple[Tensor, Tensor, int]:
    """Armijo backtracking along ``direction`` from flat params ``x``.

    value_fn: flat params -> scalar loss.  slope: g0 · direction (should
    be negative for a descent direction).  Returns ``(step, f_new,
    trials)``: the reference's pair and the number of evaluations, which
    the host loop knows and the reference's while_loop does not report.
    If no sufficient decrease is found the step decays to ~min_step,
    which callers treat as "keep old params"."""
    step, f, it = search_start(value_fn, x, direction, initial_step)
    trials = 1
    while bool(search_continue(f, f0, slope, step, it, c1, max_steps,
                               min_step)):
        step, f, it = search_trial(value_fn, x, direction, step, it, shrink)
        trials += 1
    step, f_new = search_result(f0, step, f)
    return step, f_new, trials
