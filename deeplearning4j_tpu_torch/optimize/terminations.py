"""Termination conditions — parity with ``optimize/terminations/``.

A copy of ``deeplearning4j_tpu/optimize/terminations.py``: the solvers
read each iteration's score and gradient norm on the host and hand them
over as Python floats.
"""

from __future__ import annotations

import math


class TerminationCondition:
    def terminate(self, new_score: float, old_score: float,
                  grad_norm: float) -> bool:
        raise NotImplementedError


class EpsTermination(TerminationCondition):
    """|new - old| < eps * |old| + tolerance (EpsTermination.java parity)."""

    def __init__(self, eps: float = 1e-5, tolerance: float = 1e-8):
        self.eps, self.tolerance = eps, tolerance

    def terminate(self, new_score, old_score, grad_norm):
        if not math.isfinite(old_score):
            return False  # first iteration: no previous score yet
        return abs(new_score - old_score) <= \
            self.eps * abs(old_score) + self.tolerance


class ZeroDirection(TerminationCondition):
    """Gradient direction vanished."""

    def terminate(self, new_score, old_score, grad_norm):
        return grad_norm == 0.0


class Norm2Termination(TerminationCondition):
    """Gradient L2 norm below threshold (Norm2Termination.java parity)."""

    def __init__(self, gradient_tolerance: float = 1e-6):
        self.gradient_tolerance = gradient_tolerance

    def terminate(self, new_score, old_score, grad_norm):
        return grad_norm < self.gradient_tolerance


class InvalidScore(TerminationCondition):
    """Stop on NaN/inf scores (guards divergence in line-search-free SGD)."""

    def terminate(self, new_score, old_score, grad_norm):
        return not math.isfinite(new_score)
