"""Optimization of the port (counterpart of ``deeplearning4j_tpu/optimize``):
the iteration listeners.  The solver, line search, terminations and
Hessian-free are not ported yet (ROADMAP A5)."""

from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    IterationListener, ScoreIterationListener, ComposableIterationListener,
    CollectScoresListener, TimingListener,
)
