"""Optimization of the port (counterpart of ``deeplearning4j_tpu/optimize``).

``Solver`` dispatches on ``OptimizationAlgorithm`` (Solver.java:51-59) to
gradient descent, conjugate gradient or L-BFGS (``optimize/solver.py``);
listeners and termination conditions hook the iteration loop like
``BaseOptimizer.optimize`` (BaseOptimizer.java:128).  Each iteration's
device work is captured once and replayed (``runtime/compile_cache``);
the Python loop sequences iterations, calls listeners and checks the
terminations on the host.  Hessian-free is ``optimize/hessian_free.py``.
"""

from deeplearning4j_tpu_torch.optimize.solver import Solver, Objective  # noqa: F401
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    IterationListener, ScoreIterationListener, ComposableIterationListener,
    CollectScoresListener, TimingListener,
)
from deeplearning4j_tpu_torch.optimize.terminations import (  # noqa: F401
    EpsTermination, Norm2Termination, ZeroDirection,
)
