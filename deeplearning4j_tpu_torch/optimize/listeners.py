"""Iteration listeners — parity with ``optimize/listeners/`` +
``optimize/api/IterationListener.java``.

Port of ``deeplearning4j_tpu/optimize/listeners.py``, unchanged: a fit
calls ``on_fit_start`` once and ``iteration_done(model, step, score)``
after each step (the staged ``fit_backprop`` path replays them from the
per-step scores once its steps have run)."""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, List, Sequence

log = logging.getLogger(__name__)


class IterationListener:
    """Invoked after every optimizer iteration
    (BaseOptimizer.optimize:179-180 parity)."""

    def iteration_done(self, model: Any, iteration: int, score: float) -> None:
        raise NotImplementedError

    def on_fit_start(self, model: Any) -> None:
        """Called once at every fit entry (``fit_backprop`` /
        ``fit_iterator`` / ``pretrain`` / ``ResilientFit.fit``) BEFORE
        any step runs — stateful listeners reset per-fit state here
        (e.g. ``MetricsListener``'s step timer, which would otherwise
        label the first step of a second fit with the inter-fit wall
        gap).  Default: no-op."""


class ScoreIterationListener(IterationListener):
    """Logs the score every N iterations
    (optimize/listeners/ScoreIterationListener.java)."""

    def __init__(self, print_iterations: int = 10,
                 sink: Callable[[str], None] | None = None):
        self.print_iterations = max(1, print_iterations)
        self.sink = sink or (lambda msg: log.info(msg))

    def iteration_done(self, model, iteration, score):
        if iteration % self.print_iterations == 0:
            self.sink(f"Score at iteration {iteration} is {score}")


class ComposableIterationListener(IterationListener):
    """Fan-out to child listeners (ComposableIterationListener parity)."""

    def __init__(self, listeners: Sequence[IterationListener]):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration, score):
        for ls in self.listeners:
            ls.iteration_done(model, iteration, score)

    def on_fit_start(self, model):
        for ls in self.listeners:
            ls.on_fit_start(model)


class CollectScoresListener(IterationListener):
    """Records (iteration, score) pairs — handy for tests/benchmarks."""

    def __init__(self):
        self.scores: List[tuple[int, float]] = []

    def iteration_done(self, model, iteration, score):
        self.scores.append((iteration, float(score)))


class TimingListener(IterationListener):
    """Per-iteration wall-clock timing (the reference has no profiler; this
    is part of the observability upgrade budgeted in SURVEY.md §5.1)."""

    def __init__(self):
        self.durations: List[float] = []
        self._last = time.perf_counter()

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        self.durations.append(now - self._last)
        self._last = now
