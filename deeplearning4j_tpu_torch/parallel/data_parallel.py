"""Data-parallel trainers over a mesh's data axis.

Port of ``deeplearning4j_tpu/parallel/data_parallel.py``: the reference's
two sync strategies, one process a rank on ``torch.distributed``:

1. :class:`DataParallelTrainer`, gradient sharing: each step computes
   the gradients of this rank's rows and averages them over the data
   axis (``collectives.grad_share``) before the update, the
   IterativeReduce equivalence.  Its step comes from
   ``parallel/sharded_fit``, as the ``MultiLayerNetwork`` bundle's: a
   captured step, replayed over staged batches by ``fit``.
2. :class:`ParameterAveragingTrainer`, Spark's ``fitDataSet``
   semantics: each rank trains its own replica for ``local_steps`` on
   its rows from the shared params, then the params are averaged
   (``collectives.param_average``) after every round, or once at the
   end with ``average_each_round=False``.

Both take ``loss_fn(params, x, y, gen) -> scalar`` (``gen``: a
``torch.Generator`` on the device, for dropout or sampling) and a
``dl4j_updater``, and every rank passes the same GLOBAL batches: a rank
trains on its contiguous row block (``mesh.shard_rows``).  ``key`` is an
int seed (the counterpart of a JAX key): rank r's generator is seeded
``fold(key, r)``.  The guard's verdict follows the collective in the
gradient-sharing step (every rank skips together) and is per replica in
the averaging trainer (a bad batch drops only that replica's local
update, and the average mixes the healthy replicas back in).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Tuple

import torch

from deeplearning4j_tpu_torch.ops.updaters import (Dl4jUpdater,
                                                   apply_descent, copy_into,
                                                   tree_map)
from deeplearning4j_tpu_torch.optimize.solver import value_and_grad
from deeplearning4j_tpu_torch.parallel import collectives, sharded_fit
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                    check_mesh_axes,
                                                    local_batch_size,
                                                    shard_rows)
from deeplearning4j_tpu_torch.runtime import compile_cache, resilience
from deeplearning4j_tpu_torch.runtime.metrics import dp_metrics

Tensor = torch.Tensor
PyTree = Any
LossFn = Callable[[PyTree, Tensor, Tensor, torch.Generator], Tensor]


def _note_skips(skips) -> int:
    return resilience.note_skips(skips, where="data-parallel")


def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


class _Trainer:
    """What both trainers share: the mesh, its device and the rank's
    generator and row block."""

    def __init__(self, mesh):
        check_mesh_axes(mesh)
        self.mesh = mesh
        self.device = mesh.device

    def _gen(self, key: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            resilience.fold(key, self.mesh.rank))

    def _rows(self, a, axis: int = 0) -> Tensor:
        t = torch.as_tensor(a)
        if t.dtype == torch.float64:
            t = t.float()
        return shard_rows(t, self.mesh, axis).to(self.device)


class DataParallelTrainer(_Trainer):
    """Synchronous gradient-sharing data parallelism (grads averaged
    over the data axis every step)."""

    def __init__(self, loss_fn: LossFn, updater: Dl4jUpdater, mesh,
                 donate: bool = True):
        super().__init__(mesh)
        self.loss_fn = loss_fn
        self.updater = updater
        self.donate = donate
        vag = value_and_grad(loss_fn)

        def shard_step(params, ustate, batch, gen, it):
            x, y = batch
            score, grads = vag(params, x, y, gen)
            grads = collectives.grad_share(grads, mesh)
            score = collectives.pmean(score, mesh)
            updates, new_ustate = updater.update(ustate, grads, params, it, 1)
            # the guard after the collective: one rank's non-finite
            # gradient poisons every rank's mean, so all skip together
            new_params, new_ustate, skipped = resilience.guard_update(
                params, ustate, apply_descent(params, updates), new_ustate,
                (score, grads), agree=sharded_fit.agree_over_mesh(mesh))
            return new_params, new_ustate, score, skipped

        self._step = sharded_fit.build_sharded_step(
            shard_step, mesh, label="parallel.dp_step", donate=donate)
        self._epochs = sharded_fit.build_scanned_epochs(
            shard_step, mesh, label="parallel.dp_epochs", step=self._step)

    def init_state(self, params: PyTree) -> PyTree:
        return self.updater.init(params)

    def step(self, params: PyTree, ustate: PyTree, x, y, key: int = 0,
             iteration: int = 0):
        """One global step on the global batch ``(x, y)`` (rows divisible
        by the data degree): ``(params, ustate, score, skipped)``."""
        local_batch_size(int(x.shape[0]), self.mesh, pad=False)
        it = torch.full((), int(iteration), dtype=torch.int32,
                        device=self.device)
        params, ustate, _, score, skipped = self._step(
            params, ustate, it, (self._rows(x), self._rows(y)),
            self._gen(key))
        return params, ustate, score, skipped

    def fit(self, params: PyTree, batches: Iterable[Tuple[Any, Any]],
            key: int = 0, listeners=(), num_epochs: int = 1,
            scan: bool = True) -> PyTree:
        """Train over global batches.  A uniform list (and ``scan``) is
        stacked, cut to this rank's rows and staged on the device once,
        then the step replays over it for ``num_epochs``; otherwise
        batch by batch.  Returns the trained params (the caller's are
        never written); listeners see every step's mean score."""
        ustate = self.init_state(params)
        batches = [(torch.as_tensor(x), torch.as_tensor(y))
                   for x, y in batches]
        for x, _ in batches:
            local_batch_size(int(x.shape[0]), self.mesh, pad=False)
        total = sum(_nbytes(x) + _nbytes(y) for x, y in batches)
        uniform = (scan and len(batches) > 1
                   and total <= sharded_fit.SCAN_MAX_DATASET_BYTES
                   and len({(tuple(x.shape), tuple(y.shape))
                            for x, y in batches}) == 1)
        gen = self._gen(key)
        it = torch.zeros((), dtype=torch.int32, device=self.device)
        ndp = self.mesh.shape[DATA_AXIS]
        if uniform:
            t0 = time.perf_counter()
            xs = self._rows(torch.stack([x for x, _ in batches]), 1)
            ys = self._rows(torch.stack([y for _, y in batches]), 1)
            dp_metrics.note_staged(_nbytes(xs) + _nbytes(ys),
                                   (time.perf_counter() - t0) * 1e3,
                                   batches=len(batches))
            params, ustate, it, scores, skips = self._epochs(
                params, ustate, it, (xs, ys), gen, num_epochs)
            dp_metrics.note_dispatch(steps=int(scores.numel()), accum=1,
                                     data_degree=ndp)
            _note_skips(skips)
            if listeners:
                for n, s in enumerate(scores.reshape(-1).tolist()):
                    for ls in listeners:
                        ls.iteration_done(self, n, s)
            return tree_map(torch.clone, params)
        skips, n = [], 0
        for _ in range(num_epochs):
            for x, y in batches:
                params, ustate, it, score, skipped = self._step(
                    params, ustate, it, (self._rows(x), self._rows(y)), gen)
                skips.append(skipped)
                dp_metrics.note_dispatch(steps=1, accum=1, data_degree=ndp)
                for ls in listeners:
                    ls.iteration_done(self, n, float(score))
                n += 1
        _note_skips(skips)
        return tree_map(torch.clone, params)


class ParameterAveragingTrainer(_Trainer):
    """Spark-semantics data parallelism: local ``local_steps``-step
    training on each rank's rows, then parameter averaging."""

    def __init__(self, loss_fn: LossFn, updater: Dl4jUpdater, mesh,
                 local_steps: int = 1, average_each_round: bool = True):
        super().__init__(mesh)
        self.loss_fn = loss_fn
        self.updater = updater
        self.local_steps = local_steps
        self.average_each_round = average_each_round
        vag = value_and_grad(loss_fn)

        def round_fn(params, x, y, gen, it0):
            """``local_steps`` guarded steps of this rank's replica from
            fresh updater state, then (optionally) the average:
            ``(params, mean last score, skips summed over ranks)``."""
            p, u = params, updater.init(params)
            skips = []
            for i in range(local_steps):
                score, grads = vag(p, x, y, gen)
                upd, new_u = updater.update(u, grads, p, it0 + i, 1)
                # a per-replica guard: a bad batch drops only this
                # rank's local update
                p, u, skipped = resilience.guard_update(
                    p, u, apply_descent(p, upd), new_u, (score, grads))
                skips.append(skipped)
            if average_each_round:
                p = collectives.param_average(p, mesh)
            score = collectives.pmean(score, mesh)
            n_skipped = collectives.psum(torch.stack(skips).sum(), mesh)
            with torch.no_grad():
                copy_into(params, p)
            return params, score, n_skipped

        self._round = compile_cache.cached_graph(
            round_fn, label="parallel.param_avg_round", donate_argnums=(0,))
        self._final_avg = compile_cache.cached_graph(
            lambda p: collectives.param_average(p, mesh),
            label="parallel.param_avg_final")

    def fit(self, params: PyTree, batches: Iterable[Tuple[Any, Any]],
            key: int = 0, listeners=()) -> PyTree:
        """One round a global batch.  Takes and returns one replica's
        params (the caller's are never written)."""
        gen = self._gen(key)
        it = 0
        skips = []
        for rnd, (x, y) in enumerate(batches):
            local_batch_size(int(x.shape[0]), self.mesh, pad=False)
            params, score, n_skipped = self._round(
                params, self._rows(x), self._rows(y), gen,
                torch.full((), it, dtype=torch.int32, device=self.device))
            skips.append(n_skipped)
            it += self.local_steps
            for ls in listeners:
                ls.iteration_done(self, rnd, float(score))
        _note_skips(skips)
        return tree_map(torch.clone, self._final_avg(params))
