"""Asynchronous (Hogwild-style) training: the reference's async path.

Port of ``deeplearning4j_tpu/parallel/hogwild.py``.  The reference's
``HogWildWorkRouter.java:30`` ("always send; async lock-free") and the
Hazelcast StateTracker's update flow: workers pull the current params,
train locally, push deltas; the master folds each delta in as it
arrives, with NO barrier (stale gradients by design).

Here the asynchrony lives on the host:

- each worker thread takes ``local_steps`` steps of ``loss_fn`` with a
  :func:`~deeplearning4j_tpu_torch.ops.updaters.dl4j_updater` on its
  device (``devices[w % len(devices)]``; on one card every thread drives
  it), eagerly, the gradients by ``torch.func``;
- the ``StateTracker`` holds the current global params;
- a worker folds its delta ``new - pulled`` into the current params
  under the trainer's lock the moment its job is done;
- each worker draws from a ``torch.Generator`` of its own on its device,
  seeded with ``seed + w`` (the reference's ``jax.random.key(seed +
  w)``), handed to ``loss_fn(params, x, y, generator)``.

A worker that raises stops its peers, and ``fit`` re-raises its error.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.ops.updaters import (Dl4jUpdater,
                                                   apply_descent, tree_map)
from deeplearning4j_tpu_torch.parallel.coordinator import Job, StateTracker

__all__ = ["HogwildTrainer", "INDArrayAggregator"]

PyTree = Any
LossFn = Callable[[PyTree, torch.Tensor, torch.Tensor, torch.Generator],
                  torch.Tensor]


class INDArrayAggregator:
    """Running parameter average (scaleout/aggregator/INDArrayAggregator
    .java:35-60), over trees of tensors or numpy arrays."""

    def __init__(self):
        self._sum: Optional[PyTree] = None
        self._n = 0

    def accumulate(self, params: PyTree) -> None:
        if self._sum is None:
            self._sum = params
        else:
            self._sum = pytree.tree_map(lambda s, p: s + p, self._sum,
                                        params)
        self._n += 1

    def aggregate(self) -> PyTree:
        assert self._sum is not None, "nothing accumulated"
        return pytree.tree_map(lambda s: s / self._n, self._sum)


class HogwildTrainer:
    """Async param-delta training over worker threads and a
    StateTracker.  ``devices`` (``torch.device`` s) are shared round
    robin by the workers; by default the one of ``device`` (None: the
    card)."""

    def __init__(self, loss_fn: LossFn, updater: Dl4jUpdater,
                 num_workers: int = 2, local_steps: int = 1,
                 devices: Optional[Sequence[torch.device]] = None,
                 device: DeviceLike = None):
        self.loss_fn = loss_fn
        self.updater = updater
        self.num_workers = num_workers
        self.local_steps = local_steps
        self.devices = ([torch.device(d) for d in devices] if devices
                        else [resolve_device(device)])
        self.tracker = StateTracker()
        self._lock = threading.Lock()    # guards the global fold only
        self._abort = threading.Event()  # set on a worker's crash

    def _local_train(self, params, ustate, x, y, gen: torch.Generator,
                     it0: int):
        """``local_steps`` updater steps from ``params``: ``(params,
        updater state, the last step's loss)``."""
        def loss(p):
            return self.loss_fn(p, x, y, gen)

        grad_and_value = torch.func.grad_and_value(loss)
        score = None
        for i in range(self.local_steps):
            grads, score = grad_and_value(params)
            with torch.no_grad():
                upd, ustate = self.updater.update(ustate, grads, params,
                                                  it0 + i, 1)
                params = apply_descent(params, upd)
        return params, ustate, score

    def _worker(self, wid: str, gen: torch.Generator,
                errors: List[BaseException]) -> None:
        job = None
        try:
            dev = self.devices[int(wid.split("-")[-1]) % len(self.devices)]
            ustate = None
            local = None    # this worker's replica of the params
            while not self._abort.is_set():
                self.tracker.heartbeat(wid)
                job = self.tracker.job_for(wid)
                if job is None:
                    if not self.tracker.has_pending():
                        return
                    time.sleep(0.001)
                    continue
                x, y = (torch.as_tensor(a).to(dev) for a in job.work)
                # replicate on demand (WorkerActor.checkJobAvailable): pull
                # the global params only when the tracker flagged them
                if local is None or self.tracker.needs_replicate(wid):
                    local = tree_map(lambda a: a.to(dev),
                                     self.tracker.get_current())
                    self.tracker.done_replicating(wid)
                pulled = local
                if ustate is None:
                    ustate = self.updater.init(pulled)
                new_params, ustate, score = self._local_train(
                    pulled, ustate, x, y, gen,
                    self.tracker.count("iterations"))
                local = new_params
                # push the DELTA and fold it into the global params NOW:
                # async, stale-tolerant (Hogwild)
                delta = tree_map(torch.sub, new_params, pulled)
                with self._lock:
                    current = self.tracker.get_current()
                    self.tracker.set_current(tree_map(
                        lambda c, d: c + d.to(c.device), current, delta))
                self.tracker.done_replicating(wid)  # our own fold
                job.result = float(score)
                self.tracker.add_update(wid, job)
                self.tracker.increment("iterations")
                self.tracker.clear_job(wid)
                job = None
        except BaseException as e:  # surfaced to fit
            errors.append(e)
            self._abort.set()  # stop the peers: no spinning on its job
            if job is not None:
                self.tracker.clear_job(wid)

    def fit(self, params: PyTree,
            batches: Iterable[Tuple[Any, Any]], seed: int = 0) -> PyTree:
        """Train from ``params`` (a tree of tensors) over ``batches`` of
        ``(x, y)``, one job each; returns the folded global params."""
        self.tracker.set_current(params)
        for b in batches:
            self.tracker.add_job(Job(work=b))
        errors: List[BaseException] = []
        threads = []
        for w in range(self.num_workers):
            wid = f"worker-{w}"
            dev = self.devices[w % len(self.devices)]
            gen = torch.Generator(device=dev).manual_seed(seed + w)
            self.tracker.add_worker(wid)
            t = threading.Thread(target=self._worker,
                                 args=(wid, gen, errors), daemon=True)
            threads.append(t)
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return self.tracker.get_current()
