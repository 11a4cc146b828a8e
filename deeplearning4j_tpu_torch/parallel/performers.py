"""Library work performers for the scale-out runners.

Port of ``deeplearning4j_tpu/parallel/performers.py``.  The reference's
Akka runtime ships its flagship workloads as library components:
``scaleout/perform/BaseMultiLayerNetworkWorkPerformer.java`` (set-up
rebuilds the net from a JSON conf, perform = ``fit(DataSet)`` then
``job.setResult(params())``, update = ``setParams``) and
``scaleout/perform/NeuralNetWorkPerformer.java`` (the same for
pretraining), aggregated by ``scaleout/aggregator/INDArrayAggregator
.java`` (a running parameter average).

Each performer is rebuilt from a serializable spec (the conf JSON), so
the multi-process runner can start it in a worker process from a string
(``parallel/transport.resolve_performer_factory``).  Each takes
``device=`` (None: the card) and trains there; params that arrive from
the master (tensors on any device, or numpy arrays from the wire) are
copied onto it.  A result is the network's params, tensors on that
device; the transport sends them as numpy arrays.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike
from deeplearning4j_tpu_torch.ops.updaters import tree_map
from deeplearning4j_tpu_torch.parallel import scaleout as so
from deeplearning4j_tpu_torch.parallel.coordinator import Job

__all__ = ["MultiLayerNetworkPerformer", "ParameterAveragingAggregator",
           "PretrainLayerPerformer", "params_on"]


def params_on(tree: Any, device: torch.device) -> Any:
    """A copy of a params tree (tensors on any device, or numpy arrays)
    as tensors on ``device``."""
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.to(device, copy=True)
        return torch.tensor(np.asarray(a), device=device)
    return tree_map(leaf, tree)


def _network(conf: Any, seed: int, device: DeviceLike):
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if isinstance(conf, str):
        conf = MultiLayerConfiguration.from_json(conf)
    return MultiLayerNetwork(conf, device=device).init(seed=seed)


class MultiLayerNetworkPerformer(so.WorkerPerformer):
    """Fit a MultiLayerNetwork on each job's DataSet shard and ship the
    trained params back (BaseMultiLayerNetworkWorkPerformer.java).
    ``conf`` is a ``MultiLayerConfiguration`` or its JSON, the form a
    worker process receives."""

    def __init__(self, conf: Any, num_epochs: int = 10, seed: int = 0,
                 device: DeviceLike = None):
        self.net = _network(conf, seed, device)
        self.num_epochs = num_epochs

    def perform(self, job: Job) -> None:
        # mesh=None: a scale-out performer IS one data-parallel worker;
        # the control plane owns the parallelism
        self.net.fit_backprop(job.work, num_epochs=self.num_epochs,
                              mesh=None)
        job.result = self.net.params

    def update(self, params) -> None:
        self.net.params = params_on(params, self.net.device)


class PretrainLayerPerformer(so.WorkerPerformer):
    """Greedy layer-wise pretraining of a configured net on each job's
    DataSet (NeuralNetWorkPerformer.java: pretrain layers a job, no
    supervised head)."""

    def __init__(self, conf: Any, seed: int = 0, device: DeviceLike = None):
        self.net = _network(conf, seed, device)
        self.seed = seed

    def perform(self, job: Job) -> None:
        self.net.pretrain(job.work, seed=self.seed)
        job.result = self.net.params

    def update(self, params) -> None:
        self.net.params = params_on(params, self.net.device)


class ParameterAveragingAggregator(so.WorkAccumulator):
    """Running average of params trees (INDArrayAggregator.java:35-60):
    :class:`~deeplearning4j_tpu_torch.parallel.scaleout.WorkAccumulator`'s
    math, named as the reference's topology names it."""
