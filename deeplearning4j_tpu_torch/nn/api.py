"""NN API contracts: the sequence-classification interface.

Port of ``deeplearning4j_tpu/nn/api.py`` (``nn/api/SequenceClassifier.
java``): the contract as an ABC and an LSTM implementation of it.  A
fit step is one Adam step over the whole ``[B, T, D]`` batch, the time
loop inside the LSTM layer (``nn/layers/lstm.py``).  ``optax.adam(lr)``
of the reference is ``ops/updaters.adamw(lr, weight_decay=0.0)`` here
(the two are the same transformation).  The step runs through the
compile engine (``runtime/compile_cache.cached_graph``, keyed as the
reference's ``engine_key``), so on the card the whole step, every time
step of forward and backward, is one CUDA graph replay; the in-step
guard drops an update whose loss or gradients are not finite.
"""

from __future__ import annotations

import abc
from typing import Any, List

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device

Tensor = torch.Tensor


class SequenceClassifier(abc.ABC):
    """Classify each timestep of a sequence batch (SequenceClassifier.java)."""

    @abc.abstractmethod
    def classifier(self) -> Any:
        """The underlying per-timestep classifier (layer/model object)."""

    @abc.abstractmethod
    def most_likely_in_sequence(self, examples) -> int:
        """The single most likely class over the whole sequence batch
        (``mostLikelyInSequence``): argmax of the summed class scores."""

    @abc.abstractmethod
    def predict(self, examples) -> Tensor:
        """Per-timestep class distributions ``[B, T, n_classes]``."""

    @abc.abstractmethod
    def fit(self, features, labels) -> List[float]:
        """Train on ``[B, T, D]`` features and ``[B, T, n_classes]``
        one-hot (or ``[B, T]`` int) labels; returns per-step losses."""


class LSTMSequenceClassifier(SequenceClassifier):
    """LSTM-backed sequence classifier: the fused-gate LSTM and a
    softmax decoder per timestep, trained with Adam.

    ``n_in`` features per timestep -> ``n_classes`` labels per timestep.
    ``truncate_bptt`` (recompute each step in the backward) and
    ``compute_dtype`` (the products' dtype) go to the layer's conf; the
    defaults are the reference's (no recompute, bf16 products).
    """

    def __init__(self, n_in: int, n_classes: int, hidden: int = 32,
                 learning_rate: float = 1e-2, seed: int = 0, *,
                 truncate_bptt: int = 0, compute_dtype: str = "bfloat16",
                 device: DeviceLike = None):
        from deeplearning4j_tpu_torch.nn.conf.configuration import (
            LayerKind, NeuralNetConfiguration)
        from deeplearning4j_tpu_torch.nn.layers.lstm import LSTMLayer
        from deeplearning4j_tpu_torch.ops import updaters
        from deeplearning4j_tpu_torch.runtime import compile_cache
        from deeplearning4j_tpu_torch.runtime import resilience

        self.device = resolve_device(device)
        conf = (NeuralNetConfiguration.builder()
                .kind(LayerKind.LSTM).n_in(n_in).n_out(n_classes)
                .hidden_size(hidden).activation("softmax")
                .truncate_bptt(truncate_bptt).compute_dtype(compute_dtype)
                .build())
        self._layer = LSTMLayer(conf)
        self.n_classes = n_classes
        gen = torch.Generator().manual_seed(seed)
        self.params = self._layer.init(gen, self.device)
        self._opt = updaters.adamw(learning_rate, weight_decay=0.0)
        self._opt_state = self._opt.init(self.params)

        layer, opt = self._layer, self._opt

        def train_step(params, opt_state, xs, ys):
            live = {k: p.detach().requires_grad_(True)
                    for k, p in params.items()}
            with torch.enable_grad():
                loss = layer.sequence_loss(live, xs, ys)
            keys = sorted(live)
            grads = dict(zip(keys, torch.autograd.grad(
                loss, [live[k] for k in keys])))
            loss = loss.detach()
            with torch.no_grad():
                updates, new_state = opt.update(grads, opt_state, params)
                new_params, new_state, skipped = resilience.guard_update(
                    params, opt_state,
                    updaters.apply_updates(params, updates), new_state,
                    (loss, grads))
                updaters.copy_into(params, new_params)
                updaters.copy_into(opt_state, new_state)
            return params, opt_state, loss, skipped

        def predict(params, xs):
            with torch.no_grad():
                return torch.softmax(
                    layer.decode(params, layer.scan_sequence(params, xs)),
                    dim=-1)

        # the step is determined by the hyperparameters, so identically
        # shaped classifiers share one entry (one capture a signature)
        engine_key = ("lstm_seq_clf", n_in, n_classes, hidden,
                      learning_rate, truncate_bptt, compute_dtype)
        self._train_step = compile_cache.cached_graph(
            train_step, key=("train",) + engine_key,
            label="api.lstm_train_step", donate_argnums=(0, 1))
        self._predict = compile_cache.cached_graph(
            predict, key=("predict",) + engine_key, label="api.lstm_predict")

    def classifier(self):
        return self._layer

    def _as_input(self, a) -> Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def _one_hot(self, labels) -> Tensor:
        labels = torch.as_tensor(labels).to(self.device)
        if labels.dim() == 2:                      # [B, T] int -> one-hot
            return torch.nn.functional.one_hot(
                labels.long(), self.n_classes).float()
        return labels.float()

    def fit(self, features, labels, epochs: int = 50) -> List[float]:
        from deeplearning4j_tpu_torch.ops import updaters
        from deeplearning4j_tpu_torch.runtime import resilience

        xs = self._as_input(features)
        ys = self._one_hot(labels)
        params, state = self.params, self._opt_state
        losses, skips = [], []
        for _ in range(epochs):
            params, state, loss, skipped = self._train_step(params, state,
                                                            xs, ys)
            losses.append(loss)
            skips.append(skipped)
        # the engine's state set goes back for the next fit: the trained
        # state handed to the user is a copy
        self.params = updaters.tree_map(torch.clone, params)
        self._opt_state = updaters.tree_map(torch.clone, state)
        del params, state
        resilience.note_skips(skips, where="sequence-api")
        return torch.stack(losses).cpu().tolist() if losses else []

    def predict(self, examples) -> Tensor:
        return self._predict(self.params, self._as_input(examples))

    def most_likely_in_sequence(self, examples) -> int:
        probs = self.predict(examples)             # [B, T, K]
        return int(torch.argmax(torch.sum(probs, dim=(0, 1))))

    def predict_labels(self, examples) -> np.ndarray:
        """Per-timestep argmax labels ``[B, T]`` (convenience over
        predict)."""
        return torch.argmax(self.predict(examples), dim=-1).cpu().numpy()
