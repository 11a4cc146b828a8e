"""DataSet: a (features, labels) pair.

Port of ``deeplearning4j_tpu/datasets/dataset.py``.  The arrays are
numpy arrays or torch tensors (on any device), and each transformation
returns the kind it was given.  ``shuffle(seed)`` draws its permutation
from ``np.random.default_rng(seed)`` as the reference does, so both
packages shuffle a dataset into the same order.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch


def _take(a, perm: np.ndarray):
    if isinstance(a, torch.Tensor):
        return a[torch.from_numpy(perm).to(a.device)]
    return np.asarray(a)[perm]


def _as_float32(a):
    if isinstance(a, torch.Tensor):
        return a.float()
    return np.asarray(a, dtype=np.float32)


def _concat(arrays):
    if isinstance(arrays[0], torch.Tensor):
        return torch.cat(list(arrays), dim=0)
    return np.concatenate([np.asarray(a) for a in arrays], axis=0)


class DataSet:
    """(features, labels); labels are one-hot for classifiers."""

    def __init__(self, features, labels=None):
        self.features = features
        self.labels = labels if labels is not None else features

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def num_inputs(self) -> int:
        return int(self.features.shape[-1])

    def num_outcomes(self) -> int:
        return int(self.labels.shape[-1])

    def __len__(self) -> int:
        return self.num_examples()

    def __repr__(self) -> str:
        return (f"DataSet(features{tuple(self.features.shape)}, "
                f"labels{tuple(self.labels.shape)})")

    def shuffle(self, seed: int = 0) -> "DataSet":
        perm = np.random.default_rng(seed).permutation(self.num_examples())
        return DataSet(_take(self.features, perm), _take(self.labels, perm))

    def split_test_and_train(self, num_train: int
                             ) -> Tuple["DataSet", "DataSet"]:
        """nd4j ``SplitTestAndTrain``: the first ``num_train`` rows and
        the rest."""
        return (
            DataSet(self.features[:num_train], self.labels[:num_train]),
            DataSet(self.features[num_train:], self.labels[num_train:]),
        )

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return list(self.iterate_batches(batch_size))

    def iterate_batches(self, batch_size: int, drop_last: bool = False
                        ) -> Iterator["DataSet"]:
        n = self.num_examples()
        end = (n // batch_size) * batch_size if drop_last else n
        for i in range(0, end, batch_size):
            yield DataSet(self.features[i:i + batch_size],
                          self.labels[i:i + batch_size])

    def normalize_zero_mean_unit_variance(self) -> "DataSet":
        """Per-column (x - mean) / (std + 1e-8), in fp32."""
        f = _as_float32(self.features)
        mean = f.mean(0, keepdims=True) if isinstance(f, np.ndarray) \
            else f.mean(0, keepdim=True)
        std = (f.std(0, keepdims=True) if isinstance(f, np.ndarray)
               else f.std(0, correction=0, keepdim=True)) + 1e-8
        return DataSet((f - mean) / std, self.labels)

    def scale_0_1(self) -> "DataSet":
        """Per-column (x - min) / (max - min + 1e-8), in fp32."""
        f = _as_float32(self.features)
        if isinstance(f, np.ndarray):
            lo, hi = f.min(0, keepdims=True), f.max(0, keepdims=True)
        else:
            lo, hi = f.amin(0, keepdim=True), f.amax(0, keepdim=True)
        return DataSet((f - lo) / (hi - lo + 1e-8), self.labels)

    @staticmethod
    def merge(datasets: List["DataSet"]) -> "DataSet":
        """``DataSet.merge``: rows concatenated in order."""
        return DataSet(_concat([d.features for d in datasets]),
                       _concat([d.labels for d in datasets]))


def one_hot(indices, num_classes: int) -> np.ndarray:
    """``FeatureUtil.toOutcomeMatrix``: fp32 ``[N, num_classes]``; an
    index outside [0, num_classes) gives an all-zero row, as
    ``jax.nn.one_hot``."""
    idx = np.asarray(indices).astype(np.int64)
    return (idx[..., None] == np.arange(num_classes)).astype(np.float32)
