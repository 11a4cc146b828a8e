"""Interop adapters: LabeledPoint-style records <-> DataSet.

Port of ``deeplearning4j_tpu/datasets/interop.py``
(``spark/util/MLLibUtil.java``): the bridge between
Spark MLlib's ``LabeledPoint(label, Vector)`` record form and the
framework's ``DataSet`` (one-hot labels), in both directions, so
pipelines written against record streams (MLlib RDDs, CSV rows, feature
stores) can feed training and read predictions back.  Also covers the
``fromContinuous``/vector cases: regression targets pass through
unchanged when ``num_classes`` is 0.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


@dataclasses.dataclass
class LabeledPoint:
    """One record: scalar label + dense feature vector
    (MLlib LabeledPoint shape)."""
    label: float
    features: np.ndarray

    def __post_init__(self):
        self.features = np.asarray(self.features, dtype=np.float32)


def from_labeled_points(points: Iterable[LabeledPoint],
                        num_classes: Optional[int] = None) -> DataSet:
    """Records -> DataSet of CPU tensors (MLLibUtil.fromLabeledPoint
    parity).

    Classification (default): labels are class indices, one-hot encoded
    into ``num_classes`` columns (inferred as max+1 when omitted).
    Regression: pass ``num_classes=0`` to keep labels as a [N, 1] float
    column.
    """
    points = list(points)
    if not points:
        raise ValueError("no labeled points")
    x = np.stack([p.features for p in points])
    raw = np.asarray([p.label for p in points])
    if num_classes == 0:                     # continuous/regression target
        return DataSet(torch.from_numpy(x),
                       torch.from_numpy(raw[:, None].astype(np.float32)))
    idx = raw.astype(np.int64)
    if np.any(idx != raw) or np.any(idx < 0):
        raise ValueError("classification labels must be non-negative "
                         "integers; pass num_classes=0 for regression")
    n = int(num_classes) if num_classes else int(idx.max()) + 1
    if idx.max() >= n:
        raise ValueError(f"label {int(idx.max())} >= num_classes {n}")
    one_hot = np.zeros((len(points), n), dtype=np.float32)
    one_hot[np.arange(len(points)), idx] = 1.0
    return DataSet(torch.from_numpy(x), torch.from_numpy(one_hot))


def to_labeled_points(data: DataSet) -> List[LabeledPoint]:
    """DataSet -> records (MLLibUtil.toLabeledPoint parity): one-hot (or
    probability) label rows collapse to their argmax class; single-column
    labels pass through as continuous values."""
    x = torch.as_tensor(data.features).cpu().numpy()
    y = torch.as_tensor(data.labels).cpu().numpy()
    if y.ndim == 1:
        y = y[:, None]
    if y.shape[-1] == 1:
        labels = y[:, 0].astype(float)
    else:
        labels = np.argmax(y, axis=-1).astype(float)
    return [LabeledPoint(float(lab), row) for lab, row in zip(labels, x)]


def from_arrays(features: Sequence, labels: Sequence,
                num_classes: Optional[int] = None) -> DataSet:
    """Convenience over plain (features, labels) pairs: the MLlib
    ``fromDataSet``/``fromMatrix`` family collapsed into one entry."""
    return from_labeled_points(
        [LabeledPoint(float(l), np.asarray(f)) for f, l in
         zip(features, labels)], num_classes)
