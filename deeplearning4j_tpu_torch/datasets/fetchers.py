"""Dataset fetchers: a cursor over a source that materializes the next
chunk as a ``DataSet``.

Port of the MNIST part of ``deeplearning4j_tpu/datasets/fetchers.py``
(``DataSetFetcher``, ``ArrayFetcher``, ``MnistDataFetcher``, :26-99).
A fetched chunk holds CPU tensors over the fetcher's numpy arrays; the
fit moves each batch to its device.  The Iris, CSV, Curves and LFW
fetchers are not ported yet (ROADMAP A5).  Zero egress: idx files are
read from a local directory, or a synthetic surrogate is made.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets import mnist as mnist_io
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, one_hot


class DataSetFetcher:
    """Cursor-based fetcher SPI (BaseDataFetcher parity)."""

    def __init__(self):
        self.cursor = 0
        self.total = 0
        self._current: Optional[DataSet] = None

    def has_more(self) -> bool:
        return self.cursor < self.total

    def fetch(self, num_examples: int) -> None:
        raise NotImplementedError

    def next(self) -> DataSet:
        if self._current is None:
            raise RuntimeError("call fetch() first")
        return self._current

    def reset(self) -> None:
        self.cursor = 0

    def input_columns(self) -> int:
        raise NotImplementedError

    def total_outcomes(self) -> int:
        raise NotImplementedError


class ArrayFetcher(DataSetFetcher):
    """Fetcher over in-memory fp32 arrays."""

    def __init__(self, features: np.ndarray, labels: np.ndarray):
        super().__init__()
        self.features = np.ascontiguousarray(features, dtype=np.float32)
        self.labels = np.ascontiguousarray(labels, dtype=np.float32)
        self.total = len(self.features)

    def fetch(self, num_examples: int) -> None:
        end = min(self.cursor + num_examples, self.total)
        self._current = DataSet(
            torch.from_numpy(self.features[self.cursor:end]),
            torch.from_numpy(self.labels[self.cursor:end]))
        self.cursor = end

    def input_columns(self) -> int:
        return int(np.prod(self.features.shape[1:]))

    def total_outcomes(self) -> int:
        return int(self.labels.shape[-1])


class MnistDataFetcher(ArrayFetcher):
    """MNIST (MnistDataFetcher.java:37 parity): images in [0, 1],
    binarized at > 30/255 unless ``binarize=False``, flattened to
    ``[N, 784]`` or, with ``flatten=False``, NHWC ``[N, 28, 28, 1]``;
    one-hot labels.  Reads idx files from ``data_dir`` (or the one
    ``find_mnist_dir`` discovers), else makes the synthetic surrogate
    (``synthetic`` says which)."""

    def __init__(self, binarize: bool = True, train: bool = True,
                 data_dir: Optional[str] = None,
                 synthetic_n: int = 2048, flatten: bool = True):
        data_dir = data_dir or mnist_io.find_mnist_dir()
        if data_dir is not None:
            images, labels = mnist_io.load_mnist(data_dir, train=train)
            self.synthetic = False
        else:
            images, labels = mnist_io.synthetic_mnist(
                n=synthetic_n, seed=0 if train else 1)
            self.synthetic = True
        x = images.astype(np.float32) / 255.0
        if binarize:
            x = (x > 30.0 / 255.0).astype(np.float32)
        x = x.reshape(len(x), -1) if flatten else x[..., None]
        super().__init__(x, one_hot(labels, 10))
