"""Dataset fetchers: a cursor over a source that materializes the next
chunk as a ``DataSet``.

Port of ``deeplearning4j_tpu/datasets/fetchers.py``: ``DataSetFetcher``,
``ArrayFetcher``, ``MnistDataFetcher`` (:26-99), ``IrisDataFetcher``,
``CSVDataFetcher``, ``CurvesDataFetcher`` (:102-166), ``find_lfw`` and
``LFWDataFetcher`` (:168-241, JPEG through the native decoder) and the
labelled CSV reader (:243-263).  A fetched chunk holds CPU tensors over the
fetcher's numpy arrays; the fit moves each batch to its device.  Zero
egress: files are read from local paths, or a deterministic surrogate is
made from numpy's seeded generator (the same arrays as the reference's).
"""

from __future__ import annotations

import csv as _csv
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets import mnist as mnist_io
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, one_hot
from deeplearning4j_tpu_torch.utils.image import (load_image_directory,
                                                  load_lfw_archive)


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


class IrisDataFetcher(ArrayFetcher):
    """Iris (datasets/fetchers/IrisDataFetcher.java parity): 4 features,
    3 classes.  Reads a local iris.csv if given; otherwise a deterministic
    3-cluster Gaussian surrogate with iris-like statistics (zero egress),
    the reference's arrays value for value."""

    def __init__(self, csv_path: Optional[str] = None, n_per_class: int = 50,
                 seed: int = 7):
        if csv_path and os.path.exists(csv_path):
            feats, labels = _read_labeled_csv(csv_path, label_last=True)
            x, y = feats, one_hot(labels, int(labels.max()) + 1)
        else:
            rng = np.random.default_rng(seed)
            means = np.array([[5.0, 3.4, 1.5, 0.2],
                              [5.9, 2.8, 4.3, 1.3],
                              [6.6, 3.0, 5.6, 2.0]], dtype=np.float32)
            stds = np.array([[0.35, 0.38, 0.17, 0.10],
                             [0.52, 0.31, 0.47, 0.20],
                             [0.64, 0.32, 0.55, 0.27]], dtype=np.float32)
            xs, ys = [], []
            for c in range(3):
                xs.append(rng.normal(means[c], stds[c],
                                     size=(n_per_class, 4)).astype(np.float32))
                ys.append(np.full(n_per_class, c))
            x = np.concatenate(xs)
            y = one_hot(np.concatenate(ys), 3)
            perm = rng.permutation(len(x))
            x, y = x[perm], y[perm]
        super().__init__(x, y)


class CSVDataFetcher(ArrayFetcher):
    """CSV (datasets/fetchers/CSVDataFetcher.java parity): numeric CSV with
    an integer label column."""

    def __init__(self, path: str, label_column: int = -1,
                 skip_header: bool = False, num_classes: Optional[int] = None):
        feats, labels = _read_labeled_csv(path, label_last=(label_column == -1),
                                          label_column=label_column,
                                          skip_header=skip_header)
        k = num_classes or int(labels.max()) + 1
        super().__init__(feats, one_hot(labels, k))


class CurvesDataFetcher(ArrayFetcher):
    """Curves (datasets/fetchers/CurvesDataFetcher.java parity): the
    deep-autoencoder benchmark — synthetic smooth 1-D curves rendered to a
    fixed grid; unsupervised (labels == features)."""

    def __init__(self, n: int = 1024, dim: int = 784, seed: int = 3):
        rng = np.random.default_rng(seed)
        t = np.linspace(0, 1, dim, dtype=np.float32)
        freqs = rng.uniform(1.0, 6.0, size=(n, 3)).astype(np.float32)
        phases = rng.uniform(0, 2 * np.pi, size=(n, 3)).astype(np.float32)
        amps = rng.uniform(0.2, 1.0, size=(n, 3)).astype(np.float32)
        x = np.zeros((n, dim), dtype=np.float32)
        for k in range(3):
            x += amps[:, k:k + 1] * np.sin(
                2 * np.pi * freqs[:, k:k + 1] * t[None, :]
                + phases[:, k:k + 1])
        x = (x - x.min(axis=1, keepdims=True))
        x = x / (x.max(axis=1, keepdims=True) + 1e-8)
        super().__init__(x, x)

    def total_outcomes(self) -> int:
        return self.features.shape[-1]


def find_lfw() -> Optional[str]:
    """Tiered local discovery (reference :168-198, the pattern of
    mnist.find_mnist_dir): $LFW_DIR, ./data/lfw, the repo's committed
    data/lfw, ~/.dl4j-tpu/lfw; each may be an extracted
    person-subdirectory tree, a directory containing an ``lfw*.tgz``
    archive, or a path directly to the archive.  Returns the usable path
    (dir or archive) or None."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidates = [os.environ.get("LFW_DIR"),
                  os.path.join(os.getcwd(), "data", "lfw"),
                  # the committed tiny corpus ships with the repo: found
                  # whatever the caller's cwd
                  os.path.join(repo_root, "data", "lfw"),
                  os.path.expanduser("~/.dl4j-tpu/lfw")]
    exts = (".jpg", ".jpeg", ".pgm", ".ppm")
    for c in candidates:
        if not c:
            continue
        if os.path.isfile(c) and c.endswith((".tgz", ".tar.gz", ".tar")):
            return c
        if not os.path.isdir(c):
            continue
        for entry in sorted(os.listdir(c)):
            full = os.path.join(c, entry)
            if entry.lower().startswith("lfw") and \
                    entry.endswith((".tgz", ".tar.gz", ".tar")):
                return full
            if os.path.isdir(full) and any(
                    f.lower().endswith(exts) for f in os.listdir(full)):
                return c
    return None


class LFWDataFetcher(ArrayFetcher):
    """LFW faces (datasets/fetchers/LFWDataFetcher.java parity, reference
    :201-241): reads a directory of per-person subdirectories of images
    (or an lfw.tgz archive, decoded in memory) through ``utils/image``
    (native JPEG decode first); discovers a local copy with
    ``find_lfw()``; makes seeded synthetic face-like blobs otherwise
    (``synthetic`` says which), the reference's arrays value for
    value."""

    def __init__(self, image_dir: Optional[str] = None, image_size: int = 28,
                 n: int = 256, num_people: int = 8, seed: int = 5):
        image_dir = image_dir or find_lfw()
        if image_dir and os.path.isfile(image_dir) and \
                image_dir.endswith((".tgz", ".tar.gz", ".tar")):
            x, labels, self.names = load_lfw_archive(image_dir, image_size)
            y = one_hot(labels, int(labels.max()) + 1)
            self.synthetic = False
        elif image_dir and os.path.isdir(image_dir):
            x, labels, self.names = load_image_directory(image_dir,
                                                         image_size)
            y = one_hot(labels, int(labels.max()) + 1)
            self.synthetic = False
        else:
            rng = np.random.default_rng(seed)
            labels = rng.integers(0, num_people, size=n)
            yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
            c = image_size / 2.0
            x = np.empty((n, image_size * image_size), dtype=np.float32)
            for i, lbl in enumerate(labels):
                face = np.exp(-((yy - c) ** 2 + (xx - c) ** 2)
                              / (2 * (c * 0.7) ** 2))
                eye_dx = 3 + (lbl % 4)
                for s in (-1, 1):
                    face += 0.8 * np.exp(-((yy - c + 4) ** 2 +
                                           (xx - c + s * eye_dx) ** 2) / 4.0)
                face += rng.normal(0, 0.05, face.shape)
                x[i] = face.ravel()
            y = one_hot(labels, num_people)
            self.names = [f"person_{i}" for i in range(num_people)]
            self.synthetic = True
        super().__init__(x, y)


def _read_labeled_csv(path: str, label_last: bool = True,
                      label_column: int = -1, skip_header: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
    rows: List[List[str]] = []
    with open(path, newline="") as f:
        reader = _csv.reader(f)
        for i, row in enumerate(reader):
            if skip_header and i == 0:
                continue
            if row:
                rows.append(row)
    arr = np.asarray(rows)
    lc = label_column if label_column >= 0 else arr.shape[1] - 1
    labels_raw = arr[:, lc]
    feats = np.delete(arr, lc, axis=1).astype(np.float32)
    try:
        labels = labels_raw.astype(np.float32).astype(np.int64)
    except ValueError:
        uniq = {v: i for i, v in enumerate(sorted(set(labels_raw)))}
        labels = np.asarray([uniq[v] for v in labels_raw], dtype=np.int64)
    return feats, labels
