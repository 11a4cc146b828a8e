"""MNIST idx-format file readers and writers.

Port of ``deeplearning4j_tpu/datasets/mnist.py``: readers for the
idx1/idx3 binary formats (``datasets/mnist/MnistDbFile.java`` and its
kin in the reference), their inverse writers, discovery of a local idx
tree and a synthetic surrogate.  Zero egress, as in the reference:
nothing is downloaded; files are read from a local directory.
:func:`load_mnist` parses uncompressed files with the native C++ reader
(``runtime/native.py``) when the library is available, as the reference
does, and with the Python readers otherwise; both give the same arrays.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

IMAGES_MAGIC = 2051  # idx3
LABELS_MAGIC = 2049  # idx1


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def read_idx_images(path: str) -> np.ndarray:
    """idx3 -> uint8 [N, rows, cols]."""
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != IMAGES_MAGIC:
            raise ValueError(f"{path}: bad magic {magic} (want {IMAGES_MAGIC})")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    """idx1 -> uint8 [N]."""
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != LABELS_MAGIC:
            raise ValueError(f"{path}: bad magic {magic} (want {LABELS_MAGIC})")
        return np.frombuffer(f.read(n), dtype=np.uint8)


def write_idx_images(path: str, images: np.ndarray) -> None:
    """Inverse writer (used by tests to round-trip the readers)."""
    n, rows, cols = images.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">IIII", IMAGES_MAGIC, n, rows, cols))
        f.write(np.ascontiguousarray(images, dtype=np.uint8).tobytes())


def write_idx_labels(path: str, labels: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack(">II", LABELS_MAGIC, len(labels)))
        f.write(np.ascontiguousarray(labels, dtype=np.uint8).tobytes())


_CANDIDATE_NAMES = {
    "train_images": ("train-images-idx3-ubyte", "train-images.idx3-ubyte"),
    "train_labels": ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte"),
    "test_images": ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"),
    "test_labels": ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"),
}


def find_mnist_dir() -> Optional[str]:
    """Look for idx files in $MNIST_DIR (absolute priority), then the
    LARGEST archive among ./data/mnist and the repo's committed
    data/mnist fixture — so a user's real 60k archive beats the
    2048-sample fixture.  Unlike the reference, nothing outside the
    working directory and the checkout is searched (no home-directory
    cache)."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def train_images_path(d):
        for name in _CANDIDATE_NAMES["train_images"]:
            for suffix in ("", ".gz"):
                p = os.path.join(d, name + suffix)
                if os.path.exists(p):
                    return p
        return None

    env = os.environ.get("MNIST_DIR")
    if env and os.path.isdir(env) and train_images_path(env):
        return env
    best, best_size = None, -1
    for d in [os.path.join(os.getcwd(), "data", "mnist"),
              os.path.join(repo_root, "data", "mnist")]:
        if not os.path.isdir(d):
            continue
        p = train_images_path(d)
        if p is not None and os.path.getsize(p) > best_size:
            best, best_size = d, os.path.getsize(p)
    return best


def load_mnist(data_dir: str, train: bool = True
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 [N,28,28], labels uint8 [N]) from idx files,
    plain or .gz; uncompressed files through the native reader when the
    library is available."""
    img_key = "train_images" if train else "test_images"
    lbl_key = "train_labels" if train else "test_labels"

    def resolve(key):
        for name in _CANDIDATE_NAMES[key]:
            for suffix in ("", ".gz"):
                p = os.path.join(data_dir, name + suffix)
                if os.path.exists(p):
                    return p
        raise FileNotFoundError(f"no idx file for {key} in {data_dir}")

    img_path, lbl_path = resolve(img_key), resolve(lbl_key)
    if not img_path.endswith(".gz") and not lbl_path.endswith(".gz"):
        from deeplearning4j_tpu_torch.runtime import native

        if native.available():
            imgs = native.parse_idx_images_u8(img_path)  # [N, rows, cols]
            lbls = native.parse_idx_labels(lbl_path)
            if imgs is not None and lbls is not None:
                return imgs, lbls.astype(np.uint8)
    return read_idx_images(img_path), read_idx_labels(lbl_path)


def synthetic_mnist(n: int = 2048, seed: int = 0,
                    num_classes: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped surrogate (28x28 class-dependent blob
    patterns + noise) so training/eval pipelines run with zero egress.
    Learnable: each class has a distinct spatial template."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.uint8)
    yy, xx = np.mgrid[0:28, 0:28]
    templates = []
    for c in range(num_classes):
        cy, cx = 6 + 2 * (c % 4), 6 + 2 * (c // 4)
        blob = np.exp(-(((yy - cy) / 5.0) ** 2 + ((xx - cx) / 5.0) ** 2))
        ring = np.exp(-((np.hypot(yy - 14, xx - 14) - (4 + c)) / 2.5) ** 2)
        templates.append(0.7 * blob + 0.5 * ring)
    templates = np.stack(templates)
    imgs = templates[labels] * 255.0
    imgs = imgs + rng.normal(0, 16.0, imgs.shape)
    return np.clip(imgs, 0, 255).astype(np.uint8), labels
