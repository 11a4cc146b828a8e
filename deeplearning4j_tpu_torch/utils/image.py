"""Image loading: ``util/ImageLoader.java`` and the LFW directory layout
(``base/LFWLoader.java``: one subdirectory per person).

The port's own copy of ``deeplearning4j_tpu/utils/image.py`` (a module
without JAX; the port imports nothing of the JAX package).  Images come
back as grayscale float32 ``[H, W]`` in [0, 1] numpy arrays.  JPEG and
PNM decode through the native library first (``runtime/native.py``);
PIL, imported only when needed, decodes what the native decoder refuses
(progressive JPEG, PNG, BMP), and the Python PNM reader and resize run
where the library is missing.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np


def _read_pnm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # native C++ decoder first (runtime/native.py); the same output
    from deeplearning4j_tpu_torch.runtime import native as _native
    img = _native.decode_pnm(data)
    if img is not None:
        return img
    header = re.match(rb"(P[2356])\s+(?:#.*\s+)?(\d+)\s+(\d+)\s+(\d+)\s", data)
    if not header:
        raise ValueError(f"{path}: not a PNM file")
    magic, w, h, maxval = (header.group(1).decode(), int(header.group(2)),
                           int(header.group(3)), int(header.group(4)))
    body = data[header.end():]
    channels = 3 if magic in ("P3", "P6") else 1
    if magic in ("P5", "P6"):
        arr = np.frombuffer(body, dtype=np.uint8, count=w * h * channels)
    else:
        arr = np.array(body.split()[:w * h * channels], dtype=np.float32)
    arr = arr.reshape(h, w, channels).astype(np.float32) / maxval
    return arr.mean(-1) if channels == 3 else arr[..., 0]


def load_image(path: str, size: Optional[int] = None) -> np.ndarray:
    """Load one image as grayscale float32 [H, W] in [0,1]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        img = np.load(path).astype(np.float32)
        if img.ndim == 3:
            img = img.mean(-1)
        if img.max() > 1.0:
            img = img / 255.0
    elif ext in (".pgm", ".ppm", ".pnm"):
        img = _read_pnm(path)
    else:
        # native JPEG/PNM decoders with the PIL fallback: one policy,
        # shared with archive members (load_image_bytes)
        with open(path, "rb") as f:
            img = load_image_bytes(f.read(), None, ext)
    if size is not None and img.shape != (size, size):
        img = _resize_nearest(img, size)
    return img


def load_image_bytes(data: bytes, size: Optional[int] = None,
                     ext: str = ".jpg") -> np.ndarray:
    """Decode an in-memory image (archive members, network blobs) to
    grayscale float32 [H, W] in [0,1]: native JPEG/PNM decoders first,
    then PIL.  Mirrors load_image for byte buffers."""
    from deeplearning4j_tpu_torch.runtime import native as _native

    img = None
    ext = ext.lower()
    if ext in (".jpg", ".jpeg"):
        img = _native.decode_jpeg(data)
    elif ext in (".pgm", ".ppm", ".pnm"):
        img = _native.decode_pnm(data)
    if img is None:
        import io
        try:
            from PIL import Image
        except ImportError as e:
            raise ValueError(
                f"cannot decode {ext} bytes without PIL") from e
        img = np.asarray(Image.open(io.BytesIO(data)).convert("L"),
                         dtype=np.float32) / 255.0
    if size is not None and img.shape != (size, size):
        img = _resize_nearest(img, size)
    return img


def load_lfw_archive(path: str, size: int = 28
                     ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Read an LFW-style tarball (lfw.tgz: ``lfw/<person>/<img>.jpg``)
    without extracting to disk: the local-archive tier of
    ``base/LFWLoader.java``'s untarFile path (which downloads and
    untars; here a local copy is read).  Returns the same triple as
    load_image_directory."""
    import tarfile

    by_person: dict = {}
    with tarfile.open(path, "r:*") as tf:
        for m in tf:
            if not m.isfile():
                continue
            low = m.name.lower()
            if not low.endswith((".jpg", ".jpeg", ".pgm", ".ppm")):
                continue
            parts = m.name.strip("/").split("/")
            if len(parts) < 2:
                continue
            person = parts[-2]
            f = tf.extractfile(m)
            if f is None:
                continue
            by_person.setdefault(person, []).append((m.name, f.read()))
    if not by_person:
        raise ValueError(f"no images found in archive {path}")
    names = sorted(by_person)
    feats, labels = [], []
    for idx, name in enumerate(names):
        for fname, data in sorted(by_person[name]):
            ext = os.path.splitext(fname)[1]
            feats.append(load_image_bytes(data, size, ext).ravel())
            labels.append(idx)
    return (np.stack(feats).astype(np.float32),
            np.asarray(labels, dtype=np.int64), names)


def _resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    from deeplearning4j_tpu_torch.runtime import native as _native
    out = _native.resize_nearest(img, size)
    if out is not None:
        return out
    h, w = img.shape
    ys = (np.arange(size) * h / size).astype(int).clip(0, h - 1)
    xs = (np.arange(size) * w / size).astype(int).clip(0, w - 1)
    return img[np.ix_(ys, xs)]


_IMAGE_EXTS = (".npy", ".pgm", ".ppm", ".pnm", ".png", ".jpg", ".jpeg", ".bmp")


def load_image_directory(root: str, size: int = 28
                         ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """LFW-style: root/<person>/<image> -> (flattened images [N, size*size],
    integer labels [N], person names)."""
    names = sorted(d for d in os.listdir(root)
                   if os.path.isdir(os.path.join(root, d)))
    feats, labels = [], []
    for idx, name in enumerate(names):
        person_dir = os.path.join(root, name)
        for fname in sorted(os.listdir(person_dir)):
            if not fname.lower().endswith(_IMAGE_EXTS):
                continue
            img = load_image(os.path.join(person_dir, fname), size)
            feats.append(img.ravel())
            labels.append(idx)
    if not feats:
        raise ValueError(f"no images found under {root}")
    return (np.stack(feats).astype(np.float32),
            np.asarray(labels, dtype=np.int64), names)
