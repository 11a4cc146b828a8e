"""ctypes bindings for the native host library (``native/dl4j_native.cpp``).

Port of ``deeplearning4j_tpu/runtime/native.py``.  The library is the
repo's own backend-neutral C++ source, the one the JAX package builds:
idx (MNIST) and CSV record parsing, baseline-JPEG and PNM decoding, a
nearest-neighbour resize, a threaded shuffled-minibatch producer
(:class:`NativeBatcher`) and a disk-backed byte queue
(:class:`DiskBasedQueue`), behind a C ABI bound here with ``ctypes``.

**The build.**  The port never writes under ``native/`` (that directory
and its library belong to the JAX package).  At first use
:func:`get_lib` compiles ``native/dl4j_native.cpp`` with ``g++ -O3
-fPIC -std=c++17 -shared -pthread`` (``native/Makefile``'s flags) into
``build/native/`` at the repo root (gitignored), named by a hash of the
source and the flags, so an edited source is rebuilt.  The compile runs
under a file lock and writes a temporary name that ``os.replace``
renames, so processes building at once (test workers) load a whole
library.  A failed build is logged with the compiler's stderr.

Every consumer keeps the reference's pure-Python path for a machine
without the library (:func:`available` says which runs): the wrappers
return None, and :class:`NativeBatcher` / :class:`DiskBasedQueue` raise
``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "dl4j_native.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
#: the last failed build's compiler output (None after a good build)
build_error: Optional[str] = None

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_longp = ctypes.POINTER(ctypes.c_long)
_u8p = ctypes.POINTER(ctypes.c_ubyte)


def library_path() -> Path:
    """The library's path, named by a hash of the source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdl4j_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library into ``build/native/`` unless it is there;
    returns its path.  Raises ``RuntimeError`` carrying the compiler's
    output when ``g++`` fails or is missing."""
    import fcntl

    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "a") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)       # closing the file drops it
        if out.exists():                        # another process built it
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    lib.dl4j_parse_idx_images.restype = ctypes.c_long
    lib.dl4j_parse_idx_images.argtypes = [ctypes.c_char_p, _f32p,
                                          ctypes.c_long]
    lib.dl4j_parse_idx_images_u8.restype = ctypes.c_long
    lib.dl4j_parse_idx_images_u8.argtypes = [ctypes.c_char_p, _u8p,
                                             ctypes.c_long]
    lib.dl4j_idx_image_dims.restype = ctypes.c_long
    lib.dl4j_idx_image_dims.argtypes = [ctypes.c_char_p, _longp]
    lib.dl4j_idx_label_count.restype = ctypes.c_long
    lib.dl4j_idx_label_count.argtypes = [ctypes.c_char_p]
    lib.dl4j_parse_idx_labels.restype = ctypes.c_long
    lib.dl4j_parse_idx_labels.argtypes = [ctypes.c_char_p, _i32p,
                                          ctypes.c_long]
    lib.dl4j_parse_csv.restype = ctypes.c_long
    lib.dl4j_parse_csv.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                   ctypes.c_long, ctypes.c_long, _f32p,
                                   ctypes.c_long]
    lib.dl4j_csv_dims.restype = ctypes.c_long
    lib.dl4j_csv_dims.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                  ctypes.c_long, _longp]
    lib.dl4j_batcher_create.restype = ctypes.c_void_p
    lib.dl4j_batcher_create.argtypes = [_f32p, _f32p, ctypes.c_long,
                                        ctypes.c_long, ctypes.c_long,
                                        ctypes.c_long, ctypes.c_uint64,
                                        ctypes.c_int, ctypes.c_long]
    lib.dl4j_batcher_next.restype = ctypes.c_long
    lib.dl4j_batcher_next.argtypes = [ctypes.c_void_p, _f32p, _f32p]
    lib.dl4j_batcher_batches_per_epoch.restype = ctypes.c_long
    lib.dl4j_batcher_batches_per_epoch.argtypes = [ctypes.c_void_p]
    lib.dl4j_batcher_destroy.restype = None
    lib.dl4j_batcher_destroy.argtypes = [ctypes.c_void_p]
    lib.dl4j_diskqueue_create.restype = ctypes.c_void_p
    lib.dl4j_diskqueue_create.argtypes = [ctypes.c_char_p]
    lib.dl4j_diskqueue_push.restype = ctypes.c_long
    lib.dl4j_diskqueue_push.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_long]
    lib.dl4j_diskqueue_peek_size.restype = ctypes.c_long
    lib.dl4j_diskqueue_peek_size.argtypes = [ctypes.c_void_p]
    lib.dl4j_diskqueue_pop.restype = ctypes.c_long
    lib.dl4j_diskqueue_pop.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_long]
    lib.dl4j_diskqueue_size.restype = ctypes.c_long
    lib.dl4j_diskqueue_size.argtypes = [ctypes.c_void_p]
    lib.dl4j_diskqueue_destroy.restype = None
    lib.dl4j_diskqueue_destroy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dl4j_pnm_info.restype = ctypes.c_int
    lib.dl4j_pnm_info.argtypes = [_u8p, ctypes.c_long, _longp, _longp]
    lib.dl4j_pnm_decode.restype = ctypes.c_int
    lib.dl4j_pnm_decode.argtypes = [_u8p, ctypes.c_long, _f32p]
    lib.dl4j_jpeg_info.restype = ctypes.c_int
    lib.dl4j_jpeg_info.argtypes = [_u8p, ctypes.c_long, _longp, _longp]
    lib.dl4j_jpeg_decode.restype = ctypes.c_int
    lib.dl4j_jpeg_decode.argtypes = [_u8p, ctypes.c_long, _f32p]
    lib.dl4j_resize_nearest.restype = None
    lib.dl4j_resize_nearest.argtypes = [_f32p, ctypes.c_long,
                                        ctypes.c_long, _f32p,
                                        ctypes.c_long]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built on the first call; None when it
    cannot be built or loaded (the failure is logged once, with the
    compiler's stderr, and kept in :data:`build_error`)."""
    global _lib, _lib_failed, build_error
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
        except (RuntimeError, OSError, AttributeError) as e:
            build_error = str(e)
            log.warning("native library unavailable, using the Python "
                        "paths: %s", e)
            _lib_failed = True
            return None
        _lib, build_error = lib, None
        return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# parsing wrappers
# ---------------------------------------------------------------------------

def _idx_image_dims(lib, path: str):
    dims = (ctypes.c_long * 3)()
    if lib.dl4j_idx_image_dims(path.encode(), dims) != 0:
        raise ValueError(f"{path}: not an idx3 image file")
    return dims[0], dims[1], dims[2]


def parse_idx_images(path: str) -> Optional[np.ndarray]:
    """float32 [N, rows*cols] in [0,1], or None if native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n, rows, cols = _idx_image_dims(lib, path)
    out = np.empty(n * rows * cols, dtype=np.float32)
    got = lib.dl4j_parse_idx_images(path.encode(),
                                    out.ctypes.data_as(_f32p), out.size)
    if got != n:
        raise ValueError(f"{path}: idx parse failed (code {got})")
    return out.reshape(n, rows * cols)


def parse_idx_images_u8(path: str) -> Optional[np.ndarray]:
    """Raw uint8 [N, rows, cols] — no conversion (cheapest load path)."""
    lib = get_lib()
    if lib is None:
        return None
    n, rows, cols = _idx_image_dims(lib, path)
    out = np.empty(n * rows * cols, dtype=np.uint8)
    got = lib.dl4j_parse_idx_images_u8(path.encode(),
                                       out.ctypes.data_as(_u8p), out.size)
    if got != n:
        raise ValueError(f"{path}: idx parse failed (code {got})")
    return out.reshape(n, rows, cols)


def parse_idx_labels(path: str) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    n = lib.dl4j_idx_label_count(path.encode())
    if n < 0:
        raise ValueError(f"{path}: not an idx1 label file (code {n})")
    out = np.empty(max(n, 1), dtype=np.int32)
    got = lib.dl4j_parse_idx_labels(path.encode(),
                                    out.ctypes.data_as(_i32p), out.size)
    if got < 0:
        raise ValueError(f"{path}: idx label parse failed (code {got})")
    return out[:got]


def parse_csv(path: str, sep: str = ",",
              skip_header: int = 0) -> Optional[np.ndarray]:
    """float32 [rows, cols], or None if native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    dims = (ctypes.c_long * 2)()
    if lib.dl4j_csv_dims(path.encode(), sep.encode()[0:1],
                         skip_header, dims) != 0:
        raise ValueError(f"{path}: cannot open")
    rows, cols = dims[0], dims[1]
    out = np.empty((max(rows, 1), cols), dtype=np.float32)
    got = lib.dl4j_parse_csv(path.encode(), sep.encode()[0:1], skip_header,
                             cols, out.ctypes.data_as(_f32p), rows)
    if got < 0:
        raise ValueError(f"{path}: csv parse failed (code {got})")
    return out[:got]


# ---------------------------------------------------------------------------
# image decoders
# ---------------------------------------------------------------------------

def decode_pnm(data: bytes) -> Optional[np.ndarray]:
    """Native PNM -> grayscale float32 [H, W] in [0, 1]; None when the
    library is unavailable or the buffer is not PNM (callers fall back
    to the Python decoder in utils/image.py)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    w = ctypes.c_long()
    h = ctypes.c_long()
    if lib.dl4j_pnm_info(buf.ctypes.data_as(_u8p), buf.size,
                         ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    channels = 3 if data[1:2] in (b"3", b"6") else 1
    # untrusted header: a sample needs >= 1 byte (binary) / >= 2 bytes
    # (ascii), so dims implying more pixels than the buffer could hold
    # are corrupt — refuse BEFORE allocating h*w floats
    if w.value * h.value * channels > buf.size:
        return None
    out = np.empty((h.value, w.value), np.float32)
    if lib.dl4j_pnm_decode(buf.ctypes.data_as(_u8p), buf.size,
                           out.ctypes.data_as(_f32p)) != 0:
        return None
    return out


def _scan_tables_in_range(data: bytes) -> bool:
    """False when the first SOS header names a Huffman table id above 3.

    The C decoder (``native/dl4j_native.cpp``, its SOS case) stores the
    scan's DC/AC table selectors unchecked and then indexes its four
    tables with them, so a corrupt selector reads past the tables and
    can crash the process.  The source is shared with the JAX package,
    so the bound is checked here, on the same segment walk as the C
    header parser; any other malformation is left to the C decoder."""
    n, i = len(data), 2
    while i + 4 <= n:
        if data[i] != 0xFF:
            return True
        m = data[i + 1]
        i += 2
        if m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        seg_len = (data[i] << 8) | data[i + 1]
        if seg_len < 2 or i + seg_len > n:
            return True
        seg, seg_end = i + 2, i + seg_len
        if m == 0xDA:
            if seg >= seg_end:
                return True
            ns = data[seg]
            if seg + 1 + 2 * ns > seg_end:
                return True
            return all(data[seg + 2 + 2 * s] >> 4 <= 3
                       and data[seg + 2 + 2 * s] & 15 <= 3
                       for s in range(ns))
        i = seg_end
    return True


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """Native baseline-JPEG -> grayscale float32 [H, W] in [0, 1] (the Y
    channel == BT.601 luma, what PIL's convert("L") computes); None when
    the library is unavailable or the file is an unsupported flavor
    (progressive / 12-bit): callers fall back to PIL in utils/image.py."""
    lib = get_lib()
    if lib is None or not _scan_tables_in_range(data):
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    w = ctypes.c_long()
    h = ctypes.c_long()
    if lib.dl4j_jpeg_info(buf.ctypes.data_as(_u8p), buf.size,
                          ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    # untrusted header: cap the allocation (64 MPix ~ 256 MB float32)
    if w.value * h.value > (1 << 26):
        return None
    out = np.empty((h.value, w.value), np.float32)
    if lib.dl4j_jpeg_decode(buf.ctypes.data_as(_u8p), buf.size,
                            out.ctypes.data_as(_f32p)) != 0:
        return None
    return out


def resize_nearest(img: np.ndarray, size: int) -> Optional[np.ndarray]:
    """Native nearest-neighbour resize to [size, size]; None without the
    library."""
    lib = get_lib()
    if lib is None or img.shape[0] == 0 or img.shape[1] == 0 or size <= 0:
        return None
    img = np.ascontiguousarray(img, np.float32)
    out = np.empty((size, size), np.float32)
    lib.dl4j_resize_nearest(img.ctypes.data_as(_f32p), img.shape[0],
                            img.shape[1], out.ctypes.data_as(_f32p), size)
    return out


# ---------------------------------------------------------------------------
# threaded batch assembler
# ---------------------------------------------------------------------------

class NativeBatcher:
    """Shuffled minibatch stream assembled by a native producer thread.

    Overlaps host-side batch gather with device compute: ``next()`` usually
    returns a pre-assembled batch from the ring buffer.  The fallback is
    the caller's (``datasets/iterator.NativeBatchIterator``): with the
    library unavailable the constructor raises ``RuntimeError``.
    """

    def __init__(self, features: np.ndarray, labels: np.ndarray,
                 batch_size: int, seed: int = 0, shuffle: bool = True,
                 capacity: int = 4):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        # keep alive: the native side borrows these buffers
        self._x = np.ascontiguousarray(features, dtype=np.float32)
        self._y = np.ascontiguousarray(labels, dtype=np.float32)
        if self._y.ndim == 1:
            self._y = self._y[:, None]
        n, dx = self._x.shape
        dy = self._y.shape[1]
        self.batch_size = int(batch_size)
        self.dx, self.dy = dx, dy
        self._handle = lib.dl4j_batcher_create(
            self._x.ctypes.data_as(_f32p), self._y.ctypes.data_as(_f32p),
            n, dx, dy, self.batch_size, seed, int(shuffle), capacity)
        if not self._handle:
            raise RuntimeError("batcher creation failed")
        self.batches_per_epoch = lib.dl4j_batcher_batches_per_epoch(
            self._handle)

    def next(self):
        ox = np.empty((self.batch_size, self.dx), dtype=np.float32)
        oy = np.empty((self.batch_size, self.dy), dtype=np.float32)
        rc = self._lib.dl4j_batcher_next(self._handle,
                                         ox.ctypes.data_as(_f32p),
                                         oy.ctypes.data_as(_f32p))
        if rc != 0:
            raise RuntimeError("batcher stopped")
        return ox, oy

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.dl4j_batcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# disk-backed queue (util/DiskBasedQueue.java parity)
# ---------------------------------------------------------------------------

class DiskBasedQueue:
    """FIFO of byte records spilled to a backing file — for streams larger
    than memory (the reference buffers sentence/work streams this way)."""

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = lib.dl4j_diskqueue_create(path.encode())
        if not self._handle:
            raise RuntimeError(f"cannot create disk queue at {path}")

    def push(self, data: bytes) -> None:
        buf = (ctypes.c_ubyte * len(data)).from_buffer_copy(data)
        if self._lib.dl4j_diskqueue_push(self._handle, buf, len(data)) != 0:
            raise IOError("disk queue write failed")

    def pop(self) -> Optional[bytes]:
        size = self._lib.dl4j_diskqueue_peek_size(self._handle)
        if size < 0:
            return None
        buf = (ctypes.c_ubyte * max(size, 1))()
        got = self._lib.dl4j_diskqueue_pop(self._handle, buf, max(size, 1))
        if got < 0:
            raise IOError(f"disk queue read failed (code {got})")
        return bytes(buf[:got])

    def __len__(self) -> int:
        return self._lib.dl4j_diskqueue_size(self._handle)

    def close(self, unlink: bool = True) -> None:
        if getattr(self, "_handle", None):
            self._lib.dl4j_diskqueue_destroy(self._handle, int(unlink))
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
