"""Build and load the port's hand-written CUDA kernels.

Each source under ``deeplearning4j_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
and loaded with ``ctypes`` (no PyTorch headers: a build takes seconds,
not minutes).  Libraries land in ``build/kernels/`` at the repo root
(gitignored), named by a hash of the source and flags, so an edited
source is rebuilt and an unchanged one is reused.  Nothing is built when
this module is imported: the first kernel call, or :func:`build`, does
it.  The JAX package has no counterpart (Pallas compiles inside XLA).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: kernel library name -> source file under csrc/
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "w2v_chunk": "word2vec_chunk.cu", "glove_chunk": "glove_chunk.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_scratch_bytes: Dict[tuple, int] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the
    ``nvcc`` on PATH; raises when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels are compiled at first use")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers under csrc/ and the flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds
    each build took (0.0 for one already on disk).  ``nvcc``'s
    ``-Xptxas -v`` report (registers, shared memory, spills) is kept
    beside each library as ``<lib>.log``."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)     # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib


def bind(name: str, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """:func:`load`, with each named entry point's ``argtypes`` set, an
    ``int`` (``cudaError_t``) result, and ``<name>_error_string``."""
    lib = load(name)
    for fn, types in argtypes.items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
    err_string = getattr(lib, f"{name}_error_string")
    err_string.argtypes = [ctypes.c_int]
    err_string.restype = ctypes.c_char_p
    return lib


def scratch(lib: ctypes.CDLL, fn: str, device, *shape):
    """A kernel's scratch buffer for these shapes: a ``torch.uint8``
    tensor on ``device`` of the bytes ``lib.<fn>(*shape)`` (a ``size_t``
    function of the library) asks for, asked once per shape and taken
    from PyTorch's caching allocator (256-byte aligned) each call."""
    import torch

    key = (fn,) + shape
    nbytes = _scratch_bytes.get(key)
    if nbytes is None:
        sizer = getattr(lib, fn)
        sizer.argtypes = [ctypes.c_int] * len(shape)
        sizer.restype = ctypes.c_size_t
        nbytes = _scratch_bytes[key] = sizer(*shape)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def raise_on_error(lib: ctypes.CDLL, name: str, fn: str, err: int) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} ({err})")
