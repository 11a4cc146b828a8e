"""Persistent attention autotuner.

Port of ``deeplearning4j_tpu/runtime/autotune.py``.  Whether the hand
flash-attention kernels (B1-B3, ``ops/flash_attention.py``) beat the
plain PyTorch attention is a per-(card, shape) question.  This module
settles it once per card and shape bucket and remembers the answer:

- :func:`sweep_attention` times, forward and backward (the training
  shape of the op), the port's plain attention
  (``models/transformer.attention``, the reference's ``"xla"``
  candidate) against the hand kernel (``"cuda"``), picks the faster and
  persists it.  The kernels have fixed tiles (B1-B3 share the 64-key
  causal tile of ``csrc/flash_common.cuh``), so unlike the reference's
  sweep there are no block-size candidates; the record says so.  A
  library attention (``scaled_dot_product_attention``, cuDNN) is never a
  candidate.  On the CPU only the plain candidate is timed (the kernel
  runs only on CUDA tensors);
- winners land in an on-disk JSON cache
  (``$DL4J_TPU_TORCH_AUTOTUNE_CACHE``, default
  ``~/.cache/dl4j_tpu_torch_autotune/attention.json``; the reference's
  variable and directory are never read, so a TPU verdict never routes
  the card) keyed by the card's name, power-of-two buckets of the rows
  (batch x heads) and of the sequence lengths, head dim and causality:
  a verdict taken at one batch and head count never routes a shape with
  many times the rows.  The sweep's batch and head count are always
  given by the caller.  Writes are atomic (tmp + ``os.replace``) and
  merge with concurrent writers under a file lock;
- :func:`lookup_attention` is what ``ops/flash_attention.make_attn_fn``
  consults, once per shape, when its caller opts in
  (``make_attn_fn(autotune=True)``; by default the attention takes the
  kernel for every shape it supports and reads no file): a cached
  winner then overrides that rule.  A warmed second process sweeps
  nothing: a consult is a host-side JSON read;
- :func:`measured_crossover` is the smallest key length at which the
  kernel won on this card, which ``ops/flash_attention.attention_auto``
  takes as its crossover.

Every sweep and consult books into ``runtime.metrics.mfu_metrics``
(``sweeps``, ``candidates_timed``, ``consults``, ``cache_hits``,
``cache_misses``, ``winners_persisted``).  None of the reference's TPU
constants (its block candidates, ``FLASH_MIN_SEQ``) carry over.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, Optional

import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.runtime.metrics import mfu_metrics

AUTOTUNE_CACHE_ENV = "DL4J_TPU_TORCH_AUTOTUNE_CACHE"

#: what the record says of block sizes: the kernels' tiles are fixed
FIXED_TILES = ("fixed: B1-B3 share the 64-key causal tile "
               "(csrc/flash_common.cuh)")

_LOCK = threading.RLock()
#: per-path in-process record memo: {path: {key: record}}; a warmed
#: process consults this dict, never the disk twice
_MEMO: Dict[str, Dict[str, Dict[str, Any]]] = {}


def cache_dir() -> Optional[str]:
    """The autotune cache directory: unset/empty or '1'/'true'/'on' ->
    the default under ``~/.cache``; '0'/'false'/'off' -> disabled
    (None); anything else is the directory (reference :65-75)."""
    v = (os.environ.get(AUTOTUNE_CACHE_ENV) or "").strip()
    if v.lower() in ("0", "false", "off"):
        return None
    if not v or v.lower() in ("1", "true", "on"):
        return os.path.join(os.path.expanduser("~"), ".cache",
                            "dl4j_tpu_torch_autotune")
    return os.path.expanduser(v)


def cache_path() -> Optional[str]:
    d = cache_dir()
    return os.path.join(d, "attention.json") if d else None


def reset_memo() -> None:
    """Drop the in-process record memo (a fresh process starts empty)."""
    with _LOCK:
        _MEMO.clear()


def shape_bucket(n: int, floor: int = 128) -> int:
    """Power-of-two shape bucket, at least ``floor``: a bounded key space
    over an unbounded shape space (floor 128 for sequence lengths, as the
    reference has it; floor 1 for the rows, batch x heads)."""
    return max(floor, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


def device_kind(device: DeviceLike = None) -> str:
    """The card's name (``torch.cuda.get_device_name``) for a CUDA
    device, ``"cpu"`` for the CPU; None means the first card where CUDA
    is available, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def attn_key(kind: str, q_bucket: int, k_bucket: int, head_dim: int,
             causal: bool, *, rows_bucket: int) -> str:
    """Canonical cache key: exactly what determines the verdict (the
    reference's fields and the rows' bucket after the card's name)."""
    return (f"attn|{kind}|r{rows_bucket}|q{q_bucket}|k{k_bucket}|"
            f"d{head_dim}|{'causal' if causal else 'full'}")


def _load(path: str) -> Dict[str, Dict[str, Any]]:
    """Read the cache file once per process (memoized).  A corrupt or
    missing file is an empty cache: tuning state must never break
    training."""
    with _LOCK:
        if path in _MEMO:
            return _MEMO[path]
    try:
        with open(path) as f:
            data = json.load(f)
        records = {k: v for k, v in data.items()
                   if isinstance(v, dict) and "impl" in v} \
            if isinstance(data, dict) else {}
    except (OSError, ValueError):
        records = {}
    with _LOCK:
        return _MEMO.setdefault(path, records)


def _persist(path: str, key: str, record: Dict[str, Any]) -> None:
    """Merge one winner into the on-disk cache atomically: re-read the
    file, write a temporary, ``os.replace``.  The read-merge-replace is
    serialized across processes by a sidecar ``flock`` (two sweeps
    banking different keys must not drop each other's winner) and
    across threads by the module lock."""
    import fcntl

    with _LOCK:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".lock", "a") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)   # closing the file drops it
            try:
                with open(path) as f:
                    on_disk = json.load(f)
                if not isinstance(on_disk, dict):
                    on_disk = {}
            except (OSError, ValueError):
                on_disk = {}
            on_disk[key] = record
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(on_disk, f, indent=2, sort_keys=True)
            os.replace(tmp, path)
        _MEMO.setdefault(path, {}).update(on_disk)
    mfu_metrics.note("winners_persisted")


def lookup_attention(q_len: int, k_len: int, head_dim: int, causal: bool,
                     *, rows: int, kind: Optional[str] = None
                     ) -> Optional[Dict[str, Any]]:
    """The persisted winner for this (card, shape bucket) at ``rows``
    (batch x heads), or None when nothing was swept or the cache is off.
    A host-side read."""
    path = cache_path()
    if path is None:
        return None
    mfu_metrics.note("consults")
    rec = _load(path).get(attn_key(kind or device_kind(),
                                   shape_bucket(q_len), shape_bucket(k_len),
                                   head_dim, causal,
                                   rows_bucket=shape_bucket(rows, 1)))
    mfu_metrics.note("cache_hits" if rec else "cache_misses")
    return rec


def measured_crossover(head_dim: int, causal: bool,
                       kind: Optional[str] = None) -> Optional[int]:
    """The measured kernel/plain crossover on a card (the reference's
    :188-207): the smallest swept key-length bucket at which the kernel
    (``impl == "cuda"``) won for head dim ``head_dim`` and this
    causality, over every rows bucket (a win at any batch x heads
    counts).  None when the cache is off or no sweep found a win.  The
    key's fields are read by their prefixes: the port's key carries the
    rows' bucket before the lengths (:func:`attn_key`)."""
    path = cache_path()
    if path is None:
        return None
    kind = kind or device_kind()
    want_tail = f"|d{head_dim}|{'causal' if causal else 'full'}"
    wins = []
    for key, rec in _load(path).items():
        if (key.startswith(f"attn|{kind}|") and key.endswith(want_tail)
                and rec.get("impl") == "cuda"):
            fields = [f for f in key[len(f"attn|{kind}|"):].split("|")
                      if f.startswith("k") and f[1:].isdigit()]
            if fields:
                wins.append(int(fields[0][1:]))
    return min(wins) if wins else None


def _time_candidate(fn, dev: torch.device, repeats: int) -> float:
    """Median milliseconds of ``fn()`` after one warm-up call: CUDA
    events around each call on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(max(repeats, 1)):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def sweep_attention(q_len: int, k_len: int, head_dim: int, causal: bool,
                    *, batch: int, n_heads: int,
                    dtype: torch.dtype = torch.bfloat16, repeats: int = 10,
                    persist: bool = True, device: DeviceLike = None,
                    seed: int = 0) -> Dict[str, Any]:
    """Time the plain attention and the hand kernel, forward and
    backward, on seeded random ``[batch, T, n_heads, head_dim]`` inputs
    on ``device`` (None means ``"cuda"``), and bank the faster under the
    bucket of ``batch * n_heads`` rows (the caller names the shape it
    will train or serve: there is no default batch).  Returns
    the winner record (persisted unless ``persist=False`` or the cache
    is off)."""
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    dev = resolve_device(device)
    kind = device_kind(dev)
    key = attn_key(kind, shape_bucket(q_len), shape_bucket(k_len),
                   head_dim, causal,
                   rows_bucket=shape_bucket(batch * n_heads, 1))
    mfu_metrics.note("sweeps")

    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((batch, t, n_heads, head_dim), generator=gen)
               .to(dev, dtype).requires_grad_(True)
               for t in (q_len, k_len, k_len))

    def fwd_bwd(attn):
        def run():
            out = attn(q, k, v, None, causal)
            return torch.autograd.grad(out.float().sum(), (q, k, v))
        return run

    candidates: Dict[str, Dict[str, Any]] = {}
    names = {"plain": tfm.attention}
    if dev.type == "cuda" and fa.kernel_supports(q_len, k_len, head_dim,
                                                 dtype):
        names["cuda"] = fa.flash_attention
    for name, attn in names.items():
        mfu_metrics.note("candidates_timed")
        try:
            ms = _time_candidate(fwd_bwd(attn), dev, repeats)
            candidates[name] = {"impl": name, "step_ms": round(ms, 4)}
        except torch.cuda.OutOfMemoryError as e:  # plain attention at long T
            candidates[name] = {"impl": name, "error": repr(e)[:200]}
    timed = [c for c in candidates.values() if "step_ms" in c]
    if not timed:
        raise RuntimeError(
            f"autotune sweep {key}: every candidate failed "
            f"({ {n: c.get('error') for n, c in candidates.items()} })")
    best = min(timed, key=lambda c: c["step_ms"])
    record = {
        "key": key, "impl": best["impl"], "step_ms": best["step_ms"],
        "device_kind": kind, "head_dim": head_dim, "causal": causal,
        "rows_bucket": shape_bucket(batch * n_heads, 1),
        "q_bucket": shape_bucket(q_len), "k_bucket": shape_bucket(k_len),
        "shape": [batch, q_len, k_len, n_heads, head_dim],
        "dtype": str(dtype).replace("torch.", ""),
        "blocks": FIXED_TILES,
        "swept_at": time.time(),
        "candidates": candidates,
    }
    path = cache_path()
    if persist and path is not None:
        _persist(path, key, record)
    elif path is not None:
        with _LOCK:
            _MEMO.setdefault(path, {})[key] = record
    return record


def ensure_attention(q_len: int, k_len: int, head_dim: int, causal: bool,
                     *, batch: int, n_heads: int,
                     **sweep_kwargs) -> Dict[str, Any]:
    """Consult or sweep: the cached winner when there is one, else one
    sweep (persisted), so a call site that ensures at start-up never
    sweeps twice for a shape."""
    dev = resolve_device(sweep_kwargs.get("device"))
    rec = lookup_attention(q_len, k_len, head_dim, causal,
                           rows=batch * n_heads, kind=device_kind(dev))
    if rec is not None:
        return rec
    return sweep_attention(q_len, k_len, head_dim, causal, batch=batch,
                           n_heads=n_heads, **sweep_kwargs)
