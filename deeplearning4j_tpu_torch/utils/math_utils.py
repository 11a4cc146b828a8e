"""Math helpers — ``util/MathUtils.java`` + ``util/SummaryStatistics.java``
parity (the subset with real call sites / clear semantics; pure-numpy,
host-side: these feed preprocessing and reporting, not the device path).

Port of ``deeplearning4j_tpu/utils/math_utils.py``: a copy (numpy only).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, dtype=np.float64)))


def entropy(probs: Sequence[float]) -> float:
    """Shannon entropy in nats over a probability vector."""
    p = np.asarray(probs, dtype=np.float64)
    p = p[p > 0]
    return float(-np.sum(p * np.log(p)))


def information_gain(parent: Sequence[float],
                     children: Sequence[Sequence[float]],
                     weights: Sequence[float]) -> float:
    """H(parent) - Σ w_i · H(child_i)."""
    gain = entropy(parent)
    for w, c in zip(weights, children):
        gain -= float(w) * entropy(c)
    return gain


def euclidean_distance(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, float) - np.asarray(b, float)))


def manhattan_distance(a, b) -> float:
    return float(np.sum(np.abs(np.asarray(a, float) - np.asarray(b, float))))


def cosine_similarity(a, b) -> float:
    a = np.asarray(a, float).ravel()
    b = np.asarray(b, float).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(a @ b / (na * nb))


def correlation(x, y) -> float:
    """Pearson r (MathUtils.correlation)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    sx, sy = x.std(), y.std()
    if sx == 0 or sy == 0:
        return 0.0
    return float(((x - x.mean()) * (y - y.mean())).mean() / (sx * sy))


def normalize(x, low: float = 0.0, high: float = 1.0):
    """Min-max rescale into [low, high] (MathUtils.normalize)."""
    x = np.asarray(x, dtype=np.float64)
    lo, hi = x.min(), x.max()
    if hi == lo:
        return np.full_like(x, (low + high) / 2.0)
    return (x - lo) / (hi - lo) * (high - low) + low


def next_power_of_2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


def round_to_nearest(value: float, nearest: float) -> float:
    return round(value / nearest) * nearest


def clamp(value: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, value))


def log2(x: float) -> float:
    return math.log2(x)


@dataclasses.dataclass
class SummaryStatistics:
    """util/SummaryStatistics.java parity: one-line numeric summary."""

    mean: float
    sum: float
    min: float
    max: float
    std: float
    n: int

    @staticmethod
    def of(values) -> "SummaryStatistics":
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return SummaryStatistics(0.0, 0.0, 0.0, 0.0, 0.0, 0)
        return SummaryStatistics(mean=float(v.mean()), sum=float(v.sum()),
                                 min=float(v.min()), max=float(v.max()),
                                 std=float(v.std()), n=int(v.size))

    def __str__(self) -> str:
        return (f"n={self.n} mean={self.mean:.6g} sum={self.sum:.6g} "
                f"min={self.min:.6g} max={self.max:.6g} std={self.std:.6g}")


def summary_stats(values) -> str:
    return str(SummaryStatistics.of(values))


def moving_average(x, n: int):
    """Per-row moving average of window length ``n`` over the last axis
    (``util/TimeSeriesUtils.java:movingAverage`` — cumsum formulation).
    [..., C] -> [..., C - n + 1]."""
    v = np.asarray(x, dtype=np.float64)
    cs = np.cumsum(v, axis=-1)
    head = cs[..., n - 1:n]                      # first full window sum
    rest = cs[..., n:] - cs[..., :-n]
    return np.concatenate([head, rest], axis=-1) / float(n)


def moving_window_matrix(x, window_rows: int, window_cols: int,
                         add_rotate: bool = False, flattened: bool = False):
    """Consecutive flat (window_rows x window_cols) chunks of a matrix
    (``util/MovingWindowMatrix.java:windows`` semantics: the flattened
    input is sliced into window-area chunks; ``add_rotate`` appends the
    three rot90 orientations of each window before it)."""
    flat = np.asarray(x).ravel()
    area = window_rows * window_cols
    out = []
    for lo in range(0, flat.size - area + 1, area):
        # copy: the reference returns independent windows; a view here
        # would alias the caller's matrix through every returned window
        win = flat[lo:lo + area].reshape(window_rows, window_cols).copy()
        if add_rotate:
            cur = win
            for _ in range(3):
                cur = np.rot90(cur)
                out.append(cur.ravel() if flattened else cur.copy())
        out.append(win.ravel() if flattened else win)
    return out
