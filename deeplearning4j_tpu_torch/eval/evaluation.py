"""Evaluation and ConfusionMatrix: port of
``deeplearning4j_tpu/eval/evaluation.py`` (``eval/Evaluation.java:29``
and ``eval/ConfusionMatrix.java`` in the reference).

``eval(real, guess)`` fills the confusion matrix (rows actual, columns
the argmax of the guess); ``accuracy``, ``precision``, ``recall``,
``f1`` and ``stats()`` read it.  Counting runs on the host in numpy
(one matrix product of one-hot rows, as the reference's device kernel
computes): a guess moves to the host once per ``eval`` call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def confusion_counts(labels_1hot: np.ndarray,
                     guesses: np.ndarray) -> np.ndarray:
    """``labels^T . one_hot(argmax(guesses))`` as int64 counts; an
    all-zero label row counts toward nothing."""
    c = labels_1hot.shape[-1]
    preds = np.argmax(guesses, axis=-1)
    preds_1hot = (preds[:, None] == np.arange(c)).astype(np.float64)
    return (labels_1hot.astype(np.float64).T @ preds_1hot).astype(np.int64)


class ConfusionMatrix:
    """Generic count matrix: rows = actual, cols = predicted."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.counts = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1) -> None:
        self.counts[actual, predicted] += count

    def add_matrix(self, counts: np.ndarray) -> None:
        self.counts += counts.astype(np.int64)

    def count(self, actual: int, predicted: int) -> int:
        return int(self.counts[actual, predicted])

    def actual_total(self, actual: int) -> int:
        return int(self.counts[actual].sum())

    def predicted_total(self, predicted: int) -> int:
        return int(self.counts[:, predicted].sum())

    def total(self) -> int:
        return int(self.counts.sum())

    def __repr__(self):
        return f"ConfusionMatrix({self.num_classes} classes, n={self.total()})"


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None):
        self.num_classes = num_classes
        self.confusion: Optional[ConfusionMatrix] = None

    def _ensure(self, n: int) -> ConfusionMatrix:
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = ConfusionMatrix(self.num_classes)
        return self.confusion

    # -- accumulation (eval:46 parity) -------------------------------------
    def eval(self, real_outcomes, guesses) -> None:
        """real_outcomes: one-hot [N, C] (or int labels [N]);
        guesses: probabilities/one-hot [N, C]; numpy or tensors."""
        real = _host(real_outcomes)
        guess = _host(guesses)
        if real.ndim == 1:
            # one_hot semantics, host-side: out-of-range labels (e.g. a
            # -1 ignore/padding label) become all-zero rows that count
            # toward nothing — np.eye fancy-indexing would silently wrap
            # negatives to class C-1 and crash on labels >= C
            idx = real.astype(np.int64)
            c = guess.shape[-1]
            onehot = np.zeros((idx.shape[0], c), np.float32)
            valid = (idx >= 0) & (idx < c)
            onehot[np.nonzero(valid)[0], idx[valid]] = 1.0
            real = onehot
        cm = self._ensure(real.shape[-1])
        cm.add_matrix(confusion_counts(real.astype(np.float32),
                                       guess.astype(np.float32)))

    # -- per-class counters ------------------------------------------------
    def true_positives(self, i: int) -> int:
        return self.confusion.count(i, i)

    def false_positives(self, i: int) -> int:
        return self.confusion.predicted_total(i) - self.confusion.count(i, i)

    def false_negatives(self, i: int) -> int:
        return self.confusion.actual_total(i) - self.confusion.count(i, i)

    def true_negatives(self, i: int) -> int:
        return (self.confusion.total() - self.confusion.actual_total(i)
                - self.false_positives(i))

    # -- metrics -----------------------------------------------------------
    def accuracy(self) -> float:
        cm = self.confusion
        return float(np.trace(cm.counts) / max(cm.total(), 1))

    def precision(self, i: Optional[int] = None) -> float:
        if i is not None:
            tp, fp = self.true_positives(i), self.false_positives(i)
            return tp / (tp + fp) if tp + fp else 0.0
        return float(np.mean([self.precision(c)
                              for c in range(self.confusion.num_classes)]))

    def recall(self, i: Optional[int] = None) -> float:
        if i is not None:
            tp, fn = self.true_positives(i), self.false_negatives(i)
            return tp / (tp + fn) if tp + fn else 0.0
        return float(np.mean([self.recall(c)
                              for c in range(self.confusion.num_classes)]))

    def f1(self, i: Optional[int] = None) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if p + r else 0.0

    # -- quantization acceptance (the reference's :170-187) ----------------
    def accuracy_delta(self, other: "Evaluation") -> float:
        """|accuracy(self) - accuracy(other)|: the quantized-against-fp32
        number a serving rollout holds (both evaluated on the same
        labels)."""
        return abs(self.accuracy() - other.accuracy())

    def assert_accuracy_within(self, other: "Evaluation", tol: float,
                               label: str = "quantized") -> float:
        """The accuracy delta against ``other``, which must be within
        ``tol``; beyond it, an ``AssertionError`` that names both
        accuracies."""
        delta = self.accuracy_delta(other)
        if delta > tol:
            raise AssertionError(
                f"{label} accuracy delta {delta:.4f} exceeds tolerance "
                f"{tol} (reference {self.accuracy():.4f} vs {label} "
                f"{other.accuracy():.4f})")
        return delta

    # -- report (stats():97 parity) ----------------------------------------
    def stats(self) -> str:
        cm = self.confusion
        lines = ["==========================Scores=====================================",
                 f" Accuracy:  {self.accuracy():.4f}",
                 f" Precision: {self.precision():.4f}",
                 f" Recall:    {self.recall():.4f}",
                 f" F1 Score:  {self.f1():.4f}",
                 "====================================================================="]
        lines.append("Confusion matrix (rows=actual, cols=predicted):")
        lines.append(str(cm.counts))
        return "\n".join(lines)
