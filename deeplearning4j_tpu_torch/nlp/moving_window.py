"""Moving-window featurization for sequence labeling.

Reference parity: ``text/movingwindow/{Window,Windows,WindowConverter,
WordConverter}.java`` — slide a fixed window over a token sequence, embed
each window as the concatenation of its word vectors, classify the center
token, then decode the label sequence with ``utils/viterbi``.

Port of ``deeplearning4j_tpu/nlp/moving_window.py``: the windows and
their features are the reference's host numpy code, copied;
``Word2VecDataSetIterator``'s batches are the port's ``DataSet``s of
fp32 tensors on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory

PAD = "<PAD>"


@dataclasses.dataclass
class Window:
    """One window (Window.java parity): tokens with the focus word in the
    middle, padded at sequence edges."""
    words: List[str]
    focus_index: int
    begin: int
    end: int

    @property
    def focus(self) -> str:
        return self.words[self.focus_index]


def windows(tokens_or_text, window_size: int = 5,
            tokenizer=None) -> List[Window]:
    """All center-aligned windows over a sentence (Windows.java parity).
    ``window_size`` must be odd (a center word needs symmetric context)."""
    if window_size % 2 == 0:
        raise ValueError(f"window_size must be odd, got {window_size}")
    if isinstance(tokens_or_text, str):
        tokenizer = tokenizer or DefaultTokenizerFactory()
        tokens = tokenizer.create(tokens_or_text)
    else:
        tokens = list(tokens_or_text)
    half = window_size // 2
    out = []
    for i in range(len(tokens)):
        ws = []
        for j in range(i - half, i + half + 1):
            ws.append(tokens[j] if 0 <= j < len(tokens) else PAD)
        out.append(Window(words=ws, focus_index=half,
                          begin=max(i - half, 0),
                          end=min(i + half, len(tokens) - 1)))
    return out


class WindowConverter:
    """Window -> concatenated word-vector features (WindowConverter.java).

    Uses a WordVectors-like object (``word_vector(w)`` + ``dim``); unknown
    words and PAD map to zeros.
    """

    def __init__(self, word_vectors):
        self.wv = word_vectors

    def to_features(self, window: Window) -> np.ndarray:
        d = self.wv.dim
        parts = []
        for w in window.words:
            vec = None if w == PAD else self.wv.word_vector(w)
            parts.append(np.zeros(d, np.float32) if vec is None
                         else np.asarray(vec, np.float32))
        return np.concatenate(parts)

    def to_matrix(self, wins: Sequence[Window]) -> np.ndarray:
        return np.stack([self.to_features(w) for w in wins])


def sentence_features(text_or_tokens, word_vectors, window_size: int = 5,
                      tokenizer=None) -> np.ndarray:
    """[T, window_size*dim] feature matrix for a whole sentence — the input
    to a per-position classifier whose outputs feed utils/viterbi.decode."""
    wins = windows(text_or_tokens, window_size, tokenizer)
    return WindowConverter(word_vectors).to_matrix(wins)


class Word2VecDataSetIterator:
    """Labeled windows -> DataSets (models/word2vec/iterator/
    Word2VecDataSetIterator.java parity): each window of a labeled
    sentence becomes (concatenated word vectors, one-hot label of the
    focus token) — the featurization feeding a per-position classifier
    (+ utils/viterbi for decoding).
    """

    def __init__(self, word_vectors, labeled_sentences, labels: Sequence[str],
                 batch_size: int = 32, window_size: int = 5,
                 tokenizer=None, device: DeviceLike = None):
        """labeled_sentences: iterable of (tokens_or_text, token_labels)."""
        import torch

        from deeplearning4j_tpu_torch.datasets.dataset import DataSet

        self.labels = list(labels)
        label_ix = {l: i for i, l in enumerate(self.labels)}
        conv = WindowConverter(word_vectors)
        feats, ys = [], []
        for sent, sent_labels in labeled_sentences:
            wins = windows(sent, window_size, tokenizer)
            if len(wins) != len(sent_labels):
                raise ValueError(
                    f"{len(sent_labels)} labels for {len(wins)} tokens")
            for w, lab in zip(wins, sent_labels):
                feats.append(conv.to_features(w))
                ys.append(label_ix[lab])
        dev = resolve_device(device)
        x = torch.from_numpy(np.stack(feats)).to(dev)
        y = torch.from_numpy(np.eye(len(self.labels), dtype=np.float32)[
            np.asarray(ys)]).to(dev)
        self._batches = [
            DataSet(x[i:i + batch_size], y[i:i + batch_size])
            for i in range(0, len(x), batch_size)]
        self._cursor = 0

    def has_next(self) -> bool:
        return self._cursor < len(self._batches)

    def next(self):
        ds = self._batches[self._cursor]
        self._cursor += 1
        return ds

    def reset(self) -> None:
        self._cursor = 0

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()
