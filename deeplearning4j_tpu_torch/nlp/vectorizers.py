"""Bag-of-words / TF-IDF vectorization + inverted index.

Reference parity: ``bagofwords/vectorizer/{TfidfVectorizer,
BagOfWordsVectorizer}.java`` over ``InvertedIndex``
(text/invertedindex/LuceneInvertedIndex.java — Lucene replaced by a plain
in-memory posting-list index; the capability is the contract, not Lucene).

Output matrices are fp32 tensors [n_docs, V] on the vectorizer's device,
ready for model input (the reference feeds these to MultiLayerNetwork
classifiers).  The counts and the TF-IDF weights stay host numpy until
that last upload, as in the reference.

Port of ``deeplearning4j_tpu/nlp/vectorizers.py``: ``transform`` returns
a tensor on ``device`` where the reference returns a device array.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class InvertedIndex:
    """word -> posting list of (doc_id, positions)."""

    def __init__(self):
        self.postings: Dict[str, List[Tuple[int, List[int]]]] = defaultdict(list)
        self.docs: List[List[str]] = []

    def add_document(self, tokens: Sequence[str]) -> int:
        doc_id = len(self.docs)
        self.docs.append(list(tokens))
        pos: Dict[str, List[int]] = defaultdict(list)
        for i, t in enumerate(tokens):
            pos[t].append(i)
        for t, ps in pos.items():
            self.postings[t].append((doc_id, ps))
        return doc_id

    def documents_containing(self, word: str) -> List[int]:
        return [d for d, _ in self.postings.get(word, [])]

    def doc_frequency(self, word: str) -> int:
        return len(self.postings.get(word, []))

    def num_docs(self) -> int:
        return len(self.docs)


class BagOfWordsVectorizer:
    """Count-vectorizer: fit builds vocab + index, transform -> [N, V]."""

    def __init__(self, tokenizer=None, min_word_frequency: int = 1,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.cache = VocabCache()
        self.index = InvertedIndex()

    def fit(self, texts: Iterable[str]) -> "BagOfWordsVectorizer":
        for t in texts:
            toks = self.tokenizer(t)
            self.cache.add_document(toks)
            self.index.add_document(toks)
        self.cache.trim(self.min_word_frequency)
        return self

    def _doc_counts(self, text: str) -> np.ndarray:
        v = np.zeros(len(self.cache), np.float32)
        for t in self.tokenizer(text):
            i = self.cache.index_of(t)
            if i >= 0:
                v[i] += 1.0
        return v

    def matrix(self, texts: Sequence[str]) -> np.ndarray:
        """The host numpy values :meth:`transform` uploads: fp32
        [n_docs, V] counts."""
        return np.stack([self._doc_counts(t) for t in texts])

    def transform(self, texts: Sequence[str]) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            self.matrix(texts), np.float32)).to(self.device)

    def fit_transform(self, texts: Sequence[str]) -> torch.Tensor:
        texts = list(texts)
        self.fit(texts)
        return self.transform(texts)


class TfidfVectorizer(BagOfWordsVectorizer):
    """tf-idf with idf = log(N / df) (TfidfVectorizer.java semantics)."""

    def idf(self) -> np.ndarray:
        n = max(1, self.cache.num_docs)
        out = np.zeros(len(self.cache), np.float32)
        for i, w in enumerate(self.cache.index):
            df = max(1, self.cache.doc_frequency(w))
            out[i] = math.log(n / df)
        return out

    def matrix(self, texts: Sequence[str]) -> np.ndarray:
        counts = super().matrix(texts)
        tf = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1.0)
        return tf * self.idf()[None, :]
