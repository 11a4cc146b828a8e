"""Vocabulary: VocabWord, VocabCache, Huffman coding.

A copy of ``deeplearning4j_tpu/nlp/vocab.py``, which imports no JAX: the
port imports nothing of the JAX package, so it keeps its own copy (the
tests hold its tables equal to the JAX package's).

Reference parity:
- ``VocabWord`` (models/word2vec/VocabWord.java) — word + frequency +
  Huffman ``codes``/``points`` filled by the Huffman pass.
- ``VocabCache`` (models/word2vec/wordstore/VocabCache.java,
  inmemory/InMemoryLookupCache.java) — term/doc frequencies + index.
- ``Huffman`` (models/word2vec/Huffman.java:27-35) — builds the binary tree
  over frequencies and assigns each word its code path (for hierarchical
  softmax) and inner-node indices (``points``).

TPU-native addition: ``encode_hs_tables`` packs codes/points into dense
padded int32 arrays [V, max_code_len] so the whole hierarchical-softmax
walk becomes batched gathers/scatter-adds on device (no per-word Python in
the training loop).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class VocabWord:
    word: str
    count: float = 1.0
    index: int = -1
    codes: List[int] = dataclasses.field(default_factory=list)
    points: List[int] = dataclasses.field(default_factory=list)


class VocabCache:
    """Term/doc-frequency store + word<->index mapping."""

    def __init__(self):
        self.vocab: Dict[str, VocabWord] = {}
        self.index: List[str] = []
        self.doc_freq: Counter = Counter()
        self.total_words: float = 0.0
        self.num_docs: int = 0

    # -- building ----------------------------------------------------------
    def add_token(self, word: str, count: float = 1.0) -> VocabWord:
        vw = self.vocab.get(word)
        if vw is None:
            vw = VocabWord(word, 0.0)
            self.vocab[word] = vw
        vw.count += count
        self.total_words += count
        return vw

    def add_document(self, tokens: Iterable[str]) -> None:
        toks = list(tokens)
        for t in toks:
            self.add_token(t)
        for t in set(toks):
            self.doc_freq[t] += 1
        self.num_docs += 1

    def trim(self, min_word_frequency: int = 1) -> None:
        """Drop rare words and (re)build the index ordered by frequency
        descending (the layout Huffman + the unigram table expect)."""
        kept = {w: vw for w, vw in self.vocab.items()
                if vw.count >= min_word_frequency}
        self.vocab = kept
        self.index = sorted(kept, key=lambda w: (-kept[w].count, w))
        for i, w in enumerate(self.index):
            kept[w].index = i

    # -- queries -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, word: str) -> bool:
        return word in self.vocab

    def word_for(self, index: int) -> str:
        return self.index[index]

    def index_of(self, word: str) -> int:
        vw = self.vocab.get(word)
        return vw.index if vw else -1

    def word_frequency(self, word: str) -> float:
        vw = self.vocab.get(word)
        return vw.count if vw else 0.0

    def doc_frequency(self, word: str) -> int:
        return self.doc_freq.get(word, 0)

    def words(self) -> List[str]:
        return list(self.index)


def build_vocab(sentences: Iterable[str], tokenizer,
                min_word_frequency: int = 1) -> VocabCache:
    """The reference's VocabActor pipeline, sequentially: tokenize ->
    count -> trim -> index (Word2Vec.buildVocab:257)."""
    cache = VocabCache()
    for sent in sentences:
        cache.add_document(tokenizer(sent))
    cache.trim(min_word_frequency)
    return cache


# -- Huffman ----------------------------------------------------------------

def build_huffman(cache: VocabCache) -> None:
    """Assign codes/points to every VocabWord (Huffman.java:27-35).

    points[d] = index of the d-th inner node on the root->leaf path
    (inner nodes numbered 0..V-2); codes[d] = branch taken (0/1)."""
    V = len(cache)
    if V == 0:
        return
    if V == 1:
        vw = cache.vocab[cache.index[0]]
        vw.codes, vw.points = [0], [0]
        return

    # heap of (count, tiebreak, node_id); leaves are 0..V-1, inner V..2V-2
    heap: List[Tuple[float, int, int]] = [
        (cache.vocab[w].count, i, i) for i, w in enumerate(cache.index)]
    heapq.heapify(heap)
    parent = np.zeros(2 * V - 1, dtype=np.int64)
    binary = np.zeros(2 * V - 1, dtype=np.int64)
    next_id = V
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        parent[n1] = next_id
        parent[n2] = next_id
        binary[n2] = 1
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    root = next_id - 1

    for i, w in enumerate(cache.index):
        codes: List[int] = []
        path: List[int] = []
        node = i
        while node != root:
            codes.append(int(binary[node]))
            node = int(parent[node])
            path.append(node)
        codes.reverse()
        path.reverse()
        vw = cache.vocab[w]
        vw.codes = codes
        # inner node id -> 0-based "syn1 row": node - V
        vw.points = [p - V for p in path]


def encode_hs_tables(cache: VocabCache
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense padded hierarchical-softmax tables for device-side training.

    Returns (codes [V, L] int32, points [V, L] int32, lengths [V] int32)
    where L = max code length; padding uses point=0/code=0 with
    mask from lengths."""
    V = len(cache)
    L = max((len(cache.vocab[w].codes) for w in cache.index), default=1)
    codes = np.zeros((V, L), np.int32)
    points = np.zeros((V, L), np.int32)
    lengths = np.zeros((V,), np.int32)
    for i, w in enumerate(cache.index):
        vw = cache.vocab[w]
        n = len(vw.codes)
        codes[i, :n] = vw.codes
        points[i, :n] = vw.points
        lengths[i] = n
    return codes, points, lengths


def unigram_table(cache: VocabCache, table_size: int = 100_000,
                  power: float = 0.75) -> np.ndarray:
    """Negative-sampling table (InMemoryLookupTable parity): word i occupies
    a slice proportional to count^0.75."""
    V = len(cache)
    counts = np.array([cache.vocab[w].count for w in cache.index])
    probs = counts ** power
    probs /= probs.sum()
    return np.repeat(np.arange(V), np.maximum(
        1, np.round(probs * table_size).astype(np.int64))).astype(np.int32)
