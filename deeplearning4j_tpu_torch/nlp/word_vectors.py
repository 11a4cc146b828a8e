"""WordVectors query API + serialization.

Port of ``deeplearning4j_tpu/nlp/word_vectors.py`` (reference parity:
``WordVectors.java``/``WordVectorsImpl.java`` and
``WordVectorSerializer.java``).  The table is a torch tensor on its
device; ``similarity`` and ``words_nearest`` are one normalised matrix
product over the whole table.  The text and binary writers produce
byte-identical files to the JAX package's for the same vectors, and the
loaders take ``device=`` (None means CUDA, as everywhere in the port).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class WordVectors:
    """Embedding table + vocab with similarity queries."""

    def __init__(self, cache: VocabCache, vectors: torch.Tensor):
        assert vectors.shape[0] == len(cache), (vectors.shape, len(cache))
        self.cache = cache
        self.vectors = vectors
        self._normed: Optional[torch.Tensor] = None

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    def has_word(self, word: str) -> bool:
        return word in self.cache

    def word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.cache.index_of(word)
        if i < 0:
            return None
        return self.vectors[i].detach().cpu().numpy()

    def _norm_table(self) -> torch.Tensor:
        if self._normed is None:
            v = self.vectors
            self._normed = v / v.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return self._normed

    def similarity(self, w1: str, w2: str) -> float:
        i, j = self.cache.index_of(w1), self.cache.index_of(w2)
        if i < 0 or j < 0:
            return float("nan")
        t = self._norm_table()
        return float(torch.dot(t[i], t[j]))

    def words_nearest(self, word_or_vec, top_n: int = 10,
                      exclude: Sequence[str] = ()) -> List[Tuple[str, float]]:
        t = self._norm_table()
        if isinstance(word_or_vec, str):
            i = self.cache.index_of(word_or_vec)
            if i < 0:
                return []
            q = t[i]
            exclude = tuple(exclude) + (word_or_vec,)
        else:
            q = torch.as_tensor(np.asarray(word_or_vec), dtype=t.dtype,
                                device=t.device)
            q = q / q.norm().clamp_min(1e-12)
        sims = (t @ q).cpu()
        order = torch.argsort(-sims, stable=True).numpy()
        sims = sims.numpy()
        out = []
        for idx in order:
            w = self.cache.word_for(int(idx))
            if w in exclude:
                continue
            out.append((w, float(sims[idx])))
            if len(out) >= top_n:
                break
        return out

    def analogy(self, a: str, b: str, c: str, top_n: int = 5):
        """king - man + woman style query."""
        va, vb, vc = (self.word_vector(w) for w in (a, b, c))
        if va is None or vb is None or vc is None:
            return []
        return self.words_nearest(vb - va + vc, top_n, exclude=(a, b, c))


# -- serialization (WordVectorSerializer parity) ----------------------------

def _host(wv: WordVectors) -> np.ndarray:
    return wv.vectors.detach().cpu().numpy().astype(np.float32, copy=False)


def _index_in_file_order(cache: VocabCache) -> None:
    cache.index = [w for w in cache.vocab]
    for i, w in enumerate(cache.index):
        cache.vocab[w].index = i


def write_word_vectors(wv: WordVectors, path: str) -> None:
    """word2vec C text format: header 'V dim', then 'word v0 v1 ...'."""
    vecs = _host(wv)
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{vecs.shape[0]} {vecs.shape[1]}\n")
        for i in range(vecs.shape[0]):
            vals = " ".join(f"{x:.6f}" for x in vecs[i])
            f.write(f"{wv.cache.word_for(i)} {vals}\n")


def load_word_vectors(path: str, device: DeviceLike = None) -> WordVectors:
    dev = resolve_device(device)
    cache = VocabCache()
    rows: List[np.ndarray] = []
    with open(path, encoding="utf-8") as f:
        header = f.readline().split()
        v, dim = int(header[0]), int(header[1])
        for line in f:
            parts = line.rstrip("\n").split(" ")
            # parse from the END: the last `dim` fields are floats, the
            # word is everything before (n-gram vocab entries contain
            # spaces)
            word = " ".join(parts[:-dim])
            vec = np.asarray([float(x) for x in parts[-dim:]], np.float32)
            cache.add_token(word)
            rows.append(vec)
    _index_in_file_order(cache)
    assert len(rows) == v, f"expected {v} rows, got {len(rows)}"
    return WordVectors(cache, torch.as_tensor(np.stack(rows), device=dev))


def write_word_vectors_binary(wv: WordVectors, path: str) -> None:
    """word2vec C BINARY format: ascii header 'V dim\\n', then per word:
    'word ' + dim float32 LE + '\\n'."""
    vecs = _host(wv)
    with open(path, "wb") as f:
        f.write(f"{vecs.shape[0]} {vecs.shape[1]}\n".encode())
        for i in range(vecs.shape[0]):
            word = wv.cache.word_for(i)
            if " " in word:
                # the C binary layout delimits the word with the FIRST
                # space, so spaced vocab entries (n-grams) cannot
                # round-trip — the text format handles those
                raise ValueError(
                    f"binary format cannot store spaced word {word!r}; "
                    f"use write_word_vectors (text) instead")
            f.write(word.encode("utf-8") + b" ")
            f.write(vecs[i].astype("<f4").tobytes())
            f.write(b"\n")


def load_word_vectors_binary(path: str,
                             device: DeviceLike = None) -> WordVectors:
    dev = resolve_device(device)
    cache = VocabCache()
    rows: List[np.ndarray] = []
    with open(path, "rb") as f:
        header = f.readline().split()
        v, dim = int(header[0]), int(header[1])
        for _ in range(v):
            word = bytearray()
            while True:
                c = f.read(1)
                if not c:
                    break
                if c in (b" ", b"\t", b"\n", b"\r"):
                    # skip record-separator whitespace BEFORE the word (the
                    # C writer emits '\n' after each vector; gensim emits
                    # none), so both layouts parse
                    if word:
                        break
                    continue
                word.extend(c)
            vec = np.frombuffer(f.read(4 * dim), dtype="<f4").copy()
            cache.add_token(word.decode("utf-8"))
            rows.append(vec)
    _index_in_file_order(cache)
    return WordVectors(cache, torch.as_tensor(np.stack(rows), device=dev))
