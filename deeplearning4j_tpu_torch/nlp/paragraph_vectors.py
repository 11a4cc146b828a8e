"""ParagraphVectors — PV-DBOW document embeddings.

Port of ``deeplearning4j_tpu/nlp/paragraph_vectors.py`` (reference
parity: ``ParagraphVectors.java``, ``dbow:188``).  Label words are extra
rows of syn0, trained against every word of their document.  Label
pairs ride the word2vec slab engine (``run_pair_training``, hierarchical
softmax only, so kernel B4 on CUDA) as candidate pairs with delta 0,
which the window-shrink mask always keeps.  ``infer_vector`` trains a
fresh row for an unseen document with the rest of the space frozen, in
plain PyTorch; ``nearest_labels`` ranks labels by the averaged word
vectors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import (VocabCache, build_huffman,
                                                encode_hs_tables)
from deeplearning4j_tpu_torch.nlp.word2vec import (Word2VecConfig, as_table,
                                                   corpus_pairs,
                                                   hs_mask_table,
                                                   run_pair_training)
from deeplearning4j_tpu_torch.nlp.word_vectors import WordVectors


@dataclasses.dataclass
class ParagraphVectorsConfig(Word2VecConfig):
    train_words: bool = True     # PV-DBOW + word training (dbow+w2v)


class ParagraphVectors:
    """fit() over labelled documents [(label, text), ...]."""

    def __init__(self, labelled_docs: Sequence[Tuple[str, str]],
                 config: Optional[ParagraphVectorsConfig] = None,
                 tokenizer=None, device: DeviceLike = None):
        self.config = config or ParagraphVectorsConfig()
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        self.docs = list(labelled_docs)
        self.device = resolve_device(device)
        self.cache: Optional[VocabCache] = None
        self.labels: List[str] = []
        self.syn0 = None
        self.syn1 = None
        self._hs_tables = None
        self._wv: Optional[WordVectors] = None
        #: random draws of the next fit (see word2vec.Draws)
        self._draws = None
        self.chunks = 0

    def fit(self, initial_weights=None) -> WordVectors:
        """Train.  ``initial_weights=(syn0, syn1)`` over the vocabulary
        of words then labels starts from given tables instead of
        ``syn0 ~ U(-0.5, 0.5)/dim`` and ``syn1 = 0``."""
        cfg, dev = self.config, self.device
        # vocab over words AND label tokens (label words live in the space)
        cache = VocabCache()
        for label, text in self.docs:
            cache.add_document(self.tokenizer(text))
        cache.trim(cfg.min_word_frequency)
        self.labels = sorted({l for l, _ in self.docs})
        for l in self.labels:
            cache.add_token(l, count=1.0)
        # labels not already in the word index are appended after it
        # (a label sharing a word's surface form shares its row)
        existing = set(cache.index)
        cache.index += [l for l in self.labels if l not in existing]
        for i, w in enumerate(cache.index):
            cache.vocab[w].index = i
        build_huffman(cache)
        self.cache = cache

        V, D = len(cache), cfg.vector_size
        if initial_weights is not None:
            self.syn0 = as_table(initial_weights[0], dev)
            self.syn1 = as_table(initial_weights[1], dev)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(cfg.seed)
            self.syn0 = (torch.rand((V, D), generator=gen, device=dev)
                         - 0.5) / D
            self.syn1 = torch.zeros((V, D), device=dev)

        codes_np, points_np, lengths_t = encode_hs_tables(cache)
        mask_full = hs_mask_table(codes_np, lengths_t)
        self._hs_tables = (codes_np, points_np, mask_full)

        indexed: List[np.ndarray] = []
        label_rows: List[int] = []
        for label, text in self.docs:
            idx = np.asarray(
                [i for i in (cache.index_of(t)
                             for t in self.tokenizer(text)) if i >= 0],
                np.int32)
            if idx.size:
                indexed.append(idx)
                label_rows.append(cache.index_of(label))
        if not indexed:
            self._wv = WordVectors(cache, self.syn0)
            return self._wv

        lens = np.asarray([a.size for a in indexed])
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        seen_before = starts.astype(np.int64)
        # label pairs: (center=word, input=label row, pos=token position)
        lb_cen = np.concatenate(indexed)
        lb_ctx = np.repeat(np.asarray(label_rows, np.int32), lens)
        lb_pos = np.arange(lb_cen.size, dtype=np.int32)
        lb_dlt = np.zeros(lb_cen.size, np.int32)
        lb_off = np.repeat(seen_before, lens)
        if cfg.train_words:
            w_cen, w_ctx, w_pos, w_dlt, w_off = corpus_pairs(
                indexed, cfg.window)
            pairs = tuple(np.concatenate([a, b]) for a, b in zip(
                (lb_cen, lb_ctx, lb_pos, lb_dlt, lb_off),
                (w_cen, w_ctx, w_pos, w_dlt, w_off)))
        else:
            pairs = (lb_cen, lb_ctx, lb_pos, lb_dlt, lb_off)

        self.syn0, self.syn1, _, _, self.kernel_used, self.chunks = \
            run_pair_training(
                self.syn0, self.syn1, None, pairs,
                vocab_size=V, dim=D, epochs=cfg.epochs,
                total_words=int(lens.sum()), codes_t=codes_np,
                points_t=points_np, mask_t=mask_full,
                table=np.zeros((1,), np.int32), window=cfg.window,
                alpha=cfg.alpha, min_alpha=cfg.min_alpha, use_hs=True,
                negative=0, batch_size=cfg.batch_size, kernel=cfg.kernel,
                seed=cfg.seed, draws=self._draws)
        self._wv = WordVectors(cache, self.syn0)
        return self._wv

    # -- queries ------------------------------------------------------------
    @property
    def word_vectors(self) -> WordVectors:
        if self._wv is None:
            raise RuntimeError("call fit() first")
        return self._wv

    def doc_vector(self, label: str) -> Optional[np.ndarray]:
        return self.word_vectors.word_vector(label)

    def similarity(self, a: str, b: str) -> float:
        return self.word_vectors.similarity(a, b)

    def _infer_start(self) -> torch.Tensor:
        """The first guess of an inferred row, U(-0.5, 0.5)/dim from a
        generator seeded with config.seed + 7."""
        D = self.config.vector_size
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed + 7)
        return (torch.rand((D,), generator=gen, device=self.device)
                - 0.5) / D

    def infer_vector(self, text: str, epochs: int = 25,
                     alpha: Optional[float] = None) -> np.ndarray:
        """Embed an UNSEEN document: train a fresh syn0-style row against
        the document's words' Huffman paths with the rest of the space
        frozen (:157-188)."""
        cfg = self.config
        if self.cache is None or self.syn1 is None:
            raise RuntimeError("call fit() first")
        idx = [self.cache.index_of(t) for t in self.tokenizer(text)]
        idx = np.asarray([i for i in idx if i >= 0], np.int64)
        if idx.size == 0:
            return np.zeros(cfg.vector_size, np.float32)
        codes_np, points_np, mask_np = self._hs_tables
        dev = self.device
        codes = torch.as_tensor(codes_np[idx], dtype=torch.float32,
                                device=dev)                       # [n, L]
        mask = torch.as_tensor(mask_np[idx], device=dev)
        s1 = self.syn1[torch.as_tensor(points_np[idx], device=dev).long()]
        a = float(np.float32(alpha if alpha is not None else cfg.alpha))
        v = self._infer_start()
        for _ in range(epochs):
            f = torch.sigmoid(torch.einsum("d,nld->nl", v, s1))
            g = (1.0 - codes - f) * a * mask
            v = v + torch.einsum("nl,nld->d", g, s1) / idx.size
        return v.cpu().numpy()

    def nearest_labels(self, text: str, top_n: int = 3):
        """Infer by averaging word vectors of the text, rank labels."""
        idx = [self.cache.index_of(t) for t in self.tokenizer(text)]
        idx = [i for i in idx if i >= 0]
        if not idx:
            return []
        v = self.syn0[torch.as_tensor(idx, device=self.syn0.device)] \
            .mean(dim=0)
        sims = self.word_vectors.words_nearest(v.cpu().numpy(),
                                               top_n=len(self.cache))
        labels = set(self.labels)
        return [(w, s) for w, s in sims if w in labels][:top_n]
