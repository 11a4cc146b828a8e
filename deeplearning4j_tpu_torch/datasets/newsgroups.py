"""Newsgroups text-classification corpus loader + iterator.

Reference parity: ``datasets/loader/ReutersNewsGroupsLoader.java`` (labeled
directory tree of text files -> label-aware iteration -> TF-IDF or
bag-of-words vectorization -> one merged DataSet) and
``datasets/iterator/ReutersNewsGroupsDataSetIterator.java`` (fetcher-backed
batch iterator over it).

Zero-egress build: the reference downloads 20news-18828.tar.gz
(`ReutersNewsGroupsLoader.java:45`); here a local directory in the same
layout (one subdirectory per label, one document per file) is read when
provided, and otherwise a deterministic synthetic surrogate corpus with
label-correlated vocabulary is generated so every downstream consumer
(vectorizers, classifiers, tests) exercises the real path.

Port of ``deeplearning4j_tpu/datasets/newsgroups.py``: the surrogate
corpus draws from the same ``RandomState(seed)``, so both packages build
the same documents; the loader's ``DataSet`` holds host numpy as the
reference's does, and its vectorizer uploads to ``device`` when asked
(``loader.vectorizer.transform(loader.texts)``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch import DeviceLike
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, one_hot
from deeplearning4j_tpu_torch.datasets.fetchers import ArrayFetcher
from deeplearning4j_tpu_torch.datasets.iterator import BaseDatasetIterator
from deeplearning4j_tpu_torch.nlp.vectorizers import (BagOfWordsVectorizer,
                                                      TfidfVectorizer)


def _surrogate_corpus(n_docs: int, seed: int
                      ) -> Tuple[List[str], List[str], List[str]]:
    """Deterministic labeled corpus: each label owns a topic vocabulary;
    documents mix topic words with shared filler so TF-IDF separates the
    classes but BoW overlap still exists."""
    rng = np.random.RandomState(seed)
    topic_words = {
        "sci.space": ["orbit", "rocket", "lunar", "probe", "telescope"],
        "rec.sport": ["match", "score", "team", "goal", "season"],
        "comp.graphics": ["render", "pixel", "shader", "polygon", "frame"],
        "talk.politics": ["policy", "senate", "vote", "debate", "reform"],
    }
    filler = ["the", "a", "of", "and", "to", "in", "is", "it", "for", "on"]
    texts, labels = [], []
    names = list(topic_words)
    for i in range(n_docs):
        lab = names[i % len(names)]
        words = []
        for _ in range(30):
            pool = topic_words[lab] if rng.rand() < 0.5 else filler
            words.append(pool[rng.randint(len(pool))])
        texts.append(" ".join(words))
        labels.append(lab)
    return texts, labels, names


def read_label_directories(root_dir: str
                           ) -> Tuple[List[str], List[str], List[str]]:
    """(texts, doc_labels, label_names) from a 20news-style tree: one
    subdirectory per label, one document per file
    (ReutersNewsGroupsLoader's LabelAwareFileSentenceIterator layout)."""
    label_names = sorted(
        d for d in os.listdir(root_dir)
        if os.path.isdir(os.path.join(root_dir, d)))
    if not label_names:
        raise ValueError(f"no label directories under {root_dir!r}")
    texts, labels = [], []
    for lab in label_names:
        d = os.path.join(root_dir, lab)
        for fname in sorted(os.listdir(d)):
            path = os.path.join(d, fname)
            if not os.path.isfile(path):
                continue
            with open(path, "r", errors="replace") as f:
                texts.append(f.read())
            labels.append(lab)
    return texts, labels, label_names


class NewsGroupsLoader:
    """Vectorize a labeled text corpus into one DataSet.

    tfidf=True -> TfidfVectorizer, else BagOfWordsVectorizer (the
    reference's constructor switch, ReutersNewsGroupsLoader.java:62-69).
    """

    def __init__(self, tfidf: bool = True, root_dir: Optional[str] = None,
                 tokenizer=None, min_word_frequency: int = 1,
                 n_docs: int = 200, seed: int = 0,
                 device: DeviceLike = None):
        if root_dir is not None:
            texts, labels, names = read_label_directories(root_dir)
            self.synthetic = False
        else:
            texts, labels, names = _surrogate_corpus(n_docs, seed)
            self.synthetic = True
        self.label_names: List[str] = list(names)
        self.doc_labels: List[str] = labels
        self.texts: List[str] = texts
        vec_cls = TfidfVectorizer if tfidf else BagOfWordsVectorizer
        self.vectorizer = vec_cls(tokenizer=tokenizer,
                                  min_word_frequency=min_word_frequency,
                                  device=device)
        # features/labels stay host-side numpy: the fetcher hands out one
        # batch slice at a time (a device-resident copy here would hold
        # the whole TF-IDF matrix twice and add a D2H roundtrip)
        features = self.vectorizer.fit(texts).matrix(texts)
        idx = [self.label_names.index(l) for l in labels]
        self.data = DataSet(features,
                            one_hot(np.asarray(idx), len(self.label_names)))

    @property
    def num_examples(self) -> int:
        return int(self.data.features.shape[0])


class NewsGroupsFetcher(ArrayFetcher):
    """Cursor over the loaded corpus (BaseDataFetcher.fetch parity) —
    ArrayFetcher already implements the cursor/slice logic."""

    def __init__(self, loader: NewsGroupsLoader):
        super().__init__(loader.data.features, loader.data.labels)
        self.loader = loader


class NewsGroupsDataSetIterator(BaseDatasetIterator):
    """Batch iterator (ReutersNewsGroupsDataSetIterator parity)."""

    def __init__(self, batch: int, num_examples: int = -1,
                 tfidf: bool = True, root_dir: Optional[str] = None,
                 **loader_kw):
        self.loader = NewsGroupsLoader(tfidf=tfidf, root_dir=root_dir,
                                       **loader_kw)
        super().__init__(batch, num_examples, NewsGroupsFetcher(self.loader))
