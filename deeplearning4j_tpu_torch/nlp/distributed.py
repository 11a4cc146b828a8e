"""Distributed NLP jobs over the scale-out runner.

Port of ``deeplearning4j_tpu/nlp/distributed.py``.  The reference's
Akka-runtime word2vec workload (``scaleout/perform/models/word2vec/
{Word2VecPerformer,Word2VecWork,Word2VecResult,Word2VecJobAggregator}
.java``: word-vector tables shipped out, trained on a sentence shard,
averaged back), exercised end to end by ``DistributedWord2VecTest``; the
same pattern serves GloVe, word counting and vocabulary counting.

The vocabulary is built ONCE up front (the reference's VocabActor phase)
and shared by every performer; each job is a sentence shard; the
aggregator averages the tables.  A performer trains on its ``device``
(None: the card), so each word2vec job runs kernel B4 and each GloVe job
kernel B5 there, and ships its tables back as numpy arrays; the averaged
tables are numpy arrays, as in the reference.  The trainers return
:class:`~deeplearning4j_tpu_torch.nlp.word_vectors.WordVectors` on that
device, carrying the run's averaged tables (``tables``) and its
``StateTracker`` (``tracker``: ``jobs_done``, ``jobs_failed``,
``jobs_dropped``).
"""

from __future__ import annotations

import logging
from collections import Counter
from itertools import chain
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nlp.glove import (Glove, GloveConfig,
                                                count_cooccurrences)
from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_vocab
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, Word2VecConfig
from deeplearning4j_tpu_torch.nlp.word_vectors import WordVectors
from deeplearning4j_tpu_torch.parallel import scaleout as so
from deeplearning4j_tpu_torch.parallel.coordinator import Job

log = logging.getLogger(__name__)

__all__ = ["GloveJobAggregator", "GlovePerformer", "VocabCountAggregator",
           "VocabCountPerformer", "Word2VecJobAggregator",
           "Word2VecPerformer", "WordCountAggregator", "WordCountPerformer",
           "build_vocab_distributed", "shard_sentences",
           "train_glove_distributed", "train_word2vec_distributed",
           "word_count_distributed"]


def _host(t) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def shard_sentences(sentences: Sequence[str], n_shards: int
                    ) -> List[List[str]]:
    """Round-robin the corpus into at most ``n_shards`` non-empty shards
    (the BatchActor partitioning step, shared by every distributed NLP
    job)."""
    shards: List[List[str]] = [[] for _ in range(n_shards)]
    for i, s in enumerate(sentences):
        shards[i % n_shards].append(s)
    return [s for s in shards if s]


class Word2VecPerformer(so.WorkerPerformer):
    """Trains the shared-vocabulary model on a job's sentence shard from
    the current global tables, and ships the trained tables back."""

    def __init__(self, cache: VocabCache, config: Word2VecConfig,
                 tokenizer=None, device: DeviceLike = None):
        self.cache = cache
        self.config = config
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        self.device = resolve_device(device)
        self._current: Optional[Tuple] = None
        #: the random draws of each job's fit (None: the port's own, a
        #: function of the config's seed); tests put JAX's draws here
        self._draws = None
        #: chunk updates (one B4 launch each on the card) and corpus
        #: words of the last job
        self.chunks = self.words = 0

    def perform(self, job: Job) -> None:
        w2v = Word2Vec(job.work, self.config, self.tokenizer,
                       cache=self.cache, device=self.device)
        w2v._draws = self._draws
        w2v.fit(initial_weights=self._current)
        self.chunks, self.words = w2v.chunks, w2v._n_positions
        job.result = (_host(w2v.syn0), _host(w2v.syn1), _host(w2v.syn1neg))

    def update(self, current) -> None:
        self._current = current


class Word2VecJobAggregator(so.JobAggregator):
    """Running average of the weight-table tuples
    (Word2VecJobAggregator.java)."""

    def __init__(self):
        self._sum = None
        self._n = 0

    def accumulate(self, job: Job) -> None:
        if job.result is None:
            return
        self._n += 1
        if self._sum is None:
            self._sum = [None if t is None else t.copy()
                         for t in job.result]
        else:
            self._sum = [a if b is None else
                         (b.copy() if a is None else a + b)
                         for a, b in zip(self._sum, job.result)]

    def aggregate(self):
        if self._sum is None:
            return None
        return tuple(None if t is None else t / self._n for t in self._sum)

    def reset(self) -> None:
        self._sum = None
        self._n = 0


def _warn_dropped(runner: "so.DistributedRunner") -> None:
    """Partial results change the answer, not only a counter: say so."""
    dropped = runner.tracker.count("jobs_dropped")
    if dropped:
        log.warning("%d shard job(s) were dropped after repeated failures; "
                    "the returned vectors exclude that data", dropped)


def train_word2vec_distributed(sentences: Sequence[str],
                               config: Optional[Word2VecConfig] = None,
                               n_workers: int = 2,
                               n_shards: Optional[int] = None,
                               tokenizer=None,
                               timeout_s: float = 300.0,
                               device: DeviceLike = None) -> WordVectors:
    """DistributedWord2VecTest: shard the sentences, run the in-process
    runner with word2vec performers on ``device``, return the averaged
    vectors."""
    config = config or Word2VecConfig()
    tokenizer = tokenizer or DefaultTokenizerFactory()
    dev = resolve_device(device)
    cache = build_vocab(sentences, tokenizer, config.min_word_frequency)

    shards = shard_sentences(sentences, n_shards or n_workers)
    runner = so.DistributedRunner(
        so.CollectionJobIterator(shards),
        lambda: Word2VecPerformer(cache, config, tokenizer, device=dev),
        Word2VecJobAggregator(), n_workers=n_workers)
    result = runner.run(timeout_s=timeout_s)
    _warn_dropped(runner)
    if result is None:
        raise ValueError("no worker produced trained tables — every shard "
                         "was empty of trainable pairs or every job was "
                         "dropped after repeated failures")
    wv = WordVectors(cache, torch.as_tensor(result[0], device=dev))
    wv.tables, wv.tracker = result, runner.tracker
    return wv


class WordCountPerformer(so.WorkerPerformer):
    """Distributed word counting (scaleout/perform/text/
    WordCountWorkPerformer.java): each job is a sentence (or a list of
    them); the result is its token-count dict."""

    def __init__(self, tokenizer=None):
        self.tokenizer = tokenizer or DefaultTokenizerFactory()

    def perform(self, job: Job) -> None:
        sentences = [job.work] if isinstance(job.work, str) else job.work
        job.result = dict(Counter(
            chain.from_iterable(self.tokenizer(s) for s in sentences)))


class WordCountAggregator(so.JobAggregator):
    """Merge per-shard count dicts (the WordCountTest reduction)."""

    def __init__(self):
        self.total = Counter()

    def accumulate(self, job: Job) -> None:
        self.total.update(job.result or {})

    def aggregate(self):
        return dict(self.total)

    def reset(self) -> None:
        pass                      # counts accumulate across rounds


def word_count_distributed(sentences: Sequence[str], n_workers: int = 2,
                           tokenizer=None, timeout_s: float = 60.0) -> dict:
    """WordCountTest: corpus -> merged token counts through the runner."""
    runner = so.DistributedRunner(
        so.CollectionJobIterator(list(sentences)),
        lambda: WordCountPerformer(tokenizer),
        WordCountAggregator(), n_workers=n_workers,
        router_cls=so.HogWildWorkRouter)
    counts = runner.run(timeout_s=timeout_s)
    _warn_dropped(runner)
    return counts if counts is not None else {}


class GlovePerformer(so.WorkerPerformer):
    """Distributed GloVe (scaleout/perform/models/glove/GlovePerformer
    .java): each job is a sentence shard; the performer counts the
    shard's co-occurrences and runs the AdaGrad WLS fit from the current
    averaged tables on its device, then ships the whole state (w, w~, b,
    b~ and the AdaGrad sums) back.  A shard with no co-occurrences
    gives ``None``: a deterministic raise would requeue it until the
    retry cap."""

    def __init__(self, cache: VocabCache, config: GloveConfig,
                 tokenizer=None, device: DeviceLike = None):
        self.cache = cache
        self.config = config
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        self.device = resolve_device(device)
        self._current: Optional[Tuple] = None
        #: each job's permutations (None: the port's own); tests put
        #: JAX's here
        self._shuffles = None
        #: chunk updates (one B5 launch each on the card) and
        #: co-occurrence triples of the last job
        self.chunks = self.triples = 0

    def perform(self, job: Job) -> None:
        glove = Glove(job.work, self.config, self.tokenizer,
                      cache=self.cache, device=self.device)
        glove._shuffles = self._shuffles
        cooc = count_cooccurrences(job.work, self.tokenizer, self.cache,
                                   self.config.window,
                                   self.config.symmetric)
        self.triples = int(cooc[0].size)
        if cooc[0].size == 0:
            job.result = None
            self.chunks = 0
            return
        glove.fit(initial_weights=self._current, cooccurrences=cooc)
        self.chunks = glove.chunks
        job.result = tuple(_host(t) for t in glove.state)

    def update(self, current) -> None:
        self._current = current


class GloveJobAggregator(Word2VecJobAggregator):
    """Running average of the 8-tuple GloVe state (GloveJobAggregator
    .java): the word2vec aggregator's elementwise average; only the
    tuple's arity differs."""


def train_glove_distributed(sentences: Sequence[str],
                            config: Optional[GloveConfig] = None,
                            n_workers: int = 2,
                            n_shards: Optional[int] = None,
                            tokenizer=None,
                            timeout_s: float = 300.0,
                            device: DeviceLike = None) -> WordVectors:
    """DistributedGloveTest: shard the sentences, run the runner with
    GloVe performers on ``device``, return vectors from the averaged
    tables (w + w~)."""
    config = config or GloveConfig()
    tokenizer = tokenizer or DefaultTokenizerFactory()
    dev = resolve_device(device)
    cache = build_vocab(sentences, tokenizer, config.min_word_frequency)

    shards = shard_sentences(sentences, n_shards or n_workers)
    runner = so.DistributedRunner(
        so.CollectionJobIterator(shards),
        lambda: GlovePerformer(cache, config, tokenizer, device=dev),
        GloveJobAggregator(), n_workers=n_workers)
    state = runner.run(timeout_s=timeout_s)
    _warn_dropped(runner)
    if state is None:
        raise ValueError("no worker produced trained tables — every shard "
                         "had zero co-occurrences or every job was dropped "
                         "after repeated failures")
    wv = WordVectors(cache, torch.as_tensor(state[0] + state[1],
                                            device=dev))
    wv.tables, wv.tracker = state, runner.tracker
    return wv


class VocabCountPerformer(so.WorkerPerformer):
    """Distributed vocabulary counting (the spark TextPipeline:
    dl4j-spark-nlp/.../text/TextPipeline.java:37, tokenize, then term and
    document counts a partition).  Each job is a sentence shard; the
    result is (term_counts, doc_counts, n_docs)."""

    def __init__(self, tokenizer=None):
        self.tokenizer = tokenizer or DefaultTokenizerFactory()

    def perform(self, job: Job) -> None:
        sentences = [job.work] if isinstance(job.work, str) else job.work
        terms: "Counter[str]" = Counter()
        docs: "Counter[str]" = Counter()
        for s in sentences:
            toks = self.tokenizer(s)
            terms.update(toks)
            docs.update(set(toks))
        job.result = (dict(terms), dict(docs), len(sentences))


class VocabCountAggregator(so.JobAggregator):
    """Merge partition counts into one (terms, docs, n_docs) triple:
    TextPipeline's reduceByKey stage."""

    def __init__(self):
        self.terms = Counter()
        self.docs = Counter()
        self.n_docs = 0

    def accumulate(self, job: Job) -> None:
        t, d, n = job.result or ({}, {}, 0)
        self.terms.update(t)
        self.docs.update(d)
        self.n_docs += n

    def aggregate(self):
        return dict(self.terms), dict(self.docs), self.n_docs

    def reset(self) -> None:
        pass                      # counts accumulate across rounds


def build_vocab_distributed(sentences: Sequence[str],
                            min_word_frequency: int = 1,
                            n_workers: int = 2,
                            n_shards: Optional[int] = None,
                            tokenizer=None,
                            timeout_s: float = 60.0) -> VocabCache:
    """TextPipeline: the vocabulary built from distributed counts (the
    spark pipeline tokenizes and counts on executors, then builds the
    VocabCache from the reduced counts), equal to the sequential
    ``build_vocab`` on the same corpus."""
    runner = so.DistributedRunner(
        so.CollectionJobIterator(
            shard_sentences(sentences, n_shards or n_workers)),
        lambda: VocabCountPerformer(tokenizer),
        VocabCountAggregator(), n_workers=n_workers,
        router_cls=so.HogWildWorkRouter)
    out = runner.run(timeout_s=timeout_s)
    _warn_dropped(runner)
    if out is None:
        raise ValueError(
            "no worker produced vocabulary counts — every shard job was "
            "dropped after repeated failures")
    terms, docs, n_docs = out
    cache = VocabCache()
    for w, c in terms.items():
        cache.add_token(w, count=float(c))
    for w, c in docs.items():
        cache.doc_freq[w] = int(c)
    cache.num_docs = n_docs
    cache.trim(min_word_frequency)
    return cache
