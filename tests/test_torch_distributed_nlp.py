"""The port's ``nlp/distributed.py`` against the JAX package, on the CPU.

After ``tests/test_scaleout.py:201-356``: word2vec and GloVe over the
in-process runner (sentence shards trained from the current averaged
tables, averaged back), word counting and the distributed vocabulary.

Held:
- ``shard_sentences``, the word and vocabulary counts: equal to the
  reference's (and the distributed vocabulary to the sequential one);
- the word2vec and GloVe aggregators on the same numpy tables: equal to
  the reference's, within rtol 1e-6 (the same fp32 sums);
- one performer's job against the reference performer's from the same
  tables, the port given JAX's draws (word2vec) or permutations (GloVe)
  as ``tests/test_torch_word2vec.py`` and ``tests/test_torch_glove.py``
  hand them: word2vec within 1e-6 (those tests' fit tolerance), GloVe's
  tables within 1e-6 and its AdaGrad sums within rtol 1e-4;
- the distributed fits, two workers against one: the same rounds of
  the same shards run by one performer and averaged by the aggregator
  give the runner's tables within 1e-6 (the plain twins are
  deterministic on the CPU; on the card B4 and B5 sum a row's hits in
  atomic order, ``chip_smoke.py`` phase 24 (b));
- trained vectors that rank related words above unrelated ones (the
  reference's end-to-end bar), and a GloVe shard with no co-occurrences
  that gives ``None`` instead of raising.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import distributed as jd
from deeplearning4j_tpu.nlp import glove as jg
from deeplearning4j_tpu.nlp import word2vec as jw
from deeplearning4j_tpu.nlp.text import DefaultTokenizerFactory as JTok
from deeplearning4j_tpu.nlp.vocab import build_vocab as jbuild_vocab
from deeplearning4j_tpu.parallel.coordinator import Job as JJob
from deeplearning4j_tpu_torch.nlp import distributed as td
from deeplearning4j_tpu_torch.nlp import glove as tg
from deeplearning4j_tpu_torch.nlp import word2vec as tw
from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory as TTok
from deeplearning4j_tpu_torch.nlp.vocab import build_vocab as tbuild_vocab
from deeplearning4j_tpu_torch.parallel.coordinator import Job
from test_torch_paged import assert_no_jax
from test_torch_word2vec import JaxDraws

torch.set_num_threads(2)

TOL = 1e-6
CORPUS = (["the beach has sand and sea",
           "waves crash on the beach near the sea",
           "sand and sea meet at the shore",
           "the cat sat on the mat",
           "the dog sat on the rug",
           "cats and dogs are pets"] * 30)
W2V = dict(vector_size=16, window=3, epochs=2, seed=11, batch_size=64,
           negative=3)
GLOVE = dict(vector_size=8, window=3, epochs=2, batch_size=128, seed=7)


def _rounds_by_one(performer, shards, aggregator, per_round: int):
    """The runner's rounds (``per_round`` shards each, from the last
    round's average) made by ONE performer, one job after another."""
    current = None
    for r in range(0, len(shards), per_round):
        aggregator.reset()
        for shard in shards[r:r + per_round]:
            if current is not None:
                performer.update(current)
            job = Job(work=shard)
            performer.perform(job)
            aggregator.accumulate(job)
        current = aggregator.aggregate()
    return current


def _tables_close(got, want, rtol=0.0, atol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


def test_shard_sentences_matches_reference():
    for n in (1, 3, 4, 7):
        assert td.shard_sentences(CORPUS[:10], n) == \
            jd.shard_sentences(CORPUS[:10], n)
    assert td.shard_sentences([], 3) == []


@pytest.mark.parametrize("arity,none_at", [(3, 2), (3, None), (8, None)])
def test_table_aggregators_match_reference(arity, none_at):
    rng = np.random.default_rng(arity)
    results = [tuple(None if i == none_at else
                     rng.standard_normal((5, 4)).astype(np.float32)
                     for i in range(arity)) for _ in range(3)]
    agg = (td.Word2VecJobAggregator() if arity == 3
           else td.GloveJobAggregator())
    ref = (jd.Word2VecJobAggregator() if arity == 3
           else jd.GloveJobAggregator())
    for r in results + [None]:
        agg.accumulate(Job(work=None, result=r))
        ref.accumulate(JJob(work=None, result=r))
    _tables_close(agg.aggregate(), ref.aggregate(), rtol=1e-6, atol=0)
    agg.reset()
    assert agg.aggregate() is None


def test_word2vec_performer_job_matches_reference():
    """One job from the same initial tables, JAX's draws handed to the
    port."""
    cache_t = tbuild_vocab(CORPUS, TTok(), 1)
    cache_j = jbuild_vocab(CORPUS, JTok(), 1)
    V = len(cache_t)
    rng = np.random.RandomState(0)
    init = (rng.uniform(-0.5, 0.5, (V, 16)).astype(np.float32) / 16,
            rng.randn(V, 16).astype(np.float32) * 0.01,
            rng.randn(V, 16).astype(np.float32) * 0.01)
    shard = td.shard_sentences(CORPUS, 4)[1]
    jp = jd.Word2VecPerformer(cache_j, jw.Word2VecConfig(kernel="xla",
                                                         **W2V), JTok())
    jp.update(init)
    jjob = JJob(work=shard)
    jp.perform(jjob)
    tp = td.Word2VecPerformer(cache_t, tw.Word2VecConfig(**W2V), TTok(),
                              device="cpu")
    tp._draws = JaxDraws(W2V["seed"])
    tp.update(init)
    tjob = Job(work=shard)
    tp.perform(tjob)
    assert tp.chunks > 0
    _tables_close(tjob.result, jjob.result)


def test_glove_performer_job_matches_reference():
    """One job from the same state, JAX's permutations handed over."""
    cache_t = tbuild_vocab(CORPUS, TTok(), 1)
    cache_j = jbuild_vocab(CORPUS, JTok(), 1)
    V, D = len(cache_t), GLOVE["vector_size"]
    rng = np.random.RandomState(1)
    init = (rng.randn(V, D).astype(np.float32) * 0.1,
            rng.randn(V, D).astype(np.float32) * 0.1,
            np.zeros(V, np.float32), np.zeros(V, np.float32),
            np.full((V, D), 1e-8, np.float32),
            np.full((V, D), 1e-8, np.float32),
            np.full(V, 1e-8, np.float32), np.full(V, 1e-8, np.float32))
    shard = td.shard_sentences(CORPUS, 4)[2]
    jp = jd.GlovePerformer(cache_j, jg.GloveConfig(kernel="xla", **GLOVE),
                           JTok())
    jp.update(init)
    jjob = JJob(work=shard)
    jp.perform(jjob)
    tp = td.GlovePerformer(cache_t, tg.GloveConfig(**GLOVE), TTok(),
                           device="cpu")
    key = jax.random.key(GLOVE["seed"])
    tp._shuffles = lambda epoch, n: np.array(
        jax.random.permutation(jax.random.fold_in(key, epoch), n))
    tp.update(init)
    tjob = Job(work=shard)
    tp.perform(tjob)
    assert tp.chunks > 0
    _tables_close(tjob.result[:4], jjob.result[:4])
    _tables_close(tjob.result[4:], jjob.result[4:], rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("kind", ["word2vec", "glove"])
def test_two_workers_match_one_worker(kind):
    """The runner with two workers over four shards against the same two
    rounds made by one performer: the averaged tables within 1e-6, and
    the trainer's vectors are the averaged syn0 (word2vec) or w + w~."""
    shards = td.shard_sentences(CORPUS, 4)
    cache = tbuild_vocab(CORPUS, TTok(), 1)
    if kind == "word2vec":
        cfg = tw.Word2VecConfig(**W2V)

        def make():
            return td.Word2VecPerformer(cache, cfg, TTok(), device="cpu")
        agg_cls, train = (td.Word2VecJobAggregator,
                           td.train_word2vec_distributed)
    else:
        cfg = tg.GloveConfig(**GLOVE)

        def make():
            return td.GlovePerformer(cache, cfg, TTok(), device="cpu")
        agg_cls, train = td.GloveJobAggregator, td.train_glove_distributed
    from deeplearning4j_tpu_torch.parallel import scaleout as so
    runner = so.DistributedRunner(so.CollectionJobIterator(shards), make,
                                  agg_cls(), n_workers=2)
    got = runner.run(timeout_s=120)
    assert runner.tracker.count("jobs_done") == 4
    assert runner.tracker.count("jobs_failed") == 0
    want = _rounds_by_one(make(), shards, agg_cls(), 2)
    _tables_close(got, want)
    wv = train(CORPUS, cfg, n_workers=2, n_shards=4, device="cpu")
    vecs = want[0] if kind == "word2vec" else want[0] + want[1]
    np.testing.assert_allclose(wv.vectors.numpy(), vecs, rtol=0, atol=TOL)


def test_distributed_word2vec_and_glove_rank_related_words_higher():
    """The reference's end-to-end bar (tests/test_scaleout.py:201, 234)."""
    wv = td.train_word2vec_distributed(
        CORPUS, tw.Word2VecConfig(vector_size=24, window=3, epochs=10,
                                  seed=11, batch_size=32),
        n_workers=2, n_shards=4, device="cpu")
    assert wv.similarity("sand", "sea") > wv.similarity("sand", "pets")
    gv = td.train_glove_distributed(
        CORPUS, tg.GloveConfig(vector_size=16, window=3, epochs=4,
                               batch_size=512, seed=7),
        n_workers=2, n_shards=4, device="cpu")
    assert gv.has_word("beach") and gv.has_word("cat")
    assert gv.similarity("sand", "sea") > gv.similarity("sand", "pets")


def test_glove_performer_tolerates_an_empty_shard():
    cache = tbuild_vocab(["alpha beta gamma delta"], TTok(), 1)
    p = td.GlovePerformer(cache, tg.GloveConfig(vector_size=8), TTok(),
                          device="cpu")
    job = Job(work=["zzz"])
    p.perform(job)
    assert job.result is None


def test_word_counts_and_vocabulary_match_reference():
    sents = ["the cat sat", "the dog sat", "the end"]
    assert td.word_count_distributed(sents, n_workers=2) == \
        jd.word_count_distributed(sents, n_workers=2)
    assert td.word_count_distributed([]) == {} == \
        jd.word_count_distributed([])
    got = td.build_vocab_distributed(CORPUS, min_word_frequency=2,
                                     n_workers=2, n_shards=3)
    ref = jd.build_vocab_distributed(CORPUS, min_word_frequency=2,
                                     n_workers=2, n_shards=3)
    seq = tbuild_vocab(CORPUS, TTok(), 2)
    for other in (ref, seq):
        assert list(got.index) == list(other.index)
        assert {w: got.vocab[w].count for w in got.index} == \
            {w: other.vocab[w].count for w in other.index}
    assert dict(got.doc_freq) == dict(ref.doc_freq)
    assert got.num_docs == ref.num_docs == len(CORPUS)


def test_distributed_nlp_imports_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.nlp.distributed")
