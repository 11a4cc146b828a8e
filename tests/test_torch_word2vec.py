"""The port's word2vec and ParagraphVectors against the JAX package.

The same numpy-seeded inputs go through JAX (its plain XLA path, and
``ops/pallas_word2vec.fused_chunk_update`` interpreted on the CPU, as the
JAX package's own tests run it) and through the port's plain twin, which
is what the port's wrapper runs for CPU tensors and what
``chip_smoke.py`` holds kernel B4 against on the card.

Tolerances:
- vocab, Huffman tables, the unigram table and pair generation: equal;
  ``_hash_shrink``: bit-equal;
- the plain twin against JAX's ``_hs_update``/``_neg_update``: 1e-6
  (both fp32; the scatter sums run in another order);
- against the interpreted Pallas kernel: the JAX tests' own bounds
  (tests/test_nlp.py:225-232), 1e-4 for syn1/syn1neg and 2e-4 for syn0,
  since that kernel rounds tables and payloads to bf16;
- whole fits from the same initial weights and JAX's random draws: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import paragraph_vectors as jpv
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu.nlp import word2vec as jw
from deeplearning4j_tpu.nlp import word_vectors as jwv
from deeplearning4j_tpu.nlp.text import DefaultTokenizerFactory as JTok
from deeplearning4j_tpu.ops import pallas_word2vec as jpw
from deeplearning4j_tpu_torch.nlp import paragraph_vectors as tpv
from deeplearning4j_tpu_torch.nlp import vocab as tvocab
from deeplearning4j_tpu_torch.nlp import word2vec as tw
from deeplearning4j_tpu_torch.nlp import word_vectors as twv
from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory as TTok
from deeplearning4j_tpu_torch.ops import fused_word2vec as fw

torch.set_num_threads(2)

CORPUS = [
    "the cat sat on the mat",
    "the dog sat on the rug",
    "a cat and a dog are friends",
    "the king rules the castle",
    "the queen rules the palace",
    "the cat chased the mouse",
    "the dog chased the ball",
    "a king and a queen wear crowns",
] * 30

FIT_TOL = 1e-6


class JaxDraws:
    """JAX's random draws, handed to the port's engines: the per-epoch
    shrink seed of ``_scan_slab`` (:199-201) and the negatives of chunk
    ``c`` (:224-228, :326-329), from ``jax.random.key(seed + 1)``."""

    def __init__(self, seed):
        self.key = jax.random.key(seed + 1)

    def _ekey(self, epoch):
        return jax.random.fold_in(self.key, epoch)

    def seed32(self, epoch):
        return int(jax.random.randint(
            jax.random.fold_in(self._ekey(epoch), 0), (), 0, 2 ** 31 - 1,
            jnp.uint32))

    def negatives(self, epoch, chunk, shape, n):
        return np.array(jax.random.randint(
            jax.random.fold_in(self._ekey(epoch), 1 + chunk), shape, 0, n))


def _caches(sentences, min_count, hs=True):
    j = jvocab.build_vocab(sentences, JTok(), min_count)
    t = tvocab.build_vocab(sentences, TTok(), min_count)
    if hs:
        jvocab.build_huffman(j)
        tvocab.build_huffman(t)
    return j, t


def _text8_sentences(n=200):
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "text8")
    with open(path) as f:
        words = f.read().split()[:n * 50]
    return [" ".join(words[i:i + 50]) for i in range(0, len(words), 50)]


@pytest.mark.parametrize("source", ["toy", "text8"])
def test_vocab_huffman_and_unigram_tables_equal(source):
    sents = CORPUS if source == "toy" else _text8_sentences()
    jc, tc = _caches(sents, 1 if source == "toy" else 2)
    assert tc.index == jc.index
    assert [tc.vocab[w].count for w in tc.index] == \
        [jc.vocab[w].count for w in jc.index]
    for a, b in zip(tvocab.encode_hs_tables(tc),
                    jvocab.encode_hs_tables(jc)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tvocab.unigram_table(tc, 5000),
                                  jvocab.unigram_table(jc, 5000))
    tt = tw.prepare_train_tables(tc, 5000)
    jt = jw.prepare_train_tables(jc, 5000)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_pair_generation_equal():
    rng = np.random.RandomState(0)
    indexed = [rng.randint(0, 50, rng.randint(1, 40)).astype(np.int32)
               for _ in range(60)]
    for a, b in zip(tw.sentence_pairs(indexed[3], 4,
                                      np.random.RandomState(1)),
                    jw.sentence_pairs(indexed[3], 4,
                                      np.random.RandomState(1))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tw.corpus_pairs(indexed, 5, slab=97),
                    jw.corpus_pairs(indexed, 5, slab=97)):
        np.testing.assert_array_equal(a, b)
    t_slabs = list(tw.corpus_pairs_slabs(indexed, 3, 500,
                                         np.random.RandomState(7)))
    j_slabs = list(jw.corpus_pairs_slabs(indexed, 3, 500,
                                         np.random.RandomState(7)))
    assert len(t_slabs) == len(j_slabs) > 1
    for ts, js in zip(t_slabs, j_slabs):
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a, b)


def test_hash_shrink_bit_equal_to_jax():
    rng = np.random.RandomState(3)
    pos = np.concatenate([np.arange(5000), rng.randint(0, 2 ** 31 - 1,
                                                       20000)]) \
        .astype(np.int32)
    for seed in [0, 1, 12345, 2 ** 31 - 2] + list(
            rng.randint(0, 2 ** 31 - 1, 6)):
        for window in (1, 3, 5, 8):
            ref = np.asarray(jw._hash_shrink(jnp.asarray(pos),
                                             jnp.uint32(seed), window))
            got = tw._hash_shrink(torch.from_numpy(pos), int(seed), window)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), ref)


def _rand_chunk(B=256, L=7, D=32, V=64, K=3, seed=0):
    """tests/test_nlp.py:_rand_chunk's inputs, as numpy."""
    rng = np.random.RandomState(seed)
    return dict(
        syn0=rng.randn(V, D).astype(np.float32) * 0.1,
        syn1=rng.randn(V, D).astype(np.float32) * 0.1,
        sneg=rng.randn(V, D).astype(np.float32) * 0.1,
        inputs=rng.randint(0, V, B).astype(np.int32),
        targets=rng.randint(0, V, B).astype(np.int32),
        codes=rng.randint(0, 2, (B, L)).astype(np.float32),
        points=rng.randint(0, V, (B, L)).astype(np.int32),
        mask=(rng.rand(B, L) < 0.7).astype(np.float32),
        negs=rng.randint(0, V, (B, K)).astype(np.int32),
        pmask=(rng.rand(B) < 0.9).astype(np.float32))


@pytest.mark.parametrize("use_hs,negative", [(True, 0), (False, 3),
                                             (True, 3)])
def test_chunk_plain_twin_matches_jax_and_pallas(use_hs, negative):
    c = _rand_chunk()
    D = c["syn0"].shape[1]
    alpha = np.float32(0.025)
    zeros = np.zeros((1, D), np.float32)
    s1 = c["syn1"] if use_hs else zeros
    sn = c["sneg"] if negative else zeros
    args = (c["syn0"], s1, sn, c["inputs"], c["targets"], c["codes"],
            c["points"], c["mask"], c["negs"], c["pmask"])
    got = fw.fused_chunk_update(*(torch.from_numpy(a) for a in args),
                                float(alpha), use_hs=use_hs,
                                negative=negative)
    plain = fw.fused_chunk_update_plain(
        *(torch.from_numpy(a) for a in args), float(alpha), use_hs=use_hs,
        negative=negative)
    for g, p in zip(got, plain):          # the CPU wrapper IS the twin
        torch.testing.assert_close(g, p, rtol=0, atol=0)

    # JAX's plain path, as _scan_slab runs it
    j = {k: jnp.asarray(v) for k, v in c.items()}
    r0, r1, rn = j["syn0"], jnp.asarray(s1), jnp.asarray(sn)
    if use_hs:
        h0, r1 = jw._hs_update(j["syn0"], j["syn1"], j["inputs"], j["codes"],
                               j["points"], j["mask"] * j["pmask"][:, None],
                               alpha)
        r0 = r0 + (h0 - j["syn0"])
    if negative:
        n0, rn = jw._neg_update(j["syn0"], j["sneg"], j["inputs"],
                                j["targets"], j["negs"], j["pmask"], alpha)
        r0 = r0 + (n0 - j["syn0"])
    for g, r in zip(got, (r0, r1, rn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)

    # the interpreted Pallas kernel, within tests/test_nlp.py's bounds
    k0, k1, kn = jpw.fused_chunk_update(
        *(jnp.asarray(a) for a in args), jnp.float32(alpha), use_hs=use_hs,
        negative=negative, block=128, interpret=True)
    assert float(np.abs(got[0].numpy() - np.asarray(k0)).max()) < 2e-4
    if use_hs:
        assert float(np.abs(got[1].numpy() - np.asarray(k1)).max()) < 1e-4
    if negative:
        assert float(np.abs(got[2].numpy() - np.asarray(kn)).max()) < 1e-4


@pytest.mark.parametrize("pair_mode,negative,buckets", [
    ("exact", 0, 1), ("masked", 5, 1), ("masked", 3, 2), ("device", 5, 1)])
def test_word2vec_fit_matches_jax(pair_mode, negative, buckets):
    """Whole fits from the same initial weights, the port given JAX's
    draws (``exact`` with negative 0 draws nothing)."""
    cfg = dict(vector_size=16, window=3, epochs=2, negative=negative,
               use_hs=True, batch_size=256, seed=3, pair_mode=pair_mode,
               depth_buckets=buckets)
    j = jw.Word2Vec(CORPUS, jw.Word2VecConfig(kernel="xla", **cfg))
    j.build_vocab()
    V = len(j.cache)
    rng = np.random.RandomState(0)
    init = (rng.uniform(-0.5, 0.5, (V, 16)).astype(np.float32) / 16,
            rng.randn(V, 16).astype(np.float32) * 0.01,
            rng.randn(V, 16).astype(np.float32) * 0.01 if negative
            else None)
    j.fit(initial_weights=init)
    t = tw.Word2Vec(CORPUS, tw.Word2VecConfig(**cfg), device="cpu")
    if pair_mode != "exact" or negative:
        t._draws = JaxDraws(cfg["seed"])
    t.fit(initial_weights=init)
    assert t.kernel_used == "plain" and t.chunks > 0
    for name in ("syn0", "syn1", "syn1neg"):
        ref = getattr(j, name)
        if ref is None:
            assert getattr(t, name) is None
            continue
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(ref), rtol=0, atol=FIT_TOL)
    # refits replay the cached slabs / stream and reproduce bit-for-bit
    if pair_mode != "exact":
        first = t.syn0.clone()
        t._draws = JaxDraws(cfg["seed"])
        t.fit(initial_weights=init)
        torch.testing.assert_close(t.syn0, first, rtol=0, atol=0)


def test_paragraph_vectors_fit_matches_jax():
    docs = [("animals", "the cat sat on the mat with the dog"),
            ("animals", "a dog and a cat are friends"),
            ("royals", "the king rules the castle"),
            ("royals", "the queen and the king wear crowns")] * 10
    cfg = dict(vector_size=16, window=3, epochs=3, batch_size=128, seed=5)
    j = jpv.ParagraphVectors(docs, jpv.ParagraphVectorsConfig(kernel="xla",
                                                              **cfg))
    j.fit()
    init = ((jax.random.uniform(jax.random.key(5), (len(j.cache), 16))
             - 0.5) / 16, np.zeros((len(j.cache), 16), np.float32))
    t = tpv.ParagraphVectors(docs, tpv.ParagraphVectorsConfig(**cfg),
                             device="cpu")
    t._draws = JaxDraws(5)
    t.fit(initial_weights=(np.array(init[0]), init[1]))
    assert t.cache.index == j.cache.index and t.labels == j.labels
    np.testing.assert_allclose(t.syn0.numpy(), np.asarray(j.syn0), rtol=0,
                               atol=FIT_TOL)
    np.testing.assert_allclose(t.syn1.numpy(), np.asarray(j.syn1), rtol=0,
                               atol=FIT_TOL)
    v0 = (jax.random.uniform(jax.random.key(5 + 7), (16,)) - 0.5) / 16
    t._infer_start = lambda: torch.from_numpy(np.array(v0))
    text = "the cat and the king"
    np.testing.assert_allclose(t.infer_vector(text), j.infer_vector(text),
                               rtol=0, atol=FIT_TOL)
    assert not t.infer_vector("zzz qqq").any()
    assert [w for w, _ in t.nearest_labels(text, 2)] == \
        [w for w, _ in j.nearest_labels(text, 2)]


def test_word_vector_files_byte_identical_and_queries_agree(tmp_path):
    jc, tc = _caches(CORPUS, 1, hs=False)
    vecs = np.random.RandomState(4).randn(len(tc), 12).astype(np.float32)
    jv = jwv.WordVectors(jc, jnp.asarray(vecs))
    tv = twv.WordVectors(tc, torch.from_numpy(vecs))
    for writer in ("write_word_vectors", "write_word_vectors_binary"):
        getattr(jwv, writer)(jv, str(tmp_path / "j"))
        getattr(twv, writer)(tv, str(tmp_path / "t"))
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    loaded = twv.load_word_vectors_binary(str(tmp_path / "t"), device="cpu")
    np.testing.assert_array_equal(loaded.vectors.numpy(), vecs)
    twv.write_word_vectors(tv, str(tmp_path / "t"))
    loaded = twv.load_word_vectors(str(tmp_path / "t"), device="cpu")
    assert loaded.cache.index == tc.index
    np.testing.assert_allclose(loaded.vectors.numpy(), vecs, atol=1e-6)
    got, ref = tv.words_nearest("cat", 5), jv.words_nearest("cat", 5)
    assert [w for w, _ in got] == [w for w, _ in ref]
    assert [s for _, s in got] == pytest.approx([s for _, s in ref],
                                                abs=1e-6)
    assert [w for w, _ in tv.words_nearest(vecs[3], 4)] == \
        [w for w, _ in jv.words_nearest(vecs[3], 4)]
    assert tv.similarity("cat", "dog") == pytest.approx(
        jv.similarity("cat", "dog"), abs=1e-6)


def test_devices_and_kernel_modes_raise_where_they_must():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tw.Word2Vec(CORPUS)
    cfg = tw.Word2VecConfig(vector_size=8, epochs=1, batch_size=64)
    with pytest.raises(ValueError, match="kernel='cuda'"):
        tw.Word2Vec(CORPUS, tw.Word2VecConfig(
            vector_size=8, epochs=1, batch_size=64, kernel="cuda"),
            device="cpu").fit()
    with pytest.raises(ValueError, match="kernel must be one of"):
        tw.Word2Vec(CORPUS, tw.Word2VecConfig(kernel="pallas"),
                    device="cpu").fit()
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        tw.Word2Vec(CORPUS, cfg, device="cpu").fit(mesh=object())
    c = {k: torch.from_numpy(v) for k, v in _rand_chunk().items()}
    before = fw.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fw.fused_chunk_update_cuda(
            c["syn0"], c["syn1"], c["sneg"], c["inputs"], c["targets"],
            c["codes"], c["points"], c["mask"], c["negs"], c["pmask"],
            0.025, use_hs=True, negative=3)
    assert fw.launches == before


@pytest.mark.parametrize("dim", [8, 100, 512, 600, 1024])
def test_auto_takes_the_kernel_for_cuda_tensors_at_any_width(dim):
    """B4 takes every width (rows past 512 take its wide path), so auto
    never gives way to the plain twin on the card: it resolves to the
    kernel for CUDA tensors and to the plain twin only for CPU ones."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tw._resolve("auto", dim, cuda, 64) == "cuda"
    assert tw._resolve("cuda", dim, cuda, 64) == "cuda"
    assert tw._resolve("auto", dim, cpu, 64) == "plain"
    assert tw._resolve("plain", dim, cuda, 64) == "plain"


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_twin():
    """On a CUDA card: B4 against its plain twin (fp32, unordered
    atomics; the JAX test shape needs no more than 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card "
                    "(python3 chip_smoke.py covers it there)")
    c = {k: torch.from_numpy(v).cuda() for k, v in _rand_chunk().items()}
    args = (c["syn0"], c["syn1"], c["sneg"], c["inputs"], c["targets"],
            c["codes"], c["points"], c["mask"], c["negs"], c["pmask"],
            0.025)
    before = fw.launches
    got = fw.fused_chunk_update(*args, use_hs=True, negative=3)
    assert fw.launches == before + 1
    ref = fw.fused_chunk_update_plain(*args, use_hs=True, negative=3)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_kernel_wide_rows_match_plain_twin():
    """On a CUDA card: B4's wide path (D > 512) against its plain twin
    (fp32, unordered atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card "
                    "(python3 chip_smoke.py covers it there)")
    c = {k: torch.from_numpy(v).cuda()
         for k, v in _rand_chunk(D=600).items()}
    args = (c["syn0"], c["syn1"], c["sneg"], c["inputs"], c["targets"],
            c["codes"], c["points"], c["mask"], c["negs"], c["pmask"],
            0.025)
    ref = fw.fused_chunk_update_plain(*args, use_hs=True, negative=3)
    # the CUDA entry updates its tables in place: hand it copies
    got = fw.fused_chunk_update_cuda(*(a.clone() for a in args[:3]),
                                     *args[3:], use_hs=True, negative=3)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)


# -- the update contract: untouched rows, copies, in place ------------------

def _chunk_args(c, use_hs, negative):
    D = c["syn0"].shape[1]
    zeros = np.zeros((1, D), np.float32)
    arrays = (c["syn0"], c["syn1"] if use_hs else zeros,
              c["sneg"] if negative else zeros, c["inputs"], c["targets"],
              c["codes"], c["points"], c["mask"], c["negs"], c["pmask"])
    return tuple(torch.from_numpy(a) for a in arrays) + (0.025,)


def _touched_rows(c, use_hs, negative):
    """Rows of (syn0, syn1, syn1neg) the chunk hits, as boolean masks."""
    V = c["syn0"].shape[0]
    live = c["pmask"] != 0
    hs = (c["mask"] * c["pmask"][:, None]) != 0
    rows0, rows1, rowsn = (np.zeros(V, bool) for _ in range(3))
    if use_hs:
        rows1[c["points"][hs]] = True
        rows0[c["inputs"][hs.any(1)]] = True
    if negative:
        rowsn[c["targets"][live]] = True
        rowsn[c["negs"][live][c["negs"][live] != c["targets"][live, None]]] \
            = True
        rows0[c["inputs"][live]] = True
    return rows0, rows1, rowsn


@pytest.mark.parametrize("use_hs,negative", [(True, 0), (False, 3),
                                             (True, 3)])
def test_plain_twin_leaves_untouched_rows_bit_identical(use_hs, negative):
    """An untouched row has count 0 and sum 0: it keeps its bits, which is
    what lets B4 update only the rows a chunk touches."""
    c = _rand_chunk(B=24, V=64)
    args = _chunk_args(c, use_hs, negative)
    got = fw.fused_chunk_update_plain(*args, use_hs=use_hs,
                                      negative=negative)
    for table, new, hit in zip(args[:3], got,
                               _touched_rows(c, use_hs, negative)):
        if table.shape[0] == 1:          # an absent objective's dummy
            continue
        assert (~hit).any() and hit.any()
        assert torch.equal(new[torch.from_numpy(~hit)],
                           table[torch.from_numpy(~hit)])
        assert not torch.equal(new[torch.from_numpy(hit)],
                               table[torch.from_numpy(hit)])


def test_fused_chunk_update_does_not_change_its_inputs():
    """The JAX-signature entry keeps JAX's functional contract."""
    args = _chunk_args(_rand_chunk(), True, 3)
    before = [a.clone() for a in args[:-1]]
    got = fw.fused_chunk_update(*args, use_hs=True, negative=3)
    for a, b in zip(args, before):
        assert torch.equal(a, b)
    assert all(g.data_ptr() != a.data_ptr() for g, a in zip(got, args))


@pytest.mark.parametrize("pair_mode", ["masked", "device"])
def test_refit_leaves_an_earlier_word_vectors_unchanged(pair_mode):
    """Every fit trains tables of its own, so the CUDA chunk update's
    in-place writes never reach a WordVectors an earlier fit returned."""
    w2v = tw.Word2Vec(CORPUS, tw.Word2VecConfig(
        vector_size=8, epochs=1, batch_size=64, negative=2,
        pair_mode=pair_mode), device="cpu")
    first = w2v.fit()
    kept = first.vectors.clone()
    second = w2v.fit(initial_weights=(w2v.syn0, w2v.syn1, w2v.syn1neg))
    assert torch.equal(first.vectors, kept)
    assert not torch.equal(second.vectors, kept)


def _cuda_chunk(D):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card "
                    "(python3 chip_smoke.py covers it there)")
    c = _rand_chunk(D=D)
    args = _chunk_args(c, True, 3)
    return c, tuple(a.cuda() if torch.is_tensor(a) else a for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 600])
def test_cuda_kernel_updates_in_place_only_touched_rows(D):
    """On a CUDA card: fused_chunk_update_cuda writes the tables it is
    given (narrow and wide paths), matches the plain twin, and leaves
    every untouched row's bits alone; fused_chunk_update leaves its
    inputs alone."""
    c, args = _cuda_chunk(D)
    tables = [a.clone() for a in args[:3]]
    ref = fw.fused_chunk_update_plain(*args, use_hs=True, negative=3)
    before = fw.launches
    got = fw.fused_chunk_update_cuda(*tables, *args[3:], use_hs=True,
                                     negative=3)
    assert fw.launches == before + 1
    assert all(g is t for g, t in zip(got, tables))
    for g, r, a, hit in zip(got, ref, args, _touched_rows(c, True, 3)):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)
        keep = torch.from_numpy(~hit).cuda()
        assert torch.equal(g[keep], a[keep])
    orig = [a.clone() for a in args[:3]]
    copies = fw.fused_chunk_update(*args, use_hs=True, negative=3)
    for g, a, o in zip(copies, args, orig):
        assert g.data_ptr() != a.data_ptr() and torch.equal(a, o)
