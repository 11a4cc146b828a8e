"""The port's bag-of-words / TF-IDF vectorizers and newsgroups loader
against the JAX package's, on the CPU.

After ``tests/test_nlp.py``'s vectorizer checks and the newsgroups
loader: the same texts give equal vocabularies, equal counts and TF-IDF
within 1e-7 (fp32 tensors on the vectorizer's device in the port); the
surrogate corpus (``RandomState(seed)`` in both packages) gives the same
documents, labels and vectorized ``DataSet``; the iterator's batches are
equal; a local label directory is read the same by both packages.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import newsgroups as jng
from deeplearning4j_tpu.nlp import vectorizers as jvec
from deeplearning4j_tpu_torch.datasets import newsgroups as tng
from deeplearning4j_tpu_torch.nlp import vectorizers as tvec

from test_torch_paged import assert_no_jax

TEXTS = ["the cat sat on the mat", "the dog sat on the log",
         "cats and dogs are pets", "a cat chased a dog around the mat",
         "nothing in common here", ""]


def test_imports_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.nlp.vectorizers",
                  "deeplearning4j_tpu_torch.datasets.newsgroups",
                  "deeplearning4j_tpu_torch.nlp")


def test_nlp_package_exports():
    from deeplearning4j_tpu_torch import nlp

    assert nlp.BagOfWordsVectorizer is tvec.BagOfWordsVectorizer
    assert nlp.TfidfVectorizer is tvec.TfidfVectorizer
    assert nlp.InvertedIndex is tvec.InvertedIndex


@pytest.mark.parametrize("min_freq", [1, 2])
def test_bag_of_words_counts_equal(min_freq):
    t = tvec.BagOfWordsVectorizer(min_word_frequency=min_freq, device="cpu")
    j = jvec.BagOfWordsVectorizer(min_word_frequency=min_freq)
    got, want = t.fit_transform(TEXTS), np.asarray(j.fit_transform(TEXTS))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert t.cache.words() == j.cache.words()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t.transform(["the cat", "zebra"]).numpy(),
                                  np.asarray(j.transform(["the cat",
                                                          "zebra"])))
    assert dict(t.index.postings) == dict(j.index.postings)
    for w in ("the", "cat", "zebra"):
        assert t.index.documents_containing(w) == \
            j.index.documents_containing(w)
        assert t.index.doc_frequency(w) == j.index.doc_frequency(w)
    assert t.index.num_docs() == j.index.num_docs() == len(TEXTS)


def test_tfidf_equal():
    t = tvec.TfidfVectorizer(device="cpu")
    j = jvec.TfidfVectorizer()
    got, want = t.fit_transform(TEXTS), np.asarray(j.fit_transform(TEXTS))
    np.testing.assert_allclose(t.idf(), j.idf(), atol=1e-7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    np.testing.assert_array_equal(t.matrix(TEXTS), got.numpy())


def test_surrogate_corpus_and_loader_equal():
    assert tng._surrogate_corpus(40, 3) == jng._surrogate_corpus(40, 3)
    for tfidf in (True, False):
        t = tng.NewsGroupsLoader(tfidf=tfidf, n_docs=60, seed=1,
                                 device="cpu")
        j = jng.NewsGroupsLoader(tfidf=tfidf, n_docs=60, seed=1)
        assert t.synthetic and j.synthetic
        assert t.label_names == j.label_names
        assert t.doc_labels == j.doc_labels
        assert t.num_examples == j.num_examples == 60
        np.testing.assert_allclose(t.data.features, j.data.features,
                                   atol=1e-7)
        np.testing.assert_array_equal(t.data.labels, j.data.labels)
        np.testing.assert_allclose(
            t.vectorizer.transform(t.texts).numpy(), j.data.features,
            atol=1e-7)


def test_iterator_batches_equal():
    t = tng.NewsGroupsDataSetIterator(16, num_examples=50, n_docs=60,
                                      seed=2, device="cpu")
    j = jng.NewsGroupsDataSetIterator(16, num_examples=50, n_docs=60,
                                      seed=2)
    tb, jb = [], []
    while t.has_next():
        tb.append(t.next())
    while j.has_next():
        jb.append(j.next())
    assert [b.num_examples() for b in tb] == [16, 16, 16, 2]
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a.features.numpy(),
                                   np.asarray(b.features), atol=1e-7)
        np.testing.assert_array_equal(a.labels.numpy(), np.asarray(b.labels))
    assert t.input_columns() == j.input_columns()
    assert t.total_outcomes() == j.total_outcomes() == 4
    t.reset()
    assert t.has_next()


def test_label_directory_read_equal(tmp_path):
    docs = {"alt.atheism": ["god debate", "belief and doubt"],
            "sci.med": ["doctor patient care", "the clinic",
                        "medicine dose"],
            "empty": []}
    for label, texts in docs.items():
        d = tmp_path / label
        d.mkdir()
        for i, text in enumerate(texts):
            (d / f"{i:03d}.txt").write_text(text)
    (tmp_path / "stray.txt").write_text("not a label")
    (tmp_path / "sci.med" / "sub").mkdir()
    assert tng.read_label_directories(str(tmp_path)) == \
        jng.read_label_directories(str(tmp_path))
    t = tng.NewsGroupsLoader(tfidf=False, root_dir=str(tmp_path),
                             device="cpu")
    j = jng.NewsGroupsLoader(tfidf=False, root_dir=str(tmp_path))
    assert not t.synthetic
    assert t.label_names == j.label_names
    np.testing.assert_array_equal(t.data.features, j.data.features)
    np.testing.assert_array_equal(t.data.labels, j.data.labels)
    with pytest.raises(ValueError):
        tng.read_label_directories(str(tmp_path / "empty"))
