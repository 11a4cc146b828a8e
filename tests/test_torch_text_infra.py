"""The port's JAX-free text infrastructure against the JAX package's,
on the CPU.

After ``tests/test_nlp_text_infra.py``: the same words and sentences go
through both packages' Porter stemmer, perceptron tagger, learned
chunker, annotator pipeline, sqlite inverted index, SentiWordNet scorer
and ``TreeParser``, and every result is identical.  The tagger and the
chunker train with ``random.Random(seed)`` in both packages, so
``default_tagger()`` and ``default_chunker()`` learn the same weights.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import annotators as jann
from deeplearning4j_tpu.nlp import chunker as jchunk
from deeplearning4j_tpu.nlp import inverted_index as jii
from deeplearning4j_tpu.nlp import pos as jpos
from deeplearning4j_tpu.nlp import sentiment as jsent
from deeplearning4j_tpu.nlp import stemmer as jstem
from deeplearning4j_tpu.nlp import treeparser as jtp
from deeplearning4j_tpu_torch.nlp import annotators as tann
from deeplearning4j_tpu_torch.nlp import chunker as tchunk
from deeplearning4j_tpu_torch.nlp import inverted_index as tii
from deeplearning4j_tpu_torch.nlp import pos as tpos
from deeplearning4j_tpu_torch.nlp import sentiment as tsent
from deeplearning4j_tpu_torch.nlp import stemmer as tstem
from deeplearning4j_tpu_torch.nlp import treeparser as ttp

from test_torch_paged import assert_no_jax

WORDS = ["caresses", "ponies", "ties", "cats", "feed", "agreed",
         "plastered", "motoring", "hopping", "filing", "happy", "sky",
         "relational", "conditional", "digitizer", "operator",
         "decisiveness", "hopefulness", "triplicate", "formalize",
         "electriciti", "hopeful", "goodness", "adjustable", "defensible",
         "replacement", "adoption", "activate", "effective", "rate",
         "controll", "roll", "generalizations", "oscillators", "Running"]

SENTENCES = [
    "the happy dog chased a small bird",
    "she was reading an interesting book",
    "engineers design powerful systems",
    "the very tall man walked slowly",
    "workers repaired the damaged road quickly",
    "she admired the painted wall",
    "the quick brown fox jumps over the lazy dog",
    "the food was delicious and wonderful",
    "a terrible awful disaster",
    "the results were not good",
    "wonderful excellent perfect",
    "the train arrives at noon",
]


def tree_repr(t):
    if t.is_leaf:
        return (t.label, t.word)
    return (t.label, tree_repr(t.left), tree_repr(t.right))


def test_imports_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.nlp.stemmer",
                  "deeplearning4j_tpu_torch.nlp.pos",
                  "deeplearning4j_tpu_torch.nlp.chunker",
                  "deeplearning4j_tpu_torch.nlp.annotators",
                  "deeplearning4j_tpu_torch.nlp.inverted_index",
                  "deeplearning4j_tpu_torch.nlp.sentiment",
                  "deeplearning4j_tpu_torch.nlp.treeparser")


def test_stems_equal():
    j, t = jstem.PorterStemmer(), tstem.PorterStemmer()
    for w in WORDS:
        assert t.stem(w) == j.stem(w), w
        assert tstem.stem(w) == jstem.stem(w), w


@pytest.mark.parametrize("sent", SENTENCES)
def test_tags_and_chunks_equal(sent):
    toks = sent.split()
    tagged = tpos.default_tagger().tag(toks)
    assert tagged == jpos.default_tagger().tag(toks)
    assert tpos.pos_tag(toks) == jpos.pos_tag(toks)
    assert tchunk.default_chunker().chunk(tagged) == \
        jchunk.default_chunker().chunk(tagged)
    assert ttp._chunk(tagged) == jtp._chunk(tagged)


def test_default_tagger_and_chunker_weights_identical():
    """``random.Random(seed)`` training: the same learned weights."""
    assert tpos.default_tagger().to_json() == jpos.default_tagger().to_json()
    jm, tm = jchunk.default_chunker(), tchunk.default_chunker()
    assert tm.weights == jm.weights


def test_trained_tagger_and_chunker_equal():
    t = tpos.AveragedPerceptronTagger().train(tpos.SEED_CORPUS, n_iter=5)
    j = jpos.AveragedPerceptronTagger().train(jpos.SEED_CORPUS, n_iter=5)
    assert t.to_json() == j.to_json()
    corpus = tchunk.annotated_corpus()
    assert corpus == jchunk.annotated_corpus()
    tm = tchunk.ChunkPerceptron().train(corpus[:-15])
    jm = jchunk.ChunkPerceptron().train(jchunk.annotated_corpus()[:-15])
    for sent in corpus[-15:]:
        tagged = [(w, g) for w, g, _ in sent]
        assert tm.actions(tagged) == jm.actions(tagged)


def test_annotations_equal():
    text = "The happy dog chased a bird. It was running quickly."
    ta = tann.AnalysisPipeline.default().process(text)
    ja = jann.AnalysisPipeline.default().process(text)
    assert ta.sentences == ja.sentences
    assert ta.tokens == ja.tokens
    assert ta.pos_tags == ja.pos_tags
    assert ta.stems == ja.stems
    for sent in SENTENCES:
        assert tann.PosFilterTokenizerFactory(["NN"]).create(sent) == \
            jann.PosFilterTokenizerFactory(["NN"]).create(sent)
        assert tann.StemmingTokenizerFactory().create(sent) == \
            jann.StemmingTokenizerFactory().create(sent)


def test_sqlite_index_search_equal(tmp_path):
    docs = [("the cat sat on the mat", "cats"),
            ("the dog sat on the rug", "dogs"),
            ("cats and dogs are pets", None)]
    out = {}
    for name, mod in (("jax", jii), ("torch", tii)):
        path = str(tmp_path / f"{name}.db")
        with mod.SqliteInvertedIndex(path) as idx:
            ids = [idx.add_document(text.split(), label=label)
                   for text, label in docs]
        with mod.SqliteInvertedIndex(path) as idx:
            out[name] = (
                ids, idx.num_docs(), idx.documents_containing("sat"),
                idx.doc_frequency("the"), idx.term_frequency("the"),
                [idx.document(i) for i in ids], idx.search(["cat", "mat"]),
                idx.search("dogs"), idx.search(["dog", "dogs"]),
                sorted(idx.vocab()), list(idx.iter_documents()))
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == 3


def test_sentiwordnet_scores_and_classes_equal(tmp_path):
    t, j = tsent.SentiWordNet(), jsent.SentiWordNet()
    assert len(t) == len(j) > 100
    for w in ("good", "terrible", "xylophone", "wonderful", "bad"):
        assert t.score_word(w) == j.score_word(w)
    for sent in SENTENCES:
        assert t.score(sent) == j.score(sent)
        assert t.classify(sent) == j.classify(sent)
    for s in np.linspace(-1.0, 1.0, 41):
        assert t.class_for_score(s) == j.class_for_score(s)
    lex = tmp_path / "mini.txt"
    lex.write_text("a\t1\t1.0\t0\tmixed#1\tg\n"
                   "a\t2\t0\t0.5\tmixed#2\tg\n")
    assert tsent.SentiWordNet(str(lex)).score_word("mixed", "a") == \
        jsent.SentiWordNet(str(lex)).score_word("mixed", "a") == \
        pytest.approx(0.5)


@pytest.mark.parametrize("mode", ["model", "rules"])
def test_treeparser_trees_equal(mode):
    tp, jp = ttp.TreeParser(mode=mode), jtp.TreeParser(mode=mode)
    for i, sent in enumerate(SENTENCES):
        label = i % 5
        assert tree_repr(tp.parse(sent, label=label)) == \
            tree_repr(jp.parse(sent, label=label))
        assert tree_repr(tp.parse(sent)) == tree_repr(jp.parse(sent))
    labeled = [(s, i % 5) for i, s in enumerate(SENTENCES)]
    assert [tree_repr(x) for x in ttp.trees_from_raw(labeled)] == \
        [tree_repr(x) for x in jtp.trees_from_raw(labeled)]
    assert ttp.tokenize(SENTENCES[6]) == jtp.tokenize(SENTENCES[6])
