"""The port's RNTN, Viterbi decoding and moving windows against the JAX
package's, on the CPU.

After ``tests/test_rntn_viterbi.py``:
- RNTN at dim 8 and ``max_nodes=32`` over ``TreeParser`` trees, both
  packages from the reference's ``init_params`` weights (the port takes
  them through ``rntn.params_from_numpy``): ``tree_loss``,
  ``batch_loss`` and the gradients within rtol 1e-5 / atol 1e-6; five
  AdaGrad steps (``RNTN.fit``) within 1e-5; ``predict_root``,
  ``predict_nodes`` (padding included) and ``RNTNEval``'s confusion
  matrices equal;
- Viterbi: paths equal and log-probabilities within 1e-6, over random
  emissions, a prior, one step and exact ties (first index wins in both);
  ``transitions_from_labels`` within 1e-6;
- moving windows, ``sentence_features`` and ``Word2VecDataSetIterator``'s
  batches equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import moving_window as jmw
from deeplearning4j_tpu.nlp import rntn as jr
from deeplearning4j_tpu.nlp.treeparser import trees_from_raw as jtrees
from deeplearning4j_tpu.utils import viterbi as jv
from deeplearning4j_tpu_torch.nlp import moving_window as tmw
from deeplearning4j_tpu_torch.nlp import rntn as tr
from deeplearning4j_tpu_torch.nlp.treeparser import trees_from_raw as ttrees
from deeplearning4j_tpu_torch.utils import viterbi as tv

from test_torch_paged import assert_no_jax

torch.set_num_threads(2)

LABELED = [
    ("a wonderful and excellent movie", 4),
    ("the film was great and beautiful", 3),
    ("an amazing story with lovely acting", 4),
    ("a terrible and awful movie", 0),
    ("the film was bad and ugly", 1),
    ("the quick brown fox jumps over the lazy dog", 2),
    ("a horrible story with nasty acting", 0),
    ("fine", 2),
]
CFG = dict(vocab_size=64, dim=8, n_classes=5, max_nodes=32, adagrad_lr=0.05)


def test_imports_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.nlp.rntn",
                  "deeplearning4j_tpu_torch.nlp.moving_window",
                  "deeplearning4j_tpu_torch.utils.viterbi")


@pytest.fixture(scope="module")
def models():
    """Both packages' RNTN over the same trees, from the reference's
    initial weights."""
    jm = jr.RNTN(jr.RNTNConfig(**CFG), jtrees(LABELED), seed=3)
    p0 = {k: np.asarray(v) for k, v in jm.params.items()}
    tm = tr.RNTN(tr.RNTNConfig(**CFG), ttrees(LABELED), device="cpu",
                 params=tr.params_from_numpy(p0, "cpu"))
    assert tm.vocab == jm.vocab
    return jm, tm, p0


def test_params_from_numpy_keeps_the_weights(models):
    _, tm, p0 = models
    for k, v in p0.items():
        assert tm.params[k].dtype == torch.float32
        np.testing.assert_array_equal(tm.params[k].numpy(), v)


def test_compiled_trees_equal(models):
    jm, tm, _ = models
    jb = jm._batch_arrays(jm.trees)
    tb = tm._batch_arrays(tm.trees)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_losses_and_grads_match_jax(models):
    jm, tm, p0 = models
    jcfg = jm.cfg
    jb = jm._batch_arrays(jm.trees)
    tb = tm._batch_arrays(tm.trees)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jloss = jax.jit(lambda p, t: jr.tree_loss(p, t, jcfg))
    jfwd = jax.jit(jr.forward_tree)
    for i in range(len(LABELED)):
        jt = {k: v[i] for k, v in jb.items()}
        tt = {k: v[i] for k, v in tb.items()}
        np.testing.assert_allclose(
            float(tr.tree_loss(tm.params, tt, tm.cfg)),
            float(jloss(jp, jt)), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            tr.forward_tree(tm.params, tt).numpy(),
            np.asarray(jfwd(jp, jt)), rtol=1e-5, atol=1e-6)
    jl, jg = jax.value_and_grad(jr.batch_loss)(jp, jb, jcfg)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tm.params.items()}
    tl = tr.batch_loss(leaves, tb, tm.cfg)
    tg = torch.autograd.grad(tl, [leaves[k] for k in tr.PARAM_NAMES])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-6)
    for k, g in zip(tr.PARAM_NAMES, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_five_adagrad_steps_and_predictions_match_jax():
    jm = jr.RNTN(jr.RNTNConfig(**CFG), jtrees(LABELED), seed=3)
    p0 = {k: np.asarray(v) for k, v in jm.params.items()}
    tm = tr.RNTN(tr.RNTNConfig(**CFG), ttrees(LABELED), device="cpu",
                 params=tr.params_from_numpy(p0, "cpu"))
    jl, tl = jm.fit(epochs=5), tm.fit(epochs=5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    for k in tr.PARAM_NAMES:
        np.testing.assert_allclose(tm.params[k].numpy(),
                                   np.asarray(jm.params[k]), atol=1e-5,
                                   err_msg=k)
    jb = jm._batch_arrays(jm.trees)
    tb = tm._batch_arrays(tm.trees)
    np.testing.assert_array_equal(
        tr.predict_nodes(tm.params, tb).numpy(),
        np.asarray(jax.vmap(lambda t: jr.predict_nodes(jm.params, t))(jb)))
    np.testing.assert_array_equal(
        tr.predict_root(tm.params, tb).numpy(),
        np.asarray(jax.vmap(lambda t: jr.predict_root(jm.params, t))(jb)))
    assert [tm.predict(t) for t in tm.trees] == \
        [jm.predict(t) for t in jm.trees]
    je, te = jr.RNTNEval(), tr.RNTNEval()
    je.eval(jm, jm.trees)
    te.eval(tm, tm.trees)
    np.testing.assert_array_equal(te.confusion, je.confusion)
    np.testing.assert_array_equal(te._root_counts, je._root_counts)
    assert te.stats() == je.stats()
    internal = sum((t.size() - 1) // 2 for t in tm.trees)
    assert te.confusion.sum() == internal


def test_seeded_init_trains():
    """The port's own ``torch.Generator`` weights: the reference's
    scales, and the loss falls on the toy corpus."""
    tm = tr.RNTN(tr.RNTNConfig(**CFG), ttrees(LABELED), seed=0,
                 device="cpu")
    assert tm.params["V"].shape == (8, 16, 16)
    assert float(tm.params["b"].abs().sum()) == 0.0
    losses = tm.fit(epochs=40)
    assert losses[-1] < losses[0] * 0.8


# -- viterbi ----------------------------------------------------------------

def _emissions(seed, b, t, k):
    rng = np.random.RandomState(seed)
    return np.log(rng.dirichlet(np.ones(k), size=(b, t))).astype(np.float32)


@pytest.mark.parametrize("b,t,k,prior", [(3, 7, 4, False), (2, 12, 5, True),
                                         (4, 1, 3, False)])
def test_viterbi_matches_jax(b, t, k, prior):
    em = _emissions(b * t + k, b, t, k)
    rng = np.random.RandomState(k)
    seqs = [rng.randint(k, size=9) for _ in range(6)]
    tj = jv.transitions_from_labels(seqs, k, smoothing=0.5)
    tt = tv.transitions_from_labels(seqs, k, smoothing=0.5, device="cpu")
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6)
    pr = (np.log(rng.dirichlet(np.ones(k))).astype(np.float32)
          if prior else None)
    pj, lj = jv.decode_batch(em, tj, pr)
    pt, lt = tv.decode_batch(torch.from_numpy(em), tt,
                             None if pr is None else torch.from_numpy(pr))
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-6)
    for i in range(b):
        p1, l1 = tv.decode(torch.from_numpy(em[i]), tt,
                           None if pr is None else torch.from_numpy(pr))
        q1, m1 = jv.decode(em[i], tj, pr)
        np.testing.assert_array_equal(p1.numpy(), np.asarray(q1))
        np.testing.assert_allclose(float(l1), float(m1), atol=1e-6)


def test_viterbi_ties_take_the_first_index():
    em = np.zeros((2, 5, 3), np.float32)
    em[1, 2] = [0.0, -1.0, 0.0]
    trans = np.log(np.full((3, 3), 1 / 3, np.float32))
    pj, lj = jv.decode_batch(em, trans)
    pt, lt = tv.decode_batch(torch.from_numpy(em), torch.from_numpy(trans))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert pt.numpy().tolist() == [[0] * 5] * 2
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-6)


# -- moving windows ---------------------------------------------------------

class _Vectors:
    """A WordVectors-like table both packages' windows read."""

    def __init__(self, words, dim=4, seed=0):
        rng = np.random.RandomState(seed)
        self.table = {w: rng.randn(dim).astype(np.float32) for w in words}
        self.dim = dim

    def word_vector(self, w):
        return self.table.get(w)


SENTS = [("the cat sat on the mat", ["DT", "NN", "VBD", "IN", "DT", "NN"]),
         ("a dog ran", ["DT", "NN", "VBD"]),
         ("dogs bark", ["NNS", "VBP"])]


def test_windows_and_features_equal():
    vecs = _Vectors(["the", "cat", "sat", "on", "a", "dog", "dogs"])
    for text, _ in SENTS:
        for size in (1, 3, 5):
            tw, jw = tmw.windows(text, size), jmw.windows(text, size)
            assert [(w.words, w.focus_index, w.begin, w.end, w.focus)
                    for w in tw] == \
                [(w.words, w.focus_index, w.begin, w.end, w.focus)
                 for w in jw]
            np.testing.assert_array_equal(
                tmw.sentence_features(text, vecs, size),
                jmw.sentence_features(text, vecs, size))
    with pytest.raises(ValueError):
        tmw.windows("a b", window_size=4)


def test_word2vec_dataset_iterator_equal():
    vecs = _Vectors(["the", "cat", "sat", "on", "a", "dog", "dogs"])
    labels = ["DT", "NN", "NNS", "VBD", "VBP", "IN"]
    ti = tmw.Word2VecDataSetIterator(vecs, SENTS, labels, batch_size=4,
                                     window_size=3, device="cpu")
    ji = jmw.Word2VecDataSetIterator(vecs, SENTS, labels, batch_size=4,
                                     window_size=3)
    tb, jb = list(ti), list(ji)
    assert len(tb) == len(jb) == 3
    for t, j in zip(tb, jb):
        assert isinstance(t.features, torch.Tensor)
        assert t.features.dtype == torch.float32
        np.testing.assert_array_equal(t.features.numpy(),
                                      np.asarray(j.features))
        np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    assert len(list(ti)) == 3                       # reset on iteration
    with pytest.raises(ValueError):
        tmw.Word2VecDataSetIterator(vecs, [("a b", ["DT"])], labels,
                                    device="cpu")
