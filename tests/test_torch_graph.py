"""The port's GraphBuilder (``ops/graph.py``) against the JAX
reference's: the same graphs over the same numpy variables and inputs
give the same values and gradients, and the same errors.

Tolerance: values and gradients within rtol 1e-6 (atol 1e-7), the same
fp32 arithmetic in each framework's op order.  The two packages' graph
texts (a jaxpr, an fx graph) are never compared: each is checked for
the ops it must hold.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.graph import GraphBuilder as JGraph
from deeplearning4j_tpu_torch.ops.graph import GraphBuilder

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-7)


def _tgraph():
    return GraphBuilder(device="cpu")


def _docstring_graph(g, w0):
    """The module docstring's graph (reference ``ops/graph.py:12-21``)."""
    x = g.placeholder("x", (8, 4))
    w = g.variable("w", w0)
    b = g.variable("b", np.zeros(2, np.float32))
    y = g.softmax(g.add(g.matmul(x, w), b))
    return g.mean(g.square(g.sub(y, g.placeholder("t", (8, 2)))))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_docstring_graph_values_and_gradients_equal_reference():
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(4, 2)).astype(np.float32)
    feeds = [dict(x=rng.normal(size=(8, 4)).astype(np.float32),
                  t=rng.normal(size=(8, 2)).astype(np.float32))
             for _ in range(3)]
    tg, jg = _tgraph(), JGraph()
    tl, jl = _docstring_graph(tg, w0), _docstring_graph(jg, w0)
    tf, jf, tgr, jgr = tg.compile(tl), jg.compile(jl), tg.grad(tl), \
        jg.grad(jl)
    for feed in feeds:
        np.testing.assert_allclose(_np(tf(**feed)), _np(jf(**feed)), **TOL)
        tgrads, jgrads = tgr(**feed), jgr(**feed)
        assert sorted(tgrads) == sorted(jgrads) == ["b", "w"]
        for k in jgrads:
            np.testing.assert_allclose(_np(tgrads[k]), _np(jgrads[k]), **TOL)
    # set_variable reaches compiled values and gradients, and grad(wrt=)
    # differentiates only what it names
    tg.set_variable("w", w0 * 2)
    jg.set_variable("w", w0 * 2)
    np.testing.assert_allclose(_np(tf(**feeds[0])), _np(jf(**feeds[0])),
                               **TOL)
    only_b = tg.grad(tl, wrt=["b"])(**feeds[0])
    assert list(only_b) == ["b"]
    np.testing.assert_allclose(_np(only_b["b"]),
                               _np(jg.grad(jl, wrt=["b"])(**feeds[0])["b"]),
                               **TOL)


@pytest.mark.parametrize("op,kw", [
    ("sum", {}), ("mean", {"axis": 0}), ("max", {"axis": 1}),
    ("min", {"axis": 0, "keepdims": True}), ("sum", {"axis": (0, 1)})])
def test_reductions_equal_reference(op, kw):
    x = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
    outs = []
    for g in (_tgraph(), JGraph()):
        n = g.apply(op, g.placeholder("x", (3, 5)), **kw)
        outs.append(_np(g.compile(n)(x=x)))
    assert outs[0].shape == outs[1].shape
    np.testing.assert_allclose(outs[0], outs[1], **TOL)


def test_shape_ops_unary_and_registry_ops_equal_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 4)).astype(np.float32)
    outs = []
    for g in (_tgraph(), JGraph()):
        p = g.placeholder("x", (2, 3, 4))
        a = g.transpose(p)                       # reversed axes
        b = g.transpose(p, (1, 0, 2))
        c = g.reshape(p, (6, 4))
        d = g.apply("softplus", c)               # the activation registry
        e = g.maximum(g.tanh(c), g.neg(g.abs(c)))
        outs.append([_np(g.compile(n)(x=x)) for n in (a, b, c, d, e)])
    for got, want in zip(*outs):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_graph_grad_descends():
    """Gradient descent on the symbolic graph learns a linear map (the
    reference's test)."""
    g = _tgraph()
    x = g.placeholder("x", (32, 3))
    t = g.placeholder("t", (32, 1))
    w = g.variable("w", np.zeros((3, 1), np.float32))
    loss = g.mean(g.square(g.sub(g.matmul(x, w), t)))
    gradfn, f = g.grad(loss), g.compile(loss)
    rng = np.random.default_rng(1)
    true_w = np.array([[1.0], [-2.0], [0.5]], np.float32)
    xs = rng.normal(size=(32, 3)).astype(np.float32)
    ts = xs @ true_w
    first = float(f(x=xs, t=ts))
    for _ in range(200):
        grads = gradfn(x=xs, t=ts)
        g.set_variable("w", g.variables["w"] - 0.1 * grads["w"])
    assert float(f(x=xs, t=ts)) < first * 1e-3
    np.testing.assert_allclose(g.variables["w"].numpy(), true_w, atol=1e-2)


def test_inspection_texts_hold_the_graph():
    g = _tgraph()
    loss = _docstring_graph(g, np.ones((4, 2), np.float32))
    fx = g.fx_graph(loss)
    assert "aten.mm" in fx and "aten._softmax" in fx
    exported = g.exported_graph(loss)
    assert "aten" in exported and "softmax" in exported
    assert len(g.nodes) >= 8 and "matmul" in repr(g)


def test_graph_string_dispatch_and_errors():
    g = _tgraph()
    x = g.placeholder("x", (4,))
    y = g.apply("sigmoid", x)
    z = g.apply("add", y, g.constant(np.ones(4, np.float32)))
    s = g.apply("sum", z)
    out = g.compile(s)(x=np.zeros(4, np.float32))
    assert float(out) == pytest.approx(4 * 1.5)

    with pytest.raises(ValueError):
        g.apply("no_such_op", x)
    with pytest.raises(ValueError):
        g.placeholder("x", (4,))               # duplicate name
    with pytest.raises(ValueError):
        g.grad(s, wrt=["nope"])
    with pytest.raises(ValueError):
        g.compile(s)()                         # missing placeholder
    with pytest.raises(KeyError):
        g.set_variable("unknown", 1.0)
    with pytest.raises(TypeError):
        g.apply("tanh", x, axis=0)
    with pytest.raises(TypeError):
        g.apply("sum", x, bogus=1)
    with pytest.raises(AttributeError):
        g.no_such_method


def test_graph_rejects_foreign_nodes():
    g1, g2 = _tgraph(), _tgraph()
    x = g1.placeholder("x", (2,))
    c = g2.constant(np.ones(2, np.float32) * 5)
    with pytest.raises(ValueError, match="different GraphBuilder"):
        g1.add(x, c)


def test_builder_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GraphBuilder()
