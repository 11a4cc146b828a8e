"""The port's MultiLayerNetwork substrate against the JAX reference.

Conf JSON, the named activations and losses, ``dl4j_updater``, weight
init and param packing, each layer kind LeNet uses, the preprocessors,
MNIST data, ``DataSet.shuffle`` and ``Evaluation`` go through JAX's
module and the port's on the same numpy inputs (made from a seed).

Tolerances, each with its reason:
- activations, their derivatives and losses, fp32: rtol 1e-6 with an
  atol of 3e-7.  The two frameworks' ``tanh`` differ by up to an ulp
  (6e-8 near +-1), and where a formula subtracts it from 1 (``tanh``'s
  derivative, ``gelu``) that ulp stays as an absolute error of the
  small result: 3e-7 is 5 ulp of 1.  Derivatives take an atol of 1e-6:
  ``gelu``'s is autograd of that form in both, which carries the ulp
  through ``1 - tanh^2`` and a product with x;
- ``dl4j_updater``: updates and state within rtol 1e-6 (atol 1e-9) over
  5 iterations (the same fp32 arithmetic in the same order);
- layer forwards: fp32 2e-5, bf16 3e-2 (``tests/test_pallas_attention.py``
  :34, :55, :76);
- conf JSON, MNIST arrays, shuffles and confusion counts: equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets import fetchers as jfetch
from deeplearning4j_tpu.eval.evaluation import Evaluation as JEvaluation
from deeplearning4j_tpu.models import lenet as jlenet
from deeplearning4j_tpu.nn import params as jparams
from deeplearning4j_tpu.nn.conf import configuration as jconf
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.layers import make_layer as jmake_layer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.ops import registry as jreg
from deeplearning4j_tpu.ops import updaters as jupd
from deeplearning4j_tpu_torch.datasets import dataset as tds
from deeplearning4j_tpu_torch.datasets import fetchers as tfetch
from deeplearning4j_tpu_torch.datasets import iterator as titer
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation as TEvaluation
from deeplearning4j_tpu_torch.models import lenet as tlenet
from deeplearning4j_tpu_torch.nn import params as tparams
from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpre
from deeplearning4j_tpu_torch.nn.layers import make_layer as tmake_layer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.ops import losses as tlosses
from deeplearning4j_tpu_torch.ops import registry as treg
from deeplearning4j_tpu_torch.ops import updaters as tupd

torch.set_num_threads(2)

FWD_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
OPS_RTOL, OPS_ATOL, DERIV_ATOL = 1e-6, 3e-7, 1e-6
UPD_RTOL, UPD_ATOL = 1e-6, 1e-9
MNIST_DIR = str(__import__("pathlib").Path(__file__).resolve().parents[1]
                / "data" / "mnist")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol, atol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


# -- configuration -----------------------------------------------------------

def _dense_conf(pkg):
    """One dense conf through the builder, with every updater option."""
    C = pkg.NeuralNetConfiguration
    base = (C.builder().n_in(12).lr(0.05).momentum(0.4)
            .momentum_after({3: 0.9, 1: 0.7}).l2(1e-3)
            .use_regularization(True).use_adagrad(True)
            .constrain_gradient_to_unit_norm(True).activation("tanh")
            .weight_init(pkg.WeightInit.VI).compute_dtype("float32"))
    return (base.list(3).hidden_layer_sizes(16, 8)
            .override(2, kind=pkg.LayerKind.OUTPUT, n_out=4,
                      activation="softmax", loss_function="mcxent")
            .pretrain(False).backward(True).build())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lenet_conf_json_equals_reference(dtype):
    assert tlenet.lenet_conf(compute_dtype=dtype).to_json() == \
        jlenet.lenet_conf(compute_dtype=dtype).to_json()


def test_dense_conf_json_equals_reference():
    assert _dense_conf(tconf).to_json() == _dense_conf(jconf).to_json()


@pytest.mark.parametrize("conf_of", [
    lambda pkg: _dense_conf(pkg),
    lambda pkg: (tlenet if pkg is tconf else jlenet).lenet_conf()],
    ids=["dense", "lenet"])
def test_either_packages_json_builds_the_same_network(conf_of):
    """A network built from either package's JSON wires the same sizes
    (its JSON after wiring) and has the same param shapes."""
    for src in (tconf, jconf):
        text = conf_of(src).to_json()
        tnet = TNet(tconf.MultiLayerConfiguration.from_json(text),
                    device="cpu").init(0)
        jnet = JNet(jconf.MultiLayerConfiguration.from_json(text)).init(0)
        assert tnet.conf.to_json() == jnet.conf.to_json()
        assert [{k: tuple(v.shape) for k, v in p.items()}
                for p in tnet.params] == \
            [{k: tuple(v.shape) for k, v in p.items()} for p in jnet.params]
        assert tnet.num_params() == jnet.num_params()


def test_bad_confs_raise_value_error():
    C = tconf.NeuralNetConfiguration
    with pytest.raises(ValueError):
        C.builder().activation("no-such-activation").build()
    with pytest.raises(ValueError):
        C.builder().loss_function("no-such-loss").build()
    bad = json.loads(_dense_conf(tconf).to_json())
    bad["confs"][0]["kind"] = "no-such-kind"
    with pytest.raises(ValueError):
        tconf.MultiLayerConfiguration.from_json(json.dumps(bad))


@pytest.mark.parametrize("kind,item", [
    ("recursive_autoencoder", "A5b"), ("lstm", "A5b"),
    ("batch_norm", "A6"), ("embedding", "A6")])
def test_unported_layer_kinds_raise_not_implemented(kind, item):
    conf = tconf.NeuralNetConfiguration(kind=tconf.LayerKind(kind),
                                        n_in=4, n_out=3)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}\\)"):
        tmake_layer(conf)


def test_unported_fit_paths_raise_not_implemented():
    net = TNet(_dense_conf(tconf), device="cpu").init(0)
    data = tds.DataSet(np.zeros((4, 12), np.float32),
                       np.eye(4, dtype=np.float32))
    for call in (lambda: net.fit_backprop(data, mesh="auto"),
                 lambda: net._resolve_fit_mesh(object(), 4)):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            call()
    for field, value in (("grad_accum", 2), ("mixed_precision", "bf16")):
        conf = _dense_conf(tconf)
        setattr(conf, field, value)
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            TNet(conf, device="cpu").fit_backprop(data)
    conf = _dense_conf(tconf)
    conf.mixed_precision = "fp8"
    with pytest.raises(ValueError):
        TNet(conf, device="cpu").fit_backprop(data)


# -- activations and losses --------------------------------------------------

def test_registries_hold_the_same_names():
    assert treg.list_activations() == jreg.list_activations()
    assert [m.value for m in tlosses.LossFunction] == \
        [m.value for m in jlosses.LossFunction]


@pytest.mark.parametrize("name", jreg.list_activations())
def test_activation_and_derivative_match_jax(name):
    rng = np.random.default_rng(1)
    z = rng.normal(0, 2, (6, 7)).astype(np.float32)
    if name == "sqrt":
        z = np.abs(z) + 0.1
    _close(treg.get_activation(name)(_t(z)), jreg.get_activation(name)(z),
           OPS_RTOL, OPS_ATOL, name)
    _close(treg.get_activation_derivative(name)(_t(z)),
           jreg.get_activation_derivative(name)(z), OPS_RTOL, DERIV_ATOL,
           name + " derivative")


def test_relu_gradient_at_zero_is_zero():
    z = torch.zeros(3, requires_grad=True)
    treg.get_activation("relu")(z).sum().backward()
    assert z.grad.tolist() == [0.0, 0.0, 0.0]
    assert np.asarray(jax.grad(lambda v: jreg.get_activation("relu")(v)
                               .sum())(jnp.zeros(3))).tolist() == [0.0] * 3


@pytest.mark.parametrize("loss", [m.value for m in jlosses.LossFunction])
def test_loss_functions_match_jax(loss):
    rng = np.random.default_rng(2)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 9)]
    logits = rng.normal(0, 1.5, (9, 5)).astype(np.float32)
    out = np.asarray(jax.nn.softmax(logits, -1))
    _close(tlosses.per_example_score(_t(labels), loss, _t(out)),
           jlosses.per_example_score(labels, loss, out), OPS_RTOL, OPS_ATOL,
           loss)
    _close(tlosses.score(_t(labels), loss, _t(out)),
           jlosses.score(labels, loss, out), OPS_RTOL, OPS_ATOL, loss)


def test_fused_cross_entropies_match_jax():
    rng = np.random.default_rng(3)
    labels = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 10)]
    logits = rng.normal(0, 3, (10, 6)).astype(np.float32)
    bits = (rng.random((10, 6)) > 0.5).astype(np.float32)
    for fn, lab in (("softmax_cross_entropy_with_logits", labels),
                    ("sigmoid_binary_cross_entropy_with_logits", bits)):
        for name in (fn, "per_example_" + fn):
            _close(getattr(tlosses, name)(_t(lab), _t(logits)),
                   getattr(jlosses, name)(lab, logits), OPS_RTOL, OPS_ATOL,
                   name)


# -- dl4j_updater ------------------------------------------------------------

@pytest.mark.parametrize("adagrad", [False, True])
@pytest.mark.parametrize("schedule", [None, {2: 0.9}])
@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("unit_norm", [False, True])
def test_dl4j_updater_matches_jax(adagrad, schedule, l2, unit_norm):
    """Five iterations on a tree with W, b and x_W leaves; L2 must reach
    W and x_W only."""
    kw = dict(lr=0.05, momentum=0.5, momentum_schedule=schedule,
              use_adagrad=adagrad, l2=l2, use_regularization=l2 > 0,
              constrain_unit_norm=unit_norm)
    rng = np.random.default_rng(4)
    shapes = {"W": (4, 3), "b": (3,), "x_W": (2, 5)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jup, tup = jupd.dl4j_updater(**kw), tupd.dl4j_updater(**kw)
    jstate = jup.init(params)
    tstate = tup.init({k: _t(v) for k, v in params.items()})
    for it in range(5):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        ju, jstate = jup.update(jstate, grads, params, it, 1)
        tu, tstate = tup.update(tstate, {k: _t(v) for k, v in grads.items()},
                                {k: _t(v) for k, v in params.items()}, it, 1)
        for k in shapes:
            _close(tu[k], ju[k], UPD_RTOL, UPD_ATOL, f"update {k} it {it}")
            _close(tstate.adagrad_accum[k], jstate.adagrad_accum[k],
                   UPD_RTOL, UPD_ATOL, f"accum {k}")
            _close(tstate.momentum_buf[k], jstate.momentum_buf[k],
                   UPD_RTOL, UPD_ATOL, f"momentum {k}")
        params = {k: np.asarray(jupd.apply_updates(params, ju)[k])
                  for k in shapes}


def test_dl4j_updater_divides_by_batch_size():
    up = tupd.dl4j_updater(lr=1.0, momentum=0.0)
    g = {"W": torch.full((2,), 3.0)}
    u, _ = up.update(up.init(g), g, g, 0, 4)
    assert u["W"].tolist() == [0.75, 0.75]


# -- params ------------------------------------------------------------------

@pytest.mark.parametrize("scheme", list(jconf.WeightInit))
@pytest.mark.parametrize("shape", [(400, 300), (5, 5, 20, 50)])
def test_init_weight_scheme_matches_reference_distribution(scheme, shape):
    """Same scheme, same fan convention (HWIO: fan_in = Cin kh kw): the
    draws differ (threefry vs Philox) but their spreads agree within 3%
    at 25k+ entries, their means within 6 standard errors, and a
    uniform scheme's range within 3%."""
    dist = ("normal", 0.1, 0.02)
    tw = tparams.init_weight(torch.Generator().manual_seed(0), shape,
                             tconf.WeightInit(scheme.value), dist).numpy()
    jw = np.asarray(jparams.init_weight(jax.random.key(0), shape, scheme,
                                        dist))
    assert tw.shape == jw.shape and tw.dtype == np.float32
    np.testing.assert_allclose(tw.std(), jw.std(), rtol=0.03)
    if scheme.value in ("vi", "xavier", "uniform", "normalized"):
        np.testing.assert_allclose(np.abs(tw).max(), np.abs(jw).max(),
                                   rtol=0.03)
    assert abs(tw.mean() - jw.mean()) <= 6 * jw.std() / np.sqrt(jw.size)


def test_pack_order_matches_reference_and_round_trips():
    jnet = jlenet.lenet(compute_dtype="float32")
    tp = tparams.params_from_numpy(jax.tree.map(np.asarray, jnet.params),
                                   "cpu")
    flat = tparams.pack_params(tp)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(jparams.pack_params(
                                      jnet.params)))
    back = tparams.unpack_params(flat * 2, tp)
    for a, b in zip(back, tp):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k] * 2)
    with pytest.raises(ValueError):
        tparams.unpack_params(flat[:-1], tp)


# -- layers ------------------------------------------------------------------

def _layer_pair(conf_kw, seed=5):
    tlayer = tmake_layer(tconf.NeuralNetConfiguration(**conf_kw))
    jlayer = jmake_layer(jconf.NeuralNetConfiguration(**{
        k: (jconf.LayerKind(v.value) if isinstance(v, tconf.LayerKind)
            else v) for k, v in conf_kw.items()}))
    p = jlayer.init(jax.random.key(seed))
    # a nonzero bias, so the bias's dtype and place are held too
    p = {k: (np.asarray(v) + 0.1 if k == "b" else np.asarray(v))
         for k, v in p.items()}
    return tlayer, jlayer, p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,act", [("dense", "relu"),
                                      ("output", "softmax")])
def test_dense_and_output_forward_match_jax(dtype, kind, act):
    tl, jl, p = _layer_pair(dict(kind=tconf.LayerKind(kind), n_in=24,
                                 n_out=10, activation=act,
                                 compute_dtype=dtype))
    x = np.random.default_rng(6).normal(size=(7, 24)).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    _close(tl.activate(tp, _t(x)), jl.activate(p, x), FWD_TOL[dtype],
           FWD_TOL[dtype], kind)
    if kind == "output":
        y = np.eye(10, dtype=np.float32)[np.arange(7) % 10]
        _close(tl.loss(tp, _t(x), _t(y)), jl.loss(p, x, y), FWD_TOL[dtype],
               FWD_TOL[dtype], "loss")
        _close(tl.per_example_loss(tp, _t(x), _t(y)),
               jl.per_example_loss(p, x, y), FWD_TOL[dtype], FWD_TOL[dtype],
               "per-example loss")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding,stride,size", [
    ("SAME", (1, 1), (12, 12)), ("SAME", (2, 2), (11, 12)),
    ("VALID", (1, 1), (12, 11)), ("SAME", (2, 3), (13, 10))])
def test_conv_forward_matches_jax(dtype, padding, stride, size):
    """SAME with stride 2 pads an odd total at the bottom/right, as XLA."""
    tl, jl, p = _layer_pair(dict(kind=tconf.LayerKind.CONVOLUTION,
                                 n_channels=3, n_filters=6,
                                 kernel_size=(4, 5), stride=stride,
                                 padding=padding, activation="relu",
                                 compute_dtype=dtype))
    x = np.random.default_rng(7).normal(
        size=(2,) + size + (3,)).astype(np.float32)
    got = tl.activate({k: _t(v) for k, v in p.items()}, _t(x))
    ref = jl.activate(p, x)
    assert tuple(got.shape) == ref.shape
    _close(got, ref, FWD_TOL[dtype], FWD_TOL[dtype])


@pytest.mark.parametrize("pool", ["max", "avg"])
@pytest.mark.parametrize("ties", [False, True])
def test_pooling_and_its_gradient_match_jax(pool, ties):
    """With ties (small integers), max pooling must route each window's
    gradient to the entry XLA's select_and_scatter picks, the first
    largest in row-major order: exactly equal gradients.  The 10-wide
    input leaves a column that VALID pooling drops."""
    tl, jl, _ = _layer_pair(dict(kind=tconf.LayerKind.SUBSAMPLING,
                                 pool_size=(2, 3), pool_type=pool))
    rng = np.random.default_rng(8)
    x = (rng.integers(0, 3, (3, 8, 10, 4)) if ties
         else rng.normal(size=(3, 8, 10, 4))).astype(np.float32)
    dy = rng.normal(size=(3, 4, 3, 4)).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    y = tl.activate({}, xt)
    (y * _t(dy)).sum().backward()
    jg = jax.grad(lambda v: (jl.activate({}, v) * dy).sum())(x)
    _close(y, jl.activate({}, x), FWD_TOL["float32"], FWD_TOL["float32"])
    _close(xt.grad, jg, 0 if pool == "max" else FWD_TOL["float32"],
           0 if pool == "max" else FWD_TOL["float32"])


def test_flatten_after_conv_orders_features_nhwc():
    """conv -> flatten -> dense on a non-square, multi-channel map: a
    flatten in NCHW order would scramble the dense rows."""
    conf = (tconf.NeuralNetConfiguration.builder()
            .kind(tconf.LayerKind.CONVOLUTION).n_channels(2).n_filters(3)
            .kernel_size((3, 3)).padding("VALID").activation("tanh")
            .compute_dtype("float32"))
    head = (tconf.NeuralNetConfiguration.builder()
            .kind(tconf.LayerKind.OUTPUT).n_in(4 * 6 * 3).n_out(5)
            .activation("softmax").compute_dtype("float32"))
    text = tconf.MultiLayerConfiguration(
        confs=[conf.build(), head.build()],
        input_preprocessors={1: {"name": "flatten"}},
        pretrain=False, backprop=True).to_json()
    jnet = JNet(jconf.MultiLayerConfiguration.from_json(text)).init(1)
    tnet = TNet(tconf.MultiLayerConfiguration.from_json(text),
                params=tparams.params_from_numpy(
                    jax.tree.map(np.asarray, jnet.params), "cpu"),
                device="cpu")
    x = np.random.default_rng(9).normal(size=(4, 6, 8, 2)).astype(
        np.float32)
    _close(tnet.feed_forward(tnet.params, _t(x))[-1],
           jnet.feed_forward(jnet.params, x)[-1], FWD_TOL["float32"],
           FWD_TOL["float32"])


@pytest.mark.parametrize("spec", [
    {"name": "flatten"}, {"name": "reshape", "shape": [4, 6]},
    {"name": "unit_variance"}, {"name": "zero_mean_unit_variance"},
    {"name": "zero_mean"},
    {"name": "convolution_input", "rows": 4, "cols": 3, "channels": 2},
    {"name": "composable", "specs": [{"name": "zero_mean"},
                                     {"name": "flatten"}]},
    {"name": "binomial_sampling"}])
def test_preprocessors_match_jax(spec):
    """Deterministic ones alike; binomial sampling is the identity
    without a generator (the evaluation path) in both."""
    x = np.random.default_rng(10).random((5, 24)).astype(np.float32)
    if spec["name"] == "flatten":
        x = x.reshape(5, 2, 3, 4)
    _close(tpre.make_preprocessor(spec)(_t(x)),
           jpre.make_preprocessor(spec)(x), OPS_RTOL, 1e-6, spec["name"])
    with pytest.raises(ValueError):
        tpre.make_preprocessor({"name": "no-such-preprocessor"})


# -- data and evaluation -----------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_mnist_fetcher_equals_reference_bit_for_bit(train):
    kw = dict(train=train, flatten=False, binarize=False)
    t = tfetch.MnistDataFetcher(data_dir=MNIST_DIR, **kw)
    j = jfetch.MnistDataFetcher(data_dir=MNIST_DIR, **kw)
    assert not t.synthetic and not j.synthetic
    t.fetch(t.total)
    j.fetch(j.total)
    np.testing.assert_array_equal(t.next().features.numpy(),
                                  np.asarray(j.next().features))
    np.testing.assert_array_equal(t.next().labels.numpy(),
                                  np.asarray(j.next().labels))
    assert t.next().features.shape[1:] == (28, 28, 1)
    # and through default discovery (the committed data/mnist fixture)
    d = tfetch.MnistDataFetcher(**kw)
    d.fetch(3)
    np.testing.assert_array_equal(d.next().features.numpy(),
                                  t.features[:3])


def test_mnist_iterator_batches_cover_the_split():
    it = titer.MnistDataSetIterator(100, num_examples=250,
                                    data_dir=MNIST_DIR, flatten=False)
    sizes = [b.num_examples() for b in it]
    assert sizes == [100, 100, 50] and it.total_examples() == 250
    assert it.total_outcomes() == 10 and it.input_columns() == 784


def test_shuffle_and_transforms_match_reference():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(37, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 37)]
    j = jds.DataSet(x, y)
    for t in (tds.DataSet(x, y), tds.DataSet(_t(x), _t(y))):
        ts, js = t.shuffle(7), j.shuffle(7)
        np.testing.assert_array_equal(np.asarray(ts.features),
                                      np.asarray(js.features))
        np.testing.assert_array_equal(np.asarray(ts.labels),
                                      np.asarray(js.labels))
        for name in ("normalize_zero_mean_unit_variance", "scale_0_1"):
            _close(torch.as_tensor(getattr(t, name)().features),
                   getattr(j, name)().features, 1e-6, 1e-6, name)
        tb, jb = t.batch_by(10), j.batch_by(10)
        assert [b.num_examples() for b in tb] == \
            [b.num_examples() for b in jb] == [10, 10, 10, 7]
        m = tds.DataSet.merge(tb)
        np.testing.assert_array_equal(np.asarray(m.features), x)
        tr, te = t.split_test_and_train(30)
        assert (tr.num_examples(), te.num_examples()) == (30, 7)
    np.testing.assert_array_equal(tds.one_hot([2, 0, -1, 5], 4),
                                  np.asarray(jds.one_hot([2, 0, -1, 5], 4)))


@pytest.mark.parametrize("int_labels", [False, True])
def test_evaluation_matches_reference(int_labels):
    rng = np.random.default_rng(12)
    idx = rng.integers(0, 4, 50)
    guesses = rng.random((50, 4)).astype(np.float32)
    if int_labels:
        idx[3] = -1          # an ignored row counts toward nothing
        labels = idx
    else:
        labels = np.eye(4, dtype=np.float32)[idx]
    te, je = TEvaluation(), JEvaluation()
    te.eval(_t(labels), _t(guesses))
    je.eval(labels, guesses)
    np.testing.assert_array_equal(te.confusion.counts, je.confusion.counts)
    assert te.confusion.total() == (49 if int_labels else 50)
    for metric in ("accuracy", "precision", "recall", "f1"):
        assert getattr(te, metric)() == getattr(je, metric)()
    assert te.stats() == je.stats()


def test_dropout_drop_connect_and_sampling_draw_from_the_generator():
    """The port's own draws (JAX's threefry cannot be matched): inverted
    dropout zeroes ~rate of the entries and scales the rest by
    1 / (1 - rate); the same seed gives the same mask; evaluation draws
    nothing; a dropout fit is reproducible from its seed."""
    from deeplearning4j_tpu_torch.ops import random as trandom

    x = torch.ones(400, 250)
    y = trandom.dropout(torch.Generator().manual_seed(3), x, 0.3)
    assert abs(float((y == 0).float().mean()) - 0.3) < 0.01
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.7))
    assert torch.equal(y, trandom.dropout(torch.Generator().manual_seed(3),
                                          x, 0.3))
    assert trandom.dropout(None, x, 0.0) is x
    sample = tpre.make_preprocessor({"name": "binomial_sampling"})(
        torch.full((50, 40), 0.25), torch.Generator().manual_seed(0))
    assert set(sample.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(sample.mean()) - 0.25) < 0.03

    for drop_connect in (False, True):
        layer = tmake_layer(tconf.NeuralNetConfiguration(
            kind=tconf.LayerKind.DENSE, n_in=30, n_out=20, dropout=0.5,
            drop_connect=drop_connect, activation="tanh",
            compute_dtype="float32"))
        p = layer.init(torch.Generator().manual_seed(0), "cpu")
        xin = torch.randn(6, 30, generator=torch.Generator().manual_seed(1))
        clean = layer.activate(p, xin)
        assert torch.equal(clean, layer.activate(p, xin, train=False,
                                                 gen=torch.Generator()))
        noisy = layer.activate(p, xin, gen=torch.Generator().manual_seed(2),
                               train=True)
        assert not torch.equal(noisy, clean)
        if not drop_connect:
            assert bool(((noisy == 0) | torch.isclose(noisy, 2 * clean))
                        .all())

    conf_json = _dense_conf(tconf).to_json()
    data = tds.DataSet(np.random.default_rng(13).normal(
        size=(24, 12)).astype(np.float32),
        np.eye(4, dtype=np.float32)[np.arange(24) % 4])
    flats = []
    for _ in range(2):
        conf = tconf.MultiLayerConfiguration.from_json(conf_json)
        for c in conf.confs[:-1]:
            c.dropout = 0.2
        net = TNet(conf, device="cpu").init(0)
        net.fit_backprop(data.batch_by(8), num_epochs=2, seed=5)
        flats.append(net.params_flat())
    assert bool(torch.isfinite(flats[0]).all())
    assert torch.equal(flats[0], flats[1])
