"""The port's embedding and batch-norm layers, batch norm's running
statistics in ``MultiLayerNetwork``'s train step, and ``updaters.sgd``,
against the JAX reference.

The same numpy inputs (from a seed) and the same params (JAX's, carried
over with ``nn.params.params_from_numpy``) go through both packages.
JAX's fits run with ``mesh=None``: its ``"auto"`` default shards a batch
of 8 or more over the tests' 8 virtual devices, which is the
data-parallel step (its ``bn_collective``), not the single-device one.

Tolerances, each with its reason:
- the layers' forwards, fp32: 1e-6 (the same arithmetic; the moments'
  summation order differs);
- five training steps of a net with a batch-norm layer, fp32: params
  and running statistics within 1e-6 (summation order only);
- ``sgd`` against ``optax.sgd``, fp32: 1e-7 (the same per-leaf
  arithmetic in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import configuration as jconf
from deeplearning4j_tpu.nn.layers import make_layer as jmake_layer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
from deeplearning4j_tpu_torch.nn.layers import extras
from deeplearning4j_tpu_torch.nn.layers import make_layer as tmake_layer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.params import params_from_numpy
from deeplearning4j_tpu_torch.ops import updaters

torch.set_num_threads(2)

LAYER_TOL = 1e-6
FIT_TOL = 1e-6
SGD_TOL = 1e-7


def _layer(pkg, kind, n_in, n_out):
    return (pkg.NeuralNetConfiguration.builder().kind(kind).n_in(n_in)
            .n_out(n_out).compute_dtype("float32").build())


def _params_np(jlayer, seed=0):
    return {k: np.asarray(v) for k, v in
            jlayer.init(jax.random.key(seed)).items()}


def test_embedding_layer_matches_jax():
    jl = jmake_layer(_layer(jconf, jconf.LayerKind.EMBEDDING, 50, 6))
    tl = tmake_layer(_layer(tconf, tconf.LayerKind.EMBEDDING, 50, 6))
    p = _params_np(jl)
    ids = np.random.default_rng(0).integers(0, 50, (4, 7)).astype(np.int32)
    ref = np.asarray(jl.activate(p, jnp.asarray(ids)))
    got = tl.activate(params_from_numpy([p], "cpu")[0], torch.from_numpy(ids))
    assert got.shape == (4, 7, 6)
    np.testing.assert_array_equal(got.numpy(), ref)
    init = tl.init(torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == {"W": (50, 6)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "inference"])
@pytest.mark.parametrize("shape", [(16, 5), (4, 3, 5)], ids=["2d", "3d"])
def test_batch_norm_layer_matches_jax(train, shape):
    jl = jmake_layer(_layer(jconf, jconf.LayerKind.BATCH_NORM, 5, 5))
    tl = tmake_layer(_layer(tconf, tconf.LayerKind.BATCH_NORM, 5, 5))
    rng = np.random.default_rng(1)
    p = {"scale": rng.normal(1, 0.2, 5), "bias": rng.normal(0, 0.2, 5),
         "running_mean": rng.normal(0, 1, 5),
         "running_var": rng.uniform(0.5, 2, 5)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(2, 3, shape).astype(np.float32)
    ref = np.asarray(jl.activate(p, jnp.asarray(x), train=train))
    got = tl.activate(params_from_numpy([p], "cpu")[0], torch.from_numpy(x),
                      train=train)
    np.testing.assert_allclose(got.numpy(), ref, rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    init = tl.init(torch.Generator().manual_seed(0), "cpu")
    ref_init = _params_np(jl)
    assert sorted(init) == sorted(ref_init)
    for k in init:
        np.testing.assert_array_equal(init[k].numpy(), ref_init[k])


def test_batch_moments_are_biased_like_jnp_var():
    x = np.random.default_rng(2).normal(size=(6, 3, 4)).astype(np.float32)
    mean, var = extras.batch_moments(torch.from_numpy(x))
    np.testing.assert_allclose(mean.numpy(), x.mean((0, 1)), rtol=1e-6)
    np.testing.assert_allclose(
        var.numpy(), np.asarray(jnp.var(jnp.asarray(x), axis=(0, 1))),
        rtol=1e-6)


def test_bn_collective_raises_naming_a7():
    """``bn_collective`` is ported for every axis named with its mesh
    (its data-axis contracts are in tests/test_torch_dp_fit.py); an
    axis named alone has no group in the port and raises."""
    for axis in ("model", "seq", "expert"):
        with pytest.raises(ValueError, match="name the mesh too"):
            with extras.bn_collective(axis, None):
                pass


def _bn_conf(pkg, embedding: bool):
    """dense -> batch norm -> output, or embedding -> batch norm ->
    output; fp32, plain SGD with momentum (the reference's
    test_batchnorm_running_stats_update_in_fit_backprop shape)."""
    C, K = pkg.NeuralNetConfiguration, pkg.LayerKind

    def layer(kind, n_in, n_out, **kw):
        b = (C.builder().kind(kind).n_in(n_in).n_out(n_out).lr(0.1)
             .momentum(0.5).use_adagrad(False).compute_dtype("float32"))
        for name, val in kw.items():
            b = getattr(b, name)(val)
        return b.build()

    first = (layer(K.EMBEDDING, 20, 8) if embedding
             else layer(K.DENSE, 4, 8, activation="tanh"))
    return pkg.MultiLayerConfiguration(confs=[
        first, layer(K.BATCH_NORM, 8, 8),
        layer(K.OUTPUT, 8, 3, activation="softmax",
              loss_function="mcxent")], pretrain=False, backprop=True)


@pytest.mark.parametrize("embedding", [False, True],
                         ids=["dense", "embedding"])
def test_network_with_batch_norm_trains_like_jax(embedding):
    """Five steps of fit_backprop: params, running mean and running
    variance (EMA 0.9 of the biased batch moments) equal JAX's."""
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(5):
        x = (rng.integers(0, 20, (16,)).astype(np.float32) if embedding
             else rng.normal(1.0, 2.0, (16, 4)).astype(np.float32))
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
        batches.append((x, y))
    jnet = JNet(_bn_conf(jconf, embedding)).init(seed=0)
    jp = [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params]
    tnet = TNet(_bn_conf(tconf, embedding), device="cpu",
                params=params_from_numpy(jp, "cpu"))
    jnet.fit_backprop([JDataSet(x, y) for x, y in batches], mesh=None)
    tnet.fit_backprop([TDataSet(x, y) for x, y in batches])
    for i, (jl, tl) in enumerate(zip(jnet.params, tnet.params)):
        assert sorted(jl) == sorted(tl)
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                       rtol=FIT_TOL, atol=FIT_TOL,
                                       err_msg=f"layer {i} {k}")
    bn = tnet.params[1]
    assert not np.allclose(bn["running_mean"].numpy(), jp[1]["running_mean"])
    assert not np.allclose(bn["running_var"].numpy(), jp[1]["running_var"])


def test_guard_skip_leaves_running_stats_alone():
    """A non-finite batch drops the whole update, the running stats
    included (they are set before the guard)."""
    net = TNet(_bn_conf(tconf, False), device="cpu").init(0)
    before = {k: v.clone() for k, v in net.params[1].items()}
    x = np.full((8, 4), np.nan, np.float32)
    y = np.eye(3, dtype=np.float32)[np.zeros(8, int)]
    net.fit_backprop(TDataSet(x, y))
    assert net.guard_skips == 1
    for k, v in before.items():
        assert torch.equal(net.params[1][k], v), k


@pytest.mark.parametrize("momentum,nesterov", [
    (None, False), (0.9, False), (0.9, True)],
    ids=["plain", "momentum", "nesterov"])
def test_sgd_matches_optax(momentum, nesterov):
    rng = np.random.default_rng(4)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape)
                          .astype(np.float32), params) for _ in range(3)]
    jopt = optax.sgd(0.1, momentum=momentum, nesterov=nesterov)
    topt = updaters.sgd(0.1, momentum=momentum, nesterov=nesterov)
    jp, tp = jax.tree.map(jnp.asarray, params), updaters.tree_map(
        torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(updaters.tree_map(torch.from_numpy, g), ts, tp)
        tp = updaters.apply_updates(tp, tu)
    for got, ref in zip(updaters.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=SGD_TOL, atol=SGD_TOL)
    if momentum is None:
        assert ts.trace is None
    else:
        for got, ref in zip(updaters.tree_leaves(ts.trace),
                            jax.tree.leaves(js[0].trace)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=SGD_TOL, atol=SGD_TOL)
