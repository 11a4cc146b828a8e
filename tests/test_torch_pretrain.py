"""The port's pretraining layers and ``MultiLayerNetwork.fit`` against the
JAX reference on the CPU.

- RBM CD-k (``nn/layers/rbm.py``) for every hidden and visible unit,
  k = 1 and 3, with sparsity: JAX's draws are rebuilt from its key with
  the reference's splits (``rbm.py:106-116``: ``key_h0, key_chain =
  split(key)``, ``split(key_chain, k)``, each step's key split into its
  visible and hidden keys) and handed to the port's ``pretrain_core``;
  a Bernoulli is held to be ``uniform < p`` on the test's shapes first;
- the denoising autoencoder with JAX's corruption mask injected;
- the whole ``fit`` of the reference's ``test_pretrain_finetune_path``
  conf (``tests/test_multilayer.py:59-79``) with ``corruption_level=0``,
  which makes its pretraining deterministic: every pretrain and finetune
  score, the params and the final score;
- LeNet ``fit`` at B=8 (finetune of the output layer through the solver,
  then ``fit_backprop``) and ``prepare_resilient_fit``, the JAX side on
  its single-device path (``_resolve_fit_mesh`` -> None: under the
  8-device test platform its ``mesh="auto"`` shards a batch of 8);
- two same-seed pretrains equal, and no capture after warm-up across a
  fit (the CPU stand-in for the capture of
  ``tests/test_torch_compile_cache.py``).

Tolerances (fp32): CD-k and AE score and grads 1e-5; fit scores rtol
1e-4, params atol 1e-5 (the bars of tests/test_torch_lenet.py).
"""

import os
import subprocess
import types
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.fetchers import IrisDataFetcher
from deeplearning4j_tpu.models import lenet as jlenet
from deeplearning4j_tpu.nn.conf import configuration as jconf
from deeplearning4j_tpu.nn.layers import make_layer as jmake_layer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize.listeners import \
    CollectScoresListener as JCollect
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.models import lenet as tlenet
from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
from deeplearning4j_tpu_torch.nn.layers import make_layer as tmake_layer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.params import params_from_numpy
from deeplearning4j_tpu_torch.optimize.listeners import \
    CollectScoresListener as TCollect
from deeplearning4j_tpu_torch.runtime import compile_cache
from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics
from test_torch_compile_cache import graphs_on_cpu  # noqa: F401

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CD_TOL = 1e-5
SCORE_RTOL, PARAM_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def fresh_engine():
    compile_cache.clear()
    compile_metrics.reset()
    yield


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


# -- RBM CD-k with injected draws ----------------------------------------------

_NOISE = {"binary": "uniform", "gaussian": "normal", "rectified": "normal"}


def _jax_rbm_draws(key, hidden, visible, k, n, n_in, n_out):
    """JAX's chain noise, from the key as ``RBMLayer.contrastive_divergence``
    splits it."""
    def noise(unit, kk, shape):
        kind = _NOISE.get(unit)
        if kind == "uniform":
            return torch.from_numpy(np.array(jax.random.uniform(kk, shape)))
        if kind == "normal":
            return torch.from_numpy(np.array(
                jax.random.normal(kk, shape, jnp.float32)))
        return None

    key_h0, key_chain = jax.random.split(key)
    vs, hs = [], []
    for sk in jax.random.split(key_chain, k):
        kv, kh = jax.random.split(sk)
        vs.append(noise(visible, kv, (n, n_in)))
        hs.append(noise(hidden, kh, (n, n_out)))
    return noise(hidden, key_h0, (n, n_out)), vs, hs


def test_bernoulli_is_uniform_below_p():
    rng = np.random.default_rng(0)
    for shape in ((16, 5), (16, 6)):
        p = jnp.asarray(rng.random(shape, dtype=np.float32))
        for i in range(4):
            k = jax.random.key(i)
            np.testing.assert_array_equal(
                np.asarray(jax.random.bernoulli(k, p)),
                np.asarray(jax.random.uniform(k, p.shape) < p))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("visible", ["binary", "gaussian", "linear",
                                     "softmax"])
@pytest.mark.parametrize("hidden", ["binary", "gaussian", "rectified",
                                    "softmax"])
def test_rbm_cd_k_matches_reference(hidden, visible, k):
    n, n_in, n_out = 16, 6, 5

    def conf(pkg):
        return pkg.NeuralNetConfiguration(
            kind=pkg.LayerKind.RBM, n_in=n_in, n_out=n_out, k=k,
            sparsity=0.05, hidden_unit=pkg.HiddenUnit(hidden),
            visible_unit=pkg.VisibleUnit(visible),
            weight_init=pkg.WeightInit.DISTRIBUTION,
            dist=("normal", 0.0, 0.3))

    jl, tl = jmake_layer(conf(jconf)), tmake_layer(conf(tconf))
    params = _np_tree(jl.init(jax.random.key(1)))
    params["b"] = np.linspace(-0.3, 0.3, n_out).astype(np.float32)
    params["vb"] = np.linspace(0.2, -0.2, n_in).astype(np.float32)
    rng = np.random.default_rng(2)
    x = (rng.random((n, n_in)) < 0.4).astype(np.float32) \
        if visible == "binary" else \
        rng.standard_normal((n, n_in)).astype(np.float32)
    key = jax.random.key(7)
    jscore, jgrads = jl.pretrain_value_and_grad(
        jax.tree.map(jnp.asarray, params), key, jnp.asarray(x))
    draws = _jax_rbm_draws(key, hidden, visible, k, n, n_in, n_out)
    tscore, tgrads = tl.pretrain_core(_t(params), draws, torch.from_numpy(x))
    np.testing.assert_allclose(float(tscore), float(jscore), rtol=CD_TOL,
                               atol=CD_TOL)
    assert sorted(tgrads) == sorted(jgrads) == ["W", "b", "vb"]
    for name in jgrads:
        np.testing.assert_allclose(tgrads[name].numpy(),
                                   np.asarray(jgrads[name]), rtol=CD_TOL,
                                   atol=CD_TOL, err_msg=name)
    # the generator path draws the same structure and runs the same core
    gen = torch.Generator().manual_seed(0)
    score, grads = tl.pretrain_value_and_grad(_t(params), gen,
                                              torch.from_numpy(x))
    assert torch.isfinite(score) and grads["W"].shape == (n_in, n_out)


def test_rbm_activate_and_reconstruct_match_reference():
    def conf(pkg):
        return pkg.NeuralNetConfiguration(kind=pkg.LayerKind.RBM, n_in=6,
                                          n_out=4)
    jl, tl = jmake_layer(conf(jconf)), tmake_layer(conf(tconf))
    params = _np_tree(jl.init(jax.random.key(3)))
    x = np.random.default_rng(3).random((5, 6)).astype(np.float32)
    for name in ("activate", "reconstruct"):
        np.testing.assert_allclose(
            getattr(tl, name)(_t(params), torch.from_numpy(x)).numpy(),
            np.asarray(getattr(jl, name)(params, jnp.asarray(x))),
            rtol=1e-6, atol=1e-6, err_msg=name)


# -- the autoencoder with an injected mask -------------------------------------

@pytest.mark.parametrize("level", [0.0, 0.3])
def test_autoencoder_matches_reference(level):
    def conf(pkg):
        return pkg.NeuralNetConfiguration(
            kind=pkg.LayerKind.AUTOENCODER, n_in=7, n_out=4,
            activation="sigmoid", corruption_level=level)

    jl, tl = jmake_layer(conf(jconf)), tmake_layer(conf(tconf))
    params = _np_tree(jl.init(jax.random.key(4)))
    params["vb"] = np.linspace(-0.1, 0.1, 7).astype(np.float32)
    x = np.random.default_rng(5).random((12, 7)).astype(np.float32)
    key = jax.random.key(11)
    jscore, jgrads = jl.pretrain_value_and_grad(
        jax.tree.map(jnp.asarray, params), key, jnp.asarray(x))
    mask = (torch.from_numpy(np.array(jax.random.bernoulli(
        key, 1.0 - level, x.shape))) if level > 0 else None)
    tscore, tgrads = tl.pretrain_core(_t(params), mask, torch.from_numpy(x))
    np.testing.assert_allclose(float(tscore), float(jscore), rtol=CD_TOL)
    for name in jgrads:
        np.testing.assert_allclose(tgrads[name].numpy(),
                                   np.asarray(jgrads[name]), rtol=CD_TOL,
                                   atol=CD_TOL, err_msg=name)
    assert (tl.draw(torch.Generator(), torch.from_numpy(x)) is None) == \
        (level == 0)


# -- the whole fit -------------------------------------------------------------

def _iris_0_1():
    f = IrisDataFetcher()
    x = f.features
    x = (x - x.min(0)) / (x.max(0) - x.min(0) + 1e-8)
    return x.astype(np.float32), f.labels


def _ae_conf(pkg):
    """tests/test_multilayer.py:62-72 at corruption 0 and fp32 compute."""
    return (pkg.NeuralNetConfiguration.builder()
            .n_in(4).lr(0.05).num_iterations(30).use_adagrad(False)
            .activation("sigmoid").compute_dtype("float32")
            .list(3)
            .hidden_layer_sizes(10, 6)
            .override(0, kind=pkg.LayerKind.AUTOENCODER,
                      corruption_level=0.0)
            .override(1, kind=pkg.LayerKind.AUTOENCODER,
                      corruption_level=0.0)
            .override(2, kind=pkg.LayerKind.OUTPUT, n_out=3,
                      activation="softmax", loss_function="mcxent",
                      num_iterations=200, lr=0.5)
            .pretrain(True).backward(False)
            .build())


def _pair(conf_of, seed=0):
    jnet = JNet(conf_of(jconf)).init(seed=seed)
    tnet = TNet(conf_of(tconf), device="cpu",
                params=params_from_numpy(_np_tree(jnet.params), "cpu"))
    return jnet, tnet


def _assert_nets_close(tnet, jnet):
    for i, (tp, jp) in enumerate(zip(tnet.params, jnet.params)):
        assert sorted(tp) == sorted(jp)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"layer {i} {k}")


def test_pretrain_finetune_fit_matches_reference():
    x, y = _iris_0_1()
    jnet, tnet = _pair(_ae_conf)
    jl, tl = JCollect(), TCollect()
    jnet.set_listeners([jl])
    tnet.set_listeners([tl])
    jdata = JDataSet(jnp.asarray(x), jnp.asarray(y))
    tdata = TDataSet(torch.from_numpy(x), torch.from_numpy(y))
    before = tnet.score(tdata)
    jnet.fit(jdata)
    tnet.fit(tdata)
    js, ts = [s for _, s in jl.scores], [s for _, s in tl.scores]
    # 30 + 30 pretrain iterations, then 200 finetune iterations
    assert len(ts) == len(js) == 260
    np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL)
    _assert_nets_close(tnet, jnet)
    after = tnet.score(tdata)
    np.testing.assert_allclose(after, jnet.score(jdata), rtol=SCORE_RTOL)
    assert after < before


def _lenet_batches(n_batches, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((8 * n_batches, 28, 28, 1), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8 * n_batches)]
    return ([JDataSet(jnp.asarray(x[i:i + 8]), jnp.asarray(y[i:i + 8]))
             for i in range(0, len(x), 8)],
            [TDataSet(torch.from_numpy(x[i:i + 8]),
                      torch.from_numpy(y[i:i + 8]))
             for i in range(0, len(x), 8)])


def _lenet_pair():
    jnet = jlenet.lenet(compute_dtype="float32")
    # the single-device path (see the module docstring)
    jnet._resolve_fit_mesh = lambda mesh, min_batch: None
    tnet = TNet(tlenet.lenet_conf(compute_dtype="float32"), device="cpu",
                params=params_from_numpy(_np_tree(jnet.params), "cpu"))
    return jnet, tnet


def test_lenet_fit_matches_reference():
    jb, tb = _lenet_batches(3)
    jnet, tnet = _lenet_pair()
    jl, tl = JCollect(), TCollect()
    jnet.set_listeners([jl])
    tnet.set_listeners([tl])
    jnet.fit(jb, num_epochs=1)
    tnet.fit(tb, num_epochs=1)
    js, ts = [s for _, s in jl.scores], [s for _, s in tl.scores]
    # lenet_conf: 100 finetune iterations, then one backprop step a batch
    assert len(ts) == len(js) == 103
    np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL)
    _assert_nets_close(tnet, jnet)


def test_prepare_resilient_fit_matches_reference():
    jb, tb = _lenet_batches(2, seed=1)
    jnet, tnet = _lenet_pair()
    jbatches, _ = jnet.prepare_resilient_fit(jb)
    tbatches, mesh = tnet.prepare_resilient_fit(tb)
    assert mesh is None and len(tbatches) == len(jbatches) == 2
    assert all(a is b for a, b in zip(tbatches, tb))
    _assert_nets_close(tnet, jnet)
    piped = types.SimpleNamespace(shape={"data": 1, "pipe": 2})
    assert tnet._resolve_fit_mesh(piped, 8) is piped


# -- the port's own contracts ----------------------------------------------------

def _dbn_conf(pkg=tconf, algo="gradient_descent"):
    """A small deep belief net: two binary RBMs (CD-1) and a softmax."""
    return (pkg.NeuralNetConfiguration.builder()
            .n_in(12).lr(0.1).num_iterations(4).use_adagrad(False)
            .activation("sigmoid").compute_dtype("float32")
            .optimization_algo(pkg.OptimizationAlgorithm(algo))
            .list(3).hidden_layer_sizes(8, 6)
            .override(0, kind=pkg.LayerKind.RBM)
            .override(1, kind=pkg.LayerKind.RBM)
            .override(2, kind=pkg.LayerKind.OUTPUT, n_out=3,
                      activation="softmax", loss_function="mcxent",
                      num_iterations=10)
            .pretrain(True).backward(True)
            .build())


def _binary_batches(n_batches=3, b=10, seed=0):
    rng = np.random.default_rng(seed)
    return [TDataSet(torch.from_numpy((rng.random((b, 12)) < 0.5)
                                      .astype(np.float32)),
                     torch.from_numpy(np.eye(3, dtype=np.float32)[
                         rng.integers(0, 3, b)]))
            for _ in range(n_batches)]


@pytest.mark.parametrize("algo", ["gradient_descent", "conjugate_gradient",
                                  "lbfgs"])
def test_same_seed_pretrains_are_equal(algo):
    data = _binary_batches()
    runs = []
    for seed in (5, 5, 6):
        net = TNet(_dbn_conf(algo=algo), device="cpu").init(seed=0)
        net.pretrain(data, seed=seed)
        runs.append(net.params_flat())
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_pretrain_leaves_the_callers_params_and_scores_fall():
    data = _binary_batches(n_batches=2, b=32)
    net = TNet(_dbn_conf(), device="cpu").init(seed=0)
    p0 = [{k: v.clone() for k, v in p.items()} for p in net.params]
    held = net.params
    scores = TCollect()
    net.set_listeners([scores])
    net.fit(data, num_epochs=1)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(held, p0) for k in a)
    assert not torch.equal(net.params_flat(), TNet(
        _dbn_conf(), device="cpu", params=p0).params_flat())
    s = [v for _, v in scores.scores]
    # per layer: 4 iterations x 2 batches; finetune 10; backprop 2
    assert len(s) == 8 + 8 + 10 + 2


def test_fit_captures_nothing_after_warm_up(graphs_on_cpu):  # noqa: F811
    """A fit's captured functions (one pretrain step a layer, the
    finetune solver's step, the backprop step) each capture once, however
    many iterations, batches and layers run; a second fit of the conf
    adds only the new finetune solver's capture."""
    data = _binary_batches()
    net = TNet(_dbn_conf(), device="cpu").init(seed=0)
    net.fit(data, num_epochs=2)
    assert compile_metrics.traces == {
        "multilayer.pretrain_gd[0]": 1, "multilayer.pretrain_gd[1]": 1,
        "solver.gd_step": 1, "multilayer.train_step": 1}
    ref = TNet(_dbn_conf(), device="cpu").init(seed=0)
    with _graphs_off():
        ref.fit(data, num_epochs=2)
    assert torch.equal(net.params_flat(), ref.params_flat())
    compile_metrics.reset()
    TNet(_dbn_conf(), device="cpu").init(seed=1).fit(data)
    assert compile_metrics.traces == {"solver.gd_step": 1}


class _graphs_off:
    def __enter__(self):
        self._on = compile_cache._graphs_on
        compile_cache._graphs_on = lambda dev: False

    def __exit__(self, *exc):
        compile_cache._graphs_on = self._on


def test_pretrain_modules_import_no_jax():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.nn.layers.rbm\n"
            "import deeplearning4j_tpu_torch.nn.layers.autoencoder\n"
            "import deeplearning4j_tpu_torch.nn.multilayer\n"
            "import deeplearning4j_tpu_torch.ops.random\n"
            "import deeplearning4j_tpu_torch.datasets.fetchers\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), \
        res.stdout + res.stderr
