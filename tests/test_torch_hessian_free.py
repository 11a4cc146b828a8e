"""The port's Hessian-free optimizer (``optimize/hessian_free.py``) against
the JAX reference on the CPU.

- ``GNObjective.gnvp`` (jvp through the network, the head's Hessian by a
  jvp of its gradient, vjp back) against JAX's on the same params and
  directions, and against the dense Gauss-Newton matrix JᵀHJ built from
  ``torch.func.jacrev`` / ``hessian``;
- the Gauss-Newton matrix is PSD along random directions (the
  reference's ``tests/test_hessian_free.py:64``);
- ``MultiLayerNetwork.finetune`` of a HESSIAN_FREE conf (routed to
  ``fit_hessian_free``): the Iris conf of ``tests/test_hessian_free.py
  :86`` and the curves autoencoder of :108, 3 outer iterations each, the
  damping λ after every iteration equal to JAX's and the scores within
  rtol 1e-4;
- the captures: ``value``, ``value_and_grad`` and the damped product
  capture once each, and none after the first outer iteration as λ
  adapts (λ is a 0-d tensor argument), through the CPU stand-in for the
  capture of ``tests/test_torch_compile_cache.py``.

Tolerances (fp32): products 1e-5 (atol, relative to O(1) values); HF
scores rtol 1e-4, params atol 1e-4 after 3 outer iterations of up to 50
CG iterations each (the CG recurrences carry the two frameworks' rounding
differences, e.g. the reference's alpha = rs / pAp in float64 on the host
against the port's fp32 on the device).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.fetchers import IrisDataFetcher
from deeplearning4j_tpu.nn.conf import configuration as jconf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize.hessian_free import \
    GNObjective as JGNObjective
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets.fetchers import CurvesDataFetcher
from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.params import params_from_numpy
from deeplearning4j_tpu_torch.optimize.hessian_free import (
    GNObjective, _tdot)
from deeplearning4j_tpu_torch.runtime import compile_cache
from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics
from test_torch_compile_cache import graphs_on_cpu  # noqa: F401

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
GNVP_TOL = 1e-5
SCORE_RTOL, PARAM_ATOL = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def fresh_engine():
    compile_cache.clear()
    compile_metrics.reset()
    yield


def _toy(seed=0):
    """The reference test's 2-layer MLP with a softmax head, from numpy."""
    rng = np.random.default_rng(seed)
    params = {"w1": (rng.standard_normal((5, 4)) * 0.3).astype(np.float32),
              "w2": (rng.standard_normal((4, 3)) * 0.3).astype(np.float32)}
    x = rng.standard_normal((16, 5)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]

    jobj = JGNObjective(
        lambda p: jnp.tanh(jnp.asarray(x) @ p["w1"]) @ p["w2"],
        lambda z: -jnp.mean(jnp.sum(jnp.asarray(labels)
                                    * jax.nn.log_softmax(z), -1)))
    tobj = GNObjective(
        lambda p: torch.tanh(torch.from_numpy(x) @ p["w1"]) @ p["w2"],
        lambda z: -torch.mean(torch.sum(torch.from_numpy(labels)
                                        * torch.log_softmax(z, -1), -1)))
    return jobj, tobj, params


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_gnvp_matches_reference_and_dense_gauss_newton():
    jobj, tobj, params = _toy()
    rng = np.random.default_rng(1)
    tparams = _t(params)
    # the dense G = J^T H J over the flattened params
    names = sorted(params)
    sizes = [params[k].size for k in names]

    def unflat(f):
        out, i = {}, 0
        for k, n in zip(names, sizes):
            out[k] = f[i:i + n].reshape(params[k].shape)
            i += n
        return out

    flat = torch.cat([tparams[k].reshape(-1) for k in names])
    J = torch.func.jacrev(lambda f: tobj.logits_fn(unflat(f)).reshape(-1))(
        flat)
    z = tobj.logits_fn(tparams)
    H = torch.func.hessian(lambda zf: tobj.loss_from_logits(
        zf.reshape(z.shape)))(z.reshape(-1))
    G = J.T @ H @ J
    for i in range(3):
        v = {k: rng.standard_normal(p.shape).astype(np.float32)
             for k, p in params.items()}
        jgv = jobj.gnvp(jax.tree.map(jnp.asarray, params),
                        jax.tree.map(jnp.asarray, v))
        tgv = tobj.gnvp(tparams, _t(v))
        for k in params:
            np.testing.assert_allclose(tgv[k].numpy(), np.asarray(jgv[k]),
                                       rtol=GNVP_TOL, atol=GNVP_TOL,
                                       err_msg=k)
        vf = torch.cat([_t(v)[k].reshape(-1) for k in names])
        np.testing.assert_allclose(
            torch.cat([tgv[k].reshape(-1) for k in names]).numpy(),
            (G @ vf).numpy(), rtol=1e-4, atol=GNVP_TOL)


def test_gn_matrix_is_psd_along_random_directions():
    _, tobj, params = _toy(seed=2)
    tparams = _t(params)
    for i in range(5):
        g = torch.Generator().manual_seed(10 + i)
        v = {k: torch.randn(p.shape, generator=g) for k, p in
             tparams.items()}
        assert float(_tdot(v, tobj.gnvp(tparams, v))) >= -1e-6


def _iris_conf(pkg):
    """tests/test_hessian_free.py:90-98 at 3 iterations, fp32 compute."""
    return (pkg.NeuralNetConfiguration.builder()
            .n_in(4).num_iterations(3).compute_dtype("float32")
            .optimization_algo(pkg.OptimizationAlgorithm.HESSIAN_FREE)
            .activation("tanh")
            .list(2)
            .hidden_layer_sizes(10)
            .override(1, kind=pkg.LayerKind.OUTPUT, n_out=3,
                      activation="softmax", loss_function="mcxent")
            .pretrain(False).backward(False)
            .build())


def _curves_conf(pkg):
    """tests/test_hessian_free.py:116-124 at 3 iterations, fp32 compute."""
    return (pkg.NeuralNetConfiguration.builder()
            .n_in(64).lr(0.05).use_adagrad(False).compute_dtype("float32")
            .num_iterations(3).activation("sigmoid")
            .optimization_algo(pkg.OptimizationAlgorithm.HESSIAN_FREE)
            .list(2).hidden_layer_sizes(24)
            .override(1, kind=pkg.LayerKind.OUTPUT, n_out=64,
                      activation="sigmoid", loss_function="mse")
            .pretrain(False).backward(False).build())


def _iris_data():
    f = IrisDataFetcher()
    f.fetch(150)
    d = f.next().normalize_zero_mean_unit_variance().shuffle(0)
    return np.array(d.features), np.array(d.labels)


def _curves_data():
    f = CurvesDataFetcher(n=128, dim=64)
    return f.features, f.labels


class _Record:
    """Each outer iteration's score and the damping λ after it."""

    def __init__(self):
        self.rows = []

    def iteration_done(self, model, iteration, score):
        self.rows.append((score, model.lam))


@pytest.mark.parametrize("case", ["iris", "curves"])
def test_hessian_free_finetune_matches_reference(case):
    conf_of, data_of, seed = {"iris": (_iris_conf, _iris_data, 5),
                              "curves": (_curves_conf, _curves_data, 0)}[case]
    x, y = data_of()
    jnet = JNet(conf_of(jconf)).init(seed=seed)
    tnet = TNet(conf_of(tconf), device="cpu", params=params_from_numpy(
        jax.tree.map(np.asarray, jnet.params), "cpu"))
    jrec, trec = _Record(), _Record()
    jnet.set_listeners([jrec])
    tnet.set_listeners([trec])
    jdata = JDataSet(jnp.asarray(x), jnp.asarray(y))
    tdata = TDataSet(torch.from_numpy(x), torch.from_numpy(y))
    before = tnet.score(tdata)
    jnet.finetune(jdata)
    tnet.finetune(tdata)
    assert len(trec.rows) == len(jrec.rows) == 3
    assert [lam for _, lam in trec.rows] == [lam for _, lam in jrec.rows]
    np.testing.assert_allclose([s for s, _ in trec.rows],
                               [s for s, _ in jrec.rows], rtol=SCORE_RTOL)
    for tp, jp in zip(tnet.params, jnet.params):
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=PARAM_ATOL)
    assert tnet.score(tdata) < before


def test_hessian_free_captures_once_as_lambda_adapts(graphs_on_cpu):  # noqa: F811
    x, y = _iris_data()
    net = TNet(_iris_conf(tconf), device="cpu").init(seed=5)
    rec = _Record()
    net.set_listeners([rec])
    net.finetune(TDataSet(torch.from_numpy(x), torch.from_numpy(y)))
    assert len({lam for _, lam in rec.rows}) > 1      # λ adapted
    assert compile_metrics.traces == {"hf.value": 1, "hf.value_and_grad": 1,
                                      "hf.damped_mv": 1}


def test_hessian_free_imports_no_jax():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.optimize.hessian_free\n"
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
