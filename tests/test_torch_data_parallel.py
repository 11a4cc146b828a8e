"""The port's ``DataParallelTrainer`` and ``ParameterAveragingTrainer``
on two gloo ranks against the reference's on a 2-device data mesh (the
cases of tests/test_parallel.py:59-112), from the same initial params
(JAX's draws) and the same Iris batches.

The two ranks run once, in a module fixture (``test_torch_mesh.
run_ranks``).  Tolerances: one gradient-sharing step against the
single-device step of the reference's test, 1e-5 relative and 1e-6
absolute (its own bar); whole fits against the reference's fits, 1e-5
relative and 1e-6 absolute (fp32 products and means, rounded by each
library's reductions over up to 30 steps); the staged fit against the
per-batch loop, bit-equal (the same captured step); accuracy bars are
the reference tests' own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.updaters import dl4j_updater as jupdater
from deeplearning4j_tpu.parallel import (DataParallelTrainer as JDP,
                                         ParameterAveragingTrainer as JPA)
from deeplearning4j_tpu.parallel import mesh as jmesh
from test_torch_mesh import data_parallel_rank, iris_batches, run_ranks

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _jloss(params, x, y, key):
    logp = jax.nn.log_softmax(x @ params["W"] + params["b"], axis=-1)
    return -jnp.mean(jnp.sum(y * logp, axis=-1))


def _w0():
    return np.asarray(0.01 * jax.random.normal(jax.random.key(0), (4, 3)))


def _jp0(w0):
    return {"W": jnp.asarray(w0), "b": jnp.zeros((3,))}


def _jbatches(n, b):
    return [(jnp.asarray(x), jnp.asarray(y)) for x, y in iris_batches(n, b)[0]]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    w0 = _w0()
    res = run_ranks(data_parallel_rank, 2,
                    tmp_path_factory.mktemp("data_parallel"), w0)
    mesh = jmesh.make_mesh(jmesh.MeshSpec(data=2), devices=jax.devices()[:2])
    return {"w0": w0, "ranks": res, "mesh": mesh}


def _close(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=RTOL,
                                   atol=ATOL)


def test_gradient_sharing_trains(ranks):
    r0, r1 = ranks["ranks"]
    assert r0["sharing_acc"] == r1["sharing_acc"] > 0.8


def test_gradient_sharing_equals_single_device_math(ranks):
    """One step on 2 ranks == the reference's single-device step on the
    global batch."""
    w0 = ranks["w0"]
    (x, y), = _jbatches(1, 80)
    upd = jupdater(lr=0.1, momentum=0.0, use_adagrad=False)
    params = _jp0(w0)
    score, grads = jax.value_and_grad(_jloss)(params, x, y, None)
    updates, _ = upd.update(upd.init(params), grads, params, 0, 1)
    p_ref = jax.tree.map(lambda p, u: p - u, params, updates)
    for r in ranks["ranks"]:
        _close(r["step"], p_ref)
        assert abs(r["step_score"] - float(score)) < 1e-5


def test_scanned_fit_equals_loop_and_reference(ranks):
    r0, r1 = ranks["ranks"]
    for k in r0["scan"]:
        np.testing.assert_array_equal(r0["scan"][k], r0["loop"][k])
        np.testing.assert_array_equal(r0["scan"][k], r1["scan"][k])
    tr = JDP(_jloss, jupdater(lr=0.3, momentum=0.0, use_adagrad=False),
             ranks["mesh"])
    _close(r0["scan"], tr.fit(_jp0(ranks["w0"]), _jbatches(4, 80),
                              jax.random.key(5)))


def test_gradient_sharing_fit_matches_reference(ranks):
    r0 = ranks["ranks"][0]
    tr = JDP(_jloss, jupdater(lr=0.5, momentum=0.9, use_adagrad=False),
             ranks["mesh"])
    want = tr.fit(_jp0(ranks["w0"]), _jbatches(30, 80), jax.random.key(0))
    acc = float((np.argmax(iris_batches(1, 1)[1][0] @ np.asarray(want["W"])
                           + np.asarray(want["b"]), -1)
                 == np.argmax(iris_batches(1, 1)[1][1], -1)).mean())
    assert acc == r0["sharing_acc"]


@pytest.mark.parametrize("name,steps,each,n_b,bar", [
    ("avg_rounds", 5, True, 12, 0.8), ("avg_once", 10, False, 6, 0.7)])
def test_parameter_averaging_matches_reference(ranks, name, steps, each,
                                               n_b, bar):
    r0, r1 = ranks["ranks"]
    for k in r0[name]:
        np.testing.assert_array_equal(r0[name][k], r1[name][k])
    assert r0[name + "_acc"] > bar
    tr = JPA(_jloss, jupdater(lr=0.5, momentum=0.0, use_adagrad=False),
             ranks["mesh"], local_steps=steps, average_each_round=each)
    _close(r0[name], tr.fit(_jp0(ranks["w0"]), _jbatches(n_b, 80),
                            jax.random.key(1)))
