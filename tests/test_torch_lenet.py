"""LeNet at full width: the port's MultiLayerNetwork against JAX's.

JAX's ``lenet(compute_dtype=...)`` params (seed 123) are carried over
with ``params_from_numpy``; the same numpy batches (B=8, from a seed)
go through both packages.  JAX's fits run with ``mesh=None``: under the
8-device test platform its default ``mesh="auto"`` shards any batch of
8 or more, and its sharded path is not its single-device one.

Tolerances, each with its reason:
- forward logits: fp32 2e-5, bf16 3e-2 (``tests/test_pallas_attention.py``
  :34, :55, :76);
- first-step gradients, per leaf, max |diff| <= 5e-4 of the leaf's max
  |grad| (fp32; summation order only);
- per-step losses: fp32 rtol 1e-4 over 10 steps, bf16 rtol 5e-2 over 3
  (bf16 rounds activations at other places in the two frameworks);
- params after the fp32 fits: 1e-5 absolute;
- served rows against an unpadded forward, and outputs after a blob
  crosses packages: fp32 2e-5.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import \
    ListDataSetIterator as JListIterator
from deeplearning4j_tpu.models import lenet as jlenet
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize.listeners import \
    CollectScoresListener as JCollect
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets.iterator import \
    ListDataSetIterator as TListIterator
from deeplearning4j_tpu_torch.models import lenet as tlenet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.params import params_from_numpy
from deeplearning4j_tpu_torch.optimize.listeners import \
    CollectScoresListener as TCollect
from deeplearning4j_tpu_torch.runtime import telemetry

torch.set_num_threads(2)

B = 8
FWD_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
STEPS = {"float32": 10, "bfloat16": 3}
GRAD_TOL = 5e-4
PARAM_TOL = 1e-5


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 28, 28, 1), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def _pair(dtype):
    """A JAX LeNet and the port's, on the same params."""
    jnet = jlenet.lenet(compute_dtype=dtype)
    tnet = TNet(tlenet.lenet_conf(compute_dtype=dtype),
                params=params_from_numpy(
                    jax.tree.map(np.asarray, jnet.params), "cpu"),
                device="cpu")
    return jnet, tnet


def _np(params):
    return [{k: (v.numpy() if isinstance(v, torch.Tensor) else
                 np.asarray(v)) for k, v in p.items()} for p in params]


def _assert_params_close(tparams, jparams, tol):
    for i, (t, j) in enumerate(zip(_np(tparams), _np(jparams))):
        assert sorted(t) == sorted(j)
        for k in t:
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=tol,
                                       err_msg=f"layer {i} {k}")


def _scores(listener):
    return np.array([s for _, s in listener.scores])


def _fit_both(dtype, batches, fit):
    """``fit(net, batches)`` in both packages from the same params;
    returns (jnet, tnet, jax losses, port losses)."""
    jnet, tnet = _pair(dtype)
    jc, tc = JCollect(), TCollect()
    jnet.set_listeners([jc])
    tnet.set_listeners([tc])
    fit(jnet, [JDataSet(x, y) for x, y in batches], jax_side=True)
    fit(tnet, [TDataSet(x, y) for x, y in batches], jax_side=False)
    return jnet, tnet, _scores(jc), _scores(tc)


def _fit_backprop(net, batches, jax_side):
    net.fit_backprop(batches, **({"mesh": None} if jax_side else {}))


def _fit_iterator(net, batches, jax_side):
    it = (JListIterator if jax_side else TListIterator)(batches, B)
    net.fit_iterator(it, **({"mesh": None} if jax_side else {}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(dtype):
    jnet, tnet = _pair(dtype)
    x, _ = _data(B)

    def logits(net, params, x):
        return net.output_layer.pre_output(
            params[-1], net.hidden_activations(params, x))

    got = logits(tnet, tnet.params, torch.from_numpy(x))
    ref = np.asarray(logits(jnet, jnet.params, x))
    assert tuple(got.shape) == (B, 10)
    np.testing.assert_allclose(got.numpy(), ref, rtol=FWD_TOL[dtype],
                               atol=FWD_TOL[dtype])
    np.testing.assert_allclose(
        tnet.feed_forward(tnet.params, torch.from_numpy(x))[-1].numpy(),
        np.asarray(jnet.feed_forward(jnet.params, x)[-1]),
        rtol=FWD_TOL[dtype], atol=FWD_TOL[dtype])


def test_first_step_gradients_match_jax():
    jnet, tnet = _pair("float32")
    x, y = _data(B)
    jg = jax.grad(jnet.loss)(jnet.params, x, y)
    live = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
            for p in tnet.params]
    tnet.loss(live, torch.from_numpy(x), torch.from_numpy(y)).backward()
    for i, (t, j) in enumerate(zip(live, jg)):
        for k in t:
            ref = np.asarray(j[k])
            diff = np.abs(t[k].grad.numpy() - ref).max()
            assert diff <= GRAD_TOL * np.abs(ref).max(), (i, k, diff)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fit", [_fit_backprop, _fit_iterator],
                         ids=["fit_backprop", "fit_iterator"])
def test_training_matches_jax(dtype, fit):
    """A uniform batch list (fit_backprop's staged path) and the same
    batches through a ListDataSetIterator."""
    batches = [_data(B, seed) for seed in range(STEPS[dtype])]
    tracer = telemetry.enable()
    try:
        jnet, tnet, js, ts = _fit_both(dtype, batches, fit)
    finally:
        telemetry.disable()
    assert len(ts) == len(js) == STEPS[dtype]
    np.testing.assert_allclose(ts, js, rtol=LOSS_RTOL[dtype])
    if dtype == "float32":
        _assert_params_close(tnet.params, jnet.params, PARAM_TOL)
    names = {r["name"] for r in tracer.records()}
    assert "multilayer.fit" in names and "multilayer.epoch" in names
    assert ("multilayer.stage" in names) == (fit is _fit_backprop)


def test_ragged_last_batch_takes_the_per_step_path():
    x, y = _data(21, seed=3)
    batches = [(x[i:i + B], y[i:i + B]) for i in range(0, 21, B)]
    tracer = telemetry.enable()
    try:
        jnet, tnet, js, ts = _fit_both("float32", batches, _fit_backprop)
    finally:
        telemetry.disable()
    assert "multilayer.stage" not in {r["name"] for r in tracer.records()}
    np.testing.assert_allclose(ts, js, rtol=LOSS_RTOL["float32"])
    _assert_params_close(tnet.params, jnet.params, PARAM_TOL)


def test_guard_skips_a_poisoned_batch_and_keeps_state():
    """A NaN batch leaves params and updater state as they were: the run
    g0, NaN, g1 ends bit-equal to the run g0, g1 (momentum would carry
    a poisoned or advanced velocity into g1), and both packages count
    one skip."""
    good = [_data(B, seed) for seed in (0, 1)]
    bad = (np.full((B, 28, 28, 1), np.nan, np.float32), good[0][1])
    jnet, tnet, js, ts = _fit_both("float32", [good[0], bad, good[1]],
                                   _fit_backprop)
    assert tnet.guard_skips == jnet.guard_skips == 1
    assert np.isnan(ts[1]) and np.isnan(js[1])
    _, clean = _pair("float32")
    clean.fit_backprop([TDataSet(x, y) for x, y in good])
    for a, b in zip(tnet.params, clean.params):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    _assert_params_close(tnet.params, jnet.params, PARAM_TOL)

    # one step alone: params and both updater buffers come back unchanged
    updaters = tnet._updaters()
    ustate = [u.init(p) for u, p in zip(updaters, tnet.params)]
    ustate = [type(s)(*({k: v + 1.0 for k, v in t.items()} for t in s))
              for s in ustate]
    params, new_ustate, _, skipped = tnet._train_step(
        updaters, tnet.params, ustate, torch.from_numpy(bad[0]),
        torch.from_numpy(bad[1]), torch.Generator(), 0)
    assert int(skipped) == 1
    for new, old in zip(params, tnet.params):
        assert all(torch.equal(new[k], old[k]) for k in old)
    for new, old in zip(new_ustate, ustate):
        for new_buf, old_buf in zip(new, old):
            assert all(torch.equal(new_buf[k], old_buf[k]) for k in old_buf)


def _trained_pair():
    jnet, tnet = _pair("float32")
    batches = [_data(B, seed) for seed in (5, 6)]
    jnet.fit_backprop([JDataSet(x, y) for x, y in batches], mesh=None)
    tnet.fit_backprop([TDataSet(x, y) for x, y in batches])
    return jnet, tnet


def test_to_bytes_loads_across_packages():
    jnet, tnet = _trained_pair()
    x, _ = _data(13, seed=9)
    from_jax = TNet.from_bytes(jnet.to_bytes(), device="cpu")
    np.testing.assert_allclose(from_jax.output(x).numpy(),
                               np.asarray(jnet.output(x)),
                               rtol=FWD_TOL["float32"],
                               atol=FWD_TOL["float32"])
    from_port = JNet.from_bytes(tnet.to_bytes())
    np.testing.assert_allclose(np.asarray(from_port.output(x)),
                               tnet.output(x).numpy(),
                               rtol=FWD_TOL["float32"],
                               atol=FWD_TOL["float32"])
    # params_flat equal leaf by leaf where the params are the same
    np.testing.assert_array_equal(from_jax.params_flat().numpy(),
                                  np.asarray(jnet.params_flat()))
    np.testing.assert_array_equal(np.asarray(from_port.params_flat()),
                                  tnet.params_flat().numpy())
    assert from_jax.conf.to_json() == jnet.conf.to_json()


def test_output_predict_score_evaluate_match_jax():
    jnet, tnet = _trained_pair()
    x, y = _data(37, seed=10)
    out = tnet.output(x)
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x)),
                               rtol=FWD_TOL["float32"],
                               atol=FWD_TOL["float32"])
    # the engine's padded buckets give the unpadded forward's rows
    np.testing.assert_allclose(
        out.numpy(),
        tnet.feed_forward(tnet.params, torch.from_numpy(x))[-1].numpy(),
        rtol=FWD_TOL["float32"], atol=FWD_TOL["float32"])
    np.testing.assert_allclose(tnet.output(torch.from_numpy(x)).numpy(),
                               out.numpy(), rtol=0, atol=0)
    np.testing.assert_array_equal(tnet.predict(x).numpy(),
                                  np.asarray(jnet.predict(x)))
    np.testing.assert_allclose(tnet.score(TDataSet(x, y)),
                               jnet.score(JDataSet(x, y)),
                               rtol=FWD_TOL["float32"])
    tev = tnet.evaluate(TDataSet(x, y))
    jev = jnet.evaluate(JDataSet(x, y))
    np.testing.assert_array_equal(tev.confusion.counts, jev.confusion.counts)
    assert tev.accuracy() == jev.accuracy()
    eng = tlenet.lenet_serving(tnet, max_batch_size=16)
    assert eng.buckets == (1, 2, 4, 8, 16)
    assert eng.input_spec == ((28, 28, 1), np.float32)


def test_merge_and_clone_match_jax():
    jnet, tnet = _trained_pair()
    jpeer, tpeer = _pair("float32")
    jnet.merge([jpeer])
    tnet.merge([tpeer])
    _assert_params_close(tnet.params, jnet.params, 1e-7)
    twin = tnet.clone()
    assert twin.conf.to_json() == tnet.conf.to_json()
    assert twin.params[0]["W"] is not tnet.params[0]["W"]
    assert torch.equal(twin.params_flat(), tnet.params_flat())
