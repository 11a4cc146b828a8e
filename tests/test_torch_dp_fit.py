"""The port's data-parallel, accumulation and bf16 ``MultiLayerNetwork``
fits against the JAX reference (the contracts of tests/test_dp_fit.py).

Every fit starts from JAX's initial params (``params_from_numpy``) on
the reference's confs at fp32 compute.  The 2-rank fits run once, in a
module fixture: a gloo group of two spawned CPU processes
(``test_torch_mesh.run_ranks``) against the reference on a 2-device
data mesh of its 8-device CPU platform.

Tolerances, each with its reason:
- accumulation and the 2-rank fits against the reference, fp32: 1e-6
  relative (the same masked sums and one divide; rounding differs
  between XLA's and PyTorch's reductions) with 1e-7 absolute for
  entries near zero;
- the 2-rank fit against the port's own ``grad_accum=2`` at equal
  effective batch: bit-equal (the same two row blocks, summed in one
  order by the all-reduce of two and by the accumulator);
- bf16 against the reference's bf16 fit: 5e-2 relative;
- batch norm's moments under ``bn_collective`` against the plain batch
  moments: 1e-5 relative (E[x^2] - E[x]^2 against the mean of squared
  deviations).
"""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets.iterator import (ListDataSetIterator,
                                                        PrefetchIterator)
from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
from deeplearning4j_tpu_torch.nn.layers import extras as textras
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.params import params_from_numpy
from deeplearning4j_tpu_torch.parallel import sharded_fit as tsf
from deeplearning4j_tpu_torch.runtime.metrics import dp_metrics
from test_torch_mesh import (_fake_mesh, dense_batches, dense_conf,
                             dp_fit_rank, run_ranks)

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-7
BF16_RTOL = 5e-2


def _p0(bn=False):
    net = JNet(dense_conf(jconf, bn=bn)).init(seed=3 if bn else 1)
    return jax.tree.map(np.asarray, net.params)


def _jfit(batches, mesh=None, p0=None, **kw):
    """The reference's fit: params_flat and per-step scores."""
    net = JNet(dense_conf(jconf, **kw))
    net.params = jax.tree.map(jax.numpy.asarray, p0)
    scores = []

    class Rec:
        def iteration_done(self, model, i, s):
            scores.append(s)
    net.listeners = [Rec()]
    net.fit_backprop([JDataSet(x, y) for x, y in batches], num_epochs=2,
                     mesh=mesh)
    return np.asarray(net.params_flat()), np.array(scores)


def _tfit(batches, p0, mesh=None, **kw):
    net = TNet(dense_conf(tconf, **kw), params=params_from_numpy(p0, "cpu"),
               device="cpu")
    scores = []

    class Rec:
        def iteration_done(self, model, i, s):
            scores.append(s)
    net.listeners = [Rec()]
    net.fit_backprop([TDataSet(x, y) for x, y in batches], num_epochs=2,
                     mesh=mesh)
    return net.params_flat().numpy(), np.array(scores), net


def _mesh2():
    return jmesh.make_mesh(jmesh.MeshSpec(data=2), devices=jax.devices()[:2])


# -- one process --------------------------------------------------------------

def test_grad_accum_equals_undivided_batch():
    p0 = _p0()
    plain, s_plain, _ = _tfit(dense_batches(), p0)
    accum, s_accum, _ = _tfit(dense_batches(), p0, accum=2)
    np.testing.assert_allclose(accum, plain, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s_accum, s_plain, rtol=RTOL)
    jaccum, js = _jfit(dense_batches(), p0=p0, accum=2)
    np.testing.assert_allclose(accum, jaccum, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s_accum, js, rtol=RTOL)


def test_bf16_mixed_precision_matches_reference_bf16_fit():
    p0 = _p0()
    got, s, net = _tfit(dense_batches(), p0, mp="bf16")
    want, js = _jfit(dense_batches(), p0=p0, mp="bf16")
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-3)
    np.testing.assert_allclose(s, js, rtol=BF16_RTOL)
    fp32, _, _ = _tfit(dense_batches(), p0)
    assert not np.array_equal(got, fp32)          # the cast took effect
    assert net.guard_skips == 0


def test_ragged_trailing_batch_pads_into_one_dispatch():
    p0 = _p0()
    full = dense_batches(4)
    ragged = full[:3] + [(full[3][0][:21], full[3][1][:21])]
    dp_metrics.reset()
    got, _, _ = _tfit(ragged, p0, accum=2)
    snap = dp_metrics.snapshot()
    assert snap["dispatches"] == 1 and snap["steps"] == 8, snap
    assert snap["accum_factor"] == 2
    want, _ = _jfit(ragged, p0=p0, accum=2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    single, _, _ = _tfit(ragged, p0)          # per step, unpadded
    np.testing.assert_allclose(got, single, rtol=RTOL, atol=ATOL)


def test_bn_collective_moments_exclude_padding():
    from deeplearning4j_tpu.nn.layers import extras as jextras
    c = tconf.NeuralNetConfiguration(n_in=6, n_out=6)
    layer = textras.BatchNormLayer(c)
    params = layer.init(torch.Generator(), "cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(16, 6)
                         .astype(np.float32))
    plain = layer.activate(params, x, train=True)
    with textras.bn_collective(None, torch.ones(16)):
        masked = layer.activate(params, x, train=True)
    torch.testing.assert_close(masked, plain, rtol=1e-5, atol=1e-6)
    x_pad = torch.cat([x, torch.full((8, 6), 7.7)])
    mask = torch.cat([torch.ones(16), torch.zeros(8)])
    with textras.bn_collective(None, mask):
        padded = layer.activate(params, x_pad, train=True)
    torch.testing.assert_close(padded[:16], masked, rtol=1e-5, atol=1e-6)
    # the reference's layer under its own context, same params and rows
    jl = jextras.BatchNormLayer(jconf.NeuralNetConfiguration(n_in=6, n_out=6))
    jp = {k: jax.numpy.asarray(v.numpy()) for k, v in params.items()}
    with jextras.bn_collective(None, jax.numpy.asarray(mask.numpy())):
        jout = jl.activate(jp, jax.numpy.asarray(x_pad.numpy()), train=True)
    np.testing.assert_allclose(padded.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    # bf16 rows with mean >> std: the sums run in fp32
    xb = (10.0 + 0.1 * torch.from_numpy(np.random.RandomState(1).randn(
        64, 6).astype(np.float32))).to(torch.bfloat16)
    with textras.bn_collective(None, torch.ones(64)):
        out_b = layer.activate(params, xb, train=True)
    ref = layer.activate(params, xb.float(), train=True)
    np.testing.assert_allclose(out_b.float().numpy(), ref.numpy(), atol=0.35)
    assert float(out_b.float().abs().max()) < 10.0


def test_bn_collective_names_a7_for_other_axes():
    # an axis by name alone has no group in the port; named with its
    # mesh, every axis is accepted (the data axis of a data x seq mesh
    # here)
    with pytest.raises(ValueError, match="name the mesh too"):
        with textras.bn_collective("model", torch.ones(2)):
            pass
    mesh = _fake_mesh(2)
    mesh.shape["seq"] = 2
    with textras.bn_collective((mesh, "data"), torch.ones(2)):
        pass


def test_prefetch_iterator_stages_this_ranks_rows():
    mesh = _fake_mesh(4)
    mesh.rank = 1
    inner = ListDataSetIterator(
        [TDataSet(x, y) for x, y in dense_batches(3, rows=20)], batch_size=20)
    dp_metrics.reset()
    with PrefetchIterator(inner, depth=2, pad_rows_to=8,
                          sharding=tsf.batch_sharding(mesh)) as pf:
        seen = []
        while pf.has_next():
            seen.append(pf.next())
    assert len(seen) == 3
    for ds, (x, _) in zip(seen, dense_batches(3, rows=20)):
        assert ds.n_valid == 20 and ds.staged
        assert ds.features.shape == (6, 4)        # 24 rows over 4 ranks
        np.testing.assert_array_equal(ds.features.numpy(), x[6:12])
    snap = dp_metrics.snapshot()
    assert snap["batches_staged"] == 3 and snap["bytes_staged"] > 0


def test_explicit_mesh_checks():
    net = TNet(dense_conf(tconf), device="cpu").init(0)
    with pytest.raises(ValueError, match="cannot shard"):
        net._resolve_fit_mesh(_fake_mesh(4), 2)
    # a pipe axis is taken with the weights replicated over it
    m = _fake_mesh(1)
    m.shape["pipe"] = 2
    assert net._resolve_fit_mesh(m, 8) is m
    m.shape["rows"] = 2
    with pytest.raises(ValueError, match="the axes are"):
        net._resolve_fit_mesh(m, 8)
    assert net._resolve_fit_mesh("auto", 8) is None     # no group up


def test_resilient_fit_resumes_the_accumulation_step_exactly(tmp_path):
    from deeplearning4j_tpu_torch.runtime.resilience import (
        ResilienceConfig, ResilientFit)
    p0 = _p0()
    batches = [TDataSet(x, y) for x, y in dense_batches(3, rows=21)]

    def run(d, **kw):
        net = TNet(dense_conf(tconf, accum=2, mp="bf16"),
                   params=params_from_numpy(p0, "cpu"), device="cpu")
        ResilientFit(net, ResilienceConfig(checkpoint_dir=str(d),
                                           checkpoint_every=2, shuffle=False,
                                           **kw)).fit(batches, num_epochs=2)
        return net

    whole = run(tmp_path / "whole")
    part = run(tmp_path / "part", max_steps=3)
    assert not torch.equal(part.params_flat(), whole.params_flat())
    resumed = run(tmp_path / "part", resume=True)
    assert torch.equal(resumed.params_flat(), whole.params_flat())


# -- two gloo ranks against the reference's 2-device mesh ---------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    p0, p0_bn = _p0(), _p0(bn=True)
    res = run_ranks(dp_fit_rank, 2, tmp_path_factory.mktemp("dp_fit"),
                    p0, p0_bn)
    return {"p0": p0, "p0_bn": p0_bn, "ranks": res}


def test_two_rank_fit_matches_reference_two_device_mesh(ranks):
    r0, r1 = ranks["ranks"]
    np.testing.assert_array_equal(r0["plain"], r1["plain"])
    want, _ = _jfit(dense_batches(), mesh=_mesh2(), p0=ranks["p0"])
    np.testing.assert_allclose(r0["plain"], want, rtol=RTOL, atol=ATOL)
    # mesh="auto" takes the 2-rank group
    np.testing.assert_array_equal(r0["auto"], r0["plain"])
    snap = r0["metrics"]
    assert snap["dispatches"] == 1 and snap["steps"] == 8, snap
    assert snap["data_degree"] == 2 and snap["batches_staged"] == 4, snap


def test_two_rank_fit_equals_grad_accum_2_at_equal_effective_batch(ranks):
    accum, _, _ = _tfit(dense_batches(), ranks["p0"], accum=2)
    np.testing.assert_array_equal(ranks["ranks"][0]["plain"], accum)


def test_two_rank_bn_collective_fit_matches_reference(ranks):
    r0, r1 = ranks["ranks"]
    np.testing.assert_array_equal(r0["bn"], r1["bn"])
    want, _ = _jfit(dense_batches(2, rows=21), mesh=_mesh2(),
                    p0=ranks["p0_bn"], bn=True)
    np.testing.assert_allclose(r0["bn"], want, rtol=1e-5, atol=1e-6)


def test_collective_guard_skips_on_every_rank(ranks):
    r0, r1 = ranks["ranks"]
    assert r0["poison_skips"] == r1["poison_skips"] == 2     # 1 an epoch
    assert np.isfinite(r0["poison"]).all()
    np.testing.assert_array_equal(r0["poison"], r1["poison"])
    want, _ = _jfit(dense_batches(4, poison={2}, poison_row=20),
                    mesh=_mesh2(), p0=ranks["p0"])
    np.testing.assert_allclose(r0["poison"], want, rtol=RTOL, atol=ATOL)


def test_fit_iterator_on_a_mesh_equals_fit_backprop(ranks):
    for r in ranks["ranks"]:
        np.testing.assert_allclose(r["iterator"], r["plain"], rtol=1e-6,
                                   atol=1e-6)
