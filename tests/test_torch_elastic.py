"""The elastic re-mesh and ``ResilientFit``'s device-loss recovery
against the JAX reference (``parallel/mesh.py:292-365``,
``runtime/resilience.py:884-987``).

- **The plan.** ``parallel.mesh.elastic_plan`` gives the new shape, the
  ranks the new mesh keeps and the accumulation that JAX's
  ``elastic_remesh`` gives on meshes of the same shape over the 8 CPU
  devices (device ids are ranks), over the reference's matrix
  (test_async_checkpoint.py:590-620, test_model_parallel.py:279-303,
  test_parallel_4d.py:184-195); its ``RemeshError`` words are JAX's.
- **The elastic fits** (the reference MLP, no dropout, carried JAX
  params) on four gloo ranks of ``test_torch_mesh.run_ranks``: a loss
  of half the ranks mid-fit evicts the named ranks and re-meshes the
  others to ``data=1 x model=2`` with ``elastic_accum == 2``; their
  params are ``torch.equal`` to the ranks' uninterrupted ``data=2 x
  model=2`` run, and within 1e-5 of JAX's own run of the reference
  test's configuration.  Shrinking ``data=2`` keeps the gloo data-axis
  sum bit for bit (two summands); a 4-rank data axis shrunk to 2 does
  not, since gloo's ring all-reduce of four adds in another order than
  the survivors' accumulation (measured: 37-39% of 1000 sums differ in
  the last bit), so the drills shrink a data axis of 2.  The same drill
  runs with and without a cluster (cluster-committed replicated
  snapshots, or the gathered one of the mesh's first rank), with a
  virtual host of two ranks, with a corrupt newest snapshot (the
  restore falls back one step), and on a tiny CausalLM on ``data=2 x
  model=2`` whose snapshots are four ranks' pieces (the survivors
  restore them resharded).
- **The refusals.** Lost ids outside the mesh re-raise on every rank,
  and a loss with ``mesh=None`` and no cluster re-raises.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import configuration as jconf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel.chaos import DeviceLossChaos as JDLC
from deeplearning4j_tpu.parallel.chaos import HostLossChaos as JHLC
from deeplearning4j_tpu.runtime.resilience import (
    ResilienceConfig as JConfig, ResilientFit as JFit)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.params import params_from_numpy
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel.chaos import DeviceLossChaos
from deeplearning4j_tpu_torch.runtime.resilience import (DeviceLossError,
                                                         ResilienceConfig,
                                                         ResilientFit)
from test_torch_mesh import (axes_lm_cfg, dense_conf, elastic_batches,
                             elastic_corrupt_rank, elastic_lm_rank,
                             elastic_rank, elastic_refusal_rank, lm_ids,
                             run_ranks, survivor_groups_rank)

torch.set_num_threads(2)

#: the port's elastic fit against JAX's run of the reference configuration
JAX_RTOL = 1e-5


# -- the plan ----------------------------------------------------------------

PLAN_CASES = [
    (dict(data=4), [2, 3], 1), (dict(data=4), [3], 1),
    (dict(data=4), [1, 2, 3], 2), (dict(data=8), [4, 5, 6, 7], 1),
    (dict(data=2, model=2), [0], 1), (dict(data=2, model=2), [3], 1),
    (dict(data=2, model=2), [1, 3], 2), (dict(data=2, pipe=2), [0], 1),
    (dict(data=2, seq=2), [0], 1), (dict(data=2, expert=2), [1], 3),
    (dict(data=2, model=2, pipe=2), [7], 1),
    (dict(data=4, model=2), [0, 5], 1),
]


def _jmesh(spec):
    n = int(np.prod(list(spec.values())))
    return jmesh.make_mesh(jmesh.MeshSpec(**spec), devices=jax.devices()[:n])


@pytest.mark.parametrize("spec,lost,accum", PLAN_CASES)
def test_elastic_plan_matches_jax(spec, lost, accum):
    jm = _jmesh(spec)
    ranks = [int(d.id) for d in jm.devices.flat]
    new_jm, jaccum = jmesh.elastic_remesh(jm, lost, grad_accum=accum)
    shape, survivors, new_accum = tmesh.elastic_plan(
        dict(jm.shape), ranks, lost, accum)
    assert new_accum == jaccum
    if new_jm is None:
        assert shape is None and len(survivors) == 1
        return
    assert shape == {a: int(new_jm.shape.get(a, 1)) for a in tmesh.ALL_AXES}
    assert survivors == [int(d.id) for d in new_jm.devices.flat]
    fake = tmesh.Mesh(dict(jm.shape), None, tuple(ranks), 0,
                      torch.device("cpu"), "gloo")
    assert tmesh.surviving_devices(fake, lost) == \
        [int(d.id) for d in jmesh.surviving_devices(jm, lost)]


@pytest.mark.parametrize("spec,lost", [
    (dict(data=4), [0, 1, 2, 3]), (dict(data=1, model=4), [0]),
    (dict(data=1, model=2, pipe=2), [0])])
def test_remesh_errors_are_jaxs_words(spec, lost):
    jm = _jmesh(spec)
    with pytest.raises(jmesh.RemeshError) as want:
        jmesh.elastic_remesh(jm, lost)
    with pytest.raises(tmesh.RemeshError) as got:
        tmesh.elastic_plan(dict(jm.shape),
                           [int(d.id) for d in jm.devices.flat], lost)
    assert str(got.value) == str(want.value)
    assert issubclass(tmesh.RemeshError, ValueError)


# -- the elastic fits --------------------------------------------------------

def _p0():
    net = JNet(dense_conf(jconf)).init(seed=9)
    return jax.tree.map(np.asarray, net.params)


def _jax_run(p0, spec, fault, tmp_path):
    """JAX's ResilientFit of the reference test's configuration from the
    same params: its params_flat."""
    net = JNet(dense_conf(jconf))
    net.params = jax.tree.map(jax.numpy.asarray, p0)
    batches = [JDataSet(jax.numpy.asarray(x), jax.numpy.asarray(y))
               for x, y in elastic_batches()]
    drv = JFit(net, JConfig(checkpoint_dir=str(tmp_path / "jax"),
                            checkpoint_every=3, shuffle=False),
               mesh=_jmesh(spec),
               fault_hook=fault)
    drv.fit(batches, num_epochs=3, seed=7)
    assert drv.remeshes == 1
    return np.asarray(net.params_flat())


def _check_drill(ranks, lost, survivors):
    for r, res in enumerate(ranks):
        d = res["drill"]
        if r in lost:
            assert d["evicted"] and d["remeshes"] == 0, r
            continue
        assert not d["evicted"] and d["remeshes"] == 1, r
        assert d["shape"] == dict(data=1, model=2, pipe=1, seq=1,
                                  expert=1)
        assert d["ranks"] == survivors
        assert d["elastic_accum"] == 2 and d["conf_accum"] == 1
        assert d["device_losses"] == 1 and d["elastic_resumes"] == 1
        assert d["recovery"]["lost_at"] == 7
        assert d["recovery"]["restored"] == 6
        assert torch.equal(torch.from_numpy(d["params"]),
                           torch.from_numpy(res["ref"]["params"])), r


@pytest.mark.parametrize("cluster", [False, True])
def test_device_loss_mid_fit_resumes_bit_exact(tmp_path, cluster):
    """Half the ranks lost at step 7 on ``data=2 x model=2``: ranks 2
    and 3 leave evicted, ranks 0 and 1 re-mesh to ``data=1 x model=2``
    (accumulation 2, the conf untouched), restore step 6 and finish
    ``torch.equal`` to the uninterrupted run; within 1e-5 of JAX's
    reference drill (``data=4``, devices 2 and 3 lost at step 7)."""
    p0 = _p0()
    ranks = run_ranks(elastic_rank, 4, tmp_path, dict(data=2, model=2), p0,
                      ("device", 7, [2, 3]), str(tmp_path), cluster,
                      deadline=90)
    _check_drill(ranks, (2, 3), [0, 1])
    if cluster:
        for res in ranks[:2]:
            assert res["drill"]["members"] == [0, 1]
            assert res["drill"]["generation"] == 1
    want = _jax_run(p0, dict(data=4), JDLC(at_step=7, lost_ids=[2, 3]),
                    tmp_path)
    np.testing.assert_allclose(ranks[0]["drill"]["params"], want,
                               rtol=JAX_RTOL, atol=1e-7)


def test_virtual_host_loss_remesh_resumes_bit_exact(tmp_path):
    """Two virtual hosts of two ranks (contiguous blocks of the mesh's
    ranks); host 0, the writer's, is lost at step 7: ranks 2 and 3
    re-mesh to ``data=1 x model=2`` (rank 2 now writes) and finish
    ``torch.equal`` to the uninterrupted run; within 1e-5 of JAX's
    reference drill (``data=8`` as two hosts of four, host 1 lost)."""
    p0 = _p0()
    ranks = run_ranks(elastic_rank, 4, tmp_path, dict(data=2, model=2), p0,
                      ("host", 7, 0, 2), str(tmp_path), False, deadline=90)
    _check_drill(ranks, (0, 1), [2, 3])
    want = _jax_run(p0, dict(data=8), JHLC(at_step=7, host_index=1,
                                           n_hosts=2), tmp_path)
    np.testing.assert_allclose(ranks[2]["drill"]["params"], want,
                               rtol=JAX_RTOL, atol=1e-7)


def test_elastic_resume_survives_corrupt_latest_checkpoint(tmp_path):
    """A device loss and a corrupt newest snapshot: the restore walks
    back to the previous committed step and the run finishes."""
    ranks = run_ranks(elastic_corrupt_rank, 4, tmp_path, _p0(),
                      str(tmp_path / "ck"), deadline=90)
    for r in (0, 1):
        d = ranks[r]
        assert d["remeshes"] == 1 and d["restore_fallbacks"] == 1
        assert d["recovery"]["restored"] == 3
        assert np.isfinite(d["params"]).all()
    assert ranks[2]["evicted"] and ranks[3]["evicted"]


def test_stale_device_loss_ids_reraise(tmp_path):
    """Ids that are not in the mesh surface the DeviceLossError on every
    rank instead of "recovering" onto the same mesh forever."""
    outs = run_ranks(elastic_refusal_rank, 2, tmp_path, _p0(),
                     str(tmp_path / "ck"), deadline=60)
    assert all(o["raised"] == [97] and o["elastic_resumes"] == 0
               for o in outs)


def test_device_loss_single_device_reraises(tmp_path):
    net = MultiLayerNetwork(dense_conf(tconf),
                            params=params_from_numpy(_p0(), "cpu"),
                            device="cpu")
    drv = ResilientFit(net, ResilienceConfig(checkpoint_dir=str(tmp_path)),
                       mesh=None,
                       fault_hook=DeviceLossChaos(at_step=2, lost_ids=[0]))
    with pytest.raises(DeviceLossError):
        drv.fit([DataSet(x, y) for x, y in elastic_batches(2)],
                num_epochs=2, seed=7)
    assert drv.remeshes == 0 and not drv.evicted


def test_sharded_snapshot_elastic_drill_on_a_causal_lm(tmp_path):
    """A tiny CausalLM GPT on ``data=2 x model=2`` under a cluster: every
    snapshot is four ranks' pieces (``ckpt_<n>.shards``, the manifest's
    layout ``sharded``); ranks 2 and 3 lost at step 5 leave, ranks 0 and
    1 restore step 4 resharded onto ``data=1 x model=2`` and finish
    ``torch.equal`` to the uninterrupted run."""
    import json

    from deeplearning4j_tpu_torch.models import lm_fit
    from deeplearning4j_tpu_torch.ops.updaters import tree_map

    lm = lm_fit.CausalLM(axes_lm_cfg(), lr=0.05, momentum=0.9,
                         device="cpu").init(0)
    params = tree_map(lambda t: t.numpy(), lm.params)
    ranks = run_ranks(elastic_lm_rank, 4, tmp_path, params,
                      lm_ids(64, n=4, rows=8, seq=16), str(tmp_path),
                      deadline=90)
    for r, res in enumerate(ranks):
        d = res["drill"]
        assert d["evicted"] == (r >= 2)
        if r >= 2:
            continue
        assert d["elastic_accum"] == 2
        assert d["shape"] == dict(data=1, model=2, pipe=1, seq=1, expert=1)
        assert d["recovery"]["restored"] == 4
        assert torch.equal(torch.from_numpy(d["params"]),
                           torch.from_numpy(res["ref"]["params"]))
    files = ranks[0]["drill"]["files"]
    assert {f"ckpt_4.shards/shards_p{k}.npz" for k in range(4)} <= set(files)
    assert "ckpt_6.shards/shards_p1.npz" in files
    assert "ckpt_6.shards/shards_p2.npz" not in files
    man = json.loads((tmp_path / "drill" / "ckpt_4.npz.manifest.json")
                     .read_text())
    assert man["cluster"]["layout"] == "sharded"
    assert man["cluster"]["members"] == [0, 1, 2, 3]
    assert any(k.startswith("ckpt_4.shards/shards_p3") for k in man["files"])


def test_auto_data_mesh_over_one_survivor_and_a_plan_that_drops_one():
    """``auto_data_mesh(devices=)`` with fewer than two survivors is no
    mesh; three survivors of ``data=4`` keep two ranks (the third leaves
    the run, where the reference leaves its device idle)."""
    assert tmesh.auto_data_mesh(devices=[3]) is None
    plan = tmesh.elastic_plan({"data": 4}, [0, 1, 2, 3], [0], 1)
    assert plan == ({"data": 2, "model": 1, "pipe": 1, "seq": 1,
                     "expert": 1}, [1, 2], 2)


def test_survivors_build_their_groups_after_a_killed_peer(tmp_path):
    """The rule the re-mesh rests on, on gloo: after a peer is SIGKILLed
    the old group's collective fails at once ("Connection closed by
    peer"), and ``make_mesh(..., ranks=survivors)``, called by the
    survivors alone, makes working groups (``use_local_synchronization``:
    a ``new_group`` every rank of the default group must call would wait
    on the dead one)."""
    outs = run_ranks(survivor_groups_rank, 3, tmp_path, deadline=60,
                     dies=(2,))
    assert outs[2] is None
    for rank, o in enumerate(outs[:2]):
        name, secs = o["failed"]
        assert name in ("RuntimeError", "DistBackendError") and secs < 5
        assert o["ranks"] == (0, 1)
        assert o["model_sum"] == [3.0, 3.0] and o["data_sum"] == [3.0]
