"""The port's multi-process control plane (``parallel/multihost.py``),
cluster-committed checkpoints and the multi-process ``ResilientFit``
against the reference's ``tests/test_multihost_runtime.py``.

Over ``InProcessKV`` thread "hosts" (the reference's tier-1 substrate):
the launcher's wiring (flags over the environment trio, the same results
as the JAX package's ``resolve_cluster_config``), the bounded join retry
and its typed errors, the cluster primitives, timeouts and generations,
virtual hosts, the agreement of divergent heartbeat views, the commit
order of a cluster snapshot, retention, the sharded layout's files, the
heartbeat, preemption propagated to every member at one boundary, a host
loss that evicts one member while the survivor finishes bit for bit, and
a sync timeout that becomes a host loss only on a stale heartbeat.  The
reference's :75 (``cloud/provision.py``) is held in
``tests/test_torch_periphery.py``; its
data plane (:581-628) is here: the store split by member rank, a rank's
rows of a global batch against JAX's ``P("data")`` shard, and
``global_data_mesh`` over a real group.

Across real rank processes (``test_torch_mesh.run_ranks``' gloo group,
the cluster over the group's ``FileStore``): the control plane, a
SIGTERM to one rank that drains both at the same step with one
cluster-committed snapshot, and a SIGKILLed rank whose survivor sees the
step's collective fail, finds the peer's heartbeat stale, shrinks to
generation 1, restores and finishes bit-equal to the uninterrupted
``mesh=None``, ``grad_accum=2`` fit.  Every multi-process test has a
deadline of its own.
"""

import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import multihost as jmh
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.updaters import tree_map
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import multihost as mh
from deeplearning4j_tpu_torch.parallel.chaos import (HostLossChaos,
                                                     PreemptionChaos)
from deeplearning4j_tpu_torch.runtime import checkpoint as ckpt
from deeplearning4j_tpu_torch.runtime.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.runtime.metrics import multihost_metrics
from deeplearning4j_tpu_torch.runtime.resilience import (DeviceLossError,
                                                         PreemptionGuard,
                                                         ResilienceConfig,
                                                         ResilientFit)
from test_torch_mesh import (control_plane_rank, dense_conf, elastic_batches,
                             global_mesh_rank, multihost_fit_rank, run_ranks)

torch.set_num_threads(2)


# -- launcher config: flags over env ------------------------------------------

def test_resolve_cluster_config_precedence_and_partial_errors():
    env = {mh.ENV_COORDINATOR: "envhost:1", mh.ENV_NUM_PROCESSES: "4",
           mh.ENV_PROCESS_ID: "2"}
    assert mh.ENV_TRIO == jmh.ENV_TRIO and mh.FLAG_TRIO == jmh.FLAG_TRIO
    cases = [dict(env=env), dict(process_id=3, env=env),
             dict(coordinator="flag:9", num_processes=8, process_id=0,
                  env=env), dict(env={}),
             dict(process_id=1, env={mh.ENV_COORDINATOR: "h:1",
                                     mh.ENV_NUM_PROCESSES: "2"})]
    for kw in cases:
        got, ref = mh.resolve_cluster_config(**kw), \
            jmh.resolve_cluster_config(**kw)
        assert (got is None) == (ref is None)
        if got is not None:
            assert dataclassish(got) == dataclassish(ref)
    assert mh.resolve_cluster_config(env=env) == \
        mh.ClusterConfig("envhost:1", 4, 2)
    with pytest.raises(ValueError) as ei:
        mh.resolve_cluster_config(env={mh.ENV_COORDINATOR: "h:1"})
    for name in mh.FLAG_TRIO + mh.ENV_TRIO:
        assert name in str(ei.value)
    with pytest.raises(ValueError):
        mh.resolve_cluster_config(
            coordinator="h:1", env={mh.ENV_NUM_PROCESSES: "2"})
    for bad in (("h:1", 2, 5), ("h:1", 0, 0)):
        with pytest.raises(ValueError):
            mh.ClusterConfig(*bad)


def dataclassish(c):
    return (c.coordinator, c.num_processes, c.process_id)


def test_initialize_bounded_retry_and_typed_errors(monkeypatch):
    calls = []

    def flaky(*a, **kw):
        calls.append(kw)
        if len(calls) < 3:
            raise RuntimeError("connection refused")
        return True

    monkeypatch.setattr(tmesh, "initialize_distributed", flaky)
    cfg = mh.ClusterConfig("127.0.0.1:1", 2, 0)
    before = multihost_metrics.count("join_retries")
    # the third attempt joins; no group is really up, so the cluster is
    # the single-process one
    cl = mh.initialize(cfg, attempts=3, backoff_s=0.0, timeout_s=5)
    assert len(calls) == 3 and calls[0]["timeout"] == 5
    assert multihost_metrics.count("join_retries") == before + 2
    assert cl.process_count == 1

    calls.clear()

    def refused(*a, **kw):
        calls.append(kw)
        raise RuntimeError("connection refused")

    monkeypatch.setattr(tmesh, "initialize_distributed", refused)
    with pytest.raises(mh.ClusterJoinError) as ei:
        mh.initialize(cfg, attempts=2, backoff_s=0.0)
    assert len(calls) == 2 and "2 attempt(s)" in str(ei.value)
    assert not isinstance(ei.value, mh.ClusterJoinTimeout)

    def deadline(*a, **kw):
        raise RuntimeError("Socket Timeout: rendezvous timed out")

    monkeypatch.setattr(tmesh, "initialize_distributed", deadline)
    with pytest.raises(mh.ClusterJoinTimeout):
        mh.initialize(cfg, attempts=1, backoff_s=0.0)
    calls.clear()
    monkeypatch.setattr(tmesh, "initialize_distributed", refused)
    assert mh.initialize(mh.ClusterConfig("h:1", 1, 0)).process_count == 1
    assert not calls
    assert mh.initialize_from_env(env={}) is False


# -- the control plane over InProcessKV thread "hosts" ------------------------

def _threads(fn, n):
    """fn(i) on n threads; the first error re-raised."""
    errs = []

    def wrap(i):
        try:
            fn(i)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts), "cluster op hung"
    if errs:
        raise errs[0]


def test_cluster_primitives_barrier_flag_gather_agree():
    kv = mh.InProcessKV()
    cls = [mh.Cluster(p, (0, 1, 2), kv, timeout_s=10) for p in range(3)]
    flags, gathers, agreed, ex, bc = ([None] * 3 for _ in range(5))

    def run(i):
        cls[i].barrier("start")
        flags[i] = cls[i].any_flag(i == 2)
        gathers[i] = cls[i].gather(f"blob{i}", "tbl")
        agreed[i] = cls[i].agree_lost_ids([i, 7])
        ex[i] = cls[i].exchange(str(i), "ex")
        bc[i] = cls[i].broadcast(f"b{i}", "bc")

    _threads(run, 3)
    assert flags == [True, True, True]
    assert gathers[0] == {0: "blob0", 1: "blob1", 2: "blob2"}
    assert gathers[1] is None and gathers[2] is None
    assert all(a == (0, 1, 2, 7) for a in agreed)
    assert all(e == {0: "0", 1: "1", 2: "2"} for e in ex)
    assert bc == ["b0"] * 3

    def run2(i):
        flags[i] = cls[i].any_flag(False)
    _threads(run2, 3)
    assert flags == [False, False, False]
    assert [c.is_coordinator for c in cls] == [True, False, False]
    assert [c.member_rank for c in cls] == [0, 1, 2]
    # a member's own round keys two rounds back are collected
    assert not any("/flag/0/" in k for k in kv._data)


def test_cluster_timeout_and_shrink_generation():
    kv = mh.InProcessKV()
    c0 = mh.Cluster(0, (0, 1), kv, timeout_s=0.2)
    with pytest.raises(mh.ClusterSyncTimeout):
        c0.barrier("alone")
    s = c0.shrink([1])
    assert s.members == (0,) and s.generation == 1
    assert s.is_coordinator and s.process_count == 1
    s.barrier("solo")
    assert s.any_flag(True) is True
    with pytest.raises(ValueError):
        c0.shrink([0, 1])
    assert c0.agree_lost_ids([4], suspects=[1]) == (4,)
    # a shrink that loses the coordinator elects the next member
    assert mh.Cluster(2, (0, 1, 2), kv).shrink([0]).coordinator == 1


def test_cluster_device_map_and_owners():
    kv = mh.InProcessKV()
    dmap = {0: (0, 1, 2, 3), 1: (4, 5, 6, 7)}
    c = mh.Cluster(0, (0, 1), kv, device_map=dmap)
    assert c.devices_of(1) == (4, 5, 6, 7)
    assert c.owners_of([5]) == (1,)
    assert c.owners_of([0, 7]) == (0, 1)
    assert c.owners_of([99]) == ()
    assert c.shrink([1]).device_map == dmap
    # without a map a member drives one device, its rank
    plain = mh.Cluster(1, (0, 1, 2), kv)
    assert plain.devices_of(2) == (2,) and plain.owners_of([0, 2]) == (0, 2)


def test_host_loss_agreement_unions_heartbeat_views():
    """Members with different heartbeat views agree on one lost set: each
    publishes its whole local view into the round (a divergent set would
    fork the shrink)."""
    kv = mh.InProcessKV()
    dmap = {0: (0, 1), 1: (2, 3), 2: (4, 5)}
    cls = [mh.Cluster(p, (0, 1, 2), kv, timeout_s=10, device_map=dmap)
           for p in range(3)]

    class _HB:
        def __init__(self, cluster, lost):
            self.cluster = cluster
            self._lost = tuple(lost)

        def stale_members(self):
            return (2,)

        def lost_device_ids(self):
            return self._lost

    results = [None] * 2

    def run(i):
        fit = ResilientFit.__new__(ResilientFit)
        fit.cluster = cls[i]
        fit._heartbeat = _HB(cls[i], (4, 5) if i == 0 else ())
        fit.config = SimpleNamespace(cluster_timeout_s=10)
        fit.manager = SimpleNamespace(cluster=cls[i])
        err = DeviceLossError((4,) if i == 0 else ())
        results[i] = (fit._host_loss_update(err), fit.cluster)

    _threads(run, 2)
    (lost0, ev0), c0 = results[0]
    (lost1, ev1), c1 = results[1]
    assert not ev0 and not ev1
    assert lost0 == lost1 == (4, 5)
    assert c0.members == c1.members == (0, 1)
    assert c0.generation == c1.generation == 1


def test_store_kv_over_file_and_tcp_stores(tmp_path):
    """The store-backed KV: a get waits for a later put, a missing key
    times out typed, and a waiting thread does not hold up another
    thread's put on the same store client (a TCP store's blocking wait
    would)."""
    import datetime

    stores = [torch.distributed.FileStore(str(tmp_path / "fs"), 1),
              torch.distributed.TCPStore(
                  "127.0.0.1", 0, 1, True,
                  timeout=datetime.timedelta(seconds=30))]
    for store in stores:
        kv = mh.StoreKV(store)
        got = []
        t = threading.Thread(target=lambda: got.append(kv.get("k", 10)))
        t.start()
        t0 = time.monotonic()
        kv.put("other", "x")
        put_s = time.monotonic() - t0
        time.sleep(0.05)
        kv.put("k", "v")
        t.join(10)
        assert got == ["v"] and put_s < 0.5
        with pytest.raises(mh.ClusterSyncTimeout):
            kv.get("never", 0.1)
        kv.delete("k")
        with pytest.raises(mh.ClusterSyncTimeout):
            kv.get("k", 0.05)
    with pytest.raises(RuntimeError, match="not initialized"):
        mh.StoreKV()
    assert mh.active_cluster().process_count == 1


# -- cluster-committed checkpoints --------------------------------------------

def _tree(scale=1.0):
    return {"w": torch.arange(12.0).reshape(3, 4) * scale,
            "b": torch.ones(4) * scale}


def test_cluster_commit_manifest_only_after_all_members(tmp_path):
    """The manifest (the commit marker) does not exist until every
    member reached the data barrier."""
    kv = mh.InProcessKV()
    cls = [mh.Cluster(p, (0, 1), kv, timeout_s=30) for p in (0, 1)]
    mgrs = [CheckpointManager(str(tmp_path), cluster=c) for c in cls]
    manifest = str(tmp_path / "ckpt_3.npz.manifest.json")
    release = threading.Event()
    before = multihost_metrics.count("cluster_commits")

    t0 = threading.Thread(
        target=lambda: mgrs[0].save(3, _tree(), meta={"tag": "m"}))
    t1 = threading.Thread(target=lambda: (
        release.wait(20), mgrs[1].save(3, _tree(), meta={"tag": "m"})))
    t0.start()
    time.sleep(0.5)
    pre = os.path.exists(manifest)
    t1.start()
    release.set()
    t0.join(60)
    t1.join(60)
    assert pre is False, "manifest existed before member 1 joined"
    assert os.path.exists(manifest)
    mgrs[0].verify(3)
    man = json.load(open(manifest))
    assert man["cluster"] == {"layout": "replicated", "members": [0, 1],
                              "coordinator": 0}
    assert multihost_metrics.count("cluster_commits") == before + 2
    for m in mgrs:
        out, meta = m.restore(like=_tree())
        assert torch.equal(out["w"], _tree()["w"]) and meta["tag"] == "m"


def test_cluster_commit_gc_and_retention(tmp_path):
    kv = mh.InProcessKV()
    cls = [mh.Cluster(p, (0, 1), kv, timeout_s=30) for p in (0, 1)]
    mgrs = [CheckpointManager(str(tmp_path), max_to_keep=2, cluster=c)
            for c in cls]

    def run(i):
        for s in (1, 2, 3, 4):
            mgrs[i].save(s, _tree(s), meta={})

    _threads(run, 2)
    assert mgrs[0].all_steps() == [3, 4]
    out, _ = mgrs[1].restore(like=_tree())
    assert torch.equal(out["w"], _tree(4.0)["w"])


def test_sharded_layout_save_and_manager_load(tmp_path):
    """The sharded layout's files, driven as each of two writers in turn
    (writer 1 holds nothing of a host-side tree; writer 0 writes it and
    the index), loaded through the manager's layout dispatch; a missing
    writer's file is a hard error."""
    sdir = str(tmp_path / "ckpt_7.shards")
    tree = {"w": np.arange(8.0).reshape(2, 4)}
    f0 = ckpt.save_pytree_sharded(sdir, tree, {"tag": "s"}, sync=False,
                                  process_index=0, writers=(0, 1),
                                  write_index=True)
    f1 = ckpt.save_pytree_sharded(sdir, {"w": np.zeros((0, 4))},
                                  sync=False, process_index=1,
                                  writers=(0, 1), write_index=False)
    assert "index.json" in f0 and "index.json" not in f1
    assert set(f1) == {"shards_p1.json", "shards_p1.npz"}
    idx = json.load(open(os.path.join(sdir, "index.json")))
    assert idx["writers"] == [0, 1] and idx["n_procs"] == 2
    out, meta = ckpt.load_pytree_sharded(sdir, like=tree)
    np.testing.assert_array_equal(out["w"], tree["w"])
    assert meta["tag"] == "s"
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [7]
    out2, _ = mgr._load_snapshot(7, like=tree)
    np.testing.assert_array_equal(out2["w"], tree["w"])
    os.remove(os.path.join(sdir, "shards_p1.json"))
    with pytest.raises(FileNotFoundError, match="incomplete"):
        ckpt.load_pytree_sharded(sdir, like=tree)


# -- heartbeat host-loss detection --------------------------------------------

def test_heartbeat_staleness_names_the_silent_member(tmp_path):
    kv = mh.InProcessKV()
    dmap = {0: (0, 1), 1: (2, 3)}
    c0 = mh.Cluster(0, (0, 1), kv, device_map=dmap)
    c1 = mh.Cluster(1, (0, 1), kv, device_map=dmap)
    hb0 = mh.HostHeartbeat(str(tmp_path), c0, interval_s=0.1,
                           timeout_s=0.8)
    hb1 = mh.HostHeartbeat(str(tmp_path), c1, interval_s=0.1,
                           timeout_s=0.8)
    with hb0:
        # member 1's file is missing but within the grace window
        assert hb0.stale_members() == ()
        deadline = time.time() + 10
        while hb0.stale_members() != (1,) and time.time() < deadline:
            time.sleep(0.1)
        assert hb0.stale_members() == (1,)
        hb1.start()
        time.sleep(0.3)
        assert hb0.stale_members() == ()
        hb1.stop()
        deadline = time.time() + 10
        while hb0.stale_members() != (1,) and time.time() < deadline:
            time.sleep(0.1)
        assert hb0.stale_members() == (1,)
        assert hb0.lost_device_ids() == (2, 3)


def test_host_loss_chaos_virtual_and_real_hosts():
    c = HostLossChaos(at_step=3, host_index=1, n_hosts=2, devices=range(8))
    assert c.lost_ids == (4, 5, 6, 7)
    assert HostLossChaos(3, 0, n_hosts=4, devices=range(8)).lost_ids == \
        (0, 1)
    mesh = SimpleNamespace(ranks=(4, 5, 6, 7))
    assert HostLossChaos(3, 1, mesh=mesh).lost_ids == (6, 7)
    cl = mh.Cluster(0, (0, 1), mh.InProcessKV(),
                    device_map={0: (0, 1), 1: (2, 3)})
    assert HostLossChaos(3, 1, cluster=cl).lost_ids == (2, 3)
    c(1)
    with pytest.raises(DeviceLossError) as ei:
        c(3)
    assert sorted(ei.value.lost_ids) == [4, 5, 6, 7]
    c(4)    # fires once
    with pytest.raises(ValueError):
        HostLossChaos(at_step=0, host_index=0, n_hosts=99, devices=range(8))


# -- thread-host fits (the real protocol over one process) --------------------

def _mlp():
    return MultiLayerNetwork(dense_conf(tconf), device="cpu").init(seed=9)


def _batches():
    return [DataSet(x, y) for x, y in elastic_batches()]


def _cluster_pair(timeout_s=30):
    kv = mh.InProcessKV()
    dmap = {0: (0, 1, 2, 3), 1: (4, 5, 6, 7)}
    return [mh.Cluster(p, (0, 1), kv, timeout_s=timeout_s, device_map=dmap)
            for p in (0, 1)]


def test_cluster_preemption_propagates_same_boundary(tmp_path):
    """A preemption notice on ONE member stops every member at the same
    step boundary, with one cluster-committed final snapshot."""
    cls = _cluster_pair()
    drvs = [None, None]

    def run(i):
        drv = ResilientFit(_mlp(), ResilienceConfig(
            checkpoint_dir=str(tmp_path), checkpoint_every=3,
            cluster_timeout_s=30, hb_interval_s=0.2, hb_timeout_s=5.0),
            cluster=cls[i])
        if i == 1:
            g = PreemptionGuard()
            drv.preemption_guard = g
            drv.fault_hook = PreemptionChaos(at_step=5, guard=g)
        drvs[i] = drv
        drv.fit(_batches(), num_epochs=3, seed=7)

    _threads(run, 2)
    assert [d.preempted for d in drvs] == [True, True]
    assert drvs[0].steps_run == drvs[1].steps_run == 6
    latest = drvs[0].manager.latest_step()
    drvs[0].manager.verify(latest)
    man = json.load(open(tmp_path / f"ckpt_{latest}.npz.manifest.json"))
    assert man["cluster"]["layout"] == "replicated" and latest == 6
    assert sorted(os.listdir(tmp_path / "heartbeats")) == ["hb_p0", "hb_p1"]


def test_cluster_host_loss_evicts_and_survivor_is_bit_exact(tmp_path):
    """Host 1's devices are lost mid-fit (both members inject the same
    finding): member 1 leaves with ``evicted``, member 0 agrees, shrinks
    to generation 1, restores the last cluster commit and finishes
    bit-equal to an uninterrupted single-process run."""
    ref = _mlp()
    ResilientFit(ref, ResilienceConfig(
        checkpoint_dir=str(tmp_path / "ref"), checkpoint_every=3)).fit(
        _batches(), num_epochs=3, seed=7)
    cls = _cluster_pair()
    drvs = [None, None]
    before = multihost_metrics.count("evictions")

    def run(i):
        drv = ResilientFit(_mlp(), ResilienceConfig(
            checkpoint_dir=str(tmp_path / "c"), checkpoint_every=3,
            cluster_timeout_s=30, hb_interval_s=0.2, hb_timeout_s=5.0),
            cluster=cls[i],
            fault_hook=HostLossChaos(at_step=7, host_index=1,
                                     cluster=cls[i]))
        drvs[i] = drv
        drv.fit(_batches(), num_epochs=3, seed=7)

    _threads(run, 2)
    assert drvs[1].evicted and not drvs[0].evicted
    assert drvs[0].remeshes == 1
    assert drvs[0].cluster.members == (0,)
    assert drvs[0].cluster.generation == 1
    assert multihost_metrics.count("evictions") == before + 1
    assert drvs[0].last_recovery["restored"] == 6
    assert torch.equal(ref.params_flat(), drvs[0].net.params_flat())


def test_translate_sync_timeout_requires_stale_heartbeat(tmp_path):
    """A control-plane timeout with every peer still beating re-raises;
    with a stale heartbeat it is a host loss naming the peer's
    devices."""
    cls = _cluster_pair(timeout_s=0.2)
    drv = ResilientFit(_mlp(), ResilienceConfig(
        checkpoint_dir=str(tmp_path), cluster_timeout_s=0.2),
        cluster=cls[0])
    hb = mh.HostHeartbeat(str(tmp_path), cls[0], interval_s=0.1,
                          timeout_s=30.0)
    mh.HostHeartbeat(str(tmp_path), cls[1], interval_s=0.1,
                     timeout_s=30.0)._beat_once()
    drv._heartbeat = hb
    with pytest.raises(mh.ClusterSyncTimeout):
        drv._cluster_flag(False)
    hb.timeout_s = 0.0
    with pytest.raises(DeviceLossError) as ei:
        drv._cluster_flag(False)
    assert set(ei.value.lost_ids) == {4, 5, 6, 7}
    # a failed collective with a live peer is raised again as it is
    hb.timeout_s, hb.interval_s = 30.0, 0.01
    boom = RuntimeError("Connection closed by peer")
    with pytest.raises(RuntimeError, match="closed by peer"):
        drv._translate_sync_timeout(boom, wait=False)


def test_control_plane_modules_import_no_jax():
    from test_torch_paged import assert_no_jax
    assert_no_jax("deeplearning4j_tpu_torch.parallel.multihost",
                  "deeplearning4j_tpu_torch.parallel.mesh",
                  "deeplearning4j_tpu_torch.runtime.resilience")


def test_data_plane_names_a7_4(tmp_path):
    """The data plane is ported (ROADMAP A7.4): ``stage_global_batch``
    cuts a rank's block after the members agree on the rows,
    ``StagingMismatchError`` is importable and typed, unknown names
    still raise ``AttributeError``."""
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    y = np.arange(8, dtype=np.int64)
    mesh = tmesh.Mesh({"data": 2}, None, (0, 1), 1, torch.device("cpu"),
                      "gloo")
    cls = _cluster_pair()
    got = [None, None]

    def run(i):
        got[i] = mh.stage_global_batch(x, y, mesh, cls[i])

    _threads(run, 2)
    for gx, gy in got:
        assert torch.equal(gx, torch.from_numpy(x[4:]))
        assert torch.equal(gy, torch.from_numpy(y[4:]))
    assert issubclass(mh.StagingMismatchError, RuntimeError)
    with pytest.raises(AttributeError):
        mh.NoSuchThing


def test_worker_store_iterator_splits_disjoint(tmp_path):
    from deeplearning4j_tpu_torch.cloud.artifacts import LocalArtifactStore
    from deeplearning4j_tpu_torch.datasets.store_iterator import \
        write_batches_to_store

    store = LocalArtifactStore(str(tmp_path / "store"))
    write_batches_to_store(store, "train", _batches()[:2] * 3)
    kv = mh.InProcessKV()
    cls = [mh.Cluster(p, (0, 1), kv) for p in (0, 1)]
    its = [mh.worker_store_iterator(store, "train", c) for c in cls]
    keys0, keys1 = set(its[0].keys), set(its[1].keys)
    assert not keys0 & keys1
    assert len(keys0 | keys1) == 6
    for it in its:
        it.close()
    solo = mh.worker_store_iterator(store, "train", cls[0].shrink([1]))
    assert len(solo.keys) == 6
    solo.close()


def test_stage_global_batch_single_process_matches_device_put():
    """One process: a data mesh of one stages the whole batch; on a
    ``data=8`` mesh rank ``r`` stages the reference's shard ``r``
    (``P("data")``), equal to the JAX package's ``device_put`` slice;
    ``local_rows`` of the one-member cluster is the batch itself, of a
    two-member view its contiguous halves."""
    from deeplearning4j_tpu.parallel import mesh as jmesh
    from deeplearning4j_tpu.parallel.sharded_fit import batch_sharding

    x = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.arange(16) % 3]
    one = tmesh.Mesh({"data": 1}, None, (0,), 0, torch.device("cpu"),
                     "gloo")
    gx, gy = mh.stage_global_batch(x, y, one)
    assert torch.equal(gx, torch.from_numpy(x))
    assert torch.equal(gy, torch.from_numpy(y))
    import jax
    jm = jmesh.make_mesh(jmesh.MeshSpec(data=8))
    shards = jax.device_put(x, batch_sharding(jm)).addressable_shards
    for r in range(8):
        m = tmesh.Mesh({"data": 8}, None, tuple(range(8)), r,
                       torch.device("cpu"), "gloo")
        gx, _ = mh.stage_global_batch(x, y, m)
        want = [np.asarray(s.data) for s in shards
                if s.device.id == jm.devices.flat[r].id][0]
        np.testing.assert_array_equal(gx.numpy(), want)
    assert mh.local_rows(x, mh.local_cluster()) is x
    c1 = mh.Cluster(1, (0, 1), mh.InProcessKV())
    np.testing.assert_array_equal(mh.local_rows(x, c1), x[8:])


def test_global_data_mesh_layout(tmp_path):
    outs = run_ranks(global_mesh_rank, 2, tmp_path, deadline=60)
    for shapes in outs:
        assert shapes[0]["data"] == 2 and shapes[0]["model"] == 1
        assert shapes[1]["data"] == 1 and shapes[1]["model"] == 2


# -- real rank processes over the group's store ------------------------------

def _p0():
    return tree_map(lambda t: t.numpy(), _mlp().params)


def test_two_process_cluster_control_plane(tmp_path):
    """``active_cluster`` over a 2-rank group: barriers, the flag OR,
    gather, agreement, exchange and broadcast ride the FileStore, and a
    peer that never shows times out typed."""
    outs = run_ranks(control_plane_rank, 2, tmp_path, deadline=60)
    for pid, o in enumerate(outs):
        assert o["count"] == 2 and o["pid"] == pid
        assert o["flag1"] is True and o["flag0"] is False
        assert o["agreed"] == (1, 11)
        assert o["exchange"] == {0: "0", 1: "2"}
        assert o["broadcast"] == "from0"
    assert outs[0]["gather"] == {0: "blob0", 1: "blob1"}
    assert outs[1]["gather"] is None
    name, secs = outs[0]["timeout"]
    assert name == "ClusterSyncTimeout" and 0.25 < secs < 5


def test_two_process_preemption_sigterm_drains_all(tmp_path):
    """A SIGTERM to ONE rank process drains both at the same step
    boundary, with one cluster-committed final snapshot."""
    outs = run_ranks(multihost_fit_rank, 2, tmp_path, _p0(),
                     str(tmp_path), "sigterm", deadline=90)
    assert [o["preempted"] for o in outs] == [True, True]
    assert outs[0]["steps_run"] == outs[1]["steps_run"]
    assert outs[0]["latest"] == outs[1]["latest"] == 6
    mgr = CheckpointManager(str(tmp_path / "sigterm"))
    mgr.verify(6)
    man = json.load(open(tmp_path / "sigterm" / "ckpt_6.npz.manifest.json"))
    assert man["cluster"]["members"] == [0, 1]


def test_two_process_host_loss_survivor_resumes_bit_exact(tmp_path):
    """Rank 1 is SIGKILLed at step 5 (no goodbye).  Rank 0's step
    collective fails, the heartbeat names rank 1 stale, the cluster
    shrinks to generation 1, the mesh re-meshes to none with
    ``grad_accum=2``, step 3 restores, and the run finishes bit-equal to
    the uninterrupted ``mesh=None``, ``grad_accum=2`` fit (and within
    1e-6 of this process's own run of it)."""
    outs = run_ranks(multihost_fit_rank, 2, tmp_path, _p0(),
                     str(tmp_path), "kill", deadline=90, dies=(1,))
    o = outs[0]
    assert outs[1] is None
    assert not o["evicted"] and o["remeshes"] == 1
    assert o["members"] == [0] and o["generation"] == 1
    assert o["shape"] is None and o["elastic_accum"] == 2
    assert o["conf_accum"] == 1
    rec = o["recovery"]
    assert rec["lost_at"] == 5 and rec["restored"] == 3
    np.testing.assert_array_equal(o["params"], o["ref_params"])
    from deeplearning4j_tpu_torch.nn.params import params_from_numpy
    net = MultiLayerNetwork(dense_conf(tconf, accum=2),
                            params=params_from_numpy(_p0(), "cpu"),
                            device="cpu")
    ResilientFit(net, ResilienceConfig(
        checkpoint_dir=str(tmp_path / "here"), checkpoint_every=3)).fit(
        _batches(), num_epochs=4, seed=7)
    np.testing.assert_allclose(o["params"], net.params_flat().numpy(),
                               rtol=0, atol=1e-6)
