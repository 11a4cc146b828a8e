"""The port's checkpoint writing against the JAX reference's format.

``runtime/checkpoint.py`` in both packages writes the same files: an npz
of ``a0 .. aN`` in JAX's flatten order, a sidecar with ``paths`` /
``meta`` / ``"format": 1``, and a manager's crc32 manifest.  Trees of
fp32 and int leaves written by either package are restored by the
other and compared bit for bit; bf16 round-trips within the port (the
reference cannot restore its own bf16 leaf with ``like=``, ROADMAP
Queue C), and its bytes equal the reference's on disk.  The manager's
retention, verification, fallback and orphan sweep, the async writer
(commit equal to a sync save, backpressure at ``max_in_flight``, writer
errors surfacing), ``ModelSaver`` rotation, ``save_model`` /
``load_model`` across the packages (identical predictions) and the
transformer ``TrainState`` carried across (tiny GPT, fp32: one step in
each package from a JAX-written state, losses within 1e-5 relative, the
stepped states within 1e-5) run here on the CPU.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models import transformer as jtfm
from deeplearning4j_tpu.nn.conf import LayerKind as JLayerKind
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh
from deeplearning4j_tpu.runtime import checkpoint as jckpt
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.models import transformer as ttfm
from deeplearning4j_tpu_torch.nn.conf import LayerKind as TLayerKind
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TConf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.ops import updaters
from deeplearning4j_tpu_torch.runtime import checkpoint as tckpt
from deeplearning4j_tpu_torch.runtime.metrics import checkpoint_metrics

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
#: a TrainState carried across: one fp32 step of the same arithmetic
STATE_RTOL = 1e-5


class Pair(NamedTuple):
    first: object
    second: object


def _np_tree(seed=0):
    """Mixed dict / NamedTuple / list tree of fp32 and int32 leaves (JAX
    without x64 holds no int64), keys deliberately unsorted."""
    rng = np.random.default_rng(seed)
    return {
        "b": rng.standard_normal((3, 4)).astype(np.float32),
        "a": {"z": rng.integers(-5, 5, (6,)).astype(np.int32),
              "y": [rng.standard_normal(2).astype(np.float32),
                    np.asarray(7, np.int32)]},
        "pair": Pair(first=rng.standard_normal((2, 2)).astype(np.float32),
                     second={"k": rng.integers(0, 9, (3,)).astype(np.int32)}),
    }


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(_to(tree.first, fn), _to(tree.second, fn))
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


def _torch_tree(seed=0):
    return _to(_np_tree(seed), lambda a: torch.from_numpy(np.array(a)))


def _jax_tree(seed=0):
    return _to(_np_tree(seed), jnp.asarray)


def _leaves(tree):
    """(path, numpy array) pairs of either package's tree."""
    def as_np(v):
        if isinstance(v, torch.Tensor):
            return v.numpy()
        return np.asarray(v)
    return [(p, as_np(v)) for p, v in tckpt._flatten_with_paths(tree)]


def _assert_bitwise(got, ref):
    g, r = _leaves(got), _leaves(ref)
    assert [p for p, _ in g] == [p for p, _ in r]
    for (p, a), (_, b) in zip(g, r):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=p)


# -- the tree format -----------------------------------------------------------

def test_flatten_order_is_jax_sorted_keys():
    tree = {"b": 1, "a": {"z": 2, "y": [3, 4]}}
    assert [p for p, _ in tckpt._flatten_with_paths(tree)] == \
        ["a/y/0", "a/y/1", "a/z", "b"]
    for seed in (0, 1):
        assert [p for p, _ in tckpt._flatten_with_paths(_torch_tree(seed))] \
            == [p for p, _ in jckpt._flatten_with_paths(_jax_tree(seed))]
    # named tuples by field name, None an empty subtree, as JAX
    state = ttfm.TrainState({"w": torch.zeros(1)},
                            (updaters.AdamWState(torch.zeros((), dtype=torch.int32),
                                                 {"w": torch.zeros(1)},
                                                 {"w": torch.zeros(1)}), (), None),
                            3)
    assert [p for p, _ in tckpt._flatten_with_paths(state)] == [
        "params/w", "opt_state/0/count", "opt_state/0/mu/w",
        "opt_state/0/nu/w", "step"]


def test_round_trip_with_and_without_template(tmp_path):
    p = str(tmp_path / "t.npz")
    tree = _torch_tree()
    tree["n"] = 5
    tree["wide"] = torch.arange(3, dtype=torch.int64) - 2 ** 40
    files = tckpt.save_pytree(p, tree, {"note": "x"})
    assert set(files) == {"t.npz", "t.npz.json"}
    with open(p + ".json") as f:
        side = json.load(f)
    assert side["format"] == 1 and side["meta"] == {"note": "x"}
    restored, meta = tckpt.load_pytree(p, like=tree)
    assert meta["note"] == "x"
    assert isinstance(restored["pair"], Pair) and restored["n"] == 5
    assert list(restored) == list(tree)          # the template's key order
    _assert_bitwise(restored, tree)
    plain, _ = tckpt.load_pytree(p)
    assert set(plain) == {"a", "b", "n", "pair", "wide"}
    assert torch.equal(plain["wide"], tree["wide"])
    assert torch.equal(plain["a"]["y"]["1"], tree["a"]["y"][1])
    assert torch.equal(plain["pair"]["second"]["k"],
                       tree["pair"].second["k"])
    with pytest.raises(tckpt.StructureMismatchError):
        tckpt.load_pytree(p, like={"other": torch.zeros(1)})


def test_template_dtype_and_device_rule(tmp_path):
    p = str(tmp_path / "t.npz")
    tckpt.save_pytree(p, {"w": torch.arange(4, dtype=torch.float32)})
    out, _ = tckpt.load_pytree(p, like={"w": torch.zeros(4,
                                                         dtype=torch.float64)})
    assert out["w"].dtype == torch.float64 and out["w"].device.type == "cpu"
    out, _ = tckpt.load_pytree(p, like={"w": np.zeros(4, np.float32)})
    assert isinstance(out["w"], np.ndarray)


def test_bf16_round_trip_as_raw_v2_bytes(tmp_path):
    p = str(tmp_path / "bf.npz")
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    tckpt.save_pytree(p, {"x": x})
    with np.load(p) as z:
        raw = z["a0"]
    assert raw.dtype == np.dtype("V2")
    # the same bytes numpy writes for JAX's bf16
    jraw = np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(raw.view(np.uint16), jraw.view(np.uint16))
    back, _ = tckpt.load_pytree(p, like={"x": torch.zeros(5, 3,
                                                          dtype=torch.bfloat16)})
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], x)
    plain, _ = tckpt.load_pytree(p)
    assert torch.equal(plain["x"], x)


# -- across the packages ---------------------------------------------------------

def test_jax_manager_writes_port_manager_restores(tmp_path):
    d = str(tmp_path / "ck")
    jm = jckpt.CheckpointManager(d, max_to_keep=2)
    jm.save(3, _jax_tree(0), meta={"rollbacks": 1})
    jm.save(4, _jax_tree(1))
    tm = tckpt.CheckpointManager(d)
    assert tm.all_steps() == [3, 4]
    tm.verify(4)
    got, meta = tm.restore(like=_torch_tree(5))
    assert meta["step"] == 4
    _assert_bitwise(got, _torch_tree(1))
    got3, meta3 = tm.restore(step=3, like=_torch_tree(5))
    assert meta3["rollbacks"] == 1
    _assert_bitwise(got3, _torch_tree(0))


def test_port_manager_writes_jax_manager_restores(tmp_path):
    d = str(tmp_path / "ck")
    tm = tckpt.CheckpointManager(d)
    tm.save(7, _torch_tree(2), meta={"rollbacks": 0})
    jm = jckpt.CheckpointManager(d)
    jm.verify(7)
    got, meta = jm.restore(like=_jax_tree(9))
    assert meta["step"] == 7
    _assert_bitwise(_to(got, np.asarray), _to(_np_tree(2), np.asarray))
    # the manifest's shape is the reference's
    with open(os.path.join(d, "ckpt_7.npz.manifest.json")) as f:
        man = json.load(f)
    assert man["format"] == 1 and man["step"] == 7
    assert set(man["files"]) == {"ckpt_7.npz", "ckpt_7.npz.json"}
    assert set(man["files"]["ckpt_7.npz"]) == {"crc32", "bytes"}


# -- the manager -----------------------------------------------------------------

def _val(tree):
    return float(tree["v"])


def test_rolling_retention_and_verify(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"v": torch.tensor(float(s))})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    tree, meta = mgr.restore()
    assert _val(tree) == 4.0 and meta["step"] == 4
    tree3, _ = mgr.restore(step=3, like={"v": torch.tensor(0.0)})
    assert _val(tree3) == 3.0
    mgr.verify(3)
    assert not os.path.exists(mgr._path(1) + ".manifest.json")


@pytest.mark.parametrize("damage", ["corrupt", "truncate", "uncommitted"])
def test_restore_falls_back_past_a_bad_newest_step(tmp_path, damage):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), max_to_keep=5)
    for s in (1, 2):
        mgr.save(s, {"v": torch.tensor(float(s))})
    path = mgr._path(2)
    if damage == "corrupt":
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
    elif damage == "truncate":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    else:
        os.remove(mgr._manifest_path(2))
    checkpoint_metrics.reset()
    with pytest.raises(tckpt.CorruptCheckpointError):
        mgr.verify(2)
    tree, meta = mgr.restore(like={"v": torch.tensor(0.0)})
    assert _val(tree) == 1.0 and meta["step"] == 1
    assert checkpoint_metrics.count("restore_fallbacks") == 1
    if damage != "uncommitted":
        with pytest.raises(tckpt.CorruptCheckpointError):
            mgr.restore(step=2)


def test_orphaned_tmp_files_are_swept(tmp_path):
    d = tmp_path / "ck"
    d.mkdir()
    for name in ("ckpt_5.npz.tmp", "ckpt_5.npz.json.tmp",
                 "ckpt_5.npz.manifest.json.tmp"):
        (d / name).write_bytes(b"partial")
    (d / "keep.txt").write_text("x")
    tckpt.CheckpointManager(str(d))
    assert sorted(os.listdir(d)) == ["keep.txt"]


def test_sharded_and_orbax_paths_name_their_roadmap_item(tmp_path):
    for call in (lambda: tckpt.save_pytree_sharded(str(tmp_path / "s"), {}),
                 lambda: tckpt.load_pytree_sharded(str(tmp_path / "s")),
                 lambda: tckpt.OrbaxCheckpointManager(str(tmp_path / "o")),
                 lambda: tckpt.CheckpointManager(str(tmp_path / "c"),
                                                 cluster=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            call()


# -- the async writer ------------------------------------------------------------

def test_async_commit_matches_sync_save(tmp_path):
    tree = _torch_tree(3)
    sync = tckpt.CheckpointManager(str(tmp_path / "sync"))
    sync.save(1, tree, meta={"k": 1})
    amgr = tckpt.CheckpointManager(str(tmp_path / "async"))
    checkpoint_metrics.reset()
    with tckpt.AsyncCheckpointer(amgr) as ac:
        h = ac.save(1, tree, meta={"k": 1})
        # the snapshot owns its copy: writing the live tree after save()
        # returns cannot reach the file
        tree["b"].add_(100.0)
        ac.wait_until_finished()
    assert h.done() and h.result() == amgr._path(1)
    a, _ = amgr.restore(like=_torch_tree(0))
    s, _ = sync.restore(like=_torch_tree(0))
    _assert_bitwise(a, s)
    snap = checkpoint_metrics.snapshot()
    assert snap["saves_async"] == 1 and snap["snapshots_committed"] == 1
    assert snap["in_flight"] == 0 and snap["bytes_staged"] > 0


def test_async_host_buffers_are_pooled_and_reservable(tmp_path,
                                                    monkeypatch):
    """A second snapshot of a state allocates no host buffer (the pool
    keeps the first one's), and a pool reserved from a template makes
    the first snapshot allocate none; the files are unchanged by the
    reuse."""
    allocs = []
    real = tckpt._host_empty
    monkeypatch.setattr(tckpt, "_host_empty",
                        lambda shape, dtype: allocs.append(1)
                        or real(shape, dtype))
    n_leaves = sum(isinstance(x, torch.Tensor)
                   for x in updaters.tree_leaves(_torch_tree(0)))
    mgr = tckpt.CheckpointManager(str(tmp_path / "a"), max_to_keep=5)
    with tckpt.AsyncCheckpointer(mgr, max_in_flight=1) as ac:
        ac.save(1, _torch_tree(1))
        ac.wait_until_finished()
        assert len(allocs) == ac.pool.allocations == n_leaves
        ac.save(2, _torch_tree(2))
        ac.wait_until_finished()
        assert len(allocs) == n_leaves
    for step in (1, 2):
        got, _ = mgr.restore(step=step, like=_torch_tree(0))
        _assert_bitwise(got, _torch_tree(step))
    allocs.clear()
    mgr = tckpt.CheckpointManager(str(tmp_path / "b"))
    with tckpt.AsyncCheckpointer(mgr, max_in_flight=2) as ac:
        nbytes = ac.reserve(_torch_tree(0))
        assert len(allocs) == 2 * n_leaves and nbytes == ac.pool.nbytes > 0
        ac.save(1, _torch_tree(3))
        ac.save(2, _torch_tree(4))
        ac.wait_until_finished()
        assert len(allocs) == 2 * n_leaves
    got, _ = mgr.restore(step=2, like=_torch_tree(0))
    _assert_bitwise(got, _torch_tree(4))


def test_async_backpressure_bounded_at_max_in_flight(tmp_path, monkeypatch):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), max_to_keep=10)
    gate = threading.Event()
    real = mgr.save
    active, peak = [0], [0]
    lock = threading.Lock()

    def slow(*a, **kw):
        with lock:
            active[0] += 1
        gate.wait(10)
        try:
            return real(*a, **kw)
        finally:
            with lock:
                active[0] -= 1

    monkeypatch.setattr(mgr, "save", slow)
    checkpoint_metrics.reset()
    ac = tckpt.AsyncCheckpointer(mgr, max_in_flight=2)
    ac.save(1, {"v": torch.tensor(1.0)})
    ac.save(2, {"v": torch.tensor(2.0)})
    assert checkpoint_metrics.snapshot()["in_flight"] == 2
    third = threading.Thread(target=lambda: ac.save(3, {"v": torch.tensor(3.0)}))
    third.start()
    time.sleep(0.3)
    assert third.is_alive()           # blocked: two snapshots pending
    assert checkpoint_metrics.count("backpressure_waits") == 1
    gate.set()
    third.join(10)
    ac.close()
    assert mgr.all_steps() == [1, 2, 3]
    assert checkpoint_metrics.snapshot()["max_in_flight"] == 2


def test_async_writer_error_surfaces(tmp_path, monkeypatch):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(mgr, "save", boom)
    ac = tckpt.AsyncCheckpointer(mgr)
    h = ac.save(1, {"v": torch.tensor(1.0)})
    with pytest.raises(OSError, match="disk full"):
        ac.wait_until_finished()
    with pytest.raises(OSError):
        h.result(5)
    ac.close()
    with pytest.raises(RuntimeError, match="closed"):
        ac.save(2, {"v": torch.tensor(2.0)})


def test_model_saver_rotation(tmp_path):
    p = str(tmp_path / "model.npz")
    saver = tckpt.ModelSaver(p)
    saver.save({"w": torch.ones(2)})
    time.sleep(0.002)
    saver.save({"w": torch.full((2,), 2.0)})
    tree, _ = saver.load(like={"w": torch.zeros(2)})
    assert torch.equal(tree["w"], torch.full((2,), 2.0))
    rotated = [f for f in os.listdir(tmp_path)
               if f.startswith("model.npz.") and f.endswith(".json")
               and not f.startswith("model.npz.json")]
    assert len(rotated) == 1
    old, _ = tckpt.load_pytree(str(tmp_path / rotated[0][:-5]))
    assert torch.equal(old["w"], torch.ones(2))


# -- MultiLayerNetwork across the packages ----------------------------------

def _mlp_conf(conf_cls, kind):
    return (conf_cls.builder()
            .n_in(4).lr(0.1).momentum(0.5).use_adagrad(False)
            .num_iterations(5).activation("tanh")
            .list(3).hidden_layer_sizes(8, 6)
            .override(2, kind=kind.OUTPUT, n_out=3, activation="softmax",
                      loss_function="mcxent", dropout=0.0)
            .pretrain(False).backward(True).build())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_model_load_model_across_packages(tmp_path, writer):
    x = np.random.default_rng(4).standard_normal((9, 4)).astype(np.float32)
    jnet = JNet(_mlp_conf(JConf, JLayerKind)).init(seed=3)
    tnet = TNet(_mlp_conf(TConf, TLayerKind), device="cpu").init(seed=3)
    tnet.set_params_flat(torch.from_numpy(np.array(jnet.params_flat())))
    path = str(tmp_path / "m")
    if writer == "jax":
        jckpt.save_model(path, jnet)
        loaded = tckpt.load_model(path, device="cpu")
        ref = np.asarray(jnet.output(jnp.asarray(x)))
        got = loaded.output(x).numpy()
    else:
        tckpt.save_model(path, tnet)
        loaded = jckpt.load_model(path)
        ref = tnet.output(x).numpy()
        got = np.asarray(loaded.output(jnp.asarray(x)))
    assert np.array_equal(np.asarray(loaded.params_flat()),
                          np.asarray(jnet.params_flat()))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


# -- the transformer TrainState carried across ------------------------------

def test_gpt_train_state_jax_to_port_and_back(tmp_path):
    """JAX trains 2 steps and saves its TrainState; the port restores it
    through ``load_numpy_tree`` + ``train_state_from_numpy``; each
    package takes one more step on the same batch."""
    cfg = dataclasses.replace(jgpt.gpt_tiny(), compute_dtype="float32")
    tcfg = dataclasses.replace(tgpt.gpt_tiny(), compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)) \
        .astype(np.int32)
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jinit, jstep = jgpt.make_train_step(cfg, mesh, attn_fn=jtfm.attention)
    jstate = jinit(jax.random.key(0))
    for i in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(ids), jax.random.key(i))
    path = str(tmp_path / "state.npz")
    jckpt.save_pytree(path, jstate, {"step": 2})

    tstate = ttfm.train_state_from_numpy(tckpt.load_numpy_tree(path),
                                         device="cpu")
    assert tstate.step == 2 and int(tstate.opt_state.count) == 2
    _, tstep = tgpt.make_train_step(tcfg, attn_fn=ttfm.attention,
                                    device="cpu")
    jstate, jloss = jstep(jstate, jnp.asarray(ids), jax.random.key(2))
    tstate, tloss = tstep(tstate, torch.from_numpy(ids))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=STATE_RTOL)

    back = ttfm.train_state_to_numpy(tstate)
    ref = jax.tree.map(np.asarray, jstate)
    got = dict(_leaves(back))
    want = dict((p, np.asarray(v)) for p, v in
                jckpt._flatten_with_paths(ref))
    assert list(got) == list(want)
    for p in want:
        assert got[p].dtype == want[p].dtype and \
            got[p].shape == want[p].shape, p
    assert got["step"] == want["step"] == 3
    assert got["opt_state/0/count"] == want["opt_state/0/count"] == 3
    # each group's global relative L2 (an element whose gradient is
    # rounding noise moves Adam's normalized update by a share of one
    # step, so no elementwise bar fits near-zero entries)
    for group in ("params/", "opt_state/0/mu/", "opt_state/0/nu/"):
        keys = [p for p in want if p.startswith(group)]
        num = np.sqrt(sum(float(np.sum((got[p].astype(np.float64)
                                        - want[p]) ** 2)) for p in keys))
        den = np.sqrt(sum(float(np.sum(want[p].astype(np.float64) ** 2))
                          for p in keys))
        assert num / den <= STATE_RTOL, (group, num / den)
    # and the port's file restores in JAX with its own state as template
    out = str(tmp_path / "back.npz")
    tckpt.save_pytree(out, back, {"step": 3})
    restored, _ = jckpt.load_pytree(out, like=jstate)
    assert int(restored.step) == 3 and int(restored.opt_state[0].count) == 3


# -- the port imports no JAX ---------------------------------------------------

def test_runtime_modules_import_no_jax():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.runtime.checkpoint\n"
            "import deeplearning4j_tpu_torch.runtime.metrics\n"
            "import deeplearning4j_tpu_torch.runtime.telemetry\n"
            "import deeplearning4j_tpu_torch.runtime.console\n"
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
