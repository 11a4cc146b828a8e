"""The port's ``model`` mesh axis against the JAX reference.

The contracts of the reference's ``tests/test_model_parallel.py`` (and
the data x model half of ``test_parallel_4d.py``), held on one spawned
group of four gloo CPU ranks laid out ``data=2 x model=2``
(``test_torch_mesh.run_ranks``).  One rank program (:func:`dm_rank`)
runs every case on every rank and returns what each test reads; the
tests compare with the JAX package on its 8-device CPU platform
(``tests/conftest.py``), run in this process on the same numpy params
and batches, and with the port's own ``mesh=None`` runs.

- ``CausalLM`` fp32 on ``data=2 x model=2`` against the reference's fit
  on its 2 x 2 mesh: rtol 1e-5, atol 1e-6.  The row-parallel products
  (``wo``, ``w2``) add their two partial sums over ``model``, in another
  order than one product over every head or ffn column, so the fits
  agree to rounding, not bit for bit; the four ranks gather the same
  params bit for bit;
- the bf16 fit's loss scale and a poisoned fit's skips (a non-finite
  weight in one model rank's slice) equal the reference's, and the
  mesh-wide guard turns one rank's verdict into every rank's;
- ``gpt`` / ``bert.make_train_step(mesh=)`` against the reference's
  steps on its 2 x 2 mesh, AdamW state sharded like the params;
- the ``MultiLayerNetwork`` fit on ``data x model`` equals ``mesh=None``
  and a poisoned batch skips on every rank;
- dropout masks equal across a model group, different across data
  shards;
- ``ResilientFit`` resume bit-exact on ``data x model``, and a
  checkpoint restored across ``data=2 x model=2``, ``data=4`` and
  ``mesh=None`` bit for bit;
- ``DecodeEngine(mesh=)`` greedy tokens against the reference's
  replicated engine, with half the KV bytes a slot per rank.

The module imports no JAX at its top, so the spawned ranks do not
either; the reference runs inside the tests.
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_mesh import dense_batches, dense_conf, run_ranks

torch.set_num_threads(2)

#: the reference test file's _cfg(): gpt_tiny at vocab 64, max_len 16
CFG_KW = dict(hidden=32, n_layers=2, n_heads=4, ffn_dim=64,
              compute_dtype="float32")
LR = 0.05
#: seconds the four ranks may take (about 17 s alone, most of it the
#: processes' start; the suite's other workers share the cores)
DEADLINE_S = 400.0


def _port_cfg(**kw):
    from deeplearning4j_tpu_torch.models import gpt
    return dataclasses.replace(gpt.gpt_tiny(vocab_size=64, max_len=16),
                               **{**CFG_KW, **kw})


def _ids(n=3, rows=8, seed=0, vocab=64, seq=16):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (rows, seq)).astype(np.int32)
            for _ in range(n)]


def _tensors(tree):
    from deeplearning4j_tpu_torch.ops.updaters import tree_map
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _numpy(tree):
    from deeplearning4j_tpu_torch.ops.updaters import tree_map
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(val, np.float32)
    return out


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------

def _lm(params_np, **kw):
    from deeplearning4j_tpu_torch.models import lm_fit
    lm = lm_fit.CausalLM(_port_cfg(), lr=LR, device="cpu", **kw)
    lm.params = _tensors(params_np)
    return lm


def _collectives(mesh):
    from deeplearning4j_tpu_torch.parallel import collectives as col
    from deeplearning4j_tpu_torch.parallel import sharded_fit
    g = torch.distributed.get_rank()
    x = torch.full((2,), float(g + 1))
    out = {
        "coords": dict(mesh.coords),
        "psum_model": col.psum(x, (mesh, "model")).numpy(),
        "psum_data": col.psum(x, (mesh, "data")).numpy(),
        "psum_mesh": col.psum(x, mesh).numpy(),
        "psum_world": col.psum(x, (mesh, ("data", "model"))).numpy(),
        "pmax_model": col.pmax(x, (mesh, "model")).numpy(),
        "gather_model": col.all_gather(x, (mesh, "model")).numpy(),
        "size_model": col.axis_size((mesh, "model")),
        "index_model": col.axis_index((mesh, "model")),
    }
    agree = sharded_fit.agree_over_mesh(mesh)
    out["agree_one_bad"] = bool(agree(torch.tensor(g != 3)))
    out["agree_all_ok"] = bool(agree(torch.tensor(True)))
    return out


def _lm_cases(mesh, p):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import lm_fit
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh

    data = [DataSet(x, x) for x in p["ids"]]
    out = {}
    lm = _lm(p["lm_params"])
    lm.fit_backprop(data, num_epochs=2, seed=3, mesh=mesh)
    out["fit"] = lm.params_flat().numpy()
    # the step's layout: this rank's slice of the params
    step, _ = lm._backprop_machinery(mesh)
    local = step.shard_state(_tensors(p["lm_params"]))
    out["local_bytes"] = tmesh.per_device_bytes(local, mesh)
    out["local_wq"] = tuple(local["blocks"]["wq"].shape)
    out["local_tok"] = tuple(local["embed"]["tok"].shape)
    out["total_bytes"] = lm.num_param_bytes()
    data4 = tmesh.make_mesh(tmesh.MeshSpec(data=4))
    out["sig_dm"] = tmesh.mesh_signature(mesh)
    out["sig_d4"] = tmesh.mesh_signature(data4)
    fresh = lm_fit.CausalLM(_port_cfg(), lr=LR, device="cpu")
    out["bundle_shared"] = fresh._backprop_machinery(mesh)[0] is step
    out["bundle_split"] = lm._backprop_machinery(data4)[0] is not step
    # bf16: the scale after a healthy fit, and a fit whose one model
    # rank's slice holds a non-finite weight
    lm = _lm(p["lm_params"], mixed_precision="bf16")
    lm.fit_backprop(data, num_epochs=2, seed=3, mesh=mesh)
    out["bf16_scale"] = float(lm.loss_scale["scale"])
    out["bf16_good"] = int(lm.loss_scale["good_steps"])
    out["bf16_skips"] = lm.guard_skips
    out["bf16_fit"] = lm.params_flat().numpy()
    poisoned = {**p["lm_params"]}
    poisoned["blocks"] = dict(poisoned["blocks"])
    w1 = poisoned["blocks"]["w1"].copy()
    w1[0, 0, -1] = np.inf            # the ffn column model rank 1 holds
    poisoned["blocks"]["w1"] = w1
    lm = _lm(poisoned, mixed_precision="bf16")
    lm.fit_backprop(data, num_epochs=2, seed=3, mesh=mesh)
    out["poison_scale"] = float(lm.loss_scale["scale"])
    out["poison_good"] = int(lm.loss_scale["good_steps"])
    out["poison_skips"] = lm.guard_skips
    out["poison_params"] = lm.params_flat().numpy()
    # dropout: one generator a data shard, the same masks a model group
    dcfg = _port_cfg(dropout=0.3)
    lm = lm_fit.CausalLM(dcfg, lr=LR, device="cpu")
    lm.params = _tensors(p["lm_params"])
    gen = torch.Generator().manual_seed(
        lm_fit.resilience.fold(3, mesh.rank))
    masks = lm_fit.tfm._dropout_masks(dcfg, torch.zeros(4, 16, 32), gen)
    out["mask_bits"] = np.packbits(masks[0].numpy())
    lm.fit_backprop(data, num_epochs=1, seed=3, mesh=mesh)
    # replicated leaves are not gathered: each rank's own copy
    out["dropout_ln"] = lm.params["blocks"]["ln1_g"].numpy()
    out["dropout_fit"] = lm.params_flat().numpy()
    return out


def _train_step_cases(mesh, p):
    from deeplearning4j_tpu_torch.models import bert, gpt
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import updaters

    out = {}
    for name, mod, cfg, lr, batch in (
            ("gpt", gpt, _port_cfg(), 3e-4,
             torch.from_numpy(p["ids"][0])),
            ("bert", bert, dataclasses.replace(
                bert.bert_tiny(vocab_size=64, max_len=16),
                compute_dtype="float32"), 1e-4,
             bert.Batch(*(torch.from_numpy(a) for a in p["bert_batch"])))):
        opt = updaters.adamw(lr, weight_decay=0.01)
        _, step = mod.make_train_step(cfg, mesh, optimizer=opt, device="cpu")
        params = tfm.shard_tree(_tensors(p[f"{name}_params"]), step.specs,
                                mesh)
        state = tfm.TrainState(params, opt.init(params), 0)
        losses = []
        for _ in range(2):
            state, loss = step(state, batch)
            losses.append(float(loss))
        out[name] = {
            "losses": losses,
            "params": _numpy(tfm.gather_tree(state.params, step.specs, mesh)),
            "mu": _numpy(tfm.gather_tree(state.opt_state.mu, step.specs,
                                         mesh)),
            "local_mu_wq": tuple(state.opt_state.mu["blocks"]["wq"].shape),
        }
    return out


def _dense_cases(mesh, p):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.params import params_from_numpy

    def net():
        return MultiLayerNetwork(dense_conf(tconf),
                                 params=params_from_numpy(p["dense"], "cpu"),
                                 device="cpu")

    out = {}
    n = net()
    n.fit_backprop([DataSet(x, y) for x, y in dense_batches()],
                   num_epochs=2, mesh=mesh)
    out["fit"] = n.params_flat().numpy()
    n = net()
    # row 20 of batch 2 lies in data shard 1's rows (32 rows over 2)
    n.fit_backprop([DataSet(x, y) for x, y in
                    dense_batches(poison={2}, poison_row=20)],
                   num_epochs=2, mesh=mesh)
    out["poison"] = n.params_flat().numpy()
    out["poison_skips"] = n.guard_skips
    return out


def _resilient_cases(mesh, p):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh
    from deeplearning4j_tpu_torch.runtime.resilience import (
        ResilienceConfig, ResilientFit)

    root = p["dir"]
    lead = torch.distributed.get_rank() == 0
    data = [DataSet(x, x) for x in _ids(4)]
    data4 = tmesh.make_mesh(tmesh.MeshSpec(data=4))

    def fit(where, m, **kw):
        lm = _lm(p["lm_params"], momentum=0.9)
        ResilientFit(lm, ResilienceConfig(
            checkpoint_dir=os.path.join(root, where), checkpoint_every=3,
            shuffle=False, **kw), mesh=m).fit(data, num_epochs=2, seed=4)
        return lm.params_flat().numpy()

    out = {"dir": root, "whole": fit("a", mesh)}
    fit("b", mesh, max_steps=5)
    out["resumed"] = fit("b", mesh, resume=True)
    # a snapshot written on data=2 x model=2, read on data=4 and back
    fit("x", mesh, max_steps=3)
    out["x_at_3"] = fit("x", mesh, resume=True, max_steps=0)
    if lead:
        shutil.copytree(os.path.join(root, "x"), os.path.join(root, "x4"))
    torch.distributed.barrier()
    out["x4_at_3"] = fit("x4", data4, resume=True, max_steps=0)
    out["x4_rest"] = fit("x4", data4, resume=True)
    out["d4_whole"] = fit("d4", data4)
    # and one written on data=4, read on data=2 x model=2
    fit("y", data4, max_steps=3)
    out["y_at_3"] = fit("y", data4, resume=True, max_steps=0)
    if lead:
        shutil.copytree(os.path.join(root, "y"), os.path.join(root, "ydm"))
    torch.distributed.barrier()
    out["ydm_at_3"] = fit("ydm", mesh, resume=True, max_steps=0)
    return out


def _decode_cases(mesh, p):
    from deeplearning4j_tpu_torch.models import gpt
    from deeplearning4j_tpu_torch.serving.decode import (ContinuousBatcher,
                                                         DecodeEngine)

    cfg = dataclasses.replace(gpt.gpt_tiny(vocab_size=64, max_len=32),
                              compute_dtype="float32")
    params = _tensors(p["dec_params"])
    out = {}
    for paged in (False, True):
        eng = DecodeEngine(cfg, params, n_slots=2, buckets=(16,),
                           prefill_chunk=4, mesh=mesh, paged=paged,
                           device="cpu")
        toks = []
        for prompt in p["prompts"]:
            toks.append(_greedy(eng, prompt, 8))
        out[f"tokens_paged={paged}"] = toks
        if not paged:
            out["kv_bytes_per_slot"] = eng.kv_bytes_per_slot
            slots = eng._state(eng._buckets[16])[0]
            out["slot_k"] = tuple(slots.k.shape)
            out["served_wq"] = tuple(
                eng.current_params()["blocks"]["wq"].shape)
            out["coords"] = dict(mesh.coords)
            # the batcher over the group: model rank 0 leads, rank 1
            # follows; closed before any other engine of this mesh runs
            b = ContinuousBatcher(eng)
            out["batcher"] = (b.generate(p["prompts"][0], max_tokens=8,
                                         seed=7).tolist()
                              if b.leads else "follows")
            b.close()
        else:
            out["pool_bytes"] = eng.pool_bytes
    replicated = DecodeEngine(cfg, params, n_slots=2, buckets=(16,),
                              prefill_chunk=4, device="cpu")
    out["kv_bytes_replicated"] = replicated.kv_bytes_per_slot
    out["tokens_replicated"] = [_greedy(replicated, q, 8)
                                for q in p["prompts"]]
    return out


def _greedy(eng, prompt, n):
    bucket, slot, first = eng.start(np.asarray(prompt, np.int32),
                                    max_tokens=n, temperature=0.0, seed=7)
    toks = [int(first)]
    while len(toks) < n:
        toks.append(int(eng.advance(bucket)[slot]))
    eng.release(bucket, slot)
    return toks


def dm_rank(_data_mesh, p):
    """Every case on this rank of a ``data=2 x model=2`` mesh."""
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh
    mesh = tmesh.make_mesh(tmesh.MeshSpec(data=2, model=2))
    return {"mesh": repr(mesh), "collectives": _collectives(mesh),
            "lm": _lm_cases(mesh, p), "steps": _train_step_cases(mesh, p),
            "dense": _dense_cases(mesh, p),
            "resilient": _resilient_cases(mesh, p),
            "decode": _decode_cases(mesh, p)}


# ---------------------------------------------------------------------------
# the reference side and the fixture
# ---------------------------------------------------------------------------

def _jax_cfg(**kw):
    from deeplearning4j_tpu.models import gpt as jgpt
    return dataclasses.replace(jgpt.gpt_tiny(vocab_size=64, max_len=16),
                               **{**CFG_KW, **kw})


def _jmesh(data, model):
    import jax
    from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh
    return make_mesh(MeshSpec(data=data, model=model),
                     devices=jax.devices()[:data * model])


def _bert_batch():
    rng = np.random.default_rng(0)
    labels = rng.integers(5, 64, (8, 16)).astype(np.int32)
    mlm = (rng.random((8, 16)) < 0.3).astype(np.float32)
    ids = np.where(mlm > 0, 3, labels).astype(np.int32)
    mask = np.ones((8, 16), np.float32)
    mask[1, 11:] = 0
    types = np.zeros((8, 16), np.int32)
    types[:, 8:] = 1
    return ids, mask, types, labels, mlm


@pytest.fixture(scope="module")
def payload():
    import jax
    from deeplearning4j_tpu.models import bert as jbert
    from deeplearning4j_tpu.models import gpt as jgpt
    from deeplearning4j_tpu.nn.conf import configuration as jconf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from test_torch_decode import numpy_params

    def np_tree(t):
        return jax.tree.map(lambda a: np.array(a), t)

    dec_cfg = dataclasses.replace(jgpt.gpt_tiny(vocab_size=64, max_len=32),
                                  compute_dtype="float32")
    bcfg = dataclasses.replace(jbert.bert_tiny(vocab_size=64, max_len=16),
                               compute_dtype="float32")
    return {
        "lm_params": np_tree(jgpt.init_params(jax.random.key(1),
                                              _jax_cfg())),
        "gpt_params": np_tree(jgpt.init_params(jax.random.key(0),
                                               _jax_cfg())),
        "bert_params": np_tree(jbert.init_params(jax.random.key(0), bcfg)),
        "bert_batch": _bert_batch(),
        "ids": _ids(),
        "dense": np_tree(JNet(dense_conf(jconf)).init(seed=1).params),
        "dec_params": numpy_params(dec_cfg),
        "prompts": [[5, 9, 2, 7, 11], [1, 2, 3], [60, 61, 62, 63, 0, 1, 2]],
    }


@pytest.fixture(scope="module")
def ranks(payload, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_parallel")
    payload = {**payload, "dir": str(tmp / "ckpt")}
    return run_ranks(dm_rank, 4, tmp, payload, deadline=DEADLINE_S)


def _jfit(payload, mesh, mp="off", params=None):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.models import lm_fit as jlm
    import jax.numpy as jnp
    lm = jlm.CausalLM(_jax_cfg(), lr=LR, mixed_precision=mp)
    lm.params = jax_tree(params if params is not None
                         else payload["lm_params"])
    lm.fit_backprop([JDataSet(jnp.asarray(x), jnp.asarray(x))
                     for x in payload["ids"]], num_epochs=2, seed=3,
                    mesh=mesh)
    return lm


def jax_tree(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# tests: the mesh and its collectives
# ---------------------------------------------------------------------------

def test_ranks_lay_out_data_major(ranks):
    """Rank g of data=2 x model=2 sits at data g // 2, model g % 2 (the
    reference's make_mesh device order)."""
    for g, r in enumerate(ranks):
        assert r["collectives"]["coords"] == {"data": g // 2,
                                              "model": g % 2}
        assert "data=2, model=2" in r["mesh"]


def test_collectives_over_named_axes(ranks):
    for g, r in enumerate(ranks):
        c = r["collectives"]
        d, m = divmod(g, 2)
        model_peers = [2 * d + 1, 2 * d + 2]          # ranks + 1
        data_peers = [m + 1, 2 + m + 1]
        np.testing.assert_array_equal(c["psum_model"], [sum(model_peers)] * 2)
        np.testing.assert_array_equal(c["psum_data"], [sum(data_peers)] * 2)
        np.testing.assert_array_equal(c["psum_mesh"], c["psum_data"])
        np.testing.assert_array_equal(c["psum_world"], [10.0, 10.0])
        np.testing.assert_array_equal(c["pmax_model"], [max(model_peers)] * 2)
        np.testing.assert_array_equal(
            c["gather_model"], np.repeat(model_peers, 2).astype(np.float32))
        assert c["size_model"] == 2 and c["index_model"] == m


def test_guard_verdict_is_reduced_over_the_whole_mesh(ranks):
    """One rank's non-finite verdict skips every rank of both axes."""
    for r in ranks:
        assert r["collectives"]["agree_one_bad"] is False
        assert r["collectives"]["agree_all_ok"] is True


def test_mesh_signature_distinguishes_model_degree(ranks):
    for r in ranks:
        lm = r["lm"]
        assert lm["sig_dm"] != lm["sig_d4"]
        assert lm["bundle_shared"] and lm["bundle_split"]


# ---------------------------------------------------------------------------
# tests: CausalLM on data x model
# ---------------------------------------------------------------------------

def test_data_model_fit_matches_reference(ranks, payload):
    """rtol 1e-5, atol 1e-6 against the reference's 2 x 2 fit: the
    row-parallel partial sums add over ``model`` in another order."""
    want = _jfit(payload, _jmesh(2, 2)).params_flat()
    for r in ranks:
        np.testing.assert_allclose(r["lm"]["fit"], want, rtol=1e-5,
                                   atol=1e-6)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["lm"]["fit"], ranks[0]["lm"]["fit"])


def test_data_model_fit_matches_the_ports_single_device_fit(ranks, payload):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    lm = _lm(payload["lm_params"])
    lm.fit_backprop([DataSet(x, x) for x in payload["ids"]], num_epochs=2,
                    seed=3)
    np.testing.assert_allclose(ranks[0]["lm"]["fit"],
                               lm.params_flat().numpy(), rtol=1e-5,
                               atol=1e-6)


def test_params_laid_out_over_model(ranks):
    """Each rank holds half the heads, half the ffn and (64 % 2 == 0)
    half the vocabulary: well under the replicated bytes."""
    for r in ranks:
        lm = r["lm"]
        assert lm["local_wq"] == (2, 32, 2, 8)
        assert lm["local_tok"] == (32, 32)
        assert sorted(lm["local_bytes"]) == [0, 1, 2, 3]
        assert max(lm["local_bytes"].values()) < 0.6 * lm["total_bytes"]


def _jscale(skips: int, steps: int = 6):
    """The reference's loss scale after ``steps`` guarded steps of which
    ``skips`` (all or none) skipped: its own transition function."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import sharded_fit as jsf
    assert skips in (0, steps)
    ls = jsf.init_loss_scale()
    for _ in range(steps):
        ls = jsf.next_loss_scale(ls, jnp.int32(1 if skips else 0))
    return float(ls["scale"]), int(ls["good_steps"])


def test_loss_scale_rides_the_data_model_step(ranks, payload):
    """A healthy bf16 fit: no skips, the scale and its good-step count
    the reference's; the fit stays near the reference's."""
    want = _jfit(payload, _jmesh(2, 2), "bf16")
    for r in ranks:
        lm = r["lm"]
        assert lm["bf16_skips"] == want.guard_skips == 0
        assert (lm["bf16_scale"], lm["bf16_good"]) \
            == _jscale(want.guard_skips) == (2.0 ** 15, 6)
        got = lm["bf16_fit"]
        assert np.isfinite(got).all()
        ref = want.params_flat()
        assert np.linalg.norm(got - ref) <= 5e-2 * np.linalg.norm(ref)


def test_poisoned_model_shard_skips_every_rank_as_the_reference(ranks,
                                                                payload):
    """A non-finite weight in model rank 1's slice of ``w1``: every step
    skips on all four ranks, the scale halves six times, as the
    reference's."""
    poisoned = {**payload["lm_params"]}
    poisoned["blocks"] = dict(poisoned["blocks"])
    w1 = poisoned["blocks"]["w1"].copy()
    w1[0, 0, -1] = np.inf
    poisoned["blocks"]["w1"] = w1
    want = _jfit(payload, _jmesh(2, 2), "bf16", params=poisoned)
    start = np.concatenate([np.ravel(np.asarray(a, np.float32)) for a in
                            _flat_leaves(poisoned)])
    for r in ranks:
        lm = r["lm"]
        assert lm["poison_skips"] == want.guard_skips == 6
        assert (lm["poison_scale"], lm["poison_good"]) \
            == _jscale(want.guard_skips) == (2.0 ** 15 / 2 ** 6, 0)
        np.testing.assert_array_equal(lm["poison_params"], start)


def _flat_leaves(tree):
    return [tree[k] for k in sorted(tree) if not isinstance(tree[k], dict)] \
        + [leaf for k in sorted(tree) if isinstance(tree[k], dict)
           for leaf in _flat_leaves(tree[k])]


def test_dropout_masks_equal_across_a_model_group(ranks):
    """Model ranks share their data shard's dropout stream (the replicated
    activations stay replicated); data shards draw their own."""
    for d in (0, 1):
        a, b = ranks[2 * d]["lm"], ranks[2 * d + 1]["lm"]
        np.testing.assert_array_equal(a["mask_bits"], b["mask_bits"])
        np.testing.assert_array_equal(a["dropout_ln"], b["dropout_ln"])
    assert not np.array_equal(ranks[0]["lm"]["mask_bits"],
                              ranks[2]["lm"]["mask_bits"])
    for r in ranks:
        assert np.isfinite(r["lm"]["dropout_fit"]).all()
        np.testing.assert_array_equal(r["lm"]["dropout_fit"],
                                      ranks[0]["lm"]["dropout_fit"])


# ---------------------------------------------------------------------------
# tests: make_train_step(mesh=)
# ---------------------------------------------------------------------------

def _jstep(payload, name):
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.models import bert as jbert
    from deeplearning4j_tpu.models import gpt as jgpt
    from deeplearning4j_tpu.models import transformer as jtfm

    mesh = _jmesh(2, 2)
    if name == "gpt":
        mod, cfg = jgpt, _jax_cfg()
        batch = jnp.asarray(payload["ids"][0])
    else:
        mod = jbert
        cfg = dataclasses.replace(jbert.bert_tiny(vocab_size=64, max_len=16),
                                  compute_dtype="float32")
        batch = jbert.Batch(*(jnp.asarray(a) for a in payload["bert_batch"]))
    init, step = mod.make_train_step(cfg, mesh, attn_fn=jtfm.attention)
    state = init(jax.random.key(0))
    losses = []
    for i in range(2):
        state, loss = step(state, batch, jax.random.key(i))
        losses.append(float(loss))
    return state, losses


@pytest.mark.parametrize("name", ["gpt", "bert"])
def test_make_train_step_on_data_model_matches_reference(ranks, payload,
                                                         name):
    """Two AdamW steps on the 2 x 2 mesh from the reference's initial
    params: the losses at rtol 1e-5, the params at atol 1e-6, the
    gathered first moments within 1e-4 in relative L2 (``bk``'s
    gradient is zero up to rounding: its moments are noise of 1e-13);
    every rank the same."""
    state, losses = _jstep(payload, name)
    want = _flat(jax_np(state.params))
    mu = _flat(jax_np(state.opt_state[0].mu))
    for r in ranks:
        got = r["steps"][name]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        flat = _flat(got["params"])
        assert flat.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(flat[k], want[k], atol=1e-6,
                                       err_msg=k)
        gmu = _flat(got["mu"])
        a = np.concatenate([gmu[k].ravel() for k in sorted(mu)])
        b = np.concatenate([mu[k].ravel() for k in sorted(mu)])
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
        assert got["local_mu_wq"][2] == 2        # the moments are sharded


def jax_np(tree):
    import jax
    return jax.tree.map(lambda a: np.asarray(a), tree)


# ---------------------------------------------------------------------------
# tests: the MultiLayerNetwork fit
# ---------------------------------------------------------------------------

def test_multilayer_fit_on_data_model_mesh(ranks, payload):
    """Weights replicated over ``model``: every rank equals the port's
    single-device fit, and a poisoned batch skips its step twice (two
    epochs) on every rank of both axes."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.params import params_from_numpy

    single = MultiLayerNetwork(dense_conf(tconf),
                               params=params_from_numpy(payload["dense"],
                                                        "cpu"),
                               device="cpu")
    single.fit_backprop([DataSet(x, y) for x, y in dense_batches()],
                        num_epochs=2, mesh=None)
    want = single.params_flat().numpy()
    for r in ranks:
        np.testing.assert_allclose(r["dense"]["fit"], want, rtol=1e-5,
                                   atol=1e-6)
        assert r["dense"]["poison_skips"] == 2
        assert np.isfinite(r["dense"]["poison"]).all()
        np.testing.assert_array_equal(r["dense"]["poison"],
                                      ranks[0]["dense"]["poison"])


# ---------------------------------------------------------------------------
# tests: resume
# ---------------------------------------------------------------------------

def test_resilient_fit_data_model_resume_bit_exact(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["resilient"]["resumed"],
                                      r["resilient"]["whole"])


@pytest.mark.parametrize("written,read", [("x_at_3", "x4_at_3"),
                                          ("y_at_3", "ydm_at_3")],
                         ids=["data2xmodel2-to-data4",
                              "data4-to-data2xmodel2"])
def test_checkpoint_crosses_mesh_shapes_bit_exact(ranks, written, read):
    """A snapshot is the gathered global tree: read on another mesh
    shape it is the same params, bit for bit."""
    for r in ranks:
        np.testing.assert_array_equal(r["resilient"][read],
                                      r["resilient"][written])


def test_resume_on_another_shape_continues_the_run(ranks):
    """Three steps on data=2 x model=2, the rest on data=4: close to a
    whole data=4 run (the first steps' sums took another order)."""
    for r in ranks:
        np.testing.assert_allclose(r["resilient"]["x4_rest"],
                                   r["resilient"]["d4_whole"], rtol=1e-5,
                                   atol=1e-6)


def test_checkpoint_resumes_without_a_mesh(ranks, tmp_path, payload):
    """The data=2 x model=2 snapshot restores on mesh=None, bit for bit
    (the npz keys a mesh=None run writes)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.runtime.resilience import (
        ResilienceConfig, ResilientFit)
    dst = tmp_path / "x"
    shutil.copytree(os.path.join(ranks[0]["resilient"]["dir"], "x"), dst)
    lm = _lm(payload["lm_params"], momentum=0.9)
    ResilientFit(lm, ResilienceConfig(
        checkpoint_dir=str(dst), checkpoint_every=3, shuffle=False,
        resume=True, max_steps=0)).fit([DataSet(x, x) for x in _ids(4)],
                                       num_epochs=2, seed=4)
    np.testing.assert_array_equal(lm.params_flat().numpy(),
                                  ranks[0]["resilient"]["x_at_3"])


# ---------------------------------------------------------------------------
# tests: the model-sharded decode engine
# ---------------------------------------------------------------------------

def _jax_tokens(payload, prompt, n=8):
    from deeplearning4j_tpu.models import gpt as jgpt
    from deeplearning4j_tpu.serving.decode import DecodeEngine as JEngine
    cfg = dataclasses.replace(jgpt.gpt_tiny(vocab_size=64, max_len=32),
                              compute_dtype="float32")
    eng = JEngine(cfg, jax_tree(payload["dec_params"]), n_slots=2,
                  buckets=(16,), prefill_chunk=4)
    return _greedy(eng, prompt, n)


@pytest.mark.parametrize("paged", [False, True], ids=["pinned", "paged"])
def test_decode_engine_model_sharded_parity(ranks, payload, paged):
    """Greedy tokens of the head-sharded engine equal the reference's
    replicated engine's, on every rank."""
    want = [_jax_tokens(payload, q) for q in payload["prompts"]]
    for r in ranks:
        assert r["decode"][f"tokens_paged={paged}"] == want
        assert r["decode"]["tokens_replicated"] == want


def test_decode_engine_shards_params_and_kv_over_heads(ranks):
    for r in ranks:
        d = r["decode"]
        assert d["kv_bytes_per_slot"] * 2 == d["kv_bytes_replicated"]
        assert d["slot_k"][3] == 2 and d["served_wq"][2] == 2
        # a batcher over the group serves (model rank 0 leads)
        want = d["tokens_replicated"][0] if d["coords"]["model"] == 0 \
            else "follows"
        assert d["batcher"] == want
