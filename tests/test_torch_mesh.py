"""The port's mesh and collectives against the JAX reference, and the
multi-process harness the data-parallel tests share.

``parallel/mesh.py``: ``MeshSpec.resolve``, ``pad_rows``,
``local_batch_size``, ``padded_global_batch`` and ``mesh_signature`` on
the same inputs as the reference's (on its 8-device CPU mesh; the
port's shape helpers read only ``mesh.shape``, so a ``Mesh`` of 8 ranks
is built without a group), exactly equal; every axis of the reference's
``MeshSpec`` is accepted (the model axis has a file of its own,
``test_torch_model_parallel.py``; the pipe and seq axes
``test_torch_pipeline.py`` and ``test_torch_ring_attention.py``), and
the row-major layout of ranks and groups over ``(data, model, pipe,
seq, expert)`` is the reference's.  ``parallel/collectives.py``: every
collective on a real 2-rank gloo group against numpy, exactly (sums of
two fp32 values), ``psum``'s backward, and ``ring_permute``'s values,
gradient and booked bytes against JAX's ``ppermute``.

The harness (:func:`run_ranks`) starts a gloo group of ``world`` CPU
processes with ``multiprocessing``'s spawn, a ``file://`` rendezvous in
the test's ``tmp_path`` and one torch thread a rank; each rank runs a
rank program of this module (the module imports no JAX, so a rank does
not either) and pickles its result.  Every rank is joined with a
deadline (:data:`DEADLINE_S`); on expiry all are killed and the test
fails.  The rank programs of ``test_torch_dp_fit.py``,
``test_torch_data_parallel.py`` and ``test_torch_lm_fit.py`` live here
too, with the data both sides use.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.parallel import collectives as tcol
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import sharded_fit as tsf

torch.set_num_threads(2)

#: seconds a spawned group may take before it is killed
DEADLINE_S = 60.0


# ---------------------------------------------------------------------------
# the multi-process harness
# ---------------------------------------------------------------------------

def _rank_entry(rank: int, world: int, rdv: str, fn, args, out: str):
    torch.set_num_threads(1)
    try:
        tmesh.initialize_distributed(f"file://{rdv}", world, rank,
                                     device="cpu")
        try:
            result = fn(tmesh.make_mesh(), *args)
        finally:
            torch.distributed.destroy_process_group()
        payload = ("ok", result)
    except BaseException:  # noqa: BLE001 — reported to the parent
        payload = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def run_ranks(fn, world: int, tmp_path, *args, deadline: float = DEADLINE_S,
              dies=()):
    """``fn(mesh, *args)`` on each rank of a fresh ``world``-rank gloo
    group, killed after ``deadline`` seconds; the list of their results,
    by rank.  A rank of ``dies`` must end killed by SIGKILL (its result
    is None); any other rank that dies fails the test."""
    ctx = multiprocessing.get_context("spawn")
    rdv = str(tmp_path / f"rdv-{fn.__name__}")
    outs = [str(tmp_path / f"{fn.__name__}-rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, rdv, fn, args, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    if hung:
        pytest.fail(f"ranks {hung} of {fn.__name__} still running after "
                    f"{deadline} s: killed")
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        if r in dies:
            if p.exitcode != -9:
                pytest.fail(f"rank {r} of {fn.__name__} was to be killed, "
                            f"but exited with {p.exitcode}")
            results.append(None)
            continue
        if not os.path.exists(out):
            pytest.fail(f"rank {r} of {fn.__name__} exited with "
                        f"{p.exitcode} and no result")
        with open(out, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            pytest.fail(f"rank {r} of {fn.__name__} failed:\n{value}")
        results.append(value)
    return results


# ---------------------------------------------------------------------------
# data and confs both packages build (pkg: either package's module)
# ---------------------------------------------------------------------------

def dense_conf(conf_mod, accum: int = 1, mp: str = "off", bn: bool = False):
    """The reference tests/test_dp_fit.py's ``_conf`` (and ``_bn_conf``
    with ``bn``) at fp32 compute."""
    b = (conf_mod.NeuralNetConfiguration.builder()
         .n_in(4).lr(0.1).momentum(0.5).use_adagrad(False).dropout(0.0)
         .num_iterations(1).activation("tanh").compute_dtype("float32"))
    K = conf_mod.LayerKind
    if bn:
        lb = (b.list(4).hidden_layer_sizes(8, 8, 6)
              .override(1, kind=K.BATCH_NORM)
              .override(3, kind=K.OUTPUT, n_out=3, activation="softmax",
                        loss_function="mcxent"))
    else:
        lb = (b.list(3).hidden_layer_sizes(8, 6)
              .override(2, kind=K.OUTPUT, n_out=3, activation="softmax",
                        loss_function="mcxent", dropout=0.0))
    lb = lb.pretrain(False).backward(True).grad_accum(accum)
    if mp != "off":
        lb = lb.mixed_precision(mp)
    return lb.build()


def dense_batches(n: int = 4, rows: int = 32, seed: int = 0, poison=(),
                  poison_row: int = 0):
    """``[(x [rows, 4] fp32, y [rows, 3] one-hot)]``; batch ``b`` in
    ``poison`` has a NaN at ``x[poison_row, 0]``."""
    rng = np.random.RandomState(seed)
    out = []
    for b in range(n):
        x = rng.randn(rows, 4).astype(np.float32)
        if b in poison:
            x[poison_row, 0] = np.nan
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, rows)]
        out.append((x, y))
    return out


def lm_ids(vocab: int, n: int = 3, rows: int = 8, seq: int = 32,
           seed: int = 0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (rows, seq)).astype(np.int32)
            for _ in range(n)]


def softmax_loss(params, x, y, gen):
    """The reference tests/test_parallel.py's ``_softmax_loss``."""
    logp = torch.log_softmax(x @ params["W"] + params["b"], dim=-1)
    return -torch.mean(torch.sum(y * logp, dim=-1))


def iris_batches(n_batches: int, batch: int):
    """The reference test_parallel.py's ``_iris_batches`` (numpy), from
    the port's Iris fetcher (the same synthetic rows as the
    reference's)."""
    from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataFetcher
    f = IrisDataFetcher()
    f.fetch(150)
    data = f.next().normalize_zero_mean_unit_variance()
    feats = np.asarray(data.features, np.float32)
    labels = np.asarray(data.labels, np.float32)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n_batches):
        idx = rng.integers(0, 150, size=batch)
        out.append((feats[idx], labels[idx]))
    return out, (feats, labels)


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------

def collectives_rank(mesh):
    r = mesh.rank
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4) + 10 * r
    out = {
        "rank": tcol.axis_index(mesh),
        "size": tcol.axis_size("data"),
        "psum": tcol.psum(x, mesh).numpy(),
        "pmean": tcol.pmean({"a": x}, "data")["a"].numpy(),
        "grad_share": tcol.grad_share([x], mesh)[0].numpy(),
        "all_gather": tcol.all_gather(x, mesh).numpy(),
        "all_gather_stacked": tcol.all_gather(x, mesh, tiled=False).numpy(),
        "reduce_scatter": tcol.reduce_scatter(x, mesh).numpy(),
        "ring": tcol.ring_permute(x, mesh).numpy(),
        "all_to_all": tcol.all_to_all(x, mesh, split_axis=1,
                                      concat_axis=0).numpy(),
    }
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    y = tcol.psum(w * (r + 1), mesh)
    (g,) = torch.autograd.grad((y * y).sum(), [w])
    out["psum_grad"] = g.numpy()
    out["signature"] = tmesh.mesh_signature(mesh)
    return out


def ring_permute_rank(mesh, xs, ws, shift):
    """``ring_permute`` of this rank's block over the data axis: the
    value, the gradient of ``sum(out * w)`` and the booked calls and
    bytes of the forward and of the backward."""
    r = mesh.rank
    x = torch.from_numpy(xs[r].copy()).requires_grad_(True)
    tcol.stats.reset()
    y = tcol.ring_permute(x, mesh, shift)
    fwd = dict(tcol.stats.snapshot()["by_kind"]["ring_permute"])
    (g,) = torch.autograd.grad((y * torch.from_numpy(ws[r])).sum(), [x])
    both = tcol.stats.snapshot()["by_kind"]["ring_permute"]
    return y.detach().numpy(), g.numpy(), fwd, both


def dp_fit_rank(mesh, p0, p0_bn):
    """The data-parallel MultiLayerNetwork fits of test_torch_dp_fit.py
    on this rank: the plain fit, the ragged batch-norm fit, a fit whose
    poisoned row lies in rank 1's rows, and ``fit_iterator``."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.params import params_from_numpy
    from deeplearning4j_tpu_torch.runtime.metrics import dp_metrics

    def net(p, **kw):
        return MultiLayerNetwork(dense_conf(tconf, **kw),
                                 params=params_from_numpy(p, "cpu"),
                                 device="cpu")

    def ds(bs):
        return [DataSet(x, y) for x, y in bs]

    out = {}
    dp_metrics.reset()
    n = net(p0)
    n.fit_backprop(ds(dense_batches()), num_epochs=2, mesh=mesh)
    out["plain"] = n.params_flat().numpy()
    out["metrics"] = dp_metrics.snapshot()
    auto = net(p0)
    auto.fit_backprop(ds(dense_batches()), num_epochs=2)   # mesh="auto"
    out["auto"] = auto.params_flat().numpy()
    n = net(p0_bn, bn=True)
    n.fit_backprop(ds(dense_batches(2, rows=21)), num_epochs=2, mesh=mesh)
    out["bn"] = n.params_flat().numpy()
    n = net(p0)
    n.fit_backprop(ds(dense_batches(4, poison={2}, poison_row=20)),
                   num_epochs=2, mesh=mesh)
    out["poison"] = n.params_flat().numpy()
    out["poison_skips"] = n.guard_skips
    n = net(p0)
    n.fit_iterator(ListDataSetIterator(ds(dense_batches()), batch_size=32),
                   num_epochs=2, mesh=mesh)
    out["iterator"] = n.params_flat().numpy()
    return out


def data_parallel_rank(mesh, w0):
    """DataParallelTrainer and ParameterAveragingTrainer on this rank
    (the reference tests/test_parallel.py:59-112 cases)."""
    from deeplearning4j_tpu_torch.ops.updaters import dl4j_updater
    from deeplearning4j_tpu_torch.parallel import (DataParallelTrainer,
                                                   ParameterAveragingTrainer)

    def p0():
        return {"W": torch.from_numpy(w0.copy()), "b": torch.zeros(3)}

    def acc(p, data):
        feats, labels = data
        pred = (torch.from_numpy(feats) @ p["W"] + p["b"]).argmax(-1)
        return float((pred.numpy() == labels.argmax(-1)).mean())

    out = {}
    tr = DataParallelTrainer(
        softmax_loss, dl4j_updater(lr=0.5, momentum=0.9, use_adagrad=False),
        mesh)
    bs, data = iris_batches(30, 80)
    out["sharing_acc"] = acc(tr.fit(p0(), bs, 0), data)
    upd = dl4j_updater(lr=0.1, momentum=0.0, use_adagrad=False)
    tr = DataParallelTrainer(softmax_loss, upd, mesh)
    (x, y), = iris_batches(1, 80)[0]
    p, _, score, skipped = tr.step(p0(), tr.init_state(p0()), x, y, 3, 0)
    out["step"] = {k: v.numpy() for k, v in p.items()}
    out["step_score"] = float(score)
    small, _ = iris_batches(4, 80)
    tr = DataParallelTrainer(
        softmax_loss, dl4j_updater(lr=0.3, momentum=0.0, use_adagrad=False),
        mesh)
    out["scan"] = {k: v.numpy() for k, v in tr.fit(p0(), small, 5).items()}
    out["loop"] = {k: v.numpy() for k, v in
                   tr.fit(p0(), small, 5, scan=False).items()}
    for name, steps, each, n_b in (("avg_rounds", 5, True, 12),
                                   ("avg_once", 10, False, 6)):
        pa = ParameterAveragingTrainer(
            softmax_loss, dl4j_updater(lr=0.5, momentum=0.0,
                                       use_adagrad=False),
            mesh, local_steps=steps, average_each_round=each)
        trained = pa.fit(p0(), iris_batches(n_b, 80)[0], 1)
        out[name] = {k: v.numpy() for k, v in trained.items()}
        out[name + "_acc"] = acc(trained, data)
    return out


def lm_fit_rank(mesh, params_np, ids):
    """A 2-rank CausalLM GPT fit (fp32, momentum) from carried params."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import gpt, lm_fit
    from deeplearning4j_tpu_torch.ops.updaters import tree_map

    cfg = dataclasses.replace(gpt.gpt_tiny(), compute_dtype="float32")
    lm = lm_fit.CausalLM(cfg, lr=0.05, momentum=0.9, device="cpu")
    lm.params = tree_map(torch.from_numpy, params_np)
    lm.fit_backprop([DataSet(x, x) for x in ids], num_epochs=2, mesh=mesh)
    return lm.params_flat().numpy()


#: the tiny GPT and BERT configs of the pipe and seq axes' tests (both
#: packages build them from these fields)
AXES_LM = dict(hidden=32, n_layers=2, n_heads=4, ffn_dim=64,
               compute_dtype="float32")
AXES_BERT = dict(vocab_size=128, max_len=32, hidden=32, n_layers=2,
                 n_heads=4, ffn_dim=64, dropout=0.0, compute_dtype="float32")


def axes_lm_cfg(**kw):
    from deeplearning4j_tpu_torch.models import gpt
    return dataclasses.replace(gpt.gpt_tiny(vocab_size=64, max_len=16),
                               **dict(AXES_LM, **kw))


def axes_bert_cfg(**kw):
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(**dict(AXES_BERT, **kw))


def seq_block(x, n, r):
    """Rank ``r``'s block of ``n`` along axis 1."""
    t = x.shape[1] // n
    return x[:, r * t:(r + 1) * t]


def ring_rank(mesh0, inputs, causal, kind):
    """test_torch_ring_attention.py: this rank's block of the ring's (or
    Ulysses') output and of the q/k/v gradients of ``sum(out * w)``, for
    each block form, on a ``seq`` mesh of every rank."""
    from deeplearning4j_tpu_torch.parallel import ring_attention as ra

    q, k, v, mask, w = inputs
    n = torch.distributed.get_world_size()
    mesh = tmesh.make_mesh(tmesh.MeshSpec(data=1, seq=n))
    r = mesh.seq_rank
    out = {}
    for block in ("plain", "flash"):
        ts = [torch.from_numpy(seq_block(a, n, r).copy()).requires_grad_(True)
              for a in (q, k, v)]
        fn = ra.ring_attention if kind == "ring" else ra.ulysses_attention
        o = fn(*ts, torch.from_numpy(seq_block(mask, n, r).copy()), causal,
               (mesh, "seq"), block=block)
        grads = torch.autograd.grad(
            (o * torch.from_numpy(seq_block(w, n, r).copy())).sum(), ts)
        out[block] = (o.detach().numpy(), [g.numpy() for g in grads])
    return out


def lm_axes_rank(mesh0, spec, params_np, ids, pipe_microbatches=1,
                 moe=None, n_layers=2):
    """A CausalLM fit (fp32, SGD 0.05 with momentum 0.9, 2 epochs) on a
    mesh of ``spec`` from carried params: the dense tiny GPT of
    ``n_layers``, or with ``moe`` (config fields) the MoE family."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import lm_fit
    from deeplearning4j_tpu_torch.models.moe import MoETransformerConfig
    from deeplearning4j_tpu_torch.ops.updaters import tree_map

    mesh = tmesh.make_mesh(tmesh.MeshSpec(**spec)) if spec else None
    cfg = (MoETransformerConfig(**moe) if moe
           else axes_lm_cfg(n_layers=n_layers))
    lm = lm_fit.CausalLM(cfg, lr=0.05, momentum=0.9, device="cpu",
                         pipe_microbatches=pipe_microbatches)
    lm.params = tree_map(torch.from_numpy, params_np)
    lm.fit_backprop([DataSet(x, x) for x in ids], num_epochs=2, mesh=mesh)
    return lm.params_flat().numpy()


def lm_seq_rank(mesh0, params_np, ids):
    """test_torch_ring_attention.py: the CausalLM fit on data=2 x
    seq=2."""
    return lm_axes_rank(mesh0, dict(data=2, seq=2), params_np, ids)


def bert_step_rank(mesh0, params_np, batch_np, spec, make, steps=2,
                   n_micro=None):
    """``steps`` of BERT's ``make_sp_train_step`` or
    ``make_pipeline_train_step`` (``make``) from carried params: the
    losses and the gathered params, flat in JAX's leaf order."""
    from deeplearning4j_tpu_torch.models import bert, lm_fit
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import updaters

    mesh = tmesh.make_mesh(tmesh.MeshSpec(**spec))
    cfg = axes_bert_cfg()
    params = bert.params_from_numpy(params_np, "cpu")
    batch = bert.Batch(*(torch.from_numpy(a) for a in batch_np))
    if make == "sp":
        _, step_fn = bert.make_sp_train_step(cfg, mesh, device="cpu")
    else:
        _, step_fn = bert.make_pipeline_train_step(cfg, mesh, n_micro,
                                                   device="cpu")
    if step_fn.specs is not None:
        params = tfm.shard_tree(params, step_fn.specs, mesh)
    opt = updaters.adamw(1e-4, weight_decay=0.01)
    state = bert.TrainState(params, opt.init(params), 0)
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, batch)
        losses.append(float(loss))
    out = state.params
    if step_fn.specs is not None:
        out = tfm.gather_tree(out, step_fn.specs, mesh)
    flat = torch.cat([t.reshape(-1) for t in lm_fit._sorted_leaves(out)])
    return losses, flat.numpy()


def pipe_fn_rank(mesh0, spec, stacked_np, x, y, n_micro, steps=0):
    """test_torch_pipeline.py's residual tanh stages through
    ``make_pipeline_fn``: the output and the global gradient of
    ``mean((out - y)^2)`` in the stacked params (summed over data and
    pipe); with ``steps``, that many SGD steps of
    ``make_pipeline_train_step`` (lr 0.05): the losses and the params."""
    from deeplearning4j_tpu_torch.ops.updaters import tree_map
    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.parallel import pipeline as pl

    mesh = tmesh.make_mesh(tmesh.MeshSpec(**spec))

    def stage(p, h):
        return h + torch.tanh(h @ p["w"] + p["b"])

    def loss_fn(o, t):
        return torch.mean((o - t) ** 2)

    params = tree_map(torch.from_numpy, stacked_np)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    if steps:
        init_opt, step = pl.make_pipeline_train_step(
            mesh, stage, loss_fn, n_micro, learning_rate=0.05)
        opt = init_opt(params)
        losses = []
        for _ in range(steps):
            params, opt, loss = step(params, opt, xt, yt)
            losses.append(float(loss))
        return losses, tree_map(lambda t: t.numpy(), params)
    fwd = pl.make_pipeline_fn(mesh, stage, n_micro)
    live = tree_map(lambda t: t.clone().requires_grad_(True), params)
    out = fwd(live, xt)
    grads = torch.autograd.grad(loss_fn(out, yt), [live["w"], live["b"]])
    grads = collectives.psum(list(grads), (mesh, ("data", "pipe")))
    return out.detach().numpy(), {"w": grads[0].numpy(),
                                  "b": grads[1].numpy()}


def bert_sp_rank(mesh0, params_np, batch_np, spec):
    return bert_step_rank(mesh0, params_np, batch_np, spec, "sp")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

# -- elastic recovery and the control plane (test_torch_elastic.py,
# test_torch_multihost.py) ---------------------------------------------------

def elastic_batches(n_batches: int = 4, rows: int = 16):
    """The reference test_async_checkpoint.py's ``_batches``: ``[(x [rows,
    4] fp32, y [rows, 3] one-hot)]`` from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    return [(rng.randn(rows, 4).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.randint(0, 3, rows)])
            for _ in range(n_batches)]


def _elastic_fit(mesh, p0, fault, ckdir, cluster, epochs, every,
                 hb_timeout_s=5.0, cluster_timeout_s=30.0, sync=False,
                 shuffle=True):
    """One ResilientFit of the reference MLP from carried params; the
    fit's outcome and the trained params."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.params import params_from_numpy
    from deeplearning4j_tpu_torch.parallel import chaos
    from deeplearning4j_tpu_torch.runtime.metrics import checkpoint_metrics
    from deeplearning4j_tpu_torch.runtime.resilience import (
        ResilienceConfig, ResilientFit)

    net = MultiLayerNetwork(dense_conf(tconf),
                            params=params_from_numpy(p0, "cpu"),
                            device="cpu")
    hook = fault
    if isinstance(fault, tuple) and fault[0] == "device":
        hook = chaos.DeviceLossChaos(fault[1], fault[2])
    elif isinstance(fault, tuple):
        hook = chaos.HostLossChaos(fault[1], fault[2], n_hosts=fault[3],
                                   mesh=mesh)
    drv = ResilientFit(net, ResilienceConfig(
        checkpoint_dir=ckdir, checkpoint_every=every,
        cluster_timeout_s=cluster_timeout_s, hb_interval_s=0.2,
        hb_timeout_s=hb_timeout_s, sync=sync, shuffle=shuffle), mesh=mesh,
        fault_hook=hook,
        cluster=cluster)
    checkpoint_metrics.reset()
    drv.fit([DataSet(x, y) for x, y in elastic_batches()],
            num_epochs=epochs, seed=7)
    m = drv.mesh
    return {"evicted": drv.evicted, "remeshes": drv.remeshes,
            "preempted": drv.preempted, "steps_run": drv.steps_run,
            "elastic_accum": drv.elastic_accum,
            "conf_accum": net.conf.grad_accum,
            "shape": None if m is None else dict(m.shape),
            "ranks": None if m is None else list(m.ranks),
            "members": None if drv.cluster is None
            else list(drv.cluster.members),
            "generation": None if drv.cluster is None
            else drv.cluster.generation,
            "params": net.params_flat().numpy(),
            "device_losses": checkpoint_metrics.count("device_losses"),
            "elastic_resumes": checkpoint_metrics.count("elastic_resumes"),
            "restore_fallbacks": checkpoint_metrics.count(
                "restore_fallbacks"),
            "recovery": drv.last_recovery,
            "latest": drv.manager.latest_step()}


def elastic_rank(mesh0, spec, p0, fault, tmp, cluster=False, epochs=3,
                 every=3):
    """test_torch_elastic.py: on a mesh of ``spec``, the uninterrupted
    ResilientFit (``shuffle=False``, as the JAX comparison needs), then
    the same fit with ``fault`` (``("device", at, ranks)`` or
    ``("host", at, index, n_hosts)``), each into a fresh directory under
    ``tmp``; with ``cluster`` over the group's store."""
    from deeplearning4j_tpu_torch.parallel import multihost

    out = {}
    for key, f in (("ref", None), ("drill", fault)):
        mesh = tmesh.make_mesh(tmesh.MeshSpec(**spec))
        cl = (multihost.Cluster(torch.distributed.get_rank(),
                                range(torch.distributed.get_world_size()),
                                multihost.StoreKV(), namespace=key)
              if cluster else None)
        out[key] = _elastic_fit(mesh, p0, f, os.path.join(tmp, key), cl,
                                epochs, every, shuffle=False)
    return out


def elastic_refusal_rank(mesh0, p0, tmp):
    """test_torch_elastic.py: lost ids none of which is in the ``data=2``
    mesh (a stale detector) re-raise on every rank, with no re-mesh."""
    from deeplearning4j_tpu_torch.runtime.metrics import checkpoint_metrics
    from deeplearning4j_tpu_torch.runtime.resilience import DeviceLossError

    try:
        _elastic_fit(tmesh.make_mesh(), p0, ("device", 2, [97]), tmp, None,
                     2, 3)
        raised = None
    except DeviceLossError as e:
        raised = list(e.lost_ids)
    return {"raised": raised,
            "elastic_resumes": checkpoint_metrics.count("elastic_resumes")}


def elastic_corrupt_rank(mesh0, p0, tmp):
    """test_torch_elastic.py: rank 0 corrupts the newest on-disk snapshot
    after step 7's boundary is reached, then every rank of ``data=2 x
    model=2`` reports ranks 2 and 3 lost: the restore falls back one
    step (sync snapshots, so the newest is committed when it is hit)."""
    from deeplearning4j_tpu_torch.runtime.checkpoint import CheckpointManager
    from deeplearning4j_tpu_torch.runtime.resilience import DeviceLossError

    rank = torch.distributed.get_rank()

    class CorruptThenLose:
        fired = False

        def __call__(self, step):
            if step >= 7 and not self.fired:
                self.fired = True
                if rank == 0:
                    mgr = CheckpointManager(tmp)
                    with open(mgr._path(mgr.latest_step()), "r+b") as f:
                        f.seek(12)
                        f.write(b"\xba\xad")
                raise DeviceLossError([2, 3])

    mesh = tmesh.make_mesh(tmesh.MeshSpec(data=2, model=2))
    return _elastic_fit(mesh, p0, CorruptThenLose(), tmp, None, 3, 3,
                        sync=True)


def survivor_groups_rank(mesh0):
    """test_torch_elastic.py: rank 2 of three is SIGKILLed; the others'
    collective over the old group fails at once, and ``make_mesh(...,
    ranks=[0, 1])`` builds their groups without it (gloo, a file
    rendezvous), whose model-axis sum then runs."""
    import signal

    rank = torch.distributed.get_rank()
    x = torch.ones(3)
    torch.distributed.all_reduce(x)
    if rank == 2:
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(0.5)
    t0 = time.monotonic()
    try:
        torch.distributed.all_reduce(x)
        failed = None
    except RuntimeError as e:
        failed = (type(e).__name__, time.monotonic() - t0)
    mesh = tmesh.make_mesh(tmesh.MeshSpec(data=1, model=2), ranks=[0, 1])
    y = tcol.psum(torch.full((2,), float(rank + 1)), (mesh, "model"))
    z = tcol.psum(torch.full((1,), 3.0), mesh)
    return {"failed": failed, "mesh": repr(mesh), "ranks": mesh.ranks,
            "model_sum": y.tolist(), "data_sum": z.tolist()}


def elastic_lm_rank(mesh0, params_np, ids, tmp):
    """test_torch_elastic.py: a tiny CausalLM GPT (fp32, momentum) on
    ``data=2 x model=2`` under ``ResilientFit(cluster=)`` with a snapshot
    every 2 steps, uninterrupted and then with ranks 2 and 3 lost at step
    5; the drill's snapshot files and its gathered params."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import lm_fit
    from deeplearning4j_tpu_torch.ops.updaters import tree_map
    from deeplearning4j_tpu_torch.parallel import chaos, multihost
    from deeplearning4j_tpu_torch.runtime.resilience import (
        ResilienceConfig, ResilientFit)

    out = {}
    for key, hook in (("ref", None),
                      ("drill", chaos.DeviceLossChaos(5, [2, 3]))):
        mesh = tmesh.make_mesh(tmesh.MeshSpec(data=2, model=2))
        cl = multihost.Cluster(torch.distributed.get_rank(), range(4),
                               multihost.StoreKV(), namespace=key)
        lm = lm_fit.CausalLM(axes_lm_cfg(), lr=0.05, momentum=0.9,
                             device="cpu")
        lm.params = tree_map(torch.from_numpy, params_np)
        ck = os.path.join(tmp, key)
        drv = ResilientFit(lm, ResilienceConfig(
            checkpoint_dir=ck, checkpoint_every=2, shuffle=False,
            cluster_timeout_s=30), mesh=mesh, fault_hook=hook, cluster=cl)
        drv.fit([DataSet(x, x) for x in ids], num_epochs=2, seed=3)
        out[key] = {"evicted": drv.evicted,
                    "elastic_accum": drv.elastic_accum,
                    "shape": None if drv.mesh is None
                    else dict(drv.mesh.shape),
                    "params": lm.params_flat().numpy(),
                    "recovery": drv.last_recovery,
                    "files": sorted(
                        os.path.relpath(os.path.join(d, f), ck)
                        for d, _, fs in os.walk(ck) for f in fs)}
    return out


def control_plane_rank(mesh0):
    """test_torch_multihost.py: the store-backed control plane across
    real rank processes (the reference's :733 body), and its timeout."""
    from deeplearning4j_tpu_torch.parallel import multihost

    pid = torch.distributed.get_rank()
    cluster = multihost.active_cluster(timeout_s=30)
    out = {"count": cluster.process_count, "pid": cluster.process_id}
    cluster.barrier("t1")
    out["flag1"] = cluster.any_flag(pid == 1)
    out["flag0"] = cluster.any_flag(False)
    out["gather"] = cluster.gather("blob%d" % pid, "tbl")
    out["agreed"] = cluster.agree_lost_ids([pid * 10 + 1])
    out["exchange"] = cluster.exchange(str(pid * 2), "ex")
    out["broadcast"] = cluster.broadcast("from%d" % pid, "bc")
    cluster.barrier("t2")
    if pid == 0:
        # rank 1 never publishes this tag: a typed timeout
        t0 = time.monotonic()
        try:
            cluster.barrier("alone", timeout_s=0.3)
            out["timeout"] = None
        except multihost.ClusterSyncTimeout as e:
            out["timeout"] = (type(e).__name__, time.monotonic() - t0)
    cluster.barrier("t3")
    return out


def _mh_fault(pid: int, kind: str, at: int):
    """Rank 1's drill hook: SIGTERM (a preemption notice) or SIGKILL (a
    host that says nothing) to itself at step ``at``, before the step's
    collectives."""
    import signal

    def hook(step):
        if pid == 1 and step == at:
            os.kill(os.getpid(), signal.SIGTERM if kind == "sigterm"
                    else signal.SIGKILL)
            if kind == "sigterm":
                time.sleep(0.05)        # the handler runs
    return hook


def multihost_fit_rank(mesh0, p0, tmp, kind):
    """test_torch_multihost.py: the reference MLP under ResilientFit on a
    ``data=2`` mesh with the store-backed cluster, rank 1 sending itself
    SIGTERM (``kind="sigterm"``, at step 5 of 100) or SIGKILL
    (``"kill"``, at step 5 of 16); the survivor of a kill then runs the
    uninterrupted ``mesh=None``, ``grad_accum=2`` fit of the same
    effective batch in this process for the bit comparison."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.params import params_from_numpy
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.runtime.resilience import (
        ResilienceConfig, ResilientFit)

    pid = torch.distributed.get_rank()
    cluster = multihost.active_cluster()
    epochs = 25 if kind == "sigterm" else 4
    out = _elastic_fit(tmesh.make_mesh(), p0,
                       _mh_fault(pid, kind, 5), os.path.join(tmp, kind),
                       cluster, epochs, 3, hb_timeout_s=1.5,
                       cluster_timeout_s=10.0)
    if kind == "kill":
        net = MultiLayerNetwork(dense_conf(tconf, accum=2),
                                params=params_from_numpy(p0, "cpu"),
                                device="cpu")
        ResilientFit(net, ResilienceConfig(
            checkpoint_dir=os.path.join(tmp, "ref"),
            checkpoint_every=3)).fit(
                [DataSet(x, y) for x, y in elastic_batches()],
                num_epochs=epochs, seed=7)
        out["ref_params"] = net.params_flat().numpy()
    return out


#: the sharded-checkpoint tests' layout (test_torch_checkpoint.py): a
#: column-split matrix, a split vector, a replicated matrix, a scalar
SHARDED_SPECS = {"w": ("model", 1), "b": ("model", 0), "e": None, "n": None}


def sharded_specs():
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import P

    out = {}
    for k, v in SHARDED_SPECS.items():
        if v is None:
            out[k] = None
        else:
            axes = [None] * (v[1] + 1)
            axes[v[1]] = v[0]
            out[k] = P(*axes)
    return out


def sharded_ckpt_rank(mesh0, tree_np, jax_dir, port_dir, orbax_dir):
    """test_torch_checkpoint.py on ``data=2 x model=2``: the JAX-written
    sharded checkpoint restored into this rank's layout, the port's own
    per-rank save of the same tree, and the DCP-backed manager's save and
    same-layout restore."""
    from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar
    from deeplearning4j_tpu_torch.runtime import checkpoint as tckpt

    mesh = tmesh.make_mesh(tmesh.MeshSpec(data=2, model=2))
    specs = sharded_specs()
    glob = {k: torch.from_numpy(np.array(v)) for k, v in tree_np.items()}
    local = tpar.shard_tree(glob, specs, mesh)
    zeros = {k: torch.zeros_like(v) for k, v in local.items()}
    got, meta = tckpt.load_pytree_sharded(jax_dir, like=zeros, mesh=mesh,
                                          specs=specs)
    out = {"coords": dict(mesh.coords), "meta": meta,
           "from_jax": {k: v.numpy() for k, v in got.items()},
           "local": {k: v.numpy() for k, v in local.items()}}
    out["files"] = tckpt.save_pytree_sharded(
        port_dir, local, {"tag": "port"}, mesh=mesh, specs=specs)
    mgr = tckpt.OrbaxCheckpointManager(orbax_dir, mesh=mesh, specs=specs)
    mgr.save(1, local, {"k": 1})
    back, meta = mgr.restore(like=zeros)
    out["orbax"] = {k: v.numpy() for k, v in back.items()}
    out["orbax_meta"] = meta
    return out


def _fake_mesh(n: int) -> tmesh.Mesh:
    """A port ``Mesh`` of ``n`` data ranks without a group: enough for
    the helpers that read only ``shape``."""
    return tmesh.Mesh({tmesh.DATA_AXIS: n}, None, tuple(range(n)), 0,
                      torch.device("cpu"), "gloo")


@pytest.mark.parametrize("spec,n", [
    (dict(), 8), (dict(data=2), 2), (dict(data=-1, model=2), 8),
    (dict(model=2, pipe=2), 8), (dict(data=4, expert=2), 8),
    (dict(model=3), 8), (dict(data=3), 8), (dict(data=0), 8),
    (dict(seq=0), 8)])
def test_mesh_spec_resolve_matches_reference(spec, n):
    from deeplearning4j_tpu.parallel import mesh as jmesh
    try:
        want = jmesh.MeshSpec(**spec).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.MeshSpec(**spec).resolve(n)
        assert str(got.value) == str(e)
        return
    assert tmesh.MeshSpec(**spec).resolve(n) == want
    assert tmesh.ALL_AXES == jmesh.ALL_AXES


@pytest.mark.parametrize("shape,target,dtype", [
    ((5, 3), 8, np.float32), ((4, 2, 3), 4, np.float32),
    ((3, 7), 6, np.int32), ((1,), 3, np.float32)])
def test_pad_rows_matches_reference(shape, target, dtype):
    from deeplearning4j_tpu.parallel import mesh as jmesh
    a = (np.random.RandomState(0).randn(*shape) * 10).astype(dtype)
    want = np.asarray(jmesh.pad_rows(a, target))
    got = tmesh.pad_rows(torch.from_numpy(a), target)
    assert got.dtype == torch.from_numpy(a).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_sizes_match_reference_on_eight_devices():
    from deeplearning4j_tpu.parallel import mesh as jmesh
    jm = jmesh.make_mesh(jmesh.MeshSpec(data=8))
    tm = _fake_mesh(8)
    for b in (8, 20, 32, 33, 64):
        assert tmesh.local_batch_size(b, tm) == jmesh.local_batch_size(b, jm)
        for mult in (1, 2, 3):
            assert (tmesh.padded_global_batch(b, tm, mult)
                    == jmesh.padded_global_batch(b, jm, mult))
    for call in (lambda m, f: f.local_batch_size(5, m),
                 lambda m, f: f.local_batch_size(20, m, pad=False)):
        with pytest.raises(ValueError) as want:
            call(jm, jmesh)
        with pytest.raises(ValueError) as got:
            call(tm, tmesh)
        assert str(got.value) == str(want.value)
    x = np.ones((20, 4), np.float32)
    jx, jy, jn = jmesh.pad_global_batch(x, x[:, :3], jm)
    tx, ty, tn = tmesh.pad_global_batch(torch.from_numpy(x),
                                        torch.from_numpy(x[:, :3]), tm)
    assert tn == jn == 20
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_mesh_signature_matches_reference_layout():
    from deeplearning4j_tpu.parallel import mesh as jmesh
    jsig = jmesh.mesh_signature(jmesh.make_mesh(jmesh.MeshSpec(data=8)))
    tsig = tmesh.mesh_signature(_fake_mesh(8))
    assert tsig[0] == jsig[0]               # axis names and sizes
    assert tsig[1] == jsig[1]               # ranks in the devices' order
    assert tmesh.mesh_signature(None) is None
    assert tmesh.mesh_signature(_fake_mesh(4)) != tsig


def test_shard_rows_takes_each_ranks_contiguous_block():
    x = torch.arange(24).reshape(8, 3)
    m = _fake_mesh(4)
    for r in range(4):
        m.rank = r
        assert torch.equal(tmesh.shard_rows(x, m), x[2 * r:2 * r + 2])
        assert torch.equal(tmesh.shard_rows(x[None], m, 1)[0],
                           x[2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="pad them first"):
        tmesh.shard_rows(x[:7], m)


def test_non_data_axes_and_elastic_helpers_raise_naming_a7():
    """Every axis of the reference's MeshSpec is carried: the pipe and
    seq axes pass ``check_mesh_axes`` and the step builders, and a
    collective over an axis of one is this rank alone; an axis named
    without its mesh has no group, an unknown axis is refused.  The
    elastic helpers (ROADMAP A7.3, now ported) plan over any mesh's
    shape and ranks; building the smaller mesh needs a process group
    (``test_torch_elastic.py`` builds them on gloo ranks)."""
    for axis in ("model", "pipe", "seq", "expert"):
        m = _fake_mesh(1)
        m.shape[axis] = 2
        tmesh.check_mesh_axes(m)
        step = tsf.build_sharded_step(lambda *a: a, m, label="x")
        assert step.param_specs is None
        other = "seq" if axis != "seq" else "pipe"
        torch.testing.assert_close(tcol.psum(torch.ones(2), (m, other)),
                                   torch.ones(2))
        with pytest.raises(ValueError, match="name the mesh too"):
            tcol.psum(torch.ones(2), axis)
    m = _fake_mesh(1)
    m.shape["pipe"] = 2
    assert tmesh.pipe_degree(m) == 2 and tmesh.seq_degree(m) == 1
    with pytest.raises(ValueError, match="unknown mesh axis"):
        tcol.psum(torch.ones(2), (m, "rows"))
    m.shape["rows"] = 2
    with pytest.raises(ValueError, match="the axes are"):
        tmesh.check_mesh_axes(m)
    with pytest.raises(ValueError, match="pass the mesh"):
        tsf.build_sharded_step(lambda *a: a, None, label="x",
                               param_specs={"w": None})
    assert tmesh.surviving_devices(_fake_mesh(4), [1, 3]) == [0, 2]
    assert tmesh.elastic_plan(_fake_mesh(2).shape, (0, 1), [1]) == \
        (None, [0], 2)
    with pytest.raises(tmesh.RemeshError, match="no survivors"):
        tmesh.elastic_plan(_fake_mesh(2).shape, (0, 1), [0, 1])
    for call in (lambda: tmesh.elastic_remesh(_fake_mesh(2), [1]),
                 lambda: tmesh.auto_data_mesh(devices=[0, 1])):
        with pytest.raises((RuntimeError, ValueError),
                           match="process group|not been initialized"):
            call()
    assert tmesh.model_degree(None) == tmesh.pipe_degree(None) == 1
    assert tmesh.expert_degree(_fake_mesh(2)) == tmesh.seq_degree(None) == 1


def test_no_group_means_no_auto_mesh_and_make_mesh_raises():
    if torch.distributed.is_initialized():
        pytest.skip("a process group is up in this process")
    assert tmesh.auto_data_mesh() is None
    assert not tmesh.initialize_distributed(None)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tmesh.make_mesh()


@pytest.mark.parametrize("shift", [1, -1, 2])
def test_ring_permute_matches_ppermute(tmp_path, shift):
    """The repaired ring shift: each rank's value and gradient are those
    of JAX's ``ppermute`` (as ``collectives.ring_permute`` builds it)
    under ``shard_map``, and each direction books one tensor's bytes
    once."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from deeplearning4j_tpu.compat import shard_map
    from deeplearning4j_tpu.parallel import collectives as jcol
    from deeplearning4j_tpu.parallel import mesh as jmesh

    n = 4
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((n, 3, 5)).astype(np.float32)
    ws = rng.standard_normal((n, 3, 5)).astype(np.float32)
    jm = jmesh.make_mesh(jmesh.MeshSpec(data=n), devices=jax.devices()[:n])
    f = shard_map(lambda x: jcol.ring_permute(x, "data", shift), mesh=jm,
                  in_specs=JP("data"), out_specs=JP("data"),
                  check_vma=False)
    flat_x, flat_w = xs.reshape(n * 3, 5), ws.reshape(n * 3, 5)
    want = np.asarray(jax.jit(f)(flat_x)).reshape(n, 3, 5)
    want_g = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(f(x) * flat_w)))(flat_x)).reshape(n, 3, 5)
    for r, (y, g, fwd, both) in enumerate(
            run_ranks(ring_permute_rank, n, tmp_path, xs, ws, shift)):
        np.testing.assert_array_equal(y, want[r])
        np.testing.assert_array_equal(y, xs[(r - shift) % n])
        np.testing.assert_array_equal(g, want_g[r])
        assert fwd == {"calls": 1, "bytes": xs[r].nbytes, "seconds": 0.0}
        assert both["calls"] == 2 and both["bytes"] == 2 * xs[r].nbytes


def test_collectives_on_two_gloo_ranks(tmp_path):
    r0, r1 = run_ranks(collectives_rank, 2, tmp_path)
    x = [np.arange(8, dtype=np.float32).reshape(2, 4) + 10 * r
         for r in range(2)]
    for r, res in enumerate((r0, r1)):
        assert res["rank"] == r and res["size"] == 2
        np.testing.assert_array_equal(res["psum"], x[0] + x[1])
        np.testing.assert_array_equal(res["pmean"], (x[0] + x[1]) / 2)
        np.testing.assert_array_equal(res["grad_share"], (x[0] + x[1]) / 2)
        np.testing.assert_array_equal(res["all_gather"],
                                      np.concatenate(x))
        np.testing.assert_array_equal(res["all_gather_stacked"],
                                      np.stack(x))
        np.testing.assert_array_equal(res["reduce_scatter"],
                                      (x[0] + x[1])[r:r + 1])
        np.testing.assert_array_equal(res["ring"], x[1 - r])
        np.testing.assert_array_equal(
            res["all_to_all"],
            np.concatenate([xi[:, 2 * r:2 * r + 2] for xi in x], axis=0))
        # y = (1 + 2) w summed over ranks; d/dw of sum(y^2) on rank r is
        # (r + 1) * psum(2 y): the backward sums the cotangent too
        w = np.array([1.0, 2.0], np.float32)
        np.testing.assert_array_equal(res["psum_grad"],
                                      (r + 1) * 2 * (2 * 3 * w))
        assert res["signature"] == (
            tuple((a, 2 if a == "data" else 1) for a in tmesh.ALL_AXES),
            (0, 1), r, "cpu")
