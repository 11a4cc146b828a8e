"""The port's ``expert`` mesh axis against the JAX reference.

The contracts of the reference's ``tests/test_expert.py`` (the
expert-parallel layer, the MoE LM's data x expert step, training) and
of ``test_parallel_4d.py::test_moe_expert_axis_fit_on_the_spine``, held
on one spawned group of four gloo CPU ranks (``test_torch_mesh.
run_ranks``).  One rank program (:func:`ep_rank`) runs every case on
every rank, on meshes of the four ranks laid out ``expert=4``,
``data=2 x expert=2`` and ``data=2 x model=2``, and returns what each
test reads; the tests compare with the JAX package on the same mesh
shapes of its 8-device CPU platform (``tests/conftest.py``), run in
this process on the same numpy params and batches, and with the port's
own ``mesh=None`` runs.

- ``collectives.all_to_all``: forward and gradient bit-equal to a
  gather-and-slice reference, one ``all_to_all_single`` a call;
- ``make_moe_layer`` at ``ep/dp`` = 4/1 and 2/2 against the reference's
  layer on the same mesh shape and against one device (capacity 4,
  nothing drops): atol 2e-6;
- the layer trains (the reference's 15 SGD steps): losses against the
  reference's, rtol 1e-4;
- ``moe.make_train_step(mesh=)`` on ``data=2 x expert=2``: the loss of
  the first step equals the un-sharded loss (rtol 1e-5, capacity 8),
  and two AdamW steps equal the reference's step on its 2 x 2 mesh
  (rtol 1e-4, atol 1e-6), at capacity 8 and at 1.25 (where the drops
  are the shard's own, so only the same mesh shape compares), with the
  expert tables' AdamW state split;
- ``CausalLM``'s MoE on ``data=2 x expert=2`` and on ``data=2 x
  model=2`` against the reference's fits on the same shapes (rtol 1e-4,
  atol 1e-5) and against ``mesh=None`` (the reference test's rtol
  1e-3, atol 1e-4).

The module imports no JAX at its top, so the spawned ranks do not
either; the reference runs inside the tests.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_mesh import run_ranks

torch.set_num_threads(2)

#: seconds the four ranks may take (the suite's other workers share the
#: cores)
DEADLINE_S = 400.0

#: the reference tests' MoE layer config
LAYER_KW = dict(n_experts=8, top_k=2, capacity_factor=4.0, d_model=8,
                d_ff=16)
#: ... the training test's
TRAIN_KW = dict(n_experts=4, top_k=1, capacity_factor=2.0, d_model=8,
                d_ff=16, aux_loss_weight=1e-2)
#: test_expert.py::test_moe_transformer_sharded_matches_single's LM
LM_KW = dict(vocab_size=128, max_len=32, hidden=32, n_layers=2, n_heads=4,
             d_ff=64, n_experts=8, top_k=2, capacity_factor=8.0,
             compute_dtype="float32")
#: test_parallel_4d.py::test_moe_expert_axis_fit_on_the_spine's LM
FIT_KW = dict(vocab_size=64, max_len=16, hidden=32, n_layers=2, n_heads=4,
              d_ff=64, n_experts=4, top_k=2, capacity_factor=8.0,
              compute_dtype="float32", causal=True)
FIT_LR, FIT_MU = 0.05, 0.9
STEP_LR = 1e-3


def _tensors(tree):
    from deeplearning4j_tpu_torch.ops.updaters import tree_map
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _numpy(tree):
    from deeplearning4j_tpu_torch.ops.updaters import tree_map
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _fit_ids(n=2, rows=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, (rows, 16)).astype(np.int32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------

def _a2a_cases():
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import collectives as col
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.make_mesh(tmesh.MeshSpec(data=1, expert=4))
    g = dist.get_rank()
    out = {}

    def a2a_calls():
        return col.stats.snapshot()["by_kind"]["all_to_all"]["calls"]

    for split, concat, shape in ((0, 1, (8, 6, 3)), (1, 0, (4, 8, 2)),
                                 (2, 2, (3, 2, 8))):
        gen = torch.Generator().manual_seed(10 * g + split)
        x = torch.randn(shape, generator=gen).requires_grad_(True)
        calls = a2a_calls()
        y = col.all_to_all(x, (mesh, "expert"), split, concat)
        fwd_calls = a2a_calls() - calls
        parts = [torch.empty(shape) for _ in range(4)]
        dist.all_gather(parts, x.detach())
        want = torch.cat([p.chunk(4, split)[g] for p in parts], concat)
        w = torch.randn(y.shape, generator=gen)
        (y * w).sum().backward()
        # the gradient of sum_r <y_r, w_r> by x_g: rank j's cotangent
        # block that came from x_g's block j
        ws = [torch.empty_like(w) for _ in range(4)]
        dist.all_gather(ws, w)
        gwant = torch.cat([ws[j].chunk(4, concat)[g] for j in range(4)],
                          split)
        out[(split, concat)] = {
            "fwd": bool(torch.equal(y, want)),
            "bwd": bool(torch.equal(x.grad, gwant)),
            "calls": (fwd_calls, a2a_calls() - calls)}
    return out


def _layer_cases(p):
    from deeplearning4j_tpu_torch.parallel import expert as tex
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh
    from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar

    cfg = tex.MoEConfig(**LAYER_KW)
    params = _tensors(p["layer_params"])
    x = torch.from_numpy(p["layer_x"])
    out = {"single": tuple(t.numpy() for t in tex.moe_ffn(params, x, cfg))}
    for dp, ep in ((1, 4), (2, 2)):
        mesh = tmesh.make_mesh(tmesh.MeshSpec(data=dp, expert=ep))
        local = tpar.shard_tree(params, tex.expert_param_specs(cfg), mesh)
        shard = mesh.coords["data"] * ep + mesh.coords["expert"]
        n = x.shape[0] // (dp * ep)
        y, aux = tex.make_moe_layer(mesh, cfg)(local,
                                               x[shard * n:(shard + 1) * n])
        out[(dp, ep)] = {"shard": shard, "y": y.numpy(), "aux": float(aux),
                         "wi": tuple(local["wi"].shape)}
    return out


def _train_layer(p):
    from deeplearning4j_tpu_torch.parallel import collectives as col
    from deeplearning4j_tpu_torch.parallel import expert as tex
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh
    from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar

    cfg = tex.MoEConfig(**TRAIN_KW)
    mesh = tmesh.make_mesh(tmesh.MeshSpec(data=1, expert=4))
    specs = tex.expert_param_specs(cfg)
    params = tpar.shard_tree(_tensors(p["train_params"]), specs, mesh)
    layer = tex.make_moe_layer(mesh, cfg)
    shard, n = mesh.coords["expert"], 8
    x = torch.from_numpy(p["train_x"])[shard * n:(shard + 1) * n]
    t = torch.from_numpy(p["train_t"])[shard * n:(shard + 1) * n]
    losses = []
    for _ in range(15):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        y, aux = layer(live, x)
        loss = torch.mean((y - t) ** 2) + cfg.aux_loss_weight * aux
        grads = torch.autograd.grad(loss / 4, list(live.values()))
        # the router is replicated: its gradient sums over the token
        # shards; an expert table's holds every shard's already
        grads = {k: (col.psum(g, (mesh, ("data", "expert"))) if k == "router"
                     else col.psum(g, (mesh, "data")))
                 for k, g in zip(live, grads)}
        losses.append(float(col.psum(loss.detach(), (mesh, "expert")) / 4))
        params = {k: params[k] - 0.1 * grads[k] for k in params}
    return losses


def _step_cases(p):
    from deeplearning4j_tpu_torch.models import moe as tmoe
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh
    from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar

    mesh = tmesh.make_mesh(tmesh.MeshSpec(data=2, expert=2))
    out = {}
    for cf in (8.0, 1.25):
        cfg = tmoe.MoETransformerConfig(**{**LM_KW, "capacity_factor": cf})
        opt = updaters.adamw(STEP_LR, weight_decay=0.01)
        _, step = tmoe.make_train_step(cfg, mesh, optimizer=opt,
                                       device="cpu")
        params = tpar.shard_tree(tmoe.params_from_numpy(p["lm_params"],
                                                        "cpu"),
                                 step.specs, mesh)
        state = tfm.TrainState(params, opt.init(params), 0)
        ids = torch.from_numpy(p["lm_ids"])
        losses = []
        for _ in range(2):
            state, loss = step(state, ids)
            losses.append(float(loss))
        out[cf] = {
            "losses": losses,
            "params": _numpy(tpar.gather_tree(state.params, step.specs,
                                              mesh)),
            "local_mu_wi": tuple(state.opt_state.mu["blocks"]["wi"].shape),
            "local_wq": tuple(state.params["blocks"]["wq"].shape)}
    return out


def _fit_cases(p):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import lm_fit
    from deeplearning4j_tpu_torch.models import moe as tmoe
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh

    cfg = tmoe.MoETransformerConfig(**FIT_KW)
    data = [DataSet(x, x) for x in _fit_ids()]
    out = {}
    for name, spec in (("de", dict(data=2, expert=2)),
                       ("dm", dict(data=2, model=2))):
        mesh = tmesh.make_mesh(tmesh.MeshSpec(**spec))
        lm = lm_fit.CausalLM(cfg, lr=FIT_LR, momentum=FIT_MU, device="cpu")
        lm.params = tmoe.params_from_numpy(p["fit_params"], "cpu")
        lm.fit_backprop(data, num_epochs=2, mesh=mesh)
        step, _ = lm._backprop_machinery(mesh)
        local = step.shard_state(tmoe.params_from_numpy(p["fit_params"],
                                                        "cpu"))
        out[name] = {"params": lm.params_flat().numpy(),
                     "local_wi": tuple(local["blocks"]["wi"].shape),
                     "local_wq": tuple(local["blocks"]["wq"].shape)}
    lm = lm_fit.CausalLM(cfg, lr=FIT_LR, momentum=FIT_MU, device="cpu")
    lm.params = tmoe.params_from_numpy(p["fit_params"], "cpu")
    lm.fit_backprop(data, num_epochs=2, mesh=None)
    out["none"] = lm.params_flat().numpy()
    return out


def ep_rank(_data_mesh, p):
    """Every case on this rank of the four."""
    return {"a2a": _a2a_cases(), "layer": _layer_cases(p),
            "train": _train_layer(p), "step": _step_cases(p),
            "fit": _fit_cases(p)}


# ---------------------------------------------------------------------------
# the reference side and the fixture
# ---------------------------------------------------------------------------

def _np_tree(t):
    import jax
    return jax.tree.map(lambda a: np.array(a), t)


def _jmesh(**axes):
    import jax
    from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh
    n = int(np.prod(list(axes.values())))
    return make_mesh(MeshSpec(**axes), devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def payload():
    import jax
    from deeplearning4j_tpu.models import moe as jmoe
    from deeplearning4j_tpu.parallel import expert as jex

    rng = np.random.RandomState(0)
    x = rng.randn(32, 8).astype(np.float32)
    return {
        "layer_params": _np_tree(jex.init_moe_params(
            jax.random.key(3), jex.MoEConfig(**LAYER_KW))),
        "layer_x": rng.randn(16, 8).astype(np.float32),
        "train_params": _np_tree(jex.init_moe_params(
            jax.random.key(5), jex.MoEConfig(**TRAIN_KW))),
        "train_x": x,
        "train_t": np.tanh(x @ rng.randn(8, 8).astype(np.float32)),
        "lm_params": _np_tree(jmoe.init_params(
            jax.random.key(0), jmoe.MoETransformerConfig(**LM_KW))),
        "lm_ids": rng.randint(0, 128, (8, 32)).astype(np.int32),
        "fit_params": _np_tree(jmoe.init_params(
            jax.random.key(1), jmoe.MoETransformerConfig(**FIT_KW))),
    }


@pytest.fixture(scope="module")
def ranks(payload, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert_parallel")
    return run_ranks(ep_rank, 4, tmp, payload, deadline=DEADLINE_S)


def _jtree(tree):
    import jax.numpy as jnp
    from deeplearning4j_tpu_torch.ops.updaters import tree_map
    return tree_map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(_flat(tree[key], f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(tree[key], np.float32)
    return out


# ---------------------------------------------------------------------------
# tests: the all-to-all
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split,concat", [(0, 1), (1, 0), (2, 2)])
def test_all_to_all_matches_gather_and_slice(ranks, split, concat):
    """Each rank's result equals the tiled ``lax.all_to_all`` computed
    from every rank's whole tensor, bit for bit, in one exchange (one
    more for the backward)."""
    for r in ranks:
        case = r["a2a"][(split, concat)]
        assert case["fwd"] and case["calls"] == (1, 2)


@pytest.mark.parametrize("split,concat", [(0, 1), (1, 0), (2, 2)])
def test_all_to_all_gradient_is_the_inverse_exchange(ranks, split, concat):
    """The backward of ``all_to_all(x, split, concat)`` sends each
    cotangent block back to the rank it came from, bit for bit."""
    for r in ranks:
        assert r["a2a"][(split, concat)]["bwd"]


# ---------------------------------------------------------------------------
# tests: the layer
# ---------------------------------------------------------------------------

def _jax_layer(payload, dp, ep):
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import expert as jex
    cfg = jex.MoEConfig(**LAYER_KW)
    layer = jex.make_moe_layer(_jmesh(data=dp, expert=ep), cfg)
    y, aux = jax.jit(layer)(_jtree(payload["layer_params"]),
                            jnp.asarray(payload["layer_x"]))
    return np.asarray(y), float(aux)


@pytest.mark.parametrize("ep,dp", [(4, 1), (2, 2)])
def test_expert_parallel_matches_single(ranks, payload, ep, dp):
    """The reference's test at the port's four ranks: every shard's
    outputs and the pooled aux against the reference's layer on the
    same mesh shape and against one device, atol 2e-6 (capacity 4:
    nothing drops); each rank holds E / ep experts."""
    jy, jaux = _jax_layer(payload, dp, ep)
    ys, aux1 = ranks[0]["layer"]["single"]
    n = 16 // (ep * dp)
    for r in ranks:
        case = r["layer"][(dp, ep)]
        rows = slice(case["shard"] * n, (case["shard"] + 1) * n)
        np.testing.assert_allclose(case["y"], jy[rows], rtol=0, atol=2e-6)
        np.testing.assert_allclose(case["y"], ys[rows], rtol=0, atol=2e-6)
        np.testing.assert_allclose(case["aux"], jaux, rtol=1e-6)
        np.testing.assert_allclose(case["aux"], float(aux1), rtol=1e-6)
        assert case["wi"] == (8 // ep, 8, 16)


def test_moe_training_reduces_loss(ranks, payload):
    """The reference's training test on ``expert=4``: 15 SGD steps of
    the sharded layer, the losses against the reference's, rtol 1e-4,
    the last below 0.9 of the first."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import expert as jex
    cfg = jex.MoEConfig(**TRAIN_KW)
    layer = jex.make_moe_layer(_jmesh(data=1, expert=4), cfg)
    x, t = jnp.asarray(payload["train_x"]), jnp.asarray(payload["train_t"])

    @jax.jit
    def step(p):
        def loss_fn(p):
            y, aux = layer(p, x)
            return jnp.mean((y - t) ** 2) + cfg.aux_loss_weight * aux
        loss, g = jax.value_and_grad(loss_fn)(p)
        return jax.tree.map(lambda a, b: a - 0.1 * b, p, g), loss

    params, want = _jtree(payload["train_params"]), []
    for _ in range(15):
        params, loss = step(params)
        want.append(float(loss))
    for r in ranks:
        np.testing.assert_allclose(r["train"], want, rtol=1e-4)
        assert r["train"][-1] < r["train"][0] * 0.9


# ---------------------------------------------------------------------------
# tests: the data x expert train step
# ---------------------------------------------------------------------------

def _jax_steps(payload, cf):
    import jax.numpy as jnp
    import optax
    from deeplearning4j_tpu.models import moe as jmoe
    cfg = jmoe.MoETransformerConfig(**{**LM_KW, "capacity_factor": cf})
    opt = optax.adamw(STEP_LR, weight_decay=0.01)
    _, step = jmoe.make_train_step(cfg, _jmesh(data=2, expert=2),
                                   optimizer=opt)
    params = _jtree(payload["lm_params"])
    state = jmoe.TrainState(params, opt.init(params),
                            jnp.zeros((), jnp.int32))
    losses = []
    for _ in range(2):
        state, loss = step(state, jnp.asarray(payload["lm_ids"]))
        losses.append(float(loss))
    return losses, _np_tree(state.params)


def test_moe_transformer_sharded_matches_single(ranks, payload):
    """The reference's test on ``data=2 x expert=2``: the sharded step's
    loss equals the un-sharded loss of the same params (capacity 8:
    nothing drops), rtol 1e-5."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.models import moe as jmoe
    cfg = jmoe.MoETransformerConfig(**LM_KW)
    ref = float(jmoe.lm_loss(cfg, _jtree(payload["lm_params"]),
                             jnp.asarray(payload["lm_ids"])))
    for r in ranks:
        np.testing.assert_allclose(r["step"][8.0]["losses"][0], ref,
                                   rtol=1e-5)


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_train_step_matches_reference_mesh(ranks, payload, cf):
    """Two AdamW steps on ``data=2 x expert=2`` against the reference's
    step on its 2 x 2 mesh: losses rtol 1e-5, params rtol 1e-4 atol
    1e-6.  At capacity 1.25 the shards drop their own tokens, the same
    ones in both packages; the expert tables and their AdamW moments
    stay split (4 of 8 experts a rank), heads are not split."""
    want_losses, want = _jax_steps(payload, cf)
    want = _flat(want)
    for r in ranks:
        case = r["step"][cf]
        np.testing.assert_allclose(case["losses"], want_losses, rtol=1e-5)
        got = _flat(case["params"])
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       atol=1e-6, err_msg=name)
        assert case["local_mu_wi"] == (2, 4, 32, 64)
        assert case["local_wq"] == (2, 32, 4, 8)


# ---------------------------------------------------------------------------
# tests: CausalLM's MoE on the spine
# ---------------------------------------------------------------------------

def _jax_fit(payload, **axes):
    import jax.numpy as jnp
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.models import lm_fit as jlm
    from deeplearning4j_tpu.models import moe as jmoe
    lm = jlm.CausalLM(jmoe.MoETransformerConfig(**FIT_KW), lr=FIT_LR,
                      momentum=FIT_MU)
    lm.params = _jtree(payload["fit_params"])
    lm.fit_backprop([JDataSet(jnp.asarray(x), jnp.asarray(x))
                     for x in _fit_ids()], num_epochs=2,
                    mesh=_jmesh(**axes) if axes else None)
    return np.asarray(lm.params_flat())


def test_moe_expert_axis_fit_on_the_spine(ranks, payload):
    """The reference's test: ``CausalLM`` on ``data=2 x expert=2`` with
    the expert tables split over ``expert`` (2 of 4 experts a rank),
    finite, against the reference's fit on the same mesh shape (rtol
    1e-4, atol 1e-5) and against ``mesh=None`` (the reference's own
    bound, rtol 1e-3, atol 1e-4)."""
    want = _jax_fit(payload, data=2, expert=2)
    for r in ranks:
        got = r["fit"]["de"]
        assert np.isfinite(got["params"]).all()
        assert got["local_wi"] == (2, 2, 32, 64)
        np.testing.assert_allclose(got["params"], want, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["params"], r["fit"]["none"],
                                   rtol=1e-3, atol=1e-4)


def test_moe_model_axis_fit_matches_reference(ranks, payload):
    """``CausalLM``'s MoE on ``data=2 x model=2``: experts and heads
    split over ``model`` (2 of 4 experts, 2 of 4 heads a rank), the
    combine summed over ``model``; against the reference's fit on its
    2 x 2 mesh (rtol 1e-4, atol 1e-5) and against ``mesh=None``."""
    want = _jax_fit(payload, data=2, model=2)
    for r in ranks:
        got = r["fit"]["dm"]
        assert got["local_wi"] == (2, 2, 32, 64)
        assert got["local_wq"] == (2, 32, 2, 8)
        np.testing.assert_allclose(got["params"], want, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["params"], r["fit"]["none"],
                                   rtol=1e-3, atol=1e-4)


def test_expert_modules_import_no_jax():
    from test_torch_paged import assert_no_jax
    for name in ("deeplearning4j_tpu_torch.parallel.expert",
                 "deeplearning4j_tpu_torch.models.moe",
                 "deeplearning4j_tpu_torch.parallel.collectives"):
        assert_no_jax(name)
