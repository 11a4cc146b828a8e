"""The port's Mixture-of-Experts layer and LM against the JAX reference.

``parallel/expert.py``: ``route_topk`` on the same gates (fp32, and
bf16 with exact ties, which ``lax.top_k`` breaks toward the lower
expert), ``moe_ffn`` on JAX's params, and the port's index-form
dispatch against the dense one-hot form it replaces.
``models/moe.py``: JAX's params (from its own ``init_params``) carried
over with ``moe.params_from_numpy``; the same numpy ids through
``lm_loss`` and through three steps of each package's
``make_train_step`` (JAX's on a one-device mesh).  Two attention pairs:
JAX's plain ``tfm.attention`` against the port's, and JAX's Pallas
kernel (interpreted, as its own tests run it on the CPU) against the
port's ``flash_attention`` (its plain twins on the CPU).

Tolerances, each with its reason:
- routing: dispatch exactly equal (integer slot counting, the same top-k
  order); combine exactly equal (one nonzero product an entry);
- ``moe_ffn`` against JAX and the dense reference (tests/test_expert.py
  :14-27), fp32: 2e-4, the reference's own bar;
- index form against the dense form, fp32: the inbox exactly, the
  combined output within 1e-6 (two products summed either way);
- ``lm_loss``, fp32: 1e-5 relative; bf16: 5e-2 (the forward tests');
- three AdamW steps, fp32: losses 1e-5 relative, params 1e-5 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import moe as jmoe
from deeplearning4j_tpu.models import transformer as jtfm
from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu.parallel import expert as jex
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh
from deeplearning4j_tpu_torch.models import moe as tmoe
from deeplearning4j_tpu_torch.models import transformer as ttfm
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import updaters
from deeplearning4j_tpu_torch.parallel import expert as tex

torch.set_num_threads(2)

FFN_TOL = 2e-4
INDEX_TOL = 1e-6
LOSS_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
STEP_TOL = 1e-5
B, T = 2, 32

ATTN = {
    "plain": (jtfm.attention, ttfm.attention),
    "flash": (jpa.make_attn_fn("pallas", autotune=False), fa.flash_attention),
}


def _gates(kind, n, e, seed=0):
    """(JAX gates, port gates) of one routing case."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, e)).astype(np.float32)
    if kind == "bf16-ties":
        logits = np.round(logits)          # whole numbers: many exact ties
    g = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    if kind.startswith("bf16"):
        g = g.astype(jnp.bfloat16)
        t = torch.from_numpy(np.array(g.astype(jnp.float32))).bfloat16()
    else:
        t = torch.from_numpy(np.array(g))
    return g, t


ROUTE_CASES = {
    # name: (gates kind, N, E, top_k, capacity)
    "fp32": ("fp32", 64, 8, 2, 20),
    "fp32-drops": ("fp32", 64, 4, 2, 9),
    "bf16-ties": ("bf16-ties", 256, 8, 2, 40),
    "bf16-top1": ("bf16-ties", 128, 4, 1, 50),
    # tests/test_expert.py:105: 512 tokens, no slot collision in bf16
    "bf16-512": ("bf16", 512, 2, 1, 400),
}


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_route_topk_matches_jax(name):
    kind, n, e, k, cap = ROUTE_CASES[name]
    jg, tg = _gates(kind, n, e)
    if kind == "bf16-ties":
        # the case holds ties among the chosen experts
        srt = np.sort(np.asarray(jg.astype(jnp.float32)), -1)[:, ::-1]
        assert (srt[:, :k + 1] == srt[:, 1:k + 2]).any()
    jd, jc, ja = jex.route_topk(jg, k, cap)
    td, tc, ta = tex.route_topk(tg, k, cap)
    assert td.dtype == tg.dtype and td.shape == (n, e, cap)
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd.astype(jnp.float32)))
    np.testing.assert_array_equal(tc.float().numpy(),
                                  np.asarray(jc.astype(jnp.float32)))
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    per_slot = td.float().sum(0)
    assert float(per_slot.max()) <= 1.0


def test_route_topk_ties_go_to_the_lower_expert():
    g = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]],
                     dtype=torch.bfloat16)
    r = tex.route(g, 2, 4)
    assert r.expert.tolist() == [[0, 1], [1, 2]]
    # choice-major: both first choices take their slots before token 0's
    # second choice queues behind token 1's first in expert 1
    assert r.slot.tolist() == [[0, 1], [0, 0]]


def _ffn_case(capacity_factor, n=48, seed=1):
    cfg = jex.MoEConfig(n_experts=4, top_k=2, capacity_factor=capacity_factor,
                        d_model=8, d_ff=16)
    jp = jex.init_moe_params(jax.random.key(seed), cfg)
    x = np.array(jax.random.normal(jax.random.key(seed + 1), (n, 8)))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg, jp, x, tex.MoEConfig(**dataclasses.asdict(cfg)), tp


def _dense_reference(params, x, cfg):
    """tests/test_expert.py:14-27: every token through its top-k experts
    directly (no capacity)."""
    gates = jax.nn.softmax(x @ params["router"], axis=-1)
    topv, topi = jax.lax.top_k(gates, cfg.top_k)
    topv = topv / jnp.sum(topv, -1, keepdims=True)
    outs = []
    for n in range(x.shape[0]):
        acc = jnp.zeros(cfg.d_model)
        for j in range(cfg.top_k):
            e = topi[n, j]
            h = jax.nn.gelu(x[n] @ params["wi"][e])
            acc = acc + topv[n, j] * (h @ params["wo"][e])
        outs.append(acc)
    return jnp.stack(outs)


@pytest.mark.parametrize("capacity_factor", [1.0, 4.0],
                         ids=["drops", "ample"])
def test_moe_ffn_matches_jax(capacity_factor):
    cfg, jp, x, tcfg, tp = _ffn_case(capacity_factor)
    jy, jaux = jex.moe_ffn(jp, jnp.asarray(x), cfg)
    ty, taux = tex.moe_ffn(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=FFN_TOL,
                               atol=FFN_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    if capacity_factor == 4.0:
        ref = _dense_reference(jp, jnp.asarray(x), cfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(ref), rtol=FFN_TOL,
                                   atol=FFN_TOL)


def test_moe_ffn_gradients_match_jax():
    cfg, jp, x, tcfg, tp = _ffn_case(1.0)

    def jloss(p, x):
        y, aux = jex.moe_ffn(p, x, cfg)
        return jnp.sum(jnp.tanh(y)) + aux

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tex.moe_ffn(tp, tx, tcfg)
    (torch.tanh(y).sum() + aux).backward()
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[0][k]),
                                   rtol=FFN_TOL, atol=FFN_TOL, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               rtol=FFN_TOL, atol=FFN_TOL)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
def test_index_dispatch_equals_dense_dispatch(capacity_factor):
    """The gather form of the inbox and of the combine is the dense
    one-hot einsums' function."""
    cfg, _, x, tcfg, tp = _ffn_case(capacity_factor, n=64, seed=3)
    xt = torch.from_numpy(x)
    gates = tex.router_gates(tp, xt)
    C = tex.compute_capacity(64, 4, 2, capacity_factor)
    r = tex.route(gates, 2, C)
    disp, comb, aux = tex.route_topk(gates, 2, C)
    inbox = tex.dispatch(xt, r, 4)
    torch.testing.assert_close(inbox, torch.einsum("nec,nd->ecd", disp, xt),
                               rtol=0, atol=0)
    out = tex._expert_ffn(tp["wi"], tp["wo"], inbox)
    torch.testing.assert_close(tex.combine(out, r),
                               torch.einsum("nec,ecd->nd", comb, out),
                               rtol=INDEX_TOL, atol=INDEX_TOL)
    assert float(aux) == float(r.aux)
    kept = int(r.keep.sum())
    assert float(disp.sum()) == kept <= 4 * C


def _lm_cfg(compute_dtype, **kw):
    return jmoe.MoETransformerConfig(
        vocab_size=128, max_len=T, hidden=32, n_layers=2, n_heads=4,
        d_ff=64, n_experts=4, top_k=2, compute_dtype=compute_dtype, **kw)


def _lm_start(cfg, seed=0):
    jp = jmoe.init_params(jax.random.key(seed), cfg)
    return jp, tmoe.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _ids(seed=1):
    return np.random.default_rng(seed).integers(0, 128, (B, T)) \
        .astype(np.int32)


@pytest.mark.parametrize("attn", sorted(ATTN))
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_lm_loss_matches_jax(compute_dtype, attn):
    cfg = _lm_cfg(compute_dtype)
    tcfg = tmoe.MoETransformerConfig(**dataclasses.asdict(cfg))
    jattn, tattn = ATTN[attn]
    jp, tp = _lm_start(cfg)
    ids = _ids()
    jl = jmoe.lm_loss(cfg, jp, jnp.asarray(ids), attn_fn=jattn)
    tl = tmoe.lm_loss(tcfg, tp, torch.from_numpy(ids), tattn)
    np.testing.assert_allclose(float(tl), float(jl),
                               rtol=LOSS_TOL[compute_dtype])


@pytest.mark.parametrize("attn", sorted(ATTN))
def test_three_adamw_steps_match_jax(attn):
    cfg = _lm_cfg("float32")
    tcfg = tmoe.MoETransformerConfig(**dataclasses.asdict(cfg))
    jattn, tattn = ATTN[attn]
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jinit, jstep = jmoe.make_train_step(cfg, mesh, attn_fn=jattn)
    jstate = jinit(jax.random.key(0))
    tparams = tmoe.params_from_numpy(jax.tree.map(np.asarray,
                                                  jstate.params), "cpu")
    _, tstep = tmoe.make_train_step(tcfg, attn_fn=tattn, device="cpu")
    tstate = tmoe.TrainState(tparams,
                             updaters.adamw(1e-3).init(tparams), 0)
    ids = _ids(2)
    jl, tl = [], []
    for _ in range(3):
        jstate, loss = jstep(jstate, jnp.asarray(ids))
        jl.append(float(loss))
        tstate, loss = tstep(tstate, torch.from_numpy(ids))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL)
    assert tstate.step == 3 and int(tstate.opt_state.count) == 3
    for grp in ("embed", "blocks"):
        for leaf, ref in jstate.params[grp].items():
            np.testing.assert_allclose(
                tstate.params[grp][leaf].numpy(), np.asarray(ref),
                rtol=STEP_TOL, atol=STEP_TOL, err_msg=f"{grp}/{leaf}")


def test_remat_changes_no_gradient():
    cfg = tmoe.MoETransformerConfig(**dataclasses.asdict(_lm_cfg("float32")))
    _, tp = _lm_start(_lm_cfg("float32"))
    ids = torch.from_numpy(_ids())
    got = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        got[remat] = ttfm.value_and_grad(
            lambda p: tmoe.lm_loss(c, p, ids), tp)
    assert float(got[True][0]) == float(got[False][0])
    for a, b in zip(updaters.tree_leaves(got[True][1]),
                    updaters.tree_leaves(got[False][1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ffn_fn_hook_replaces_the_dispatch():
    cfg = tmoe.MoETransformerConfig(**dataclasses.asdict(_lm_cfg("float32")))
    _, tp = _lm_start(_lm_cfg("float32"))
    ids = torch.from_numpy(_ids())
    seen = []

    def ffn(lp, tok):
        seen.append(tuple(tok.shape))
        return tex.make_gspmd_moe_ffn(None, cfg.moe)(lp, tok)

    with torch.no_grad():
        a = tmoe.lm_loss(cfg, tp, ids)
        b = tmoe.lm_loss(cfg, tp, ids, ffn_fn=ffn)
    assert float(a) == float(b) and seen == [(B * T, 32)] * 2


def test_one_device_layers_and_a7_refusals():
    cfg, jp, x, tcfg, tp = _ffn_case(2.0)
    xt = torch.from_numpy(x)
    ref = tex.moe_ffn(tp, xt, tcfg)
    one = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    for mesh in (None, one, {"data": 1, "expert": 1}):
        for make in (tex.make_moe_layer, tex.make_gspmd_moe_ffn):
            y, aux = make(mesh, tcfg)(tp, xt)
            torch.testing.assert_close(y, ref[0], rtol=0, atol=0)
    # the expert axis is ported: the specs are the reference's
    mcfg = tmoe.MoETransformerConfig()
    jcfg = jmoe.MoETransformerConfig()

    def axes(tree):
        return {k: axes(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else tuple(tree)

    assert axes(tex.expert_param_specs(tcfg)) \
        == axes(jex.expert_param_specs(cfg))
    assert axes(tmoe.param_specs(mcfg)) == axes(jmoe.param_specs(jcfg))
    for kw in (dict(expert_degree=2), dict(model_degree=2),
               dict(model_degree=2, expert_degree=4)):
        assert axes(tmoe.shard_specs(mcfg, **kw)) \
            == axes(jmoe.shard_specs(jcfg, **kw))
    # the pipe stages are ported (stage-major over pipe, the expert split
    # kept); what stays refused: an axis named without its mesh, and an
    # expert axis above 1 on anything but a port Mesh
    for kw in (dict(pipe_degree=2), dict(pipe_degree=2, expert_degree=2)):
        assert axes(tmoe.shard_specs(mcfg, **kw)) \
            == axes(jmoe.shard_specs(jcfg, **kw))
    with pytest.raises(ValueError, match="name the mesh too"):
        tex.moe_ffn(tp, xt, tcfg, axis_name="expert")
    for call in (lambda: tex.make_moe_layer({"expert": 2}, tcfg),
                 lambda: tex.make_gspmd_moe_ffn({"expert": 4}, tcfg),
                 lambda: tex.moe_ffn(tp, xt, tcfg, stat_axes=("data",)),
                 lambda: tex.route_topk(tex.router_gates(tp, xt), 2, 8,
                                        stat_axes=("data",))):
        with pytest.raises(ValueError, match="mesh"):
            call()
    with pytest.raises(ValueError, match="not divisible by expert degree"):
        tex.make_moe_layer({"expert": 3}, tcfg)


def test_entry_points_need_cuda_or_an_explicit_cpu():
    cfg = tmoe.MoETransformerConfig()
    if not torch.cuda.is_available():
        for call in (lambda: tmoe.make_train_step(cfg),
                     lambda: tmoe.init_params(torch.Generator(), cfg),
                     lambda: tmoe.synthetic_ids(0, cfg, 2, 8),
                     lambda: tex.init_moe_params(torch.Generator(),
                                                 cfg.moe)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    ids = tmoe.synthetic_ids(0, cfg, 2, 8, device="cpu")
    assert ids.shape == (2, 8) and ids.dtype == torch.int32
    p = tmoe.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = jax.eval_shape(lambda: jmoe.init_params(jax.random.key(0),
                                                 jmoe.MoETransformerConfig()))
    for grp in jp:
        assert {k: tuple(v.shape) for k, v in p[grp].items()} == \
            {k: tuple(v.shape) for k, v in jp[grp].items()}
    with pytest.raises(KeyError, match="blocks/router"):
        bad = jax.tree.map(np.asarray, jmoe.init_params(
            jax.random.key(0), jmoe.MoETransformerConfig()))
        del bad["blocks"]["router"]
        tmoe.params_from_numpy(bad, "cpu")
