"""The port's optimizer families against optax, through both registries.

``updaters.make_optimizer`` of the port and of the JAX package
(``deeplearning4j_tpu/ops/updaters.py:138-153``, optax 0.2.6 underneath)
take the same numpy params and the same seeded gradient sequence for
10 steps: a dict of a [7, 5] matrix, a [5] bias and a scalar, one of
whose gradients is all zeros on one step (LAMB's trust ratio at a zero
norm).  Params, updates and the optimizer state agree at rtol 1e-6 /
atol 1e-7 in fp32 (the same per-leaf arithmetic in the same order; the
rest is the rounding of a reduction or an rsqrt).  Then BERT's train
step with LAMB against the JAX step from the same carried params and
batch, within ``test_torch_train``'s fp32 tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.models import transformer as jtfm
from deeplearning4j_tpu.ops import updaters as jupd
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.models import transformer as ttfm
from deeplearning4j_tpu_torch.ops import updaters

torch.set_num_threads(2)

FAMILIES = ("adam", "adagrad", "rmsprop", "lamb")
N_STEPS = 10
RTOL, ATOL = 1e-6, 1e-7


def _tree(rng, scale=1.0):
    return {"W": (scale * rng.standard_normal((7, 5))).astype(np.float32),
            "b": (scale * rng.standard_normal(5)).astype(np.float32),
            "s": np.asarray(scale * rng.standard_normal(), np.float32)}


def _grads(rng):
    """The 10 steps' gradients; step 3's bias gradient is all zeros."""
    grads = [_tree(rng, 0.1) for _ in range(N_STEPS)]
    grads[3]["b"] = np.zeros(5, np.float32)
    return grads


def _close(got, ref, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _state_leaves(name, tstate, jstate):
    """(what, port leaf tree, optax leaf tree) pairs of the two states."""
    if name in ("adam", "lamb"):
        return [("mu", tstate.mu, jstate[0].mu), ("nu", tstate.nu,
                                                  jstate[0].nu)]
    if name == "adagrad":
        return [("sum_of_squares", tstate.sum_of_squares,
                 jstate[0].sum_of_squares)]
    return [("nu", tstate.nu, jstate[0].nu)]


@pytest.mark.parametrize("lr", [1e-3, 3e-2], ids=["lr1e-3", "lr3e-2"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_matches_optax(name, lr):
    rng = np.random.default_rng(11)
    params = _tree(rng)
    params["W"][0, 0] = 0.0
    grads = _grads(rng)
    jopt = jupd.make_optimizer(name, lr)
    topt = updaters.make_optimizer(name, lr)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init(tp)
    for step, g in enumerate(grads):
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        tp = updaters.apply_updates(tp, tu)
        for k in params:
            _close(tu[k], ju[k], f"{name} step {step} update {k}")
            _close(tp[k], jp[k], f"{name} step {step} param {k}")
    for what, tleaf, jleaf in _state_leaves(name, ts, js):
        for k in params:
            _close(tleaf[k], jleaf[k], f"{name} state {what}/{k}")
    if name in ("adam", "lamb"):
        assert int(ts.count) == int(js[0].count) == N_STEPS


def test_lamb_trust_ratio_is_one_at_a_zero_norm():
    """A zero gradient gives a zero Adam direction on its first step: the
    trust ratio is 1 there, not 0/0, and the update is exactly 0."""
    opt = updaters.make_optimizer("lamb", 1e-2)
    params = {"a": torch.ones(3), "z": torch.zeros(2)}
    u, _ = opt.update({"a": torch.zeros(3), "z": torch.ones(2)},
                      opt.init(params), params)
    assert torch.equal(u["a"], torch.zeros(3))
    assert torch.isfinite(u["z"]).all() and (u["z"] != 0).all()


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"momentum": 0.9}), ("adamw", {"weight_decay": 0.1}),
    ("adam", {"b1": 0.8, "b2": 0.99}), ("lamb", {"weight_decay": 0.01}),
    ("SGD", {})], ids=["sgd", "adamw", "adam-betas", "lamb-decay",
                       "upper-case"])
def test_registry_keywords_match_the_reference(name, kw):
    rng = np.random.default_rng(5)
    params = _tree(rng)
    grads = _grads(rng)[:3]
    jopt = jupd.make_optimizer(name, 1e-2, **kw)
    topt = updaters.make_optimizer(name, 1e-2, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        tp = updaters.apply_updates(tp, tu)
    for k in params:
        _close(tp[k], jp[k], f"{name} {kw} param {k}")


def test_unknown_name_raises_the_reference_message():
    with pytest.raises(ValueError) as jerr:
        jupd.make_optimizer("adadelta", 1e-3)
    with pytest.raises(ValueError) as terr:
        updaters.make_optimizer("adadelta", 1e-3)
    assert str(terr.value) == str(jerr.value) == \
        "unknown optimizer 'adadelta'"


def test_bert_train_step_with_lamb_matches_jax():
    """Three LAMB steps of ``bert.make_train_step`` on ``bert_tiny`` from
    JAX's initial params and one batch (fp32, plain attention): losses
    rtol 1e-4, params 1e-5 absolute (``test_torch_train``'s fp32
    bounds)."""
    B, T = 2, 32
    jcfg = dataclasses.replace(jbert.bert_tiny(), compute_dtype="float32")
    tcfg = dataclasses.replace(tbert.bert_tiny(), compute_dtype="float32")
    rng = np.random.default_rng(0)
    labels = rng.integers(5, jcfg.vocab_size, (B, T)).astype(np.int32)
    mlm = (rng.random((B, T)) < 0.3).astype(np.float32)
    ids = np.where(mlm > 0, 103, labels).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[1, 21:] = 0
    types = np.zeros((B, T), np.int32)
    arrays = (ids, mask, types, labels, mlm)
    jbatch = jbert.Batch(*(jnp.asarray(a) for a in arrays))
    tbatch = tbert.Batch(*(torch.from_numpy(a) for a in arrays))

    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jinit, jstep = jbert.make_train_step(
        jcfg, mesh, optimizer=jupd.make_optimizer("lamb", 1e-3),
        attn_fn=jtfm.attention)
    jstate = jinit(jax.random.key(0))
    tparams = tbert.params_from_numpy(
        jax.tree.map(np.asarray, jstate.params), device="cpu")
    topt = updaters.make_optimizer("lamb", 1e-3)
    _, tstep = tbert.make_train_step(tcfg, optimizer=topt,
                                     attn_fn=ttfm.attention, device="cpu")
    tstate = tbert.TrainState(tparams, topt.init(tparams), 0)
    for i in range(3):
        jstate, jl = jstep(jstate, jbatch, jax.random.key(i))
        tstate, tl = tstep(tstate, tbatch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jstate.params)[0])
    for path, jleaf in jflat.items():
        node = tstate.params
        for entry in path:
            node = node[entry.key]
        err = float(np.abs(node.detach().numpy() - np.asarray(jleaf)).max())
        assert err <= 1e-5, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam", "adamw", "lamb",
                                  "rmsprop"])
def test_gpt_train_step_takes_every_family(name):
    """``gpt.make_train_step(optimizer=)`` trains with each family: two
    steps on ``gpt_tiny``, the loss finite and falling."""
    from deeplearning4j_tpu_torch.models import gpt as tgpt

    cfg = tgpt.gpt_tiny(vocab_size=64, max_len=16)
    init_fn, step_fn = tgpt.make_train_step(
        cfg, optimizer=updaters.make_optimizer(name, 1e-2), device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (2, 16)).astype(np.int32))
    losses = []
    for _ in range(3):
        state, loss = step_fn(state, ids)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam", "adamw", "lamb",
                                  "rmsprop"])
def test_update_matches_leaves_by_key_not_by_order(name):
    """Gradients whose dict holds its keys in another order than the
    params' update each leaf from its own moments and params."""
    rng = np.random.default_rng(2)
    params = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    grads = [{k: torch.from_numpy(v) for k, v in g.items()}
             for g in _grads(rng)[:3]]
    opt = updaters.make_optimizer(name, 1e-2)
    ref_state, got_state = opt.init(params), opt.init(params)
    for g in grads:
        ref, ref_state = opt.update(g, ref_state, params)
        shuffled = {k: g[k] for k in reversed(list(g))}
        got, got_state = opt.update(shuffled, got_state, params)
        for k in params:
            assert torch.equal(got[k], ref[k]), (name, k)
