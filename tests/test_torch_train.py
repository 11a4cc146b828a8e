"""The port's training path against the JAX reference, on shared weights.

JAX's ``bert_tiny`` / ``gpt_tiny`` params (from its own ``init_fn``) are
carried over with ``params_from_numpy``; the same numpy batch goes
through JAX's ``make_train_step`` on a one-device mesh and the port's
``make_train_step`` on the CPU, dropout 0.  Two attention pairs: JAX's
plain ``tfm.attention`` against the port's, and JAX's forced Pallas
kernel (interpreted) against the port's ``flash_attention`` (its
autograd Function, running the plain twins on the CPU).

Tolerances, each with its reason:
- per-step losses: fp32 rtol 1e-4, bf16 rtol 5e-2 (the forward tests');
- first-step gradients, per leaf, max |diff| over max(max |grad|,
  1e-6): fp32 1e-4 (summation order only); bf16 5e-2 (bf16 rounds
  activations and cotangents at other places in the two frameworks).
  The floor is for ``bk``, whose gradient is 0 up to rounding: softmax
  ignores a shift shared by a row's scores;
- params after 3 steps, absolute: fp32 1e-5; bf16 3 lr per step.  Adam
  moves every element by about lr a step whatever its gradient's size,
  so where bf16 rounding flips a near-zero gradient's sign the two
  packages step about 2 lr apart; 3 lr leaves room for Adam's
  early-step ratio.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models import transformer as jtfm
from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.models import transformer as ttfm
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import updaters

torch.set_num_threads(2)

B, T = 2, 32
N_STEPS = 3
LOSS_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
PARAM_TOL_FP32 = 1e-5
PARAM_TOL_BF16_LR = 3.0          # x lr x steps
LR = {"bert": 1e-4, "gpt": 3e-4}     # the default optimizers' rates

ATTN = {
    "plain": (jtfm.attention, ttfm.attention),
    "flash": (jpa.make_attn_fn("pallas", autotune=False), fa.flash_attention),
}


def _one_device_mesh():
    return make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a JAX or port tree."""
    out = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = (val.detach().float().numpy()
                                 if isinstance(val, torch.Tensor)
                                 else np.asarray(val, np.float32))
    return out


def _assert_trees_close(got, ref, tol, relative, what):
    got, ref = _flat(got), _flat(ref)
    assert got.keys() == ref.keys(), (what, got.keys() ^ ref.keys())
    for path in ref:
        err = float(np.abs(got[path] - ref[path]).max())
        bound = (tol * max(float(np.abs(ref[path]).max()), 1e-6)
                 if relative else tol)
        assert err <= bound, f"{what} {path}: max|diff| {err} > {bound}"


# -- the two models, each as (JAX side, port side) --------------------------

def _bert_case(compute_dtype):
    jcfg = dataclasses.replace(jbert.bert_tiny(), compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(tbert.bert_tiny(), compute_dtype=compute_dtype)
    rng = np.random.default_rng(0)
    labels = rng.integers(5, jcfg.vocab_size, (B, T)).astype(np.int32)
    mlm = (rng.random((B, T)) < 0.3).astype(np.float32)
    ids = np.where(mlm > 0, 103, labels).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[1, 21:] = 0
    types = np.zeros((B, T), np.int32)
    types[:, T // 2:] = 1
    arrays = (ids, mask, types, labels, mlm)
    jb = jbert.Batch(*(jnp.asarray(a) for a in arrays))
    tb = tbert.Batch(*(torch.from_numpy(a) for a in arrays))

    def jloss(params, attn):
        return jbert.mlm_loss(jcfg, params, jb, None, attn)

    def tloss(params, attn):
        return tbert.mlm_loss(tcfg, params, tb, None, attn)

    return dict(jmod=jbert, tmod=tbert, jcfg=jcfg, tcfg=tcfg, jbatch=jb,
                tbatch=tb, jloss=jloss, tloss=tloss)


def _gpt_case(compute_dtype):
    jcfg = dataclasses.replace(jgpt.gpt_tiny(), compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(tgpt.gpt_tiny(), compute_dtype=compute_dtype)
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, T)) \
        .astype(np.int32)
    jb, tb = jnp.asarray(ids), torch.from_numpy(ids)

    def jloss(params, attn):
        return jgpt.lm_loss(jcfg, params, jb, None, None, attn)

    def tloss(params, attn):
        return tgpt.lm_loss(tcfg, params, tb, None, None, attn)

    return dict(jmod=jgpt, tmod=tgpt, jcfg=jcfg, tcfg=tcfg, jbatch=jb,
                tbatch=tb, jloss=jloss, tloss=tloss)


CASES = {"bert": _bert_case, "gpt": _gpt_case}


def _start(c):
    """JAX's initial params (its ``init_params`` from key 0, what its
    ``init_fn`` returns) and the port's copy of them."""
    jparams = c["jmod"].init_params(jax.random.key(0), c["jcfg"])
    tparams = c["tmod"].params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return jparams, tparams


@pytest.mark.parametrize("attn", sorted(ATTN))
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", sorted(CASES))
def test_first_step_grads_match_jax(model, compute_dtype, attn):
    c = CASES[model](compute_dtype)
    assert dataclasses.asdict(c["tcfg"]) == dataclasses.asdict(c["jcfg"])
    jattn, tattn = ATTN[attn]
    jparams, tparams = _start(c)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: c["jloss"](p, jattn)))(jparams)
    tloss, tgrads = ttfm.value_and_grad(lambda p: c["tloss"](p, tattn),
                                        tparams)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=LOSS_TOL[compute_dtype])
    _assert_trees_close(tgrads, jgrads, GRAD_TOL[compute_dtype], True,
                        "first-step grad")


@pytest.mark.parametrize("attn", sorted(ATTN))
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", sorted(CASES))
def test_train_steps_match_jax(model, compute_dtype, attn):
    """Three steps of each package's ``make_train_step`` with its default
    optimizer (adamw, lr 1e-4 for BERT and 3e-4 for GPT)."""
    c = CASES[model](compute_dtype)
    jattn, tattn = ATTN[attn]
    jinit, jstep = c["jmod"].make_train_step(c["jcfg"], _one_device_mesh(),
                                             attn_fn=jattn)
    jstate = jinit(jax.random.key(0))
    _, tparams = _start(c)
    _, tstep = c["tmod"].make_train_step(c["tcfg"], attn_fn=tattn,
                                         device="cpu")
    tstate = c["tmod"].TrainState(
        tparams, updaters.adamw(LR[model]).init(tparams), 0)
    jlosses, tlosses = [], []
    for i in range(N_STEPS):
        jstate, jl = jstep(jstate, c["jbatch"], jax.random.key(i))
        tstate, tl = tstep(tstate, c["tbatch"])
        jlosses.append(float(jl))
        tlosses.append(float(tl))
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_TOL[compute_dtype])
    assert tstate.step == N_STEPS and tstate.opt_state.count == N_STEPS
    tol = (PARAM_TOL_FP32 if compute_dtype == "float32"
           else PARAM_TOL_BF16_LR * LR[model] * N_STEPS)
    _assert_trees_close(tstate.params, jstate.params, tol, False,
                        "params after 3 steps")


# -- the optimizer -----------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(learning_rate=1e-4, weight_decay=0.01),
    dict(learning_rate=3e-3, weight_decay=0.1, b1=0.8, b2=0.99, eps=1e-6),
], ids=["bert-default", "other-hyperparameters"])
def test_adamw_matches_optax(kwargs):
    """10 steps on a random fp32 tree, rtol 1e-6: the same per-leaf
    arithmetic in the same order as optax 0.2.6."""
    rng = np.random.default_rng(7)

    def tree(scale=1.0):
        return {"blocks": {"w": scale * rng.standard_normal((3, 5, 7)),
                           "b": 1e-3 * scale * rng.standard_normal((3, 7))},
                "embed": {"tok": scale * rng.standard_normal((11, 5))}}

    def f32(t):
        return jax.tree.map(lambda a: np.asarray(a, np.float32), t)

    params = f32(tree())
    grads = [f32(tree(0.1)) for _ in range(10)]
    opt = optax.adamw(**kwargs)
    jp = jax.tree.map(jnp.asarray, params)
    js = opt.init(jp)
    topt = updaters.adamw(**kwargs)
    tp = updaters.tree_map(torch.from_numpy, params)
    ts = topt.init(tp)
    for g in grads:
        u, js = opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = topt.update(updaters.tree_map(torch.from_numpy, g), ts, tp)
        tp = updaters.apply_updates(tp, tu)
    assert ts.count == int(js[0].count) == 10
    for got, ref in ((tp, jp), (ts.mu, js[0].mu), (ts.nu, js[0].nu)):
        got, ref = _flat(got), _flat(ref)
        for path in ref:
            np.testing.assert_allclose(got[path], ref[path], rtol=1e-6,
                                       atol=0, err_msg=path)


def test_tree_helpers_round_trip():
    t = {"b": {"y": torch.ones(2), "x": torch.zeros(3)}, "a": torch.ones(1)}
    leaves = updaters.tree_leaves(t)
    assert [x.shape[0] for x in leaves] == [2, 3, 1]
    back = updaters.tree_unflatten(t, [x + 1 for x in leaves])
    assert torch.equal(back["b"]["x"], torch.ones(3))
    doubled = updaters.tree_map(lambda a, b: a + b, t, t)
    assert torch.equal(doubled["a"], torch.full((1,), 2.0))


# -- the training entry points -----------------------------------------------

@pytest.mark.parametrize("model", ["bert", "gpt"])
def test_loss_goes_down(model):
    """8 steps of the default step (port init, flash attention through its
    CPU plain twins) on one fixed batch: the loss falls."""
    if model == "bert":
        cfg = tbert.bert_tiny()
        init, step = tbert.make_train_step(cfg, attn_fn=fa.flash_attention,
                                           device="cpu")
        batch = tbert.synthetic_batch(0, cfg, 4, 32, device="cpu")
    else:
        cfg = tgpt.gpt_tiny()
        init, step = tgpt.make_train_step(cfg, attn_fn=fa.flash_attention,
                                          device="cpu")
        batch = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 32)).astype(np.int32))
    state = init(torch.Generator().manual_seed(0))
    assert state.step == 0 and state.opt_state.count == 0
    losses = []
    for _ in range(8):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 1e-3, losses
    assert state.step == 8


def test_n_steps_equals_repeated_single_steps():
    """``n_steps=3`` (JAX's scan) returns the three losses of three
    single steps and the same params."""
    cfg = tbert.bert_tiny()
    batch = tbert.synthetic_batch(2, cfg, 2, 16, device="cpu")
    init, step1 = tbert.make_train_step(cfg, device="cpu")
    _, step3 = tbert.make_train_step(cfg, n_steps=3, device="cpu")
    s1 = s3 = init(torch.Generator().manual_seed(0))
    singles = []
    for _ in range(3):
        s1, loss = step1(s1, batch)
        singles.append(loss)
    s3, losses = step3(s3, batch)
    assert torch.equal(torch.stack(singles), losses)
    for a, b in zip(updaters.tree_leaves(s1.params),
                    updaters.tree_leaves(s3.params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="n_steps"):
        tbert.make_train_step(cfg, n_steps=0, device="cpu")


def test_dropout_training_needs_and_uses_its_generator():
    cfg = dataclasses.replace(tbert.bert_tiny(), dropout=0.1)
    init, step = tbert.make_train_step(cfg, device="cpu")
    state = init(torch.Generator().manual_seed(0))
    batch = tbert.synthetic_batch(0, cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="torch.Generator"):
        step(state, batch)
    _, l1 = step(state, batch, torch.Generator().manual_seed(1))
    _, l2 = step(state, batch, torch.Generator().manual_seed(1))
    _, l3 = step(state, batch, torch.Generator().manual_seed(2))
    assert torch.equal(l1, l2) and not torch.equal(l1, l3)


def test_gpt_params_and_config_match_jax():
    """gpt_config is GPT-2 small as in JAX; init refuses a non-causal
    config; the GPT tree (no mlm, no pooler, one token type) carries over
    with params_from_numpy and has JAX's shapes."""
    assert dataclasses.asdict(tgpt.gpt_config()) == \
        dataclasses.asdict(jgpt.gpt_config())
    assert dataclasses.asdict(tgpt.gpt_tiny()) == \
        dataclasses.asdict(jgpt.gpt_tiny())
    with pytest.raises(ValueError, match="causal"):
        tgpt.init_params(torch.Generator(), tbert.bert_tiny(), "cpu")
    cfg = tgpt.gpt_tiny()
    ref = jax.eval_shape(lambda: jgpt.init_params(jax.random.key(0),
                                                  jgpt.gpt_tiny()))
    got = tgpt.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k: sorted(v) for k, v in got.items()} == \
        {k: sorted(v) for k, v in ref.items()}
    for grp in ref:
        for name, sd in ref[grp].items():
            assert tuple(got[grp][name].shape) == sd.shape
    tree = jax.tree.map(np.asarray, jgpt.init_params(jax.random.key(1),
                                                     jgpt.gpt_tiny()))
    carried = tgpt.params_from_numpy(tree, device="cpu")
    assert set(carried) == {"embed", "blocks"}
    assert carried["embed"]["type"].shape == (1, cfg.hidden)
    del tree["embed"]["pos"]
    with pytest.raises(KeyError, match="embed/pos"):
        tgpt.params_from_numpy(tree, device="cpu")


def test_train_entry_points_default_to_cuda_and_refuse_a_mesh():
    # a pipe or seq axis is ported: the step builds, replicated over it
    # (BERT's pipeline and sequence-parallel steps are their own); an
    # axis the reference's MeshSpec lacks is refused
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh
    for mod, cfg in ((tbert, tbert.bert_tiny()), (tgpt, tgpt.gpt_tiny())):
        for axis in ("pipe", "seq"):
            fake = tmesh.Mesh({"data": 1, axis: 2}, None, (0, 1), 0,
                              torch.device("cpu"), "gloo")
            _, step = mod.make_train_step(cfg, mesh=fake, device="cpu")
            assert tuple(step.specs["blocks"]["wq"])[0] is None
        with pytest.raises(ValueError, match="the axes are"):
            mod.make_train_step(cfg, mesh=types.SimpleNamespace(
                shape={"data": 1, "rows": 2}), device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                mod.make_train_step(cfg)


# -- the stacked-weight backward and remat ----------------------------------

def _tiny(model, **kw):
    cfg = (tbert.bert_tiny() if model == "bert" else tgpt.gpt_tiny())
    return dataclasses.replace(cfg, **kw)


def _live_params(model, cfg):
    mod = tbert if model == "bert" else tgpt
    params = mod.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return updaters.tree_map(lambda p: p.detach().requires_grad_(True),
                             params)


def _encode_backward_ops(n_layers):
    """{op: count} of the backward of an ``n_layers`` encode, profiled."""
    from torch.profiler import profile

    cfg = _tiny("bert", n_layers=n_layers, remat=False)
    live = _live_params("bert", cfg)
    batch = tbert.synthetic_batch(0, cfg, 2, 16, device="cpu")
    h = ttfm.encode(cfg, live, batch.token_ids, batch.attention_mask,
                    batch.type_ids)
    with profile() as prof:
        torch.autograd.grad(h.sum(), updaters.tree_leaves(live["blocks"]))
    return {e.key: e.count for e in prof.key_averages()}


def test_stacked_weight_backward_does_not_grow_with_depth():
    """Each stacked [L, ...] leaf is unbound once a forward, so its
    gradient is stacked once: no select_backward (a full-size zero
    gradient per layer), and as many zero fills at depth 8 as at 2."""
    ops2, ops8 = _encode_backward_ops(2), _encode_backward_ops(8)
    assert ops8.get("aten::select_backward", 0) == 0
    assert ops8.get("aten::zeros", 0) == ops2.get("aten::zeros", 0)
    assert ops8.get("aten::stack", 0) == len(ttfm._ENCODER_TREE["blocks"])


def _loss_and_grads(model, cfg, seed):
    """Loss, gradients and the generator after one dropout forward and
    backward of ``cfg`` from a generator seeded with ``seed``."""
    live = _live_params(model, cfg)
    gen = torch.Generator().manual_seed(seed)
    if model == "bert":
        batch = tbert.synthetic_batch(0, cfg, 2, 16, device="cpu")
        loss = tbert.mlm_loss(cfg, live, batch, gen, ttfm.attention)
    else:
        ids = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 16)).astype(np.int32))
        loss = tgpt.lm_loss(cfg, live, ids, None, gen, ttfm.attention)
    grads = torch.autograd.grad(loss, updaters.tree_leaves(live),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), grads, gen


@pytest.mark.parametrize("model", ["bert", "gpt"])
def test_remat_replays_the_dropout_masks_exactly(model):
    """remat on and off give bit-equal losses and gradients under dropout
    from the same generator (fp32 on the CPU: the recompute runs the same
    kernels on the same inputs and the same masks), and leave the
    caller's generator in the same state."""
    got, ref = (_loss_and_grads(model, _tiny(model, n_layers=3,
                                             dropout=0.1, remat=remat), 7)
                for remat in (True, False))
    assert torch.equal(got[0], ref[0])
    for g, r in zip(got[1], ref[1]):
        assert torch.equal(g, r)
    assert torch.equal(got[2].get_state(), ref[2].get_state())
    # the masks were drawn: the generator moved, and another seed differs
    assert not torch.equal(got[2].get_state(),
                           torch.Generator().manual_seed(7).get_state())
    other = _loss_and_grads(model, _tiny(model, n_layers=3, dropout=0.1), 8)
    assert not torch.equal(got[0], other[0])


@pytest.mark.parametrize("grad", [True, False])
def test_remat_checkpoints_each_block_only_with_grad(grad, monkeypatch):
    """Training (grad on) checkpoints each of the L blocks; serving
    (no_grad) never does, and its output does not depend on remat."""
    calls = []
    real = ttfm._checkpoint.checkpoint

    def counting(*args, **kwargs):
        calls.append(kwargs.get("use_reentrant"))
        return real(*args, **kwargs)

    monkeypatch.setattr(ttfm._checkpoint, "checkpoint", counting)
    cfg = _tiny("bert", n_layers=3)
    params = tbert.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = tbert.synthetic_batch(0, cfg, 2, 16, device="cpu")
    with torch.set_grad_enabled(grad):
        h = ttfm.encode(cfg, params, batch.token_ids, batch.attention_mask,
                        batch.type_ids)
        h0 = ttfm.encode(dataclasses.replace(cfg, remat=False), params,
                         batch.token_ids, batch.attention_mask,
                         batch.type_ids)
    assert calls == ([False] * cfg.n_layers if grad else [])
    assert torch.equal(h, h0)
