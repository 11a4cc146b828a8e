"""The port's pipe axis against the JAX reference.

``parallel/pipeline.py``: ``make_pipeline_fn`` (``pipeline_forward``
under it) and its gradients against JAX's at ``(pipe, data)`` = (4, 1)
and (2, 2), at rtol 1e-5; ``make_pipeline_train_step``'s losses against
JAX's; ``split_layers_into_stages`` and the reference's errors.
``bert.make_pipeline_train_step`` against JAX's over two steps.
``CausalLM`` at ``pipe=2`` ``torch.equal`` to ``pipe=1`` at the same
data degree, both within the reference's rtol 1e-4 / atol 1e-5
(``test_parallel_4d.py:139``) of JAX's ``CausalLM`` on the same mesh
shape; ``pipe_microbatches=2`` at ``mesh=None`` against JAX; the MoE
``CausalLM`` on ``pipe=2`` against JAX at capacity factor 8; and the
stage specs of ``test_parallel_4d.py:69-91``.  The port's ranks run as
gloo groups of CPU processes (``test_torch_mesh.run_ranks``); the JAX
side runs on the conftest's virtual devices; weights carry across as
numpy trees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models import lm_fit as jlm
from deeplearning4j_tpu.models import moe as jmoe
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import pipeline as jpl
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.models import lm_fit as tlm
from deeplearning4j_tpu_torch.models import moe as tmoe
from deeplearning4j_tpu_torch.ops.updaters import tree_map
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import pipeline as tpl
from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar
from test_torch_mesh import (AXES_BERT, AXES_LM, bert_step_rank,
                             lm_axes_rank, pipe_fn_rank, run_ranks)

torch.set_num_threads(2)


def _jmesh(**axes):
    n = int(np.prod(list(axes.values())))
    return jmesh.make_mesh(jmesh.MeshSpec(**axes), devices=jax.devices()[:n])


def _jstage(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


def _stacked(n_stages, d, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n_stages, d, d)) * 0.1)
            .astype(np.float32),
            "b": (rng.standard_normal((n_stages, d)) * 0.1).astype(np.float32)}


def _lm_ids(n=2, rows=8, t=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, (rows, t)).astype(np.int32) for _ in range(n)]


def _jax_lm(cfg, ids, mesh, pipe_microbatches=1):
    net = jlm.CausalLM(cfg, lr=0.05, momentum=0.9,
                       pipe_microbatches=pipe_microbatches).init(0)
    p0 = jax.tree.map(np.asarray, net.params)
    net.fit_backprop([JDataSet(jnp.asarray(x), jnp.asarray(x)) for x in ids],
                     num_epochs=2, mesh=mesh)
    return p0, net.params_flat()


@pytest.mark.parametrize("pipe,data", [(4, 1), (2, 2)])
def test_pipeline_fn_and_its_gradients_match_reference(tmp_path, pipe,
                                                        data):
    d, B, n_micro = 8, 8, 4
    stacked = _stacked(pipe, d)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, d)).astype(np.float32)
    y = rng.standard_normal((B, d)).astype(np.float32)
    fwd = jpl.make_pipeline_fn(_jmesh(data=data, pipe=pipe), _jstage,
                               n_micro)
    want = np.asarray(jax.jit(fwd)(stacked, x))
    want_g = jax.jit(jax.grad(lambda p: jnp.mean((fwd(p, x) - y) ** 2)))(
        stacked)
    for out, grads in run_ranks(pipe_fn_rank, pipe * data, tmp_path,
                                dict(data=data, pipe=pipe), stacked, x, y,
                                n_micro):
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(grads[k], np.asarray(want_g[k]),
                                       rtol=1e-5, atol=1e-6)


def test_pipeline_train_step_matches_reference(tmp_path):
    d, B, n_micro = 8, 16, 4
    stacked = _stacked(2, d, seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, d)).astype(np.float32)
    y = (rng.standard_normal((B, d)) * 0.1).astype(np.float32)
    init_opt, step = jpl.make_pipeline_train_step(
        _jmesh(data=2, pipe=2), _jstage, lambda o, t: jnp.mean((o - t) ** 2),
        n_micro, learning_rate=0.05)
    params, opt = jax.tree.map(jnp.asarray, stacked), None
    opt = init_opt(params)
    want = []
    for _ in range(4):
        params, opt, loss = step(params, opt, x, y)
        want.append(float(loss))
    assert want[-1] < want[0]
    for losses, final in run_ranks(pipe_fn_rank, 4, tmp_path,
                                   dict(data=2, pipe=2), stacked, x, y,
                                   n_micro, 4):
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(final[k], np.asarray(params[k]),
                                       rtol=1e-5, atol=1e-6)


def test_split_layers_into_stages_and_the_reference_errors():
    stacked = {"w": torch.zeros(8, 3, 3)}
    out = tpl.split_layers_into_stages(stacked, 4)
    assert tuple(out["w"].shape) == (4, 2, 3, 3) == tuple(
        jpl.split_layers_into_stages({"w": jnp.zeros((8, 3, 3))}, 4)["w"]
        .shape)
    for call, jcall in (
            (lambda: tpl.split_layers_into_stages({"w": torch.zeros(7, 2)}, 4),
             lambda: jpl.split_layers_into_stages({"w": jnp.zeros((7, 2))},
                                                  4)),
            (lambda: tpl.to_microbatches(torch.zeros(6, 2), 4),
             lambda: jpl.to_microbatches(jnp.zeros((6, 2)), 4))):
        with pytest.raises(ValueError) as want:
            jcall()
        with pytest.raises(ValueError) as got:
            call()
        assert str(got.value) == str(want.value)
    micro = tpl.to_microbatches({"a": torch.arange(12).reshape(6, 2)}, 3)
    assert tuple(micro["a"].shape) == (3, 2, 2)
    assert torch.equal(tpl.from_microbatches(micro)["a"],
                       torch.arange(12).reshape(6, 2))
    per = [{"w": torch.full((2,), float(i))} for i in range(3)]
    assert torch.equal(tpl.stack_stage_params(per)["w"],
                       torch.tensor([[0.0] * 2, [1.0] * 2, [2.0] * 2]))
    fake = tmesh.Mesh({"data": 1, "pipe": 2}, None, (0, 1), 0,
                      torch.device("cpu"), "gloo")
    fn = tpl.make_pipeline_fn(fake, lambda p, x: x, 2)
    with pytest.raises(ValueError, match="leading dim 3 != pipe degree 2"):
        fn({"w": torch.zeros(3, 2)}, torch.zeros(4, 2))


@pytest.mark.parametrize("spec", [dict(data=1, pipe=2), dict(data=2, pipe=2)])
def test_bert_pipeline_train_step_matches_reference(tmp_path, spec):
    import optax
    from deeplearning4j_tpu.models import bert as jbert
    from deeplearning4j_tpu.models.transformer import TransformerConfig

    cfg = TransformerConfig(**AXES_BERT)
    params = jbert.init_params(jax.random.key(0), cfg)
    p_np = jax.tree.map(np.asarray, params)
    batch = jbert.synthetic_batch(jax.random.key(1), cfg, 8, 32)
    n = spec["data"] * spec["pipe"]
    opt = optax.adamw(1e-4, weight_decay=0.01)
    _, step_fn = jbert.make_pipeline_train_step(cfg, _jmesh(**spec),
                                                n_micro=2, optimizer=opt)
    pp = dict(params)
    pp["blocks"] = jpl.split_layers_into_stages(params["blocks"], 2)
    state = jbert.TrainState(pp, opt.init(pp), jnp.zeros((), jnp.int32))
    want = []
    for _ in range(2):
        state, loss = step_fn(state, batch)
        want.append(float(loss))
    final = dict(state.params)
    final["blocks"] = jax.tree.map(
        lambda t: t.reshape((-1,) + t.shape[2:]), final["blocks"])
    want_flat = np.concatenate([np.ravel(np.asarray(t))
                                for t in jax.tree.leaves(final)])
    ranks = run_ranks(bert_step_rank, n, tmp_path, p_np,
                      tuple(np.asarray(a) for a in batch), spec, "pipe", 2,
                      2)
    for losses, flat in ranks:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        np.testing.assert_allclose(flat, want_flat, rtol=1e-5, atol=1e-6)


def test_causal_lm_pipe_two_equals_pipe_one_and_matches_reference(tmp_path):
    cfg = dataclasses.replace(jgpt.gpt_tiny(vocab_size=64, max_len=16),
                              **dict(AXES_LM, n_layers=4))
    ids = _lm_ids()
    p0, want = _jax_lm(cfg, ids, _jmesh(data=2, pipe=2), 2)
    piped = run_ranks(lm_axes_rank, 4, tmp_path, dict(data=2, pipe=2), p0,
                      ids, 2, None, 4)
    flat = run_ranks(lm_axes_rank, 2, tmp_path, dict(data=2), p0, ids, 2,
                     None, 4)
    for got in piped + flat:
        assert np.array_equal(got, flat[0])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_pipe_microbatches_at_mesh_none_matches_reference():
    cfg = dataclasses.replace(jgpt.gpt_tiny(vocab_size=64, max_len=16),
                              **AXES_LM)
    ids = _lm_ids(seed=1)
    p0, want = _jax_lm(cfg, ids, None, 2)
    lm = tlm.CausalLM(dataclasses.replace(
        tgpt.gpt_tiny(vocab_size=64, max_len=16), **AXES_LM), lr=0.05,
        momentum=0.9, pipe_microbatches=2, device="cpu")
    lm.params = tree_map(torch.from_numpy, p0)
    lm.fit_backprop([TDataSet(x, x) for x in ids], num_epochs=2)
    np.testing.assert_allclose(lm.params_flat().numpy(), want, rtol=1e-4,
                               atol=1e-5)


def test_moe_causal_lm_on_pipe_matches_reference(tmp_path):
    fields = dict(vocab_size=64, max_len=16, hidden=32, n_layers=2,
                  n_heads=4, d_ff=64, n_experts=4, top_k=2,
                  capacity_factor=8.0, compute_dtype="float32", causal=True)
    ids = _lm_ids(seed=2)
    p0, want = _jax_lm(jmoe.MoETransformerConfig(**fields), ids,
                       _jmesh(data=1, pipe=2))
    for got in run_ranks(lm_axes_rank, 2, tmp_path, dict(data=1, pipe=2),
                         p0, ids, 1, fields):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_pipe_shard_specs_and_divisibility():
    """test_parallel_4d.py:69-91."""
    cfg = dataclasses.replace(tgpt.gpt_tiny(vocab_size=64, max_len=16),
                              **dict(AXES_LM, n_layers=4))
    jcfg = dataclasses.replace(jgpt.gpt_tiny(vocab_size=64, max_len=16),
                               **dict(AXES_LM, n_layers=4))
    specs = tgpt.shard_specs(cfg, model_degree=2, pipe_degree=2)
    for leaf in specs["blocks"].values():
        assert tuple(leaf)[0] == "pipe", leaf
    flat2d = tgpt.shard_specs(cfg, model_degree=2)["blocks"]["wq"]
    assert specs["blocks"]["wq"] == tpar.P("pipe", *tuple(flat2d)[1:])
    assert tgpt.shard_specs(cfg, model_degree=2) \
        == tgpt.shard_specs(cfg, model_degree=2, pipe_degree=1)
    jspecs = jgpt.shard_specs(jcfg, model_degree=2, pipe_degree=2)
    assert {k: tuple(v) for k, v in specs["blocks"].items()} \
        == {k: tuple(v) for k, v in jspecs["blocks"].items()}
    with pytest.raises(ValueError, match="n_layers=4 not divisible"):
        tgpt.shard_specs(cfg, pipe_degree=3)
    mfields = dict(vocab_size=64, hidden=32, n_layers=2, n_heads=4, d_ff=64,
                   n_experts=4, top_k=2)
    mspecs = tmoe.shard_specs(tmoe.MoETransformerConfig(**mfields),
                              expert_degree=2, pipe_degree=2)
    assert tuple(mspecs["blocks"]["wi"])[1] == "expert"
    assert tuple(mspecs["blocks"]["wi"])[0] == "pipe"
    assert tuple(jmoe.shard_specs(jmoe.MoETransformerConfig(**mfields),
                                  expert_degree=2, pipe_degree=2)["blocks"]
                 ["wi"]) == tuple(mspecs["blocks"]["wi"])
    with pytest.raises(ValueError, match="n_experts"):
        tmoe.shard_specs(tmoe.MoETransformerConfig(**mfields),
                         expert_degree=3)
    # a rank's slice of a stacked tree is its stage's contiguous layers
    fake = tmesh.Mesh({"data": 1, "pipe": 2}, None, (0, 1), 0,
                      torch.device("cpu"), "gloo",
                      groups={}, coords={"data": 0, "pipe": 1})
    w = torch.arange(8.0).reshape(4, 2)
    local = tpar.shard_tree({"w": w}, {"w": tpar.P("pipe", None)}, fake)
    assert torch.equal(local["w"], w[2:])
