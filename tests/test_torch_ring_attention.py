"""The port's seq axis against the JAX reference.

``parallel/ring_attention.py``: ``ring_attention`` (causal, full, and
with a padding mask) and its gradients against JAX's ``ring_attention``
inside ``shard_map`` on the conftest's virtual devices, at 2e-5, in both
block forms (the plain block, and the flash block run through the
kernels' plain twins, ``flash_attention_fwd_plain`` / ``_bwd_plain``);
``ulysses_attention`` against JAX's.  ``make_attn_fn``'s ring decisions
and errors (the reference's ``test_parallel_4d.py:201-217``).
``CausalLM`` on ``data=2 x seq=2`` against JAX's on the same mesh shape
at the reference's 1e-4 / 1e-5, and ``bert.make_sp_train_step`` against
JAX's.  The port's ranks run as gloo groups of CPU processes
(``test_torch_mesh.run_ranks``); the inputs are numpy arrays drawn from
a seed, the same on both sides.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from deeplearning4j_tpu.compat import shard_map
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import ring_attention as jra
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import kernel_select as ks
from test_torch_mesh import (AXES_BERT, AXES_LM, bert_sp_rank, lm_seq_rank,
                             ring_rank, run_ranks)

torch.set_num_threads(2)

TOL = 2e-5


def _qkv(T=16, B=2, H=4, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, T, H, D)).astype(np.float32)
                 for _ in range(3))


def _mask(case, B, T):
    if case != "padded":
        return np.ones((B, T), np.float32)
    m = np.ones((B, T), np.float32)
    m[:, T - 6:] = 0.0          # the last keys of every row padded
    return m


def _jax_seq(fn, n, q, k, v, mask, w, grad_of=None):
    """JAX's ``fn`` under ``shard_map`` on a ``seq=n`` mesh: the output
    and the gradients of ``sum(out * w)`` in q, k, v (of ``grad_of(q, k,
    v, mask)`` instead, when given: the same function unsharded)."""
    mesh = jmesh.make_mesh(jmesh.MeshSpec(data=1, seq=n),
                           devices=jax.devices()[:n])
    spec = JP(None, jmesh.SEQ_AXIS, None, None)
    f = shard_map(fn, mesh=mesh,
                  in_specs=(spec, spec, spec, JP(None, jmesh.SEQ_AXIS)),
                  out_specs=spec, check_vma=False)
    out = jax.jit(f)(q, k, v, mask)
    g_fn = grad_of or f
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(g_fn(a, b, c, mask) * w),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


# ---------------------------------------------------------------------------
# configs (the port's twins are test_torch_mesh.axes_lm_cfg / axes_bert_cfg)
# ---------------------------------------------------------------------------

def _lm_cfg():
    from deeplearning4j_tpu.models import gpt
    return dataclasses.replace(gpt.gpt_tiny(vocab_size=64, max_len=16),
                               **AXES_LM)


def _bert_cfg():
    from deeplearning4j_tpu.models.transformer import TransformerConfig
    return TransformerConfig(**AXES_BERT)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["full", "causal", "padded"])
def test_ring_attention_and_its_gradients_match_reference(tmp_path, case):
    n = 4
    q, k, v = _qkv(seed=1)
    mask = _mask(case, q.shape[0], q.shape[1])
    w = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    causal = case == "causal"
    want, want_g = _jax_seq(
        lambda a, b, c, m: jra.ring_attention(a, b, c, m, causal,
                                              jmesh.SEQ_AXIS), n, q, k, v,
        mask, w)
    ranks = run_ranks(ring_rank, n, tmp_path, (q, k, v, mask, w), causal,
                      "ring")
    for block in ("plain", "flash"):
        got = np.concatenate([res[block][0] for res in ranks], axis=1)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        for i in range(3):
            g = np.concatenate([res[block][1][i] for res in ranks], axis=1)
            np.testing.assert_allclose(g, want_g[i], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_reference(tmp_path, causal):
    # the gradients against those of the reference's unsharded attention
    # (JAX's own VJP of its untiled all_to_all under shard_map fails on
    # the cotangent's shape)
    from deeplearning4j_tpu.models.transformer import attention
    n = 2
    q, k, v = _qkv(seed=3)
    mask = _mask("padded", q.shape[0], q.shape[1])
    w = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    want, want_g = _jax_seq(
        lambda a, b, c, m: jra.ulysses_attention(a, b, c, m, causal,
                                                 jmesh.SEQ_AXIS), n, q, k,
        v, mask, w,
        grad_of=lambda a, b, c, m: attention(a, b, c, m, causal=causal))
    ranks = run_ranks(ring_rank, n, tmp_path, (q, k, v, mask, w), causal,
                      "ulysses")
    for block in ("plain", "flash"):
        got = np.concatenate([res[block][0] for res in ranks], axis=1)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        for i in range(3):
            g = np.concatenate([res[block][1][i] for res in ranks], axis=1)
            np.testing.assert_allclose(g, want_g[i], rtol=TOL, atol=TOL)


def test_make_attn_fn_ring_decisions_and_errors():
    """test_parallel_4d.py:201-217: on a seq-sharded mesh "auto" is the
    ring; a forced ring without a sharded sequence axis and a forced
    kernel on one refuse."""
    assert "ring" in ks.ATTN_KERNELS and ks.KERNELS == ("auto", "cuda",
                                                        "plain")
    seq = types.SimpleNamespace(shape={"data": 2, "model": 2, "seq": 2})
    flat = types.SimpleNamespace(shape={"data": 2, "model": 2})
    shape = (8, 16, 4, 8)
    for dev in ("cpu", "cuda"):
        d = fa.make_attn_fn("auto", mesh=seq).describe(shape, shape, True,
                                                       device=dev)
        assert d.impl == "ring" and "seq=2" in d.source
        assert fa.make_attn_fn("plain", mesh=seq).describe(
            shape, shape, device=dev).impl == "ring"
    assert fa.make_attn_fn("auto", mesh=flat).describe(
        shape, shape, device="cpu").impl == "plain"
    with pytest.raises(ValueError, match="no sharded sequence axis"):
        fa.make_attn_fn("ring", mesh=flat).describe(shape, shape, True)
    with pytest.raises(ValueError, match="ring attention owns"):
        fa.make_attn_fn("cuda", mesh=seq).describe(shape, shape, True)
    with pytest.raises(ValueError, match="kernel must be one of"):
        fa.make_attn_fn("pallas")
    with pytest.raises(ValueError, match="kernel must be one of"):
        ks.resolve_attn_kernel("xla", aligned=True, on_cuda=False)
    assert ks.resolve_attn_kernel("auto", aligned=True, on_cuda=True) \
        == "cuda"


def test_causal_lm_on_data_and_seq_matches_reference(tmp_path):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.models import lm_fit as jlm

    rng = np.random.RandomState(0)
    ids = [rng.randint(0, 64, (8, 16)).astype(np.int32) for _ in range(2)]
    jnet = jlm.CausalLM(_lm_cfg(), lr=0.05, momentum=0.9).init(0)
    p0 = jax.tree.map(np.asarray, jnet.params)
    jnet.fit_backprop([JDataSet(jnp.asarray(x), jnp.asarray(x))
                       for x in ids], num_epochs=2,
                      mesh=jmesh.make_mesh(jmesh.MeshSpec(data=2, seq=2),
                                           devices=jax.devices()[:4]))
    want = jnet.params_flat()
    ranks = run_ranks(lm_seq_rank, 4, tmp_path, p0, ids)
    for got in ranks:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got, ranks[0])


@pytest.mark.parametrize("spec", [dict(data=1, seq=2),
                                  dict(data=2, seq=2)])
def test_bert_sp_train_step_matches_reference(tmp_path, spec):
    import optax
    from deeplearning4j_tpu.models import bert as jbert

    cfg = _bert_cfg()
    params = jbert.init_params(jax.random.key(0), cfg)
    batch = jbert.synthetic_batch(jax.random.key(1), cfg, 4, 32)
    n = spec["data"] * spec["seq"]
    mesh = jmesh.make_mesh(jmesh.MeshSpec(**spec), devices=jax.devices()[:n])
    init_fn, step_fn = jbert.make_sp_train_step(
        cfg, mesh, optimizer=optax.adamw(1e-4, weight_decay=0.01))
    state = jbert.TrainState(params, optax.adamw(1e-4, weight_decay=0.01)
                             .init(params), jnp.zeros((), jnp.int32))
    p_np = jax.tree.map(np.asarray, params)
    want = []
    for _ in range(2):
        state, loss = step_fn(state, batch)
        want.append(float(loss))
    want_flat = np.concatenate([np.ravel(np.asarray(x)) for x in
                                jax.tree.leaves(state.params)])
    batch_np = tuple(np.asarray(a) for a in batch)
    ranks = run_ranks(bert_sp_rank, n, tmp_path, p_np, batch_np, spec)
    for losses, flat in ranks:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        np.testing.assert_allclose(flat, want_flat, rtol=1e-5, atol=1e-6)
