"""The port's BERT forward against the JAX reference, on shared weights.

JAX's ``bert_tiny`` params are carried over with ``params_from_numpy``;
the same numpy batch goes through both forwards.  Two attention pairs:
JAX's plain ``tfm.attention`` against the port's, and JAX's forced
Pallas kernel (interpreted) against the port's flash path (its plain
twin on the CPU).  Tolerances: fp32 1e-4; bf16 5e-2 on logits with at
least 99% fill-mask argmax agreement.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.models import transformer as jtfm
from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu.runtime import checkpoint as jckpt
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.models import transformer as ttfm
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.runtime import checkpoint as tckpt

torch.set_num_threads(2)

B, T = 4, 32


def _configs(compute_dtype):
    jcfg = dataclasses.replace(jbert.bert_tiny(), compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(tbert.bert_tiny(), compute_dtype=compute_dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _batch(cfg):
    rng = np.random.default_rng(0)
    ids = rng.integers(5, cfg.vocab_size, (B, T)).astype(np.int32)
    ids[rng.random((B, T)) < 0.15] = 103
    mask = np.ones((B, T), np.float32)
    mask[1, 20:] = 0
    mask[3, 9:] = 0
    types = np.zeros((B, T), np.int32)
    types[:, T // 2:] = 1
    jb = jbert.Batch(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types),
                     jnp.asarray(ids), jnp.asarray(mask))
    tb = tbert.Batch(*(torch.from_numpy(a) for a in
                       (ids, mask, types, ids, mask)))
    return jb, tb


@pytest.fixture(scope="module")
def jax_params():
    return {cdt: jbert.init_params(jax.random.key(0), _configs(cdt)[0])
            for cdt in ("float32", "bfloat16")}


ATTN = {
    "plain": (jtfm.attention, ttfm.attention),
    "flash": (jpa.make_attn_fn("pallas", autotune=False), fa.flash_attention),
}


@pytest.mark.parametrize("attn", sorted(ATTN))
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(jax_params, compute_dtype, attn):
    jcfg, tcfg = _configs(compute_dtype)
    jp = jax_params[compute_dtype]
    tp = tbert.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jb, tb = _batch(jcfg)
    jattn, tattn = ATTN[attn]

    jh = jbert.forward_hidden(jcfg, jp, jb, attn_fn=jattn)
    jl = np.asarray(jbert.mlm_logits(jcfg, jp, jh))
    jloss = float(jbert.mlm_loss_from_hidden(jcfg, jp, jh, jb))
    th = tbert.forward_hidden(tcfg, tp, tb, attn_fn=tattn)
    tl = tbert.mlm_logits(tcfg, tp, th).numpy()
    tloss = float(tbert.mlm_loss_from_hidden(tcfg, tp, th, tb))

    assert th.dtype == torch.float32 and tl.shape == (B, T, tcfg.vocab_size)
    if compute_dtype == "float32":
        np.testing.assert_allclose(th.numpy(), np.asarray(jh),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    else:
        np.testing.assert_allclose(tl, jl, rtol=5e-2, atol=5e-2)
        assert (tl.argmax(-1) == jl.argmax(-1)).mean() >= 0.99
        np.testing.assert_allclose(tloss, jloss, rtol=5e-2)


def test_serving_apply_matches_jax(jax_params):
    """The serving forward (flash dispatch, all-ones mask) against JAX's
    ``make_serving_apply`` on the same ids."""
    jcfg, tcfg = _configs("bfloat16")
    jp = jax_params["bfloat16"]
    tp = tbert.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (3, 16)) \
        .astype(np.int32)
    japply, _ = jbert.make_serving_apply(jcfg)
    jl = np.asarray(japply(jp, jnp.asarray(ids)))
    tl = tbert.make_serving_apply(tcfg)(tp, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=5e-2, atol=5e-2)
    assert (tl.argmax(-1) == jl.argmax(-1)).mean() >= 0.99


def test_checkpoint_roundtrip_through_numpy_reader(jax_params, tmp_path):
    """A JAX ``save_pytree`` file read back without JAX gives the same
    tree, and a port forward on it equals one on the in-memory carry."""
    jp = jax_params["float32"]
    path = str(tmp_path / "bert.npz")
    jckpt.save_pytree(path, jp, meta={"step": 3})
    tree = tckpt.load_numpy_tree(path)
    flat_ref = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
                for kp, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = v
    walk(tree, "")
    assert flat.keys() == flat_ref.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], flat_ref[k])

    _, tcfg = _configs("float32")
    _, tb = _batch(tcfg)
    a = tbert.forward_hidden(tcfg, tbert.params_from_numpy(tree, "cpu"), tb)
    b = tbert.forward_hidden(
        tcfg, tbert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        tb)
    assert torch.equal(a, b)


def test_params_from_numpy_names_missing_leaves(jax_params):
    tree = jax.tree.map(np.asarray, jax_params["float32"])
    del tree["blocks"]["w1"], tree["mlm"]["out_b"]
    with pytest.raises(KeyError, match="blocks/w1.*mlm/out_b"):
        tbert.params_from_numpy(tree, device="cpu")


def test_init_params_matches_jax_tree():
    """Same leaf names, shapes and dtypes as the JAX init, drawn from a
    torch.Generator (same seed -> same params)."""
    jcfg, tcfg = _configs("bfloat16")
    ref = jax.eval_shape(lambda: jbert.init_params(jax.random.key(0), jcfg))
    p1 = tbert.init_params(torch.Generator().manual_seed(5), tcfg, "cpu")
    p2 = tbert.init_params(torch.Generator().manual_seed(5), tcfg, "cpu")
    for grp, leaves in ref.items():
        assert set(leaves) == set(p1[grp])
        for name, sd in leaves.items():
            assert tuple(p1[grp][name].shape) == sd.shape
            assert p1[grp][name].dtype == torch.float32
            assert torch.equal(p1[grp][name], p2[grp][name])
    w = p1["blocks"]["wq"]
    assert w.abs().max() <= 0.04 and 0.01 < w.std() < 0.02


def test_synthetic_batch_and_loss():
    _, tcfg = _configs("float32")
    b = tbert.synthetic_batch(0, tcfg, 2, 16, device="cpu")
    b2 = tbert.synthetic_batch(0, tcfg, 2, 16, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(b, b2))
    assert torch.equal(b.token_ids[b.mlm_mask > 0],
                       torch.full_like(b.token_ids[b.mlm_mask > 0], 103))
    p = tbert.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    loss = tbert.mlm_loss_from_hidden(
        tcfg, p, tbert.forward_hidden(tcfg, p, b), b)
    assert torch.isfinite(loss) and 5.0 < float(loss) < 9.0  # ~log(1024)


def test_dropout_draws_from_the_generator():
    _, tcfg = _configs("float32")
    tcfg = dataclasses.replace(tcfg, dropout=0.1)
    p = tbert.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    b = tbert.synthetic_batch(0, tcfg, 2, 16, device="cpu")
    h0 = tbert.forward_hidden(tcfg, p, b)
    h1 = tbert.forward_hidden(tcfg, p, b, torch.Generator().manual_seed(1))
    h2 = tbert.forward_hidden(tcfg, p, b, torch.Generator().manual_seed(1))
    assert torch.equal(h1, h2) and not torch.equal(h0, h1)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbert.init_params(torch.Generator(), tbert.bert_tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbert.synthetic_batch(0, tbert.bert_tiny(), 1, 4)
