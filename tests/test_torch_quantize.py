"""The port's post-training quantization and int8 KV cache against the
JAX reference (``runtime/quantize.py``, ``models/gpt.py:172-205``), on
the CPU and on the same numpy trees.

Held: per-channel scales within 1e-6 relative; int8 values equal except
off by one at a rounding boundary, in at most 0.1% of them (``x /
scale`` may differ by an ulp between the libraries); norm and bias
leaves left alone, and the bf16 mode; the round trip within ``scale /
2`` (``tests/test_serving_tier2.py:70``); ``_kv_quant``/``_kv_load``;
int8-KV prefill within the reference's drift bound of the fp32 cache and
int8-KV slot decoding against JAX's (:204); ``slots_bytes_per_slot``
against the arrays (:238); the int8 engines against the dequantized
tree (:163, :597).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.runtime import quantize as jqz
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.runtime import quantize as tqz
from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
from test_torch_decode import _slot_case, both, numpy_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fp32():
    return both("float32")


def _int8_close(got_q, ref_q, what):
    """int8 payloads: equal, or off by one in at most 0.1% of entries."""
    got = got_q.numpy().astype(np.int32)
    ref = np.asarray(ref_q).astype(np.int32)
    assert got.shape == ref.shape, what
    diff = np.abs(got - ref)
    assert diff.max() <= 1, (what, diff.max())
    assert (diff > 0).mean() <= 1e-3, (what, (diff > 0).mean())


def _scales_close(got, ref, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0, err_msg=what)


def test_quantize_leaf_matches_jax():
    rng = np.random.RandomState(0)
    leaves = {
        "2-D, channel ranges apart": (rng.randn(64, 16)
                                      * rng.gamma(2.0, 2.0, size=16)),
        "3-D stacked": rng.randn(3, 32, 8) * np.array([1, 10, 100])[:, None,
                                                                    None],
        "4-D stacked": rng.randn(2, 16, 4, 8),
        "a zero channel": np.concatenate([rng.randn(8, 3),
                                          np.zeros((8, 1))], 1),
    }
    for what, w in leaves.items():
        w = w.astype(np.float32)
        ref = jqz.quantize_leaf(jnp.asarray(w))
        got = tqz.quantize_leaf(torch.from_numpy(w))
        assert got.q.dtype == torch.int8 and got.q.shape == w.shape
        assert got.scale.shape == ref.scale.shape
        _scales_close(got.scale, ref.scale, what)
        _int8_close(got.q, ref.q, what)
        # the round trip is off by at most scale / 2 (:70)
        sb = got.scale.reshape(tqz._scale_bshape(w.ndim, got.scale))
        err = (tqz.dequantize_leaf(got) - torch.from_numpy(w)).abs()
        assert bool((err <= sb / 2 + 1e-5 * sb).all()), what
        np.testing.assert_allclose(
            tqz.dequantize_leaf(got).numpy(),
            np.asarray(jqz.dequantize_leaf(ref)), rtol=1e-6,
            atol=float(got.scale.max()) * 1.0001, err_msg=what)
    zero = tqz.quantize_leaf(torch.zeros(8, 4))
    assert bool((tqz.dequantize_leaf(zero) == 0).all())


def test_quantize_tree_matches_jax(fp32):
    """The GPT tree in both packages: the same leaves quantized, the
    same left alone (norm and bias leaves, 1-D leaves), equal payloads
    and scales; bf16 casts; None passes the tree through."""
    _, jp, _, tp = fp32
    jq = jqz.quantize_tree(jp, "int8")
    tq = tqz.quantize_tree(tp, "int8")
    for grp in tp:
        for name, leaf in tq[grp].items():
            ref = jq[grp][name]
            what = f"{grp}/{name}"
            assert isinstance(leaf, tqz.QTensor) == isinstance(
                ref, jqz.QTensor), what
            if isinstance(leaf, tqz.QTensor):
                _int8_close(leaf.q, ref.q, what)
                _scales_close(leaf.scale, ref.scale, what)
            else:
                assert leaf is tp[grp][name], what     # untouched
    assert isinstance(tq["blocks"]["wq"], tqz.QTensor)
    for name in ("ln1_g", "ln1_b", "bq", "b1", "ln2_g"):
        assert not isinstance(tq["blocks"][name], tqz.QTensor), name
    assert tq["embed"]["ln_g"].dtype == torch.float32
    assert tqz.tree_bytes(tq) < 0.5 * tqz.tree_bytes(tp)
    assert tqz.tree_bytes(tq) == jqz.tree_bytes(jq)
    dq = tqz.dequantize_tree(tq)
    assert dq.keys() == tp.keys() and dq["embed"]["tok"].dtype == \
        torch.float32
    assert tqz.dequantize_tree(tq, torch.bfloat16)["blocks"]["w1"].dtype \
        == torch.bfloat16
    bf = tqz.quantize_tree(tp, "bf16")
    jbf = jqz.quantize_tree(jp, "bf16")
    for grp in tp:
        for name, leaf in bf[grp].items():
            assert str(leaf.dtype).split(".")[-1] == \
                str(jbf[grp][name].dtype), f"{grp}/{name}"
    assert bf["blocks"]["ln1_g"].dtype == torch.bfloat16     # 2-D, stacked
    assert bf["embed"]["ln_g"].dtype == torch.float32        # 1-D
    assert tqz.quantize_tree(tp, None) is tp
    with pytest.raises(ValueError, match="quantize mode"):
        tqz.quantize_tree(tp, "fp4")


def test_int8_skips_stacked_norm_and_bias_leaves():
    """A shape-only rule would share one scale across the stacked gains
    and round the small layer to zeros; the name rule keeps them."""
    ln = torch.cat([torch.full((1, 4), 0.01), torch.full((1, 4), 100.0)])
    tree = {"blocks": {"ln1_g": ln, "bq": torch.ones(2, 2, 4),
                       "wq": torch.ones(2, 4, 2, 2)},
            "layers": [{"W": torch.ones(3, 2), "b": torch.ones(1, 2)}]}
    qp = tqz.quantize_tree(tree, "int8")
    assert qp["blocks"]["ln1_g"] is ln and qp["blocks"]["bq"] is \
        tree["blocks"]["bq"]
    assert isinstance(qp["blocks"]["wq"], tqz.QTensor)
    assert isinstance(qp["layers"][0]["W"], tqz.QTensor)
    assert not isinstance(qp["layers"][0]["b"], tqz.QTensor)
    dq = tqz.dequantize_leaf(tqz.quantize_leaf(ln))
    assert float(dq[0].abs().max()) == 0.0


def test_quant_memo_keys_on_identity():
    memo, calls = tqz.QuantMemo(), []
    a, b = {"w": torch.ones(2, 2)}, {"w": torch.ones(2, 2)}

    def f(t):
        calls.append(t)
        return len(calls)

    assert memo.get(a, f) == 1 and memo.get(a, f) == 1
    assert memo.get(b, f) == 2 and memo.get(a, f) == 3


def test_kv_quant_and_load_match_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 5, 3, 8) * rng.gamma(2.0, 1.0, (2, 5, 1, 1))
         ).astype(np.float32)
    x[1, 2] = 0.0                                     # an all-zero row
    jq, js = jgpt._kv_quant(jnp.asarray(x))
    tq, ts = tgpt._kv_quant(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.shape == (2, 5)
    _int8_close(tq, jq, "_kv_quant")
    _scales_close(ts, js, "_kv_quant scales")
    for cdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = tgpt._kv_load(tq, ts, cdt).float().numpy()
        ref = np.asarray(jgpt._kv_load(jq, js, jdt).astype(jnp.float32))
        np.testing.assert_allclose(got, ref, rtol=1e-2 if jdt ==
                                   jnp.bfloat16 else 1e-6,
                                   atol=float(ts.max()) * 1.0001)


def test_int8_kv_drift_bound(fp32):
    """int8 KV against the fp32 cache on the same weights (:204): the
    prefill logits within 5% of their scale and the last argmax equal;
    and the int8 cache through the port against JAX's."""
    jcfg, jp, tcfg, tp = fp32
    prompt = np.random.RandomState(3).randint(
        1, 64, (1, 12)).astype(np.int32)
    with torch.inference_mode():
        _, ref = tgpt._prefill_chunk(
            tcfg, tp, tgpt.init_cache(tcfg, 1, 32, device="cpu"),
            torch.from_numpy(prompt), 0)
        qcache = tgpt.init_cache(tcfg, 1, 32, kv_dtype="int8", device="cpu")
        assert isinstance(qcache, tgpt.QKVCache)
        _, got = tgpt._prefill_chunk(tcfg, tp, qcache,
                                     torch.from_numpy(prompt), 0)
    ref, got = ref.numpy(), got.numpy()
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= 0.05 * scale
    assert np.argmax(ref[0, -1]) == np.argmax(got[0, -1])
    jqc = jgpt.QKVCache(jnp.zeros((2, 1, 32, 2, 16), jnp.int8),
                        jnp.zeros((2, 1, 32, 2, 16), jnp.int8),
                        jnp.zeros((2, 1, 32), jnp.float32),
                        jnp.zeros((2, 1, 32), jnp.float32))
    jqc, jl = jgpt._prefill_chunk(jcfg, jp, jqc, jnp.asarray(prompt),
                                  jnp.int32(0))
    np.testing.assert_allclose(got, np.asarray(jl), rtol=1e-4,
                               atol=1e-4 * scale)
    _int8_close(qcache.k, jqc.k, "int8 cache K")
    _scales_close(qcache.v_scale, jqc.v_scale, "int8 cache V scales")


def test_int8_kv_slot_decode_matches_jax(fp32):
    """Four int8-KV slots prefilled and decoded three steps in both
    packages (an inactive slot and a full one among them): the same
    greedy tokens and positions, payloads within one step of the grid,
    logits' tokens equal."""
    jcfg, jp, tcfg, tp = fp32
    jslots, jfirst = _slot_case(
        jgpt, jcfg, jp, jgpt.init_slots(jcfg, 4, 32, kv_dtype="int8"))
    with torch.inference_mode():
        tslots, tfirst = _slot_case(
            tgpt, tcfg, tp, tgpt.init_slots(tcfg, 4, 32, kv_dtype="int8",
                                            device="cpu"))
        assert tfirst == jfirst
        active = np.array([False, True, True, True])
        for _ in range(3):
            jslots, jout = jgpt.slot_decode(
                jcfg, jp, jslots, jnp.asarray(active), jnp.zeros(4),
                jnp.arange(4, dtype=jnp.uint32))
            tslots, tout = tgpt.slot_decode(
                tcfg, tp, tslots, torch.from_numpy(active),
                torch.zeros(4), torch.arange(4))
            np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tslots.pos.numpy(), np.asarray(jslots.pos))
    _int8_close(tslots.k, jslots.k, "int8 slot K")
    _int8_close(tslots.v, jslots.v, "int8 slot V")
    _scales_close(tslots.k_scale, jslots.k_scale, "int8 slot K scales")


def test_kv_bytes_per_slot_accounting(fp32):
    """The accounting matches the arrays' bytes (:238) and the engine's
    gauge; int8 beats fp32 by >= 1.8x."""
    jcfg, _, tcfg, tp = fp32
    slots = tgpt.init_slots(tcfg, 4, 32, kv_dtype="int8", device="cpu")
    per_slot = sum(t.numel() * t.element_size() for t in
                   (slots.k, slots.v, slots.k_scale, slots.v_scale)) // 4
    assert tgpt.slots_bytes_per_slot(tcfg, 32, "int8") == per_slot
    assert tgpt.slots_bytes_per_slot(tcfg, 32, "int8") == \
        jgpt.slots_bytes_per_slot(jcfg, 32, "int8")
    dense = tgpt.init_slots(tcfg, 4, 32, device="cpu")
    assert tgpt.slots_bytes_per_slot(tcfg, 32) == (
        dense.k.numel() + dense.v.numel()) * 4 // 4
    eng = DecodeEngine(tcfg, tp, n_slots=4, buckets=(32,),
                       kv_dtype="int8", device="cpu")
    assert eng.kv_bytes_per_slot == per_slot
    assert decode_metrics.snapshot()["kv_bytes_per_slot"] == per_slot
    assert tgpt.slots_bytes_per_slot(tcfg, 32) / per_slot >= 1.8


def _engine_tokens(eng, prompt, n):
    bucket, slot, first = eng.start(np.asarray(prompt, np.int32),
                                    max_tokens=n)
    toks = [first] + [int(eng.advance(bucket)[slot]) for _ in range(n - 1)]
    eng.release(bucket, slot)
    return toks


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_quantized_engine_matches_dequantized_tree(fp32, kv_dtype):
    """DecodeEngine(quantize="int8") greedy tokens == ``generate`` on the
    dequantized tree, in the port and in JAX (:163); the bf16 mode
    serves bf16 leaves."""
    jcfg, jp, tcfg, tp = fp32
    prompt = np.random.RandomState(1).randint(1, 64, 11).astype(np.int32)
    eng = DecodeEngine(tcfg, tp, n_slots=2, buckets=(32,), prefill_chunk=8,
                       quantize="int8", kv_dtype=kv_dtype, device="cpu")
    eng.warmup()
    got = _engine_tokens(eng, prompt, 8)
    assert isinstance(eng.current_params()["blocks"]["wq"], tqz.QTensor)
    dq = tqz.dequantize_tree(tqz.quantize_tree(tp, "int8"))
    solo = tgpt.generate(tcfg, dq, torch.from_numpy(prompt[None]), 8,
                         temperature=0.0, prefill_chunk=8,
                         kv_dtype=kv_dtype)
    assert got == solo[0].tolist()
    if kv_dtype is None:
        jdq = jqz.dequantize_tree(jqz.quantize_tree(jp, "int8"))
        ref = jgpt.generate(jcfg, jdq, prompt[None], 8, jax.random.key(0),
                            temperature=0.0, prefill_chunk=8)
        assert got == np.asarray(ref)[0].tolist()
    bf = DecodeEngine(tcfg, tp, n_slots=2, buckets=(32,), prefill_chunk=8,
                      quantize="bf16", device="cpu")
    assert len(_engine_tokens(bf, prompt, 4)) == 4
    assert bf.current_params()["blocks"]["w1"].dtype == torch.bfloat16


def test_inference_engine_int8(fp32):
    """InferenceEngine(quantize="int8") serves the dequantized tree's
    forward (:597), far from the fp32 forward at rounding scale; a live
    params callable is quantized once per tree."""
    jcfg, jp, tcfg, tp = fp32
    apply_fn = tgpt.make_serving_apply(tcfg)
    x = np.random.RandomState(9).randint(1, 64, (4, 12)).astype(np.int32)
    q = InferenceEngine(apply_fn, tp, buckets=(4,), quantize="int8",
                        device="cpu")
    got = q.infer(x).numpy()
    with torch.inference_mode():
        ref = apply_fn(tqz.dequantize_tree(tqz.quantize_tree(tp, "int8")),
                       torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    japply, _ = jgpt.make_serving_apply(jcfg)
    jref = np.asarray(japply(jqz.dequantize_tree(
        jqz.quantize_tree(jp, "int8")), x))
    np.testing.assert_allclose(got, jref, rtol=1e-4, atol=1e-4)
    fp = InferenceEngine(apply_fn, tp, buckets=(4,), device="cpu")
    fp_out = fp.infer(x).numpy()
    assert np.abs(got - fp_out).max() > 1e-3
    trees = [tp]
    live = InferenceEngine(apply_fn, lambda: trees[-1], buckets=(4,),
                           quantize="int8", device="cpu")
    first = live.current_params()
    assert live.current_params() is first
    trees.append(tgpt.params_from_numpy(numpy_params(tcfg, 1), "cpu"))
    assert live.current_params() is not first
    with pytest.raises(ValueError, match="quantize mode"):
        InferenceEngine(apply_fn, tp, quantize="int4", device="cpu")
