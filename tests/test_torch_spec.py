"""The port's speculative decoding against the JAX reference, on the CPU.

At the reference tests' sizes (target 2 x 32, draft 1 x 16, vocab 64,
fp32) with two drafts: a small random draft (acceptance near 0, the
reject path) and the target as its own draft (most rounds commit all
k + 1 tokens).  Held: ``slot_verify`` against JAX's on the same
slots and drafts (``t``, ``n_commit``, positions, tokens and the rows
written, 1e-5); speculative greedy tokens equal plain decoding's and
JAX's, pinned and paged; speculative sampled (0.8) equals plain sampled
within the port; paged + spec + int8 weights through the batcher equals
the pinned int8 plain engine; ``note_spec``'s proposed and accepted
counts equal the reference engine's on the same greedy run; and no
capture after ``warmup()`` through the CPU capture stand-in.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models.transformer import TransformerConfig as JCfg
from deeplearning4j_tpu.serving import decode as jdecode
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
from deeplearning4j_tpu_torch.serving.decode import (ContinuousBatcher,
                                                     DecodeEngine,
                                                     PrefixCache)
from test_torch_compile_cache import monkeypatch_graphs_off
from test_torch_paged import (CFG, DCFG, DKW, ENGINE, KW, assert_no_jax,
                              audit_zero_pages, engine_tokens, jax_tree,
                              port, solo, trees)
from test_torch_paged import graphs_on_cpu  # noqa: F401 (a fixture)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree():
    return trees()


@pytest.fixture(scope="module")
def params(tree):
    return port(tree[0])


@pytest.fixture(scope="module")
def drafts(tree, params):
    """name -> the port's ``draft=`` argument."""
    return {"small": (DCFG, port(tree[1])), "self": (CFG, params)}


def _jax_solo(tree, prompt, n):
    out = jgpt.generate(JCfg(**KW), jax_tree(tree),
                        np.asarray(prompt, np.int32)[None, :], n,
                        jax_key(), temperature=0.0)
    return [int(t) for t in np.asarray(out)[0]]


def jax_key():
    import jax
    return jax.random.key(0)


def _prefilled(mod, cfg, params, slots):
    """Prefill three slots of a T_max=32 cache identically in either
    package (prompts of 5, 13 and 9)."""
    rng = np.random.RandomState(3)
    for slot, n in ((0, 5), (1, 13), (2, 9)):
        prompt = rng.randint(1, 64, n).astype(np.int32)
        for lo in range(0, n, 8):
            chunk = np.zeros(8, np.int32)
            nv = min(8, n - lo)
            chunk[:nv] = prompt[lo:lo + nv]
            if mod is jgpt:
                slots, _ = jgpt.slot_prefill(
                    cfg, params, slots, jnp.asarray(chunk), jnp.int32(slot),
                    jnp.int32(lo), jnp.int32(nv), jnp.float32(0.0),
                    jnp.uint32(0))
            else:
                slots, _ = tgpt.slot_prefill(
                    cfg, params, slots, torch.from_numpy(chunk), slot, lo,
                    nv, 0.0, 0)
    return slots


def test_slot_verify_matches_jax(tree, params):
    jcfg, jp = JCfg(**KW), jax_tree(tree[0])
    jslots = _prefilled(jgpt, jcfg, jp, jgpt.init_slots(jcfg, 3, 32))
    active = np.array([True, True, False])
    temps = np.array([0.0, 0.8, 0.0], np.float32)
    seeds = np.array([1, 2, 3])
    with torch.inference_mode():
        tslots = _prefilled(tgpt, CFG, params,
                            tgpt.init_slots(CFG, 3, 32, device="cpu"))
        # slot 0's drafts: its own greedy chain (accepted), slot 1's: a
        # guess (rejected early)
        probe = tgpt.init_slots(CFG, 3, 32, device="cpu")
        for a, b in zip(probe[:4], tslots[:4]):
            a.copy_(b)
        chain = []
        for _ in range(3):
            _, t = tgpt.slot_decode(CFG, params, probe, torch.ones(
                3, dtype=torch.bool), torch.zeros(3),
                torch.zeros(3, dtype=torch.int64))
            chain.append(t.numpy().copy())
        drafts = np.stack(chain, 1).astype(np.int32)
        drafts[1] = [5, 6, 7]
        jslots, jt, jn = jgpt.slot_verify(
            jcfg, jp, jslots, jnp.asarray(active), jnp.asarray(temps),
            jnp.asarray(seeds, jnp.uint32), jnp.asarray(drafts))
        out = tgpt.slot_verify(CFG, params, tslots,
                               torch.from_numpy(active),
                               torch.from_numpy(temps),
                               torch.from_numpy(seeds),
                               torch.from_numpy(drafts))
    assert out[0] is tslots
    t, n_commit = out[1].numpy(), out[2].numpy()
    # slot 1 samples at 0.8: the packages' noise differs there (threefry
    # against the port's hash), so its draws are held within the port
    np.testing.assert_array_equal(t[[0, 2]], np.asarray(jt)[[0, 2]])
    assert n_commit[0] == np.asarray(jn)[0] == 4        # all accepted
    assert n_commit[2] == np.asarray(jn)[2] == 0        # inactive
    np.testing.assert_array_equal(tslots.pos.numpy()[[0, 2]],
                                  np.asarray(jslots.pos)[[0, 2]])
    np.testing.assert_array_equal(tslots.tokens.numpy()[[0, 2]],
                                  np.asarray(jslots.tokens)[[0, 2]])
    for got, ref in ((tslots.k, jslots.k), (tslots.v, jslots.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("draft", ["small", "self"])
def test_spec_greedy_equals_plain_and_jax(tree, params, drafts, paged,
                                          draft):
    spec = DecodeEngine(CFG, params, paged=paged, draft=drafts[draft],
                        draft_k=3, **ENGINE)
    plain = DecodeEngine(CFG, params, **ENGINE)
    spec.warmup()
    plain.warmup()
    before = decode_metrics.snapshot()
    for prompt in (np.arange(1, 10), np.arange(7, 20)):
        got = engine_tokens(spec, prompt, 12)
        assert got == engine_tokens(plain, prompt, 12)
        assert got == _jax_solo(tree[0], prompt, 12)
    after = decode_metrics.snapshot()
    proposed = after["draft_proposed"] - before["draft_proposed"]
    accepted = after["draft_accepted"] - before["draft_accepted"]
    assert proposed > 0 and 0 <= accepted <= proposed
    if draft == "self":
        # the target proposes its own chain, but not always: as in the
        # reference, the draft writes k rows a round, so after a round
        # that commits all k + 1 tokens its row of the last proposal is
        # stale, and its later proposals attend it
        assert accepted > proposed // 2
    if paged:
        audit_zero_pages(spec)


@pytest.mark.parametrize("paged", [False, True])
def test_spec_sampled_equals_plain_sampled(params, drafts, paged):
    spec = DecodeEngine(CFG, params, paged=paged, draft=drafts["small"],
                        draft_k=3, **ENGINE)
    plain = DecodeEngine(CFG, params, **ENGINE)
    spec.warmup()
    plain.warmup()
    for prompt, seed in ((np.arange(1, 8), 9), (np.arange(3, 16), 4)):
        assert engine_tokens(spec, prompt, 12, 0.8, seed) \
            == engine_tokens(plain, prompt, 12, 0.8, seed)


def test_batcher_composes_paged_spec_int8(params, drafts):
    """Continuous batching over a paged, speculative, int8-weight engine
    with a prefix store: every request equals the pinned int8 plain
    engine's, and every page comes back."""
    eng = DecodeEngine(CFG, params, n_slots=4, buckets=(32,),
                       prefill_chunk=8, paged=True, quantize="int8",
                       draft=drafts["small"], draft_k=3,
                       prefix_cache=PrefixCache(), device="cpu")
    ref = DecodeEngine(CFG, params, quantize="int8", **ENGINE)
    eng.warmup()
    ref.warmup()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 64, size=int(rng.integers(4, 18)))
               for _ in range(6)]
    with ContinuousBatcher(eng) as cb:
        reqs = [cb.submit(p, max_tokens=8) for p in prompts]
        outs = [list(r.result(120.0)) for r in reqs]
    for p, o in zip(prompts, outs):
        assert o == engine_tokens(ref, p, 8), p
    assert eng.n_active() == 0
    audit_zero_pages(eng)


def test_note_spec_matches_reference(tree, params, drafts):
    """The same greedy run through the JAX engine and the port's, both
    with the small draft: equal tokens and equal proposed/accepted
    deltas (``note_spec``)."""
    from deeplearning4j_tpu.runtime.metrics import \
        decode_metrics as jmetrics
    jeng = jdecode.DecodeEngine(JCfg(**KW), jax_tree(tree[0]), n_slots=2,
                                buckets=(32,), prefill_chunk=8,
                                draft=(JCfg(**DKW), jax_tree(tree[1])),
                                draft_k=3)
    eng = DecodeEngine(CFG, params, draft=drafts["small"], draft_k=3,
                       **ENGINE)
    jeng.warmup()
    eng.warmup()
    deltas = []
    for e, m in ((jeng, jmetrics), (eng, decode_metrics)):
        b = m.snapshot()
        toks = [engine_tokens(e, np.arange(s, s + 9), 14) for s in (1, 4)]
        a = m.snapshot()
        deltas.append((toks, a["draft_proposed"] - b["draft_proposed"],
                       a["draft_accepted"] - b["draft_accepted"]))
    assert deltas[0] == deltas[1]


@pytest.mark.parametrize("paged", [False, True])
def test_spec_adds_no_capture(graphs_on_cpu, params, drafts,  # noqa: F811
                              paged):
    """On the card's capture path: warm-up captures 4 graphs a bucket
    (prefill, draft prefill, spec round, step), a batched speculative
    burst adds none and equals the plain CPU run."""
    kw = dict(n_slots=2, buckets=(32, 64), prefill_chunk=8, paged=paged,
              draft=drafts["small"], draft_k=3, device="cpu")

    def burst(eng):
        rng = np.random.default_rng(3)
        with ContinuousBatcher(eng) as cb:
            reqs = [cb.submit(rng.integers(0, 64, size=n), max_tokens=m,
                              temperature=t, seed=i)
                    for i, (n, m, t) in enumerate(
                        [(3, 9, 0.0), (11, 20, 0.7), (5, 30, 0.0)])]
            return [list(r.result(timeout=120)) for r in reqs]

    eng = DecodeEngine(CFG, params, **kw)
    assert eng.warmup()["compiles"] == 8
    outs = burst(eng)
    assert decode_metrics.snapshot()["compile_delta_since_mark"] == 0
    with monkeypatch_graphs_off():
        assert outs == burst(DecodeEngine(CFG, params, **kw))
    assert outs[0] == solo(params, np.random.default_rng(3).integers(
        0, 64, size=3), 9)


def test_spec_modules_import_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.serving.decode",
                  "deeplearning4j_tpu_torch.models.gpt")
