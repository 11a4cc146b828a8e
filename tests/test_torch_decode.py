"""The port's GPT decoding and continuous-batching decode serving against
the JAX reference, on the CPU.

The same numpy weights (drawn from a seed, wide enough that greedy
continuations vary) go through ``deeplearning4j_tpu/models/gpt.py`` and
``deeplearning4j_tpu_torch/models/gpt.py`` (``params_from_numpy``).
Held: ``embed`` with an offset, ``_prefill_chunk``/``prefill_cache``
and ``_decode_step`` logits (rtol 1e-5 fp32, 2e-2 bf16), greedy
``generate`` token for token, ``slot_prefill``/``slot_decode`` with an
inactive slot and a slot at ``pos == T_max`` whose write must drop, and
the engine and batcher behaviours of ``tests/test_decode.py``: slot
parity of mid-flight joins and busy batches with solo ``generate``
(greedy fp32), sampling reproducible across placement, EOS recycling,
streaming, synchronous rejection, many clients, draining close.  The
port's sampler follows the reference's key contract (seed, position),
not its threefry draws, so sampled tokens are held within the port and
to the distribution by a chi-square test.
"""

import os
import subprocess
import sys
import threading
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models import transformer as jtfm
from deeplearning4j_tpu.models.transformer import TransformerConfig as JCfg
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.models import transformer as ttfm
from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
from deeplearning4j_tpu_torch.serving.decode import (ContinuousBatcher,
                                                     DeadlineExceeded,
                                                     DecodeEngine,
                                                     default_length_buckets)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

#: ``tests/test_decode.py``'s config
KW = dict(vocab_size=64, max_len=64, hidden=32, n_layers=2, n_heads=2,
          ffn_dim=64, dropout=0.0, compute_dtype="float32", causal=True,
          type_vocab_size=1)
CFG = TransformerConfig(**KW)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def numpy_params(cfg, seed: int = 0):
    """A GPT param tree as numpy arrays: projections at std
    1/sqrt(fan-in), token embeddings at 0.5 and positions at 2 (so
    greedy continuations move on instead of repeating one id), gains and
    biases near 1 and 0."""
    rng = np.random.default_rng(seed)
    L, H, NH, D, Fd = (cfg.n_layers, cfg.hidden, cfg.n_heads,
                       cfg.hidden // cfg.n_heads, cfg.ffn_dim)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    embed = {"tok": n(cfg.vocab_size, H, s=0.5),
             "pos": n(cfg.max_len, H, s=2.0),
             "type": n(1, H, s=0.3), "ln_g": 1 + n(H, s=0.1),
             "ln_b": n(H, s=0.1)}
    blocks = {"wq": n(L, H, NH, D, s=H ** -0.5),
              "wk": n(L, H, NH, D, s=H ** -0.5),
              "wv": n(L, H, NH, D, s=H ** -0.5),
              "wo": n(L, NH, D, H, s=H ** -0.5),
              "bq": n(L, NH, D, s=0.1), "bk": n(L, NH, D, s=0.1),
              "bv": n(L, NH, D, s=0.1), "bo": n(L, H, s=0.1),
              "ln1_g": 1 + n(L, H, s=0.1), "ln1_b": n(L, H, s=0.1),
              "w1": n(L, H, Fd, s=H ** -0.5), "b1": n(L, Fd, s=0.1),
              "w2": n(L, Fd, H, s=Fd ** -0.5), "b2": n(L, H, s=0.1),
              "ln2_g": 1 + n(L, H, s=0.1), "ln2_b": n(L, H, s=0.1)}
    return {"embed": embed, "blocks": blocks}


def both(compute_dtype="float32", seed=0):
    """(JAX cfg, JAX params, port cfg, port params) on shared weights."""
    kw = dict(KW, compute_dtype=compute_dtype)
    tree = numpy_params(TransformerConfig(**kw), seed)
    return (JCfg(**kw), jax.tree.map(jnp.asarray, tree),
            TransformerConfig(**kw), tgpt.params_from_numpy(tree, "cpu"))


@pytest.fixture(scope="module")
def fp32():
    return both("float32")


@pytest.fixture(scope="module")
def params(fp32):
    return fp32[3]


@pytest.fixture(scope="module")
def engine(params):
    eng = DecodeEngine(CFG, params, n_slots=4, buckets=(32, 64),
                       device="cpu")
    eng.warmup()
    return eng


def _close(got, ref, dt, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    tol = TOL[dt]
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _solo(params, prompt, n_tokens, **kw):
    """The port's solo greedy ``generate``: the batcher's reference."""
    out = tgpt.generate(CFG, params, torch.from_numpy(
        np.asarray(prompt, np.int32)[None, :]), n_tokens,
        temperature=kw.pop("temperature", 0.0), **kw)
    return out[0].numpy()


def _jax_solo(jp, prompt, n_tokens):
    out = jgpt.generate(JCfg(**KW), jp,
                        np.asarray(prompt, np.int32)[None, :], n_tokens,
                        jax.random.key(0), temperature=0.0)
    return np.asarray(out)[0]


def _prompts(seed, sizes):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG.vocab_size, size=n).astype(np.int32)
            for n in sizes]


# -- dense KV-cache decoding -------------------------------------------------

def test_embed_position_offset(fp32):
    jcfg, jp, tcfg, tp = fp32
    ids = np.random.RandomState(0).randint(0, 64, (2, 5)).astype(np.int32)
    for off in (0, 7, 59):
        ref = jtfm.embed(jcfg, jp, jnp.asarray(ids), None, off)
        got = ttfm.embed(tcfg, tp, torch.from_numpy(ids), None, off)
        _close(got, ref, "float32", f"offset {off}")
    with pytest.raises(IndexError):
        ttfm.embed(tcfg, tp, torch.from_numpy(ids), None, 60)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_prefill_and_decode_step_match_jax(dt):
    jcfg, jp, tcfg, tp = both(dt)
    rng = np.random.RandomState(1)
    toks = rng.randint(1, 64, (2, 16)).astype(np.int32)
    jcache = jgpt.init_cache(jcfg, 2, 32)
    tcache = tgpt.init_cache(tcfg, 2, 32, device="cpu")
    with torch.inference_mode():
        # two chunks: the second attends the first one's cached rows
        for start in (0, 8):
            jcache, jl = jgpt._prefill_chunk(
                jcfg, jp, jcache, jnp.asarray(toks[:, start:start + 8]),
                jnp.int32(start))
            tcache, tl = tgpt._prefill_chunk(
                tcfg, tp, tcache, torch.from_numpy(toks[:, start:start + 8]),
                start)
            _close(tl, jl, dt, f"_prefill_chunk at {start}")
        _close(tcache.k, jcache.k, dt, "cached K")
        _close(tcache.v, jcache.v, dt, "cached V")
        nxt = rng.randint(1, 64, (2,)).astype(np.int32)
        jcache, jl = jgpt._decode_step(jcfg, jp, jcache, jnp.asarray(nxt),
                                       jnp.int32(16))
        same = tgpt._decode_step(tcfg, tp, tcache, torch.from_numpy(nxt), 16)
        assert same[0] is tcache                    # updated in place
        _close(same[1], jl, dt, "_decode_step")
        _close(tcache.k, jcache.k, dt, "cached K after a step")
        for t_p in (3, 8, 9, 17, 32):
            prompt = rng.randint(1, 64, (2, t_p)).astype(np.int32)
            _, jl = jgpt.prefill_cache(jcfg, jp, jgpt.init_cache(jcfg, 2, 64),
                                       prompt, chunk=8)
            _, tl = tgpt.prefill_cache(
                tcfg, tp, tgpt.init_cache(tcfg, 2, 64, device="cpu"),
                torch.from_numpy(prompt), chunk=8)
            _close(tl, jl, dt, f"prefill_cache T_p={t_p}")


def test_prefill_past_the_cache_raises(params):
    cache = tgpt.init_cache(CFG, 1, 32, device="cpu")
    with pytest.raises(ValueError, match="past the cache"):
        tgpt._prefill_chunk(CFG, params, cache,
                            torch.ones((1, 8), dtype=torch.int32), 28)


@pytest.mark.parametrize("t_p,n_tokens,chunk", [(5, 12, 32), (11, 20, 8),
                                                (40, 24, 32)])
def test_generate_greedy_matches_jax(fp32, t_p, n_tokens, chunk):
    """Token for token, with prompts on and off chunk boundaries."""
    jcfg, jp, tcfg, tp = fp32
    prompt = np.random.RandomState(t_p).randint(
        1, 64, (2, t_p)).astype(np.int32)
    ref = np.asarray(jgpt.generate(jcfg, jp, prompt, n_tokens,
                                   jax.random.key(0), temperature=0.0,
                                   prefill_chunk=chunk))
    got, logits = tgpt.generate(tcfg, tp, torch.from_numpy(prompt),
                                n_tokens, temperature=0.0,
                                prefill_chunk=chunk, return_logits=True)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(set(ref[0].tolist())) > 3            # not one repeated id
    # teacher forcing: each step's logits are the dense forward's
    full = np.concatenate([prompt, ref], axis=1)
    dense = jgpt.forward_logits(jcfg, jp, jnp.asarray(full))
    _close(logits, dense[:, t_p - 1:t_p - 1 + n_tokens], "float32",
           "generate's logits vs the dense forward")
    with pytest.raises(ValueError, match="exceeds max"):
        tgpt.generate(tcfg, tp, torch.from_numpy(prompt), 65 - t_p)


def _slot_case(mod, cfg, params, slots, C=8):
    """Prefill four slots of a T_max=32 cache identically in either
    package: slot 0 a 5-token prompt (then left inactive), slots 1-2
    prompts of 13 and 8, slot 3 a 32-token prompt (pos == T_max)."""
    rng = np.random.RandomState(3)
    firsts = []
    for slot, n in ((0, 5), (1, 13), (2, 8), (3, 32)):
        prompt = rng.randint(1, 64, n).astype(np.int32)
        for lo in range(0, n, C):
            chunk = np.zeros(C, np.int32)
            nv = min(C, n - lo)
            chunk[:nv] = prompt[lo:lo + nv]
            if mod is jgpt:
                slots, first = jgpt.slot_prefill(
                    cfg, params, slots, jnp.asarray(chunk), jnp.int32(slot),
                    jnp.int32(lo), jnp.int32(nv), jnp.float32(0.0),
                    jnp.uint32(slot))
            else:
                slots, first = tgpt.slot_prefill(
                    cfg, params, slots, torch.from_numpy(chunk), slot, lo,
                    nv, 0.0, slot)
        firsts.append(int(first))
    return slots, firsts


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_slot_prefill_and_decode_match_jax(dt):
    jcfg, jp, tcfg, tp = both(dt, seed=1)
    jslots, jfirst = _slot_case(jgpt, jcfg, jp, jgpt.init_slots(jcfg, 4, 32))
    with torch.inference_mode():
        tslots = tgpt.init_slots(tcfg, 4, 32, device="cpu")
        ptr = tslots.k.data_ptr()
        tslots, tfirst = _slot_case(tgpt, tcfg, tp, tslots)
        if dt == "float32":
            assert tfirst == jfirst
        np.testing.assert_array_equal(tslots.pos.numpy(), [5, 13, 8, 32])
        np.testing.assert_array_equal(tslots.pos.numpy(),
                                      np.asarray(jslots.pos))
        _close(tslots.k, jslots.k, dt, "slot K after prefill")
        _close(tslots.v, jslots.v, dt, "slot V after prefill")
        active = np.array([False, True, True, True])
        temps = np.zeros(4, np.float32)
        seeds = np.arange(4)
        row_before = tslots.k[:, 3, 31].clone()
        for step in range(3):
            jslots, jout = jgpt.slot_decode(
                jcfg, jp, jslots, jnp.asarray(active), jnp.asarray(temps),
                jnp.asarray(seeds, jnp.uint32))
            tslots, tout = tgpt.slot_decode(
                tcfg, tp, tslots, torch.from_numpy(active),
                torch.from_numpy(temps), torch.from_numpy(seeds))
            if dt == "float32":
                np.testing.assert_array_equal(tout.numpy(),
                                              np.asarray(jout))
            np.testing.assert_array_equal(tslots.pos.numpy(),
                                          np.asarray(jslots.pos))
            _close(tslots.k, jslots.k, dt, f"slot K after step {step}")
            _close(tslots.v, jslots.v, dt, f"slot V after step {step}")
        # the slot at pos >= T_max wrote nothing: its last row is intact
        assert torch.equal(tslots.k[:, 3, 31], row_before)
        np.testing.assert_array_equal(tslots.pos.numpy(), [5, 16, 11, 35])
        assert tslots.k.data_ptr() == ptr           # one cache, in place


# -- the engine ---------------------------------------------------------------

def test_default_length_buckets():
    assert default_length_buckets(128) == (32, 64, 128)
    assert default_length_buckets(48) == (32, 48)
    assert default_length_buckets(16) == (16,)
    assert default_length_buckets(1024) == (32, 64, 128, 256, 512, 1024)
    with pytest.raises(ValueError):
        default_length_buckets(0)


def test_bucket_chunk_divisibility_and_knobs(params):
    eng = DecodeEngine(CFG, params, buckets=(24, 64), prefill_chunk=16,
                       device="cpu")
    assert eng.prefill_chunk == 8
    eng = DecodeEngine(CFG, params, buckets=(32, 48), device="cpu")
    assert eng.prefill_chunk == 16
    with pytest.raises(ValueError, match="exceeds the model"):
        DecodeEngine(CFG, params, buckets=(128,), device="cpu")
    # a pipe or seq axis above 1 holds the whole served tree on each of
    # its ranks (the reference's decode specs split only model): one rank
    # of such a mesh runs no collective and decodes mesh=None's tokens
    # (every rank of a group: tests/test_torch_pipe_serving.py)
    prompt = np.arange(5, dtype=np.int32) + 3
    for axis in ("pipe", "seq"):
        eng = DecodeEngine(CFG, params, buckets=(24, 64), device="cpu",
                           mesh=types.SimpleNamespace(
                               shape={"data": 1, axis: 2},
                               axis_names=("data", axis), ranks=(0, 1),
                               rank=0, device=torch.device("cpu"),
                               backend="gloo"))
        assert eng.model_degree == 1 and eng._tp is None
        b, slot, first = eng.start(prompt, max_tokens=6)
        toks = [int(first)] + [int(eng.advance(b)[slot]) for _ in range(5)]
        np.testing.assert_array_equal(toks, _solo(params, prompt, 6))
    # the serving tier's knobs: the page width is the shrunk chunk, the
    # default pool the pinned capacity plus the trash page
    eng = DecodeEngine(CFG, params, buckets=(24, 64), prefill_chunk=16,
                       paged=True, prefix_cache=True,
                       draft=(CFG, params), device="cpu")
    assert eng.page_tokens == 8 and eng.n_kv_pages == 8 * (64 // 8) + 1
    assert DecodeEngine(CFG, params, n_pages=9,
                        device="cpu").n_kv_pages == 9
    with pytest.raises(ValueError, match="draft_k"):
        DecodeEngine(CFG, params, draft=(CFG, params), draft_k=0,
                     device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        DecodeEngine(CFG, params, kv_dtype="fp8", device="cpu")
    with pytest.raises(ValueError, match="quantize mode"):
        DecodeEngine(CFG, params, quantize="fp4", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DecodeEngine(CFG, params)


def test_chunked_prefill_logits_parity(params):
    """``prefill_cache`` at any chunk width gives the dense forward's
    last-position logits."""
    rng = np.random.RandomState(0)
    with torch.inference_mode():
        for t_p in (3, 8, 9, 17, 32):
            prompt = torch.from_numpy(
                rng.randint(1, 64, (2, t_p)).astype(np.int32))
            ref = tgpt.forward_logits(CFG, params, prompt)[:, -1]
            for chunk in (4, 8, 32):
                _, logits = tgpt.prefill_cache(
                    CFG, params, tgpt.init_cache(CFG, 2, 64, device="cpu"),
                    prompt, chunk=chunk)
                np.testing.assert_allclose(logits.numpy(), ref.numpy(),
                                           rtol=2e-4, atol=2e-4)


def test_mid_flight_join_token_parity(fp32, params, engine):
    """A decodes alone, B joins the running bucket, both run to budget,
    and both are token-identical to their solo runs: the port's
    ``generate`` and JAX's."""
    pa, pb = _prompts(1, (7, 11))
    n_a, n_b = 12, 9
    bucket, slot_a, first_a = engine.start(pa, max_tokens=n_a, owner="A")
    toks_a = [first_a]
    for _ in range(4):
        toks_a.append(int(engine.advance(bucket)[slot_a]))
    assert engine.n_active() == 1
    bucket_b, slot_b, first_b = engine.start(pb, max_tokens=n_b, owner="B")
    assert bucket_b == bucket and slot_b != slot_a
    toks_b = [first_b]
    while len(toks_a) < n_a or len(toks_b) < n_b:
        out = engine.advance(bucket)
        if len(toks_a) < n_a:
            toks_a.append(int(out[slot_a]))
        if len(toks_b) < n_b:
            toks_b.append(int(out[slot_b]))
    engine.release(bucket, slot_a)
    engine.release(bucket, slot_b)
    for toks, p, n in ((toks_a, pa, n_a), (toks_b, pb, n_b)):
        np.testing.assert_array_equal(toks, _solo(params, p, n))
        np.testing.assert_array_equal(toks, _jax_solo(fp32[1], p, n))


def test_busy_batcher_token_parity(fp32, params, engine):
    """Requests submitted into a busy batch (the last one joins
    mid-flight) match their solo runs."""
    prompts = _prompts(2, (5, 9, 3, 14))
    n_tok = 16
    refs = [_solo(params, p, n_tok) for p in prompts]
    np.testing.assert_array_equal(refs[3], _jax_solo(fp32[1], prompts[3],
                                                     n_tok))
    decode_metrics.reset()
    tracer = telemetry.enable()
    try:
        with ContinuousBatcher(engine, default_max_tokens=n_tok) as cb:
            first_wave = [cb.submit(p) for p in prompts[:3]]
            for r in first_wave:
                next(r.stream(30))
            probe = cb.submit(prompts[3])
            outs = [r.result(60) for r in first_wave] + [probe.result(60)]
    finally:
        telemetry.disable()
    for ref, out in zip(refs, outs):
        np.testing.assert_array_equal(out, ref)
    snap = decode_metrics.snapshot()
    assert snap["joins"] > 0 and snap["requests_completed"] == 4
    assert snap["tokens_out"] == 4 * n_tok
    assert snap["decode_dispatches"] > 0 and snap["prefill_dispatches"] >= 4
    assert 0.0 < snap["slot_occupancy"] <= 1.0
    assert snap["ttft_p50_ms"] is not None and snap["tok_p99_ms"] is not None
    names = {r["name"] for r in tracer.records()}
    assert {"decode.prefill", "decode.dispatch", "decode.join",
            "decode.complete"} <= names


def test_sampling_reproducible_across_placement(params, engine):
    """Keys fold (seed, position), not the slot or the step: a sampled
    request alone, in a busy batch and through ``generate`` with its
    seed gives the same tokens."""
    rng = np.random.RandomState(3)
    p = rng.randint(1, CFG.vocab_size, size=6).astype(np.int32)
    with ContinuousBatcher(engine, default_max_tokens=10) as cb:
        alone = cb.submit(p, max_tokens=10, temperature=0.8,
                          seed=42).result(60)
        others = [cb.submit(rng.randint(1, CFG.vocab_size, size=4),
                            max_tokens=12, temperature=0.5, seed=i)
                  for i in range(3)]
        busy = cb.submit(p, max_tokens=10, temperature=0.8,
                         seed=42).result(60)
        other_seed = cb.submit(p, max_tokens=10, temperature=0.8,
                               seed=43).result(60)
        for o in others:
            o.result(60)
    np.testing.assert_array_equal(alone, busy)
    np.testing.assert_array_equal(
        alone, _solo(params, p, 10, temperature=0.8, seed=42))
    assert not np.array_equal(alone, other_seed)
    assert not np.array_equal(alone, _solo(params, p, 10))


def test_generate_rows_sample_independently(params):
    """Copies of one prompt sampled together draw independent noise (as
    JAX's batched categorical does), and row 0 keeps the engine's
    (seed, position) keys: it equals a solo ``generate`` of the seed."""
    p = np.random.RandomState(7).randint(1, CFG.vocab_size, size=6)
    batch = tgpt.generate(CFG, params, torch.from_numpy(
        np.tile(p.astype(np.int32), (4, 1))), 12, seed=5,
        temperature=1.0).numpy()
    assert len({tuple(r) for r in batch}) > 1, batch
    np.testing.assert_array_equal(
        batch[0], _solo(params, p, 12, temperature=1.0, seed=5))


def test_seed_reduces_mod_2_32_in_engine_and_generate(params, engine):
    """A seed outside [0, 2**32) (-1 here) is taken mod 2**32 by the
    engine and by ``generate`` alike: the request samples as a solo
    ``generate`` of that seed and of ``2**32 - 1``."""
    p = np.random.RandomState(8).randint(1, CFG.vocab_size, size=5)
    with ContinuousBatcher(engine, default_max_tokens=10) as cb:
        got = cb.submit(p, max_tokens=10, temperature=0.9,
                        seed=-1).result(60)
    np.testing.assert_array_equal(
        got, _solo(params, p, 10, temperature=0.9, seed=-1))
    np.testing.assert_array_equal(
        got, _solo(params, p, 10, temperature=0.9, seed=2 ** 32 - 1))


def test_eos_ends_early_and_recycles_slots(params, engine):
    rng = np.random.RandomState(4)
    p = rng.randint(1, CFG.vocab_size, size=5).astype(np.int32)
    ref = _solo(params, p, 8)
    eos = int(ref[3])
    stop = int(np.argmax(ref == eos))
    with ContinuousBatcher(engine, default_max_tokens=8) as cb:
        out = cb.submit(p, max_tokens=20, eos_id=eos).result(60)
        np.testing.assert_array_equal(out, ref[:stop + 1])
        assert out[-1] == eos and len(out) < 20
        prompts = [rng.randint(1, CFG.vocab_size, size=4 + i % 5)
                   for i in range(12)]
        outs = [cb.submit(q.astype(np.int32), max_tokens=5)
                for q in prompts]
        for r in outs:
            assert r.result(120).shape == (5,)
    assert engine.n_active() == 0
    assert all(b.free_slot() == 0 for b in engine._buckets.values())


def test_request_streaming_matches_result(engine):
    p = _prompts(5, (4,))[0]
    with ContinuousBatcher(engine, default_max_tokens=6) as cb:
        r = cb.submit(p, max_tokens=6)
        streamed = list(r.stream(30))
        np.testing.assert_array_equal(streamed, r.result(1))
        assert r.ttft_ms is not None and r.ttft_ms >= 0.0


def test_oversize_prompt_rejected_synchronously(engine):
    with ContinuousBatcher(engine) as cb:
        with pytest.raises(ValueError, match="largest bucket"):
            cb.submit(np.ones(60, np.int32), max_tokens=32)
        with pytest.raises(ValueError, match="empty prompt"):
            cb.submit(np.zeros(0, np.int32), max_tokens=4)
        with pytest.raises(ValueError, match="deadline_ms"):
            cb.submit(np.ones(4, np.int32), deadline_ms=0)


def test_deadline_expires_queued_request(engine):
    decode_metrics.reset()
    with ContinuousBatcher(engine) as cb:
        r = cb.submit(np.ones(4, np.int32), max_tokens=8,
                      deadline_ms=1e-6)
        with pytest.raises(DeadlineExceeded) as ei:
            r.result(30)
    assert ei.value.tokens_emitted == 0
    assert decode_metrics.snapshot()["deadline_expirations"] == 1
    assert engine.n_active() == 0


def test_many_concurrent_clients(params, engine):
    """16 requests from 16 threads (more than the cores) against 4 slots,
    with a short switch interval: all complete and all match their solo
    runs (greedy fp32)."""
    n_tok = 6
    prompts = _prompts(9, [3 + i % 7 for i in range(16)])
    refs = [_solo(params, p, n_tok) for p in prompts]
    outs = [None] * 16
    errs = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)             # interleave the threads hard
    try:
        with ContinuousBatcher(engine, default_max_tokens=n_tok) as cb:
            def client(i):
                try:
                    outs[i] = cb.submit(prompts[i]).result(120)
                except Exception as e:          # asserted below
                    errs.append(e)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(180)
            assert not any(t.is_alive() for t in threads)
            assert cb.depth() == 0
    finally:
        sys.setswitchinterval(interval)
    assert not errs
    for ref, out in zip(refs, outs):
        np.testing.assert_array_equal(out, ref)


def test_failed_dispatches_fail_their_requests(params):
    """A prefill or decode dispatch that raises resolves its requests
    with the error and frees their slots; the batcher keeps serving."""
    eng = DecodeEngine(CFG, params, n_slots=2, buckets=(32,), device="cpu")
    good_prefill, good_decode = eng._prefill, eng._decode

    def boom(*a):
        raise RuntimeError("injected dispatch fault")

    with ContinuousBatcher(eng, default_max_tokens=4) as cb:
        eng._prefill = boom
        with pytest.raises(RuntimeError, match="injected"):
            cb.submit(np.ones(3, np.int32)).result(30)
        eng._prefill, eng._decode = good_prefill, boom
        with pytest.raises(RuntimeError, match="injected"):
            cb.submit(np.ones(3, np.int32)).result(30)
        assert eng.n_active() == 0
        eng._decode = good_decode
        p = _prompts(11, (5,))[0]
        np.testing.assert_array_equal(cb.submit(p).result(30),
                                      _solo(params, p, 4))


def test_close_drains_accepted_requests(engine):
    rng = np.random.RandomState(10)
    cb = ContinuousBatcher(engine, default_max_tokens=10)
    h = cb.submit(rng.randint(1, 64, size=5), max_tokens=10)
    cb.close()
    assert h.result(1).shape == (10,)
    with pytest.raises(RuntimeError, match="closed"):
        cb.submit(rng.randint(1, 64, size=5))


# -- sampling -----------------------------------------------------------------

def test_sampled_frequencies_follow_softmax():
    """Chi-square: 40,000 draws (one key each, from 400 seeds x 100
    positions) over a fixed 8-token distribution follow
    softmax(logits / t); greedy is the first argmax on ties."""
    logits = torch.tensor([1.0, 0.5, 0.0, -0.5, 2.0, 1.5, -1.0, 0.25])
    t = 0.7
    seeds = torch.arange(400, dtype=torch.int64)[:, None]
    pos = torch.arange(100, dtype=torch.int64)[None, :]
    keys = tgpt._slot_key(seeds, pos).reshape(-1)
    draws = tgpt.sample_token(logits.expand(keys.shape[0], 8), keys,
                              torch.full((keys.shape[0],), t))
    counts = np.bincount(draws.numpy(), minlength=8)
    probs = torch.softmax(logits.double() / t, -1).numpy()
    expected = probs / probs.sum() * counts.sum()
    p_value = stats.chisquare(counts, expected).pvalue
    assert p_value > 1e-3, (counts, expected, p_value)
    # one key per (seed, position): the same key draws the same token
    again = tgpt.sample_token(logits, int(keys[17]), t)
    assert int(again) == int(draws[17])
    ties = torch.tensor([[0.0, 3.0, 3.0, 1.0]])
    assert int(tgpt.sample_token(ties, 5, 0.0)[0]) == 1
    assert int(tgpt.sample_token(ties, 5, torch.zeros(1))[0]) == 1


def test_slot_key_is_int_exact():
    """The key and the noise come from integer ops only: Python ints and
    int64 tensors give the same bits, every value below 2**32."""
    seeds = [0, 1, 42, 2 ** 32 - 1]
    for s in seeds:
        for p in (0, 5, 1023):
            k = tgpt._slot_key(s, p)
            kt = tgpt._slot_key(torch.tensor(s), torch.tensor(p))
            assert 0 <= k < 2 ** 32 and int(kt) == k
    assert len({tgpt._slot_key(s, p) for s in range(50)
                for p in range(50)}) == 2500


# -- the port imports no JAX ---------------------------------------------------

def test_decode_modules_import_no_jax():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.serving.decode\n"
            "import deeplearning4j_tpu_torch.runtime.quantize\n"
            "import deeplearning4j_tpu_torch.models.gpt\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), \
        res.stdout + res.stderr
