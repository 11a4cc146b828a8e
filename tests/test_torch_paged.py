"""The port's paged KV serving against the JAX reference, on the CPU.

At the reference tests' sizes (``tests/test_serving_tier3.py:50-57``:
the target 2 x 32 with vocab 64, fp32), on numpy weights drawn from a
seed (``test_torch_decode.numpy_params``) carried into both packages.
Held: ``PageAllocator``'s properties and a randomized schedule of
alloc/share/free run against the reference's allocator op for op (same
ids, refcounts, ``in_use``); paged greedy tokens equal the pinned
engine's and the JAX paged engine's, and every page is released; paged
int8 equals pinned int8 and paged sampled equals pinned sampled within
the port; ``paged_decode``'s pool writes and tokens equal JAX's on the
same pool and table, and its logits JAX's ``_decode_step`` over the
gathered pages (1e-5); an inactive slot whose stale table still names a
page another slot now owns writes to the trash page; an oversize admit
fails synchronously with the typed error; a small pool makes requests
wait for pages instead of failing them; and a paged burst after
``warmup()`` adds no capture through the CPU stand-in for CUDA-graph
capture of ``tests/test_torch_compile_cache.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models.transformer import TransformerConfig as JCfg
from deeplearning4j_tpu.serving import decode as jdecode
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
from deeplearning4j_tpu_torch.runtime import compile_cache
from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
from deeplearning4j_tpu_torch.serving.decode import (KV_PAGE_TOKENS,
                                                     ContinuousBatcher,
                                                     DecodeEngine,
                                                     KVPagesExhausted,
                                                     PageAllocator)
from test_torch_compile_cache import _record_eagerly, monkeypatch_graphs_off
from test_torch_decode import numpy_params

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

#: ``tests/test_serving_tier3.py``'s target and draft configs
KW = dict(vocab_size=64, max_len=64, hidden=32, n_layers=2, n_heads=2,
          ffn_dim=64, dropout=0.0, compute_dtype="float32", causal=True,
          type_vocab_size=1)
DKW = dict(KW, hidden=16, n_layers=1, ffn_dim=32)
CFG = TransformerConfig(**KW)
DCFG = TransformerConfig(**DKW)
ENGINE = dict(n_slots=2, buckets=(32,), prefill_chunk=8, device="cpu")


def trees(seed=7, dseed=3):
    """(target tree, draft tree) as numpy."""
    return numpy_params(CFG, seed), numpy_params(DCFG, dseed)


def port(tree):
    return tgpt.params_from_numpy(tree, "cpu")


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def engine_tokens(eng, prompt, n, temperature=0.0, seed=0):
    """One request driven to ``n`` tokens by plain or speculative
    advances, honouring ``last_ran`` (either package's engine)."""
    bucket, slot, first = eng.start(np.asarray(prompt, np.int32),
                                    max_tokens=n, temperature=temperature,
                                    seed=seed)
    out = [int(first)]
    while len(out) < n:
        if eng.draft is not None:
            toks, n_c = eng.advance_spec(bucket)
            for j in range(int(n_c[slot])):
                out.append(int(toks[slot, j]))
        else:
            toks = eng.advance(bucket)
            if eng.last_ran(bucket)[slot]:
                out.append(int(toks[slot]))
    eng.release(bucket, slot)
    return out[:n]


def solo(params, prompt, n):
    """The port's solo greedy ``generate``."""
    out = tgpt.generate(CFG, params, torch.from_numpy(
        np.asarray(prompt, np.int32)[None, :]), n, temperature=0.0)
    return [int(t) for t in out[0]]


def audit_zero_pages(eng):
    """After a drain: drop the resident registry, then every page is
    free and every reference accounted for."""
    eng.drop_residents()
    assert eng._alloc.in_use() == 0
    assert eng.pages_unaccounted() == 0


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    """The card's capture path, recorded and replayed eagerly."""
    monkeypatch.setattr(compile_cache, "_graphs_on", lambda dev: True)
    monkeypatch.setattr(compile_cache, "_new_pool", lambda: None)
    monkeypatch.setattr(compile_cache, "_record", _record_eagerly)


@pytest.fixture(scope="module")
def tree():
    return trees()[0]


@pytest.fixture(scope="module")
def params(tree):
    return port(tree)


# -- the page allocator -------------------------------------------------------

def test_kv_page_tokens_matches_prefill_chunk():
    assert KV_PAGE_TOKENS == tgpt.PREFILL_CHUNK == jdecode.KV_PAGE_TOKENS


def test_page_allocator_properties():
    a = PageAllocator(8)                    # page 0 reserved: 7 usable
    assert a.n_free() == 7 and a.in_use() == 0
    ids = a.alloc(3)
    assert len(set(ids)) == 3 and 0 not in ids
    ids2 = a.alloc(4)
    assert not set(ids) & set(ids2)
    assert a.in_use() == 7
    with pytest.raises(KVPagesExhausted) as ei:
        a.alloc(1)
    assert (ei.value.needed, ei.value.free, ei.value.total) == (1, 0, 8)
    a.free(ids)
    assert set(a.alloc(3)) == set(ids)
    p = ids2[0]
    a.share([p])
    assert a.refcount(p) == 2
    a.free([p])
    assert a.refcount(p) == 1 and p not in a._free
    a.free([p])
    assert a.refcount(p) == 0
    with pytest.raises(ValueError):
        a.free([p])
    with pytest.raises(ValueError):
        a.share([0])
    with pytest.raises(ValueError):
        PageAllocator(1)


def test_page_allocator_schedule_matches_reference():
    """A randomized alloc/share/free schedule, op for op on both
    allocators: the same ids, refcounts and ``in_use`` after every op,
    the same typed shortfalls, and a drained pool fully free."""
    rng = np.random.default_rng(0)
    ours, ref = PageAllocator(33), jdecode.PageAllocator(33)
    live = []                               # lists of page references
    for _ in range(400):
        op = rng.random()
        if live and (op < 0.35 or ours.n_free() < 4):
            refs = live.pop(int(rng.integers(len(live))))
            ours.free(refs)
            ref.free(refs)
        elif live and op < 0.5:
            refs = list(live[int(rng.integers(len(live)))])
            ours.share(refs)
            ref.share(refs)
            live.append(refs)
        else:
            n = int(rng.integers(1, 5))
            if n > ours.n_free():
                with pytest.raises(KVPagesExhausted):
                    ours.alloc(n)
                with pytest.raises(jdecode.KVPagesExhausted):
                    ref.alloc(n)
                continue
            got = ours.alloc(n)
            assert got == ref.alloc(n)
            live.append(got)
        assert ours.in_use() == ref.in_use()
        assert ours.total_refs() == ref.total_refs()
        assert all(ours.refcount(p) == ref.refcount(p) for p in range(33))
    for refs in live:
        ours.free(refs)
    assert ours.in_use() == 0 and ours.n_free() == 32


# -- paged == pinned == JAX ---------------------------------------------------

def test_paged_greedy_equals_pinned_and_jax_paged(tree, params):
    paged = DecodeEngine(CFG, params, paged=True, **ENGINE)
    pinned = DecodeEngine(CFG, params, **ENGINE)
    jeng = jdecode.DecodeEngine(JCfg(**KW), jax_tree(tree), n_slots=2,
                                buckets=(32,), prefill_chunk=8, paged=True)
    for e in (paged, pinned, jeng):
        e.warmup()
    decode_metrics.reset()
    for prompt in (np.arange(1, 7), np.arange(3, 22) % 64):
        got = engine_tokens(paged, prompt, 10)
        assert got == engine_tokens(pinned, prompt, 10)
        assert got == engine_tokens(jeng, prompt, 10), prompt
    snap = decode_metrics.snapshot()
    assert snap["pages_in_use_hw"] >= 2     # prompt pages + growth
    audit_zero_pages(paged)
    assert decode_metrics.snapshot()["pages_leaked"] == 0


@pytest.mark.parametrize("mode", ["int8", "sampled"])
def test_paged_matches_pinned(params, mode):
    kw = dict(ENGINE)
    temp, seed = 0.0, 0
    if mode == "int8":
        kw.update(quantize="int8", kv_dtype="int8")
    else:
        temp, seed = 0.8, 5
    paged = DecodeEngine(CFG, params, paged=True, **kw)
    pinned = DecodeEngine(CFG, params, **kw)
    paged.warmup()
    pinned.warmup()
    for prompt in (np.arange(1, 13), np.arange(5, 14)):
        assert engine_tokens(paged, prompt, 12, temp, seed) \
            == engine_tokens(pinned, prompt, 12, temp, seed)
    audit_zero_pages(paged)


def _pool_case(tree, kv_dtype=None):
    """The same pool, page table, tokens and positions in both
    packages: 3 slots of 2 pages of 8 rows over an 8-page pool filled
    with random rows; slot 2 is inactive."""
    rng = np.random.default_rng(11)
    L, NH, D = CFG.n_layers, CFG.n_heads, CFG.hidden // CFG.n_heads
    k = rng.standard_normal((L, 8, 8, NH, D)).astype(np.float32)
    v = rng.standard_normal((L, 8, 8, NH, D)).astype(np.float32)
    ptab = np.array([[1, 2], [3, 4], [5, 0]], np.int32)
    tokens = np.array([7, 9, 11], np.int32)
    pos = np.array([3, 12, 5], np.int32)
    active = np.array([True, True, False])
    return k, v, ptab, tokens, pos, active


def test_paged_decode_matches_jax(tree, params):
    k, v, ptab, tokens, pos, active = _pool_case(tree)
    temps = np.zeros(3, np.float32)
    seeds = np.arange(3)
    jcfg, jp = JCfg(**KW), jax_tree(tree)
    jpool, jout = jgpt.paged_decode(
        jcfg, jp, jgpt.PagedKV(jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(ptab), jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(active), jnp.asarray(temps),
        jnp.asarray(seeds, jnp.uint32))
    with torch.inference_mode():
        pool = tgpt.PagedKV(torch.from_numpy(k.copy()),
                            torch.from_numpy(v.copy()))
        tt, tp = torch.from_numpy(tokens.copy()), torch.from_numpy(pos.copy())
        pool2, out, logits = tgpt.paged_decode(
            CFG, tgpt.serving_params(CFG, params), pool,
            torch.from_numpy(ptab), tt, tp, torch.from_numpy(active),
            torch.from_numpy(temps), torch.from_numpy(seeds),
            return_logits=True)
    assert pool2 is pool                    # updated in place
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # the trash page (0) takes the inactive slot's write in both; every
    # other page must agree
    for got, ref in ((pool.k, jpool.k), (pool.v, jpool.v)):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(ref)[:, 1:], rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(tp.numpy(), pos + active)
    # logits: JAX's dense decode step over each active slot's gathered
    # pages of the pool before the step
    for s in np.flatnonzero(active):
        view = jgpt._paged_view(
            jgpt.PagedKV(jnp.asarray(k), jnp.asarray(v)),
            jnp.asarray(ptab[s:s + 1]), jnp.asarray(tokens[s:s + 1]),
            jnp.asarray(pos[s:s + 1]))
        _, jl = jgpt._decode_step(jcfg, jp, jgpt.KVCache(view.k, view.v),
                                  jnp.asarray(tokens[s:s + 1]),
                                  jnp.int32(pos[s]))
        np.testing.assert_allclose(logits[s].numpy(), np.asarray(jl)[0],
                                   rtol=1e-5, atol=1e-5)


def test_inactive_slot_writes_land_in_the_trash_page(params):
    """Page 3 was slot 0's and now belongs to slot 1.  Slot 0 is
    inactive but its stale table still names page 3 at its position: its
    write must go to the trash page and leave slot 1's rows alone."""
    with torch.inference_mode():
        pool = tgpt.init_pages(CFG, 6, 8, device="cpu")
        g = torch.Generator().manual_seed(0)
        pool = tgpt.PagedKV(*(torch.randn(t.shape, generator=g)
                              for t in pool[:2]))
        before = [t.clone() for t in pool[:2]]
        ptab = torch.tensor([[3, 0], [2, 3]], dtype=torch.int32)
        tokens = torch.tensor([5, 6], dtype=torch.int32)
        pos = torch.tensor([3, 9], dtype=torch.int32)   # slot 1: page 3 row 1
        tgpt.paged_decode(CFG, params, pool, ptab, tokens, pos,
                          torch.tensor([False, True]), torch.zeros(2),
                          torch.zeros(2, dtype=torch.int64))
        for got, old in zip(pool[:2], before):
            changed = (got != old).flatten(3).any(-1)       # [L, P, C]
            assert changed[:, 3, 1].all()                   # slot 1's row
            keep = changed.clone()
            keep[:, 0] = False                              # trash page
            keep[:, 3, 1] = False
            assert not keep.any(), "a write landed outside its page"
            assert changed[:, 0, 3].all()                   # slot 0's


def test_oversize_paged_admit_is_typed_and_sync(params):
    eng = DecodeEngine(CFG, params, paged=True, n_pages=4, **ENGINE)
    eng.warmup()
    with pytest.raises(KVPagesExhausted) as ei:
        eng.check_capacity(25)              # 4 + 1 pages, the pool has 3
    assert ei.value.needed == 5 and ei.value.total == 4
    with ContinuousBatcher(eng) as cb:
        with pytest.raises(KVPagesExhausted):
            cb.submit(np.arange(1, 26, dtype=np.int32), max_tokens=4)
        # one that fits still runs
        assert len(cb.submit(np.arange(1, 6), max_tokens=4).result(60)) == 4


def test_small_pool_requests_wait_for_pages(params):
    """Six requests over a pool of 4 usable pages: admission waits for
    pages, nothing fails, and every request gets the pinned tokens."""
    eng = DecodeEngine(CFG, params, paged=True, n_pages=5, n_slots=4,
                       buckets=(32,), prefill_chunk=8, device="cpu")
    ref = DecodeEngine(CFG, params, **ENGINE)
    eng.warmup()
    ref.warmup()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 64, int(n)) for n in (5, 9, 3, 12, 7, 4)]
    # the high-water mark is process-wide: clear what engines of earlier
    # tests in this process left in it, so it reads this engine's pool
    decode_metrics.reset()
    with ContinuousBatcher(eng) as cb:
        reqs = [cb.submit(p, max_tokens=10) for p in prompts]
        outs = [list(r.result(120)) for r in reqs]
    for p, o in zip(prompts, outs):
        assert o == engine_tokens(ref, p, 10)
    assert decode_metrics.snapshot()["pages_in_use_hw"] <= 4
    audit_zero_pages(eng)


def test_paged_burst_adds_no_capture(graphs_on_cpu, params):
    """The paged engine on the card's capture path: warm-up captures 2
    graphs a bucket, a burst adds none and equals the plain CPU run, and
    a steady step copies nothing (the page tables and masks are copied
    in only when they change)."""
    specs = [(3, 6, 0.0), (11, 20, 0.7), (5, 4, 0.0), (17, 30, 1.0),
             (9, 12, 0.0)]

    def burst(eng):
        rng = np.random.default_rng(1)
        with ContinuousBatcher(eng, default_max_tokens=6) as cb:
            reqs = [cb.submit(rng.integers(0, 64, size=n), max_tokens=m,
                              temperature=t, seed=i)
                    for i, (n, m, t) in enumerate(specs)]
            return [list(r.result(timeout=120)) for r in reqs]

    kw = dict(n_slots=2, buckets=(32, 64), prefill_chunk=8, paged=True,
              device="cpu")
    eng = DecodeEngine(CFG, params, **kw)
    assert eng.warmup()["compiles"] == 4
    outs = burst(eng)
    assert decode_metrics.snapshot()["compile_delta_since_mark"] == 0
    eng.start(np.arange(5), max_tokens=8)
    eng.advance(32)
    n0 = eng._decode.copied_bytes
    eng.advance(32)
    assert eng._decode.copied_bytes == n0
    with monkeypatch_graphs_off():
        assert outs == burst(DecodeEngine(CFG, params, **kw))


def assert_no_jax(*modules):
    """Importing ``modules`` in a fresh interpreter loads no JAX and
    nothing of the JAX package."""
    code = "".join(f"import {m}\n" for m in modules) + (
        "import sys\n"
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


def test_paged_modules_import_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.serving.decode",
                  "deeplearning4j_tpu_torch.models.gpt")
