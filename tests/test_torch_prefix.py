"""The port's prefix store against the JAX reference, on the CPU.

Held: ``PrefixCache`` semantics table-driven against the reference's
store (the same inserts, then the same lookup results, alias hits,
evictions and ``stats()``); a hit's continuation bit-exact against the
cold prefill with fp32 and with int8 KV, with hits, misses and saved
tokens booked and no new capture; a store shared by two batchers (and
missed by an engine of another KV space); harvesting that extends a
partial hit to the longer prefix; a paged engine mounting a resident
prefix by reference (refcounts, no copy) and returning the pages on
release; and pages harvested by the JAX engine continuing greedy-
identically in the port's engine, which shows the page layout is
shared.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import TransformerConfig as JCfg
from deeplearning4j_tpu.serving import decode as jdecode
from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
from deeplearning4j_tpu_torch.serving.decode import (ContinuousBatcher,
                                                     DecodeEngine,
                                                     PrefixCache)
from test_torch_paged import (CFG, ENGINE, KW, assert_no_jax,
                              audit_zero_pages, engine_tokens, jax_tree,
                              port, solo, trees)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree():
    return trees()[0]


@pytest.fixture(scope="module")
def params(tree):
    return port(tree)


# -- the store ----------------------------------------------------------------

def _pages(n, fill):
    return (np.full((2, n, 2, 4), fill, np.float32),
            np.full((2, n, 2, 4), fill + 0.5, np.float32))


def test_prefix_cache_table_matches_reference():
    """The same table of inserts and lookups on both stores, under a
    byte bound that forces evictions: every insert's verdict, every
    lookup's length and pages, and ``stats()`` agree after each row."""
    C = 8
    toks = np.arange(100, 124, dtype=np.int32)          # 3 chunks
    toks2 = np.arange(200, 224, dtype=np.int32)
    entry = int(toks.nbytes + sum(p.nbytes for p in _pages(24, 1.0)))
    table = [
        ("insert", toks, _pages(24, 1.0), None),
        ("insert", toks, _pages(24, 1.0), None),         # a duplicate
        ("lookup", np.concatenate([toks, [9, 9, 9]]), None, None),
        ("lookup", np.concatenate([toks[:8], [1, 2, 3, 4]]), None, None),
        ("lookup", toks, None, None),                     # strict prefix
        ("lookup", np.arange(1, 10, dtype=np.int32), None, None),
        ("lookup", np.concatenate([toks, [9]]), None, "other space"),
        ("insert", toks[:16], _pages(16, 3.0), None),     # shared aliases
        ("lookup", np.concatenate([toks[:16], [7, 7]]), None, None),
        ("insert", toks2, _pages(24, 5.0), None),         # evicts the LRU
        ("lookup", np.concatenate([toks, [9]]), None, None),
        ("lookup", np.concatenate([toks2, [9]]), None, None),
        ("insert", np.arange(300, 324, dtype=np.int32), _pages(24, 7.0),
         None),
        ("lookup", np.concatenate([toks[:16], [7, 7, 7]]), None, None),
        ("lookup", np.concatenate([toks2[:8], [1]]), None, None),
    ]
    ours = PrefixCache(max_bytes=2 * entry + 200)
    ref = jdecode.PrefixCache(max_bytes=2 * entry + 200)
    for i, (op, t, pages, space) in enumerate(table):
        if op == "insert":
            assert ours.insert(t, pages, C, space) \
                == ref.insert(t, pages, C, space), i
        else:
            a, b = ours.lookup(t, C, space), ref.lookup(t, C, space)
            assert (a is None) == (b is None), i
            if a is not None:
                assert a[0] == b[0], i
                for x, y in zip(a[1], b[1]):
                    np.testing.assert_array_equal(x, y)
        assert ours.stats() == ref.stats(), i
    with pytest.raises(ValueError, match="multiple"):
        ours.insert(toks[:5], _pages(5, 1.0), C)
    # stored pages own their memory: a slice of a large base is not
    # accounted as the base
    base = np.zeros((2, 1024, 2, 4), np.float32)
    owned = PrefixCache()
    owned.insert(np.arange(8, dtype=np.int32), (base[:, :8], base[:, :8]), C)
    assert owned.stats()["bytes"] < base.nbytes
    ours.clear()
    assert ours.stats() == {"entries": 0, "bytes": 0}


# -- hits ---------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefix_hit_bit_exact_vs_cold(params, kv_dtype):
    store = PrefixCache()
    eng = DecodeEngine(CFG, params, prefix_cache=store, kv_dtype=kv_dtype,
                       **ENGINE)
    assert eng.warmup()["compiles"] == 2
    rng = np.random.RandomState(4)
    prompt = rng.randint(1, CFG.vocab_size, size=21).astype(np.int32)
    base = decode_metrics.snapshot()
    cold = engine_tokens(eng, prompt, 8)
    eng.flush_harvests()
    assert store.stats()["entries"] == 1
    s1 = decode_metrics.snapshot()
    assert s1["prefix_misses"] == base["prefix_misses"] + 1
    decode_metrics.mark_compiles()
    hot = engine_tokens(eng, prompt, 8)
    s2 = decode_metrics.snapshot()
    assert hot == cold
    if kv_dtype is None:
        assert cold == solo(params, prompt, 8)
    assert s2["prefix_hits"] == base["prefix_hits"] + 1
    assert s2["prefill_tokens_saved"] == base["prefill_tokens_saved"] + 16
    assert s2["compile_delta_since_mark"] == 0
    # a partial hit: two shared chunks, then another tail
    p2 = np.concatenate([prompt[:16], rng.randint(1, 64, size=6)])
    cold2 = engine_tokens(DecodeEngine(CFG, params, kv_dtype=kv_dtype,
                                       **ENGINE), p2, 8)
    assert engine_tokens(eng, p2, 8) == cold2
    assert decode_metrics.snapshot()["prefix_hits"] == base["prefix_hits"] + 2
    eng.close()


def test_shared_store_through_two_batchers(params):
    store = PrefixCache()
    eng1 = DecodeEngine(CFG, params, prefix_cache=store, **ENGINE)
    eng1.warmup()
    rng = np.random.RandomState(6)
    prompt = rng.randint(1, CFG.vocab_size, size=17).astype(np.int32)
    with ContinuousBatcher(eng1, default_max_tokens=6) as cb:
        cold = list(cb.submit(prompt, max_tokens=6).result(60))
        eng1.flush_harvests()
        h0 = decode_metrics.snapshot()["prefix_hits"]
        assert list(cb.submit(prompt, max_tokens=6).result(60)) == cold
        assert decode_metrics.snapshot()["prefix_hits"] == h0 + 1
    eng2 = DecodeEngine(CFG, params, prefix_cache=store, paged=True,
                        **ENGINE)
    eng2.warmup()
    with ContinuousBatcher(eng2, default_max_tokens=6) as cb:
        h1 = decode_metrics.snapshot()["prefix_hits"]
        assert list(cb.submit(prompt, max_tokens=6).result(60)) == cold
        assert decode_metrics.snapshot()["prefix_hits"] == h1 + 1
    audit_zero_pages(eng2)
    # another KV space (int8) misses the fp32 pages and still decodes
    # from its own cold prefill
    eng8 = DecodeEngine(CFG, params, prefix_cache=store, kv_dtype="int8",
                        **ENGINE)
    eng8.warmup()
    h2 = decode_metrics.snapshot()["prefix_hits"]
    ref8 = engine_tokens(DecodeEngine(CFG, params, kv_dtype="int8",
                                      **ENGINE), prompt, 6)
    assert engine_tokens(eng8, prompt, 6) == ref8
    assert decode_metrics.snapshot()["prefix_hits"] == h2


def test_harvest_extends_on_partial_hit(params):
    eng = DecodeEngine(CFG, params, prefix_cache=True, n_slots=2,
                       buckets=(64,), prefill_chunk=8, device="cpu")
    eng.warmup()
    rng = np.random.RandomState(12)
    p1 = rng.randint(1, CFG.vocab_size, size=20).astype(np.int32)
    engine_tokens(eng, p1, 4)                           # miss, stores 16
    eng.flush_harvests()
    p2 = np.concatenate([p1, rng.randint(1, 64, size=17).astype(np.int32)])
    s0 = decode_metrics.snapshot()
    assert engine_tokens(eng, p2, 4) == solo(params, p2, 4)
    eng.flush_harvests()
    s1 = decode_metrics.snapshot()
    assert s1["prefill_tokens_saved"] - s0["prefill_tokens_saved"] == 16
    p3 = np.concatenate([p2, rng.randint(1, 64, size=8).astype(np.int32)])
    assert engine_tokens(eng, p3, 4) == solo(params, p3, 4)
    s2 = decode_metrics.snapshot()
    assert s2["prefill_tokens_saved"] - s1["prefill_tokens_saved"] == 32


def test_resident_prefix_mounts_by_reference(params):
    eng = DecodeEngine(CFG, params, paged=True, **ENGINE)
    eng.warmup()
    head = np.arange(1, 17, dtype=np.int32)             # two whole chunks
    p1 = np.concatenate([head, [20, 21]])
    p2 = np.concatenate([head, [30]])
    assert engine_tokens(eng, p1, 8) == solo(params, p1, 8)
    held = eng._alloc.in_use()
    assert held >= 2                                    # the registry's
    before = decode_metrics.snapshot()["prefix_hits"]
    bucket, slot, first = eng.start(p2, max_tokens=8)
    assert decode_metrics.snapshot()["prefix_hits"] == before + 1
    b = eng._buckets[bucket]
    shared = [int(x) for x in b.ptab[slot, :2]]
    assert all(eng._alloc.refcount(p) >= 2 for p in shared)
    out = [first]
    while len(out) < 8:
        out.append(int(eng.advance(bucket)[slot]))
    eng.release(bucket, slot)
    assert out == solo(params, p2, 8)
    assert all(eng._alloc.refcount(p) >= 1 for p in shared)
    assert eng._alloc.in_use() == held                  # only decrefs
    audit_zero_pages(eng)


def test_jax_harvested_pages_continue_in_the_port(tree, params):
    """The JAX engine harvests a prompt's prefix pages into its store;
    the same numpy pages, inserted into the port's store under the
    port's KV space, mount into a pinned and a paged port engine, whose
    continuations equal a cold port prefill's and JAX's, greedy."""
    jstore = jdecode.PrefixCache()
    jeng = jdecode.DecodeEngine(JCfg(**KW), jax_tree(tree), n_slots=2,
                                buckets=(32,), prefill_chunk=8,
                                prefix_cache=jstore)
    jeng.warmup()
    rng = np.random.RandomState(9)
    prompt = rng.randint(1, CFG.vocab_size, size=19).astype(np.int32)
    jcold = engine_tokens(jeng, prompt, 8)
    jeng.flush_harvests()
    hit = jstore.lookup(prompt, 8, jeng._prefix_space)
    assert hit is not None and hit[0] == 16
    for paged in (False, True):
        store = PrefixCache()
        eng = DecodeEngine(CFG, params, prefix_cache=store, paged=paged,
                           **ENGINE)
        eng.warmup()
        assert store.insert(prompt[:16], tuple(np.asarray(p)
                                               for p in hit[1]),
                            8, eng._prefix_space)
        h0 = decode_metrics.snapshot()["prefix_hits"]
        got = engine_tokens(eng, prompt, 8)
        assert decode_metrics.snapshot()["prefix_hits"] == h0 + 1
        assert got == solo(params, prompt, 8) == jcold
        eng.close()


def test_prefix_modules_import_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.serving.decode")
