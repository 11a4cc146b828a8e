"""The generator repeats under one seed, differs under two, and gives
every seed the same set of sizes."""

import numpy as np
import pytest

from benchmark.traffic import generators

BIG = 2 ** 31 + 12345


def _req_key(reqs):
    return [(r.prompt.tobytes(), r.max_tokens, r.temperature, r.seed)
            for r in reqs]


def test_requests_repeat_and_differ():
    p = generators.load("sharegpt_closed_128")
    a = generators.requests(p, 50257, BIG, 128)
    b = generators.requests(p, 50257, BIG, 128)
    c = generators.requests(p, 50257, BIG + 1, 128)
    assert _req_key(a) == _req_key(b)
    assert _req_key(a) != _req_key(c)
    # the same sizes in the same order under every seed; other tokens
    assert [(r.prompt.size, r.max_tokens, r.temperature) for r in a] == \
        [(r.prompt.size, r.max_tokens, r.temperature) for r in c]
    for r in a:
        assert r.prompt.size + r.max_tokens <= p["max_total"]
        assert r.max_tokens >= 4 and r.prompt.size >= 4
    assert sum(r.temperature == 0.0 for r in a) == 64
    assert {r.temperature for r in a} == {0.0, 1.0}


def test_request_lengths_keep_the_published_means():
    """Before the cap, a block's quantiles keep the source's means (the
    midpoints of 64 quantiles fall a little short of an exponential's
    tail)."""
    p = generators.load("sharegpt_closed_128")
    for key in ("prompt", "output"):
        dist = {k: v for k, v in p[key].items() if k not in ("lo", "hi")}
        q = generators.stratified(dist, 64, 64,
                                  generators.schedule_rng(3, p),
                                  integer=False)
        assert q.mean() == pytest.approx(dist["mean"], rel=0.04)


def test_schedule_seed_moves_the_sizes():
    p = generators.load("mlm_b32_t128")
    a = generators.mlm_pairs(p, 30522, BIG)
    b = generators.mlm_pairs({**p, "schedule_seed": 7}, 30522, BIG)
    assert not np.array_equal(a.attention_mask, b.attention_mask)


def test_lm_packed():
    p = generators.load("lm_pack_b8_t1024")
    a = generators.lm_packed(p, 50257, BIG)
    assert a.shape == (p["n_batches"], 8, 1024) and a.dtype == np.int32
    assert np.array_equal(a, generators.lm_packed(p, 50257, BIG))
    assert not np.array_equal(a, generators.lm_packed(p, 50257, BIG + 1))
    assert a.min() >= 0 and a.max() < 50257
    eos = (a == p["eos_id"]).mean()
    assert 0.0005 < eos < 0.02              # documents of a few hundred
    rows = a.reshape(-1, 1024)
    assert len({r.tobytes() for r in rows}) == rows.shape[0]


def test_mlm_pairs():
    p = generators.load("mlm_b32_t128")
    b = generators.mlm_pairs(p, 30522, BIG)
    again = generators.mlm_pairs(p, 30522, BIG)
    other = generators.mlm_pairs(p, 30522, BIG + 1)
    assert all(np.array_equal(x, y) for x, y in zip(b, again))
    assert not np.array_equal(b.token_ids, other.token_ids)
    lengths = b.attention_mask.sum(-1)
    short = (lengths < 128).mean()
    assert short == pytest.approx(0.1, abs=0.02)
    assert lengths.min() >= 32
    rate = b.mlm_mask.sum() / (lengths - 3).sum()
    assert rate == pytest.approx(0.15, abs=0.01)
    assert ((b.mlm_mask > 0) <= (b.attention_mask > 0)).all()
    assert (b.token_ids[..., 0] == p["cls_id"]).all()
    assert set(np.unique(b.type_ids)) == {0, 1}
