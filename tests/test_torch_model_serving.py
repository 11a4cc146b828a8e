"""The model axis for a serving fleet, against the JAX reference.

The serving half of the reference's ``tests/test_model_parallel.py``
(``test_router_replicate_device_groups``) and the engine knobs the
reference's model-sharded ``DecodeEngine`` takes (``quantize=``,
``kv_dtype="int8"``, ``draft=``; ``serving/decode.py:603-730``), held on
one spawned group of four gloo CPU ranks (``test_torch_mesh.
run_ranks``).  One rank program (:func:`ms_rank`) runs every case and
returns what the tests read: the engines on a ``data=2 x model=2``
mesh (each model group of two ranks serves alike), the batcher over a
group, and ``Router.replicate(model_degree=2)`` over the four ranks.
The tests compare with the JAX package's replicated engines, run in
this process on the same numpy params (greedy tokens, token for
token).

- int8 weights: the rank's served scales equal the slices of the
  global tree's (quantized before the split, ``quant_specs``), and the
  tokens the reference's int8 engine's;
- int8 KV: each written row's scale equals the replicated engine's
  (its amax over every head of the group), rtol 1e-6, and the tokens
  the reference's;
- a draft on the mesh: speculative tokens equal the reference's plain
  and speculative ones; a draft whose heads do not split raises;
- the batcher on a group: ordered results under concurrent clients, a
  clean ``close()`` that stops the follower, a dispatch failed on the
  follower alone after its collectives replayed on both ranks with the
  same tokens, one failed before them stopping both workers within the
  mesh's timeout, and the worker holding the model group against other
  threads and a second batcher;
- ``Router.replicate(model_degree=2, n_replicas=2)``: two replicas on
  the two groups (the second led over a control group), both serving
  the reference's tokens; a degree above the ranks raises.

The module imports no JAX at its top, so the spawned ranks do not
either; the reference runs inside the tests.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_mesh import run_ranks

torch.set_num_threads(2)

#: seconds the four ranks may take (the suite's other workers share the
#: cores)
DEADLINE_S = 400.0

ENGINE = dict(n_slots=2, buckets=(16,), prefill_chunk=4)
PROMPTS = [[5, 9, 2, 7, 11], [1, 2, 3], [60, 61, 62, 63, 0, 1, 2]]
#: the batcher's requests: (prompt, max_tokens)
BURST = [([5, 9, 2], 6), ([1, 2, 3, 4], 5), ([60, 61], 8), ([7], 4),
         ([3, 3, 3, 3, 3], 7), ([10, 20, 30], 6)]
N_TOK = 8
#: the collective timeout of the mesh whose follower fails before a
#: dispatch's collectives: how long the leader waits inside one
BROKEN_TIMEOUT_S = 10.0


def _cfg_kw():
    return dict(vocab_size=64, max_len=32)


def _port_cfg(**kw):
    from deeplearning4j_tpu_torch.models import gpt
    return dataclasses.replace(gpt.gpt_tiny(**_cfg_kw()),
                               compute_dtype="float32", **kw)


#: the draft: one layer, two heads (splits over a model axis of two)
DRAFT_KW = dict(n_layers=1, hidden=32, n_heads=2, ffn_dim=64)


def _tensors(tree):
    from deeplearning4j_tpu_torch.ops.updaters import tree_map
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _greedy(eng, prompt, n=N_TOK):
    bucket, slot, first = eng.start(np.asarray(prompt, np.int32),
                                    max_tokens=n, temperature=0.0, seed=7)
    toks = [int(first)]
    while len(toks) < n:
        toks.append(int(eng.advance(bucket)[slot]))
    eng.release(bucket, slot)
    return toks


def _spec_greedy(eng, prompt, n=N_TOK):
    bucket, slot, first = eng.start(np.asarray(prompt, np.int32),
                                    max_tokens=n, temperature=0.0, seed=7)
    toks = [int(first)]
    while len(toks) < n:
        out, n_c = eng.advance_spec(bucket)
        toks.extend(int(t) for t in out[slot, :int(n_c[slot])])
    eng.release(bucket, slot)
    return toks[:n]


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------

def _engine_cases(mesh, p):
    from deeplearning4j_tpu_torch.runtime import quantize as qz
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    cfg = _port_cfg()
    params = _tensors(p["params"])
    out = {}
    # int8 weights: the served tree is the slice of the global quantized
    eng = DecodeEngine(cfg, params, mesh=mesh, quantize="int8",
                       device="cpu", **ENGINE)
    out["q8_tokens"] = [_greedy(eng, q) for q in PROMPTS]
    served = eng.current_params()["blocks"]
    whole = qz.quantize_tree(params, "int8")["blocks"]
    r = mesh.model_rank
    out["q8_scales"] = {
        # wq [L, H, NH, D]: heads split, the scale [L, D] spans them all
        "wq": bool(torch.equal(served["wq"].scale, whole["wq"].scale)),
        "wq_q": bool(torch.equal(served["wq"].q,
                                 whole["wq"].q[:, :, 2 * r:2 * r + 2])),
        # wo [L, NH, D, H]: rows split, the scale [L, H] spans them all
        "wo": bool(torch.equal(served["wo"].scale, whole["wo"].scale)),
        # w1 [L, H, F]: columns split, the scale [L, F] with them
        "w1": bool(torch.equal(served["w1"].scale,
                               whole["w1"].scale.chunk(2, 1)[r])),
    }
    out["q8_paged"] = [_greedy(DecodeEngine(
        cfg, params, mesh=mesh, quantize="int8", paged=True, device="cpu",
        **ENGINE), q) for q in PROMPTS[:1]]
    # int8 KV: the scales of a written row are the replicated engine's
    for paged in (False, True):
        eng = DecodeEngine(cfg, params, mesh=mesh, kv_dtype="int8",
                           paged=paged, device="cpu", **ENGINE)
        out[f"kv8_tokens_paged={paged}"] = [_greedy(eng, q) for q in PROMPTS]
    eng = DecodeEngine(cfg, params, mesh=mesh, kv_dtype="int8",
                       device="cpu", **ENGINE)
    rep = DecodeEngine(cfg, params, kv_dtype="int8", device="cpu", **ENGINE)
    for e in (eng, rep):
        b, s, _ = e.start(np.asarray(PROMPTS[0], np.int32), max_tokens=4)
        e.advance(b)
    mine, theirs = (e._state(e._buckets[16])[0] for e in (eng, rep))
    out["kv8_scales"] = (mine.k_scale.numpy(), theirs.k_scale.numpy(),
                         mine.v_scale.numpy(), theirs.v_scale.numpy())
    out["kv8_bytes"] = (eng.kv_bytes_per_slot, rep.kv_bytes_per_slot)
    # a draft on the mesh, pinned and paged
    cfg_d = _port_cfg(**DRAFT_KW)
    draft = (cfg_d, _tensors(p["draft"]))
    for paged in (False, True):
        eng = DecodeEngine(cfg, params, mesh=mesh, draft=draft, draft_k=3,
                           paged=paged, device="cpu", **ENGINE)
        out[f"spec_tokens_paged={paged}"] = [_spec_greedy(eng, q)
                                             for q in PROMPTS]
        if not paged:
            dslots = eng._state(eng._buckets[16])[1]
            out["draft_heads"] = dslots.k.shape[3]
    odd = dataclasses.replace(cfg_d, n_heads=1)
    try:
        DecodeEngine(cfg, params, mesh=mesh, draft=(odd, draft[1]),
                     device="cpu", **ENGINE)
        out["odd_draft"] = "built"
    except ValueError as e:
        out["odd_draft"] = str(e)
    return out


def _batcher_cases(mesh, p):
    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh
    from deeplearning4j_tpu_torch.serving.decode import (BatcherClosed,
                                                         ContinuousBatcher,
                                                         DecodeEngine,
                                                         GroupBroken)

    cfg = _port_cfg()
    params = _tensors(p["params"])
    out = {}
    eng = DecodeEngine(cfg, params, mesh=mesh, device="cpu", **ENGINE)
    b = ContinuousBatcher(eng, default_max_tokens=8)
    out["leads"] = b.leads
    # the worker holds the mesh's model group: a second batcher over an
    # engine of the same mesh, and a collective on the group from this
    # thread, raise (on every rank alike, before any collective)
    other = DecodeEngine(cfg, params, mesh=mesh, device="cpu", **ENGINE)
    held = {}
    for what, fn in (("batcher", lambda: ContinuousBatcher(other)),
                     ("psum", lambda: collectives.psum(torch.ones(2),
                                                       (mesh, "model")))):
        try:
            fn()
            held[what] = "ran"
        except RuntimeError as e:
            held[what] = str(e)
    out["held"] = held
    if b.leads:
        results = [None] * len(BURST)

        def client(i):
            prompt, n = BURST[i]
            h = b.submit(prompt, max_tokens=n)
            results[i] = h.result(120).tolist()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(BURST))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(150)
        out["burst"] = results
    else:
        try:
            b.submit([1, 2])
            out["follower_submit"] = "accepted"
        except RuntimeError as e:
            out["follower_submit"] = str(e)
    b.close()
    out["closed"] = not b._thread.is_alive()
    # a dispatch that fails on the follower alone, after its collectives:
    # both ranks drop the bucket and replay its requests
    eng = DecodeEngine(cfg, params, mesh=mesh, device="cpu", **ENGINE)
    if mesh.model_rank == 1:
        real, calls = eng._decode, [0]

        def flaky(*a, **kw):
            res = real(*a, **kw)
            calls[0] += 1
            if calls[0] == 3:
                raise RuntimeError("injected decode failure")
            return res
        eng._decode = flaky
    b = ContinuousBatcher(eng, default_max_tokens=8)
    if b.leads:
        hs = [b.submit(q, max_tokens=N_TOK) for q in PROMPTS[:2]]
        out["replayed"] = [h.result(120).tolist() for h in hs]
        out["replays"] = [h._replays for h in hs]
    b.close()
    out["replay_closed"] = not b._thread.is_alive()
    # the group's model group is free again once the worker is gone
    out["free_after_close"] = float(collectives.psum(
        torch.ones(()), (mesh, "model")))
    # a dispatch that fails on the follower before its collectives: the
    # leader waits inside the step's first all-reduce until the mesh's
    # timeout, the ranks find they started different numbers of the
    # group's collectives, and both workers stop, the leader resolving
    # its requests with GroupBroken
    short = tmesh.make_mesh(tmesh.MeshSpec(data=2, model=2),
                            timeout=BROKEN_TIMEOUT_S)
    eng = DecodeEngine(cfg, params, mesh=short, device="cpu", **ENGINE)
    if short.model_rank == 1:
        real, calls = eng._decode, [0]

        def early(*a, **kw):
            calls[0] += 1
            if calls[0] == 3:
                raise RuntimeError("injected failure before the collectives")
            return real(*a, **kw)
        eng._decode = early
    t0 = time.perf_counter()
    b = ContinuousBatcher(eng, default_max_tokens=8)
    if b.leads:
        hs = [b.submit(q, max_tokens=N_TOK) for q in PROMPTS[:2]]
        got = []
        for h in hs:
            try:
                got.append(h.result(300).tolist())
            except GroupBroken as e:
                got.append(f"broken: {e}")
        out["broken"] = got
        try:
            b.submit([1, 2])
            out["broken_submit"] = "accepted"
        except BatcherClosed as e:
            out["broken_submit"] = str(e)
    b._thread.join(300)
    out["broken_stopped"] = not b._thread.is_alive()
    out["broken_s"] = time.perf_counter() - t0
    b.close()
    return out


def _router_cases(p):
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.serving.router import Router

    cfg = _port_cfg()
    params = p["params"]
    out = {}
    router = Router.replicate(cfg, params, n_replicas=2, model_degree=2,
                              device="cpu", default_max_tokens=4, **ENGINE)
    out["n_batchers"] = len(router.batchers)
    local = [b.engine.current_params() for b in router.batchers
             if hasattr(b.engine, "current_params")]
    out["bytes"] = [sum(x.numel() * x.element_size() for x in _leaves(t))
                    for t in local]
    if dist.get_rank() == 0:
        prompt = np.array([5, 9, 2], np.int32)
        h1 = router.submit(prompt, max_tokens=4)
        h2 = router.submit(prompt, max_tokens=4)
        out["tokens"] = [h1.result(120).tolist(), h2.result(120).tolist()]
        out["routed"] = list(router.routed)
    else:
        try:
            router.submit([1, 2])
            out["submit"] = "accepted"
        except RuntimeError as e:
            out["submit"] = str(e)
    router.close()
    try:
        Router.replicate(cfg, params, 1, model_degree=8, device="cpu")
        out["too_big"] = "built"
    except ValueError as e:
        out["too_big"] = str(e)
    return out


def _leaves(tree):
    from deeplearning4j_tpu_torch.ops.updaters import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def ms_rank(_data_mesh, p):
    """Every case on this rank of the four."""
    from deeplearning4j_tpu_torch.parallel import mesh as tmesh
    mesh = tmesh.make_mesh(tmesh.MeshSpec(data=2, model=2))
    return {"engine": _engine_cases(mesh, p),
            "batcher": _batcher_cases(mesh, p),
            "router": _router_cases(p)}


# ---------------------------------------------------------------------------
# the reference side and the fixture
# ---------------------------------------------------------------------------

def _jax_cfg(**kw):
    from deeplearning4j_tpu.models import gpt as jgpt
    return dataclasses.replace(jgpt.gpt_tiny(**_cfg_kw()),
                               compute_dtype="float32", **kw)


def _jtree(tree):
    import jax.numpy as jnp
    from deeplearning4j_tpu_torch.ops.updaters import tree_map
    return tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def payload():
    from test_torch_decode import numpy_params
    return {"params": numpy_params(_jax_cfg()),
            "draft": numpy_params(_jax_cfg(**DRAFT_KW), seed=1)}


@pytest.fixture(scope="module")
def ranks(payload, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_serving")
    return run_ranks(ms_rank, 4, tmp, payload, deadline=DEADLINE_S)


def _jax_engine(payload, **kw):
    from deeplearning4j_tpu.serving.decode import DecodeEngine as JEngine
    return JEngine(_jax_cfg(), _jtree(payload["params"]), **ENGINE, **kw)


def _jax_tokens(payload, prompts=PROMPTS, n=N_TOK, **kw):
    eng = _jax_engine(payload, **kw)
    return [_greedy(eng, q, n) for q in prompts]


# ---------------------------------------------------------------------------
# tests: the engine's knobs on a model mesh
# ---------------------------------------------------------------------------

def test_int8_weights_on_a_model_mesh_match_reference(ranks, payload):
    """Greedy tokens of the int8 engine on ``data=2 x model=2`` (pinned
    and paged) equal the reference's replicated int8 engine's, on every
    rank; the served scales are the global tree's (a split leaf's scale
    spans every head), the payloads its slices."""
    want = _jax_tokens(payload, quantize="int8")
    for r in ranks:
        e = r["engine"]
        assert e["q8_tokens"] == want
        assert e["q8_paged"] == want[:1]
        assert all(e["q8_scales"].values()), e["q8_scales"]


@pytest.mark.parametrize("paged", [False, True], ids=["pinned", "paged"])
def test_int8_kv_on_a_model_mesh_matches_reference(ranks, payload, paged):
    """Greedy tokens with an int8 KV cache on the mesh equal the
    reference's replicated int8-KV engine's."""
    want = _jax_tokens(payload, kv_dtype="int8", paged=paged)
    for r in ranks:
        assert r["engine"][f"kv8_tokens_paged={paged}"] == want


def test_int8_kv_scales_span_every_head(ranks):
    """A row's scale on a model rank (its amax over the whole group's
    heads) equals the replicated engine's, rtol 1e-6; the rank's KV
    payload is half the replicated slot's, the scale rows whole."""
    for r in ranks:
        mk, rk, mv, rv = r["engine"]["kv8_scales"]
        assert (rk > 0).any()
        np.testing.assert_allclose(mk, rk, rtol=1e-6, atol=0)
        np.testing.assert_allclose(mv, rv, rtol=1e-6, atol=0)
        mine, rep = r["engine"]["kv8_bytes"]
        cfg = _port_cfg()
        scale_bytes = 2 * cfg.n_layers * 16 * 4
        assert 2 * (mine - scale_bytes) == rep - scale_bytes


@pytest.mark.parametrize("paged", [False, True], ids=["pinned", "paged"])
def test_draft_on_a_model_mesh_matches_reference(ranks, payload, paged):
    """Speculative decoding on the mesh (the draft's heads split beside
    the target's) gives the reference's plain greedy tokens and its
    speculative engine's."""
    from deeplearning4j_tpu.serving.decode import DecodeEngine as JEngine
    plain = _jax_tokens(payload)
    cfg_d = _jax_cfg(**DRAFT_KW)
    jeng = JEngine(_jax_cfg(), _jtree(payload["params"]),
                   draft=(cfg_d, _jtree(payload["draft"])), draft_k=3,
                   paged=paged, **ENGINE)
    spec = [_spec_greedy(jeng, q) for q in PROMPTS]
    assert spec == plain
    for r in ranks:
        assert r["engine"][f"spec_tokens_paged={paged}"] == plain
        assert r["engine"]["draft_heads"] == 1


def test_draft_whose_heads_do_not_split_raises(ranks):
    for r in ranks:
        assert "draft n_heads=1 not divisible by model degree 2" \
            in r["engine"]["odd_draft"]


# ---------------------------------------------------------------------------
# tests: the batcher over a group
# ---------------------------------------------------------------------------

def test_batcher_on_a_group_serves_concurrent_clients_in_order(ranks,
                                                               payload):
    """Six clients at once through the leader: each handle's tokens are
    the reference's greedy continuation of its own prompt; model rank 0
    of each group leads, rank 1 follows and refuses a submit."""
    want = [_jax_tokens(payload, [q], n)[0] for q, n in BURST]
    for g, r in enumerate(ranks):
        b = r["batcher"]
        assert b["leads"] == (g % 2 == 0)
        if b["leads"]:
            assert b["burst"] == want
        else:
            assert "submit on the group's model rank 0" \
                in b["follower_submit"]


def test_batcher_on_a_group_closes_cleanly(ranks):
    """The leader's ``close()`` drains and stops the follower's worker:
    every rank's worker has exited."""
    for r in ranks:
        assert r["batcher"]["closed"] and r["batcher"]["replay_closed"]


def test_batcher_on_a_group_stops_when_a_dispatch_fails_before_its_collectives(
        ranks):
    """A decode dispatch that fails on the follower before it starts any
    of the step's model-group collectives leaves the leader inside one:
    it raises at the mesh's timeout, the agreement finds the ranks out
    of step, and every worker stops (no rank waits past the timeout and
    the channel's bound); the leader's requests resolve with
    ``GroupBroken`` and its batcher takes no more."""
    for g, r in enumerate(ranks):
        b = r["batcher"]
        assert b["broken_stopped"]
        assert b["broken_s"] < BROKEN_TIMEOUT_S + 120.0
        if g % 2 == 0:
            assert all(isinstance(x, str) and "out of step" in x
                       for x in b["broken"]), b["broken"]
            assert "closed" in b["broken_submit"]


def test_batcher_on_a_group_holds_its_model_group(ranks):
    """While a batcher serves a model-sharded engine its worker holds the
    mesh's model group: a second batcher over an engine of that mesh and
    a collective on the group from another thread raise naming the
    holder; after ``close()`` the group runs collectives again."""
    for r in ranks:
        held = r["batcher"]["held"]
        assert "held by thread 'dl4j-decode-batcher'" in held["batcher"]
        assert "close that batcher first" in held["psum"]
        assert r["batcher"]["free_after_close"] == 2.0


def test_batcher_on_a_group_replays_a_failed_dispatch_on_both_ranks(
        ranks, payload):
    """A decode dispatch that fails on the follower alone fails on both
    ranks: the leader replays its requests (one replay each) and the
    tokens are still the reference's."""
    want = _jax_tokens(payload, PROMPTS[:2])
    for r in ranks[::2]:
        assert r["batcher"]["replayed"] == want
        assert r["batcher"]["replays"] == [1, 1]


# ---------------------------------------------------------------------------
# tests: the router over model groups
# ---------------------------------------------------------------------------

def test_router_replicate_device_groups(ranks, payload):
    """``Router.replicate(model_degree=2, n_replicas=2)`` over four
    ranks: two replicas on the two groups, each rank holding a model
    shard of its replica; rank 0 routes one request to each and both
    give the reference's greedy tokens.  A degree above the ranks
    raises ``ValueError`` naming ``model_degree`` on every rank."""
    want = _jax_tokens(payload, [[5, 9, 2]], 4)[0]
    r0 = ranks[0]["router"]
    assert r0["tokens"] == [want, want]
    assert r0["routed"] == [1, 1]
    assert r0["n_batchers"] == 2                # its own and the remote
    for r in ranks[1:]:
        assert r["router"]["n_batchers"] == 1
        assert "submit on global rank 0" in r["router"]["submit"]
    full = sum(np.asarray(a).nbytes for grp in payload["params"].values()
               for a in grp.values())
    for r in ranks:
        for nbytes in r["router"]["bytes"]:
            assert nbytes < 0.8 * full
        assert "model_degree 8" in r["router"]["too_big"]


@pytest.mark.parametrize("mode", ["int8", "bf16", None])
def test_quant_specs_match_reference(payload, mode):
    """``quant_specs`` rewrites GPT's model-axis specs as the reference's
    does: an int8 payload keeps its leaf's spec, a scale takes the
    stack and channel entries; bias and normalization leaves, bf16 and
    no quantization keep theirs."""
    import jax
    from jax.sharding import PartitionSpec as JP
    from deeplearning4j_tpu.models import gpt as jgpt
    from deeplearning4j_tpu.runtime import quantize as jqz
    from deeplearning4j_tpu_torch.models import gpt as tgpt
    from deeplearning4j_tpu_torch.runtime import quantize as tqz

    def axes(tree):
        if isinstance(tree, dict):
            return {k: axes(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return {f: axes(getattr(tree, f)) for f in tree._fields}
        return tuple(tree)

    want = jqz.quant_specs(jgpt.shard_specs(_jax_cfg(), 2),
                           _jtree(payload["params"]), mode)
    got = tqz.quant_specs(tgpt.shard_specs(_port_cfg(), 2),
                          _tensors(payload["params"]), mode)
    jax_axes = jax.tree.map(lambda s: tuple(s), want,
                            is_leaf=lambda x: isinstance(x, JP))
    assert axes(got) == axes(jax_axes)


def test_serving_modules_import_no_jax():
    from test_torch_paged import assert_no_jax
    assert_no_jax("deeplearning4j_tpu_torch.serving.router",
                  "deeplearning4j_tpu_torch.serving.decode",
                  "deeplearning4j_tpu_torch.runtime.quantize")
