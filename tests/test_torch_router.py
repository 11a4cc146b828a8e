"""The port's ``serving/router.Router``, ``rebind_params`` and request
replay, on the CPU.

After ``tests/test_decode.py:247-330`` and ``tests/test_serving_tier3.py:
318-350, 510``: least-depth dispatch, the typed load shed (booked in
``requests_shed``), validation, ``close`` draining accepted requests;
``Router.replicate`` on the CPU with client threads; ``rebind_params``
(a busy engine raises, an idle one serves the new weights with the
tokens of a fresh engine built on them and no new capture, its resident
registry is freed and a host-store entry of the old weights no longer
hits); ``evacuate`` / ``resubmit`` of a replica's unfinished requests,
greedy and sampled, continuing with the tokens of an undisturbed run;
a failed dispatch returning its pages and replaying its requests bit
for bit; the fleet's names, which import, the model-degree refusal,
and an engine on a pipe mesh, which builds.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
from deeplearning4j_tpu_torch.serving import router as trouter
from deeplearning4j_tpu_torch.serving.decode import (BatcherClosed,
                                                     ContinuousBatcher,
                                                     DecodeEngine,
                                                     PrefixCache,
                                                     _ReplayRequest)
from deeplearning4j_tpu_torch.serving.router import (OverloadedError,
                                                     Router, RouterClosed)
from test_torch_paged import (CFG, ENGINE, assert_no_jax, audit_zero_pages,
                              engine_tokens, port, solo, trees)
from test_torch_paged import graphs_on_cpu  # noqa: F401 (a fixture)

torch.set_num_threads(2)

ROUTER_ENGINE = dict(n_slots=4, buckets=(32, 64), device="cpu")


@pytest.fixture(scope="module")
def tree():
    return trees()[0]


@pytest.fixture(scope="module")
def params(tree):
    return port(tree)


@pytest.fixture(scope="module")
def engine(params):
    eng = DecodeEngine(CFG, params, **ROUTER_ENGINE)
    eng.warmup()
    return eng


def test_router_least_depth_dispatch(params, engine):
    eng2 = DecodeEngine(CFG, params, **ROUTER_ENGINE)
    eng2.warmup()
    router = Router([ContinuousBatcher(engine, default_max_tokens=12),
                     ContinuousBatcher(eng2, default_max_tokens=12)],
                    max_queue_depth=8)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 64, size=4) for _ in range(2)]
    with router:
        h = [router.submit(p, max_tokens=12) for p in prompts]
        depths = router.depths()
        assert sorted(depths) == [1, 1] or sum(depths) < 2  # may finish
        assert router.routed == [1, 1]
        for p, x in zip(prompts, h):
            assert list(x.result(60)) == solo(params, p, 12)


def test_router_load_shed(engine):
    b = ContinuousBatcher(engine, default_max_tokens=24)
    router = Router([b], max_queue_depth=1)
    shed_before = decode_metrics.snapshot()["requests_shed"]
    rng = np.random.RandomState(8)
    with router:
        keep = router.submit(rng.randint(1, 64, size=4), max_tokens=56)
        with pytest.raises(OverloadedError) as ei:
            router.submit(rng.randint(1, 64, size=4), max_tokens=4)
        assert ei.value.bound == 1 and ei.value.replicas == 1
        assert ei.value.depth >= 1
        assert keep.result(60).shape == (56,)
    assert decode_metrics.snapshot()["requests_shed"] == shed_before + 1
    with pytest.raises(RouterClosed):
        router.submit(rng.randint(1, 64, size=4))


def test_router_validation(tree):
    with pytest.raises(ValueError):
        Router([], max_queue_depth=4)
    b = ContinuousBatcher(DecodeEngine(CFG, port(tree), **ENGINE))
    try:
        with pytest.raises(ValueError):
            Router([b], max_queue_depth=0)
    finally:
        b.close()
    with pytest.raises(ValueError):
        Router.replicate(CFG, tree, 0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Router.replicate(CFG, tree, 1)


def test_close_drains_accepted_requests(engine):
    rng = np.random.RandomState(10)
    router = Router([ContinuousBatcher(engine, default_max_tokens=10)])
    h = router.submit(rng.randint(1, 64, size=5), max_tokens=10)
    router.close()
    assert h.result(1).shape == (10,)           # ran to completion
    with pytest.raises(RouterClosed):
        router.submit(rng.randint(1, 64, size=5))
    with pytest.raises(BatcherClosed):
        router.batchers[0].submit(rng.randint(1, 64, size=5))


def test_replicate_serves_client_threads(tree, params):
    """Two replicas from a numpy tree on the CPU, 16 requests from 8
    client threads: all complete with the solo tokens, and both
    replicas serve."""
    router = Router.replicate(CFG, tree, 2, devices=["cpu"], n_slots=2,
                              buckets=(32, 64), prefill_chunk=8,
                              max_queue_depth=64)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, 64, size=3 + i % 7).astype(np.int32)
               for i in range(16)]
    outs = [None] * 16
    with router:
        def client(k):
            for i in (k, k + 8):
                outs[i] = router.submit(prompts[i], max_tokens=6).result(120)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
    for p, o in zip(prompts, outs):
        assert list(o) == solo(params, p, 6)
    assert sum(router.routed) == 16 and min(router.routed) > 0


# -- rebind -------------------------------------------------------------------

def test_rebind_params(graphs_on_cpu, tree, params):  # noqa: F811
    """A busy engine refuses; an idle one serves the new weights with a
    fresh engine's tokens and no new capture; its resident registry is
    freed, and the host-store entry of the old weights no longer hits."""
    p_new = port(trees(seed=11)[0])
    store = PrefixCache()
    eng = DecodeEngine(CFG, params, paged=True, prefix_cache=store,
                       **ENGINE)
    eng.warmup()
    head = np.arange(1, 17, dtype=np.int32)
    engine_tokens(eng, np.concatenate([head, [20]]), 6)
    eng.flush_harvests()
    assert eng._alloc.in_use() > 0              # the resident registry
    assert store.stats()["entries"] == 1
    bucket, slot, _ = eng.start(np.arange(1, 8), max_tokens=4)
    with pytest.raises(RuntimeError, match="busy"):
        eng.rebind_params(p_new)
    eng.release(bucket, slot)
    decode_metrics.mark_compiles()
    eng.rebind_params(p_new)
    assert eng._alloc.in_use() == 0             # registry freed
    fresh = DecodeEngine(CFG, p_new, paged=True, **ENGINE)
    fresh.warmup()
    decode_metrics.mark_compiles()
    hits = decode_metrics.snapshot()["prefix_hits"]
    for prompt in (np.concatenate([head, [30]]), np.arange(2, 11)):
        assert engine_tokens(eng, prompt, 8) == engine_tokens(fresh, prompt,
                                                              8)
    assert decode_metrics.snapshot()["prefix_hits"] == hits
    assert decode_metrics.snapshot()["compile_delta_since_mark"] == 0
    assert engine_tokens(eng, np.arange(2, 11), 8) == solo(p_new,
                                                           np.arange(2, 11),
                                                           8)
    with pytest.raises(ValueError, match="draft"):
        eng.rebind_params(p_new, draft_params=p_new)
    audit_zero_pages(eng)


# -- replay -------------------------------------------------------------------

def test_evacuate_and_resubmit_replay_bit_exact(params):
    """Replica 0 is evacuated mid-burst; its requests, greedy and
    sampled, finish on replica 1 with the tokens an undisturbed run
    gives."""
    specs = [(np.arange(1, 9), 0.0, 1), (np.arange(4, 15), 0.8, 2),
             (np.arange(9, 14), 0.7, 3), (np.arange(2, 20), 0.0, 4)]
    ref_eng = DecodeEngine(CFG, params, **ROUTER_ENGINE)
    expect = [engine_tokens(ref_eng, p, 20, t, s) for p, t, s in specs]
    engines = [DecodeEngine(CFG, params, **ROUTER_ENGINE) for _ in range(2)]
    for e in engines:
        e.warmup()
    router = Router([ContinuousBatcher(e, default_max_tokens=20)
                     for e in engines])
    before = decode_metrics.snapshot()["requests_replayed"]
    with router:
        src = router.batchers[0]
        handles = [src.submit(p, max_tokens=20, temperature=t, seed=s)
                   for p, t, s in specs]
        deadline = time.time() + 60
        while len(handles[0]._tokens) < 3 and time.time() < deadline:
            time.sleep(0.001)
        moved = src.evacuate()
        assert len(moved) >= 1
        for r in moved:
            router.batchers[1].resubmit(_ReplayRequest(r))
            decode_metrics.note_request_replayed()
        with pytest.raises(BatcherClosed):
            src.submit(np.arange(1, 5), max_tokens=4)
        outs = [list(h.result(120)) for h in handles]
    assert outs == expect
    assert decode_metrics.snapshot()["requests_replayed"] - before == \
        len(moved)


def test_failed_dispatch_returns_pages_and_replays(params):
    eng = DecodeEngine(CFG, params, paged=True, **ENGINE)
    eng.warmup()
    prompt = np.arange(2, 9, dtype=np.int32)
    with ContinuousBatcher(eng, default_max_tokens=6) as b:
        expect = list(b.submit(prompt, max_tokens=6, temperature=0.8,
                               seed=11).result(60))
        before = decode_metrics.snapshot()["requests_replayed"]
        good = eng._decode
        fired = []

        def poisoned(*a, **kw):
            if not fired:
                fired.append(1)
                raise RuntimeError("injected dispatch fault")
            return good(*a, **kw)

        eng._decode = poisoned
        got = list(b.submit(prompt, max_tokens=6, temperature=0.8,
                            seed=11).result(60))
        assert fired and got == expect
        assert decode_metrics.snapshot()["requests_replayed"] - before >= 1
        assert b.worker_alive()
        eng._decode = good
    audit_zero_pages(eng)


# -- what is not ported -------------------------------------------------------

def test_stub_messages_name_their_items(tree, params):
    # the fleet half is ported: its names import
    from deeplearning4j_tpu_torch.serving.router import (  # noqa: F401
        AutoscalePolicy, AutoscalingRouter, ReplicaHealth, SwapFailed)
    for name in ("AutoscalingRouter", "AutoscalePolicy", "ReplicaHealth",
                 "SwapFailed"):
        assert isinstance(getattr(trouter, name), type)
    # model groups are ported: without a process group of two ranks a
    # degree of 2 cannot be filled (the reference's error); serving on a
    # pipe mesh is ported too (tests/test_torch_pipe_serving.py), while
    # Router.replicate builds model meshes only, as the reference's
    # (serving/router.py:160-200): its one replica here is unsharded
    with pytest.raises(ValueError, match="model_degree 2"):
        Router.replicate(CFG, tree, 1, model_degree=2, device="cpu")
    eng = DecodeEngine(CFG, params, device="cpu", mesh=types.SimpleNamespace(
        shape={"data": 1, "pipe": 2}, axis_names=("data", "pipe"),
        ranks=(0, 1), rank=0, device=torch.device("cpu"), backend="gloo"))
    assert eng.model_degree == 1 and eng.mesh.shape["pipe"] == 2


def test_router_modules_import_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.serving.router")
