"""The port's serving fleet under swaps and faults, against the JAX
reference, on the CPU.

After ``tests/test_serving_tier3.py:352-685``, at its sizes (target 2 x
32 and draft 1 x 16, vocab 64, fp32, on numpy weights drawn from a seed
and carried into both packages).  Held: ``swap_weights`` under live
traffic drops no request, books ``swaps_completed``, costs no capture,
and afterwards serves the tokens of a fresh engine on the new tree and
of the JAX package's fleet swapped to it (greedy), plain and int8; a
one-replica fleet swaps through a temporary replica that costs exactly
one warm-up's captures and is retired; deadlines validate, expire typed
while queued behind ``exhaust_pages`` and while placed behind
``stall_dispatch``; a poisoned dispatch replays in place; a killed
worker is replaced by the health monitor and its requests replay bit for
bit (greedy ones equal the JAX package's); the brownout ladder climbs
(speculation off, then harvesting off) before shedding and walks back,
with no speculative round at level 1 or above and fp32 tokens unchanged;
a submit racing ``close`` either completes or raises ``RouterClosed``;
and a wedged fleet's swap raises ``SwapFailed`` with its drain states.

Captures (the port's form of the reference's "zero new compiles"): a
replica the factory builds costs exactly ``W`` captures (one
``warmup()``'s ``"compiles"``) and nothing after its warm-up; a swap, a
rebind, a replay and a brownout transition cost 0.  The tests hold
``compile_count - before == W x (replicas the factory built)``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import TransformerConfig as JCfg
from deeplearning4j_tpu.serving import decode as jdecode
from deeplearning4j_tpu.serving import router as jrouter
from deeplearning4j_tpu_torch.parallel.chaos import ServingChaos
from deeplearning4j_tpu_torch.runtime.metrics import (compile_metrics,
                                                      decode_metrics)
from deeplearning4j_tpu_torch.serving.decode import (BatcherClosed,
                                                     DeadlineExceeded,
                                                     DecodeEngine,
                                                     PrefixCache)
from deeplearning4j_tpu_torch.serving.router import (AutoscalePolicy,
                                                     AutoscalingRouter,
                                                     OverloadedError,
                                                     ReplicaHealth,
                                                     RouterClosed,
                                                     SwapFailed)
from test_torch_autoscale import counted_factory, jax_greedy, wait_for
from test_torch_decode import numpy_params
from test_torch_paged import (CFG, DCFG, KW, assert_no_jax,
                              audit_zero_pages, engine_tokens, jax_tree,
                              port, trees)

torch.set_num_threads(2)

FT = dict(n_slots=2, buckets=(32,), prefill_chunk=8, paged=True,
          device="cpu", default_max_tokens=6)


@pytest.fixture(scope="module")
def tree():
    return trees()[0]


@pytest.fixture(scope="module")
def params(tree):
    return port(tree)


@pytest.fixture(scope="module")
def tree_2():
    return numpy_params(CFG, 13)


def ft_batcher(params, **kw):
    builds = []
    return counted_factory(params, builds, **dict(FT, **kw))()


# -- the hot weight swap ------------------------------------------------------

def test_router_swap_weights_zero_drops(tree, params, tree_2):
    """A live two-replica fleet rolls onto a new tree: no request fails,
    requests during the swap are counted, the swap is booked, it costs
    no capture, and afterwards greedy requests give a fresh engine's
    tokens on the new tree and the JAX package's swapped fleet's."""
    store = PrefixCache()
    builds = []
    factory = counted_factory(params, builds, n_slots=4,
                              prefix_cache=store, **{
                                  k: v for k, v in FT.items()
                                  if k != "n_slots"})
    router = AutoscalingRouter(
        factory, AutoscalePolicy(min_replicas=2, max_replicas=2))
    before = decode_metrics.snapshot()
    c0 = compile_metrics.compile_count
    stop = threading.Event()
    errors, served = [], []

    def traffic(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                served.append(router.generate(rng.integers(1, 64, size=9),
                                              timeout=60.0))
            except Exception as e:          # any drop is a failure
                errors.append(e)

    # two requests in flight: with one, a single request can straddle the
    # whole swap, and none is booked as arriving during it
    threads = [threading.Thread(target=traffic, args=(seed,))
               for seed in (2, 3)]
    for t in threads:
        t.start()
    try:
        assert wait_for(lambda: len(served) >= 2)
        assert router.swap_weights(port(tree_2), timeout=60.0) == 2
        n = len(served)
        assert wait_for(lambda: len(served) >= n + 2)
    finally:
        stop.set()
        for t in threads:
            t.join(60.0)
    assert not any(t.is_alive() for t in threads)
    prompts = [np.arange(1, 8), np.arange(3, 12), np.arange(9, 14),
               np.arange(20, 31)]
    outs = [list(router.generate(p, timeout=60.0, max_tokens=8))
            for p in prompts]
    router.close(timeout=30.0)
    assert not errors, errors[:3]
    after = decode_metrics.snapshot()
    assert after["swaps_completed"] == before["swaps_completed"] + 1
    assert after["requests_during_swap"] > before["requests_during_swap"]
    assert compile_metrics.compile_count == c0          # 0 captures
    assert router._draining == set() and not router._swapping
    fresh = DecodeEngine(CFG, port(tree_2), n_slots=4, buckets=(32,),
                         prefill_chunk=8, paged=True, device="cpu")
    fresh.warmup()
    assert outs == [engine_tokens(fresh, p, 8) for p in prompts]
    # the JAX package's fleet, swapped to the same tree
    jcfg = JCfg(**KW)

    def jfactory():
        eng = jdecode.DecodeEngine(jcfg, jax_tree(tree), n_slots=4,
                                   buckets=(32,), prefill_chunk=8,
                                   paged=True)
        eng.warmup()
        return jdecode.ContinuousBatcher(eng, default_max_tokens=6)

    jr = jrouter.AutoscalingRouter(
        jfactory, jrouter.AutoscalePolicy(min_replicas=2, max_replicas=2))
    try:
        assert jr.swap_weights(jax_tree(tree_2), timeout=60.0) == 2
        jouts = [[int(x) for x in jr.generate(p, timeout=60.0,
                                              max_tokens=8)]
                 for p in prompts]
    finally:
        jr.close()
    assert outs == jouts


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_swap_single_replica_through_a_temporary_replica(params, tree_2,
                                                         quantize):
    """A one-replica fleet swaps with no downtime: a temporary factory
    replica on the old weights serves while the real one drains, is
    swapped too, then retired.  It costs exactly W captures (the
    temporary replica's warm-up) and the swap itself none; afterwards
    the fleet gives a fresh engine's tokens on the new tree (int8: the
    requantization ran on the swapping thread)."""
    builds = []
    factory = counted_factory(params, builds, quantize=quantize,
                              **FT)
    router = AutoscalingRouter(
        factory, AutoscalePolicy(min_replicas=1, max_replicas=2))
    W = builds[0]
    c0 = compile_metrics.compile_count
    added = decode_metrics.snapshot()["replicas_added"]
    assert router.swap_weights(port(tree_2), timeout=60.0) == 2
    assert router.n_replicas() == 1            # the temporary one retired
    assert compile_metrics.compile_count - c0 == W
    assert decode_metrics.snapshot()["replicas_added"] == added + 1
    prompts = [np.arange(1, 6), np.arange(7, 19)]
    outs = [list(router.generate(p, timeout=60.0, max_tokens=6))
            for p in prompts]
    router.close(timeout=30.0)
    assert compile_metrics.compile_count - c0 == W
    fresh = DecodeEngine(CFG, port(tree_2), n_slots=2, buckets=(32,),
                         prefill_chunk=8, paged=True, quantize=quantize,
                         device="cpu")
    fresh.warmup()
    assert outs == [engine_tokens(fresh, p, 6) for p in prompts]
    if quantize is None:
        assert outs == [jax_greedy(tree_2, p, 6) for p in prompts]


def test_swap_failed_typed_with_drain_states_on_wedged_fleet(params,
                                                             tree_2):
    """A fleet that cannot drain (a dead worker, a pinned depth) raises
    the typed SwapFailed with per-replica drain states; the fleet is
    left on the old weights."""
    builds = []
    router = AutoscalingRouter(            # no health monitor: the wedge
        counted_factory(params, builds, **FT),
        AutoscalePolicy(min_replicas=1, max_replicas=2))
    victim = router.batchers[0]
    try:
        ServingChaos(victim).kill_worker()
        victim.submit(np.arange(1, 6), max_tokens=8)
        assert wait_for(lambda: not victim.worker_alive(), 10.0)
        with pytest.raises(SwapFailed) as ei:
            router.swap_weights(port(tree_2), timeout=0.5)
        err = ei.value
        assert isinstance(err, TimeoutError)
        assert err.swapped == 0
        states = err.drain_states
        assert any(s["depth"] > 0 and not s["worker_alive"]
                   for s in states.values())
        assert any(s["draining"] for s in states.values())
        assert router._draining == set() and not router._swapping
    finally:
        router.close(timeout=5.0)


# -- deadlines and faults -----------------------------------------------------

def test_deadline_ms_validation(params):
    b = ft_batcher(params)
    try:
        for bad in (0, -10):
            with pytest.raises(ValueError):
                b.submit(np.arange(1, 5), deadline_ms=bad)
    finally:
        b.close()


def test_queued_deadline_expires_typed_and_reclaims(tree, params):
    """A request expiring while QUEUED behind an exhausted pool fails
    with the typed DeadlineExceeded and leaves the batcher serving."""
    b = ft_batcher(params)
    eng = b.engine
    prompt = np.arange(1, 6)
    before = decode_metrics.snapshot()["deadline_expirations"]
    chaos = ServingChaos(b)
    try:
        chaos.exhaust_pages()
        probe = b.submit(prompt, max_tokens=4, deadline_ms=80)
        time.sleep(0.3)
        chaos.release_pages()
        with pytest.raises(DeadlineExceeded) as ei:
            probe.result(30)
        assert ei.value.deadline_ms == 80
        assert ei.value.elapsed_ms >= 80
        assert ei.value.tokens_emitted == 0
        assert decode_metrics.snapshot()["deadline_expirations"] > before
        out = list(b.submit(prompt, max_tokens=4).result(60))
        assert out == jax_greedy(tree, prompt, 4)
    finally:
        chaos.restore()
        b.close()
    audit_zero_pages(eng)


def test_placed_deadline_expires_mid_decode(tree, params):
    """A PLACED request whose budget runs out behind a stalled dispatch
    is cut off with the typed error and its pages come back."""
    b = ft_batcher(params)
    eng = b.engine
    prompt = np.arange(1, 6)
    chaos = ServingChaos(b)
    try:
        chaos.stall_dispatch(0.4)
        r = b.submit(prompt, max_tokens=8, deadline_ms=100)
        with pytest.raises(DeadlineExceeded) as ei:
            r.result(30)
        assert ei.value.tokens_emitted < 8
        assert chaos.injected["stall"] == 1
        out = list(b.submit(prompt, max_tokens=4).result(60))
        assert out == jax_greedy(tree, prompt, 4)
    finally:
        chaos.restore()
        b.close()
    audit_zero_pages(eng)


def test_poisoned_dispatch_returns_pages_and_replays(params):
    """A poisoned dispatch frees its slots' pages and replays the
    requests in place, bit for bit (sampled), at no capture."""
    b = ft_batcher(params)
    eng = b.engine
    prompt = np.arange(2, 9)
    expect = b.submit(prompt, max_tokens=6, temperature=0.8,
                      seed=11).result(60)
    before = decode_metrics.snapshot()["requests_replayed"]
    c0 = compile_metrics.compile_count
    chaos = ServingChaos(b)
    chaos.poison_dispatch(1)
    got = b.submit(prompt, max_tokens=6, temperature=0.8,
                   seed=11).result(60)
    assert np.array_equal(got, expect)
    assert chaos.injected["poison"] == 1
    assert decode_metrics.snapshot()["requests_replayed"] - before >= 1
    assert compile_metrics.compile_count == c0
    assert b.worker_alive()
    b.close()
    audit_zero_pages(eng)


def test_killed_worker_replaced_and_replayed_bit_exact(tree, params):
    """A dead worker is found by the health monitor; the replica is
    replaced from the factory at exactly W captures; every journaled
    request replays bit for bit (sampled ones equal the undisturbed
    run, greedy ones the JAX package's tokens)."""
    prompts = [np.arange(1, 6), np.arange(3, 11), np.arange(2, 7),
               np.arange(12, 21)]
    temps = [0.7, 0.7, 0.0, 0.0]
    builds = []
    factory = counted_factory(params, builds, **dict(FT, n_slots=3))
    base = factory()
    expect = [np.asarray(base.submit(p, max_tokens=5, temperature=t,
                                     seed=40 + i).result(60))
              for i, (p, t) in enumerate(zip(prompts, temps))]
    base.close()
    W = builds[0]
    before = decode_metrics.snapshot()["replicas_replaced"]
    router = AutoscalingRouter(
        factory, AutoscalePolicy(min_replicas=1, max_replicas=2),
        health=ReplicaHealth(poll_interval_s=0.02, max_error_streak=3,
                             stall_after_s=5.0))
    c0, n0 = compile_metrics.compile_count, len(builds)
    try:
        victim = router.batchers[0]
        ServingChaos(victim).kill_worker()
        handles = [victim.submit(p, max_tokens=5, temperature=t,
                                 seed=40 + i)
                   for i, (p, t) in enumerate(zip(prompts, temps))]
        got = [np.asarray(h.result(120)) for h in handles]
        assert victim not in router.batchers
        assert not victim.worker_alive()
        lock = victim.engine._prefill._sh.lock   # free after the kill
        assert lock.acquire(timeout=5.0)
        lock.release()
        assert all(np.array_equal(g, e) for g, e in zip(got, expect))
        for p, g in zip(prompts[2:], got[2:]):
            assert list(g) == jax_greedy(tree, p, 5)
        assert compile_metrics.compile_count - c0 == W * (len(builds) - n0)
        assert len(builds) - n0 == 1
        assert decode_metrics.snapshot()["replicas_replaced"] == before + 1
    finally:
        router.close(timeout=30.0)


# -- the brownout ladder ------------------------------------------------------

def test_brownout_ladder_escalates_before_shedding_and_recovers(tree,
                                                                params):
    """At the replica ceiling and over the depth bound the router first
    turns speculation off, then harvesting, and only then sheds; every
    move is booked, no speculative round runs at level 1 or above, no
    harvest is queued at level 2, ``tick`` walks the ladder back one
    rung at a time, and the fp32 tokens are the ones speculation and
    harvesting give (the JAX package's greedy ones)."""
    store = PrefixCache()
    builds = []
    factory = counted_factory(
        params, builds, draft=(DCFG, port(trees()[1])), draft_k=3,
        prefix_cache=store, **FT)
    router = AutoscalingRouter(
        factory, AutoscalePolicy(min_replicas=1, max_replicas=1),
        max_queue_depth=1)
    b = router.batchers[0]
    eng = b.engine
    rounds = []
    spec = eng.advance_spec

    def counted_spec(bucket):
        rounds.append(router.brownout_level())
        return spec(bucket)

    eng.advance_spec = counted_spec
    harvests = []
    harvest = eng._harvest

    def counted_harvest(*a, **kw):
        harvests.append(router.brownout_level())
        return harvest(*a, **kw)

    eng._harvest = counted_harvest
    prompt = np.arange(1, 12)            # one page to harvest
    before = decode_metrics.snapshot()["brownout_transitions"]
    c0 = compile_metrics.compile_count
    chaos = ServingChaos(b)
    try:
        warm = list(router.submit(prompt, max_tokens=6).result(60))
        assert rounds and all(lv == 0 for lv in rounds)
        chaos.exhaust_pages()            # pin the depth: nothing admits
        handles = [router.submit(prompt, max_tokens=6)]
        assert router.brownout_level() == 0
        handles.append(router.submit(prompt, max_tokens=6))
        assert router.brownout_level() == 1
        assert eng.spec_enabled is False and eng.harvest_enabled is True
        handles.append(router.submit(prompt, max_tokens=6))
        assert router.brownout_level() == 2
        assert eng.harvest_enabled is False
        with pytest.raises(OverloadedError):     # only level 2 sheds
            router.submit(prompt, max_tokens=6)
        n_rounds = len(rounds)
        chaos.release_pages()
        outs = [list(h.result(60)) for h in handles]
        assert len(rounds) == n_rounds           # no spec round since
        assert all(lv < 2 for lv in harvests)
        now = time.monotonic()
        router.tick(now=now + 10.0)
        assert router.brownout_level() == 1      # one rung per tick
        router.tick(now=now + 20.0)
        assert router.brownout_level() == 0
        assert eng.spec_enabled is True and eng.harvest_enabled is True
        after = decode_metrics.snapshot()["brownout_transitions"]
        assert after - before == 4               # 0->1->2->1->0
        again = list(router.submit(prompt, max_tokens=6).result(60))
        assert len(rounds) > n_rounds            # speculation is back
    finally:
        chaos.restore()
        router.close(timeout=30.0)
    assert compile_metrics.compile_count == c0   # transitions: 0 captures
    expect = jax_greedy(tree, prompt, 6)
    assert warm == expect and again == expect
    assert all(o == expect for o in outs)
    eng.flush_harvests()
    audit_zero_pages(eng)


# -- submit racing close ------------------------------------------------------

def test_submit_racing_close_gets_typed_error_never_hangs(params):
    """Eight client threads submit while ``close()`` runs: each submit
    either lands (and its request completes during the drain) or raises
    the typed RouterClosed; every join is timed."""
    builds = []
    router = AutoscalingRouter(counted_factory(params, builds, **FT),
                               AutoscalePolicy(min_replicas=1,
                                               max_replicas=1),
                               max_queue_depth=10 ** 6)
    prompt = np.arange(1, 6)
    accepted, outcome = [], {}
    lock = threading.Lock()

    def hammer(k):
        try:
            for _ in range(10 ** 4):
                h = router.submit(prompt, max_tokens=3)
                with lock:
                    accepted.append(h)
                time.sleep(0.005)
            outcome[k] = "exhausted"
        except RouterClosed:
            outcome[k] = "typed"
        except BaseException as e:       # the failure this test exists for
            outcome[k] = repr(e)

    threads = [threading.Thread(target=hammer, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    router.close(timeout=30.0)
    for t in threads:
        t.join(30.0)
    assert not any(t.is_alive() for t in threads)
    assert set(outcome.values()) == {"typed"}, outcome
    expect = None
    for h in accepted:
        out = list(h.result(60))
        expect = expect or out
        assert out == expect
    with pytest.raises(RouterClosed):
        router.submit(prompt)
    b = ft_batcher(params)
    b.close()
    with pytest.raises(BatcherClosed):
        b.submit(prompt)


def test_fleet_modules_import_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.serving.router",
                  "deeplearning4j_tpu_torch.parallel.chaos")
