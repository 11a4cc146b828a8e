"""The port's ``AutoscalePolicy`` and ``AutoscalingRouter`` against the
JAX reference, on the CPU.

After ``tests/test_serving_tier2.py:435-558``, at its sizes (the target
2 x 32 with vocab 64, fp32, on numpy weights drawn from a seed and
carried into both packages).  Held: the policy's hysteresis table; one
seeded synthetic load trace driven through both packages' policies with
the same clock gives the same verdict at every step; pressure scales the
fleet up and idle ticks scale it back down, every request completing
with the JAX package's greedy tokens; the router sheds (typed, booked
``shed_by_policy``) only at its ceiling; and a retired replica is let go
(a ``weakref`` to it dies after its drain and ``gc.collect()``), whether
scaled down or replaced by the health monitor.

Captures: the reference asserts an unchanged ``compile_count`` across
scale-up, because its factory clones hit a shared XLA cache.  In the
port a replica's graphs are bound to its own KV state and weight
buffers, so each replica the factory builds costs exactly ``W``
captures, where ``W`` is one ``warmup()``'s ``"compiles"``, and nothing
after its warm-up: these tests hold ``compile_count - before == W x
(replicas the factory built)``, which is the port's form of "zero new
compiles".  On the CPU a capture is a wrapper's first call of a
signature, so the rule reads the same as on the card.
"""

import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models.transformer import TransformerConfig as JCfg
from deeplearning4j_tpu.serving import router as jrouter
from deeplearning4j_tpu_torch.runtime.metrics import (compile_metrics,
                                                      decode_metrics)
from deeplearning4j_tpu_torch.serving.decode import (ContinuousBatcher,
                                                     DecodeEngine)
from deeplearning4j_tpu_torch.serving.router import (AutoscalePolicy,
                                                     AutoscalingRouter,
                                                     OverloadedError,
                                                     ReplicaHealth)
from test_torch_paged import CFG, KW, assert_no_jax, jax_tree, port, trees

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree():
    return trees()[0]


@pytest.fixture(scope="module")
def params(tree):
    return port(tree)


def jax_greedy(tree, prompt, n):
    """The JAX package's greedy continuation of ``prompt``."""
    import jax

    out = jgpt.generate(JCfg(**KW), jax_tree(tree),
                        np.asarray(prompt, np.int32)[None, :], n,
                        jax.random.key(0), temperature=0.0)
    return [int(t) for t in np.asarray(out)[0]]


def counted_factory(params, builds, **kw):
    """A replica factory over the fp32 test model; ``builds`` collects
    each build's warm-up captures (W)."""
    eng_kw = dict(n_slots=2, buckets=(32,), prefill_chunk=8, device="cpu")
    eng_kw.update(kw)
    max_tokens = eng_kw.pop("default_max_tokens", 8)

    def factory():
        eng = DecodeEngine(CFG, params, **eng_kw)
        builds.append(eng.warmup()["compiles"])
        return ContinuousBatcher(eng, default_max_tokens=max_tokens)
    return factory


def wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


# -- the policy ---------------------------------------------------------------

def test_autoscale_policy_hysteresis():
    """Oscillation never scales, sustained heat scales up once per
    cooldown, sustained cold scales down, the bounds clamp both ways,
    and the TTFT signal counts only under live load."""
    pol = AutoscalePolicy(1, 3, high_depth=4.0, low_depth=1.0,
                          up_after=2, down_after=3, cooldown_s=10.0,
                          interval_s=0.0)
    t = [0.0]

    def obs(depth, n):
        t[0] += 1.0
        return pol.observe(depth, None, n, now=t[0])

    assert [obs(d, 1) for d in (5, 0, 5, 0, 5, 0)] == ["hold"] * 6
    assert obs(6, 1) == "hold"
    assert obs(6, 1) == "up"
    assert obs(9, 2) == "hold"              # cooldown
    t[0] += 20.0
    assert [obs(0, 2) for _ in range(2)] == ["hold", "hold"]
    assert obs(0, 2) == "down"
    t[0] += 20.0
    assert [obs(9, 3) for _ in range(4)] == ["hold"] * 4
    t[0] += 20.0
    assert [obs(0, 1) for _ in range(5)] == ["hold"] * 5
    pol2 = AutoscalePolicy(1, 2, high_depth=100.0, low_depth=1.0,
                           ttft_p99_slo_ms=50.0, up_after=1,
                           down_after=1, cooldown_s=0.0, interval_s=0.0)
    assert pol2.observe(1.5, 80.0, 1, now=1.0) == "up"
    assert pol2.observe(0.0, 80.0, 2, now=2.0) == "down"
    # the interval gate, and due() reading it without observing
    pol3 = AutoscalePolicy(1, 2, high_depth=2.0, low_depth=1.0,
                           up_after=1, cooldown_s=0.0, interval_s=1.0)
    assert pol3.due(0.0)
    assert pol3.observe(5.0, None, 1, now=0.0) == "up"
    assert not pol3.due(0.5)
    assert pol3.observe(5.0, None, 1, now=0.5) == "hold"
    assert pol3.due(1.0)
    with pytest.raises(ValueError, match="min_replicas"):
        AutoscalePolicy(3, 2)
    with pytest.raises(ValueError, match="low_depth"):
        AutoscalePolicy(1, 2, high_depth=1.0, low_depth=2.0)
    with pytest.raises(ValueError, match="low_depth"):
        AutoscalePolicy(1, 2, high_depth=8.0, low_depth=0.0)
    with pytest.raises(ValueError, match="up_after"):
        AutoscalePolicy(1, 2, up_after=0)
    with pytest.raises(TypeError, match="factory"):
        AutoscalingRouter.replicate(CFG, {}, 2)


POLICIES = {
    "defaults": dict(),
    "fast": dict(min_replicas=1, max_replicas=3, high_depth=3.0,
                 low_depth=1.0, up_after=2, down_after=4, cooldown_s=0.2,
                 interval_s=0.02),
    "slo": dict(min_replicas=2, max_replicas=5, high_depth=6.0,
                low_depth=0.5, ttft_p99_slo_ms=40.0, up_after=1,
                down_after=2, cooldown_s=0.5, interval_s=0.1),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_matches_reference_on_a_shared_trace(name):
    """One seeded load trace (bursts, lulls, TTFT spikes, irregular
    clock steps, some inside the interval) through both packages'
    policies, each replica count following its own verdicts: the same
    verdict and the same ``due`` at every step."""
    kw = POLICIES[name]
    ours, ref = AutoscalePolicy(**kw), jrouter.AutoscalePolicy(**kw)
    rng = np.random.default_rng(5)
    now, n_ours, n_ref = 0.0, ours.min_replicas, ref.min_replicas
    verdicts = []
    for step in range(600):
        now += float(rng.choice([0.005, 0.03, 0.12, 0.4, 1.5]))
        phase = (step // 60) % 4
        depth = float(rng.gamma(2.0, (0.2, 3.0, 9.0, 1.0)[phase]))
        ttft = None if rng.random() < 0.2 else float(rng.gamma(2.0, 25.0))
        assert ours.due(now) == ref.due(now)
        a = ours.observe(depth, ttft, n_ours, now=now)
        b = ref.observe(depth, ttft, n_ref, now=now)
        assert a == b, (step, depth, ttft, n_ours)
        n_ours += {"up": 1, "down": -1}.get(a, 0)
        n_ref += {"up": 1, "down": -1}.get(b, 0)
        verdicts.append(a)
    assert "up" in verdicts and "down" in verdicts


# -- the router ---------------------------------------------------------------

def test_autoscaling_router_scales_up_and_drains(tree, params):
    """Pressure scales the fleet up, idle ticks scale it back down, every
    request completes with the JAX package's greedy tokens, and the
    captures are exactly W a factory replica."""
    builds = []
    factory = counted_factory(params, builds)
    pol = AutoscalePolicy(1, 2, high_depth=2.0, low_depth=1.0,
                          up_after=1, down_after=2, cooldown_s=0.0,
                          interval_s=0.0)
    decode_metrics.reset()
    before = compile_metrics.compile_count
    router = AutoscalingRouter(factory, pol, max_queue_depth=64)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, CFG.vocab_size, size=5) for _ in range(12)]
    with router:
        handles = [router.submit(p, max_tokens=8) for p in prompts]
        outs = [list(h.result(120)) for h in handles]
        assert wait_for(
            lambda: decode_metrics.snapshot()["replicas_added"] >= 1)
        # one policy spawn lands; later verdicts found it in flight
        assert wait_for(lambda: router.n_replicas() == 2)
        for i in range(5):                  # idle ticks after the burst
            router.tick(now=1e9 + i)
        snap = decode_metrics.snapshot()
        assert snap["replicas_removed"] >= 1
        assert router.n_replicas() == 1
        # the surviving replica still serves, with the same tokens
        again = list(router.submit(prompts[0], max_tokens=8).result(60))
    W = builds[0]
    assert W == 2                            # prefill + step, one bucket
    assert all(w == W for w in builds)
    assert compile_metrics.compile_count - before == W * len(builds)
    assert len(builds) == 1 + snap["replicas_added"]
    assert decode_metrics.snapshot()["compile_delta_since_mark"] == 0
    assert again == outs[0]
    for p, o in zip(prompts, outs):
        assert o == jax_greedy(tree, p, 8)


def test_autoscaling_router_sheds_only_at_ceiling(params):
    """Below ``max_replicas`` an over-bound submit becomes an emergency
    scale-up on the submitting thread; at the ceiling (brownout level 2
    reached first) it sheds with the typed error, booked in
    ``shed_by_policy`` and ``requests_shed``."""
    builds = []
    factory = counted_factory(params, builds, buckets=(64,))
    pol = AutoscalePolicy(1, 2, high_depth=50.0, low_depth=0.5,
                          up_after=10 ** 6, down_after=10 ** 6,
                          cooldown_s=10 ** 6, interval_s=0.0)
    router = AutoscalingRouter(factory, pol, max_queue_depth=1)
    rng = np.random.RandomState(8)
    base = decode_metrics.snapshot()
    before = compile_metrics.compile_count
    with router:
        handles, shed = [], 0
        for _ in range(8):
            try:
                handles.append(
                    router.submit(rng.randint(1, CFG.vocab_size, size=4),
                                  max_tokens=56))
            except OverloadedError as e:
                assert e.replicas == 2 and e.bound == 1
                shed += 1
        assert router.n_replicas() == 2          # the emergency spawn
        assert router.brownout_level() == 2      # climbed before shedding
        assert shed >= 1
        for h in handles:
            assert h.result(120).shape == (56,)
    after = decode_metrics.snapshot()
    assert after["shed_by_policy"] == base["shed_by_policy"] + shed
    assert after["requests_shed"] == base["requests_shed"] + shed
    assert after["replicas_added"] == base["replicas_added"] + 1
    assert compile_metrics.compile_count - before == builds[0] * 1


def test_retired_replicas_are_let_go(params):
    """Neither the router, its drain list nor its monitor keeps a
    reference to a replica it retired: a weakref to a scaled-down
    replica and to a replaced one dies once its drain ended and
    ``gc.collect()`` ran, with the router still open (the card's
    memory check in ``chip_smoke.py`` phase 15 rests on this)."""
    builds = []
    factory = counted_factory(params, builds)
    pol = AutoscalePolicy(1, 3, high_depth=50.0, low_depth=1.0,
                          up_after=10 ** 6, down_after=1, cooldown_s=0.0,
                          interval_s=0.0)
    router = AutoscalingRouter(
        factory, pol, max_queue_depth=1,
        health=ReplicaHealth(poll_interval_s=0.01, stall_after_s=5.0))
    try:
        prompt = np.arange(1, 6)
        hs = [router.submit(prompt, max_tokens=24) for _ in range(3)]
        assert router.n_replicas() == 3          # two emergency spawns
        for h in hs:
            h.result(60)
        scaled = weakref.ref(router.batchers[-1])
        for i in range(4):
            router.tick(now=1e9 + i)
        assert router.n_replicas() == 1
        # the health monitor replaces the last replica, whose worker
        # exits (no local name holds it: the test itself lets it go)
        replaced = weakref.ref(router.batchers[0])
        replaced().close(timeout=30.0)
        del hs
        # the replacement is built, the carcass evacuated and retired on
        # a drain thread: both weakrefs die within the wait
        for ref in (scaled, replaced):
            assert wait_for(lambda: (gc.collect(), ref() is None)[1])
        assert router.n_replicas() == 1
        out = router.submit(prompt, max_tokens=4).result(60)
        assert out.shape == (4,)
    finally:
        router.close(timeout=30.0)


def test_policy_spawn_lands_after_close_is_closed(params):
    """A policy spawn that lands after ``close()`` closes its fresh
    replica instead of adding it (and ``close`` joins the spawn)."""
    gate = threading.Event()
    builds = []
    inner = counted_factory(params, builds)
    made = []

    def factory():
        if builds:                               # the spawn waits
            assert gate.wait(30.0)
        b = inner()
        made.append(b)
        return b

    router = AutoscalingRouter(factory, AutoscalePolicy(1, 2),
                               max_queue_depth=64)
    with router._lock:                           # a policy "up" verdict
        router._scale_up_async()
    assert router._spawning
    closer = threading.Thread(target=router.close, kwargs={"timeout": 30.0})
    closer.start()
    assert wait_for(lambda: router._closed)
    gate.set()
    closer.join(60.0)
    assert not closer.is_alive()
    assert router.n_replicas() == 1
    assert len(made) == 2 and not made[1].worker_alive()


def test_autoscale_modules_import_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.serving.router",
                  "deeplearning4j_tpu_torch.serving")
