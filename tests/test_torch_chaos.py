"""The port's ``parallel/chaos.ServingChaos`` and the serving chaos
drill, on the CPU.

After ``deeplearning4j_tpu/parallel/chaos.py:199-424`` and
``tests/test_serving_tier3.py:686``.  Held: a fault arms on the engine,
fires once on the replica's own worker thread and restores the engine's
methods; ``restore`` disarms what never fired; ``exhaust_pages`` holds
every free page (evicting pool-resident prefixes first) until
``release_pages`` gives them back on the worker; the injectors validate
their arguments; ``WorkerKilled`` passes the batcher's replay handler,
ends the worker with its entry lock free and its traceback silenced;
``chaos_gate.main(device="cpu")`` returns 0, as the reference's gate
does in its tier-1 test; the training injectors fire once at their step
as the JAX package's do (``DeviceLossChaos``, ``HostLossChaos`` over a
virtual host, ``PreemptionChaos``), and the scale-out runner's
``ChaosPerformer`` and ``chaos_factory`` (ROADMAP A7.6) raise
``NotImplementedError`` naming their item.

The drill's captures are the port's form of the reference's "zero new
compiles": each replica the factory builds costs exactly one warm-up's
captures (W), and nothing after its warm-up.
"""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.parallel import chaos
from deeplearning4j_tpu_torch.parallel.chaos import (InjectedFault,
                                                     ServingChaos,
                                                     WorkerKilled)
from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics
from deeplearning4j_tpu_torch.serving import chaos_gate
from test_torch_autoscale import counted_factory, wait_for
from test_torch_paged import assert_no_jax, audit_zero_pages, port, trees

torch.set_num_threads(2)

FT = dict(n_slots=2, buckets=(32,), prefill_chunk=8, paged=True,
          device="cpu", default_max_tokens=6)


@pytest.fixture(scope="module")
def params():
    return port(trees()[0])


def batcher(params, **kw):
    return counted_factory(params, [], **dict(FT, **kw))()


def test_a_fault_fires_once_on_the_worker_and_restores(params):
    """An armed poison fires on the worker thread at the next dispatch,
    exactly ``n`` times, and puts the engine's own methods back."""
    b = batcher(params)
    eng = b.engine
    orig = {m: getattr(eng, m) for m in ServingChaos._ANY}
    c = ServingChaos(b)
    threads = []
    advance = eng.advance

    def spy(bucket):
        threads.append(threading.current_thread())
        return advance(bucket)

    eng.advance = spy
    c.poison_dispatch(2)
    assert eng.advance is not spy            # armed
    try:
        out = b.submit(np.arange(1, 6), max_tokens=4).result(60)
        assert out.shape == (4,)
        assert c.injected["poison"] == 2
        assert eng.advance is spy            # restored after the second
        assert threads and all(t is b._thread for t in threads)
    finally:
        b.close()
    for m in ("advance_spec", "can_admit"):
        assert getattr(eng, m) == orig[m]
    audit_zero_pages(eng)


def test_restore_disarms_what_never_fired(params):
    b = batcher(params)
    eng = b.engine
    orig = {m: getattr(eng, m) for m in ServingChaos._ANY}
    c = ServingChaos(b)
    c.kill_worker()
    c.stall_dispatch(5.0)
    assert all(getattr(eng, m) != orig[m] for m in ServingChaos._DISPATCH)
    c.restore()
    assert all(getattr(eng, m) == orig[m] for m in ServingChaos._ANY)
    try:
        assert b.submit(np.arange(1, 6), max_tokens=3).result(60).shape \
            == (3,)
        assert b.worker_alive()
        assert c.injected == {"kill": 0, "poison": 0, "stall": 0,
                              "exhaust": 0, "release": 0}
    finally:
        b.close()


def test_exhaust_holds_every_free_page_until_released(params):
    """The grab fires on the worker at the next admission scan, evicts
    the resident prefixes and holds every free page: a request waits;
    ``release_pages`` returns them on the worker, and the request
    completes."""
    b = batcher(params)
    eng = b.engine
    c = ServingChaos(b)
    try:
        warm = list(b.submit(np.arange(1, 12), max_tokens=4).result(60))
        assert eng._resident                     # a prefix is resident
        c.exhaust_pages()
        h = b.submit(np.arange(1, 12), max_tokens=4)
        assert wait_for(lambda: c.injected["exhaust"] == 1)
        total = eng.n_kv_pages - eng._alloc.n_reserved
        assert len(c._held_pages) == total
        assert eng._alloc.n_free() == 0 and not eng._resident
        assert not h.done()
        c.release_pages()
        assert list(h.result(60)) == warm
        assert c.injected["release"] == 1 and c._held_pages == []
        c.release_pages()                        # nothing held: a no-op
    finally:
        c.restore()
        b.close()
    audit_zero_pages(eng)


def test_injectors_validate_their_arguments(params):
    b = batcher(params)
    pinned = batcher(params, paged=False)
    try:
        c = ServingChaos(b)
        with pytest.raises(ValueError, match="poison"):
            c.poison_dispatch(0)
        with pytest.raises(ValueError, match="stall"):
            c.stall_dispatch(0.0)
        with pytest.raises(ValueError, match="leave"):
            c.exhaust_pages(leave=-1)
        with pytest.raises(ValueError, match="paged"):
            ServingChaos(pinned).exhaust_pages()
    finally:
        b.close()
        pinned.close()
    assert issubclass(InjectedFault, RuntimeError)
    assert issubclass(WorkerKilled, BaseException)
    assert not issubclass(WorkerKilled, Exception)


def test_worker_killed_escapes_the_replay_handler(params):
    """A kill passes the batcher's ``except Exception`` replay path: the
    worker thread ends, its requests stay stranded (not failed), the
    engine's entry lock is free, and the thread's excepthook stays
    quiet about it while passing every other error on."""
    b = batcher(params)
    eng = b.engine
    c = ServingChaos(b)
    seen = []
    prev = chaos._orig_thread_excepthook
    chaos._orig_thread_excepthook = lambda args: seen.append(args.exc_type)
    try:
        c.kill_worker()
        h = b.submit(np.arange(1, 6), max_tokens=4)
        b._thread.join(30.0)
        assert not b.worker_alive()
        assert c.injected["kill"] == 1
        assert not h.done() and b.depth() == 1   # stranded, not failed
        lock = eng._prefill._sh.lock
        assert lock.acquire(timeout=5.0)
        lock.release()
        assert seen == []                        # the kill was silenced

        def boom():
            raise KeyError("not a kill")

        t = threading.Thread(target=boom)
        t.start()
        t.join(10.0)
        assert seen == [KeyError]                # others pass through
    finally:
        chaos._orig_thread_excepthook = prev
        b.evacuate()
        b.close(timeout=5.0)


def test_serving_chaos_gate():
    """The whole drill (poison, kill, stall, exhaust) completes every
    request bit for bit at W captures a factory replica, with zero
    leaked pages on the live and the retired replicas."""
    c0 = compile_metrics.compile_count
    assert chaos_gate.main(device="cpu") == 0
    assert compile_metrics.compile_count > c0     # replicas captured


@pytest.mark.parametrize("name", ["DeviceLossChaos", "HostLossChaos",
                                  "PreemptionChaos", "ChaosPerformer",
                                  "chaos_factory"])
def test_training_injectors_name_a7(name):
    """The training injectors fire exactly once, at the first step at or
    past theirs, as the JAX package's do (each port injector is held
    against the reference's on the same calls); the scale-out runner's
    two still raise, naming ROADMAP A7.6."""
    from deeplearning4j_tpu.parallel import chaos as jchaos

    if name in ("ChaosPerformer", "chaos_factory"):
        with pytest.raises(NotImplementedError, match="ROADMAP A7.6"):
            getattr(chaos, name)
        assert callable(getattr(jchaos, name))
    else:
        def guard():
            return type("G", (), {"n": 0, "request": lambda self: setattr(
                self, "n", self.n + 1)})()

        if name == "DeviceLossChaos":
            pair = [chaos.DeviceLossChaos(3, [2, 5]),
                    jchaos.DeviceLossChaos(3, [2, 5])]
        elif name == "HostLossChaos":
            pair = [chaos.HostLossChaos(3, 1, n_hosts=2, devices=range(8)),
                    jchaos.HostLossChaos(3, 1, n_hosts=2)]
        else:
            gs = [guard(), guard()]
            pair = [chaos.PreemptionChaos(3, gs[0]),
                    jchaos.PreemptionChaos(3, gs[1])]
        seen = []
        for inj in pair:
            fired = []
            for step in (1, 2, 4, 3, 5):
                try:
                    inj(step)
                    fired.append(None)
                except Exception as e:  # noqa: BLE001 — the fault is the result
                    fired.append((type(e).__name__,
                                  sorted(int(i) for i in e.lost_ids)))
            seen.append((fired, inj.fired))
        assert seen[0] == seen[1]
        if name == "PreemptionChaos":
            assert [g.n for g in gs] == [1, 1]
        else:
            assert [f for f in seen[0][0] if f] == [seen[0][0][2]]
            assert seen[0][0][2][0] == "DeviceLossError"
    with pytest.raises(AttributeError):
        getattr(chaos, "NoSuchInjector")


def test_chaos_modules_import_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.parallel.chaos",
                  "deeplearning4j_tpu_torch.serving.chaos_gate")
