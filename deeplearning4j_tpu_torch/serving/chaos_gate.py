"""Chaos drill for the serving fleet's fault tolerance.

Port of ``tools/serving_chaos_gate.py``.  Under injected faults (a
poisoned dispatch, a killed decode worker, a stalled replica, an
exhausted KV page pool) every submitted request must still complete
with the tokens of an undisturbed run, every replacement replica must
cost exactly the captures of one warm-up (the port's form of the
reference's "zero new compiles": a replica's CUDA graphs are bound to
its own buffers, so it captures its own, and nothing after its warm-up),
and every page allocator must account for every page after the drill,
the retired replicas' included.

Bit-exactness is possible because sampling keys fold (seed, POSITION):
a request journaled as (prompt, seed, temperature, tokens emitted)
replays on any replica of the same configuration and continues where it
stopped.

Phases (each fault armed with ``parallel.chaos.ServingChaos`` and fired
at a step boundary on the victim's own worker thread):

1. POISON: one dispatch raises ``InjectedFault``; the batcher frees the
   slots, returns their pages and replays the requests in place (no
   replacement: the error streak stays under the bound);
2. KILL: the worker thread dies (``WorkerKilled``, raised before the
   engine call, so the engine's entry lock is free); the health monitor
   sees ``worker_alive()`` False, spawns a factory replacement and
   replays every journaled request on it;
3. STALL: a dispatch sleeps past ``stall_after_s``; the monitor's
   progress-age detector replaces the replica while the worker sleeps.
   The zombie wakes, replays its own graph once on its own buffers and
   exits into detached handles;
4. EXHAUST: the free page pool is held: admissions wait (no deadlock,
   no shed), a deadline probe queued behind it expires with the typed
   ``DeadlineExceeded``, and releasing the pages finishes the wave.

Run it as ``python -m deeplearning4j_tpu_torch.serving.chaos_gate
[--device cpu|cuda]`` (the card by default); it exits 1 on any
violation.  :func:`main` takes a config and params too, to run the same
drill at a model's full width.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Callable, List, Optional

import numpy as np

N_REQUESTS = 12


def _prompts() -> List[np.ndarray]:
    r = np.random.RandomState(17)
    return [r.randint(1, 48, size=r.randint(2, 12)).astype(np.int32)
            for _ in range(N_REQUESTS)]


def _make_factory(cfg, params, device, builds: List[int]):
    """The drill's replica factory; ``builds`` collects each build's
    warm-up captures."""
    from deeplearning4j_tpu_torch.serving.decode import (ContinuousBatcher,
                                                         DecodeEngine)

    def factory():
        eng = DecodeEngine(cfg, params, n_slots=3, buckets=(16, 32),
                           prefill_chunk=8, paged=True, label="chaos-gate",
                           device=device)
        builds.append(eng.warmup()["compiles"])
        return ContinuousBatcher(eng, default_max_tokens=5)
    return factory


def _submit(target, prompt, i):
    # per-request (seed, temperature) pairs make bit-exactness a claim
    # about SAMPLED decode, not just greedy argmax
    return target.submit(prompt, max_tokens=5, temperature=0.7,
                         seed=100 + i)


def _lock_free(engine) -> bool:
    """Whether the engine's captured entries' lock can be taken (a
    killed worker must not have died holding it)."""
    lock = engine._prefill._sh.lock
    if not lock.acquire(timeout=5.0):
        return False
    lock.release()
    return True


def _retired_audit(batcher) -> Optional[str]:
    """A retired replica, once its worker has exited: every allocator
    reference is explained by its slots and residents, and releasing
    the slots its evacuation left returns every page.  None when it
    holds, else what failed."""
    batcher._thread.join(30.0)
    if batcher.worker_alive():
        return "its worker did not exit"
    eng = batcher.engine
    if eng.pages_unaccounted() != 0:
        return f"unaccounted={eng.pages_unaccounted()}"
    for bucket, b in eng._buckets.items():
        for slot in np.flatnonzero(b.active):
            eng.release(bucket, int(slot))
    eng.drop_residents()
    if eng._alloc.in_use() != 0:
        return f"in_use={eng._alloc.in_use()} after releasing its slots"
    return None


def main(device: Any = None, *, cfg=None, params=None,
         say: Callable[[str], None] = print) -> int:
    """Run the drill on ``device`` (None: the card), over ``cfg`` and
    ``params`` (default: ``gpt_tiny(vocab_size=48, max_len=32)`` with
    seeded weights).  Returns 0 when every check holds, else 1."""
    import torch

    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.models import gpt
    from deeplearning4j_tpu_torch.parallel.chaos import ServingChaos
    from deeplearning4j_tpu_torch.runtime.metrics import (compile_metrics,
                                                          decode_metrics)
    from deeplearning4j_tpu_torch.serving.decode import DeadlineExceeded
    from deeplearning4j_tpu_torch.serving.router import (AutoscalePolicy,
                                                         AutoscalingRouter,
                                                         ReplicaHealth)

    def fail(msg: str) -> int:
        say(f"[serving-chaos-gate] FAIL: {msg}")
        return 1

    dev = resolve_device(device)
    if cfg is None:
        cfg = gpt.gpt_tiny(vocab_size=48, max_len=32)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = gpt.init_params(gen, cfg, device=dev)
    builds: List[int] = []
    factory = _make_factory(cfg, params, dev, builds)
    prompts = _prompts()

    # -- 1) undisturbed baseline: the bit-exact reference -------------------
    base = factory()
    W = builds[0]
    try:
        handles = [_submit(base, p, i) for i, p in enumerate(prompts)]
        expect = [h.result(120) for h in handles]
    finally:
        base.close()
    del base, handles

    # -- 2) the chaos fleet --------------------------------------------------
    decode_metrics.reset()
    c0 = compile_metrics.compile_count
    n0 = len(builds)
    router = AutoscalingRouter(
        factory, AutoscalePolicy(min_replicas=2, max_replicas=3),
        max_queue_depth=64,
        health=ReplicaHealth(poll_interval_s=0.02, max_error_streak=3,
                             stall_after_s=0.6))
    got: dict = {}
    probe = None
    retired = []
    try:
        # phase 1: POISON one dispatch: in-place replay, no replacement
        b0 = router.batchers[0]
        ServingChaos(b0).poison_dispatch(1)
        wave = [(i, _submit(b0, prompts[i], i)) for i in range(0, 4)]
        for i, h in wave:
            got[i] = h.result(120)
        if b0 not in router.batchers:
            return fail("a poisoned dispatch replaced its replica")

        # phase 2: KILL a worker: the monitor replaces, requests replay
        victim = router.batchers[1]
        ServingChaos(victim).kill_worker()
        wave = [(i, _submit(victim, prompts[i], i)) for i in range(4, 8)]
        for i, h in wave:
            got[i] = h.result(120)
        if victim in router.batchers:
            return fail("the killed replica was never replaced: the "
                        "health monitor missed a dead worker")
        if not _lock_free(victim.engine):
            return fail("the killed worker left its engine's entry lock "
                        "held")
        retired.append(victim)

        # phase 3: STALL a replica mid-decode: the progress-age detector
        # replaces it; the requests replay from their last token
        stalled = router.batchers[0]
        ServingChaos(stalled).stall_dispatch(1.5)
        wave = [(i, _submit(stalled, prompts[i], i)) for i in range(8, 10)]
        for i, h in wave:
            got[i] = h.result(120)
        if stalled in router.batchers:
            return fail("the stalled replica was never replaced: the "
                        "progress-age detector missed it")
        retired.append(stalled)

        # phase 4: EXHAUST the page pool: admissions wait (never deadlock
        # or shed), a deadline probe behind the exhaustion expires
        # typed, releasing the pages completes the wave
        host = router.batchers[0]
        chaos = ServingChaos(host)
        chaos.exhaust_pages()
        wave = [(i, _submit(host, prompts[i], i)) for i in range(10, 12)]
        probe = host.submit(prompts[0], max_tokens=5, temperature=0.7,
                            seed=100, deadline_ms=80)
        time.sleep(0.3)                 # let the probe expire queued
        chaos.release_pages()
        for i, h in wave:
            got[i] = h.result(120)
        live = list(router.batchers)
    finally:
        router.close(timeout=30.0)

    # -- 3) verdicts ---------------------------------------------------------
    bad = [i for i in range(N_REQUESTS)
           if not np.array_equal(got[i], expect[i])]
    if bad:
        return fail(f"request(s) {bad} completed with tokens differing "
                    f"from the undisturbed run: replay is not bit-exact")
    spawned = builds[n0:]
    delta = compile_metrics.compile_count - c0
    if any(w != W for w in spawned) or delta != W * len(spawned):
        return fail(f"the drill captured {delta} graph(s) over "
                    f"{len(spawned)} factory build(s) of {spawned} each: "
                    f"a replica must cost exactly W={W}")
    after = decode_metrics.snapshot()["compile_delta_since_mark"]
    if after != 0:
        return fail(f"{after} capture(s) after the last warm-up")
    try:
        probe.result(1)
        return fail("the deadline probe completed instead of expiring "
                    "behind the exhausted pool")
    except DeadlineExceeded:
        pass
    for b in live:
        # pool-resident prefix pages are a CACHE (registry references),
        # not occupancy: evict them (the workers are joined) so that
        # in_use() == 0 is the leak audit
        eng = b.engine
        eng.drop_residents()
        if eng._alloc.in_use() != 0 or eng.pages_unaccounted() != 0:
            return fail(f"pages leaked after drain: in_use="
                        f"{eng._alloc.in_use()} unaccounted="
                        f"{eng.pages_unaccounted()}")
    for b in retired:
        why = _retired_audit(b)
        if why is not None:
            return fail(f"a retired replica's pages: {why}")
    snap = decode_metrics.snapshot()
    for key, floor in (("replicas_replaced", 2),
                       ("requests_replayed", 1),
                       ("deadline_expirations", 1)):
        if snap[key] < floor:
            return fail(f"{key}={snap[key]} (expected >= {floor}): the "
                        f"drill did not exercise its fault path")
    say(f"[serving-chaos-gate] ok: {N_REQUESTS} requests bit-exact under "
        f"poison/kill/stall/exhaust, {len(spawned)} factory replicas at "
        f"W={W} captures each ({delta} in all, 0 after the last warm-up), "
        f"replaced={snap['replicas_replaced']}, "
        f"replayed={snap['requests_replayed']}, pages_leaked=0 on "
        f"{len(live)} live and {len(retired)} retired replicas")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda)")
    sys.exit(main(ap.parse_args().device))
