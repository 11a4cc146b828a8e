"""The port's ``parallel/coordinator.StateTracker`` against the JAX
package's, on one script of calls.

``deeplearning4j_tpu/parallel/coordinator.py`` imports no JAX, and the
port keeps its own copy.  Each case drives both trackers through the
same calls and compares, exactly, everything a caller reads back: the
jobs handed out, counters, ``pending_counts``, the replication flags,
the workers and the done flag.  The cases are the reference's
(``tests/test_parallel.py:114-163``, ``tests/test_scaleout.py:68-79,
293-311``) plus the retry cap: the reaper requeues a stale worker's job,
a job past ``max_job_retries`` is dropped and counted, a reaped
worker's late ``complete_job`` is discarded and counted.
"""

import time

import pytest

from deeplearning4j_tpu_torch.parallel import coordinator as tc
from test_torch_paged import assert_no_jax


def _job_flow(mod):
    """tests/test_parallel.py:114: assignment, re-asking, disabling."""
    t = mod.StateTracker(stale_after_s=0.05)
    seen = []
    t.add_worker("w0")
    t.add_worker("w1")
    t.add_job(mod.Job(work="a"))
    t.add_job(mod.Job(work="b"))
    j0 = t.job_for("w0")
    seen += [(j0.work, j0.worker_id), t.job_for("w0") is j0]
    seen.append(t.job_for("w1").work)
    seen.append(t.pending_counts())
    t.clear_job("w0")
    seen.append(t.job_for("w0"))
    t.add_job(mod.Job(work="c"))
    t.enable_worker("w1", False)
    t.clear_job("w1")
    seen += [t.job_for("w1"), t.worker_enabled("w1"), t.job_for("w0").work]
    t.increment("n")
    t.increment("n", 2)
    seen += [t.count("n"), t.count("missing"), t.pending_counts(),
             t.has_pending(), sorted(t.workers())]
    return seen


def _reaper(mod):
    """tests/test_parallel.py:140, test_scaleout.py:68: a stale worker's
    job goes back to the queue, its retry counted."""
    t = mod.StateTracker(stale_after_s=0.01)
    t.add_worker("w0")
    t.add_job(mod.Job(work="a"))
    t.job_for("w0")
    time.sleep(0.03)
    seen = [t.remove_stale_workers(), t.workers(), t.pending_counts(),
            t.heartbeat("w0")]
    t.add_worker("w1")
    j = t.job_for("w1")
    seen += [j.work, j.retries, j.worker_id, t.needs_replicate("w0")]
    return seen


def _replication(mod):
    """tests/test_parallel.py:154: new params flag every worker."""
    t = mod.StateTracker()
    seen = [t.needs_replicate("nobody")]
    t.add_worker("w0")
    t.add_worker("w1")
    seen.append(t.needs_replicate("w0"))
    t.done_replicating("w0")
    t.done_replicating("w1")
    seen += [t.needs_replicate("w0"), t.needs_replicate("w1")]
    t.set_current({"x": 1})
    seen += [t.needs_replicate("w0"), t.needs_replicate("w1"),
             t.get_current()]
    t.done_replicating("w1")
    seen += [t.needs_replicate("w0"), t.needs_replicate("w1")]
    return seen


def _late_result(mod):
    """tests/test_scaleout.py:293: a reaped worker's result is
    discarded; its peer's recompute counts once."""
    t = mod.StateTracker(stale_after_s=0.0)
    t.add_worker("slow")
    t.add_job(mod.Job(work="x"))
    job = t.job_for("slow")
    seen = [t.remove_stale_workers(), t.complete_job("slow", job),
            t.count("updates_discarded"), t.count("jobs_done"),
            t.drain_updates()]
    t.add_worker("peer")
    again = t.job_for("peer")
    seen += [t.complete_job("peer", again), t.count("jobs_done"),
             [u.work for u in t.drain_updates()], t.pending_counts()]
    return seen


def _retry_cap(mod):
    """A job requeued past ``max_job_retries`` is dropped and counted,
    so ``has_pending`` clears."""
    t = mod.StateTracker(max_job_retries=2)
    t.add_worker("w")
    t.add_job(mod.Job(work="poison"))
    seen = []
    for _ in range(4):
        job = t.job_for("w")
        seen.append(None if job is None else (job.work, job.retries))
        t.requeue("w")
        seen += [t.pending_counts(), t.count("jobs_dropped")]
    seen.append(t.has_pending())
    return seen


def _updates_and_done(mod):
    """add_update / updates / drain, heartbeats, the done flag."""
    t = mod.StateTracker()
    t.add_worker("w")
    job = mod.Job(work=1, result=2)
    t.add_update("w", job)
    seen = [[u.result for u in t.updates()], len(t.drain_updates()),
            t.updates(), t.heartbeat("w"), t.heartbeat("ghost"),
            sorted(t.heartbeats()), t.is_done()]
    t.set_done()
    seen.append(t.is_done())
    t.set_done(False)
    seen.append(t.is_done())
    return seen


@pytest.mark.parametrize("script", [_job_flow, _reaper, _replication,
                                    _late_result, _retry_cap,
                                    _updates_and_done],
                         ids=lambda f: f.__name__.strip("_"))
def test_state_tracker_matches_reference(script):
    from deeplearning4j_tpu.parallel import coordinator as jc
    assert script(tc) == script(jc)


def test_job_and_worker_record_fields_match_reference():
    import dataclasses

    from deeplearning4j_tpu.parallel import coordinator as jc
    for name in ("Job", "WorkerRecord"):
        port = [(f.name, f.default) for f in
                dataclasses.fields(getattr(tc, name))]
        ref = [(f.name, f.default) for f in
               dataclasses.fields(getattr(jc, name))]
        assert port == ref


def test_coordinator_imports_no_jax():
    assert_no_jax("deeplearning4j_tpu_torch.parallel.coordinator",
                  "deeplearning4j_tpu_torch.parallel")
