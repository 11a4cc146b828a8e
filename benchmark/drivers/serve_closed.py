"""Closed-loop serving: ``clients`` clients, each with one request
outstanding, sending its next request when the last one finishes.

The clients join one by one over the first half of ``ramp_s`` seconds
before the window, so the window opens on a full engine whose requests
do not finish in one cohort; the counters reset then.
``serve_tokens_per_s`` is the output tokens of the requests that
finished inside the window over its length.  At the close no client
sends again, and every request sent is waited for.

With ``--trace 1`` the same window runs untraced, for the counters, and
then the clients go on for the cell's ``trace_seconds`` more under the
profiler, for the device's share.
"""

from __future__ import annotations

import time

from benchmark.drivers import serving
from benchmark.harness.core import Outcome
from benchmark.traffic import generators


def run(ctx, server=None, keep: bool = False) -> Outcome:
    out = Outcome()
    t = ctx.traffic
    vocab = ctx.family.sizes(ctx.conf)["vocab"]
    reqs = generators.requests(t, vocab, ctx.seed, int(t["pool"]))
    server = server or serving.Server(ctx)
    server.rehearse(reqs)
    client = serving.Client(ctx, server.batcher)
    nxt = 0

    def send(c: int, now: float) -> serving.Record:
        nonlocal nxt
        rec = serving.Record(nxt, reqs[nxt % len(reqs)], now, client=c)
        nxt += 1
        client.submit(rec, now)
        return rec

    # the clients join one by one over the first half of the ramp, so
    # their requests do not finish in one cohort
    n_clients = int(t["clients"])
    ramp = float(t["ramp_s"])
    r0 = time.perf_counter()
    joined = 0
    while time.perf_counter() < r0 + ramp:
        now = time.perf_counter()
        while joined < n_clients and now >= r0 + joined * ramp / 2 / n_clients:
            send(joined, now)
            joined += 1
        for rec in client.poll():
            send(rec.client, time.perf_counter())
        client.sleep()
    seconds = ctx.seconds
    tail = float(ctx.workload["trace_seconds"]) if ctx.trace else 0.0
    sent = []
    done_in_window = []

    def loop(until: float, done: list) -> None:
        """Each finished request counts in ``done`` and its client sends
        again, until ``until``."""
        while True:
            now = time.perf_counter()
            if now >= until:
                return
            for rec in client.poll():
                if rec.last < until:
                    done.append(rec)
                now = time.perf_counter()
                if now < until:
                    sent.append(send(rec.client, now))
            client.sleep(until)

    serving.reset_counters()
    cap0 = serving.captures()
    t0 = time.perf_counter()
    setup_s = ctx.setup_clock(t0)
    loop(t0 + seconds, done_in_window)
    t1 = time.perf_counter()
    snap = serving.counters()
    tail_tokens = 0
    if tail > 0:
        # the traced tail: the same clients, on under the profiler
        done_tail = []
        with ctx.tracer.window():
            loop(time.perf_counter() + tail, done_tail)
        tail_tokens = sum(r.tokens.size for r in done_tail
                          if r.tokens is not None)
    cap1 = serving.captures()
    client.drain(time.perf_counter() + serving.DRAIN_S)
    window_s = t1 - t0
    tokens = sum(r.tokens.size for r in done_in_window
                 if r.tokens is not None)
    out.e2e = {"serve_tokens_per_s": tokens / window_s, "setup_s": setup_s}
    out.material = {"window_s": window_s, "counters": snap}
    out.notes.append(
        f"window {window_s:.6f} s: {len(done_in_window)} requests finished, "
        f"{tokens} tokens, {len(sent)} sent (the traced tail's too); e2e "
        f"{out.e2e}; traced tail {tail:.1f} s at "
        f"{tail_tokens / tail if tail else 0.0:.1f} tokens/s; captures "
        f"while serving {cap1 - cap0}; slot occupancy "
        f"{snap['slot_occupancy']}, decode dispatches "
        f"{snap['decode_dispatches']}")
    ids = {r.index for r in sent}
    serving.finish(ctx, out, server,
                   sent + [r for r in done_in_window if r.index not in ids],
                   keep)
    return out
