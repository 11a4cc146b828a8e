"""What the serving drivers share: the engine under test, the client, and
the comparison of served tokens with the plain reference.

The program under test is ``serving/decode.ContinuousBatcher`` over a
``DecodeEngine``, built from the benchmark's weights and warmed up (every
bucket captured, then one short request through each bucket the traffic
uses).  The client is one thread of the benchmark's: it submits each
request through ``ContinuousBatcher.submit`` and watches every handle it
holds through the handle's public face (``ttft_ms`` set: the first token
has arrived; ``done()``: the last one has), stamping both on its own
clock every ``poll_ms``.  Tokens come back with ``result()``.

After the window the client waits for every request it sent (at most
``DRAIN_S`` past the close); one that never finishes, or fails, counts
in ``failed``.  Then the engine is freed, and a sample of the finished
requests, drawn from the seed, half greedy and half sampled, with the
longest of each kind among them, goes to the plain reference
(``check_requests`` of them): each prompt with its served tokens in one
float32 forward pass, and the widest gap by which a served token's score
lies below the reference's best at its position.  A greedy token's
score is its logit; a sampled token's is its logit plus the request's
own noise times its temperature (``reference/sampler.py``), so a
sampled token is judged as exactly as a greedy one.  The two kinds are
read apart, as ``gap`` and ``gap_sampled``.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np

from benchmark.families import weights
from benchmark.reference import sampler
from benchmark.reference import transformer as ref
from benchmark.traffic import generators

#: seconds the client waits past the window for the requests it sent
DRAIN_S = 60.0


class Record:
    __slots__ = ("index", "req", "due", "sent", "first", "last", "tokens",
                 "error", "handle", "client")

    def __init__(self, index, req, due, client=None):
        self.index = index
        self.req = req
        self.due = due
        self.sent = None
        self.first = None
        self.last = None
        self.tokens = None
        self.error = None
        self.handle = None
        self.client = client


class Server:
    """The engine and batcher over the benchmark's weights."""

    def __init__(self, ctx, params=None):
        from deeplearning4j_tpu_torch.serving.decode import (
            ContinuousBatcher, DecodeEngine)

        self.ctx = ctx
        fam = ctx.family
        self.cfg = fam.port_config(ctx.conf)
        self.params = (params if params is not None else
                       weights.make(fam.leaves(ctx.conf), ctx.seed,
                                    ctx.device, **ctx.workload["weights"]))
        t = ctx.traffic
        self.engine = DecodeEngine(self.cfg, self.params,
                                   n_slots=int(t["n_slots"]),
                                   device=ctx.device)
        self.engine.warmup()
        self.batcher = ContinuousBatcher(self.engine)

    def rehearse(self, reqs: List[generators.Request]) -> None:
        """One short request through every bucket ``reqs`` reach, so that
        the first request of each bucket in the window finds nothing to
        set up."""
        seen = {}
        for r in reqs:
            b = self.engine.pick_bucket(r.prompt.size + r.max_tokens)
            seen.setdefault(b, r)
        handles = [self.batcher.submit(r.prompt, max_tokens=min(
            r.max_tokens, 4), temperature=r.temperature, seed=r.seed)
            for r in seen.values()]
        for h in handles:
            h.result(timeout=600)

    def rebind(self, params) -> None:
        """Serve ``params`` instead, with no new capture (the engine is
        idle between runs)."""
        self.batcher.close()
        self.engine.rebind_params(params)
        self.params = params
        from deeplearning4j_tpu_torch.serving.decode import ContinuousBatcher
        self.batcher = ContinuousBatcher(self.engine)

    def close(self) -> None:
        self.batcher.close()
        self.batcher = None
        self.engine = None
        gc.collect()
        torch = self.ctx.torch
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
            torch.cuda.empty_cache()


class Client:
    """The benchmark's one client thread."""

    def __init__(self, ctx, batcher):
        self.ctx = ctx
        self.batcher = batcher
        self.inflight: List[Record] = []
        self.poll_s = float(ctx.traffic["poll_ms"]) / 1e3
        self.span = ctx.tracer.span

    def submit(self, rec: Record, now: float) -> None:
        r = rec.req
        with self.span("bench.submit"):
            rec.sent = now
            try:
                rec.handle = self.batcher.submit(
                    r.prompt, max_tokens=r.max_tokens,
                    temperature=r.temperature, seed=r.seed)
            except Exception as e:      # noqa: BLE001 — a refused request
                rec.error = e
                rec.last = now
                return
        self.inflight.append(rec)

    def poll(self) -> List[Record]:
        """Stamp first and last tokens; returns the requests that just
        finished."""
        now = time.perf_counter()
        done = []
        with self.span("bench.poll"):
            keep = []
            for rec in self.inflight:
                h = rec.handle
                if rec.first is None and h.ttft_ms is not None:
                    rec.first = now
                if h.done():
                    rec.last = now
                    if rec.first is None:
                        rec.first = now
                    try:
                        rec.tokens = h.result(timeout=0)
                    except Exception as e:  # noqa: BLE001 — counted failed
                        rec.error = e
                    done.append(rec)
                else:
                    keep.append(rec)
            self.inflight = keep
        return done

    def sleep(self, until: Optional[float] = None) -> None:
        now = time.perf_counter()
        wait = self.poll_s if until is None else min(self.poll_s,
                                                     until - now)
        if wait > 0:
            with self.span("bench.sleep"):
                time.sleep(wait)

    def drain(self, deadline: float) -> None:
        while self.inflight and time.perf_counter() < deadline:
            self.poll()
            self.sleep()


def counters():
    """``decode_metrics``' snapshot, with the raw slot sums beside its
    rounded occupancy."""
    from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
    snap = decode_metrics.snapshot()
    snap["slot_steps"] = decode_metrics.slot_steps
    snap["slot_capacity_steps"] = decode_metrics.slot_capacity_steps
    return snap


def reset_counters() -> None:
    from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
    decode_metrics.reset()


def captures() -> int:
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics
    return compile_metrics.compile_count


def pct(values, q: float) -> Optional[float]:
    """The ``q`` quantile by nearest rank: the smallest sample with at
    least a ``q`` share of the samples at or below it."""
    if not values:
        return None
    s = sorted(values)
    return s[max(int(math.ceil(q * len(s))) - 1, 0)]


# -- correctness --------------------------------------------------------------

def sample(finished: List[Record], seed: int, n: int) -> List[Record]:
    """Up to ``n`` finished requests drawn from the seed, half of them
    greedy and half sampled: of each kind the one with the most served
    tokens, and others in random order."""
    ok = [r for r in finished if r.error is None and r.tokens is not None
          and r.tokens.size > 0]
    rng = generators.rng_of(seed, 5)
    out: List[Record] = []
    for greedy in (True, False):
        kind = [r for r in ok if (r.req.temperature <= 0.0) == greedy]
        if not kind:
            continue
        longest = max(kind, key=lambda r: (r.tokens.size, r.req.prompt.size))
        rest = [kind[i] for i in rng.permutation(len(kind))
                if kind[i] is not longest]
        out += [longest] + rest[:max(n // 2, 1) - 1]
    return out


def served_gap(ctx, params, recs: List[Record], mm=ref.mm_fp32,
               pick=None) -> Dict[str, Dict[str, Any]]:
    """``{"gap", "gap_sampled"}``: over the served tokens of the greedy
    and of the sampled requests of ``recs``, the widest gap between the
    float32 reference's best score and its score of the served token at
    that position (``sampler.scores``).  With ``pick`` (a second ``mm``)
    the token judged at each position is instead the one ``pick``'s
    forward puts first under the same noise (the control, which need not
    decode)."""
    torch = ctx.torch
    fam = ctx.family
    eps = fam.sizes(ctx.conf)["eps"]
    got = {k: {"value": 0.0, "tokens": 0, "requests": 0}
           for k in ("gap", "gap_sampled")}
    with ref.exact_fp32(), torch.no_grad():
        for r in recs:
            ids = np.concatenate([r.req.prompt, r.tokens]).astype(np.int64)
            tp = r.req.prompt.size
            t, seed = r.req.temperature, r.req.seed
            logits = fam.reference_logits(params, ids[:-1], eps, mm,
                                          ctx.device)[tp - 1:]
            pos = torch.arange(tp - 1, tp - 1 + logits.shape[0],
                               device=logits.device)
            sc = sampler.scores(logits, t, seed, pos)
            del logits
            if pick is None:
                tok = torch.from_numpy(r.tokens.astype(np.int64)).to(
                    sc.device)
            else:
                low = fam.reference_logits(params, ids[:-1], eps, pick,
                                           ctx.device)[tp - 1:]
                tok = sampler.scores(low, t, seed, pos).argmax(-1)
                del low
            gap = sc.max(-1).values - sc.gather(-1, tok[:, None])[:, 0]
            g = got["gap" if t <= 0.0 else "gap_sampled"]
            g["value"] = max(g["value"], float(gap.max()))
            g["tokens"] += int(tok.numel())
            g["requests"] += 1
            del sc, gap
    return got


def judge(ctx, recs: List[Record]) -> Dict[str, Any]:
    """Failures and malformed answers among ``recs``."""
    vocab = ctx.family.sizes(ctx.conf)["vocab"]
    failed = sum(1 for r in recs if r.error is not None or r.tokens is None)
    malformed = sum(1 for r in recs if r.tokens is not None and (
        r.tokens.size != r.req.max_tokens
        or (r.tokens.size and (r.tokens.min() < 0
                               or r.tokens.max() >= vocab))))
    return {"failed": failed, "malformed": malformed}


def finish(ctx, out, server: Server, window: List[Record],
           keep: bool = False):
    """After the drain: read the memory peak, free the engine (unless
    ``keep``: a readings run serves further seeds on it), and compare a
    sample of ``window`` with the reference; fills ``out``'s attempted,
    failed, checks and passed."""
    from benchmark.drivers.train import held

    torch = ctx.torch
    if ctx.device.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
    params = server.params
    if not keep:
        server.close()
    j = judge(ctx, window)
    out.attempted = len(window)
    out.failed = j["failed"]
    recs = sample(window, ctx.seed, int(ctx.workload["check_requests"]))
    gaps = served_gap(ctx, params, recs)
    out.notes.append(
        f"compared {gaps['gap']['tokens']} served tokens of "
        f"{gaps['gap']['requests']} greedy requests and "
        f"{gaps['gap_sampled']['tokens']} of "
        f"{gaps['gap_sampled']['requests']} sampled ones; malformed "
        f"answers {j['malformed']}")
    share = float(ctx.traffic["greedy_share"])
    # every kind the traffic sends has to have been compared
    seen = (share <= 0.0 or gaps["gap"]["tokens"] > 0) and \
        (share >= 1.0 or gaps["gap_sampled"]["tokens"] > 0)
    out.checks, ok = held(ctx, gaps)
    out.passed = ok and seen and j["failed"] == 0 and j["malformed"] == 0
    if keep:
        out.material["_sample"] = recs
        out.material["_params"] = params
