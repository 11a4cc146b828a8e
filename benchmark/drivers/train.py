"""Training cells: the program's training step, timed over a window.

Set-up builds one step (the program's ``make_train_step`` with its
optimizer) and one state from the benchmark's own weights, and drives
that state through the first three steps with the window's own call and
feed, on three batches whose rows all differ.  Those three steps are what
the reference follows (``benchmark/check/train.py``); the same state goes
on into the window.  In the window every step is enqueued as the
program would be by a training loop, with at most ``LOOKAHEAD`` steps
in flight, and the window ends with a synchronize.  ``train_step_ms`` is
the window's length over the steps completed in it.
"""

from __future__ import annotations

import collections
import gc
import time
from typing import Dict, List

from benchmark.check import train as check
from benchmark.counts import flops as counts
from benchmark.families import weights
from benchmark.harness.core import Outcome
from benchmark.reference import transformer as ref

#: steps enqueued ahead of the one the host waits for
LOOKAHEAD = 2
#: steps the reference follows
REF_STEPS = 3


class Trainer:
    """The program's step for one configuration, built once."""

    def __init__(self, ctx):
        from deeplearning4j_tpu_torch.ops import updaters

        self.ctx = ctx
        self.torch = ctx.torch
        self.fam = ctx.family
        self.cfg = self.fam.port_config(ctx.conf)
        oc = ctx.conf["port"]["optimizer"]
        self.opt_conf = oc
        self.optimizer = updaters.adamw(oc["learning_rate"],
                                        weight_decay=oc["weight_decay"])
        self.step_fn = self.fam.make_train_step(self.cfg, self.optimizer,
                                                ctx.device)

    def first_steps(self, seed: int):
        """``(state, program, params0, batches)``: the state after the
        first ``REF_STEPS`` steps from the seed's weights, and what the
        comparison reads of them."""
        from deeplearning4j_tpu_torch.models.transformer import TrainState

        ctx = self.ctx
        params0 = weights.make(self.fam.leaves(ctx.conf), seed, ctx.device,
                               **ctx.workload["weights"])
        batches = self.fam.batches(ctx.traffic, ctx.conf, seed, ctx.device)
        state = TrainState(params0, self.optimizer.init(params0), 0)
        losses = []
        grads = None
        b1 = self.opt_conf.get("b1", 0.9)
        for k in range(REF_STEPS):
            state, loss = self.step_fn(state, batches[k])
            losses.append(loss)
            if k == 0:
                # the first moment after one step is (1 - b1) g
                grads = {n: t.detach().float() / (1.0 - b1) for n, t in
                         weights.flat_leaves(state.opt_state.mu)}
        program = {"losses": [float(x) for x in losses], "grads": grads,
                   "params": {n: t.detach().clone() for n, t in
                              weights.flat_leaves(state.params)}}
        return state, program, params0, batches

    def reference(self, params0, batches, mm=ref.mm_fp32) -> Dict:
        return check.reference_steps(
            self.fam, params0, batches[:REF_STEPS], self.opt_conf,
            self.fam.sizes(self.ctx.conf)["eps"], mm,
            int(self.ctx.workload["reference_row_block"]))


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> Outcome:
    torch = ctx.torch
    dev = ctx.device
    out = Outcome()
    tr = Trainer(ctx)
    state, program, params0, batches = tr.first_steps(ctx.seed)
    _sync(torch, dev)
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics
    captures0 = compile_metrics.compile_count
    cuda = dev.type == "cuda"
    pending: collections.deque = collections.deque()
    losses: List = []
    n = 0
    i = REF_STEPS
    span = ctx.tracer.span
    seconds = ctx.window_seconds
    with ctx.tracer.window():
        t0 = time.perf_counter()
        setup_s = ctx.setup_clock(t0)
        while True:
            with span("bench.step_fn"):
                state, loss = tr.step_fn(state, batches[i % len(batches)])
            losses.append(loss)
            i += 1
            n += 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                if len(pending) > LOOKAHEAD:
                    with span("bench.synchronize"):
                        pending.popleft().synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        with span("bench.synchronize"):
            _sync(torch, dev)
        t1 = time.perf_counter()
    window_s = t1 - t0
    out.notes.append(f"window {window_s:.6f} s, {n} steps, captures in the "
                     f"window {compile_metrics.compile_count - captures0}")
    if cuda:
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    finite = torch.isfinite(torch.stack([x.float() for x in losses]))
    out.attempted = n
    out.failed = int((~finite).sum())
    out.e2e = {"train_step_ms": window_s / n * 1e3, "setup_s": setup_s}
    s = ctx.family.shape(ctx.traffic, ctx.conf)
    out.material = {
        "window_s": window_s, "steps": n, "shape": s,
        "flops_per_step": counts.train_step_flops(
            s["layers"], s["hidden"], s["ffn"], s["vocab"], s["batch"],
            s["seq"], s["causal"])}
    # the program's state goes before the reference runs
    del state, losses, pending
    tr.step_fn = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    refr = tr.reference(params0, batches)
    got = check.compare(program, refr, dict(weights.flat_leaves(params0)))
    out.notes.append(f"leaves left out of the change: "
                     f"{got.pop('_dead_leaves')}")
    out.checks, out.passed = held(ctx, got)
    out.passed = out.passed and out.failed == 0
    return out


def held(ctx, numbers: Dict[str, Dict]):
    """``(checks, all within their limits)``: each number beside its
    limit; a limit of null is a number not compared."""
    checks, ok = {}, True
    for name, got in numbers.items():
        lim = ctx.workload["limits"].get(name)
        entry = {"value": got["value"], "limit": lim}
        if "leaf" in got:
            entry["leaf"] = got["leaf"]
        checks[name] = entry
        if lim is not None and not got["value"] <= lim:
            ok = False
    return checks, ok
