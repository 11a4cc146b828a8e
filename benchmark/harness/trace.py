"""The traced window: ``torch.profiler`` over the window, reduced to the
numbers the per-layer readers take.

The window itself is a span (``bench.window``) recorded by the profiler,
so the device intervals and the host spans are clipped to it on the
profiler's own clock.  Device work is every kernel, copy and fill on
the card; its busy time is the union of their intervals.  The idle gaps
are named by the host call that covered each gap's start, on the
thread that launched the most device work (the benchmark's own spans on
a training loop, the program's worker thread under serving).
"""

from __future__ import annotations

import contextlib
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.counts import intervals

WINDOW = "bench.window"
#: the prefix of the benchmark's own host spans
BENCH_SPAN = "bench."
#: characters of a device operation's name kept in the breakdown
NAME_CHARS = 160


class Summary:
    """What a traced window leaves: device intervals by name, the window,
    and the idle time by host call."""

    def __init__(self, window: Tuple[int, int],
                 device: List[Tuple[int, int, str]],
                 idle_by_host: Dict[str, float]):
        self.window = window
        self.device = device
        lo, hi = window
        self.busy = intervals.union(((a, b) for a, b, _ in device), lo, hi)
        self.window_s = (hi - lo) / 1e9
        self.busy_s = intervals.covered(self.busy) / 1e9
        self.idle_by_host = idle_by_host

    def kernel_seconds(self, patterns: Sequence[str]) -> float:
        """Seconds of device operations whose name holds any of
        ``patterns``, inside the window (summed: one kernel's time)."""
        lo, hi = self.window
        return sum(min(b, hi) - max(a, lo) for a, b, n in self.device
                   if b > lo and a < hi and any(p in n for p in patterns)
                   ) / 1e9

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        lo, hi = self.window
        by: Dict[str, int] = defaultdict(int)
        for a, b, n in self.device:
            if b > lo and a < hi:
                by[n[:NAME_CHARS]] += min(b, hi) - max(a, lo)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
                "idle_gaps": [[n, ns / 1e9] for n, ns in idle]}


class Tracer:
    """``with tracer.window():`` around the measured window.  Disabled, it
    costs one no-op context per window."""

    def __init__(self, enabled: bool, torch):
        self.enabled = enabled
        self.torch = torch
        self.prof = None
        self.summary: Optional[Summary] = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        try:
            with record_function(WINDOW):
                yield
        finally:
            self.prof.__exit__(None, None, None)
        self.summary = summarize(self.prof, self.torch)
        self.prof = None

    def span(self, name: str):
        """A host span of the benchmark's own, recorded when tracing."""
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)


def summarize(prof, torch) -> Summary:
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    device: List[Tuple[int, int, str]] = []
    host: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    launches: Counter = Counter()
    annotations = set()
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == cuda:
            device.append((start, end, name))
            continue
        annotations.add(name)
        if name == WINDOW:
            window = (start, end)
            continue
        tid = e.start_thread_id()
        if name.startswith(("cudaGraphLaunch", "cudaLaunchKernel",
                            "cuLaunchKernel", "cudaMemcpy")):
            launches[tid] += 1
        host[tid].append((start, end, name))
    # a host span's image on the device's timeline bears the host span's
    # name; it is not device work (kernels, copies and fills never share
    # a name with a host call)
    device = [d for d in device if d[2] not in annotations]
    if window is None:
        raise RuntimeError("the traced window's span is missing from the "
                           "profiler's trace")
    lo, hi = window
    busy = intervals.union(((a, b) for a, b, _ in device), lo, hi)
    idle = intervals.gaps(busy, lo, hi)
    # the program's own calls name a gap first (on the thread that
    # launched the most device work first), the benchmark's spans next
    order = sorted(host, key=lambda tid: -launches[tid])
    named = [intervals.innermost(idle, host[tid]) for tid in order]
    by: Dict[str, float] = defaultdict(float)
    for i, (a, b) in enumerate(idle):
        labels = [n[i] for n in named if n[i] is not None]
        prog = [x for x in labels if not x.startswith(BENCH_SPAN)]
        name = (prog or labels or ["no traced host call"])[0]
        by[name] += b - a
    return Summary(window, device, dict(by))
