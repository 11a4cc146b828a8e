"""Interval arithmetic over a device trace: the union of busy intervals,
the gaps between them, and the host call that covered each gap.

Work that overlaps on two streams (a decode engine runs on a stream of
its own beside the default one) is counted once: the busy time is the
length of the union of the intervals, not the sum of their durations.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]


def union(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, as sorted
    disjoint intervals."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in intervals
                     if b > lo and a < hi)
    out: List[Interval] = []
    for a, b in clipped:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(intervals: Sequence[Interval]) -> int:
    """Total length of disjoint ``intervals``."""
    return sum(b - a for a, b in intervals)


def gaps(busy: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The idle intervals of ``[lo, hi]`` between disjoint sorted
    ``busy`` intervals."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(idle: Sequence[Interval],
              spans: Sequence[Tuple[int, int, str]]) -> List[Optional[str]]:
    """For each gap of ``idle``, the name of the innermost span of
    ``spans`` that covers its start (None where none does).  ``spans``
    are one thread's, so they nest: a sweep in time order keeps the open
    ones on a stack."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    order = sorted(range(len(idle)), key=lambda i: idle[i][0])
    out: List[Optional[str]] = [None] * len(idle)
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for g in order:
        a = idle[g][0]
        while i < len(spans) and spans[i][0] <= a:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= a:
            stack.pop()
        out[g] = stack[-1][2] if stack else None
    return out


def label_gaps(idle: Sequence[Interval],
               spans: Sequence[Tuple[int, int, str]],
               default: str = "no traced host call") -> Dict[str, float]:
    """Idle time by the innermost span of one thread's ``spans`` that
    covers each gap's start."""
    out: Dict[str, float] = {}
    for (a, b), name in zip(idle, innermost(idle, spans)):
        name = default if name is None else name
        out[name] = out.get(name, 0.0) + (b - a)
    return out
