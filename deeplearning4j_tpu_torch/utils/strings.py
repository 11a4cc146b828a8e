"""String-grid utilities — ``util/{Index,StringGrid,StringCluster}.java``
parity: bidirectional vocab index, a CSV-like string grid with
fingerprint-based near-duplicate clustering (the reference uses these for
data dedup before NLP training).

Port of ``deeplearning4j_tpu/utils/strings.py``: a copy (stdlib only).
"""

from __future__ import annotations

import collections
import re
from typing import Dict, Iterable, List, Optional, Sequence

_PUNCT = re.compile(r"[^\w\s]")


class Index:
    """Bidirectional object<->int index (util/Index.java parity)."""

    def __init__(self):
        self._to_id: Dict[object, int] = {}
        self._items: List[object] = []

    def add(self, obj) -> int:
        if obj in self._to_id:
            return self._to_id[obj]
        i = len(self._items)
        self._to_id[obj] = i
        self._items.append(obj)
        return i

    def index_of(self, obj) -> int:
        return self._to_id.get(obj, -1)

    def get(self, i: int):
        return self._items[i]

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, obj) -> bool:
        return obj in self._to_id

    def __iter__(self):
        return iter(self._items)


def fingerprint(s: str) -> str:
    """OpenRefine-style key: lowercase, strip punctuation, unique sorted
    tokens — near-duplicates share a fingerprint."""
    tokens = _PUNCT.sub("", s.lower()).split()
    return " ".join(sorted(set(tokens)))


class StringCluster:
    """Groups of rows sharing a fingerprint (StringCluster.java parity);
    ordered by cluster size so the largest duplicate groups come first."""

    def __init__(self, strings: Iterable[str]):
        self.groups: Dict[str, List[str]] = collections.defaultdict(list)
        for s in strings:
            self.groups[fingerprint(s)].append(s)

    def clusters(self) -> List[List[str]]:
        return sorted(self.groups.values(), key=len, reverse=True)

    def duplicates(self) -> List[List[str]]:
        return [g for g in self.clusters() if len(g) > 1]

    def canonical(self, s: str) -> str:
        """Most frequent variant in s's cluster."""
        group = self.groups.get(fingerprint(s), [s])
        counts = collections.Counter(group)
        return counts.most_common(1)[0][0]


class StringGrid:
    """Row/column grid of strings (StringGrid.java parity) with
    column-scoped dedup by fingerprint."""

    def __init__(self, rows: Optional[Sequence[Sequence[str]]] = None,
                 sep: str = ","):
        self.sep = sep
        self.rows: List[List[str]] = [list(r) for r in (rows or [])]

    @staticmethod
    def from_lines(lines: Iterable[str], sep: str = ",") -> "StringGrid":
        return StringGrid([ln.rstrip("\n").split(sep) for ln in lines
                           if ln.strip()], sep=sep)

    def num_rows(self) -> int:
        return len(self.rows)

    def num_columns(self) -> int:
        return len(self.rows[0]) if self.rows else 0

    def get_column(self, c: int) -> List[str]:
        return [r[c] for r in self.rows]

    def get_row(self, r: int) -> List[str]:
        return list(self.rows[r])

    def filter_rows_by_column(self, c: int, allowed: Iterable[str]
                              ) -> "StringGrid":
        allow = set(allowed)
        return StringGrid([r for r in self.rows if r[c] in allow], self.sep)

    def dedup_column(self, c: int) -> "StringGrid":
        """Keep the first row per fingerprint of column ``c`` (the
        reference's fingerprint-dedup flow)."""
        seen = set()
        out = []
        for r in self.rows:
            key = fingerprint(r[c])
            if key in seen:
                continue
            seen.add(key)
            out.append(r)
        return StringGrid(out, self.sep)

    def cluster_column(self, c: int) -> StringCluster:
        return StringCluster(self.get_column(c))

    def to_lines(self) -> List[str]:
        return [self.sep.join(r) for r in self.rows]
