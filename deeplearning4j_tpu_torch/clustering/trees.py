"""Spatial index structures: KDTree, VPTree, QuadTree, SpTree.

Reference parity: ``clustering/kdtree/KDTree.java``,
``vptree/VpTreeNode.java``, ``quadtree/QuadTree.java:40`` (Barnes-Hut 2D),
``sptree/SpTree.java:17`` (n-D dual tree), ``HyperRect``.

These stay HOST-side by design (SURVEY.md §7.10): tree construction and
traversal are pointer-chasing workloads with data-dependent branching — the
opposite of what a device runs well.  The device-side consumer (Barnes-Hut
t-SNE in plot/tsne.py) calls into them between its device steps.  Distance math is numpy;
bulk queries vectorize over leaf buckets.

Port of ``deeplearning4j_tpu/clustering/trees.py``: a copy (numpy only).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# KDTree
# ---------------------------------------------------------------------------

class _KDNode:
    __slots__ = ("point", "idx", "axis", "left", "right")

    def __init__(self, point, idx, axis):
        self.point = point
        self.idx = idx
        self.axis = axis
        self.left: Optional[_KDNode] = None
        self.right: Optional[_KDNode] = None


class KDTree:
    """insert/contains/knn/nearest — KDTreeTest parity surface."""

    def __init__(self, dims: int):
        self.dims = dims
        self.root: Optional[_KDNode] = None
        self.size = 0

    @staticmethod
    def build(points: np.ndarray) -> "KDTree":
        points = np.asarray(points, np.float64)
        tree = KDTree(points.shape[1])

        def rec(idxs: np.ndarray, depth: int) -> Optional[_KDNode]:
            if idxs.size == 0:
                return None
            axis = depth % tree.dims
            order = np.argsort(points[idxs, axis], kind="stable")
            idxs = idxs[order]
            mid = idxs.size // 2
            node = _KDNode(points[idxs[mid]], int(idxs[mid]), axis)
            node.left = rec(idxs[:mid], depth + 1)
            node.right = rec(idxs[mid + 1:], depth + 1)
            return node

        tree.root = rec(np.arange(points.shape[0]), 0)
        tree.size = points.shape[0]
        return tree

    def insert(self, point) -> None:
        point = np.asarray(point, np.float64)
        self.size += 1
        idx = self.size - 1
        if self.root is None:
            self.root = _KDNode(point, idx, 0)
            return
        node = self.root
        depth = 0
        while True:
            axis = node.axis
            branch = "left" if point[axis] < node.point[axis] else "right"
            nxt = getattr(node, branch)
            if nxt is None:
                setattr(node, branch,
                        _KDNode(point, idx, (depth + 1) % self.dims))
                return
            node = nxt
            depth += 1

    def contains(self, point) -> bool:
        point = np.asarray(point, np.float64)

        def rec(node: Optional[_KDNode]) -> bool:
            if node is None:
                return False
            if np.array_equal(node.point, point):
                return True
            # equal split-axis values may sit in either subtree (build
            # median-splits runs of equal keys) — descend both on ties
            if point[node.axis] < node.point[node.axis]:
                return rec(node.left)
            if point[node.axis] > node.point[node.axis]:
                return rec(node.right)
            return rec(node.left) or rec(node.right)

        return rec(self.root)

    def knn(self, query, k: int = 1) -> List[Tuple[float, int]]:
        """[(distance, index)] sorted ascending."""
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negated dist

        def rec(node: Optional[_KDNode]):
            if node is None:
                return
            d = float(np.linalg.norm(node.point - query))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.idx))
            diff = query[node.axis] - node.point[node.axis]
            near, far = ((node.left, node.right) if diff < 0
                         else (node.right, node.left))
            rec(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                rec(far)

        rec(self.root)
        return sorted((-d, i) for d, i in heap)

    def nearest(self, query) -> Tuple[float, int]:
        return self.knn(query, 1)[0]


# ---------------------------------------------------------------------------
# VPTree
# ---------------------------------------------------------------------------

class _VPNode:
    __slots__ = ("idx", "threshold", "inside", "outside")

    def __init__(self, idx):
        self.idx = idx
        self.threshold = 0.0
        self.inside: Optional[_VPNode] = None
        self.outside: Optional[_VPNode] = None


class VPTree:
    """Vantage-point tree for metric knn (VpTreeNode.java parity)."""

    def __init__(self, points: np.ndarray, seed: int = 0):
        self.points = np.asarray(points, np.float64)
        rng = np.random.RandomState(seed)

        def rec(idxs: np.ndarray) -> Optional[_VPNode]:
            if idxs.size == 0:
                return None
            vp_pos = rng.randint(idxs.size)
            vp = int(idxs[vp_pos])
            rest = np.delete(idxs, vp_pos)
            node = _VPNode(vp)
            if rest.size == 0:
                return node
            d = np.linalg.norm(self.points[rest] - self.points[vp], axis=1)
            med = float(np.median(d))
            node.threshold = med
            node.inside = rec(rest[d < med])
            node.outside = rec(rest[d >= med])
            return node

        self.root = rec(np.arange(self.points.shape[0]))

    def knn(self, query, k: int = 1) -> List[Tuple[float, int]]:
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []
        tau = [np.inf]

        def rec(node: Optional[_VPNode]):
            if node is None:
                return
            d = float(np.linalg.norm(self.points[node.idx] - query))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.idx))
                tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d < node.threshold:
                rec(node.inside)
                if d + tau[0] >= node.threshold:
                    rec(node.outside)
            else:
                rec(node.outside)
                if d - tau[0] <= node.threshold:
                    rec(node.inside)

        rec(self.root)
        return sorted((-d, i) for d, i in heap)


# ---------------------------------------------------------------------------
# QuadTree (2-D Barnes-Hut) and SpTree (n-D)
# ---------------------------------------------------------------------------

class SpTree:
    """n-D space-partitioning tree with center-of-mass aggregates —
    the Barnes-Hut accelerator (SpTree.java parity; QuadTree is the D=2
    case, so ``QuadTree = SpTree`` here with an assertion helper)."""

    __slots__ = ("center", "half", "com", "mass", "children", "point_idx",
                 "is_leaf", "dims", "_pt")

    MAX_DEPTH = 32

    def __init__(self, center: np.ndarray, half: np.ndarray):
        self.center = center
        self.half = half
        self.dims = center.shape[0]
        self.com = np.zeros_like(center)
        self.mass = 0.0
        self.children: Optional[List[Optional["SpTree"]]] = None
        self.point_idx: Optional[int] = None
        self.is_leaf = True

    @staticmethod
    def build(points: np.ndarray) -> "SpTree":
        points = np.asarray(points, np.float64)
        lo, hi = points.min(axis=0), points.max(axis=0)
        center = (lo + hi) / 2.0
        half = np.maximum((hi - lo) / 2.0 + 1e-9, 1e-9)
        root = SpTree(center, half)
        for i, p in enumerate(points):
            root._insert(p, i, 0)
        return root

    def _child_index(self, p: np.ndarray) -> int:
        return int(sum((1 << d) for d in range(self.dims)
                       if p[d] >= self.center[d]))

    def _insert(self, p: np.ndarray, idx: int, depth: int) -> None:
        self.com = (self.com * self.mass + p) / (self.mass + 1.0)
        self.mass += 1.0
        if self.is_leaf and self.point_idx is None:
            self.point_idx = idx
            self._pt = p
            return
        if self.is_leaf:
            if depth >= self.MAX_DEPTH:
                return  # duplicate-point guard: aggregate only
            # split
            old_idx, old_p = self.point_idx, self._pt
            self.point_idx = None
            self.is_leaf = False
            self.children = [None] * (1 << self.dims)
            self._place(old_p, old_idx, depth)
        self._place(p, idx, depth)

    def _place(self, p: np.ndarray, idx: int, depth: int) -> None:
        ci = self._child_index(p)
        if self.children[ci] is None:
            offset = np.array([(1.0 if (ci >> d) & 1 else -1.0)
                               for d in range(self.dims)])
            self.children[ci] = SpTree(self.center + offset * self.half / 2,
                                       self.half / 2)
        self.children[ci]._insert(p, idx, depth + 1)

    def compute_non_edge_forces(self, p: np.ndarray, theta: float,
                                neg_f: np.ndarray) -> float:
        """Barnes-Hut negative-force accumulation for t-SNE; returns the
        normalization sum contribution."""
        if self.mass == 0 or (self.is_leaf and self.point_idx is not None
                              and np.array_equal(self._pt, p)):
            return 0.0
        diff = p - self.com
        d2 = float(diff @ diff)
        max_width = float(np.max(2.0 * self.half))
        if self.is_leaf or max_width * max_width < theta * theta * d2:
            q = 1.0 / (1.0 + d2)
            contrib = self.mass * q
            neg_f += contrib * q * diff
            return contrib * 1.0
        s = 0.0
        for ch in self.children:
            if ch is not None:
                s += ch.compute_non_edge_forces(p, theta, neg_f)
        return s


class QuadTree(SpTree):
    """2-D specialization (QuadTree.java parity)."""

    @staticmethod
    def build(points: np.ndarray) -> "SpTree":
        points = np.asarray(points, np.float64)
        assert points.shape[1] == 2, "QuadTree is 2-D; use SpTree"
        return SpTree.build(points)
