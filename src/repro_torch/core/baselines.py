"""Baselines the paper compares against (all exact); the port's own numpy
copy of ``repro.core.baselines``, bit-identical to it.

* brute force 1 — naive per-query ``((X - q)**2).sum``  (paper's "brute force 1").
* brute force 2 — BLAS form with precomputed half-norms, no pruning
  (paper's "brute force 2" == SNN without index/pruning).
* kd-tree       — median-split tree with plane-distance pruning
  (scikit-learn/Matlab/SciPy all use tree methods; we implement our own since
  the container is offline).
* grid          — GriSPy-style regular grid hash (practical for small d only).
"""
from __future__ import annotations

import numpy as np

from . import metrics as _metrics


# --------------------------------------------------------------------------- #
# Brute force                                                                  #
# --------------------------------------------------------------------------- #
class BruteForce1:
    """Naive exhaustive search (one pass of explicit differences per query)."""

    def __init__(self, p: np.ndarray, metric: str = "euclidean"):
        self.metric = metric
        self.x, self.xi = _metrics.transform_data(p, metric)

    def query_radius(self, q: np.ndarray, radius) -> list[np.ndarray]:
        tq = _metrics.transform_query(np.asarray(q), self.metric)
        r = _metrics.euclidean_radius(radius, tq, self.metric, self.xi)
        out = []
        for i in range(tq.shape[0]):
            diff = self.x - tq[i][None, :]
            sq = np.einsum("nd,nd->n", diff, diff)
            out.append(np.nonzero(sq <= r[i] * r[i])[0].astype(np.int64))
        return out


class BruteForce2:
    """BLAS exhaustive search: half-norm trick + GEMM, no pruning (paper §6.1)."""

    def __init__(self, p: np.ndarray, metric: str = "euclidean"):
        self.metric = metric
        self.x, self.xi = _metrics.transform_data(p, metric)
        self.half_norms = 0.5 * np.einsum("nd,nd->n", self.x, self.x)

    def query_radius(self, q: np.ndarray, radius) -> list[np.ndarray]:
        tq = _metrics.transform_query(np.asarray(q), self.metric)
        r = _metrics.euclidean_radius(radius, tq, self.metric, self.xi)
        qsq = np.einsum("md,md->m", tq, tq)
        # one GEMM for the whole batch
        dhalf = self.half_norms[None, :] - tq @ self.x.T
        thresh = (r * r - qsq) / 2.0
        return [np.nonzero(dhalf[i] <= thresh[i])[0].astype(np.int64)
                for i in range(tq.shape[0])]


# --------------------------------------------------------------------------- #
# kd-tree                                                                      #
# --------------------------------------------------------------------------- #
class KDTree:
    """Array-based median-split kd-tree with exact radius queries.

    Nodes are stored in flat arrays; leaves hold up to ``leaf_size`` points.
    Query descends with the standard |q[axis] - split| <= r plane test.
    """

    def __init__(self, p: np.ndarray, leaf_size: int = 40, metric: str = "euclidean"):
        self.metric = metric
        x, self.xi = _metrics.transform_data(p, metric)
        self.x = np.ascontiguousarray(x)
        n = x.shape[0]
        self.idx = np.arange(n, dtype=np.int64)
        self.leaf_size = leaf_size
        # node arrays
        self._axis: list[int] = []
        self._split: list[float] = []
        self._left: list[int] = []
        self._right: list[int] = []
        self._lo: list[int] = []
        self._hi: list[int] = []
        if n:
            self._build(0, n)

    def _new_node(self) -> int:
        for a in (self._axis, self._split, self._left, self._right, self._lo, self._hi):
            a.append(-1)
        return len(self._axis) - 1

    def _build(self, lo: int, hi: int) -> int:
        node = self._new_node()
        self._lo[node], self._hi[node] = lo, hi
        if hi - lo <= self.leaf_size:
            return node
        seg = self.idx[lo:hi]
        pts = self.x[seg]
        axis = int(np.argmax(pts.max(0) - pts.min(0)))
        ordk = np.argsort(pts[:, axis], kind="stable")
        self.idx[lo:hi] = seg[ordk]
        mid = (hi - lo) // 2
        self._axis[node] = axis
        self._split[node] = float(self.x[self.idx[lo + mid], axis])
        self._left[node] = self._build(lo, lo + mid)
        self._right[node] = self._build(lo + mid, hi)
        return node

    def query_radius(self, q: np.ndarray, radius) -> list[np.ndarray]:
        tq = _metrics.transform_query(np.asarray(q), self.metric)
        r = _metrics.euclidean_radius(radius, tq, self.metric, self.xi)
        out = []
        for i in range(tq.shape[0]):
            hits: list[np.ndarray] = []
            self._query_one(0, tq[i], float(r[i]), hits)
            out.append(np.sort(np.concatenate(hits)) if hits
                       else np.zeros(0, np.int64))
        return out

    def _query_one(self, node: int, q: np.ndarray, r: float, hits: list) -> None:
        if self._axis[node] < 0:  # leaf
            seg = self.idx[self._lo[node]: self._hi[node]]
            diff = self.x[seg] - q[None, :]
            sq = np.einsum("nd,nd->n", diff, diff)
            sel = seg[sq <= r * r]
            if sel.size:
                hits.append(sel)
            return
        axis, split = self._axis[node], self._split[node]
        delta = q[axis] - split
        near, far = (self._left[node], self._right[node]) if delta < 0 else \
                    (self._right[node], self._left[node])
        self._query_one(near, q, r, hits)
        if abs(delta) <= r:
            self._query_one(far, q, r, hits)

    def query_knn(self, q: np.ndarray, k: int, return_distance: bool = True):
        """Exact k nearest neighbors: (indices (m,k), distances (m,k)).

        Branch-and-bound over the same tree: descend the near child first,
        visit the far child only while the plane distance can beat the
        current k-th best.  Output contract matches `core.knn.query_knn`
        (distances ascending, ties by id, -1/+inf past the database size;
        native-metric distances, so inner products for mips).
        """
        tq = _metrics.transform_query(np.asarray(q), self.metric)
        m, n = tq.shape[0], self.x.shape[0]
        k = int(k)
        out_i = np.full((m, k), -1, np.int64)
        out_sq = np.full((m, k), np.inf, np.float64)
        kk = min(k, n)
        if kk:
            for i in range(m):
                best = [np.zeros(0, np.float64), np.zeros(0, np.int64)]
                self._knn_one(0, tq[i].astype(np.float64), kk, best)
                out_sq[i, :best[0].size] = best[0]
                out_i[i, :best[1].size] = best[1]
        if not return_distance:
            return out_i
        return out_i, _metrics.native_knn_distances(out_i, out_sq,
                                                    self.metric, self.xi, tq)

    def _knn_one(self, node: int, q: np.ndarray, kk: int, best: list) -> None:
        if self._axis[node] < 0:  # leaf
            seg = self.idx[self._lo[node]: self._hi[node]]
            diff = self.x[seg].astype(np.float64) - q[None, :]
            sq = np.einsum("nd,nd->n", diff, diff)
            d = np.concatenate([best[0], sq])
            ii = np.concatenate([best[1], seg])
            keep = np.lexsort((ii, d))[:kk]  # ascending distance, ties by id
            best[0], best[1] = d[keep], ii[keep]
            return
        axis, split = self._axis[node], self._split[node]
        delta = q[axis] - split
        near, far = (self._left[node], self._right[node]) if delta < 0 else \
                    (self._right[node], self._left[node])
        self._knn_one(near, q, kk, best)
        bound = best[0][-1] if best[0].size == kk else np.inf
        if delta * delta <= bound:
            self._knn_one(far, q, kk, best)


# --------------------------------------------------------------------------- #
# Regular grid (GriSPy-style)                                                  #
# --------------------------------------------------------------------------- #
class GridIndex:
    """Regular-grid hash index (GriSPy [38]); memory grows as cells^d."""

    def __init__(self, p: np.ndarray, n_cells: int = 16, metric: str = "euclidean"):
        x, self.xi = _metrics.transform_data(p, metric)
        self.metric = metric
        self.x = np.ascontiguousarray(x)
        self.n_cells = int(n_cells)
        self.lo = x.min(0) if x.size else np.zeros(x.shape[1])
        self.hi = x.max(0) if x.size else np.ones(x.shape[1])
        span = np.maximum(self.hi - self.lo, 1e-12)
        self.inv_w = self.n_cells / span
        cells = self._cell_of(x)
        order = np.lexsort(cells.T[::-1])
        self.sorted_idx = order.astype(np.int64)
        keys = [tuple(c) for c in cells[order]]
        self.table: dict[tuple, tuple[int, int]] = {}
        s = 0
        for e in range(1, len(keys) + 1):
            if e == len(keys) or keys[e] != keys[s]:
                self.table[keys[s]] = (s, e)
                s = e

    def _cell_of(self, x: np.ndarray) -> np.ndarray:
        c = np.floor((x - self.lo[None, :]) * self.inv_w[None, :]).astype(np.int64)
        return np.clip(c, 0, self.n_cells - 1)

    def query_radius(self, q: np.ndarray, radius) -> list[np.ndarray]:
        tq = _metrics.transform_query(np.asarray(q), self.metric)
        r = _metrics.euclidean_radius(radius, tq, self.metric, self.xi)
        d = self.x.shape[1]
        out = []
        for i in range(tq.shape[0]):
            clo = self._cell_of(np.maximum(tq[i] - r[i], self.lo)[None, :])[0]
            chi = self._cell_of(np.minimum(tq[i] + r[i], self.hi)[None, :])[0]
            ranges = [np.arange(clo[k], chi[k] + 1) for k in range(d)]
            mesh = np.stack(np.meshgrid(*ranges, indexing="ij"), -1).reshape(-1, d)
            segs = [self.sorted_idx[s:e]
                    for key in map(tuple, mesh)
                    for (s, e) in [self.table.get(key, (0, 0))] if e > s]
            if not segs:
                out.append(np.zeros(0, np.int64))
                continue
            cand = np.concatenate(segs)
            diff = self.x[cand] - tq[i][None, :]
            sq = np.einsum("nd,nd->n", diff, diff)
            out.append(np.sort(cand[sq <= r[i] * r[i]]))
        return out
