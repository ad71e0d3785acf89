"""DBSCAN on the exact radius-graph engine (paper §6.4).

The counterpart of ``repro.core.dbscan``.  Semantics match scikit-learn's
DBSCAN: a point is *core* iff its eps-ball holds >= min_samples points
(itself included); clusters are the connected components of core points
under eps-adjacency; a non-core point in a core's ball becomes a border
member of the lowest-id such cluster; everything else is noise (-1).

Every backend gives the region queries as one (n, n) eps-neighbour graph:
the engine backends build it on the device (`core.graph.
build_neighbor_graph`), the host ones repack per-point lists as CSR
(`_lists_to_graph`), and `labels_from_graph` clusters it on the host with
vectorized connected components: no Python loop over points.
"""
from __future__ import annotations

import numpy as np

from ..kernels import registry as _registry
from . import snn as _snn
from .baselines import BruteForce2, KDTree
from .graph import build_neighbor_graph, min_label_components

BACKENDS = ("snn", "snn-csr", "snn-graph", "brute", "kdtree")


def _lists_to_graph(lists) -> _snn.CSRNeighbors:
    """Repack per-point neighbour lists (host and baseline backends) as CSR."""
    counts = np.fromiter((len(nb) for nb in lists), np.int64, len(lists))
    flat = (np.concatenate(lists).astype(np.int64) if len(lists)
            else np.zeros(0, np.int64))
    indptr = np.zeros(len(lists) + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return _snn.CSRNeighbors(indptr, flat)


def neighbor_graph(x: np.ndarray, eps: float, backend: str = "snn",
                   query_chunk: int = 2048, device=None) -> _snn.CSRNeighbors:
    """The eps-neighbour graph DBSCAN answers its region queries with.

    Backends:
      * ``snn``: the host Algorithm 2 path (`snn.query_radius_batch`, one
        GEMM a query group on ``device``) over an index built there;
      * ``snn-csr``: the two-pass CSR engine on the graph builder's
        sorted-chunk schedule, on ``device``;
      * ``snn-graph``: the same with the symmetric self-join;
      * ``brute`` / ``kdtree``: the baseline exact searches, numpy on the
        host (``device`` is not used).

    ``device`` defaults to the card and raises without one unless
    ``"cpu"``.
    """
    if backend == "snn":
        index = _snn.build_index(x, device=_registry.resolve_device(device))
        return _lists_to_graph(
            _snn.query_radius_batch(index, x, eps, return_distance=False))
    if backend in ("snn-csr", "snn-graph"):
        return build_neighbor_graph(x, eps, query_chunk=query_chunk,
                                    symmetric=(backend == "snn-graph"),
                                    device=device)
    if backend == "brute":
        return _lists_to_graph(BruteForce2(x).query_radius(x, eps))
    if backend == "kdtree":
        return _lists_to_graph(KDTree(x).query_radius(x, eps))
    raise ValueError(f"unknown backend {backend!r}; valid: {BACKENDS}")


def labels_from_graph(graph: _snn.CSRNeighbors, min_samples: int) -> np.ndarray:
    """DBSCAN labels from a prebuilt eps-neighbour graph (noise = -1).

    The graph must be the symmetric self-join of the data, each row holding
    the point itself when it is its own neighbour.  Core mask from the
    ``indptr`` diffs, components by `min_label_components` over the
    core-core edges (cluster ids ordered by their smallest core id), border
    points by one scatter-min.
    """
    n = graph.m
    counts = np.diff(graph.indptr)
    core = counts >= min_samples
    labels = np.full(n, -1, np.int64)
    if not core.any():
        return labels
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    cols = np.asarray(graph.indices, np.int64)
    cc = core[rows] & core[cols]
    comp = min_label_components(n, rows[cc], cols[cc])
    reps = np.unique(comp[core])
    labels[core] = np.searchsorted(reps, comp[core])
    border = ~core[rows] & core[cols]
    if border.any():
        # a border point joins its lowest-id adjacent cluster; component
        # representatives order like cluster ids
        best = np.full(n, n, np.int64)
        np.minimum.at(best, rows[border], comp[cols[border]])
        hit = best < n
        labels[hit] = np.searchsorted(reps, best[hit])
    return labels


def dbscan(x: np.ndarray, eps: float, min_samples: int = 5,
           backend: str = "snn", query_chunk: int = 2048,
           device=None) -> np.ndarray:
    """Cluster ``x``; returns labels (n,), noise = -1.  The region queries
    run as one neighbour graph from ``backend`` (`neighbor_graph`; the
    device ones on ``device``, default the card); the labels are the same
    for every backend."""
    x = np.asarray(x, dtype=np.float32)
    graph = neighbor_graph(x, eps, backend, query_chunk, device=device)
    return labels_from_graph(graph, min_samples)


def normalized_mutual_information(a: np.ndarray, b: np.ndarray) -> float:
    """NMI with arithmetic-mean normalization (sklearn's default)."""
    a = np.asarray(a)
    b = np.asarray(b)
    n = a.shape[0]
    if n == 0:
        return 0.0
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    ka, kb = ai.max() + 1, bi.max() + 1
    cont = np.zeros((ka, kb), dtype=np.float64)
    np.add.at(cont, (ai, bi), 1.0)
    pij = cont / n
    pa = pij.sum(1, keepdims=True)
    pb = pij.sum(0, keepdims=True)
    nz = pij > 0
    mi = float((pij[nz] * np.log(pij[nz] / (pa @ pb)[nz])).sum())
    ha = float(-(pa[pa > 0] * np.log(pa[pa > 0])).sum())
    hb = float(-(pb[pb > 0] * np.log(pb[pb > 0])).sum())
    denom = (ha + hb) / 2.0
    return mi / denom if denom > 0 else 1.0
