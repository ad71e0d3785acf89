"""Exact all-pairs eps-neighbourhood self-join: the fixed-radius graph.

The counterpart of ``repro.core.graph``.  The paper's flagship application
(§6.4, DBSCAN) and every radius-graph workload need the full (n, n) graph
whose row i lists every point within ``eps`` of point i.
`build_neighbor_graph` builds it exactly, as the self-join ``join(X, X,
eps)`` of `core.join`, with what only a self-join has: **the queries ARE
the database**, so the index's own alpha-sorted order is the schedule, and
symmetry can be used.

* the sorted database is cut into contiguous segments of ``segment_rows``
  rows (`engine.segments_from_index`), on the index's device;
* queries run in sorted order, ``query_chunk`` rows at a time: a chunk of
  alpha-adjacent queries spans a narrow alpha window, so the engine's
  segment prune discards most segments before any launch;
* ``symmetric=True`` evaluates each cross-chunk pair once: chunk k joins
  only segments from its own first segment on (the block upper triangle),
  and `join.mirror_merge` adds the mirrored pairs.  Rows still ascend in
  sorted position, so the graph equals the plain one up to pairs exactly
  on the float32 boundary, whose predicate is evaluated in one direction
  instead of two.

Rows and column ids are in ORIGINAL point order, so ``graph.row(i)`` is
``query_radius_csr(index, x[i:i+1], eps).row(0)``.

`build_neighbor_graph_sharded` runs the same self-join over a mesh's shard
decomposition (`core.sharded.mesh_segments`: one segment a shard).
`min_label_components` is the vectorized connected-components routine
`core.dbscan` clusters with.
"""
from __future__ import annotations

import numpy as np

from ..kernels import registry as _registry
from . import engine as _engine
from . import snn as _snn
from .join import _empty_csr, resolve_chunk, sorted_join_csr


# --------------------------------------------------------------------------- #
# Connected components (vectorized)                                            #
# --------------------------------------------------------------------------- #
def min_label_components(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Per-node component labels: the minimum node id reachable from each.

    Min-label propagation with pointer jumping: every round scatter-mins
    neighbour labels along both edge directions, then compresses label
    chains (``lab = lab[lab]``) until idempotent.  Labels only fall and are
    bounded below, so the loop ends; at the fixed point they are constant on
    components and equal to the component's minimum id.  Edges may be given
    in either or both directions.
    """
    lab = np.arange(n, dtype=np.int64)
    if n == 0 or rows.size == 0:
        return lab
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    while True:
        new = lab.copy()
        np.minimum.at(new, rows, lab[cols])
        np.minimum.at(new, cols, lab[rows])
        changed = bool((new < lab).any())
        lab = new
        while True:
            jumped = lab[lab]
            if (jumped == lab).all():
                break
            lab = jumped
        if not changed:
            return lab


def _graph_from_join(index, segments, x_sorted, eps, *, symmetric: bool,
                     query_chunk: int, segs_per_chunk: int, query_tile: int,
                     return_distance: bool, native: bool, packed: bool = True,
                     mixed: bool = False):
    """`join.sorted_join_csr` with the index's own order as the schedule
    (the queries ARE the sorted database, so ``dest = index.order`` undoes
    the sort)."""
    return sorted_join_csr(
        index, segments, x_sorted, eps, symmetric=symmetric,
        query_chunk=query_chunk, segs_per_chunk=segs_per_chunk,
        query_tile=query_tile, return_distance=return_distance,
        native=native, dest=index.order, packed=packed, mixed=mixed)


def _self_join_inputs(x, eps, index, *, metric: str, n_iter: int, device,
                      symmetric: bool):
    """(x, index, eps) of a self-join: the index built on ``device`` when
    not given, ``x`` checked to be its data, a per-point eps checked and
    put in the sorted query order."""
    x = np.asarray(x)
    if index is None:
        index = _snn.build_index(x, metric=metric, n_iter=n_iter,
                                 device=_registry.resolve_device(device))
    n = index.n
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"x must be the index's (n, d) data; got shape "
                         f"{x.shape} for an index of n={n}")
    eps = np.asarray(eps, np.float64) if np.ndim(eps) else eps
    if np.ndim(eps):
        if symmetric:
            # a mirrored pair would be tested under two different radii
            raise ValueError("symmetric=True requires a uniform scalar eps; "
                             "use symmetric=False for per-point eps")
        if eps.shape != (n,):
            raise ValueError(f"per-point eps must have shape ({n},); "
                             f"got {eps.shape}")
        eps = eps[index.order]  # align with the sorted query order
    return x, index, eps


def build_neighbor_graph(
    x: np.ndarray,
    eps,
    *,
    index: _snn.SNNIndex | None = None,
    metric: str = "euclidean",
    return_distance: bool = False,
    symmetric: bool = False,
    query_chunk: int | None = 2048,
    memory_budget_mb: float | None = None,
    segment_rows: int | None = None,
    block: int = 512,
    query_tile: int = 128,
    native: bool = True,
    n_iter: int = 64,
    packed: bool = True,
    mixed: bool = False,
    device=None,
) -> _snn.CSRNeighbors:
    """Exact (n, n) eps-neighbour self-join of ``x`` as one `CSRNeighbors`.

    Row i lists every point of ``x`` within ``eps`` of ``x[i]`` (itself
    included where d(i, i) <= eps), rows and column ids in original point
    order, row contents ascending in the index's sorted order: per row
    bit-identical to ``query_radius_csr(index, x, eps)``.

    Args:
      x: (n, d) points; the database and the query set.
      eps: radius in the native metric (inner-product threshold for mips);
        a scalar, or with ``symmetric=False`` a per-point (n,) vector.
      index: prebuilt `SNNIndex` over exactly ``x`` (built here on
        ``device`` if None).
      symmetric: evaluate each cross-chunk pair once and mirror it.
      query_chunk: rows per scheduled chunk (default 2048).
      memory_budget_mb: when given, sizes the chunks in its place, as the
        rows of float32 over the padded database it holds
        (`join.resolve_chunk`; with ``symmetric`` floored to whole
        segments).
      segment_rows: rows per engine segment (default ``block``).
      packed: one `engine.SegmentPack` for the whole join, two stacked
        launches a chunk (default); False runs the looped executor, two
        launches per live segment.  Bit-identical either way.
      mixed: count pass with the certified bf16 product; same result.
      device: where the segments live and the passes run (default: the
        card; raises without one unless ``"cpu"``).

    Returns:
      `CSRNeighbors` with ``distances`` iff ``return_distance``.
    """
    dev = _registry.resolve_device(device)
    x, index, eps = _self_join_inputs(x, eps, index, metric=metric,
                                      n_iter=n_iter, device=dev,
                                      symmetric=symmetric)
    n = index.n
    if symmetric and return_distance and not native and index.metric == "mips":
        # the lifted squared Euclidean distance depends on which point is
        # the query, so it cannot be mirrored; native mips (p.q) can
        raise ValueError("symmetric=True cannot mirror non-native mips "
                         "distances; use native=True or symmetric=False")
    if n == 0:
        return _empty_csr(0, return_distance)
    sr = max(int(segment_rows), 1) if segment_rows is not None else block
    cs = resolve_chunk(n, query_chunk, memory_budget_mb,
                       sr if symmetric else None, block)
    ids = np.arange(n, dtype=np.int64) if symmetric else None
    segments = _engine.segments_from_index(index, rows_per_segment=sr,
                                           block=block, ids=ids, device=dev)
    return _graph_from_join(
        index, segments, x[index.order], eps, symmetric=symmetric,
        query_chunk=cs, segs_per_chunk=cs // sr, query_tile=query_tile,
        return_distance=return_distance, native=native, packed=packed,
        mixed=mixed)


def build_neighbor_graph_sharded(
    x: np.ndarray,
    mesh,
    eps,
    *,
    index: _snn.SNNIndex | None = None,
    metric: str = "euclidean",
    axis: str = "data",
    return_distance: bool = False,
    query_chunk: int | None = 2048,
    memory_budget_mb: float | None = None,
    block: int = 512,
    query_tile: int = 128,
    native: bool = True,
    n_iter: int = 64,
    packed: bool = True,
    mixed: bool = False,
    device=None,
) -> _snn.CSRNeighbors:
    """`build_neighbor_graph` over a mesh's shard decomposition.

    The segment list is the mesh's shards (one `Segment` per shard of
    ``axis``, exactly as `sharded.query_radius_csr_sharded` uses; ``mesh``
    is a `DeviceMesh` or an int shard count), so the sorted-chunk schedule
    prunes whole shards per chunk: a query chunk touches only the
    contiguous run of shards its alpha windows overlap.  Symmetry is not
    used: the shards are the mesh's, not the chunk schedule's, so the
    triangular split does not apply.  Results are bit-identical to
    `build_neighbor_graph` with ``symmetric=False``.  The segments live on
    the index's device (built on ``device``, default the card, when
    ``index`` is None).
    """
    from . import sharded as _sharded

    x, index, eps = _self_join_inputs(x, eps, index, metric=metric,
                                      n_iter=n_iter, device=device,
                                      symmetric=False)
    n = index.n
    if n == 0:
        return _empty_csr(0, return_distance)
    cs = resolve_chunk(n, query_chunk, memory_budget_mb, None, block)
    segments = _sharded.mesh_segments(index, mesh, axis=axis, block=block)
    return _graph_from_join(
        index, segments, x[index.order], eps, symmetric=False,
        query_chunk=cs, segs_per_chunk=0, query_tile=query_tile,
        return_distance=return_distance, native=native, packed=packed,
        mixed=mixed)
