"""Bichromatic eps-join core: the one scheduling loop the front-ends run on.

The counterpart of ``repro.core.join``.  Every public workload is a thin
front-end over the engine:

* **point queries** (`snn.query_radius_csr`) are a join whose A side is one
  chunk: `single_query` hands the whole batch to the packed executor, or
  with ``packed=False`` to the looped one, and `query_counts` stops after
  pass 1;
* **the self-join graph** (`graph.build_neighbor_graph`) is ``join(X, X,
  eps)`` with the index's own order as the query sort, plus the symmetric
  triangular schedule and `mirror_merge`, which only a self-join can use;
* **bichromatic joins** (`join`) cut B into segments once, sort A's queries
  by their alpha score and stream alpha-adjacent chunks through the engine
  (`chunked_join`): a chunk spans a narrow alpha window, so the segment
  prune discards most of B before any launch;
* **reverse neighbours** (`reverse_neighbors`) transpose the join CSR: with
  per-point radii as A's radius vector, row j of the transpose lists the
  points that hold target j inside their own ball;
* **count-only analytics** (`query_counts`, `join_counts`,
  `degree_histogram`, and `count_pass`, the kNN expansion's primitive) stop
  after pass 1 (`engine.run_counts_packed`): no compact pass, no flat
  outputs.

Per-row results are bit-identical to evaluating that row alone, whatever
the chunking, and pass-1 counts always equal pass-2 row lengths.  The CSR
plumbing (`permute_rows`, `transpose_csr`, `mirror_merge`) and the query
preparation run on the host in numpy, as in the reference; the passes run
on the segments' device.
"""
from __future__ import annotations

import numpy as np

from ..kernels import ops as _ops
from ..kernels import registry as _registry
from . import engine as _engine
from . import metrics as _metrics
from . import snn as _snn


# --------------------------------------------------------------------------- #
# CSR plumbing                                                                 #
# --------------------------------------------------------------------------- #
def indptr_from_counts(counts: np.ndarray) -> np.ndarray:
    out = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts, out=out[1:])
    return out


def permute_rows(indptr, indices, distances, dest):
    """Reorder CSR rows: input row i becomes output row ``dest[i]``.

    One O(nnz) gather; undoes a query sort (``dest = index.order`` for the
    self-join, the alpha argsort for a bichromatic join).
    """
    counts = np.diff(indptr)
    counts_out = np.empty_like(counts)
    counts_out[dest] = counts
    out_indptr = indptr_from_counts(counts_out)
    pos = np.repeat(out_indptr[:-1][dest] - indptr[:-1], counts) \
        + np.arange(indices.size)
    out_idx = np.empty_like(indices)
    out_idx[pos] = indices
    out_d = None
    if distances is not None:
        out_d = np.empty_like(distances)
        out_d[pos] = distances
    return out_indptr, out_idx, out_d


def transpose_csr(indptr, cols, dists, n_cols: int):
    """Exact CSR transpose: output row j lists every input row whose
    neighbour list holds j, in ascending input-row order; distances move
    with their pair."""
    rows = np.repeat(np.arange(indptr.size - 1, dtype=np.int64),
                     np.diff(indptr))
    order = np.argsort(cols, kind="stable")
    out_indptr = indptr_from_counts(
        np.bincount(cols, minlength=n_cols).astype(np.int64))
    out_d = None if dists is None else dists[order]
    return out_indptr, rows[order], out_d


def mirror_merge(indptr, cols, dists, chunk: int):
    """Complete a block-upper-triangular self-join with its mirror pairs.

    Rows and columns are sorted positions.  Every pair (i, j) whose column
    lies in a LATER query chunk than its row was evaluated once, so its
    mirror (j, i) is added here (pairs inside a chunk were evaluated both
    ways already).  Mirrored neighbours of row j all precede j's chunk and
    go ahead of the direct ones in ascending source order, so merged rows
    stay ascending in sorted position.  Distances mirror verbatim (the
    asymmetric case, non-native mips, is refused by the graph builder).
    """
    n = indptr.size - 1
    counts_d = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts_d)
    cross = (cols // chunk) > (rows // chunk)
    rows_m, cols_m = cols[cross], rows[cross]
    d_m = dists[cross] if dists is not None else None
    src = np.argsort(rows_m, kind="stable")  # group by target row, keep order
    rows_m, cols_m = rows_m[src], cols_m[src]
    counts_m = np.bincount(rows_m, minlength=n).astype(np.int64)
    indptr_m = indptr_from_counts(counts_m)
    out_indptr = indptr_from_counts(counts_m + counts_d)
    start = out_indptr[:-1]
    pos_m = np.repeat(start - indptr_m[:-1], counts_m) + np.arange(rows_m.size)
    pos_d = np.repeat(start + counts_m - indptr[:-1], counts_d) \
        + np.arange(cols.size)
    out_cols = np.empty(rows_m.size + cols.size, np.int64)
    out_cols[pos_m] = cols_m
    out_cols[pos_d] = cols
    out_d = None
    if dists is not None:
        out_d = np.empty(out_cols.size, dists.dtype)
        out_d[pos_m] = d_m[src]
        out_d[pos_d] = dists
    return out_indptr, out_cols, out_d


# --------------------------------------------------------------------------- #
# The chunked join loop (the core)                                             #
# --------------------------------------------------------------------------- #
def chunked_join(index, segments, xq, aq, r, th, *, query_chunk: int,
                 segs_per_chunk: int, query_tile: int = 128,
                 packed: bool = True, memory_budget_mb=None,
                 mixed: bool = False, compacted: bool | None = None,
                 oracle: bool = False):
    """Run alpha-sorted query chunks through the engine over ``segments``.

    ``xq``/``aq``/``r``/``th`` are the float32 predicate inputs of
    `snn.prepare_query_predicates`, already sorted ascending by ``aq`` (the
    caller owns the sort).  ``packed=True`` builds ONE `engine.SegmentPack`
    for the whole join and runs every chunk through `engine.run_csr_packed`
    (two stacked launches a chunk); ``packed=False`` runs the looped
    `engine.run_csr` (two launches per live segment), bit-identically.

    ``segs_per_chunk > 0`` turns on the triangular schedule: chunk k only
    sees segments from its own first segment on (chunks and segments must
    tile the sorted order, ``query_chunk`` a multiple of the segment size),
    which is only meaningful when the queries ARE the database.  Returns
    chunk-major (= ascending sorted row) ``(counts, flat_ids, flat_dh)``.
    ``oracle=True`` takes the engine's host lane (`engine.run_csr_packed`;
    CPU plans only, it raises on the card's), where ``compacted`` and
    ``memory_budget_mb`` select and bound its executors; off the lane both
    are ignored.
    """
    m = xq.shape[0]
    aq64 = np.asarray(aq, np.float64)
    r64 = np.asarray(r, np.float64)
    counts = np.zeros(m, np.int64)
    ids_parts: list[np.ndarray] = []
    dh_parts: list[np.ndarray] = []
    pack = _engine.SegmentPack.build(segments) if packed else None
    # the extra pruning projections come from B's basis: computed once for
    # the whole join, sliced per chunk
    pq_full = _snn.query_extra_projections(index, xq)
    pq64_full = (None if pq_full is None
                 else np.asarray(pq_full, np.float64))
    for c0 in range(0, m, query_chunk):
        c1 = min(c0 + query_chunk, m)
        k0 = (c0 // query_chunk) * segs_per_chunk if segs_per_chunk else 0
        qp, aqp, rp, thp, _ = _ops.pad_queries(
            xq[c0:c1], aq[c0:c1], r[c0:c1], th[c0:c1], tq=query_tile)
        pqp = (None if pq_full is None
               else _ops.pad_components(pq_full[:, c0:c1], qp.shape[0]))
        if packed:
            _, cnt, ids, dh = _engine.run_csr_packed(
                pack, qp, aqp, rp, thp, c1 - c0, query_tile=query_tile,
                first_seg=k0, memory_budget_mb=memory_budget_mb, pq=pqp,
                mixed=mixed, compacted=compacted, oracle=oracle)
        else:
            # the schedule: alpha-adjacent queries span a narrow window, so
            # most segments fail this interval test and never launch
            if pq64_full is None:
                live = [s for s in segments[k0:]
                        if _engine._window_may_hit(s, aq64[c0:c1],
                                                   r64[c0:c1])]
            else:
                qn64 = _engine._qnorm64(rp, thp, c1 - c0)
                live = [s for s in segments[k0:]
                        if _engine._window_may_hit(
                            s, aq64[c0:c1], r64[c0:c1],
                            pq64_full[:, c0:c1], qn64)]
            _, cnt, ids, dh = _engine.run_csr(
                live, qp, aqp, rp, thp, c1 - c0, query_tile=query_tile,
                memory_budget_mb=memory_budget_mb, pq=pqp, mixed=mixed,
                oracle=oracle)
        counts[c0:c1] = cnt
        ids_parts.append(ids)
        dh_parts.append(dh)
    flat_ids = (np.concatenate(ids_parts) if ids_parts
                else np.zeros(0, np.int64))
    flat_dh = (np.concatenate(dh_parts) if dh_parts
               else np.zeros(0, np.float32))
    return counts, flat_ids, flat_dh


def resolve_chunk(n: int, query_chunk: int | None, memory_budget_mb,
                  align: int | None, block: int) -> int:
    """Pick the query chunk size: explicit, or sized to a memory budget.

    With ``memory_budget_mb`` the chunk is the number of float32 rows of
    ``n_pad`` (``n`` rounded up to ``block``) the budget holds, the
    reference's bound on one dense (chunk, n_pad) filter, which the flat
    CSR outputs of a chunk scale with too.  The port's executors hold no
    such filter (the reference's CPU oracle executors do), so here the
    budget sizes the chunks and nothing else.  A budget is a CEILING: it
    floors the derived chunk, never inflates it.  Without one the chunk is
    ``query_chunk``, or 2048 when that is not given.

    ``align`` is the segment size the symmetric triangular schedule needs
    chunks to tile in whole multiples of (None when any chunk size works:
    the plain, sharded and bichromatic schedules).  Alignment floors to
    whole segments, again never inflating a budgeted chunk, except that
    one segment is the smallest chunk.
    """
    if memory_budget_mb is not None:
        n_pad = _ops.round_up(n, block)
        cs = int(memory_budget_mb * 2**20) // (4 * n_pad)
    else:
        cs = int(query_chunk) if query_chunk else 2048
    cs = max(cs, 1)
    if align:
        cs = max(cs // align, 1) * align
    return cs


def sorted_join_csr(index, segments, q_sorted, radius, *, symmetric: bool,
                    query_chunk: int, segs_per_chunk: int, query_tile: int,
                    return_distance: bool, native: bool, dest: np.ndarray,
                    packed: bool = True, memory_budget_mb=None,
                    mixed: bool = False, compacted: bool | None = None,
                    oracle: bool = False):
    """Shared tail of the self-join and bichromatic builders.

    ``q_sorted`` are raw query points in ascending-alpha order and ``dest``
    maps each sorted row to its public row (the self-join passes
    ``index.order``, `join` its own argsort).  Prepares predicates, runs the
    chunk loop, finalizes distances, mirror-completes the triangular
    schedule if ``symmetric``, and unsorts the rows.
    """
    xq, aq, r, th, qsq = _snn.prepare_query_predicates(index, q_sorted, radius)
    counts, flat_ids, flat_dh = chunked_join(
        index, segments, xq, aq, r, th, query_chunk=query_chunk,
        segs_per_chunk=segs_per_chunk if symmetric else 0,
        query_tile=query_tile, packed=packed,
        memory_budget_mb=memory_budget_mb, mixed=mixed, compacted=compacted,
        oracle=oracle)
    indptr = indptr_from_counts(counts)
    fin = _snn.csr_finalize(index, indptr, flat_ids, flat_dh, xq, qsq, counts,
                            return_distance, native)
    cols, dists = fin.indices, fin.distances
    if symmetric:
        indptr, cols, dists = mirror_merge(indptr, cols, dists, query_chunk)
        cols = index.order[cols]  # sorted positions -> original ids
    indptr, cols, dists = permute_rows(indptr, cols, dists, dest)
    return _snn.CSRNeighbors(indptr, cols, dists)


# --------------------------------------------------------------------------- #
# Resolution helpers shared by the thin front-ends                             #
# --------------------------------------------------------------------------- #
def _as_rows(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a[None, :] if a.ndim == 1 else a


def _resolve_pack(index, block: int, device=None):
    """(owner, pack) for an `SNNIndex` or a `streaming.StreamingSNNIndex`:
    ``owner`` holds the mu/v1/metric/xi every predicate derives from (the
    streaming base freezes them); ``pack`` is the streaming snapshot's plan,
    on the index's own device, or the index's cached plan on the device the
    call runs on (`resolve_device`: the card unless ``"cpu"``)."""
    if hasattr(index, "plan") and hasattr(index, "parts"):  # streaming
        parts, _, pack = index._snapshot()
        return parts[0], pack
    dev = _registry.resolve_device(device)
    return index, index.pack(block, dev)


def _checked_radius(radius, m: int):
    """Validate a scalar-or-(m,) radius BEFORE any query sort touches it."""
    if np.ndim(radius) == 0:
        return radius, None
    r = np.asarray(radius, np.float64)
    if r.shape != (m,):
        raise ValueError(f"radius must be a scalar or a per-row ({m},) "
                         f"vector; got shape {r.shape}")
    return r, r


def _empty_csr(m: int, return_distance: bool) -> _snn.CSRNeighbors:
    return _snn.CSRNeighbors(
        np.zeros(m + 1, np.int64), np.zeros(0, np.int64),
        np.zeros(0, np.float64) if return_distance else None)


# --------------------------------------------------------------------------- #
# Point queries as single-chunk joins                                          #
# --------------------------------------------------------------------------- #
def single_query(index, q, radius, return_distance: bool = True, *,
                 pack=None, block: int = 512, query_tile: int = 128,
                 native: bool = True, packed: bool = True,
                 memory_budget_mb=None, mixed: bool = False,
                 bucket: bool = True, compacted: bool | None = None,
                 fused: bool = True, oracle: bool = False,
                 device=None) -> _snn.CSRNeighbors:
    """A point-query batch through the engine over ``pack`` (default: the
    index's cached plan on ``device``): the packed executor, or with
    ``packed=False`` the looped one over the plan's segments, with
    bit-identical results.  ``oracle=True`` takes the engine's host lane (`engine.run_csr_packed`;
    CPU plans only, it raises on the card's), where ``compacted`` and
    ``memory_budget_mb`` select and bound its executors; off the lane both
    are ignored."""
    if pack is None:
        index, pack = _resolve_pack(index, block, device)
    if not packed:
        return _engine.query_csr(
            index, pack.segments, q, radius, return_distance,
            query_tile=query_tile, native=native,
            memory_budget_mb=memory_budget_mb, mixed=mixed, bucket=bucket,
            oracle=oracle)
    return _engine.query_csr_packed(
        index, pack, q, radius, return_distance, query_tile=query_tile,
        native=native, memory_budget_mb=memory_budget_mb, mixed=mixed,
        bucket=bucket, compacted=compacted, fused=fused, oracle=oracle)


def count_pass(pack, xq, aq, qsq, r, *, query_tile: int = 128,
               memory_budget_mb=None, pq=None, mixed: bool = False,
               bucket: bool = True, compacted: bool | None = None,
               oracle: bool = False) -> np.ndarray:
    """One engine count launch for prepared queries under Euclidean ``r``.

    The pass-1-only join primitive (`engine.run_counts_packed`): no compact
    pass, no flat outputs.  The kNN expansion loop re-enters it with a
    shrinking active subset each round; bucketed padding keeps that at
    O(log m) launch shapes instead of one a round.  ``oracle``,
    ``compacted`` and ``memory_budget_mb`` as in `single_query`.
    """
    thresh = ((r * r - qsq) / 2.0).astype(np.float32)
    qp, aqp, rp, thp, m = _ops.pad_queries(xq, aq, r.astype(np.float32),
                                           thresh, tq=query_tile,
                                           bucket=bucket)
    pqp = None if pq is None else _ops.pad_components(pq, qp.shape[0])
    return _engine.run_counts_packed(pack, qp, aqp, rp, thp, m,
                                     query_tile=query_tile,
                                     memory_budget_mb=memory_budget_mb,
                                     pq=pqp, mixed=mixed,
                                     compacted=compacted, oracle=oracle)


def query_counts(index, q, radius, *, block: int = 512,
                 query_tile: int = 128, memory_budget_mb=None,
                 mixed: bool = False, bucket: bool = True,
                 compacted: bool | None = None, oracle: bool = False,
                 device=None) -> np.ndarray:
    """Exact neighbour counts per query: pass 1 only, no CSR.

    The same predicate pipeline as `snn.query_radius_csr`, so the counts
    equal ``np.diff(csr.indptr)`` of the full query exactly.  ``index`` is
    an `snn.SNNIndex` or a `streaming.StreamingSNNIndex` (base + deltas
    through its plan); ``radius`` is a scalar or per-query (m,) vector in
    the native metric.  ``oracle=True`` takes the engine's host lane (`engine.run_csr_packed`;
    CPU plans only, it raises on the card's), where ``compacted`` and
    ``memory_budget_mb`` select and bound its executors; off the lane both
    are ignored.
    """
    owner, pack = _resolve_pack(index, block, device)
    xq, aq, r32, th, qsq = _snn.prepare_query_predicates(owner, q, radius)
    qp, aqp, rp, thp, m = _ops.pad_queries(xq, aq, r32, th, tq=query_tile,
                                           bucket=bucket)
    pq = _snn.query_extra_projections(owner, xq)
    pqp = None if pq is None else _ops.pad_components(pq, qp.shape[0])
    return _engine.run_counts_packed(pack, qp, aqp, rp, thp, m,
                                     query_tile=query_tile,
                                     memory_budget_mb=memory_budget_mb,
                                     pq=pqp, mixed=mixed,
                                     compacted=compacted, oracle=oracle)


# --------------------------------------------------------------------------- #
# The public bichromatic join                                                  #
# --------------------------------------------------------------------------- #
def join(
    a: np.ndarray,
    b: np.ndarray | None,
    radius,
    *,
    metric: str = "euclidean",
    b_index: _snn.SNNIndex | None = None,
    return_distance: bool = True,
    query_chunk: int | None = 2048,
    memory_budget_mb: float | None = None,
    segment_rows: int | None = None,
    block: int = 512,
    query_tile: int = 128,
    native: bool = True,
    n_iter: int = 64,
    packed: bool = True,
    mixed: bool = False,
    compacted: bool | None = None,
    oracle: bool = False,
    device=None,
) -> _snn.CSRNeighbors:
    """Exact bichromatic eps-join: row i lists every b within radius of a[i].

    B is indexed once and cut into ``segment_rows``-row segments (default
    ``block``) on ``device`` (default: the card; raises without one unless
    ``"cpu"``); A's rows stream through the sorted-chunk schedule in
    ascending order of their alpha score.  Row contents and distances are
    bit-identical per row to ``query_radius_csr(b_index, a, radius)``: the
    schedule reorders work, it never changes it.

    ``radius`` is a scalar or a per-A-row (ma,) vector in the native metric
    (the inner-product threshold for mips, where a is the query side);
    ``b_index`` is a prebuilt `snn.SNNIndex` over exactly ``b``;
    ``memory_budget_mb``, when given, sizes the query chunks in place of
    ``query_chunk`` (`resolve_chunk`) and bounds the host lane's filters
    (``oracle=True``, with ``compacted``: `chunked_join`); the other knobs
    are `build_neighbor_graph`'s.  Column ids are original B row ids,
    ascending in B's sorted order within each row.
    """
    dev = _registry.resolve_device(device)
    a = _as_rows(a)
    index = b_index
    if index is None:
        if b is None:
            raise ValueError("join needs b points or a prebuilt b_index")
        index = _snn.build_index(np.asarray(b), metric=metric, n_iter=n_iter,
                                 device=dev)
    m = a.shape[0]
    radius, rvec = _checked_radius(radius, m)
    if index.n == 0 or m == 0:
        return _empty_csr(m, return_distance)
    # sort A by its alpha score so chunks are alpha-adjacent; any order is
    # exact, sorted order is merely fast
    qord = np.argsort(_metricsafe_scores(index, a), kind="stable")
    r_sorted = radius if rvec is None else rvec[qord]
    sr = max(int(segment_rows), 1) if segment_rows is not None else block
    cs = resolve_chunk(index.n, query_chunk, memory_budget_mb, None, block)
    segments = _engine.segments_from_index(index, rows_per_segment=sr,
                                           block=block, device=dev)
    return sorted_join_csr(
        index, segments, a[qord], r_sorted, symmetric=False, query_chunk=cs,
        segs_per_chunk=0, query_tile=query_tile,
        return_distance=return_distance, native=native, dest=qord,
        packed=packed, memory_budget_mb=memory_budget_mb, mixed=mixed,
        compacted=compacted, oracle=oracle)


def _metricsafe_scores(index, a: np.ndarray) -> np.ndarray:
    """A-side alpha scores for the schedule sort, computed as
    `snn.prepare_query_predicates` computes ``aq`` (transform, centre,
    project on v1); each row's score depends only on that row."""
    tq = _metrics.transform_query(a, index.metric)
    xq = (tq - index.mu[None, :]).astype(np.float32)
    return (xq @ index.v1).astype(np.float32)


def join_counts(
    a: np.ndarray,
    b: np.ndarray | None,
    radius,
    *,
    metric: str = "euclidean",
    b_index: _snn.SNNIndex | None = None,
    query_chunk: int | None = 2048,
    memory_budget_mb: float | None = None,
    segment_rows: int | None = None,
    block: int = 512,
    query_tile: int = 128,
    n_iter: int = 64,
    mixed: bool = False,
    compacted: bool | None = None,
    oracle: bool = False,
    device=None,
) -> np.ndarray:
    """Count-only bichromatic join: ``|ball(a[i], r_i) ∩ B|`` per A row.

    The pass-1 twin of `join`: the same sorted-chunk schedule over one
    `engine.SegmentPack` of B's ``segment_rows``-row segments on ``device``
    (default: the card), but every chunk runs `engine.run_counts_packed`
    and nothing is compacted.  Counts equal ``np.diff(join(...).indptr)``
    exactly (identical predicates).  ``memory_budget_mb`` sizes the chunks
    as in `join`; ``oracle``/``compacted`` as in `join`.
    """
    dev = _registry.resolve_device(device)
    a = _as_rows(a)
    index = b_index
    if index is None:
        if b is None:
            raise ValueError("join_counts needs b points or a b_index")
        index = _snn.build_index(np.asarray(b), metric=metric, n_iter=n_iter,
                                 device=dev)
    m = a.shape[0]
    radius, rvec = _checked_radius(radius, m)
    if index.n == 0 or m == 0:
        return np.zeros(m, np.int64)
    qord = np.argsort(_metricsafe_scores(index, a), kind="stable")
    r_sorted = radius if rvec is None else rvec[qord]
    sr = max(int(segment_rows), 1) if segment_rows is not None else block
    cs = resolve_chunk(index.n, query_chunk, memory_budget_mb, None, block)
    pack = _engine.SegmentPack.build(_engine.segments_from_index(
        index, rows_per_segment=sr, block=block, device=dev))
    xq, aq, r32, th, _ = _snn.prepare_query_predicates(index, a[qord],
                                                       r_sorted)
    pq_full = _snn.query_extra_projections(index, xq)
    counts_sorted = np.zeros(m, np.int64)
    for c0 in range(0, m, cs):
        c1 = min(c0 + cs, m)
        qp, aqp, rp, thp, _ = _ops.pad_queries(
            xq[c0:c1], aq[c0:c1], r32[c0:c1], th[c0:c1], tq=query_tile)
        pqp = (None if pq_full is None
               else _ops.pad_components(pq_full[:, c0:c1], qp.shape[0]))
        counts_sorted[c0:c1] = _engine.run_counts_packed(
            pack, qp, aqp, rp, thp, c1 - c0, query_tile=query_tile,
            memory_budget_mb=memory_budget_mb, pq=pqp, mixed=mixed,
            compacted=compacted, oracle=oracle)
    out = np.empty(m, np.int64)
    out[qord] = counts_sorted
    return out


def degree_histogram(
    x: np.ndarray,
    eps,
    *,
    metric: str = "euclidean",
    index: _snn.SNNIndex | None = None,
    query_chunk: int | None = 2048,
    memory_budget_mb: float | None = None,
    block: int = 512,
    query_tile: int = 128,
    n_iter: int = 64,
    mixed: bool = False,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Degree distribution of the eps-graph WITHOUT building the graph.

    ``degrees[i] = |ball(x[i], eps)|`` (self included, as in the graph) by
    the count-only self-join (`join_counts`): no CSR, no compact pass, O(n)
    memory however dense the graph is (``memory_budget_mb`` sizes its
    chunks).  Returns ``(hist, degrees)`` where
    ``hist[k]`` is the number of points with exactly k neighbours.
    """
    x = _as_rows(x)
    if index is None:
        index = _snn.build_index(x, metric=metric, n_iter=n_iter,
                                 device=_registry.resolve_device(device))
    degrees = join_counts(x, None, eps, b_index=index,
                          query_chunk=query_chunk,
                          memory_budget_mb=memory_budget_mb, block=block,
                          query_tile=query_tile, mixed=mixed, device=device)
    hist = np.bincount(degrees) if degrees.size else np.zeros(0, np.int64)
    return hist, degrees


# --------------------------------------------------------------------------- #
# Reverse neighbours                                                           #
# --------------------------------------------------------------------------- #
def reverse_neighbors(
    points: np.ndarray,
    targets: np.ndarray,
    radii,
    *,
    metric: str = "euclidean",
    target_index: _snn.SNNIndex | None = None,
    return_distance: bool = False,
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
    """Exact reverse eps-neighbours: which points hold each target in range.

    Row j of the result lists every i with ``d(points[i], targets[j]) <=
    radii[i]``: each point owns its radius, and the question is asked from
    the target's side.  This is the transposed bichromatic join
    ``join(points, targets, radii)`` on ``device`` (default: the card),
    exact because the forward join is exact and the transpose lossless.

    ``points`` are raw metric-space rows (for mips the point is the query
    side of ``p.q >= S``); ``radii`` is a scalar or per-point
    (n_points,) vector in the native metric.  Column ids in each row are
    point row ids, ascending; distances (iff ``return_distance``) are the
    forward pair's.
    """
    points = _as_rows(points)
    targets = _as_rows(targets)
    fwd = join(points, targets, radii, metric=metric, b_index=target_index,
               return_distance=return_distance, query_chunk=query_chunk,
               memory_budget_mb=memory_budget_mb, segment_rows=segment_rows,
               block=block, query_tile=query_tile, native=native, n_iter=n_iter, packed=packed, mixed=mixed,
               device=device)
    n_targets = targets.shape[0] if target_index is None else target_index.n
    indptr, rows, dists = transpose_csr(fwd.indptr, fwd.indices,
                                        fwd.distances, n_targets)
    return _snn.CSRNeighbors(indptr, rows, dists)
