"""Exact k-nearest-neighbour search on the sorted-projection index.

The counterpart of ``repro.core.knn``.  The engine's predicate takes a
radius per query, so exact kNN is a front-end: find, for every query, a
radius whose ball provably holds >= k points, then take the k nearest
inside that ball.  If ``count(q, r) >= k`` the k-th smallest distance in the
ball is <= r and every point outside it is farther than r, so the k nearest
in the ball are the k nearest overall, however the radii were found.

* **seed**: by Cauchy-Schwarz ``|alpha_p - alpha_q| <= ||p - q||``, so the
  k-th smallest projection gap (two binary searches a query over the sorted
  alphas, on the host) bounds the k-th neighbour distance from below; it is
  combined with a strided-sample estimate, which stays close in high
  dimensions where the gap bound collapses;
* **expand**: one engine count pass (`join.count_pass`, the stacked count
  kernel on the card) checks all queries at once; only the under-filled
  queries' radii double, and only they enter the next pass.  Counts are
  monotone in r and the radii are capped by a diameter bound, so the loop
  ends; the seed is usually tight enough for 0-2 doublings.

One final count -> compact execution (`engine.run_csr_packed`) lists every
converged ball, the survivors' distances are computed again in float64 from
their rows (gathered on the device, only those rows copied to the host),
and a per-row select on the host keeps the k nearest, ties by id.  The final
radii carry a small relative margin, so a float32 rounding at the ball's
edge cannot drop a true neighbour.

Works over an `snn.SNNIndex` (its cached plan on ``device``) or a
`streaming.StreamingSNNIndex` (base + deltas through its snapshot's plan,
on its own device).  For mips "k nearest" means the k largest inner
products; for cosine and angular the transforms are monotone, so kNN in
index space is kNN in the metric.

`KNN_STATS` counts, per thread, the expansion rounds, the final pass's
candidates and the host seconds of each stage since its last reset.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..kernels import ops as _ops
from ..kernels import registry as _registry
from . import engine as _engine
from . import metrics as _metrics
from . import snn as _snn
from .join import count_pass as _count_pass
from .join import resolve_chunk as _resolve_chunk

# final-pass radius inflation: absorbs float32 predicate rounding at the
# ball boundary (counts are monotone in r, so the margin only ever adds
# candidates, never drops one)
_RADIUS_MARGIN = 1e-3


_STAGES = ("seed", "expand", "final", "refine")


class KnnStats(threading.local):
    """Per-thread counters of `query_knn`: ``searches``, the calls that ran
    the search; ``rounds`` of the expansion loop (each one count pass over
    the still-active queries); ``candidates``, the pairs the final pass
    listed; and ``seconds``, host-clock seconds by stage: the seed radii,
    the expansion loop, the final count and compact (each stage ends in a
    copy to the host, so the card's work is inside it) and the float64
    refine with the per-row select."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.searches = 0
        self.rounds = 0
        self.candidates = 0
        self.seconds = dict.fromkeys(_STAGES, 0.0)

    def snapshot(self) -> dict:
        return {"searches": self.searches, "rounds": self.rounds,
                "candidates": self.candidates, "seconds": dict(self.seconds)}


KNN_STATS = KnnStats()


def _resolve(index, block: int, device=None):
    """(owner, parts, pack) for an `SNNIndex` or a streaming index.

    ``owner`` holds the mu/v1/metric/xi every predicate derives from (the
    streaming base freezes them, so its first part is the owner); ``parts``
    are the alpha-sorted runs the seed reads; ``pack`` is the plan.
    """
    if hasattr(index, "plan") and hasattr(index, "parts"):  # streaming
        parts, _, pack = index._snapshot()
        return parts[0], list(parts), pack
    return index, [index], index.pack(block, _registry.resolve_device(device))


def _seed_radii(parts, aq: np.ndarray, k_eff: np.ndarray) -> np.ndarray:
    """Per-query k-th smallest projection gap over the union of sorted runs.

    For each part, the k nearest alphas to ``aq[i]`` lie inside the window
    of 2*K sorted positions around ``searchsorted(alphas, aq[i])``, so the
    k-th smallest gap of the union is found inside the concatenation of
    those windows.  Out-of-range window slots read +inf.  The alphas come
    to the host once (`SNNIndex.host_alphas`).
    """
    m = aq.shape[0]
    K = int(k_eff.max()) if m else 0
    if K == 0:
        return np.zeros(m, np.float64)
    aq64 = np.asarray(aq, np.float64)
    offs = np.arange(-K, K)
    gap_cols = []
    for p in parts:
        if p.n == 0:
            continue
        al = np.asarray(p.host_alphas(), np.float64)
        pos = np.searchsorted(al, aq64)
        idx = pos[:, None] + offs[None, :]
        ok = (idx >= 0) & (idx < p.n)
        gaps = np.where(ok, np.abs(al[np.clip(idx, 0, p.n - 1)]
                                   - aq64[:, None]), np.inf)
        gap_cols.append(gaps)
    if not gap_cols:
        return np.zeros(m, np.float64)
    allg = np.sort(np.concatenate(gap_cols, axis=1), axis=1)
    return allg[np.arange(m), k_eff - 1]


def _sample_estimate(parts, xq: np.ndarray, k_eff: np.ndarray,
                     n_total: int, sample: int = 256) -> np.ndarray:
    """Data-driven starting radii from a strided database sample.

    The distance from each query to the ``ceil(k * S / n)``-th nearest of S
    evenly strided sorted rows estimates the k-th neighbour distance with a
    bias near 1 in any dimension.  Purely advisory: over- or undershooting
    costs work, never exactness.  Each part's strided rows come to the
    host by one device slice.
    """
    m = xq.shape[0]
    rows = []
    for p in parts:
        if p.n:
            stride = max(p.n * len(parts) // sample, 1)
            rows.append(p.xs[::stride].cpu().numpy())
    if not rows:
        return np.zeros(m, np.float64)
    s = np.concatenate(rows).astype(np.float64)
    xq64 = xq.astype(np.float64)
    sq = (np.einsum("ij,ij->i", xq64, xq64)[:, None]
          + np.einsum("ij,ij->i", s, s)[None, :] - 2.0 * (xq64 @ s.T))
    sq = np.sort(np.maximum(sq, 0.0), axis=1)
    k_s = np.clip((k_eff * sq.shape[1] + n_total - 1) // max(n_total, 1),
                  1, sq.shape[1])
    return np.sqrt(sq[np.arange(m), k_s - 1])


def _fetch_rows(parts, ids: np.ndarray) -> np.ndarray:
    """Candidate rows (len(ids), d) float32 in index space, by original id.

    Every part's ``order`` maps its sorted rows to original ids; the union
    is inverted once on the host (O(n) ids), the rows are gathered with
    ``index_select`` on the parts' device, and only they are copied.
    """
    n_total = sum(p.n for p in parts)
    part_of = np.empty(n_total, np.int32)
    local = np.empty(n_total, np.int64)
    for j, p in enumerate(parts):
        part_of[p.order] = j
        local[p.order] = np.arange(p.n)
    d = parts[0].d
    out = np.empty((ids.shape[0], d), np.float32)
    for j, p in enumerate(parts):
        sel = part_of[ids] == j
        if sel.any():
            rows = torch.from_numpy(local[ids[sel]]).to(p.device)
            out[sel] = p.xs.index_select(0, rows).cpu().numpy()
    return out


def query_knn(
    index,
    q: np.ndarray,
    k,
    return_distance: bool = True,
    *,
    native: bool = True,
    block: int = 512,
    query_tile: int = 128,
    memory_budget_mb: float | None = None,
    max_rounds: int = 100,
    mixed: bool = False,
    bucket: bool = True,
    device=None,
):
    """Exact k nearest neighbours of each query (indices and distances).

    Args:
      index: `snn.SNNIndex` or `streaming.StreamingSNNIndex`.
      q: (m, d) or (d,) queries in the raw metric space.
      k: neighbours a query: a scalar or a per-query (m,) int vector.
      return_distance: also return the (m, K) distances.
      native: distances in the index's metric (for mips the inner products,
        columns descending); False leaves squared Euclidean in index space.
      block / query_tile / mixed / bucket: engine knobs, as in
        `snn.query_radius_csr` (``bucket`` pads the shrinking expansion
        batches onto the geometric ladder).
      memory_budget_mb: caps the queries one search holds at
        `join.resolve_chunk`'s ``budget // (4 * n_pad)`` rows; more queries
        run as consecutive searches of that many, with the same rows.  (The
        reference spends it in its CPU oracle executors, which the port
        does not have.)
      device: where an `SNNIndex`'s plan runs (default: the card; raises
        without one unless ``"cpu"``); a streaming index runs on its own.

    Returns:
      ``indices`` (m, K) int64 with K = max(k): column j is the (j+1)-th
      nearest neighbour's original row id, distances ascending, ties by id.
      Past the database size (k > n) the columns hold id -1 and distance
      +inf.  With ``return_distance`` the result is ``(indices, distances)``.
    """
    owner, parts, pack = _resolve(index, block, device)
    tq_ = _metrics.transform_query(np.asarray(q), owner.metric)
    xq = (tq_ - owner.mu[None, :]).astype(np.float32)
    m = xq.shape[0]
    n_total = sum(p.n for p in parts)

    k_arr = np.asarray(k, np.int64)
    k_arr = np.full(m, int(k_arr), np.int64) if k_arr.ndim == 0 else k_arr
    if k_arr.shape != (m,):
        raise ValueError(f"k must be a scalar or per-query ({m},) vector; "
                         f"got shape {k_arr.shape}")
    if (k_arr < 0).any():
        raise ValueError("k must be >= 0")
    K_out = int(k_arr.max()) if m else 0
    out_idx = np.full((m, K_out), -1, np.int64)
    out_sq = np.full((m, K_out), np.inf, np.float64)
    k_eff = np.minimum(k_arr, n_total)

    chunk = (m if memory_budget_mb is None else
             _resolve_chunk(n_total, None, memory_budget_mb, None, block))
    if m > chunk:
        # a query's row does not depend on the other queries of its search
        qs = np.asarray(q)
        for s in range(0, m, chunk):
            idx, sq = query_knn(index, qs[s:s + chunk], k_arr[s:s + chunk],
                                native=False, block=block,
                                query_tile=query_tile, max_rounds=max_rounds,
                                mixed=mixed, bucket=bucket, device=device)
            out_idx[s:s + chunk, :idx.shape[1]] = idx
            out_sq[s:s + chunk, :idx.shape[1]] = sq
    elif m and n_total and k_eff.max() > 0:
        KNN_STATS.searches += 1
        t0 = time.perf_counter()
        # the predicate inputs the engine sees (float32, computed once) and
        # their float64 twins for the seed and cap arithmetic
        aq = (xq @ owner.v1).astype(np.float32)
        pq = _snn.query_extra_projections(owner, xq)
        qsq32 = np.einsum("ij,ij->i", xq, xq)
        aq64 = (xq.astype(np.float64) @ owner.v1.astype(np.float64))
        qsq64 = np.einsum("ij,ij->i", xq.astype(np.float64), xq)
        # diameter bound in centred index space: every distance is at most
        # max ||x|| + ||q||; inflated so float32 rounding at the cap still
        # admits all n points (the loop's termination guarantee)
        max_half = max((float(torch.max(p.half_norms)) if p.n else 0.0)
                       for p in parts)
        ub = (np.sqrt(2.0 * max(max_half, 0.0)) + np.sqrt(qsq64)) * 1.01 \
            + 1e-6

        r = np.minimum(
            np.maximum(_seed_radii(parts, aq64, np.maximum(k_eff, 1)),
                       _sample_estimate(parts, xq, np.maximum(k_eff, 1),
                                        n_total)),
            ub)
        t1 = time.perf_counter()
        active = np.nonzero(k_eff > 0)[0]
        for _ in range(max_rounds):
            KNN_STATS.rounds += 1
            counts = _count_pass(pack, xq[active], aq[active], qsq32[active],
                                 r[active], query_tile=query_tile,
                                 pq=None if pq is None else pq[:, active],
                                 mixed=mixed, bucket=bucket)
            short = counts < k_eff[active]
            if not short.any():
                break
            grow = active[short]
            already_capped = r[grow] >= ub[grow]
            r[grow] = np.minimum(
                np.where(r[grow] > 0, 2.0 * r[grow], 1e-3 * ub[grow]),
                ub[grow])
            if already_capped.all():
                break  # cannot hold: nothing left to expand
            active = grow

        t2 = time.perf_counter()
        # final count -> compact on the converged radii (+margin); the
        # engine recounts with the same predicate pipeline, so every row is
        # complete: the loop above was advisory, not load-bearing
        r_fin = np.where(k_eff > 0, r * (1.0 + _RADIUS_MARGIN), 0.0)
        # k == 0 rows must match nothing at all (not even themselves)
        r_fin[k_eff == 0] = -1.0
        thresh = ((r_fin * r_fin - qsq32) / 2.0).astype(np.float32)
        thresh[k_eff == 0] = np.float32(-_ops.BIG)
        qp, aqp, rp, thp, _ = _ops.pad_queries(
            xq, aq, r_fin.astype(np.float32), thresh, tq=query_tile,
            bucket=bucket)
        pqp = None if pq is None else _ops.pad_components(pq, qp.shape[0])
        indptr, _, flat_ids, _ = _engine.run_csr_packed(
            pack, qp, aqp, rp, thp, m, query_tile=query_tile, pq=pqp,
            mixed=mixed)
        t3 = time.perf_counter()
        KNN_STATS.candidates += int(flat_ids.size)

        # float64 distances of the survivors from their rows: the half-norm
        # form loses low bits to cancellation exactly where the kNN order
        # needs them.  Row by row, the float32 rows widening inside the
        # subtraction: no float64 copy of every candidate is held at once
        vecs = _fetch_rows(parts, flat_ids)
        xq64 = xq.astype(np.float64)
        for i in range(m):
            s, e = int(indptr[i]), int(indptr[i + 1])
            kk = min(int(k_eff[i]), e - s)
            if kk == 0:
                continue
            diff = vecs[s:e] - xq64[i]
            sq = np.einsum("ij,ij->i", diff, diff)
            order = np.lexsort((flat_ids[s:e], sq))[:kk]
            out_idx[i, :kk] = flat_ids[s:e][order]
            out_sq[i, :kk] = sq[order]
        for stage, dt in zip(_STAGES, (t1 - t0, t2 - t1, t3 - t2,
                                       time.perf_counter() - t3)):
            KNN_STATS.seconds[stage] += dt

    if not return_distance:
        return out_idx
    if not native:
        return out_idx, out_sq
    return out_idx, _metrics.native_knn_distances(out_idx, out_sq,
                                                  owner.metric, owner.xi, tq_)
