"""Streaming (LSM-style) SNN index: sublinear appends, exact queries.

The counterpart of ``repro.core.streaming``:

* the **base** is an `snn.SNNIndex` on the index's device;
* an `append` projects the new points onto the base's *frozen* ``mu``/``v1``
  and sorts only the batch, producing a small **delta** (an `SNNIndex`
  sharing mu/v1/metric/xi, its ``order`` holding global row ids).  The
  delta is computed on the host in numpy, exactly as the reference computes
  it, and only then moved to the device, so both packages make the same
  deltas bit for bit;
* queries run the one predicate pipeline across base + deltas through
  `core.engine`, so results are exact: as neighbour sets, equal to a fresh
  index over the concatenated data;
* a size-ratio trigger merges the deltas into the base with a stable
  two-pointer merge of already sorted runs (`merge_sorted_indexes`, on the
  device: two `torch.searchsorted` calls and one scatter, no re-sort, no
  power iteration);
* only when the database outgrows ``rebuild_ratio`` times its size at the
  last full build does a real `build_index` run (fresh mu/v1/xi).

Frozen mu/v1 stay exact because the Cauchy-Schwarz window holds for any
fixed direction with ``||v1|| <= 1`` and any fixed centring.  The mips
lift's xi is the one global statistic: an append past it forces a full
re-index.

Writers (append/rebuild) serialize on a mutation lock and do their heavy
work outside the short state lock, publishing an immutable ``(parts,
segments, plan)`` snapshot in one locked swap, after their device work has
finished; queries read one snapshot.
The ``plan`` is the engine's `SegmentPack`: built lazily on first query,
extended by one stacked slab an append (`SegmentPack.extend`, the next
epoch), and replaced by merges and rebuilds.  With `set_plan_warming` the
mutator also primes the next epoch (`engine.warm_plan`) before it
publishes it; ``warm_runs`` and ``warm_failures`` count those primes.
"""
from __future__ import annotations

import threading
import traceback

import numpy as np
import torch

from ..kernels import registry as _registry
from . import engine as _engine
from . import metrics as _metrics
from . import snn as _snn
# module-path imports: the package-level `join` export is the function
from .join import query_counts as _join_query_counts
from .join import single_query as _join_single_query


def _as_batch(a: np.ndarray, d: int | None = None) -> np.ndarray:
    """Normalize seed/append input to (b, d) rows.

    A 1-D ``(k,)`` array is one point; a 1-D *empty* array is zero points,
    of width ``d`` when a width is already known, else width 0, which marks
    "no width committed yet".
    """
    if a.ndim == 1:
        a = a.reshape(1, -1) if a.size else a.reshape(0, d or 0)
    if a.ndim != 2:
        raise ValueError(f"expected (b, d) or (d,) points, got shape {a.shape}")
    return a


def merge_sorted_indexes(a: _snn.SNNIndex, b: _snn.SNNIndex) -> _snn.SNNIndex:
    """Stable merge of two alpha-sorted runs sharing mu/v1/metric/xi.

    An O(n) scatter on the runs' device after two binary searches; ``a``'s
    rows precede equal-alpha rows of ``b`` (append order, as a stable
    re-sort would put them): a row of ``a`` lands after the rows of ``b``
    strictly below it, a row of ``b`` after the rows of ``a`` at or below
    it (`torch.searchsorted` with ``right=False`` and ``right=True``, which
    are numpy's ``side="left"`` and ``side="right"``, ties included).
    """
    na, nb = a.n, b.n
    dev = a.device
    pos_a = (torch.arange(na, device=dev)
             + torch.searchsorted(b.alphas, a.alphas, right=False))
    pos_b = (torch.arange(nb, device=dev)
             + torch.searchsorted(a.alphas, b.alphas, right=True))
    n = na + nb
    xs = torch.empty((n, a.d), dtype=a.xs.dtype, device=dev)
    al = torch.empty(n, dtype=a.alphas.dtype, device=dev)
    hn = torch.empty(n, dtype=a.half_norms.dtype, device=dev)
    od = np.empty(n, np.int64)
    for pos, src in ((pos_a, a), (pos_b, b)):
        xs[pos] = src.xs
        al[pos] = src.alphas
        hn[pos] = src.half_norms
        od[pos.cpu().numpy()] = src.order
    # the projections on the shared frozen basis merge the same way; a
    # differing component count keeps the common prefix (the box bound
    # holds for any prefix of the basis)
    kx = min(a.vs.shape[0], b.vs.shape[0])
    pj = torch.empty((kx, n), dtype=torch.float32, device=dev)
    pj[:, pos_a] = a.projs[:kx]
    pj[:, pos_b] = b.projs[:kx]
    return _snn.SNNIndex(a.mu, a.v1, xs, al, hn, od, a.metric, a.xi,
                         vs=np.asarray(a.vs)[:kx], projs=pj)


class StreamingSNNIndex:
    """An SNN index that absorbs appends as LSM-style delta segments.

    Exposes the module-level query surface (`query_radius_csr`,
    `query_counts_device`, `query_knn`, `query_radius_batch`,
    `query_counts`, `query_radius_fixed`) over base + deltas, exact at
    every point of the append/merge/rebuild lifecycle.  Everything lives on
    ``device`` (default: the card; raises without one unless ``"cpu"``).
    """

    def __init__(
        self,
        data: np.ndarray,
        metric: str = "euclidean",
        n_iter: int = 64,
        block: int = 512,
        delta_ratio: float = 0.25,
        max_deltas: int = 4,
        rebuild_ratio: float = 4.0,
        *,
        device=None,
    ):
        self.metric = metric
        self.n_iter = n_iter
        self.block = block
        self.delta_ratio = float(delta_ratio)
        self.max_deltas = int(max_deltas)
        self.rebuild_ratio = float(rebuild_ratio)
        self.device = _registry.resolve_device(device)
        self._init_runtime()
        # raw rows as a list of chunks: append is O(1) in index size (the
        # O(n) concatenation waits for the rare `raw` materialization);
        # np.array copies: the seed must not alias a caller-mutable buffer
        self._raw_parts = [_as_batch(np.array(data, dtype=np.float32))]
        base = _snn.build_index(self._raw_parts[0], metric=metric,
                                n_iter=n_iter, device=self.device)
        self._n_at_build = base.n
        # generation counts snapshot publishes
        self._generation = 0
        # published snapshot: (parts, segments, plan); parts[0] is the base,
        # segments[i] the lazily built engine Segment of parts[i], plan the
        # lazily built `engine.SegmentPack` over all of them
        self._state = ((base,), (None,), None)

    def _init_runtime(self) -> None:
        """Locks and plan-warming settings (not part of the saved state)."""
        # double-buffered plan epochs are off until `set_plan_warming`
        self._warm = False
        self._warm_kwargs: dict = {}
        self._warm_buckets = (128,)
        self._warmer = None
        self.warm_runs = 0
        self.warm_failures = 0
        # _mutate serializes writers for their whole run; _lock guards only
        # the published state and is never held across work
        self._mutate = threading.Lock()
        self._lock = threading.Lock()

    # ------------------------------------------------------------ metadata
    @property
    def base(self) -> _snn.SNNIndex:
        return self._state[0][0]

    @property
    def parts(self) -> tuple[_snn.SNNIndex, ...]:
        """Current (base, *deltas) snapshot, read-only."""
        return self._state[0]

    @property
    def n(self) -> int:
        return sum(p.n for p in self._state[0])

    @property
    def d(self) -> int:
        return self._raw_parts[0].shape[1]

    @property
    def raw(self) -> np.ndarray:
        """All points in original (append) order (materialized lazily)."""
        with self._lock:
            if len(self._raw_parts) > 1:
                self._raw_parts = [np.concatenate(self._raw_parts)]
            return self._raw_parts[0]

    @property
    def generation(self) -> int:
        """Snapshot publish counter: bumps on every append, merge and
        rebuild."""
        return self._generation

    # ------------------------------------------------- double-buffered plans
    def set_plan_warming(self, enabled: bool = True, *,
                         m_pads=(128,), warmer=None, **warm_kwargs) -> None:
        """Turn on double-buffered plan epochs for this index's mutators.

        With warming on, `append`/`rebuild` build the next generation's
        segments and `SegmentPack` AND run `engine.warm_plan`'s zero-match
        dispatch for each bucketed batch size in ``m_pads`` (an iterable, or
        a callable returning one) on the mutator's thread, then publish the
        warm snapshot.  ``warm_kwargs`` go to `engine.warm_plan`;
        ``warmer(plan, spec_from)`` replaces it entirely.
        """
        self._warm = bool(enabled)
        self._warm_buckets = m_pads
        self._warmer = warmer
        self._warm_kwargs = dict(warm_kwargs)

    def _prime(self, plan: _engine.SegmentPack,
               spec_from: _engine.SegmentPack | None = None) -> None:
        """Warm ``plan`` before it is published (mutator thread).

        A failure is printed and counted in ``warm_failures``, never raised:
        a plan that was not warmed still answers every query correctly,
        only colder, so it must not block the publish.
        """
        self.warm_runs += 1
        try:
            if self._warmer is not None:
                self._warmer(plan, spec_from)
            else:
                buckets = (self._warm_buckets()
                           if callable(self._warm_buckets)
                           else self._warm_buckets)
                _engine.warm_plan(plan, m_pads=tuple(buckets) or (128,),
                                  spec_from=spec_from, **self._warm_kwargs)
        except Exception:
            self.warm_failures += 1
            traceback.print_exc()

    def _settle(self) -> None:
        """Wait for this thread's device work before a publish: a query on
        another thread (or stream) must never read a plan or part whose
        tensors are still being written."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _segment(self, part: _snn.SNNIndex) -> _engine.Segment:
        return _engine.segment_from_index(part, block=self.block)

    def _next_plan(self, parts: tuple):
        """(segments, plan) for a snapshot about to publish: lazy (all None)
        unless warming is on; a warmed plan adopts the outgoing plan's fused
        capacities (`SegmentPack.adopt_spec`)."""
        if not self._warm:
            return tuple(None for _ in parts), None
        prev_plan = self._state[2]
        segs = tuple(self._segment(p) for p in parts)
        plan = _engine.SegmentPack.build(list(segs),
                                         epoch=self._generation + 1)
        self._prime(plan, spec_from=prev_plan)
        return segs, plan

    def plan_bytes(self) -> int:
        """`MemoryPlan`-accounted bytes of the published plan (0 if none)."""
        with self._lock:
            plan = self._state[2]
        return 0 if plan is None else plan.planned_bytes()

    def drop_plan(self) -> None:
        """Release the cached plan and segments; the parts, and so every
        answer, stay.  Does not bump `generation`."""
        with self._lock:
            parts = self._state[0]
            self._state = (parts, tuple(None for _ in parts), None)

    # ------------------------------------------------------------ snapshot
    # leaves-per-part layout for state_leaves/from_state:
    _PART_LEAVES = 8  # mu, v1, xs, alphas, half_norms, order, vs, projs

    def state_leaves(self) -> tuple[list[np.ndarray], dict]:
        """Flat numpy leaves + JSON-scalar extras capturing the EXACT state.

        ``leaves[0]`` is raw (append order); each part then contributes
        `_PART_LEAVES` arrays in field order.  ``extra`` holds every scalar
        `from_state` needs.  The layout is the JAX package's, so the leaves
        of either package restore in the other.
        """
        with self._mutate:
            raw = self.raw
            with self._lock:
                parts = self._state[0]
            leaves: list[np.ndarray] = [raw]
            xi = []
            for p in parts:
                leaves += [np.asarray(p.mu), np.asarray(p.v1),
                           p.xs.cpu().numpy(), p.alphas.cpu().numpy(),
                           p.half_norms.cpu().numpy(), np.asarray(p.order),
                           np.asarray(p.vs), p.projs.cpu().numpy()]
                xi.append(float(p.xi))
            extra = {
                "metric": self.metric, "n_iter": self.n_iter,
                "block": self.block, "delta_ratio": self.delta_ratio,
                "max_deltas": self.max_deltas,
                "rebuild_ratio": self.rebuild_ratio,
                "n_at_build": int(self._n_at_build),
                "generation": int(self._generation),
                "n_parts": len(parts), "xi": xi,
            }
            return leaves, extra

    @classmethod
    def from_state(cls, leaves, extra: dict, device=None) -> "StreamingSNNIndex":
        """Rebuild the exact snapshot a `state_leaves` call captured, on
        ``device`` (default: the card).  No power iteration, no sorting:
        the parts are the saved arrays, so every query answers as the
        original did at the same generation."""
        self = cls.__new__(cls)
        self.metric = extra["metric"]
        self.n_iter = int(extra["n_iter"])
        self.block = int(extra["block"])
        self.delta_ratio = float(extra["delta_ratio"])
        self.max_deltas = int(extra["max_deltas"])
        self.rebuild_ratio = float(extra["rebuild_ratio"])
        self.device = _registry.resolve_device(device)
        self._init_runtime()
        self._raw_parts = [np.asarray(leaves[0], dtype=np.float32)]
        k = cls._PART_LEAVES
        parts = []
        for i in range(int(extra["n_parts"])):
            mu, v1, xs, al, hn, od, vs, pj = leaves[1 + i * k:1 + (i + 1) * k]
            parts.append(_snn.index_from_arrays(
                mu, v1, xs, al, hn, od, extra["metric"], extra["xi"][i], vs,
                pj, device=self.device))
        self._n_at_build = int(extra["n_at_build"])
        self._generation = int(extra["generation"])
        self._state = (tuple(parts), tuple(None for _ in parts), None)
        return self

    # ------------------------------------------------------------- updates
    def append(self, points: np.ndarray) -> None:
        """Absorb a batch: O(b log b + segments) between compactions.

        No power iteration and no full re-sort happen here; at most a
        linear delta merge (size-ratio trigger) or, past ``rebuild_ratio``
        growth or a mips-lift overflow, one full re-index.  All of it runs
        outside the state lock: queries keep answering against the previous
        snapshot until the publish.
        """
        # np.array copies: the delta must not alias a caller-mutable buffer
        pts = _as_batch(np.array(points, dtype=np.float32), self.d)
        with self._mutate:
            width_free = self.n == 0 and self.d == 0  # width-unknown seed
            if pts.shape[1] != self.d and not width_free:
                raise ValueError(f"append expects (b, {self.d}) points, "
                                 f"got {pts.shape}")
            if pts.shape[0] == 0:
                return
            with self._lock:
                if width_free and self._raw_parts[0].shape[1] != pts.shape[1]:
                    # the first real batch commits the width of an empty seed
                    self._raw_parts = [np.zeros((0, pts.shape[1]), np.float32)]
                parts = list(self._state[0])
                self._raw_parts.append(pts)
            base = parts[0]
            start_id = sum(p.n for p in parts)
            if base.n == 0:
                # an empty base has no mu/v1 worth freezing: the first real
                # batch IS the build
                self._full_rebuild()
                return
            if self.metric == "mips":
                if float(np.einsum("ij,ij->i", pts, pts).max()) > base.xi**2:
                    # the frozen lift cannot represent a larger-norm point
                    self._full_rebuild()
                    return
            # the delta, on the host as the reference computes it
            t, _ = _metrics.transform_data(pts, self.metric, xi=base.xi)
            x = (t - base.mu[None, :]).astype(np.float32)
            al = x @ base.v1
            loc = np.argsort(al, kind="stable")
            xs = np.ascontiguousarray(x[loc])
            als = np.ascontiguousarray(al[loc])
            # projected onto the base's FROZEN extra components too: the
            # box bound, like the window, holds for any fixed direction
            base_vs = np.asarray(base.vs)
            projs = np.concatenate(
                [als[None, :],
                 (xs @ base_vs[1:].T).T.astype(np.float32)]) \
                if base_vs.shape[0] > 1 else als[None, :]
            delta = _snn.index_from_arrays(
                base.mu, base.v1, xs, als,
                0.5 * np.einsum("ij,ij->i", xs, xs), start_id + loc,
                self.metric, base.xi, base_vs, projs, device=base.device)
            parts.append(delta)
            n_total = start_id + delta.n
            if n_total >= self.rebuild_ratio * max(self._n_at_build, 1):
                self._full_rebuild()
                return
            n_delta = sum(p.n for p in parts[1:])
            if (len(parts) - 1 > self.max_deltas
                    or n_delta > self.delta_ratio * max(base.n, 1)):
                merged = parts[0]
                for p in parts[1:]:
                    merged = merge_sorted_indexes(merged, p)
                segs, plan = self._next_plan((merged,))
                self._settle()
                with self._lock:
                    self._generation += 1
                    self._state = ((merged,), segs, plan)
            else:
                # the next epoch: the delta's segment, and the cached plan
                # extended by one stacked slab (the base's stack reused)
                seg_delta = self._segment(delta)
                # read as late as possible: a plan a racing query built
                # meanwhile is extended rather than dropped
                with self._lock:
                    prev_plan = self._state[2]
                if prev_plan is not None:
                    new_plan = prev_plan.extend([seg_delta])
                elif self._warm:
                    # nothing live to extend: build the next epoch whole so
                    # the publish still carries a warm plan
                    segs_now = tuple(
                        s if s is not None else self._segment(p)
                        for p, s in zip(parts[:-1], self._state[1]))
                    new_plan = _engine.SegmentPack.build(
                        [*segs_now, seg_delta], epoch=self._generation + 1)
                else:
                    new_plan = None
                if self._warm and new_plan is not None:
                    self._prime(new_plan, spec_from=prev_plan)
                self._settle()
                with self._lock:
                    # a query may have filled segments meanwhile: keep them
                    self._generation += 1
                    self._state = (tuple(parts),
                                   (*self._state[1], seg_delta), new_plan)

    def _full_rebuild(self) -> None:
        """Build a fresh base (caller holds ``_mutate``) and publish it."""
        base = _snn.build_index(self.raw, metric=self.metric,
                                n_iter=self.n_iter, device=self.device)
        segs, plan = self._next_plan((base,))
        self._settle()
        with self._lock:
            self._n_at_build = base.n
            self._generation += 1
            self._state = ((base,), segs, plan)

    def rebuild(self) -> None:
        """Force a full re-index (fresh mu/v1/xi) of everything appended."""
        with self._mutate:
            self._full_rebuild()

    # ------------------------------------------------------------- queries
    def _parts(self) -> tuple[_snn.SNNIndex, ...]:
        """Consistent parts snapshot for the host paths: no segment builds."""
        with self._lock:
            return self._state[0]

    def _snapshot(self):
        """Parts + segments + the `SegmentPack` plan, building what is
        missing outside the state lock (two racing queries at worst build
        the same plan twice; the write-back is dropped if a writer
        published new parts meanwhile)."""
        with self._lock:
            parts, segs, plan = self._state
        if any(s is None for s in segs) or plan is None:
            segs = tuple(s if s is not None else self._segment(p)
                         for p, s in zip(parts, segs))
            if plan is None:
                plan = _engine.SegmentPack.build(list(segs),
                                                 epoch=self._generation)
            with self._lock:
                if self._state[0] is parts:
                    self._state = (parts, segs, plan)
        return parts, list(segs), plan

    def plan(self) -> _engine.SegmentPack:
        """The current snapshot's `SegmentPack` (built on first use)."""
        return self._snapshot()[2]

    def query_radius_csr(self, q: np.ndarray, radius,
                         return_distance: bool = True, *,
                         query_tile: int = 128,
                         native: bool = True,
                         packed: bool = True,
                         mixed: bool = False,
                         bucket: bool = True,
                         fused: bool = True,
                         compacted: bool | None = None,
                         memory_budget_mb: float | None = None,
                         oracle: bool = False) -> _snn.CSRNeighbors:
        """Exact CSR results over base + deltas through the engine.

        Row contents are segment-major (base first, then the deltas in
        append order), ascending in sorted position within each segment.
        ``packed=True`` runs the snapshot's plan (one stacked launch a
        pass over every segment); ``packed=False`` the looped executor over
        the same segments, bit-identically.  ``oracle=True`` (an index on
        the CPU) takes the engine's host lane, with ``compacted`` and
        ``memory_budget_mb`` (`core.join.single_query`).
        """
        parts, _, plan = self._snapshot()
        return _join_single_query(parts[0], q, radius, return_distance,
                                  pack=plan, query_tile=query_tile,
                                  native=native, packed=packed,
                                  memory_budget_mb=memory_budget_mb,
                                  mixed=mixed, bucket=bucket,
                                  compacted=compacted, fused=fused,
                                  oracle=oracle)

    def query_counts_device(self, q: np.ndarray, radius, *,
                            query_tile: int = 128,
                            memory_budget_mb: float | None = None,
                            mixed: bool = False, bucket: bool = True,
                            compacted: bool | None = None,
                            oracle: bool = False) -> np.ndarray:
        """Exact per-query neighbour counts over base + deltas, pass 1 only
        (`core.join.query_counts` on this snapshot's plan); they equal
        ``np.diff(query_radius_csr(...).indptr)``."""
        return _join_query_counts(self, q, radius, query_tile=query_tile,
                                  memory_budget_mb=memory_budget_mb,
                                  mixed=mixed, bucket=bucket,
                                  compacted=compacted, oracle=oracle)

    def query_knn(self, q: np.ndarray, k, return_distance: bool = True, *,
                  native: bool = True, query_tile: int = 128,
                  bucket: bool = True):
        """Exact k nearest neighbours over base + deltas (`core.knn`),
        through this snapshot's plan.  ``k`` is a scalar or per-query (m,)
        vector."""
        from . import knn as _knn

        return _knn.query_knn(self, q, k, return_distance, native=native,
                              query_tile=query_tile, bucket=bucket)

    def query_radius_batch(self, q: np.ndarray, radius,
                           return_distance: bool = True,
                           group_size: int = 64) -> list:
        """Host Algorithm 2 over every part, merged per query."""
        parts = self._parts()
        outs = [_snn.query_radius_batch(p, q, radius, return_distance,
                                        group_size) for p in parts]
        if len(outs) == 1:
            return outs[0]
        merged = []
        for per_q in zip(*outs):
            if return_distance:
                merged.append((np.concatenate([i for i, _ in per_q]),
                               np.concatenate([d for _, d in per_q])))
            else:
                merged.append(np.concatenate(per_q))
        return merged

    def query_counts(self, q: np.ndarray, radius,
                     group_size: int = 64) -> np.ndarray:
        parts = self._parts()
        return sum(_snn.query_counts(p, q, radius, group_size) for p in parts)

    def query_radius_fixed(self, q: np.ndarray, radius, max_neighbors: int):
        """Fixed-shape (K-bounded) results merged across parts.

        Each part's `snn.query_radius_fixed` top-K (the filter kernel on the
        device) is concatenated and cut again to the K best by squared
        distance, ties in part order; ``counts`` stays the exact total, so
        truncation stays detectable.
        """
        parts = self._parts()
        outs = [_snn.query_radius_fixed(p, q, radius, max_neighbors,
                                        block=self.block) for p in parts]
        if len(outs) == 1:
            return outs[0]
        idx = np.concatenate([o[0] for o in outs], axis=1)
        sq = np.concatenate([o[1] for o in outs], axis=1)
        valid = np.concatenate([o[2] for o in outs], axis=1)
        counts = np.sum([o[3] for o in outs], axis=0)
        k = min(max_neighbors, idx.shape[1])
        pick = np.argsort(np.where(valid, sq, np.inf), axis=1,
                          kind="stable")[:, :k]
        return (np.take_along_axis(idx, pick, 1),
                np.take_along_axis(sq, pick, 1),
                np.take_along_axis(valid, pick, 1), counts)
