"""Serving runtime: request/response types, admission policies, executors.

This module is the mechanics under `serving.server.SNNServer` and
`serving.registry.IndexRegistry`:

* `Request` / `Response` — the wire types.  A request carries an SLO budget
  (``slo_ms``, defaulting to ``SNNConfig.serve_slo_ms``) and a ``tenant``
  name; a response records how its latency split into queue delay (submit →
  batch flush) and service time (the fused engine execution), plus the
  index ``generation`` it was answered on and an ``error`` string when the
  runtime could not serve it (instead of silently timing the caller out).
* `ServiceClock` — the per-batch service-time EWMA the deadline-aware
  admission policy subtracts from the oldest request's remaining budget.
* `collect_batch` — one admission-loop iteration.  ``serve_policy ==
  "deadline"`` (default) is continuous batching: block only for the first
  request, then greedily fuse everything already queued until the batch
  fills, the queue empties (light load flushes immediately — no fixed
  window to eat), or the OLDEST admitted request's remaining SLO budget
  minus the service-time estimate hits zero (so a backlogged drain still
  flushes in time).  FIFO order is the queue's own: nothing reorders, so no
  request can starve behind later arrivals.  ``serve_policy == "window"``
  closes each batch a fixed ``serve_timeout_ms`` after it opens.
* `TenantRuntime` — one tenant's index + per-point reverse radii + the
  batch executors (the fused CSR-family dispatch, the fixed-shape
  fallback, the knn front-end).  `run_batch` guarantees EVERY request in
  the batch gets a response: requests a degraded path cannot serve — and
  requests lost to an executor exception — receive an error `Response`
  immediately rather than leaving their callers blocked until the
  `result()` timeout.

The executors are the JAX package's (``repro.serving.runtime``) over the
port's streaming index: the fused single-dispatch contract (a batch of
mixed kinds/radii/k costs O(1) engine executions) and bit-identity to
single-shot queries are unchanged.  The index lives on ``device`` (default:
the card; raises without one unless ``"cpu"``); `Response` arrays are
numpy on the host.
"""
from __future__ import annotations

import dataclasses
import queue
import time
import traceback

import numpy as np

from ..configs.snn_default import SNNConfig
from ..core import metrics as _metrics
from ..core.streaming import StreamingSNNIndex
from ..kernels import ops as _ops


@dataclasses.dataclass
class Request:
    """One serving request; the kind is derived from which fields are set.

    Exactly one of ``radius`` / ``k`` must be set — except for reverse
    requests, which set NEITHER (their radii are the server's stored
    per-point vector).  ``k`` makes it an snn-knn request whose response
    holds the k nearest neighbors (ascending distance) instead of an
    eps-ball.  A 2-D ``query`` block makes a radius request an snn-join
    (``radius`` then may be a per-row vector); ``count_only`` downgrades
    any radius/join request to counts; ``reverse`` asks for the points
    whose stored radius covers the query target(s).

    ``slo_ms`` is this request's end-to-end latency budget for the
    deadline-aware admission loop (None → ``SNNConfig.serve_slo_ms``);
    ``tenant`` routes it to a named index when the server fronts an
    `IndexRegistry` (the default tenant is ``"default"``).
    """

    query: np.ndarray
    radius: float | np.ndarray | None = None
    id: int = 0
    k: int | None = None
    count_only: bool = False
    reverse: bool = False
    slo_ms: float | None = None
    tenant: str = "default"
    # stamped by submit(); a default keeps requests that reach the dispatcher
    # by other routes (tests, replays) from crashing mid-batch
    _t0: float = dataclasses.field(default=0.0, repr=False, compare=False)

    @property
    def kind(self) -> str:
        if self.k is not None:
            return "snn-knn"
        if self.reverse:
            return "snn-reverse"
        if self.count_only:
            return "snn-count"
        if np.asarray(self.query).ndim == 2:
            return "snn-join"
        return "snn-radius"

    @property
    def rows(self) -> int:
        """Rows this request contributes to the fused query block."""
        q = np.asarray(self.query)
        return q.shape[0] if q.ndim == 2 else 1


@dataclasses.dataclass
class Response:
    id: int
    indices: np.ndarray
    sq_dists: np.ndarray
    truncated: bool
    latency_ms: float
    # snn-join / snn-reverse: per-row CSR offsets into indices/sq_dists
    indptr: np.ndarray | None = None
    # snn-count: per-row neighbor counts (no indices/sq_dists materialized)
    counts: np.ndarray | None = None
    # latency split: submit -> batch flush, and the batch's engine execution
    queue_delay_ms: float = 0.0
    service_ms: float = 0.0
    # index generation the answer was computed on (-1: never served)
    generation: int = -1
    # set when the runtime could NOT serve the request (degraded path with
    # no equivalent for this kind, executor failure, unknown tenant):
    # indices/sq_dists are empty and the caller should treat this as a fast
    # failure instead of a timeout
    error: str | None = None


_EMPTY_I = np.zeros(0, np.int64)
_EMPTY_F = np.zeros(0, np.float64)


def error_response(req: Request, message: str) -> Response:
    """A fast-failure `Response`: empty results, ``error`` set."""
    now = time.monotonic()
    return Response(
        id=req.id, indices=_EMPTY_I, sq_dists=_EMPTY_F, truncated=False,
        latency_ms=(now - req._t0) * 1e3 if req._t0 else 0.0,
        error=message)


class ServiceClock:
    """EWMA of per-batch service time (seconds) for the deadline policy."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self._est = 0.0

    def observe(self, seconds: float) -> None:
        s = max(0.0, float(seconds))
        self._est = s if self._est == 0.0 \
            else self.alpha * s + (1.0 - self.alpha) * self._est

    def estimate(self) -> float:
        return self._est


def request_deadline(req: Request, cfg: SNNConfig) -> float:
    """Absolute monotonic() time ``req``'s SLO budget expires at."""
    slo = cfg.serve_slo_ms if req.slo_ms is None else req.slo_ms
    t0 = req._t0 or time.monotonic()
    return t0 + max(0.0, float(slo)) / 1e3


def collect_batch(q: "queue.Queue[Request]", cfg: SNNConfig,
                  clock: ServiceClock | None = None,
                  poll_s: float = 0.05) -> list[Request]:
    """One admission iteration: block for work, fuse, return the batch.

    Returns [] when nothing arrived within one poll interval (the caller's
    loop re-checks its shutdown flag and calls again).  See the module
    docstring for the two policies; FIFO comes from the queue itself.
    """
    if cfg.serve_policy == "window":
        # fixed window: the batch closes serve_timeout_ms after the
        # iteration starts, whether or not anything arrived early
        batch: list[Request] = []
        deadline = time.monotonic() + cfg.serve_timeout_ms / 1e3
        while len(batch) < cfg.serve_batch:
            tmo = deadline - time.monotonic()
            if tmo <= 0:
                break
            try:
                batch.append(q.get(timeout=tmo))
            except queue.Empty:
                break
        return batch
    # deadline-aware continuous batching: block ONLY for the first request
    try:
        first = q.get(timeout=poll_s)
    except queue.Empty:
        return []
    batch = [first]
    flush_at = request_deadline(first, cfg)
    est = clock.estimate() if clock is not None else 0.0
    while len(batch) < cfg.serve_batch:
        # the OLDEST request governs: once its remaining budget no longer
        # covers the expected service time, flush whatever is fused so far
        # (an already-expired budget flushes the first request alone)
        if flush_at - time.monotonic() - est <= 0.0:
            break
        try:
            # non-blocking: an empty queue means light load — flush NOW
            # instead of holding the batch open for a window that only
            # adds queueing latency
            batch.append(q.get_nowait())
        except queue.Empty:
            break
    return batch


class TenantRuntime:
    """One tenant's index + executors; stateless across batches except for
    the reverse-radii table and the bucket ladder observed for plan warming.

    ``run_batch`` is the dispatcher body: it is called from ONE dispatcher
    thread at a time per tenant (batch-local context lives on the instance).
    """

    def __init__(self, data_or_index, cfg: SNNConfig = SNNConfig(), *,
                 name: str = "default", device=None):
        self.cfg = cfg
        self.name = name
        if isinstance(data_or_index, StreamingSNNIndex):
            self.index = data_or_index
        else:
            self.index = StreamingSNNIndex(
                np.asarray(data_or_index, np.float32), metric=cfg.metric,
                n_iter=cfg.power_iters, block=cfg.block_rows,
                delta_ratio=cfg.delta_merge_ratio,
                max_deltas=cfg.max_delta_segments,
                rebuild_ratio=cfg.rebuild_ratio, device=device)
        # per-point radii for snn-reverse requests (original append order);
        # points appended after set_reverse_radii() have no radius and never
        # match until the radii are set again
        self.reverse_radii: np.ndarray | None = None
        # bucketed batch sizes this tenant has actually served: the plan
        # warmer primes exactly these ladder rungs for the next generation
        self._buckets: set[int] = {cfg.query_tile}
        if cfg.serve_warm_plans:
            # the callable holds the set, not the runtime: an index that
            # held its runtime would keep both, and their device memory,
            # alive until the cycle collector ran
            buckets = self._buckets
            self.index.set_plan_warming(
                True, m_pads=lambda: sorted(buckets),
                query_tile=cfg.query_tile)
        # batch-local context (valid during one run_batch call)
        self._t_svc = 0.0
        self._gen = -1
        self._stored: set[int] = set()
        self._emit_fn = None

    # ---------------------------------------------------------- validation
    def validate(self, req: Request) -> None:
        """Kind/shape validation (the submit()-time fail-fast gate)."""
        q = np.asarray(req.query)
        if req.reverse:
            if req.radius is not None or req.k is not None:
                raise ValueError(
                    "an snn-reverse Request takes neither radius= nor k= — "
                    "it is answered with the stored per-point radii "
                    "(set_reverse_radii)")
            if req.count_only:
                raise ValueError("count_only is not supported for "
                                 "snn-reverse requests")
            if self.reverse_radii is None:
                raise ValueError("call set_reverse_radii() before "
                                 "submitting snn-reverse requests")
        elif (req.radius is None) == (req.k is None):
            raise ValueError("a Request needs exactly one of radius= "
                             "(snn-radius / snn-join / snn-count) or k= "
                             "(snn-knn)")
        if req.k is not None:
            if req.count_only:
                raise ValueError("count_only applies to radius requests "
                                 "only, not snn-knn")
            if q.ndim != 1:
                raise ValueError("snn-knn queries are single (d,) points; "
                                 f"got shape {q.shape}")
        if q.ndim not in (1, 2):
            raise ValueError(f"query must be (d,) or (m, d); got {q.shape}")
        if req.radius is not None and np.ndim(req.radius):
            rv = np.asarray(req.radius)
            if rv.ndim != 1 or rv.shape[0] != req.rows:
                raise ValueError(
                    f"per-row radius must be a ({req.rows},) vector "
                    f"matching the query block; got shape {rv.shape}")

    def set_reverse_radii(self, radii: np.ndarray) -> None:
        radii = np.asarray(radii, np.float64)
        n = self.index.n
        if radii.ndim != 1 or radii.shape[0] != n:
            raise ValueError(f"reverse radii must be a ({n},) vector "
                             f"(one per served point); got shape "
                             f"{radii.shape}")
        self.reverse_radii = radii.copy()

    # ----------------------------------------------------------- execution
    def run_batch(self, batch: list[Request], store,
                  clock: ServiceClock | None = None) -> None:
        """Serve ``batch`` end-to-end; EVERY request gets a `Response`.

        ``store`` receives each `Response` (the server's result table).
        Degraded paths store an error response immediately for the kinds
        they cannot serve, and a final sweep answers anything an executor
        exception orphaned — a request never exits this method unanswered.
        """
        t_svc = time.monotonic()
        self._t_svc = t_svc
        self._gen = self.index.generation
        self._stored = set()
        self._emit_fn = store
        try:
            knn_sel = [i for i, r in enumerate(batch)
                       if r.kind == "snn-knn"]
            csr_sel = [i for i, r in enumerate(batch)
                       if r.kind != "snn-knn"]
            if csr_sel:
                self._serve_csr(batch, csr_sel)
            if knn_sel:
                try:
                    self._respond_knn(batch, knn_sel)
                except Exception:
                    traceback.print_exc()
        finally:
            # the no-silent-drop guarantee: whatever failed above, every
            # request's caller gets a fast error instead of a timeout
            for r in batch:
                if r.id not in self._stored:
                    self._emit_error(r, f"{r.kind} request could not be "
                                     f"served (executor failure; see "
                                     f"server log)")
            if clock is not None:
                clock.observe(time.monotonic() - t_svc)
            self._emit_fn = None

    def _serve_csr(self, batch, csr_sel) -> None:
        cfg = self.cfg
        if cfg.serve_exact:
            try:
                self._respond_csr_family(batch, csr_sel)
                return
            except Exception:
                # The exact path's flat output is data-dependent (a
                # pathologically dense batch can need a CSR larger than
                # device memory, and the kernels raise on a failed
                # launch); degrade to the K-bounded fixed path — per-query
                # radii there too.
                traceback.print_exc()
        # Only the plain-radius subset has a fixed-shape equivalent; answer
        # join/count/reverse requests with an error NOW, so their callers
        # fail fast instead of blocking until the result() timeout
        fixed_sel = []
        for i in csr_sel:
            if batch[i].kind == "snn-radius":
                fixed_sel.append(i)
            elif batch[i].id not in self._stored:
                self._emit_error(
                    batch[i],
                    f"the fixed-shape path cannot serve {batch[i].kind} "
                    f"requests"
                    + (" (exact CSR path failed for this batch)"
                       if cfg.serve_exact else " (cfg.serve_exact=False)"))
        try:
            self._respond_fixed(batch, fixed_sel)
        except Exception:
            traceback.print_exc()  # final sweep answers these with errors

    # ------------------------------------------------------------ emission
    def _emit(self, req: Request, *, indices, sq_dists, truncated=False,
              indptr=None, counts=None) -> None:
        now = time.monotonic()
        t0 = req._t0 or now
        self._stored.add(req.id)
        self._emit_fn(Response(
            id=req.id, indices=indices, sq_dists=sq_dists,
            truncated=truncated,
            latency_ms=(now - t0) * 1e3 if req._t0 else 0.0,
            indptr=indptr, counts=counts,
            queue_delay_ms=max(0.0, (self._t_svc - t0) * 1e3)
            if req._t0 else 0.0,
            service_ms=(now - self._t_svc) * 1e3,
            generation=self._gen))

    def _emit_error(self, req: Request, message: str) -> None:
        self._stored.add(req.id)
        resp = error_response(req, message)
        resp.generation = self._gen
        if req._t0:
            resp.queue_delay_ms = max(0.0, (self._t_svc - req._t0) * 1e3)
        self._emit_fn(resp)

    # ------------------------------------------------- reverse radii plumbing
    def _reverse_tables(self):
        """(stored radii, index-space sq thresholds, cover radius) snapshot.

        The thresholds convert each stored native radius into the squared
        index-space Euclidean bound the fused dispatch's ``sq_dists`` are
        compared against (`metrics.euclidean_radius` squared, precomputed
        per point); for mips the per-target ``xi^2 + ||q||^2`` offset is
        added at filter time.  The cover radius is the single most inclusive
        stored radius — running each target forward at the cover returns a
        superset of every per-point answer, which the float64 threshold
        filter then trims exactly.
        """
        rr = self.reverse_radii
        metric = self.cfg.metric
        if metric == "euclidean":
            thr = rr * rr
        elif metric == "cosine":
            thr = 2.0 * rr
        elif metric == "angular":
            thr = 2.0 - 2.0 * np.cos(rr)
        else:  # mips: threshold is xi^2 + ||q||^2 - 2 S; offset added later
            thr = -2.0 * rr
        # mips thresholds are inner products: SMALLER is more inclusive
        cover = float(rr.min() if metric == "mips" else rr.max())
        return rr, thr, cover

    @staticmethod
    def _filter_reverse_row(ids, sq, thr, mips_offset):
        """Trim a cover-radius forward row to the exact reverse answer.

        Keeps point i iff i has a stored radius and the row's index-space
        squared distance is within i's own threshold (float64 throughout).
        """
        keep = ids < thr.shape[0]
        ids, sq = ids[keep], np.asarray(sq, np.float64)[keep]
        ok = sq <= thr[ids] + mips_offset
        return ids[ok], sq[ok]

    # ----------------------------------------------------------- executors
    def _respond_csr_family(self, batch, sel):
        """Exact path: ONE fused dispatch for every CSR-family request.

        Radius, join, count, and reverse requests all reduce to rows of one
        query block with per-row radii — heterogeneous radii AND kinds cost
        the same single packed execution a uniform batch does, and each
        response is bit-identical to querying its request alone.  An
        all-count batch never runs the compact pass at all
        (`core.join.query_counts` == `engine.run_counts_packed`); counts
        mixed with CSR kinds are read off the fused CSR row lengths.  With
        ``cfg.serve_packed`` (default) the execution runs the streaming
        snapshot's `SegmentPack` plan — built on the first request of an
        index generation, reused by every request until an append/rebuild
        publishes the next generation (appends extend the plan
        incrementally instead of rebuilding it, and with
        ``cfg.serve_warm_plans`` the next generation arrives pre-warmed;
        see `core.streaming`).  The flat CSR staging buffers are
        engine-level scratch reused across requests, so steady-state
        serving allocates only the exact-size responses.
        """
        cfg = self.cfg
        index = self.index
        rev_thr = rev_cover = None
        if any(batch[bi].kind == "snn-reverse" for bi in sel):
            _, rev_thr, rev_cover = self._reverse_tables()
        spans, qparts, rparts = [], [], []
        row0 = 0
        for bi in sel:
            r = batch[bi]
            q = np.asarray(r.query, np.float32)
            q2 = q[None, :] if q.ndim == 1 else q
            mi = q2.shape[0]
            if r.kind == "snn-reverse":
                rv = np.full(mi, rev_cover, np.float64)
            else:
                rv = _metrics.broadcast_radius(r.radius, mi)
            qparts.append(q2)
            rparts.append(rv)
            spans.append((bi, row0, mi))
            row0 += mi
        qs = np.concatenate(qparts, axis=0)
        radii = np.concatenate(rparts)
        if cfg.serve_bucket:
            self._buckets.add(int(_ops.bucket_rows(row0, cfg.query_tile)))
        if (cfg.serve_count_pass
                and all(batch[bi].kind == "snn-count" for bi in sel)):
            counts = index.query_counts_device(
                qs, radii, query_tile=cfg.query_tile,
                bucket=cfg.serve_bucket)
            for bi, s, mi in spans:
                self._emit(batch[bi], indices=_EMPTY_I, sq_dists=_EMPTY_F,
                           counts=counts[s:s + mi].copy())
            return
        csr = index.query_radius_csr(qs, radii,
                                     query_tile=cfg.query_tile,
                                     native=False,
                                     packed=cfg.serve_packed,
                                     bucket=cfg.serve_bucket)
        for bi, s, mi in spans:
            r = batch[bi]
            # copies throughout: CSR rows are views into the batch-wide flat
            # arrays, and a Response parked in _results must not pin them
            if r.kind == "snn-count":
                cnt = (csr.indptr[s + 1:s + mi + 1]
                       - csr.indptr[s:s + mi])
                self._emit(r, indices=_EMPTY_I, sq_dists=_EMPTY_F,
                           counts=cnt.copy())
            elif r.kind == "snn-join":
                lo, hi = csr.indptr[s], csr.indptr[s + mi]
                self._emit(r, indices=np.array(csr.indices[lo:hi]),
                           sq_dists=np.array(csr.distances[lo:hi]),
                           indptr=(csr.indptr[s:s + mi + 1] - lo).copy())
            elif r.kind == "snn-reverse":
                if cfg.metric == "mips":
                    xi = index.base.xi
                    qsq = np.einsum("ij,ij->i",
                                    np.asarray(qs[s:s + mi], np.float64),
                                    np.asarray(qs[s:s + mi], np.float64))
                    offs = xi * xi + qsq
                else:
                    offs = np.zeros(mi)
                parts_i, parts_d = [], []
                for t in range(mi):
                    ids, sq = csr.row(s + t)
                    fi, fd = self._filter_reverse_row(ids, sq, rev_thr,
                                                      offs[t])
                    parts_i.append(fi)
                    parts_d.append(fd)
                indptr = np.zeros(mi + 1, np.int64)
                np.cumsum([p.size for p in parts_i], out=indptr[1:])
                self._emit(r, indices=np.concatenate(parts_i),
                           sq_dists=np.concatenate(parts_d),
                           indptr=(indptr if np.asarray(r.query).ndim == 2
                                   else None))
            else:  # snn-radius
                idx, sq = csr.row(s)
                self._emit(r, indices=np.array(idx),
                           sq_dists=np.array(sq))

    def _respond_fixed(self, batch, sel):
        """Legacy fixed-shape path: K-bounded responses, truncated flag.

        Fused exactly like the exact path — the per-query radius vector
        flows through `query_radius_fixed` unchanged.  Plain snn-radius
        requests only (join/count/reverse have no fixed-shape equivalent
        and were already answered with errors by `_serve_csr`).
        """
        if not sel:
            return
        qs = np.stack([np.asarray(batch[bi].query, np.float32)
                       for bi in sel])
        radii = np.asarray([batch[bi].radius for bi in sel], np.float64)
        idx, sq, valid, counts = self.index.query_radius_fixed(
            qs, radii, self.cfg.max_neighbors)
        for j, bi in enumerate(sel):
            self._emit(batch[bi], indices=idx[j][valid[j]],
                       sq_dists=sq[j][valid[j]],
                       truncated=bool(counts[j] > self.cfg.max_neighbors))

    def _respond_knn(self, batch, sel):
        """snn-knn: one fused per-query-k search (`core.knn`) for the batch.

        Mixed k's fuse the same way mixed radii do — the expansion loop's
        radius vector is per query, so one engine execution serves them all.
        Responses carry squared Euclidean index-space distances ascending
        (the radius paths' ``sq_dists`` convention), trimmed to each
        request's k.
        """
        qs = np.stack([np.asarray(batch[bi].query, np.float32)
                       for bi in sel])
        ks = np.asarray([batch[bi].k for bi in sel], np.int64)
        idx, sq = self.index.query_knn(qs, ks, native=False,
                                       query_tile=self.cfg.query_tile,
                                       bucket=self.cfg.serve_bucket)
        for j, bi in enumerate(sel):
            found = idx[j, :ks[j]] >= 0
            self._emit(batch[bi], indices=idx[j, :ks[j]][found],
                       sq_dists=sq[j, :ks[j]][found])
