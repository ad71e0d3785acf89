"""Batched neighbor-search serving (the paper's online/streaming setting, §1.4).

A `SNNServer` fronts an `IndexRegistry` (`serving.registry`) of named
`StreamingSNNIndex`s — a single-index server is just a registry with one
``"default"`` tenant — and executes requests through the unified two-pass
CSR engine (`core.engine`) by default: every response is the full,
untruncated neighbor set, whatever its length.  Setting
``cfg.serve_exact = False`` selects the fixed-shape top-K path
(bounded response size, ``truncated`` flag when counts exceed K).

Five request kinds share the dispatcher; four of them are front-ends over
the SAME bichromatic-join primitive (`core.join`) and fuse into ONE packed
engine execution per (tenant, batch):

* **snn-radius** (``Request(query, radius)``) — the fixed-radius search;
* **snn-join** (``Request(queries_2d, radius)``) — a whole A-side block
  joined against the served database in one request: the response is the
  block's CSR (``indptr`` + flat ``indices``/``sq_dists``); ``radius`` may
  be a per-row vector;
* **snn-count** (``Request(query, radius, count_only=True)``) — neighbor
  COUNTS only (range counting / degree analytics).  An all-count batch
  skips the compact pass entirely (`engine.run_counts_packed` via
  `core.join.query_counts`); counts mixed into a CSR batch are read off
  the fused CSR row lengths at no extra dispatch;
* **snn-reverse** (``Request(target, reverse=True)``) — exact reverse
  neighbors: every served point i whose stored per-point radius covers the
  target (``d(p_i, t) <= r_i``, set once via `SNNServer.set_reverse_radii`).
  Served as a forward row at the batch's cover radius inside the same fused
  dispatch, then filtered per point against the stored radii (float64
  index-space thresholds — same measure-zero boundary caveat as
  docs/architecture.md notes for host-vs-device thresholds);
* **snn-knn** (``Request(query, k=...)``) — exact k nearest neighbors via
  the per-query radius-expansion front-end (`core.knn`).

**Admission** is deadline-aware continuous batching by default
(``cfg.serve_policy = "deadline"``): the dispatcher blocks only for the
first request, then fuses everything already queued until the batch fills
``serve_batch``, the queue empties (light load flushes immediately), or
the OLDEST request's remaining SLO budget (``Request.slo_ms``, default
``cfg.serve_slo_ms``) minus the measured per-batch service-time EWMA hits
zero.  FIFO order is preserved end to end, so no request starves, and
every `Response` records its ``queue_delay_ms`` / ``service_ms`` split.
``cfg.serve_policy = "window"`` selects a fixed
``serve_timeout_ms`` batching window.  Whatever the policy, EVERY pending
request of the CSR family (radius + join + count + reverse) fuses into one
engine execution per tenant — a batch of B requests with R distinct radii
and any mix of kinds costs O(1) engine dispatches, not O(R) and not
O(kinds).

Online updates go through `append`: new points become a sorted LSM delta
segment on the index's frozen mu/v1 (O(b log b) for a b-point batch — no
power iteration, no full re-sort, no serving gap) and queries remain exact
across base + deltas; compactions and the rare full re-index are handled by
the streaming index's size-ratio triggers (see `core.streaming`).
`rebuild(new_points)` additionally FORCES a full re-index (fresh mu/v1/xi)
after absorbing the points.  With ``cfg.serve_warm_plans`` (default) every
mutation runs double-buffered: the next generation's `SegmentPack` is built
AND warmed (zero-match priming dispatch through the bucket ladder the
server has actually served, fused-capacity spec adopted from the outgoing
plan) on the mutator thread before the atomic snapshot swap — the serving
thread keeps answering on the old plan and never pays plan construction or
first-launch warmup, so p99 does not spike across a rebuild.

The server and its tenants live on ``device`` (default: the card; raises
without one unless ``"cpu"``).  The dispatcher and the mutator threads both
launch on their current CUDA stream, the default stream unless a caller set
another, and a streaming index synchronizes its device work before it
publishes a plan, so the dispatcher never reads a plan still in flight.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback

import numpy as np

from ..configs.snn_default import SNNConfig
from ..kernels import registry as _kregistry
from .registry import IndexRegistry
from .runtime import (Request, Response, ServiceClock, TenantRuntime,
                      collect_batch, error_response)

__all__ = ["Request", "Response", "SNNServer", "IndexRegistry"]


class SNNServer:
    """The serving front door: queue + admission loop + result table.

    ``data`` seeds the ``"default"`` tenant; pass ``registry=`` to front an
    existing multi-tenant `IndexRegistry` instead (``data`` may then be
    None if a default tenant already exists).  Requests route by
    ``Request.tenant``; all tenants share one FIFO queue, one dispatcher
    thread, and one device-memory budget (`IndexRegistry.enforce_budget`).
    ``device`` defaults to the registry's when one is passed (and must
    then name it), else to the card.
    """

    def __init__(self, data: np.ndarray | None = None,
                 cfg: SNNConfig = SNNConfig(), *,
                 registry: IndexRegistry | None = None, device=None):
        self.cfg = cfg
        if registry is None:
            self.device = _kregistry.resolve_device(device)
            registry = IndexRegistry(cfg, device=self.device)
        else:
            self.device = registry._own_device(device)
        self.registry = registry
        if data is not None and "default" not in self.registry:
            self.registry.create("default", np.asarray(data, np.float32),
                                 cfg)
        self._q: queue.Queue = queue.Queue()
        self._results: dict[int, Response] = {}
        self._events: dict[int, threading.Event] = {}
        # responses whose waiter timed out (or never existed) have no event
        # left to protect them; cap how many such orphans we keep
        self._max_backlog = max(4 * cfg.serve_batch, 1024)
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        # per-batch service-time EWMA the deadline admission policy uses
        self._clock = ServiceClock(cfg.serve_ewma)

    # -------------------------------------------------------- tenant access
    def runtime(self, tenant: str = "default") -> TenantRuntime:
        rt = self.registry.get(tenant)
        if rt is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        return rt

    @property
    def index(self):
        """The default tenant's `StreamingSNNIndex` (single-index usage)."""
        return self.runtime().index

    @property
    def data(self) -> np.ndarray:
        """All served points of the default tenant (original append order)."""
        return self.index.raw

    @property
    def generation(self) -> int:
        """Index generation the cached execution plan is valid for.

        Bumps on every append/merge/rebuild; the serving plan (the streaming
        snapshot's `SegmentPack`) is invalidated, incrementally extended, or
        — with ``cfg.serve_warm_plans`` — swapped for a pre-warmed successor
        at the same publish, so a response is always computed on a plan of
        its own generation.
        """
        return self.index.generation

    # ----------------------------------------------------------- lifecycle
    def start(self):
        self._done.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._done.set()
        if self._thread:
            self._thread.join()

    def append(self, new_points: np.ndarray, tenant: str = "default"):
        """Stream new points in: an O(b log b) delta append, no serving gap."""
        self.runtime(tenant).index.append(new_points)

    def rebuild(self, new_points: np.ndarray | None = None,
                tenant: str = "default"):
        """Absorb ``new_points`` (if any) and FORCE a full re-index.

        Unlike `append` — which only creates an LSM delta and lets the
        streaming index's size-ratio triggers decide — this always runs the
        real rebuild path (fresh mu/v1/xi over everything served so far) and
        publishes a new index `generation`.  The rebuild happens outside
        the snapshot lock — queries keep answering on the previous
        generation until the publish — and with ``cfg.serve_warm_plans``
        the new generation's plan is built and warmed on THIS (caller's)
        thread before the swap, so the serving thread's first post-swap
        batch runs at steady-state cost.
        """
        index = self.runtime(tenant).index
        if new_points is not None and np.asarray(new_points).size:
            before = index._n_at_build
            index.append(new_points)
            if index._n_at_build != before:
                # the append itself tripped a full re-index (rebuild_ratio
                # growth or a mips-lift overflow) — everything below would
                # repeat the identical build over the same points
                return
        index.rebuild()

    def set_reverse_radii(self, radii: np.ndarray,
                          tenant: str = "default"):
        """Store the per-point radii snn-reverse requests are answered with.

        ``radii[i]`` is point i's radius (original append order, native
        metric; for mips the per-point inner-product threshold).  Must cover
        every currently-served point; points appended later have no radius
        and never match a reverse request until this is called again.
        """
        self.runtime(tenant).set_reverse_radii(radii)

    # ------------------------------------------------------------- client
    def submit(self, req: Request):
        """Validate and enqueue ``req``.

        The one validation point for every request kind: exactly one of
        ``radius=`` / ``k=`` must be set (reverse requests set neither —
        their radii are the stored per-point vector), the tenant must
        exist, and kind-specific shape rules are checked here so a
        malformed request fails fast at the call site instead of poisoning
        a fused batch.
        """
        self.runtime(req.tenant).validate(req)
        req._t0 = time.monotonic()
        with self._lock:
            self._events.setdefault(req.id, threading.Event())
        self._q.put(req)

    def result(self, rid: int, timeout: float = 30.0) -> Response:
        """Block until request ``rid``'s response is ready (event-driven).

        A response whose runtime could not serve the request comes back
        with ``error`` set (and empty results) *immediately* — a degraded
        batch is a fast failure here, never a silent wait for this timeout.
        """
        with self._lock:
            if rid in self._results:
                self._events.pop(rid, None)
                return self._results.pop(rid)
            ev = self._events.setdefault(rid, threading.Event())
        ev.wait(timeout)
        with self._lock:
            self._events.pop(rid, None)
            if rid in self._results:
                return self._results.pop(rid)
        raise TimeoutError(f"request {rid}")

    def query_batch(self, queries: np.ndarray, radius: float,
                    tenant: str = "default"):
        """Synchronous batched query (bypasses the dispatcher)."""
        return self.runtime(tenant).index.query_radius_batch(
            queries, radius, group_size=self.cfg.batch_group)

    # ----------------------------------------------------------- dispatcher
    def _loop(self):
        while not self._done.is_set():
            batch = collect_batch(self._q, self.cfg, self._clock)
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception:
                # keep the dispatcher alive; _run_batch's sweep answered
                # what it could, anything else times out
                traceback.print_exc()

    def _run_batch(self, batch: list[Request]):
        """Serve one admitted batch: group by tenant, one fused run each.

        Single-tenant batches (the common case) keep the exact pre-registry
        execution; multi-tenant batches run per-tenant sub-batches in FIFO
        order of each tenant's first request.  After serving, the
        registry's device-memory budget is enforced — cold tenants' plans
        are LRU-evicted, never the ones just served.
        """
        groups: dict[str, list[Request]] = {}
        for r in batch:
            groups.setdefault(getattr(r, "tenant", "default") or "default",
                              []).append(r)
        for tenant, sub in groups.items():
            rt = self.registry.get(tenant)
            if rt is None:
                # submit() validates tenants, but requests can reach the
                # dispatcher by other routes — answer, don't drop
                for r in sub:
                    self._store(error_response(
                        r, f"unknown tenant {tenant!r}"))
                continue
            self.registry.touch(tenant)
            rt.run_batch(sub, self._store, clock=self._clock)
        if len(self.registry.names()) > 1:
            self.registry.enforce_budget(
                active=next(iter(groups)) if len(groups) == 1 else None)

    def _store(self, resp: Response):
        with self._lock:
            self._results[resp.id] = resp
            # signal, never create: a missing event means the waiter already
            # timed out and popped it (or never existed) — creating one here
            # would leak it, since nobody is left to pop it
            ev = self._events.get(resp.id)
            if ev is not None:
                ev.set()
            # evict oldest orphaned responses (no live waiter event) so
            # timed-out requests cannot grow _results without bound
            if len(self._results) > self._max_backlog:
                for rid in list(self._results):
                    if len(self._results) <= self._max_backlog:
                        break
                    if rid not in self._events:
                        del self._results[rid]
            # hard cap (load shedding): fire-and-forget clients never pop
            # their events, so past 4x the soft cap evict oldest entries
            # outright — a parked waiter wakes into its TimeoutError
            hard = 4 * self._max_backlog
            while len(self._results) > hard:
                rid = next(iter(self._results))
                del self._results[rid]
                stale = self._events.pop(rid, None)
                if stale is not None:
                    stale.set()
            while len(self._events) > hard:
                rid, stale = next(iter(self._events.items()))
                del self._events[rid]
                stale.set()
