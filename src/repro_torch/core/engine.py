"""Multi-segment CSR execution engine: plan / execute, packed and looped.

The counterpart of ``repro.core.engine``.  A *segment* is a contiguous
alpha-sorted run of database rows: a whole index, or one of the narrow
runs `segments_from_index` cuts for the self-join graph.  Every batch runs
the two-pass exact CSR orchestration:

1. **pass 1, count**: per-(segment, query) survivor counts, (S, m_pad);
2. **prefix sums**: the global CSR ``indptr`` and each segment's per-query
   write base (an exclusive prefix over segments);
3. **pass 2, compact**: every survivor is written into its flat CSR slot.

Two executors share that orchestration:

* the **packed** executor (`run_csr_packed`) runs a `SegmentPack`, which
  stacks the segments into (S, n_pad, d_pad) tensors on one device, built
  once and reused across batches: the segment prune is one vectorized
  interval test, each pass is ONE stacked launch, and the prefix sums run
  on the device.  Once a batch shape has run, the fused path chains count,
  prefix and compact with no host sync between them, under a speculated
  flat capacity that the compact kernel checks on the device; the result
  comes back in one device-to-host copy.  An overflow reruns the classic
  path with exact sizes and ratchets the capacity (power-of-two buckets);
* the **looped** executor (`run_csr`) launches the single-segment count and
  compact once per live segment, with a host sync after each count and the
  prefix sums in numpy: the cross-check of the packed executor.  The
  single-segment kernels are the stacked ones on a stack of one, so packed
  output is bit-identical to looped output.

The passes run through `kernels.registry`: the CUDA kernels for segments on
the card, their plain PyTorch versions for segments on the CPU, with the
same orchestration around them.  Both passes evaluate one predicate
pipeline on identical float32 inputs, so pass-2 survivors are exactly the
pass-1 counted pairs; a final ``>= 0`` check on the flat ids fails loudly if
they ever disagree.  Segments whose alpha range meets no query window are
skipped before any launch.

**The host lane** (``oracle=True``): the reference's CPU executors, for
segments and packs on the CPU.  One dense masked filter feeds both passes
(np.nonzero's row-major order is the CSR order, and an O(nnz) group rank
places every survivor); with extra projection components the filter is
evaluated on host-gathered candidate rows only, per query tile (the
*pruned* executor) or as one batched tile product (the *compacted*
executor, the default).  ``memory_budget_mb`` bounds the dense filters the
lane holds: the looped executor caches pass-1 filters for pass 2 only
under it, and a packed batch whose filter would pass it runs the looped
executor instead.  The lane never reroutes a CUDA tensor: on a pack on the
card ``oracle=True`` raises, as the reference sends every device lane to
its stacked executor; ``compacted`` and ``memory_budget_mb`` are ignored
off the lane.  Flat results are staged in a per-thread grow-only scratch
(`_FlatScratch`), which `MemoryPlan.reserve` pre-grows.

A `SegmentPack` carries an ``epoch``: the streaming index extends it by
one stacked slab a delta (`SegmentPack.extend`), and `warm_plan` primes a
new epoch before it is published.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..kernels import ops as _ops
from ..kernels import ref as _ref
from ..kernels import registry as _registry

# Padding rows carry alpha = half_norm = +BIG; anything above this threshold
# is sentinel, not data (used when recovering a segment's real alpha range).
_REAL = _ops.BIG / 2


# --------------------------------------------------------------------------- #
# Dispatch instrumentation                                                     #
# --------------------------------------------------------------------------- #
_STAT_FIELDS = ("kernel_launches", "host_transfers", "jit_compiles",
                "bytes_planned")


class _StatCounters:
    """One thread's raw counters (only its owner thread mutates them)."""

    __slots__ = _STAT_FIELDS

    def __init__(self) -> None:
        for f in _STAT_FIELDS:
            setattr(self, f, 0)


_AGG_LOCK = threading.Lock()
_ALL_COUNTERS: list[_StatCounters] = []


class DispatchStats(threading.local):
    """Per-thread counters of the engine's dispatch overhead.

    ``kernel_launches`` counts the device passes the engine issues (count,
    prefix, compact); ``host_transfers`` counts device-to-host copies (the
    fused path's whole result is one copy); ``jit_compiles`` counts launch
    signatures never seen before in this process
    (`kernels.registry.note_launch_signature`); ``bytes_planned`` counts the
    bytes of newly built `MemoryPlan`s.

    Each thread gets its own `_StatCounters` holder on first touch
    (``threading.local``), registered in a lock-guarded list, so a server's
    dispatcher and a mutator warming the next plan never race on an
    increment and each sees only its own work; `aggregate()` sums every
    holder ever registered, the cross-thread view.
    """

    def __init__(self) -> None:
        self._c = _StatCounters()
        with _AGG_LOCK:
            _ALL_COUNTERS.append(self._c)

    def reset(self) -> None:
        for f in _STAT_FIELDS:
            setattr(self._c, f, 0)

    def snapshot(self) -> dict:
        return {f: getattr(self._c, f) for f in _STAT_FIELDS}

    @staticmethod
    def aggregate() -> dict:
        """Sum of every thread's counters (exited threads included), since
        each thread's last `reset`."""
        with _AGG_LOCK:
            holders = list(_ALL_COUNTERS)
        out = dict.fromkeys(_STAT_FIELDS, 0)
        for c in holders:
            for f in _STAT_FIELDS:
                out[f] += getattr(c, f)
        return out


def _stat_property(field: str) -> property:
    return property(lambda self: getattr(self._c, field),
                    lambda self, value: setattr(self._c, field, value))


for _f in _STAT_FIELDS:
    setattr(DispatchStats, _f, _stat_property(_f))
del _f


DISPATCH_STATS = DispatchStats()


# --------------------------------------------------------------------------- #
# Flat scratch reuse (the host lane's CSR staging)                             #
# --------------------------------------------------------------------------- #
# requests above this many flat slots get one-off arrays instead of the
# cached scratch: one huge result set must not pin GBs of staging memory in
# a thread for the rest of the process
_SCRATCH_CACHE_MAX = 1 << 24


class _FlatScratch(threading.local):
    """Grow-only per-thread staging buffers for the host lane's flat CSR.

    The scratch grows monotonically (up to `_SCRATCH_CACHE_MAX` slots) and
    is reused across calls; results are copied out at their exact size, so
    callers own their arrays.
    """

    ids: np.ndarray | None = None
    dh: np.ndarray | None = None

    def take(self, cap: int) -> tuple[np.ndarray, np.ndarray, bool]:
        """(ids, dh, owned) filled with -1 / +BIG: ``owned`` means the
        arrays are one-off (past the cache cap) and the caller may hand out
        trimmed views instead of copying them."""
        if cap > _SCRATCH_CACHE_MAX:
            return (np.full(cap, -1, np.int64),
                    np.full(cap, np.float32(_ops.BIG), np.float32), True)
        if self.ids is None or self.ids.size < cap:
            self.ids = np.empty(cap, np.int64)
            self.dh = np.empty(cap, np.float32)
        ids, dh = self.ids[:cap], self.dh[:cap]
        ids.fill(-1)
        dh.fill(np.float32(_ops.BIG))
        return ids, dh, False


_SCRATCH = _FlatScratch()


def _out_of_scratch(indptr, counts, flat_ids, flat_dh, owned: bool,
                    total: int):
    """The CSR quadruple at its exact size: trimmed views of one-off
    arrays, copies out of the reusable scratch."""
    if owned:
        return indptr, counts, flat_ids[:total], flat_dh[:total]
    return indptr, counts, flat_ids[:total].copy(), flat_dh[:total].copy()


def _host_only(dev: torch.device) -> None:
    """The host lane runs on CPU tensors only: it never reroutes a CUDA
    tensor to a plain version."""
    if dev.type != "cpu":
        raise ValueError(
            f"oracle=True runs the host executors on CPU tensors; these are "
            f"on {dev} (every device lane takes the stacked executor)")


def _host(a) -> torch.Tensor:
    """A host numpy operand as a CPU float32 tensor (no copy when it is
    contiguous float32 already)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


# --------------------------------------------------------------------------- #
# Segments                                                                     #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Segment:
    """One contiguous alpha-sorted run, padded and on its device.

    Attributes:
      xs, alphas, half_norms: padded float32 tensors (rows to a block
        multiple with +BIG sentinels, features to the 128-lane multiple).
      ids: (n,) host int64 original row ids of the local sorted positions;
        sentinel rows inside ``n`` carry -1 and never survive the predicate.
      alpha_lo/alpha_hi: range of the real alphas, the segment-level window
        prune (lo > hi for an all-sentinel segment: always skipped).
      block: the row-block size the arrays were padded to (the kernels' bn).
      projs: optional (ke, n_pad) EXTRA projection components (+BIG in
        padding and sentinel columns) for the k-dim box prune.
      proj_lo/proj_hi: (ke,) float64 real ranges per component.
      xnorm_max: max real row norm (float64), the host box slack's scale.
      proj_sorted/proj_rank: (ke, n_pad) host float64 sorted component
        values and the matching local positions, the host lane's
        interval-to-rows lookup (`sorted_projs`, made on first use).
    """

    xs: torch.Tensor
    alphas: torch.Tensor
    half_norms: torch.Tensor
    ids: np.ndarray
    alpha_lo: float
    alpha_hi: float
    block: int
    projs: torch.Tensor | None = None
    proj_lo: np.ndarray | None = None
    proj_hi: np.ndarray | None = None
    xnorm_max: float = 0.0
    proj_sorted: np.ndarray | None = None
    proj_rank: np.ndarray | None = None

    @property
    def n(self) -> int:
        return self.ids.shape[0]

    def sorted_projs(self) -> tuple[np.ndarray, np.ndarray]:
        """(proj_sorted, proj_rank), built on first use."""
        if self.proj_sorted is None:
            pj = self.projs.cpu().numpy()
            self.proj_sorted = np.sort(pj.astype(np.float64), axis=1)
            self.proj_rank = np.argsort(pj, axis=1,
                                        kind="stable").astype(np.int64)
        return self.proj_sorted, self.proj_rank

    @property
    def ke(self) -> int:
        """Number of extra projection components carried (0 = none)."""
        return 0 if self.projs is None else int(self.projs.shape[0])


def make_segment(xs, alphas, half_norms, ids, *, block: int = 512,
                 projs=None, device=None) -> Segment:
    """Pad one sorted run for the kernels and record its real ranges.

    ``xs``/``alphas``/``half_norms`` (and ``projs``, the optional (ke, n)
    EXTRA components) are tensors or arrays; the padded copies live on
    ``device`` (default: the device of ``xs``).  Projection columns of
    padding and sentinel rows hold +BIG, so no box interval selects them.
    """
    dev = torch.device(device) if device is not None else (
        xs.device if isinstance(xs, torch.Tensor) else torch.device("cpu"))

    def on_dev(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dev)

    xs_t, al_t, hn_t = on_dev(xs), on_dev(alphas), on_dev(half_norms)
    xs_p, al_p, hn_p, _, _ = _ops.pad_database(xs_t, al_t, hn_t, bn=block)
    al_host = al_t.cpu().numpy()
    realm = al_host < _REAL
    real = al_host[realm]
    lo = float(real[0]) if real.size else float("inf")
    hi = float(real[-1]) if real.size else float("-inf")
    pj = plo = phi = None
    xnorm_max = 0.0
    if projs is not None:
        big = np.float32(_ops.BIG)
        pj_np = np.asarray(torch.as_tensor(projs, dtype=torch.float32).cpu())
        pj_np = np.where(realm[None, :], pj_np, big)
        n_pad = int(al_p.shape[0])
        pj_full = np.concatenate(
            [pj_np, np.full((pj_np.shape[0], n_pad - pj_np.shape[1]), big,
                            np.float32)], axis=1)
        pj = torch.from_numpy(np.ascontiguousarray(pj_full)).to(dev)
        if realm.any():
            p64 = pj_np[:, realm].astype(np.float64)
            plo, phi = p64.min(axis=1), p64.max(axis=1)
            hn_real = hn_t.cpu().numpy().astype(np.float64)[realm]
            xnorm_max = float(np.sqrt(max(2.0 * float(hn_real.max()), 0.0)))
        else:
            plo = np.full(pj_np.shape[0], np.inf)
            phi = np.full(pj_np.shape[0], -np.inf)
    return Segment(xs_p, al_p, hn_p, np.asarray(ids, np.int64), lo, hi, block,
                   pj, plo, phi, xnorm_max)


def _index_extra_projs(index):
    """The (ke, n) EXTRA projection rows of an index, or None (single-PC)."""
    pj = getattr(index, "projs", None)
    if pj is None or pj.shape[0] <= 1:
        return None
    return pj[1:]


def segment_from_index(index, *, block: int = 512, device=None) -> Segment:
    """The whole of one `SNNIndex` as a segment on ``device``."""
    return make_segment(index.xs, index.alphas, index.half_norms, index.order,
                        block=block, projs=_index_extra_projs(index),
                        device=device)


def segments_from_index(index, *, rows_per_segment: int, block: int = 512,
                        ids: np.ndarray | None = None,
                        device=None) -> list[Segment]:
    """Partition one index's sorted rows into contiguous equal-size segments.

    Segment k covers sorted rows ``[k * rows_per_segment, (k+1) *
    rows_per_segment)``, so a query batch with a narrow alpha footprint (the
    sorted query chunks of `core.graph`'s self-join) pays only for the
    segments its windows meet, and segment-major engine output stays in
    ascending sorted order.  ``ids`` overrides the per-row id map (default
    ``index.order``, the original row ids; ``np.arange(n)`` gives sorted
    positions, the representation of the symmetric self-join).  The
    segments live on ``device`` (default: the index's own).
    """
    n = index.n
    ids = index.order if ids is None else np.asarray(ids, np.int64)
    rs = max(int(rows_per_segment), 1)
    ep = _index_extra_projs(index)
    return [make_segment(index.xs[s:s + rs], index.alphas[s:s + rs],
                         index.half_norms[s:s + rs], ids[s:s + rs],
                         block=block,
                         projs=None if ep is None else ep[:, s:s + rs],
                         device=device)
            for s in range(0, n, rs)]


def _qnorm64(rp, thp, m: int) -> np.ndarray:
    """(m,) float64 query norms recovered from the predicate pair, through
    the kernels' own float32 expression first (`ref.norm_scales`)."""
    r32 = np.asarray(rp, np.float32)[:m]
    t32 = np.asarray(thp, np.float32)[:m]
    with np.errstate(over="ignore", invalid="ignore"):
        qn = np.sqrt(np.maximum(r32 * r32 - np.float32(2.0) * t32,
                                np.float32(0.0)))
    return qn.astype(np.float64)


def _box_interval_radius(r64, qn64, xnorm_max) -> np.ndarray:
    """Float64 SUPERSET of the kernels' per-pair box slack: the segment-wide
    ``xnorm_max`` bounds every row norm, and the 1e-6 relative inflation
    (+1e-30 absolute) dominates every float32 rounding of the device test."""
    return (r64 + _ref.BOX_EPS * (xnorm_max + qn64 + np.abs(r64))) \
        * (1.0 + 1e-6) + 1e-30


def _window_may_hit(seg: Segment, aq: np.ndarray, r: np.ndarray,
                    pq: np.ndarray | None = None,
                    qn: np.ndarray | None = None) -> bool:
    """Can ANY query window (and, with ``pq``/``qn``, box) touch ``seg``?

    The kernels test ``|alpha - aq| <= r`` in float32; a few-ulp slack on
    the float64 host comparison makes sure a skipped segment never holds a
    pair the kernels would keep.  ``pq`` is (kq, m) float64 extra query
    projections and ``qn`` their `_qnorm64` norms.
    """
    if seg.alpha_lo > seg.alpha_hi or aq.size == 0:
        return False
    slack = 1e-6 * (np.abs(aq) + np.abs(r)
                    + max(abs(seg.alpha_lo), abs(seg.alpha_hi)) + 1.0)
    hit = ((aq + r + slack >= seg.alpha_lo)
           & (aq - r - slack <= seg.alpha_hi))
    if pq is not None and seg.ke:
        kq = min(pq.shape[0], seg.ke)
        R = _box_interval_radius(r, qn, seg.xnorm_max)
        for c in range(kq):
            hit &= ((pq[c] + R >= seg.proj_lo[c])
                    & (pq[c] - R <= seg.proj_hi[c]))
    return bool(np.any(hit))


def run_csr(segments: list[Segment], qp, aqp, rp, thp, m: int, *,
            query_tile: int = 128, memory_budget_mb: float | None = None,
            pq=None, mixed: bool = False, oracle: bool = False):
    """The two-pass LOOPED orchestration over padded queries and segments.

    One count launch and one host sync per live segment, the prefix sums on
    the host, then one compact launch per live segment with survivors: the
    cross-check of `run_csr_packed`, on the same kernels at S = 1.  Each
    segment's pass-1 per-row-block counts go to its pass 2, which then
    needs no recount to place its writes.  On segments that live on the CPU
    the two passes run as their plain versions (`kernels.ref`).

    Args:
      segments: alpha-sorted runs (see `Segment`) on one device; they need
        not be disjoint.
      qp/aqp/rp/thp: `kernels.ops.pad_queries` outputs (host arrays).
      m: real (unpadded) query count.
      memory_budget_mb: the host lane's cache ceiling (ignored off it).
        Pass-1 dense filters are kept for pass 2 only while their sum stays
        under the budget; a segment past it evaluates the same filter again
        in pass 2, one more evaluation for bounded peak memory.  Each kept
        filter is released right after its scatter.
      pq: optional (kq, m_pad) padded extra query projections; the box
        prune uses ``min(kq, min segment ke)`` components.
      mixed: pass 1 counts with the certified bf16 product; pass 2 always
        decides in float32, and the final check enforces the certificate.
        The host lane reuses one float32 filter for both passes.
      oracle: run the host lane (one dense filter a segment feeds both
        passes) on CPU segments; raises on segments on the card.

    Returns ``(indptr (m+1,) int64, counts (m,) int64, flat_ids (nnz,) int64,
    flat_dh (nnz,) float32)``; ``flat_ids`` are the segments' ids in
    segment-major, locally ascending order within each row.
    """
    aq64 = np.asarray(aqp, np.float64)[:m]
    r64 = np.asarray(rp, np.float64)[:m]
    kq = 0
    if pq is not None and segments:
        kq = min([s.ke for s in segments] + [int(np.asarray(pq).shape[0])])
    pq_np = pq64 = qn64 = None
    if kq:
        pq_np = np.ascontiguousarray(np.asarray(pq, np.float32)[:kq])
        pq64 = pq_np[:, :m].astype(np.float64)
        qn64 = _qnorm64(rp, thp, m)
    dev = segments[0].xs.device if segments else torch.device("cpu")
    if oracle:
        _host_only(dev)
    qd, aqd, rd, thd = (torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, np.float32))).to(dev)
        for a in (qp, aqp, rp, thp))
    pqd = None if pq_np is None else torch.from_numpy(pq_np).to(dev)
    args = (qd, aqd, rd, thd)
    budget = (float("inf") if memory_budget_mb is None
              else memory_budget_mb * 2**20)

    def _px(seg):
        if not kq:
            return None
        return seg.projs if seg.ke == kq else seg.projs[:kq].contiguous()

    def _filter(seg):
        return _registry.snn_filter(*args, seg.xs, seg.alphas,
                                    seg.half_norms, pqd, _px(seg),
                                    bn=seg.block).numpy()[:m]

    # ---- pass 1: per-segment counts, one launch + one sync each ----------
    per = np.zeros((len(segments), m), np.int64)
    partials: dict[int, torch.Tensor] = {}
    cached: dict[int, np.ndarray] = {}
    cached_bytes = 0
    live: list[int] = []
    for k, seg in enumerate(segments):
        if not _window_may_hit(seg, aq64, r64, pq64, qn64):
            continue
        live.append(k)
        DISPATCH_STATS.kernel_launches += 1
        DISPATCH_STATS.host_transfers += 1
        if oracle:
            # one dense filter feeds both passes; np.nonzero's row-major
            # order is the CSR order
            dh = _filter(seg)
            if cached_bytes + dh.nbytes <= budget:
                cached[k] = dh
                cached_bytes += dh.nbytes
            per[k] = (dh < _ops.BIG).sum(axis=1)
            continue
        cnt, partials[k] = _registry.snn_count(
            *args, seg.xs, seg.alphas, seg.half_norms, pqd, _px(seg),
            bn=seg.block, mixed=mixed, with_partials=True)
        per[k] = cnt.cpu().numpy()[:m]

    # ---- host prefix sums: global indptr + per-segment write bases -------
    counts = per.sum(axis=0)
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    total = int(indptr[-1])
    if total == 0:
        return indptr, counts, np.zeros(0, np.int64), np.zeros(0, np.float32)
    seg_base = np.cumsum(per, axis=0) - per  # exclusive prefix over segments

    # ---- pass 2: per-segment compaction into disjoint flat slots ---------
    cap = _ops.csr_capacity(total)
    if oracle:
        flat_ids, flat_dh, owned = _SCRATCH.take(cap)
    else:
        flat_ids = np.full(cap, -1, np.int64)
        flat_dh = np.full(cap, np.float32(_ops.BIG), np.float32)
    off_pad = np.full(int(np.shape(qp)[0]) - m, total, np.int64)
    for k in live:
        part = partials.pop(k, None)
        if not per[k].any():
            cached.pop(k, None)
            continue
        seg = segments[k]
        if oracle:
            dh = cached.pop(k, None)
            if dh is None:  # past the budget: the same filter, again
                DISPATCH_STATS.kernel_launches += 1
                DISPATCH_STATS.host_transfers += 1
                dh = _filter(seg)
            rows, cols = np.nonzero(dh < _ops.BIG)
            # np.nonzero is row-major: a survivor's rank in its row is its
            # place after the row's first survivor (O(nnz), no dense scan)
            first = np.zeros(m, np.int64)
            np.cumsum(per[k][:-1], out=first[1:])
            within = np.arange(rows.size, dtype=np.int64) - first[rows]
            slots = indptr[rows] + seg_base[k][rows] + within
            flat_ids[slots] = seg.ids[cols]
            flat_dh[slots] = dh[rows, cols]
            continue
        off_k = torch.from_numpy(np.concatenate(
            [indptr[:-1] + seg_base[k], off_pad]).astype(np.int32)).to(dev)
        DISPATCH_STATS.kernel_launches += 1
        DISPATCH_STATS.host_transfers += 2
        fi, fd = _registry.snn_compact(
            *args, off_k, seg.xs, seg.alphas, seg.half_norms, pqd, _px(seg),
            nnz=cap, bn=seg.block, partials=part)
        fi = fi.cpu().numpy()
        written = fi >= 0
        flat_ids[written] = seg.ids[fi[written]]
        flat_dh[written] = fd.cpu().numpy()[written]
    # both passes ran the same predicate, so every slot is written; a -1
    # would silently alias a wrong row, so fail loudly
    if not (flat_ids[:total] >= 0).all():
        raise RuntimeError("CSR pass-1/pass-2 disagreement (looped)")
    if oracle:
        return _out_of_scratch(indptr, counts, flat_ids, flat_dh, owned,
                               total)
    return indptr, counts, flat_ids[:total], flat_dh[:total]


# --------------------------------------------------------------------------- #
# Static memory planning                                                       #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """Static buffer-size ledger for one (pack, query-bucket) combination.

    ``buffers`` maps each buffer the device executor touches to (name,
    shape, dtype, nbytes), sized from the pack geometry, the bucketed batch
    size and the worst-case survivor count; the total lands in
    ``DISPATCH_STATS.bytes_planned`` when the plan is first built.
    ``staging_cap`` is the host lane's flat staging ceiling: the worst-case
    capacity clamped to `_SCRATCH_CACHE_MAX` (past it the lane uses one-off
    arrays by design).  The staging is host memory, so it is not among the
    device buffers.
    """

    m_pad: int
    query_tile: int
    buffers: tuple
    total_bytes: int
    staging_cap: int = 0

    def reserve(self) -> None:
        """Pre-grow this thread's flat staging (`_FlatScratch`) to the
        plan's ceiling, so no later host-lane batch of this plan's bucket
        reallocates it in this thread."""
        if 0 < self.staging_cap <= _SCRATCH_CACHE_MAX:
            _SCRATCH.take(self.staging_cap)


def _build_memory_plan(pack: "SegmentPack", m_pad: int,
                       query_tile: int) -> MemoryPlan:
    """Derive every device-executor buffer size from the pack geometry."""
    S = pack.n_segments
    n_pad = pack.n_pad
    d_pad = int(pack.segments[0].xs.shape[1]) if pack.segments else 0
    ke = pack.ke
    nb = n_pad // pack.block if pack.block else 0
    n_real = int(sum(s.n for s in pack.segments))
    bufs: list[tuple] = []

    def add(name, shape, dtype):
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        bufs.append((name, tuple(int(v) for v in shape),
                     np.dtype(dtype).name, int(nbytes)))

    # device-resident pack representations (once per plan)
    add("stacked_xs", (S, n_pad, d_pad), np.float32)
    add("stacked_alphas", (S, n_pad), np.float32)
    add("stacked_half_norms", (S, n_pad), np.float32)
    add("stacked_ids", (S, n_pad), np.int64)
    if ke:
        add("stacked_projs", (S, ke, n_pad), np.float32)
    # per-batch query operands at the bucketed size
    add("queries", (m_pad, d_pad), np.float32)
    add("query_alpha", (m_pad,), np.float32)
    add("query_radius", (m_pad,), np.float32)
    add("query_thresh", (m_pad,), np.float32)
    if ke:
        add("query_projs", (ke, m_pad), np.float32)
    # pass-boundary buffers: counts, per-row-block partials, prefix sums
    add("counts", (S, m_pad), np.int32)
    add("partials", (S, m_pad, nb), np.int32)
    add("indptr", (m_pad + 1,), np.int32)
    add("offsets", (S, m_pad), np.int32)
    # flat CSR outputs: worst case = every real row survives for every query
    nnz_cap = _ops.csr_capacity(m_pad * max(n_real, 0) + 1)
    add("csr_flat_idx", (nnz_cap,), np.int32)
    add("csr_flat_dh", (nnz_cap,), np.float32)
    total = sum(b[3] for b in bufs)
    return MemoryPlan(int(m_pad), int(query_tile), tuple(bufs), int(total),
                      int(min(nnz_cap, _SCRATCH_CACHE_MAX)))


# --------------------------------------------------------------------------- #
# The packed plan                                                              #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class SegmentPack:
    """A device-resident execution plan: every segment of an index, stacked.

    Two representations are built lazily, because each executor wants its
    own and most deployments only touch one:

    * **stacked** (`stacked()`): every segment padded to the pack-wide row
      count ``n_pad`` and stacked into (S, n_pad, d_pad) tensors, what the
      stacked kernels read;
    * **concat** (`concat()`): the segments' own padded rows concatenated
      ragged into (sum n_pad_k, d_pad), what the host lane reads.  No
      uniform padding: a streaming index whose base dwarfs its deltas would
      otherwise pay S x base rows of dense-filter work.

    Attributes:
      segments: the source per-segment views.
      alpha_lo / alpha_hi: (S,) float64 real alpha ranges, the inputs of the
        vectorized interval-overlap prune (`live_mask`).
      block: the row-block size every segment was padded to.
      epoch: the plan's generation (`extend` bumps it).
      ke: extra projection components shared by every segment (0 when any
        segment lacks them).
      proj_lo / proj_hi: (S, ke) float64 per-segment real component ranges;
        xnorm_max: (S,) float64 per-segment max row norms (None if ke == 0).
    """

    segments: list[Segment]
    alpha_lo: np.ndarray
    alpha_hi: np.ndarray
    block: int
    epoch: int = 0
    ke: int = 0
    proj_lo: np.ndarray | None = None
    proj_hi: np.ndarray | None = None
    xnorm_max: np.ndarray | None = None
    _stacked: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _stacked_px: torch.Tensor | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _concat: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _concat_px: torch.Tensor | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # the host lane's sentinel-extended candidate operands, by (live set,
    # kq); at most 8 entries (`_pruned_setup`)
    _pruned: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _plans: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # capacity speculation of the fused path: (m_pad, query_tile, live set,
    # kq) -> {"nnz_cap": ..., "total": the largest total seen}; dies with
    # the pack
    _spec: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # totals expected from a predecessor plan's batches: (m_pad,
    # query_tile, kq) -> pairs (`adopt_spec`), a capacity floor for every
    # live set of that bucket
    _spec_hint: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def n_pad(self) -> int:
        """Padded rows of the largest segment (the stacked row count)."""
        return max((s.xs.shape[0] for s in self.segments), default=0)

    @property
    def device(self) -> torch.device:
        return (self.segments[0].xs.device if self.segments
                else torch.device("cpu"))

    @classmethod
    def build(cls, segments: list[Segment], *,
              epoch: int = 0) -> "SegmentPack":
        """Plan over ``segments`` (uniform block, lane padding and device)."""
        segments = list(segments)
        if segments:
            block = segments[0].block
            d_pad = segments[0].xs.shape[1]
            dev = segments[0].xs.device
            for s in segments:
                if s.block != block or s.xs.shape[1] != d_pad \
                        or s.xs.device != dev:
                    raise ValueError("SegmentPack needs uniform block, lane "
                                     "padding and device across segments")
        else:
            block = 0
        lo = np.asarray([s.alpha_lo for s in segments], np.float64)
        hi = np.asarray([s.alpha_hi for s in segments], np.float64)
        ke = min((s.ke for s in segments), default=0)
        plo = phi = xnm = None
        if ke:
            plo = np.stack([np.asarray(s.proj_lo[:ke], np.float64)
                            for s in segments])
            phi = np.stack([np.asarray(s.proj_hi[:ke], np.float64)
                            for s in segments])
            xnm = np.asarray([s.xnorm_max for s in segments], np.float64)
        return cls(segments, lo, hi, block, epoch, ke, plo, phi, xnm)

    def memory_plan(self, m_pad: int, query_tile: int = 128) -> MemoryPlan:
        """The static `MemoryPlan` for a bucketed batch size (memoized; the
        first build accounts its bytes in ``DISPATCH_STATS.bytes_planned``)."""
        key = (int(m_pad), int(query_tile))
        hit = self._plans.get(key)
        if hit is not None:
            return hit
        plan = _build_memory_plan(self, int(m_pad), int(query_tile))
        self._plans[key] = plan
        DISPATCH_STATS.bytes_planned += plan.total_bytes
        return plan

    def planned_bytes(self) -> int:
        """Total bytes of every `MemoryPlan` built on this pack so far: the
        device-memory cost of admitting the plan (its stacked operands plus
        every bucketed batch shape it has served); zero until the first
        query or warm builds one."""
        return sum(p.total_bytes for p in self._plans.values())

    def adopt_spec(self, prev: "SegmentPack") -> None:
        """Inherit ``prev``'s batch totals as capacity hints (the
        double-buffered epoch handoff: the next plan serves the same
        workload, so the pairs its predecessor's batches held are the
        right opening speculation; a real overflow still ratchets).

        A plan over more rows holds more pairs for the same queries, so
        each total grows with the row count: an append of a few percent
        must not overflow a capacity learned to within a few percent.
        """
        rows = sum(s.n for s in self.segments)
        grow = max(rows / max(sum(s.n for s in prev.segments), 1), 1.0)

        def take(key, total):
            if total:
                total = int(np.ceil(total * grow))
                self._spec_hint[key] = max(self._spec_hint.get(key, 0), total)

        for key, total in prev._spec_hint.items():
            take(key, total)
        for (m_pad, tile, _live, kq), rec in prev._spec.items():
            take((m_pad, tile, kq), rec.get("total", 0))

    def stacked(self):
        """(xs (S, n_pad, d), alphas (S, n_pad), half_norms (S, n_pad),
        ids (S, n_pad) host int64 with -1 padding), built on first use; a
        single-segment pack is a view of its segment, not a copy."""
        if self._stacked is None:
            dev = self.device
            if not self.segments:
                z2 = torch.zeros((0, 0), dtype=torch.float32, device=dev)
                return (torch.zeros((0, 0, 0), dtype=torch.float32,
                                    device=dev), z2, z2,
                        np.zeros((0, 0), np.int64))
            if len(self.segments) == 1:
                s = self.segments[0]
                self._stacked = (s.xs[None], s.alphas[None],
                                 s.half_norms[None], _stack_ids(
                                     self.segments, self.n_pad))
            else:
                self._stacked = _stack(self.segments, self.n_pad)
        return self._stacked

    def stacked_projs(self) -> torch.Tensor | None:
        """(S, ke, n_pad) extra projections stacked to match `stacked()`
        (+BIG in the uniform padding), or None when ``ke == 0``."""
        if not self.ke:
            return None
        if self._stacked_px is None:
            if len(self.segments) == 1:
                self._stacked_px = self.segments[0].projs[:self.ke][None]
            else:
                self._stacked_px = _stack_projs(self.segments, self.ke,
                                                self.n_pad)
        return self._stacked_px

    def concat(self):
        """(xs (N, d_pad), alphas (N,), half_norms (N,), ids (N,) host
        int64 with -1 in padding rows, starts (S+1,) host row offsets): the
        ragged host-lane representation, built on first use (no copy for a
        single-segment pack)."""
        if self._concat is None:
            segs = self.segments
            dev = self.device
            if not segs:
                z1 = torch.zeros(0, dtype=torch.float32, device=dev)
                return (torch.zeros((0, 0), dtype=torch.float32, device=dev),
                        z1, z1, np.zeros(0, np.int64), np.zeros(1, np.int64))
            starts = np.zeros(len(segs) + 1, np.int64)
            np.cumsum([s.xs.shape[0] for s in segs], out=starts[1:])
            if len(segs) == 1:
                xs, al, hn = segs[0].xs, segs[0].alphas, segs[0].half_norms
            else:
                xs = torch.cat([s.xs for s in segs])
                al = torch.cat([s.alphas for s in segs])
                hn = torch.cat([s.half_norms for s in segs])
            ids = np.full(int(starts[-1]), -1, np.int64)
            for k, s in enumerate(segs):
                ids[starts[k]:starts[k] + s.n] = s.ids
            self._concat = (xs, al, hn, ids, starts)
        return self._concat

    def concat_projs(self) -> torch.Tensor | None:
        """(ke, sum n_pad_k) extra projections in `concat()`'s row order,
        or None when ``ke == 0``."""
        if not self.ke:
            return None
        if self._concat_px is None:
            self._concat_px = torch.cat(
                [s.projs[:self.ke] for s in self.segments], dim=1)
        return self._concat_px

    def extend(self, new_segments: list[Segment]) -> "SegmentPack":
        """A NEW plan with ``new_segments`` appended (the next epoch).

        The streaming index's append path: stacked and concat operands
        already built on this plan are extended by one concatenation each
        with the new segments' rows (the base's are reused, not padded
        again); operands not built yet stay lazy.  The receiver is never mutated:
        the owner publishes the returned plan in one snapshot swap.
        """
        if not new_segments:
            return self
        new_segments = list(new_segments)
        # build() validates block, lane padding and device over the lot
        out = SegmentPack.build(self.segments + new_segments,
                                epoch=self.epoch + 1)
        if self._concat is not None:
            tail = SegmentPack.build(new_segments).concat()
            xs, al, hn, ids, starts = self._concat
            out._concat = (torch.cat([xs, tail[0]]), torch.cat([al, tail[1]]),
                           torch.cat([hn, tail[2]]),
                           np.concatenate([ids, tail[3]]),
                           np.concatenate([starts, starts[-1] + tail[4][1:]]))
        if out.n_pad != self.n_pad:
            return out  # a wider slab: every stacked row count changes
        if self._stacked is not None:
            xs, al, hn, ids = self._stacked
            txs, tal, thn, tids = _stack(new_segments, self.n_pad)
            out._stacked = (torch.cat([xs, txs]), torch.cat([al, tal]),
                            torch.cat([hn, thn]),
                            np.concatenate([ids, tids]))
        if self._stacked_px is not None and out.ke == self.ke:
            out._stacked_px = torch.cat(
                [self._stacked_px,
                 _stack_projs(new_segments, self.ke, self.n_pad)])
        return out

    def live_mask(self, aq: np.ndarray, r: np.ndarray,
                  pq: np.ndarray | None = None,
                  qn: np.ndarray | None = None) -> np.ndarray:
        """Which segments can any query window (and box) touch?  One (S, m)
        float64 broadcast with a few-ulp slack, so a skipped segment never
        holds a pair the kernels would keep."""
        S = self.n_segments
        if S == 0 or aq.size == 0:
            return np.zeros(S, bool)
        nonempty = self.alpha_lo <= self.alpha_hi
        amax = np.maximum(np.abs(self.alpha_lo), np.abs(self.alpha_hi))
        amax = np.where(nonempty, amax, 0.0)  # keep the slack finite
        slack = 1e-6 * ((np.abs(aq) + np.abs(r))[None, :]
                        + amax[:, None] + 1.0)
        hit = ((aq[None, :] + r[None, :] + slack >= self.alpha_lo[:, None])
               & (aq[None, :] - r[None, :] - slack <= self.alpha_hi[:, None]))
        if pq is not None and self.ke:
            kq = min(int(pq.shape[0]), self.ke)
            R = _box_interval_radius(r[None, :], qn[None, :],
                                     self.xnorm_max[:, None])  # (S, m)
            for c in range(kq):
                hit &= ((pq[c][None, :] + R >= self.proj_lo[:, c:c + 1])
                        & (pq[c][None, :] - R <= self.proj_hi[:, c:c + 1]))
        return hit.any(axis=1) & nonempty


def _stack_ids(segments: list[Segment], n_pad: int) -> np.ndarray:
    """(S, n_pad) host int64 ids of ``segments``, -1 in the padding."""
    ids = np.full((len(segments), n_pad), -1, np.int64)
    for k, s in enumerate(segments):
        ids[k, :s.n] = s.ids
    return ids


def _stack(segments: list[Segment], n_pad: int):
    """(xs (S, n_pad, d_pad), alphas (S, n_pad), half_norms (S, n_pad),
    ids (S, n_pad)) of ``segments``, each padded to ``n_pad`` rows (zero
    features, +BIG alpha and half norm, -1 id)."""
    dev = segments[0].xs.device
    S, d_pad = len(segments), segments[0].xs.shape[1]
    xs = torch.zeros((S, n_pad, d_pad), dtype=torch.float32, device=dev)
    al = torch.full((S, n_pad), _ops.BIG, dtype=torch.float32, device=dev)
    hn = torch.full((S, n_pad), _ops.BIG, dtype=torch.float32, device=dev)
    for k, s in enumerate(segments):
        rows = s.xs.shape[0]
        xs[k, :rows] = s.xs
        al[k, :rows] = s.alphas
        hn[k, :rows] = s.half_norms
    return xs, al, hn, _stack_ids(segments, n_pad)


def _stack_projs(segments: list[Segment], ke: int, n_pad: int) -> torch.Tensor:
    """(S, ke, n_pad) first ``ke`` extra projections of ``segments``, +BIG
    in the padding."""
    px = torch.full((len(segments), ke, n_pad), _ops.BIG,
                    dtype=torch.float32, device=segments[0].xs.device)
    for k, s in enumerate(segments):
        px[k, :, :s.projs.shape[1]] = s.projs[:ke]
    return px


def pack_from_index(index, *, block: int = 512, device=None,
                    epoch: int = 0) -> SegmentPack:
    """The whole of one index as a single-segment plan on ``device``."""
    return SegmentPack.build([segment_from_index(index, block=block,
                                                 device=device)],
                             epoch=epoch)


def _live_idx(pack: SegmentPack, aqp, rp, m: int, first_seg: int = 0,
              pq64: np.ndarray | None = None,
              qn64: np.ndarray | None = None) -> np.ndarray:
    """Which segments are live?  `run_csr_packed` and `run_counts_packed`
    share this decision, so counts predict the CSR rows exactly.  Segments
    before ``first_seg`` are never live (the triangular schedule)."""
    aq64 = np.asarray(aqp, np.float64)[:m]
    r64 = np.asarray(rp, np.float64)[:m]
    mask = pack.live_mask(aq64, r64, pq64, qn64)
    if first_seg:
        mask[:first_seg] = False
    return np.nonzero(mask)[0]


def _gather_live_stacked(pack: SegmentPack, live_idx: np.ndarray, kq: int):
    """(xs, alphas, half_norms, ids, projs) of the live slabs from the
    pack's stacked rep (no copy when every segment is live); ``projs`` holds
    the first ``kq`` extra components, or is None when ``kq == 0``."""
    xs, al, hn, ids = pack.stacked()
    px = pack.stacked_projs()[:, :kq].contiguous() if kq else None
    if live_idx.size < pack.n_segments:
        sel = torch.as_tensor(live_idx, device=xs.device)
        xs, al, hn = xs[sel], al[sel], hn[sel]
        ids = ids[live_idx]
        if px is not None:
            px = px[sel]
    return xs, al, hn, ids, px


def _query_operands(pack: SegmentPack, m: int, qp, aqp, rp, thp, pq):
    """The host query operands, the effective component count and its
    float64 box inputs, and the operands moved to the pack's device."""
    qp, aqp, rp, thp = (np.asarray(a, np.float32) for a in (qp, aqp, rp, thp))
    kq = 0
    if pq is not None and pack.ke:
        kq = min(pack.ke, int(np.asarray(pq).shape[0]))
    pq_np = pq64 = qn64 = None
    if kq:
        pq_np = np.ascontiguousarray(np.asarray(pq, np.float32)[:kq])
        pq64 = pq_np[:, :m].astype(np.float64)
        qn64 = _qnorm64(rp, thp, m)
    dev = pack.device
    on_dev = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (qp, aqp, rp, thp)]
    pq_t = None if pq_np is None else torch.from_numpy(pq_np).to(dev)
    return (qp, aqp, rp, thp), kq, pq64, qn64, (*on_dev, pq_t)


# --------------------------------------------------------------------------- #
# The host lane: candidate generation and the pruned / compacted executors     #
# --------------------------------------------------------------------------- #
def _gather_live_concat(pack: SegmentPack, live_idx: np.ndarray,
                        with_px: bool = False):
    """(xs, alphas, half_norms, ids, sizes[, projs]) of the live segments'
    rows from the pack's concat rep (no copy when every segment is live).
    ``with_px`` appends the matching (ke, rows) projections (None when the
    pack has no extra components)."""
    xs_c, al_c, hn_c, ids_c, starts_c = pack.concat()
    px_c = pack.concat_projs() if with_px else None
    if live_idx.size == pack.n_segments:
        out = (xs_c, al_c, hn_c, ids_c, np.diff(starts_c))
        return out + (px_c,) if with_px else out
    sizes = np.diff(starts_c)[live_idx]
    rows_sel = np.concatenate(
        [np.arange(starts_c[k], starts_c[k + 1]) for k in live_idx])
    sel = torch.from_numpy(rows_sel)
    out = (xs_c[sel], al_c[sel], hn_c[sel], ids_c[rows_sel], sizes)
    if with_px:
        return out + (None if px_c is None else px_c[:, sel],)
    return out


def _tile_candidates(pack: SegmentPack, live_idx: np.ndarray,
                     starts_l: np.ndarray, al_np: np.ndarray,
                     t0: int, tm: int, aq64, r64, pq64, qn64) -> np.ndarray:
    """Concat-row candidate columns for the query tile ``[t0, t0 + tm)``.

    The host mirror of the kernels' conjunctive box test: per live segment,
    a diff-array union of the tile's per-query float64 intervals over the
    segment's sorted alphas (component 0), intersected with the rank-space
    interval unions of every extra component (`Segment.sorted_projs`).
    Every interval is a superset of the float32 device predicate
    (`_box_interval_radius`; component 0 needs only the relative inflation,
    as a correctly rounded subtraction has bounded relative error), so the
    columns cover every pair either pass could keep.  Ascending order
    (segments in pack order, local rows ascending) keeps the scatter in CSR
    order.
    """
    aq_t = aq64[t0:t0 + tm]
    r_t = r64[t0:t0 + tm]
    R0_t = r_t * (1.0 + 1e-6) + 1e-30
    qn_t = qn64[t0:t0 + tm]
    kq = pq64.shape[0]
    out = []
    for j, k in enumerate(live_idx):
        seg = pack.segments[k]
        if seg.alpha_lo > seg.alpha_hi:
            continue
        Rb_t = _box_interval_radius(r_t, qn_t, seg.xnorm_max)
        sel = (aq_t + R0_t >= seg.alpha_lo) & (aq_t - R0_t <= seg.alpha_hi)
        for c in range(kq):
            sel &= ((pq64[c, t0:t0 + tm] + Rb_t >= seg.proj_lo[c])
                    & (pq64[c, t0:t0 + tm] - Rb_t <= seg.proj_hi[c]))
        if not sel.any():
            continue
        s0, s1 = int(starts_l[j]), int(starts_l[j + 1])
        n_loc = s1 - s0
        al_loc = al_np[s0:s1]
        # component 0: intervals on the sorted alphas.  An empty interval
        # (kNN's r = -1 rows) marks its end before its start, and the
        # running sum never goes positive there
        lo_i = np.searchsorted(al_loc, aq_t[sel] - R0_t[sel], side="left")
        hi_i = np.searchsorted(al_loc, aq_t[sel] + R0_t[sel], side="right")
        mark = np.zeros(n_loc + 1, np.int64)
        np.add.at(mark, lo_i, 1)
        np.add.at(mark, hi_i, -1)
        inmask = np.cumsum(mark[:n_loc]) > 0
        proj_sorted, proj_rank = seg.sorted_projs()
        for c in range(kq):
            psc, prc = proj_sorted[c], proj_rank[c]
            pqc = pq64[c, t0:t0 + tm][sel]
            lo_i = np.searchsorted(psc, pqc - Rb_t[sel], side="left")
            hi_i = np.searchsorted(psc, pqc + Rb_t[sel], side="right")
            markc = np.zeros(n_loc + 1, np.int64)
            np.add.at(markc, lo_i, 1)
            np.add.at(markc, hi_i, -1)
            in_c = np.zeros(n_loc, bool)
            in_c[prc[np.cumsum(markc[:n_loc]) > 0]] = True
            inmask &= in_c
        cand_local = np.flatnonzero(inmask)
        if cand_local.size:
            out.append(s0 + cand_local)
    if not out:
        return np.zeros(0, np.int64)
    return np.concatenate(out)


def _pruned_setup(pack: SegmentPack, live_idx: np.ndarray, kq: int):
    """Shared prologue of the pruned and compacted host executors.

    Appends ONE +BIG sentinel row to the live concat rows: candidate
    padding points every unused slot at it, and no predicate keeps it.
    The result depends only on the pack, the live set and ``kq``, so it is
    memoized on the pack (at most 8 entries): repeated batches pay the
    O(N) concatenation once.  ``xs_t`` drops the trailing feature columns
    that are zero in every row (lane padding, zero in the queries too),
    whose +0.0 terms add nothing to a product.
    """
    key = (live_idx.tobytes(), kq)
    hit = pack._pruned.get(key)
    if hit is not None:
        return hit
    xs_c, al_c, hn_c, ids, sizes, px_c = _gather_live_concat(
        pack, live_idx, with_px=True)
    starts_l = np.zeros(live_idx.size + 1, np.int64)
    np.cumsum(sizes, out=starts_l[1:])
    al_np = al_c.numpy()
    big = np.float32(_ops.BIG)
    xs_s = np.concatenate([xs_c.numpy(),
                           np.zeros((1, xs_c.shape[1]), np.float32)])
    al_s = np.concatenate([al_np, np.full(1, big, np.float32)])
    hn_s = np.concatenate([hn_c.numpy(), np.full(1, big, np.float32)])
    px_s = np.concatenate([px_c[:kq].numpy(),
                           np.full((kq, 1), big, np.float32)], axis=1)
    nz = np.flatnonzero(np.any(xs_s != 0.0, axis=0))
    d_trim = int(nz[-1]) + 1 if nz.size else 1
    xs_t = np.ascontiguousarray(xs_s[:, :d_trim])
    out = (xs_s, al_s, hn_s, px_s, ids, starts_l, al_np, xs_t)
    if len(pack._pruned) >= 8:  # live sets vary per batch; bound the memo
        pack._pruned.clear()
    pack._pruned[key] = out
    return out


# The candidate tile of the host lane: the executors form PER-TILE interval
# unions across the tile's queries, so a wide tile (128 alpha-sorted queries
# over many clusters) inflates every union toward the whole database.
_PRUNED_TILE = 16


def _scatter_flat(m: int, m_pad: int, L: int, counts, rows, cols, dh_vals,
                  ids, starts_l, tag: str = "packed"):
    """The flat CSR of survivors given in row-major order (``rows`` query,
    ``cols`` concat row, ascending within a query): an O(nnz) group rank
    within each (query, segment) places every survivor at ``indptr[row] +
    (survivors of earlier segments) + (its rank)``."""
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    total = int(indptr[-1])
    if total == 0 and rows.size == 0:
        return indptr, counts, np.zeros(0, np.int64), np.zeros(0, np.float32)
    if rows.size != total:  # a broken mixed certificate fails loudly
        raise RuntimeError(f"CSR pass-1/pass-2 disagreement ({tag})")
    seg_of = np.searchsorted(starts_l, cols, side="right") - 1
    gk = rows * np.int64(L) + seg_of      # non-decreasing in nonzero order
    per = np.bincount(gk, minlength=m_pad * L).reshape(m_pad, L).T
    seg_base = np.cumsum(per, axis=0) - per  # exclusive prefix over segments
    gstart = np.flatnonzero(np.r_[True, gk[1:] != gk[:-1]])
    within = np.arange(gk.size, dtype=np.int64) \
        - np.repeat(gstart, np.diff(np.r_[gstart, gk.size]))
    slots = indptr[rows] + seg_base[seg_of, rows] + within
    flat_ids, flat_dh, owned = _SCRATCH.take(total + 1)
    flat_ids[slots] = ids[cols]
    flat_dh[slots] = dh_vals
    if not (flat_ids[:total] >= 0).all():
        raise RuntimeError(f"CSR pass-1/pass-2 disagreement ({tag})")
    return _out_of_scratch(indptr, counts, flat_ids, flat_dh, owned, total)


def _padded_candidates(cand: np.ndarray, sent: int) -> np.ndarray:
    """``cand`` padded to its power-of-two capacity with the sentinel row."""
    cand_p = np.full(_ops.csr_capacity(cand.size), sent, np.int64)
    cand_p[:cand.size] = cand
    return cand_p


def _run_csr_packed_pruned(pack, qp, aqp, rp, thp, m, live_idx, *,
                           query_tile, pq_np, pq64, qn64, kq, mixed):
    """Host-lane CSR with candidate pruning, one filter a query tile.

    Each tile of `_PRUNED_TILE` queries evaluates the filter on the columns
    its box intervals can reach (`_tile_candidates`) and nothing else; with
    ``mixed`` its counts come from the certified bf16 count on the same
    rows, which the scatter checks against the filter's survivors.
    """
    aq64 = np.asarray(aqp, np.float64)
    r64 = np.asarray(rp, np.float64)
    xs_s, al_s, hn_s, px_s, ids, starts_l, al_np, _ = _pruned_setup(
        pack, live_idx, kq)
    sent = int(al_np.shape[0])  # the appended sentinel row
    m_pad = int(qp.shape[0])
    counts_pad = np.zeros(m_pad, np.int64)
    ptile = min(query_tile, _PRUNED_TILE)
    rows_l, cols_l, dh_l = [], [], []
    for t0 in range(0, m, ptile):
        tm = min(ptile, m - t0)
        cand = _tile_candidates(pack, live_idx, starts_l, al_np, t0, tm,
                                aq64, r64, pq64, qn64)
        if cand.size == 0:
            continue
        cand_p = _padded_candidates(cand, sent)
        t1 = t0 + ptile
        tile = (_host(qp[t0:t1]), _host(aqp[t0:t1]), _host(rp[t0:t1]),
                _host(thp[t0:t1]))
        *sub, px_t = _gather_rows(cand_p, xs_s, al_s, hn_s, (px_s, 1))
        pq_t = _host(pq_np[:, t0:t1])
        DISPATCH_STATS.kernel_launches += 1
        DISPATCH_STATS.host_transfers += 1
        dh_t = _registry.snn_filter(*tile, *sub, pq_t, px_t).numpy()[:tm]
        keep_t = dh_t < _ops.BIG
        if mixed:
            DISPATCH_STATS.kernel_launches += 1
            DISPATCH_STATS.host_transfers += 1
            cnt_t = _registry.snn_count(*tile, *sub, pq_t, px_t,
                                        mixed=True).numpy()[:tm]
        else:
            cnt_t = keep_t.sum(axis=1)
        counts_pad[t0:t0 + tm] = cnt_t
        tr, tc = np.nonzero(keep_t)
        rows_l.append(t0 + tr.astype(np.int64))
        cols_l.append(cand_p[tc])
        dh_l.append(dh_t[tr, tc])
    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
    dh_vals = np.concatenate(dh_l) if dh_l else np.zeros(0, np.float32)
    return _scatter_flat(m, m_pad, int(live_idx.size), counts_pad[:m], rows,
                         cols, dh_vals, ids, starts_l)


def _run_counts_packed_pruned(pack, qp, aqp, rp, thp, m, live_idx, *,
                              query_tile, pq_np, pq64, qn64, kq, mixed):
    """Pass 1 only, candidate-pruned: the counts twin of
    `_run_csr_packed_pruned` (the same tiles, gathered rows and count
    expressions)."""
    aq64 = np.asarray(aqp, np.float64)
    r64 = np.asarray(rp, np.float64)
    xs_s, al_s, hn_s, px_s, _, starts_l, al_np, _ = _pruned_setup(
        pack, live_idx, kq)
    sent = int(al_np.shape[0])
    counts = np.zeros(m, np.int64)
    ptile = min(query_tile, _PRUNED_TILE)
    for t0 in range(0, m, ptile):
        tm = min(ptile, m - t0)
        cand = _tile_candidates(pack, live_idx, starts_l, al_np, t0, tm,
                                aq64, r64, pq64, qn64)
        if cand.size == 0:
            continue
        cand_p = _padded_candidates(cand, sent)
        t1 = t0 + ptile
        xs_g, al_g, hn_g, px_g = _gather_rows(cand_p, xs_s, al_s, hn_s,
                                              (px_s, 1))
        DISPATCH_STATS.kernel_launches += 1
        DISPATCH_STATS.host_transfers += 1
        counts[t0:t0 + tm] = _registry.snn_count(
            _host(qp[t0:t1]), _host(aqp[t0:t1]), _host(rp[t0:t1]),
            _host(thp[t0:t1]), xs_g, al_g, hn_g, _host(pq_np[:, t0:t1]),
            px_g, mixed=mixed).numpy()[:tm]
    return counts


def _compacted_candidate_tiles(pack, live_idx, starts_l, al_np, m, ptile,
                               aq64, r64, pq64, qn64, sent):
    """Every query tile's candidates at once: ``(cand_p (T, ccap) int64,
    T, ccap)``, each row `_tile_candidates`' ascending concat rows padded
    with the sentinel row to one power-of-two capacity; ``cand_p`` is None
    when no tile has a candidate."""
    T = (m + ptile - 1) // ptile
    cands = []
    for t in range(T):
        t0 = t * ptile
        cands.append(_tile_candidates(pack, live_idx, starts_l, al_np, t0,
                                      min(ptile, m - t0), aq64, r64, pq64,
                                      qn64))
    cmax = max((int(c.size) for c in cands), default=0)
    if cmax == 0:
        return None, T, 0
    ccap = _ops.csr_capacity(cmax)  # power of two: O(log) launch shapes
    cand_p = np.full((T, ccap), sent, np.int64)
    for t, c in enumerate(cands):
        cand_p[t, :c.size] = c
    return cand_p, T, ccap


def _compacted_query_tiles(qp, aqp, rp, thp, pq_np, kq, T, ptile, d_trim):
    """The padded query operands as (T, ptile) tiles, with the feature trim
    (trailing zero columns add exact +0.0 terms)."""
    mt = T * ptile
    qt = _host(qp[:mt, :d_trim].reshape(T, ptile, d_trim))
    aqt, rt, tht = (_host(a[:mt].reshape(T, ptile)) for a in (aqp, rp, thp))
    pqt = _host(pq_np[:, :mt].reshape(kq, T, ptile))
    return qt, aqt, rt, tht, pqt


def _gather_rows(cand: np.ndarray, *arrays):
    """``arrays`` (host numpy, rows on axis 0, or on axis 1 for a 2-D
    projection block given as ``(array, 1)``) gathered at the candidate
    rows ``cand`` into CPU tensors shaped ``cand.shape + the rest``: one
    ``index_select`` each, which torch runs on every core (numpy's fancy
    indexing takes one)."""
    idx = torch.from_numpy(np.ascontiguousarray(cand)).reshape(-1)
    out = []
    for a in arrays:
        a, axis = a if isinstance(a, tuple) else (a, 0)
        g = torch.from_numpy(a).index_select(axis, idx)
        shape = (a.shape[:axis] + cand.shape + a.shape[axis + 1:])
        out.append(g.reshape(shape))
    return out


def _gathered_tiles(cand_p, xs_t, al_s, hn_s, px_s):
    """The candidate rows' operands gathered on the host into (T, ccap,
    ...) tiles."""
    return _gather_rows(cand_p, xs_t, al_s, hn_s, (px_s, 1))


def _run_csr_packed_compacted(pack, qp, aqp, rp, thp, m, live_idx, *,
                              query_tile, pq_np, pq64, qn64, kq, mixed):
    """Host-lane CSR with candidate COMPACTION: pruning as skipped FLOPs.

    The pruned executor's candidate generation, but every tile's surviving
    rows are gathered into one dense (T, ptile, ccap) tile batch and
    evaluated by ONE batched launch (`snn_filter_tiles`): one launch and
    one host transfer a batch instead of a pair a tile, and the product
    touches gathered candidate rows only.  The scatter is the dense path's
    slot formula.
    """
    aq64 = np.asarray(aqp, np.float64)
    r64 = np.asarray(rp, np.float64)
    xs_s, al_s, hn_s, px_s, ids, starts_l, al_np, xs_t = _pruned_setup(
        pack, live_idx, kq)
    sent = int(al_np.shape[0])
    m_pad = int(qp.shape[0])
    ptile = min(query_tile, _PRUNED_TILE)
    cand_p, T, _ = _compacted_candidate_tiles(
        pack, live_idx, starts_l, al_np, m, ptile, aq64, r64, pq64, qn64,
        sent)
    if cand_p is None:
        return (np.zeros(m + 1, np.int64), np.zeros(m, np.int64),
                np.zeros(0, np.int64), np.zeros(0, np.float32))
    qt, aqt, rt, tht, pqt = _compacted_query_tiles(
        qp, aqp, rp, thp, pq_np, kq, T, ptile, xs_t.shape[1])
    xt, alt, hnt, pxt = _gathered_tiles(cand_p, xs_t, al_s, hn_s, px_s)
    DISPATCH_STATS.kernel_launches += 1
    DISPATCH_STATS.host_transfers += 1
    dh_t = _registry.snn_filter_tiles(qt, aqt, rt, tht, xt, alt, hnt, pqt,
                                      pxt).numpy()
    keep_t = dh_t < _ops.BIG
    if mixed:
        DISPATCH_STATS.kernel_launches += 1
        DISPATCH_STATS.host_transfers += 1
        cnt_t = _registry.snn_count_tiles(qt, aqt, rt, tht, xt, alt, hnt,
                                          pqt, pxt, mixed=True).numpy()
    else:
        cnt_t = keep_t.sum(axis=2)
    counts = cnt_t.reshape(T * ptile)[:m].astype(np.int64)
    # np.nonzero is row-major: per query ascending candidate slots, i.e.
    # ascending concat rows, the CSR order
    tt, pp, cc = np.nonzero(keep_t)
    rows = tt.astype(np.int64) * ptile + pp
    return _scatter_flat(m, m_pad, int(live_idx.size), counts, rows,
                         cand_p[tt, cc], dh_t[tt, pp, cc], ids, starts_l)


def _run_counts_packed_compacted(pack, qp, aqp, rp, thp, m, live_idx, *,
                                 query_tile, pq_np, pq64, qn64, kq, mixed):
    """Pass 1 only, candidate-compacted: ONE batched tile count launch (the
    counts twin of `_run_csr_packed_compacted`)."""
    aq64 = np.asarray(aqp, np.float64)
    r64 = np.asarray(rp, np.float64)
    xs_s, al_s, hn_s, px_s, _, starts_l, al_np, xs_t = _pruned_setup(
        pack, live_idx, kq)
    sent = int(al_np.shape[0])
    ptile = min(query_tile, _PRUNED_TILE)
    cand_p, T, _ = _compacted_candidate_tiles(
        pack, live_idx, starts_l, al_np, m, ptile, aq64, r64, pq64, qn64,
        sent)
    if cand_p is None:
        return np.zeros(m, np.int64)
    qt, aqt, rt, tht, pqt = _compacted_query_tiles(
        qp, aqp, rp, thp, pq_np, kq, T, ptile, xs_t.shape[1])
    xt, alt, hnt, pxt = _gathered_tiles(cand_p, xs_t, al_s, hn_s, px_s)
    DISPATCH_STATS.kernel_launches += 1
    DISPATCH_STATS.host_transfers += 1
    cnt_t = _registry.snn_count_tiles(qt, aqt, rt, tht, xt, alt, hnt, pqt,
                                      pxt, mixed=mixed).numpy()
    return cnt_t.reshape(T * ptile)[:m].astype(np.int64)


def _budget_exceeded(memory_budget_mb, nbytes: int) -> bool:
    return memory_budget_mb is not None and nbytes > memory_budget_mb * 2**20


def _run_csr_packed_host(pack, host, m, live_idx, kq, pq64, qn64, *,
                         query_tile, memory_budget_mb, pq_np, mixed,
                         compacted):
    """The host-lane branch of `run_csr_packed` (see its docstring)."""
    qp, aqp, rp, thp = host
    if kq:
        rows_all = int(sum(pack.segments[k].xs.shape[0] for k in live_idx))
        # conservative: the pruned path's largest possible tile gather
        if _budget_exceeded(memory_budget_mb,
                            query_tile * (rows_all + 1) * 4):
            return run_csr([pack.segments[k] for k in live_idx], qp, aqp, rp,
                           thp, m, query_tile=query_tile,
                           memory_budget_mb=memory_budget_mb, pq=pq_np,
                           mixed=mixed, oracle=True)
        run = (_run_csr_packed_compacted if compacted is None or compacted
               else _run_csr_packed_pruned)
        return run(pack, qp, aqp, rp, thp, m, live_idx, query_tile=query_tile,
                   pq_np=pq_np, pq64=pq64, qn64=qn64, kq=kq, mixed=mixed)
    xs_c, al_c, hn_c, ids, sizes = _gather_live_concat(pack, live_idx)
    if _budget_exceeded(memory_budget_mb, qp.shape[0] * int(sizes.sum()) * 4):
        return run_csr([pack.segments[k] for k in live_idx], qp, aqp, rp, thp,
                       m, query_tile=query_tile,
                       memory_budget_mb=memory_budget_mb, oracle=True)
    # ---- pass 1: ONE filter over the ragged concatenation, reused for the
    # compaction, so counts and scatter cannot disagree
    DISPATCH_STATS.kernel_launches += 1
    DISPATCH_STATS.host_transfers += 1
    dh_np = _registry.snn_filter(_host(qp), _host(aqp), _host(rp), _host(thp),
                                 xs_c, al_c, hn_c).numpy()
    keep = dh_np < _ops.BIG
    L = int(live_idx.size)
    starts_l = np.zeros(L + 1, np.int64)
    np.cumsum(sizes, out=starts_l[1:])
    # np.nonzero is row-major: survivors arrive per query in ascending
    # (segment, local row) order, the CSR order
    rows, cols = np.nonzero(keep)
    counts = np.bincount(rows, minlength=keep.shape[0])[:m]
    return _scatter_flat(m, keep.shape[0], L, counts, rows, cols,
                         dh_np[rows, cols], ids, starts_l)


def _run_counts_packed_host(pack, host, m, live_idx, kq, pq64, qn64, *,
                            query_tile, memory_budget_mb, pq_np, mixed,
                            compacted):
    """The host-lane branch of `run_counts_packed`."""
    qp, aqp, rp, thp = host
    if kq:
        run = (_run_counts_packed_compacted if compacted is None or compacted
               else _run_counts_packed_pruned)
        return run(pack, qp, aqp, rp, thp, m, live_idx, query_tile=query_tile,
                   pq_np=pq_np, pq64=pq64, qn64=qn64, kq=kq, mixed=mixed)
    args = (_host(qp), _host(aqp), _host(rp), _host(thp))
    xs_c, al_c, hn_c, _, sizes = _gather_live_concat(pack, live_idx)
    if _budget_exceeded(memory_budget_mb, qp.shape[0] * int(sizes.sum()) * 4):
        # one segment at a time bounds the transient dense filter
        counts = np.zeros(m, np.int64)
        for k in live_idx:
            seg = pack.segments[k]
            DISPATCH_STATS.kernel_launches += 1
            DISPATCH_STATS.host_transfers += 1
            counts += _registry.snn_count(
                *args, seg.xs, seg.alphas, seg.half_norms, bn=seg.block,
                mixed=mixed).numpy()[:m]
        return counts
    DISPATCH_STATS.kernel_launches += 1
    DISPATCH_STATS.host_transfers += 1
    if mixed:
        return _registry.snn_count(*args, xs_c, al_c, hn_c,
                                   mixed=True).numpy()[:m].astype(np.int64)
    dh = _registry.snn_filter(*args, xs_c, al_c, hn_c).numpy()[:m]
    return (dh < _ops.BIG).sum(axis=1).astype(np.int64)


def run_csr_packed(
    pack: SegmentPack,
    qp, aqp, rp, thp,
    m: int,
    *,
    query_tile: int = 128,
    first_seg: int = 0,
    memory_budget_mb: float | None = None,
    pq=None,
    mixed: bool = False,
    compacted: bool | None = None,
    fused: bool = True,
    oracle: bool = False,
):
    """Execute a `SegmentPack` plan: both passes as single launches.

    ``qp``/``aqp``/``rp``/``thp`` are the padded host query operands
    (`kernels.ops.pad_queries`), ``m`` the number of real queries and ``pq``
    the optional (kq, m_pad) padded extra query projections.
    ``first_seg`` leaves out the segments before that pack position (the
    triangular schedule of `core.graph`'s symmetric self-join).  The output
    is bit-identical to `run_csr` over the same live segments.  Returns
    (indptr (m+1,) int64, counts (m,) int64, original ids (nnz,) int64,
    dhalf (nnz,) float32).  Flat totals are int32 on the device (~2^31
    pairs).

    ``oracle=True`` runs the host lane on a pack on the CPU (it raises on a
    pack on the card): without extra components one dense filter over the
    live rows (`SegmentPack.concat`) feeds both passes; with them the
    filter runs on host-gathered candidate rows, as one batched tile launch
    (``compacted`` None or True) or one launch a query tile (``compacted=
    False``).  ``memory_budget_mb`` bounds that lane's dense filter: a batch
    whose filter (or, with components, a tile's largest possible gather)
    would pass it runs the looped `run_csr` instead, which keeps its cached
    filters under the budget.  Both options are ignored off the host lane,
    as ``fused`` is on it.
    """
    if oracle:
        _host_only(pack.device)
    if pack.segments:
        pack.memory_plan(int(np.shape(qp)[0]), query_tile)
    host, kq, pq64, qn64, dev_ops = _query_operands(pack, m, qp, aqp, rp,
                                                     thp, pq)
    live_idx = _live_idx(pack, host[1], host[2], m, first_seg, pq64, qn64)
    if live_idx.size == 0:
        return (np.zeros(m + 1, np.int64), np.zeros(m, np.int64),
                np.zeros(0, np.int64), np.zeros(0, np.float32))
    if oracle:
        pq_np = None if not kq else dev_ops[4].numpy()
        return _run_csr_packed_host(
            pack, host, m, live_idx, kq, pq64, qn64, query_tile=query_tile,
            memory_budget_mb=memory_budget_mb, pq_np=pq_np, mixed=mixed,
            compacted=compacted)
    return _execute_stacked(pack, m, live_idx, dev_ops, kq,
                            query_tile=query_tile, mixed=mixed, fused=fused)


def run_counts_packed(
    pack: SegmentPack,
    qp, aqp, rp, thp,
    m: int,
    *,
    query_tile: int = 128,
    memory_budget_mb: float | None = None,
    pq=None,
    mixed: bool = False,
    compacted: bool | None = None,
    oracle: bool = False,
) -> np.ndarray:
    """Pass 1 only: per-query survivor counts (m,) int64 over a plan, by the
    identical predicate pipeline as `run_csr_packed`'s pass 1 (with
    ``oracle``, ``compacted`` and ``memory_budget_mb`` as there: the same
    host-lane tiles, gathers and count expressions; past the budget one
    segment at a time)."""
    if oracle:
        _host_only(pack.device)
    if pack.segments:
        pack.memory_plan(int(np.shape(qp)[0]), query_tile)
    host, kq, pq64, qn64, dev_ops = _query_operands(pack, m, qp, aqp, rp,
                                                     thp, pq)
    live_idx = _live_idx(pack, host[1], host[2], m, 0, pq64, qn64)
    if live_idx.size == 0:
        return np.zeros(m, np.int64)
    if oracle:
        pq_np = None if not kq else dev_ops[4].numpy()
        return _run_counts_packed_host(
            pack, host, m, live_idx, kq, pq64, qn64, query_tile=query_tile,
            memory_budget_mb=memory_budget_mb, pq_np=pq_np, mixed=mixed,
            compacted=compacted)
    qd, aqd, rd, thd, pqd = dev_ops
    xs, al, hn, _, px = _gather_live_stacked(pack, live_idx, kq)
    DISPATCH_STATS.kernel_launches += 1
    per = _registry.snn_count_stacked(qd, aqd, rd, thd, xs, al, hn, pqd, px,
                                      bn=pack.block, mixed=mixed)
    DISPATCH_STATS.host_transfers += 1
    return per.sum(dim=0).cpu().numpy()[:m].astype(np.int64)


def _execute_stacked(pack: SegmentPack, m: int, live_idx: np.ndarray,
                     dev_ops, kq: int, *, query_tile: int,
                     mixed: bool = False, fused: bool = True):
    """The device executor of `run_csr_packed`.

    With ``fused`` a batch shape that has run once before chains count,
    device prefix and compact with no host sync, under the capacity
    recorded on the pack; the compact kernel checks it on the device and
    the whole result comes back in ONE copy.  On overflow the classic path
    below reruns with exact sizes and the recorded capacity ratchets.
    ``mixed`` applies to pass 1 only; pass 2 always decides in float32.
    """
    qd, aqd, rd, thd, pqd = dev_ops
    xs, al, hn, ids, px = _gather_live_stacked(pack, live_idx, kq)
    m_pad = int(qd.shape[0])
    args = (qd, aqd, rd, thd)

    spec = pack._spec.setdefault(
        (m_pad, int(query_tile), live_idx.tobytes(), kq), {})
    # a total adopted from the previous epoch (an eighth over it) outranks
    # the few slots a zero-match warming dispatch recorded (`warm_plan`)
    hint = pack._spec_hint.get((m_pad, int(query_tile), kq), 0)
    nnz_spec = max(spec.get("nnz_cap", 0),
                   _ops.csr_capacity(hint + hint // 8) if hint else 0)

    # ---- speculative fused path: no host sync between the passes ---------
    if fused and nnz_spec:
        DISPATCH_STATS.kernel_launches += 3
        per, partials = _registry.snn_count_stacked(
            *args, xs, al, hn, pqd, px, bn=pack.block, mixed=mixed,
            with_partials=True)
        _, indptr_dev, offsets_dev = _ref.stacked_prefix(per)
        fi, fd = _registry.snn_compact_stacked(
            *args, offsets_dev, xs, al, hn, pqd, px, nnz=nnz_spec,
            bn=pack.block, partials=partials)
        DISPATCH_STATS.host_transfers += 1
        flat = torch.cat([indptr_dev, fi, fd.view(torch.int32)]).cpu().numpy()
        indptr_pad = flat[:m_pad + 1]
        total = int(indptr_pad[m])
        spec["nnz_cap"] = max(nnz_spec, _ops.csr_capacity(total))
        spec["total"] = max(spec.get("total", 0), total)
        if total + 1 <= nnz_spec:
            indptr = indptr_pad[:m + 1].astype(np.int64)
            counts = np.diff(indptr)
            fi = flat[m_pad + 1:m_pad + 1 + total]
            fd = flat[m_pad + 1 + nnz_spec:m_pad + 1 + nnz_spec + total]
            if not (fi >= 0).all():
                raise RuntimeError("CSR pass-1/pass-2 disagreement (packed)")
            return (indptr, counts, ids.reshape(-1)[fi],
                    np.ascontiguousarray(fd).view(np.float32))
        # speculation overflow: fall through to the exact-sized classic path

    # ---- pass 1: ONE stacked count launch --------------------------------
    DISPATCH_STATS.kernel_launches += 1
    per, partials = _registry.snn_count_stacked(
        *args, xs, al, hn, pqd, px, bn=pack.block, mixed=mixed,
        with_partials=True)

    # ---- device prefix sums + the one pass-boundary sync -----------------
    DISPATCH_STATS.kernel_launches += 1
    _, indptr_dev, offsets_dev = _ref.stacked_prefix(per)
    DISPATCH_STATS.host_transfers += 1
    indptr_pad = indptr_dev.cpu().numpy()
    total = int(indptr_pad[m])
    spec["nnz_cap"] = max(spec.get("nnz_cap", 0), _ops.csr_capacity(total))
    spec["total"] = max(spec.get("total", 0), total)
    indptr = indptr_pad[:m + 1].astype(np.int64)
    counts = np.diff(indptr)
    if total == 0:
        return indptr, counts, np.zeros(0, np.int64), np.zeros(0, np.float32)

    # ---- pass 2: ONE stacked compaction launch ---------------------------
    DISPATCH_STATS.kernel_launches += 1
    fi, fd = _registry.snn_compact_stacked(
        *args, offsets_dev, xs, al, hn, pqd, px,
        nnz=_ops.csr_capacity(total), bn=pack.block, partials=partials)
    DISPATCH_STATS.host_transfers += 2
    fi = fi[:total].cpu().numpy()
    if not (fi >= 0).all():
        raise RuntimeError("CSR pass-1/pass-2 disagreement (packed)")
    return indptr, counts, ids.reshape(-1)[fi], fd[:total].cpu().numpy()


def query_csr_packed(
    index,
    pack: SegmentPack,
    q: np.ndarray,
    radius,
    return_distance: bool = True,
    *,
    query_tile: int = 128,
    native: bool = True,
    memory_budget_mb: float | None = None,
    mixed: bool = False,
    bucket: bool = False,
    compacted: bool | None = None,
    fused: bool = True,
    oracle: bool = False,
):
    """Full CSR query through a prebuilt plan: predicates from ``index``
    (the owner of mu/v1/metric/xi) on the host, then `run_csr_packed`, then
    float64 distance finalization on the host.  ``bucket`` pads the batch to
    the geometric query-bucket ladder; results are identical either way.
    ``oracle``, ``compacted`` and ``memory_budget_mb`` select and bound the
    host lane (`run_csr_packed`)."""
    from . import snn as _snn  # deferred: snn imports this module lazily too

    xq, aq, r, th, qsq = _snn.prepare_query_predicates(index, q, radius)
    m = xq.shape[0]
    qp, aqp, rp, thp, _ = _ops.pad_queries(xq, aq, r, th, tq=query_tile,
                                           bucket=bucket)
    pq = _snn.query_extra_projections(index, xq)
    pqp = None if pq is None else _ops.pad_components(pq, qp.shape[0])
    indptr, counts, ids, dh = run_csr_packed(
        pack, qp, aqp, rp, thp, m, query_tile=query_tile,
        memory_budget_mb=memory_budget_mb, pq=pqp, mixed=mixed,
        compacted=compacted, fused=fused, oracle=oracle)
    return _snn.csr_finalize(index, indptr, ids, dh, xq, qsq, counts,
                             return_distance, native)


def query_csr(
    index,
    segments: list[Segment],
    q: np.ndarray,
    radius,
    return_distance: bool = True,
    *,
    query_tile: int = 128,
    native: bool = True,
    memory_budget_mb: float | None = None,
    mixed: bool = False,
    bucket: bool = False,
    oracle: bool = False,
):
    """Full CSR query through the looped executor: predicates from ``index``
    (the owner of mu/v1/metric/xi) on the host, then `run_csr` over
    ``segments``, then float64 distance finalization on the host.  The
    counterpart of `query_csr_packed`, with bit-identical results;
    ``oracle`` and ``memory_budget_mb`` as in `run_csr`."""
    from . import snn as _snn  # deferred: snn imports this module lazily too

    xq, aq, r, th, qsq = _snn.prepare_query_predicates(index, q, radius)
    m = xq.shape[0]
    qp, aqp, rp, thp, _ = _ops.pad_queries(xq, aq, r, th, tq=query_tile,
                                           bucket=bucket)
    pq = _snn.query_extra_projections(index, xq)
    pqp = None if pq is None else _ops.pad_components(pq, qp.shape[0])
    indptr, counts, ids, dh = run_csr(segments, qp, aqp, rp, thp, m,
                                      query_tile=query_tile,
                                      memory_budget_mb=memory_budget_mb,
                                      pq=pqp, mixed=mixed, oracle=oracle)
    return _snn.csr_finalize(index, indptr, ids, dh, xq, qsq, counts,
                             return_distance, native)


# --------------------------------------------------------------------------- #
# Plan warming (double-buffered epochs)                                        #
# --------------------------------------------------------------------------- #
def warm_plan(
    pack: SegmentPack,
    *,
    m_pads=(128,),
    query_tile: int = 128,
    mixed: bool = False,
    fused: bool = True,
    spec_from: SegmentPack | None = None,
) -> SegmentPack:
    """Prime a plan so its first real batch costs steady-state work.

    A mutator (the streaming index's append or rebuild) builds the next
    epoch's pack and calls this before it publishes it.  For each bucketed
    batch size in ``m_pads`` one zero-match dispatch runs through
    `run_csr_packed`: one query row per segment sits at that segment's
    ``alpha_lo`` (and box corner) with radius 0, so every segment is live
    and the whole stacked operand set is built on the device and every
    launch signature is seen, while the threshold ``-BIG`` keeps no row, so
    the output is empty.  It builds each bucket's `MemoryPlan` and,
    through ``spec_from`` (`SegmentPack.adopt_spec`), takes the previous
    epoch's fused capacities, so the first batch of a warmed bucket takes
    the fused path.

    Warming never changes a result; callers treat a failure as non-fatal
    (a plan that was not warmed still answers correctly, only colder).
    """
    if spec_from is not None:
        pack.adopt_spec(spec_from)
    S = pack.n_segments
    if S == 0 or pack.n_pad == 0:
        return pack
    d_pad = int(pack.segments[0].xs.shape[1])
    nonempty = pack.alpha_lo <= pack.alpha_hi
    aq_seg = np.where(nonempty, pack.alpha_lo, 0.0).astype(np.float32)
    pq_seg = None
    if pack.ke:
        pq_seg = np.where(nonempty[:, None],
                          np.asarray(pack.proj_lo, np.float64),
                          0.0).astype(np.float32)  # (S, ke)
    for m_pad in sorted({int(b) for b in m_pads if int(b) > 0}):
        reps = -(-m_pad // S)  # cycle the per-segment rows to fill the bucket
        aq = np.tile(aq_seg, reps)[:m_pad]
        qp = np.zeros((m_pad, d_pad), np.float32)
        rp = np.zeros(m_pad, np.float32)
        thp = np.full(m_pad, -_ops.BIG, np.float32)
        pq = None
        if pq_seg is not None:
            pq = np.tile(pq_seg, (reps, 1))[:m_pad].T  # (ke, m_pad)
        pack.memory_plan(m_pad, query_tile)
        run_csr_packed(pack, qp, aq, rp, thp, m_pad, query_tile=query_tile,
                       pq=pq, mixed=mixed, fused=fused)
    return pack
