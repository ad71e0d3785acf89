"""SNN on PyTorch: the index (paper Alg. 1) and the exact CSR radius query.

The counterpart of ``repro.core.snn``.  `build_index` centres the data,
finds the first principal direction by power iteration, sorts the rows by
their score ``alpha`` (stably) and stores half norms and two deflated extra
components for the box prune, all on the device.  `query_radius_csr` answers
a batch of radius queries exactly, as CSR, through the two-pass engine
(`core.join.single_query` -> `core.engine`).

Query preparation (`prepare_queries`, `prepare_query_predicates`) and the
float64 distance finalization (`csr_finalize`) run on the host in numpy, as
in the reference, so the float32 predicate inputs are the reference's bits.

The paper's Algorithm 2 on the host side (`query_radius`,
`query_radius_batch`, `query_counts`) windows the sorted alphas in numpy and
takes each window's product (one GEMM a query group) on the index's device,
in float32 with TF32 off whatever the caller set (`_full_float32`); the
per-query selection runs in numpy.  `query_radius_fixed`,
the K-bounded fixed-shape query, runs the filter kernel
(`kernels.ops.snn_filter`) and a top-K on the index's device.

Device rule: `build_index`, `index_from_arrays` and `query_radius_csr` take
``device=None``, meaning the CUDA device; without a card they raise unless
the caller passes ``device="cpu"``.  The host queries run on the index's own
device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from ..kernels import registry as _registry
from ..kernels.ref import BIG as _BIG
from ..utils import top_k
from . import metrics as _metrics


# --------------------------------------------------------------------------- #
# Index                                                                        #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class SNNIndex:
    """Output of Algorithm 1 (plus bookkeeping to undo the sort).

    Host numpy: ``mu`` (d,) mean, ``v1`` (d,) first principal direction,
    ``order`` (n,) original row of each sorted row, ``vs`` (k, d) pruning
    directions (row 0 is ``v1``).  Tensors on the index's device: ``xs``
    (n, d) centred rows sorted by alpha, ``alphas`` (n,) = ``xs @ v1``,
    ``half_norms`` (n,) = ``x.x / 2``, ``projs`` (k, n) = ``xs @ vs.T`` with
    row 0 equal to ``alphas``.  ``metric`` is one of
    `metrics.VALID_METRICS`; ``xi`` is the mips lift's max norm.
    """

    mu: np.ndarray
    v1: np.ndarray
    xs: torch.Tensor
    alphas: torch.Tensor
    half_norms: torch.Tensor
    order: np.ndarray
    metric: str = "euclidean"
    xi: float = 0.0
    vs: np.ndarray | None = None
    projs: torch.Tensor | None = None
    # execution plans built over this index, by (block, device): reused
    # across query batches, which is what lets the fused path engage
    _packs: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # a host copy of ``alphas``, made on first use by the host paths
    _alphas_np: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.vs is None:
            self.vs = np.asarray(self.v1)[None, :]
        if self.projs is None:
            self.projs = self.alphas[None, :]

    @property
    def n(self) -> int:
        return int(self.xs.shape[0])

    @property
    def d(self) -> int:
        return int(self.xs.shape[1])

    @property
    def device(self) -> torch.device:
        return self.xs.device

    def prepare_queries(self, q: np.ndarray, radius) -> tuple[np.ndarray, np.ndarray]:
        """Transform+center queries; return (xq (m,d), per-query Euclidean radii).

        ``radius`` is a scalar (broadcast) or a per-query (m,) vector in the
        native metric.
        """
        tq = _metrics.transform_query(np.asarray(q), self.metric)
        r = _metrics.euclidean_radius(radius, tq, self.metric, self.xi)
        return (tq - self.mu[None, :]).astype(self.mu.dtype), r.astype(np.float64)

    def host_alphas(self) -> np.ndarray:
        """``alphas`` as a float32 numpy array, copied from the device once:
        the windows of the host queries and the kNN seed search it."""
        if self._alphas_np is None:
            self._alphas_np = self.alphas.cpu().numpy()
        return self._alphas_np

    def pack(self, block: int = 512, device=None):
        """The single-segment `engine.SegmentPack` of this index on
        ``device`` (default: the index's own), built once and reused."""
        from . import engine as _engine

        dev = torch.device(device) if device is not None else self.device
        key = (int(block), str(dev))
        pack = self._packs.get(key)
        if pack is None:
            pack = _engine.pack_from_index(self, block=block, device=dev)
            self._packs[key] = pack
        return pack


def index_from_arrays(mu, v1, xs, alphas, half_norms, order,
                      metric: str = "euclidean", xi: float = 0.0, vs=None,
                      projs=None, *, device=None) -> SNNIndex:
    """An `SNNIndex` from the arrays of an index built elsewhere.

    Takes the fields of a ``repro.core.snn.SNNIndex`` as numpy arrays, so
    both packages can query the very same index; ``xs``, ``alphas``,
    ``half_norms`` and ``projs`` become float32 tensors on ``device``.
    """
    dev = _registry.resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    return SNNIndex(np.asarray(mu), np.asarray(v1), t(xs), t(alphas),
                    t(half_norms), np.asarray(order, np.int64), metric,
                    float(xi), None if vs is None else np.asarray(vs),
                    None if projs is None else t(projs))


def _power_iteration(x: torch.Tensor, n_iter: int = 64) -> torch.Tensor:
    """First right singular vector of centred x by power iteration on X^T X,
    from the dimension of largest variance, sign fixed so that the
    largest-|component| is positive (reproducible)."""
    var = torch.var(x, dim=0, unbiased=False)
    v = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    v[torch.argmax(var)] = 1.0
    for _ in range(n_iter):
        w = x.T @ (x @ v)
        v = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
    s = torch.sign(v[torch.argmax(torch.abs(v))])
    return v * torch.where(s == 0, torch.ones_like(s), s)


def _extra_components(xs: torch.Tensor, v1: torch.Tensor, alphas: torch.Tensor,
                      n_components: int, n_iter: int):
    """Deflation power iteration for components 2..k over the sorted data.

    Row 0 of the returned (vs, projs) is ``v1``/``alphas`` itself.  Each
    deflated direction has norm <= 1, which is all the box bound needs:
    imperfect deflation only loosens the box.
    """
    n, d = xs.shape
    k = max(1, min(int(n_components), max(d, 1)))
    vs = [v1]
    projs = [alphas]
    if k > 1:
        resid = xs - alphas[:, None] * v1[None, :]
        for _ in range(k - 1):
            vc = _power_iteration(resid, n_iter=n_iter)
            vs.append(vc)
            # project the ORIGINAL data: exact orthogonality is not required
            projs.append(xs @ vc)
            resid.addr_(resid @ vc, vc, alpha=-1.0)
    return torch.stack(vs), torch.stack(projs)


def build_index(
    p: np.ndarray,
    metric: str = "euclidean",
    n_iter: int = 64,
    n_components: int = 3,
    *,
    device=None,
) -> SNNIndex:
    """Algorithm 1 on the device: center, score by the first PC, sort stably,
    precompute half-norms and the extra components of the box prune.

    The metric transform runs on the host (numpy, as in the reference); the
    rest runs in float32 on ``device`` (default: the CUDA device).
    """
    dev = _registry.resolve_device(device)
    x_raw, xi = _metrics.transform_data(np.asarray(p), metric)
    x = torch.from_numpy(np.ascontiguousarray(x_raw, np.float32)).to(dev)
    n, d = x.shape
    # an empty database has no mean; zeros keep every predicate finite
    mu = x.mean(dim=0) if n else torch.zeros(d, dtype=torch.float32,
                                             device=dev)
    x = x - mu[None, :]
    if n == 0 or d == 0:
        zn = torch.zeros(n, dtype=torch.float32, device=dev)
        return SNNIndex(mu.cpu().numpy(), np.zeros(d, np.float32), x, zn,
                        zn.clone(), np.arange(n, dtype=np.int64), metric, xi)
    v1 = _power_iteration(x, n_iter=n_iter)
    alphas = x @ v1
    order = torch.argsort(alphas, stable=True)
    xs = x[order].contiguous()
    del x
    alphas = alphas[order].contiguous()
    half_norms = 0.5 * torch.sum(xs * xs, dim=1)
    vs, projs = _extra_components(xs, v1, alphas, n_components, n_iter)
    return SNNIndex(mu.cpu().numpy(), v1.cpu().numpy(), xs, alphas,
                    half_norms, order.cpu().numpy().astype(np.int64), metric,
                    xi, vs.cpu().numpy(), projs.contiguous())


# --------------------------------------------------------------------------- #
# Exact host queries (Algorithm 2)                                             #
# --------------------------------------------------------------------------- #
_FP32_LOCK = threading.Lock()
_fp32_users = 0
_fp32_saved: tuple | None = None


@contextlib.contextmanager
def _full_float32():
    """Run the enclosed float32 products in full float32 on the card.

    TF32 is process-wide state that a caller may turn on (the
    ``allow_tf32`` flag, ``torch.set_float32_matmul_precision("high")`` or
    the newer ``fp32_precision``); its 10-bit mantissa would make the
    window products inexact.  The first thread in clears it and the last one
    out puts the caller's setting back, through the same interface it was
    made with (PyTorch refuses to read one interface's state after the other
    set it).  When TF32 is already off nothing is touched."""
    global _fp32_users, _fp32_saved
    m = torch.backends.cuda.matmul
    with _FP32_LOCK:
        if _fp32_users == 0:
            try:
                on, name, off = m.allow_tf32, "allow_tf32", False
            except RuntimeError:   # set through fp32_precision
                on = m.fp32_precision
                name, off = "fp32_precision", "ieee"
                on = on if on == "tf32" else False
            _fp32_saved = (name, on) if on else None
            if on:
                setattr(m, name, off)
        _fp32_users += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _fp32_users -= 1
            if _fp32_users == 0 and _fp32_saved is not None:
                setattr(m, *_fp32_saved)
                _fp32_saved = None


def _window(index: SNNIndex, aq: np.ndarray, r: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    al = index.host_alphas()
    lo = np.searchsorted(al, aq - r, side="left")
    hi = np.searchsorted(al, aq + r, side="right")
    return lo, hi


def query_radius(
    index: SNNIndex, q: np.ndarray, radius, return_distance: bool = True
):
    """Exact radius query for a single query point.

    Returns (indices, distances) into the ORIGINAL data ordering; distances
    are in the native metric.  The window's GEMV runs on the index's device.
    """
    xq, r = index.prepare_queries(q, radius)
    xq, r = xq[0], float(r[0])
    aq = float(xq @ index.v1)
    lo, hi = _window(index, np.asarray([aq]), np.asarray([r]))
    lo, hi = int(lo[0]), int(hi[0])
    if hi <= lo:
        out_i = np.zeros(0, np.int64)
        return (out_i, np.zeros(0, np.float64)) if return_distance else out_i
    xqd = torch.from_numpy(np.ascontiguousarray(xq)).to(index.device)
    # paper eq. (4): half-norm form, one GEMV over the contiguous window
    with _full_float32():
        dhalf = (index.half_norms[lo:hi] - index.xs[lo:hi] @ xqd).cpu().numpy()
    qsq = float(xq @ xq)
    keep = dhalf <= (r * r - qsq) / 2.0
    sel = np.nonzero(keep)[0] + lo
    out_i = index.order[sel]
    if not return_distance:
        return out_i
    sq = np.maximum(2.0 * dhalf[keep] + qsq, 0.0)
    return out_i, _native_distance(index, sq, xq)


def _native_distance(index: SNNIndex, sq_eucl: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """Convert squared Euclidean distances (in index space) to the native metric."""
    return _native_distance_csr(index, sq_eucl, xq[None, :],
                                np.asarray([sq_eucl.shape[0]]))


def query_radius_batch(
    index: SNNIndex,
    q: np.ndarray,
    radius,
    return_distance: bool = True,
    group_size: int = 64,
):
    """Exact batched radius query (paper section 4, level-3 BLAS variant).

    Queries are sorted by their alpha score and processed in groups; each
    group computes one float32 GEMM over the union of its members' windows
    on the index's device and brings that block to the host once, where
    each member selects its own window.  Returns a list of per-query
    results in the original query order.  ``radius`` is a scalar or a
    per-query (m,) vector in the native metric.
    """
    xq, r = index.prepare_queries(q, radius)
    m = xq.shape[0]
    aq = xq @ index.v1
    lo, hi = _window(index, aq, r)
    qord = np.argsort(aq, kind="stable")
    results: list = [None] * m
    qsq = np.einsum("ij,ij->i", xq, xq)
    xqd = torch.from_numpy(np.ascontiguousarray(xq)).to(index.device)
    for g0 in range(0, m, group_size):
        grp = qord[g0 : g0 + group_size]
        glo, ghi = int(lo[grp].min()), int(hi[grp].max())
        if ghi <= glo:
            for qi in grp:
                e = np.zeros(0, np.int64)
                results[qi] = (e, np.zeros(0, np.float64)) if return_distance else e
            continue
        # one GEMM for the whole group: (ghi-glo, d) @ (d, |grp|)
        grp_t = torch.from_numpy(grp).to(index.device)
        with _full_float32():
            dhalf = (index.half_norms[glo:ghi, None]
                     - index.xs[glo:ghi] @ xqd[grp_t].T).cpu().numpy()
        for k, qi in enumerate(grp):
            s, e = lo[qi] - glo, hi[qi] - glo
            dh = dhalf[s:e, k]
            keep = dh <= (r[qi] * r[qi] - qsq[qi]) / 2.0
            sel = np.nonzero(keep)[0] + lo[qi]
            oi = index.order[sel]
            if return_distance:
                sqd = np.maximum(2.0 * dh[keep] + qsq[qi], 0.0)
                results[qi] = (oi, _native_distance(index, sqd, xq[qi]))
            else:
                results[qi] = oi
    return results


def query_counts(index: SNNIndex, q: np.ndarray, radius, group_size: int = 64) -> np.ndarray:
    """Number of neighbours within radius for each query (exact, batched)."""
    res = query_radius_batch(index, q, radius, return_distance=False, group_size=group_size)
    return np.asarray([len(r) for r in res], dtype=np.int64)


# --------------------------------------------------------------------------- #
# Fixed-shape path                                                             #
# --------------------------------------------------------------------------- #
def _smallest_k(dhalf: torch.Tensor, k: int):
    """`top_k` of the smallest half distances; tied +BIG entries at the
    k-th value are pruned pairs, masked by the caller, so they are left."""
    return top_k(dhalf, k, largest=False, masked=_BIG)


def query_radius_fixed(index: SNNIndex, q: np.ndarray, radius, max_neighbors: int,
                       block: int = 512):
    """Fixed-shape query: (indices (m,K), sq_dists (m,K), valid (m,K),
    counts (m,)).

    K = max_neighbors, clamped to the padded row count; results are the K
    nearest within the radius (exact as long as the true neighbour count
    <= K; ``counts`` lets callers detect truncation), nearest first, equal
    distances by sorted row.  ``radius`` is a scalar or per-query (m,)
    vector in the native metric.  The masked half distances come from the
    filter kernel (`kernels.ops.snn_filter`) over the index's cached padded
    rows, and the top-K and the id map run on the index's device.
    """
    from ..kernels import ops as _ops

    if index.n == 0:
        # ``order[idx % n]`` below would divide by zero; an empty database
        # has well-defined results: K = min(max_neighbors, 0) = 0 columns
        m = _metrics.transform_query(np.asarray(q), index.metric).shape[0]
        return (np.zeros((m, 0), np.int64), np.zeros((m, 0), np.float64),
                np.zeros((m, 0), bool), np.zeros(m, np.int64))
    # the padding contract of every path (`ops.pad_database`): the index's
    # own one-segment plan holds these rows already
    seg = index.pack(block).segments[0]
    xq, r = index.prepare_queries(q, radius)
    m = xq.shape[0]
    aq = (xq @ index.v1).astype(np.float32)
    r32 = r.astype(np.float32)
    qsq = np.einsum("ij,ij->i", xq, xq).astype(np.float32)
    thresh = ((r32 * r32 - qsq) / np.float32(2.0)).astype(np.float32)
    ops = [torch.from_numpy(a).to(index.device)
           for a in _ops.pad_queries(xq, aq, r32, thresh)[:4]]
    dhalf = _ops.snn_filter(*ops, seg.xs, seg.alphas, seg.half_norms,
                            bn=seg.block)[:m]
    counts = (dhalf < _BIG).sum(dim=1)
    k = min(int(max_neighbors), int(dhalf.shape[1]))
    vals, idx = _smallest_k(dhalf, k)
    valid = vals < _BIG
    qsq_t = torch.from_numpy(qsq).to(index.device)
    sq = torch.clamp_min(2.0 * vals + qsq_t[:, None], 0.0)
    order = torch.from_numpy(index.order).to(index.device)
    out_idx = torch.where(valid, order[idx % index.n], -1)
    return (out_idx.cpu().numpy(),
            torch.where(valid, sq, torch.inf).cpu().numpy(),
            valid.cpu().numpy(), counts.cpu().numpy().astype(np.int64))


# --------------------------------------------------------------------------- #
# Two-pass exact CSR engine                                                    #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class CSRNeighbors:
    """Exact variable-length radius results in CSR form.

    Query i's neighbours occupy ``indptr[i]:indptr[i+1]``.  ``indices`` are
    original (pre-sort) row ids, ascending in sorted-database order within
    each row; ``distances`` (if requested) are in the native metric.
    """

    indptr: np.ndarray
    indices: np.ndarray
    distances: np.ndarray | None = None

    @property
    def m(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def row(self, i: int):
        s, e = int(self.indptr[i]), int(self.indptr[i + 1])
        if self.distances is None:
            return self.indices[s:e]
        return self.indices[s:e], self.distances[s:e]

    def tolist(self) -> list:
        return [self.row(i) for i in range(self.m)]


def prepare_query_predicates(index: SNNIndex, q: np.ndarray, radius):
    """Float32 predicate inputs (xq, aq, r, thresh, qsq) for the device paths.

    Both passes of the engine derive their window and half-norm tests from
    THIS host computation, the reference's own arithmetic.
    """
    xq, r = index.prepare_queries(q, radius)
    aq = (xq @ index.v1).astype(np.float32)
    qsq = np.einsum("ij,ij->i", xq, xq)
    thresh = ((r * r - qsq) / 2.0).astype(np.float32)
    return xq, aq, r.astype(np.float32), thresh, qsq


def query_extra_projections(index: SNNIndex, xq: np.ndarray) -> np.ndarray | None:
    """(ke, m) float32 EXTRA-component query projections for the box prune,
    or None when the index carries no extra components.  Component 0
    (``xq @ v1``) is left out: the alpha window covers it."""
    vs = getattr(index, "vs", None)
    if vs is None or vs.shape[0] <= 1:
        return None
    return np.ascontiguousarray(
        (np.asarray(xq) @ vs[1:].T).T.astype(np.float32))


def _native_distance_csr(index: SNNIndex, sq_eucl: np.ndarray, xq: np.ndarray,
                         counts: np.ndarray) -> np.ndarray:
    """Native-metric distances over a flat CSR squared-distance array."""
    qsq_raw = None
    if index.metric == "mips":
        # index space is centered (and lifted); undo to recover ||q||^2
        qraw = xq + index.mu[None, :]
        qsq_raw = np.repeat(np.einsum("ij,ij->i", qraw, qraw), counts)
    return _metrics.native_distance(sq_eucl, index.metric, index.xi, qsq_raw)


def query_radius_csr(
    index: SNNIndex,
    q: np.ndarray,
    radius,
    return_distance: bool = True,
    block: int = 512,
    query_tile: int = 128,
    native: bool = True,
    packed: bool = True,
    mixed: bool = False,
    bucket: bool = True,
    fused: bool = True,
    compacted: bool | None = None,
    memory_budget_mb: float | None = None,
    oracle: bool = False,
    device=None,
) -> CSRNeighbors:
    """Exact radius query with CSR output (two passes, no (m, n) array).

    ``radius`` is a scalar or a per-query (m,) vector in the native metric.
    Pass 1 counts each query's neighbours, device prefix sums turn the
    counts into CSR offsets, and pass 2 re-runs the identical predicate and
    writes each survivor into its slot.  ``packed=True`` runs the packed
    executor over the index's one-segment plan; ``packed=False`` the looped
    executor (`engine.query_csr`) over the same segment, the cross-check.
    ``mixed=True`` runs pass 1 with bf16 products under the margin
    certificate; ``bucket`` pads the batch to the geometric ladder;
    ``fused`` lets a repeated batch shape run both passes without a host
    sync.  None of them changes the result.

    ``oracle=True`` runs the engine's host lane instead (the reference's
    CPU executors; needs ``device="cpu"``, and raises on the card's plan):
    one dense filter, or with the index's extra components the filter on
    gathered candidate rows, one batched launch (``compacted`` None or
    True) or one a query tile (``compacted=False``); ``memory_budget_mb``
    bounds its dense filters (`engine.run_csr_packed`).  Off the lane both
    are ignored.

    Runs on ``device`` (default: the CUDA device; raises without one unless
    ``device="cpu"``), through the index's cached plan on that device.
    """
    from .join import single_query as _single_query

    return _single_query(index, q, radius, return_distance, block=block,
                         query_tile=query_tile, native=native, packed=packed,
                         memory_budget_mb=memory_budget_mb, mixed=mixed,
                         bucket=bucket, compacted=compacted, fused=fused,
                         oracle=oracle, device=device)


def csr_finalize(index: SNNIndex, indptr, indices, fd, xq, qsq, counts,
                 return_distance: bool, native: bool = True) -> CSRNeighbors:
    """Wrap flat original ids + dhalf values into a `CSRNeighbors`, with the
    distances computed in float64 on the host.  ``native=False`` leaves them
    as squared Euclidean distances in index space."""
    indices = np.asarray(indices, np.int64)
    if not return_distance:
        return CSRNeighbors(indptr, indices, None)
    fd = np.asarray(fd)
    sq = np.maximum(2.0 * fd.astype(np.float64) + np.repeat(qsq, counts), 0.0)
    if not native:
        return CSRNeighbors(indptr, indices, sq)
    return CSRNeighbors(indptr, indices, _native_distance_csr(index, sq, xq, counts))
