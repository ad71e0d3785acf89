"""Distance metrics supported by SNN (paper §3); the port's own copy of
``repro.core.metrics`` (host-side numpy, as in the reference).

Every metric is reduced to a Euclidean radius query, exactly as the paper does:

* euclidean  — identity.
* cosine     — rows are L2-normalized at index/query time; for normalized u, v:
               ``2 * cdist(u, v) = ||u - v||^2``  =>  ``R_eucl = sqrt(2 * R_cos)``.
* angular    — ``theta <= alpha  <=>  ||u - v||^2 <= 2 - 2 cos(alpha)``.
* mips       — maximum-inner-product: data is lifted to d+1 dims with
               ``p~ = [sqrt(xi^2 - ||p||^2), p]``, ``q~ = [0, q]``; then
               ``||p~ - q~||^2 = xi^2 + ||q||^2 - 2 p.q`` so an inner-product
               threshold ``p.q >= S`` becomes the (query-dependent) radius
               ``R_eucl = sqrt(xi^2 + ||q||^2 - 2 S)``.
"""
from __future__ import annotations

import numpy as np

VALID_METRICS = ("euclidean", "cosine", "angular", "mips")


def _as2d(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.float64 if a.dtype == np.float64 else np.float32)
    return a[None, :] if a.ndim == 1 else a


def normalize_rows(a: np.ndarray, eps: float = 1e-30) -> np.ndarray:
    a = _as2d(a)
    nrm = np.linalg.norm(a, axis=1, keepdims=True)
    return a / np.maximum(nrm, eps)


def lift_mips_data(p: np.ndarray, xi: float | None = None) -> tuple[np.ndarray, float]:
    """Lift data points for MIPS: ``p~ = [sqrt(xi^2 - ||p||^2), p]``.

    ``xi`` defaults to the max data norm.  A *frozen* xi (streaming appends
    against an existing index) keeps the lift identity valid as long as it is
    >= every appended norm — callers must check and re-index otherwise.
    """
    p = _as2d(p)
    sq = np.einsum("ij,ij->i", p, p)
    xi2 = (float(sq.max()) if p.shape[0] else 0.0) if xi is None else float(xi) ** 2
    extra = np.sqrt(np.maximum(xi2 - sq, 0.0))
    return np.concatenate([extra[:, None], p], axis=1), float(np.sqrt(xi2))


def lift_mips_query(q: np.ndarray) -> np.ndarray:
    q = _as2d(q)
    return np.concatenate([np.zeros((q.shape[0], 1), q.dtype), q], axis=1)


def transform_data(p: np.ndarray, metric: str,
                   xi: float | None = None) -> tuple[np.ndarray, float]:
    """Map raw data into the Euclidean space used by the index.

    Returns (transformed data, xi) where xi is only meaningful for mips; pass
    a frozen ``xi`` to transform appended points consistently with an
    existing mips index (only valid while it bounds every appended norm).
    """
    if metric == "euclidean":
        return _as2d(p), 0.0
    if metric in ("cosine", "angular"):
        return normalize_rows(p), 0.0
    if metric == "mips":
        return lift_mips_data(p, xi)
    raise ValueError(f"unknown metric {metric!r}; valid: {VALID_METRICS}")


def transform_query(q: np.ndarray, metric: str) -> np.ndarray:
    if metric == "euclidean":
        return _as2d(q)
    if metric in ("cosine", "angular"):
        return normalize_rows(q)
    if metric == "mips":
        return lift_mips_query(q)
    raise ValueError(f"unknown metric {metric!r}; valid: {VALID_METRICS}")


def broadcast_radius(radius, m: int) -> np.ndarray:
    """Canonicalize a radius argument to the per-query (m,) float64 vector.

    The per-query vector is the canonical representation everywhere below
    the public API surface; a scalar is the broadcasting convenience (every
    query gets the same radius).  Anything else — a wrong-length vector, a
    2-D array — is a shape bug at the call site and is rejected here, once,
    instead of surfacing as a cryptic kernel-padding error.
    """
    r = np.asarray(radius, dtype=np.float64)
    if r.ndim == 0:
        return np.full((m,), float(r), dtype=np.float64)
    if r.shape != (m,):
        raise ValueError(f"radius must be a scalar or a per-query (m,) = "
                         f"({m},) vector; got shape {r.shape}")
    return r.copy()


def euclidean_radius(radius, q: np.ndarray, metric: str, xi: float = 0.0) -> np.ndarray:
    """Per-query Euclidean radii equivalent to ``radius`` in ``metric``.

    ``radius`` is a scalar or a per-query (m,) vector in the native metric
    (`broadcast_radius` is the one canonicalization point); the result is
    always the per-query (m,) Euclidean vector the kernels consume.  For
    mips, ``radius`` is the inner-product threshold S (neighbors satisfy
    ``p.q >= S``) and the result additionally depends on ||q||.
    """
    q = _as2d(q)
    r = broadcast_radius(radius, q.shape[0])
    if metric == "euclidean":
        return r
    if metric == "cosine":
        # cdist(u, v) <= radius  <=>  ||u-v||^2 <= 2*radius
        return np.sqrt(np.maximum(2.0 * r, 0.0))
    if metric == "angular":
        return np.sqrt(np.maximum(2.0 - 2.0 * np.cos(r), 0.0))
    if metric == "mips":
        qsq = np.einsum("ij,ij->i", q, q)
        return np.sqrt(np.maximum(xi * xi + qsq - 2.0 * r, 0.0))
    raise ValueError(f"unknown metric {metric!r}; valid: {VALID_METRICS}")


def native_distance(sq_eucl: np.ndarray, metric: str, xi: float = 0.0,
                    qsq_raw: np.ndarray | None = None) -> np.ndarray:
    """Convert squared Euclidean distances (index space) to ``metric``.

    The inverse of the `euclidean_radius` reduction, vectorized over a flat
    array.  ``qsq_raw`` is the squared norm of each RAW (un-lifted) query,
    aligned element-wise with ``sq_eucl`` — required for mips only, whose
    lifted distance carries ||q||^2 (`lift_mips_data` docstring).
    """
    if metric == "euclidean":
        return np.sqrt(sq_eucl)
    if metric == "cosine":
        return sq_eucl / 2.0
    if metric == "angular":
        return np.arccos(np.clip(1.0 - sq_eucl / 2.0, -1.0, 1.0))
    if metric == "mips":
        if qsq_raw is None:
            raise ValueError("mips native distances need qsq_raw")
        # ||p~-q~||^2 = xi^2 + ||q||^2 - 2 p.q  =>  p.q (larger = nearer)
        return (xi * xi + qsq_raw - sq_eucl) / 2.0
    raise ValueError(f"unknown metric {metric!r}; valid: {VALID_METRICS}")


def native_knn_distances(idx: np.ndarray, sq: np.ndarray, metric: str,
                         xi: float = 0.0,
                         q_transformed: np.ndarray | None = None) -> np.ndarray:
    """Finalize (m, K) kNN squared Euclidean distances to the native metric.

    Shared by `core.knn.query_knn` and `baselines.KDTree.query_knn` so the
    engine and its cross-check baseline cannot drift apart.  Slots with
    ``idx < 0`` (a query asked for more neighbors than the database holds)
    stay +inf.  ``q_transformed`` is the (m, d') TRANSFORMED query block —
    required for mips, whose native value carries ‖q‖² (the lift's extra
    coordinate is 0, so ‖q~‖² == ‖q‖²).
    """
    valid = idx >= 0
    dist = np.full(idx.shape, np.inf, np.float64)
    qsq_raw = None
    if metric == "mips":
        qt = _as2d(q_transformed)
        qsq_raw = np.broadcast_to(
            np.einsum("ij,ij->i", qt, qt)[:, None], valid.shape)[valid]
    dist[valid] = native_distance(sq[valid], metric, xi, qsq_raw)
    return dist


def pairwise_sq_dists(x: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Reference O(n m d) squared distances, numerically safe (no BLAS trick)."""
    x, q = _as2d(x), _as2d(q)
    diff = x[None, :, :] - q[:, None, :]
    return np.einsum("mnd,mnd->mn", diff, diff)
