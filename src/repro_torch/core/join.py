"""Point queries as single-chunk joins: the front-end over the engine.

The counterpart of the point-query and count-only front-ends of
``repro.core.join``: a batch of point queries is the bichromatic join whose
A side is one chunk, so `single_query` hands the whole batch to the packed
engine, and `query_counts` stops after pass 1.  The chunked bichromatic
join, the self-join graph and the reverse and analytics front-ends are not
ported yet.
"""
from __future__ import annotations

import numpy as np

from ..kernels import ops as _ops
from ..kernels import registry as _registry
from . import engine as _engine
from . import snn as _snn


def indptr_from_counts(counts: np.ndarray) -> np.ndarray:
    out = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts, out=out[1:])
    return out


def _resolve_pack(index, block: int, device=None):
    """(owner, pack) for an `SNNIndex`: ``owner`` holds the mu/v1/metric/xi
    every predicate derives from; ``pack`` is its cached plan on the device
    the call runs on (`resolve_device`: the card unless ``"cpu"``)."""
    dev = _registry.resolve_device(device)
    return index, index.pack(block, dev)


def single_query(index, q, radius, return_distance: bool = True, *,
                 pack=None, block: int = 512, query_tile: int = 128,
                 native: bool = True, mixed: bool = False,
                 bucket: bool = True, fused: bool = True,
                 device=None) -> _snn.CSRNeighbors:
    """A point-query batch through the packed engine over ``pack`` (default:
    the index's cached plan on ``device``)."""
    if pack is None:
        index, pack = _resolve_pack(index, block, device)
    return _engine.query_csr_packed(
        index, pack, q, radius, return_distance, query_tile=query_tile,
        native=native, mixed=mixed, bucket=bucket, fused=fused)


def query_counts(index, q, radius, *, block: int = 512,
                 query_tile: int = 128, mixed: bool = False,
                 bucket: bool = True, device=None) -> np.ndarray:
    """Exact neighbour counts per query: pass 1 only, no CSR.

    The same predicate pipeline as `snn.query_radius_csr`, so the counts
    equal ``np.diff(csr.indptr)`` of the full query exactly.  ``radius`` is
    a scalar or per-query (m,) vector in the native metric.
    """
    owner, pack = _resolve_pack(index, block, device)
    xq, aq, r32, th, qsq = _snn.prepare_query_predicates(owner, q, radius)
    qp, aqp, rp, thp, m = _ops.pad_queries(xq, aq, r32, th, tq=query_tile,
                                           bucket=bucket)
    pq = _snn.query_extra_projections(owner, xq)
    pqp = None if pq is None else _ops.pad_components(pq, qp.shape[0])
    return _engine.run_counts_packed(pack, qp, aqp, rp, thp, m,
                                     query_tile=query_tile, pq=pqp,
                                     mixed=mixed)
