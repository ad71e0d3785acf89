"""The padding contract of the kernels, and the CSR capacity ladder.

The counterpart of ``repro.kernels.ops``, with the same contract:

* database rows pad to a multiple of the row block ``bn`` with the +BIG
  sentinel in alpha and half norm (no window or threshold keeps them);
* features pad with zeros to a multiple of ``lane`` = 128 (dot-neutral);
* queries pad to a multiple of the query tile (or to the geometric bucket
  ladder) with ``r = thresh = -BIG``, which matches nothing.

Database padding runs on the tensors' own device; queries are prepared and
padded on the host in numpy, as in the reference, and the engine moves them
to the device once per batch.

`snn_filter`, `snn_count` and `snn_compact` are the public single-segment
ops over padded operands, and `embedding_bag` the recsys table lookup, all
dispatched by `kernels.registry` (the CUDA kernels for CUDA tensors, the
plain versions for CPU tensors).  `snn_filter_tiles`, `snn_count_tiles` and
`snn_csr_compacted_stacked`, the candidate-compacted ops of the engine's
host lane, are torch operations on their tensors' device (XLA on every
lane in the reference).
"""
from __future__ import annotations

import numpy as np
import torch

from . import registry as _registry
from .ref import BIG


def pad_database(xs, alphas, half_norms, bn: int = 512, lane: int = 128):
    """Pad rows to a ``bn`` multiple (alpha/half-norm = +BIG) and features to
    a ``lane`` multiple.  Returns (xs, alphas, half_norms, n, d) as float32
    tensors on the inputs' device."""
    n, d = xs.shape
    n_pad = n + ((-n) % bn if n else bn)
    d_pad = d + (-d) % lane
    dev = xs.device
    xs_p = torch.zeros((n_pad, d_pad), dtype=torch.float32, device=dev)
    xs_p[:n, :d] = xs
    al_p = torch.full((n_pad,), BIG, dtype=torch.float32, device=dev)
    al_p[:n] = alphas
    hn_p = torch.full((n_pad,), BIG, dtype=torch.float32, device=dev)
    hn_p[:n] = half_norms
    return xs_p, al_p, hn_p, n, d


def pad_components(p, to: int, value: float = 0.0) -> np.ndarray:
    """Pad the column axis of a (ke, x) host projection block to ``to``.

    Query projections pad with 0 (their padded rows carry r = -BIG, so the
    box test is moot there); database projections pad with +BIG.
    """
    p = np.asarray(p, np.float32)
    return np.pad(p, ((0, 0), (0, to - p.shape[1])),
                  constant_values=np.float32(value))


def bucket_rows(m: int, tq: int = 128) -> int:
    """The geometric query-bucket ladder: smallest ``tq * 2^i >= m``."""
    cap = tq
    while cap < m:
        cap *= 2
    return cap


def pad_queries(q, aq, r, thresh, tq: int = 128, lane: int = 128,
                bucket: bool = False):
    """Pad host query operands to a ``tq`` multiple (or the bucket ladder).

    Padding queries get ``r = thresh = -BIG`` and match nothing.  Returns
    (q, aq, r, thresh, m) as float32 numpy arrays.
    """
    q, aq, r, thresh = (np.asarray(a, np.float32) for a in (q, aq, r, thresh))
    m, d = q.shape
    mpad = (bucket_rows(m, tq) - m) if bucket else ((-m) % tq if m else tq)
    dpad = (-d) % lane
    q = np.pad(q, ((0, mpad), (0, dpad)))
    aq = np.pad(aq, (0, mpad))
    r = np.pad(r, (0, mpad), constant_values=np.float32(-BIG))
    thresh = np.pad(thresh, (0, mpad), constant_values=np.float32(-BIG))
    return q, aq, r, thresh, m


def round_up(x: int, mult: int) -> int:
    return max(((x + mult - 1) // mult) * mult, mult)


def csr_capacity(total_neighbors: int, lane: int = 128) -> int:
    """Flat CSR capacity: total + 1 trash slot, rounded up to a power of two
    of whole lanes, so a stream of result sizes uses O(log nnz) shapes."""
    need = round_up(total_neighbors + 1, lane)
    cap = lane
    while cap < need:
        cap *= 2
    return cap


def snn_filter(q, aq, r, thresh, xs, alphas, half_norms, pq=None, px=None, *,
               bn: int = 512):
    """Masked half distances (m_pad, n_pad): ``hn - q.x`` where the window,
    radius and (with ``pq``/``px``, the (ke, m_pad) / (ke, n_pad) extra
    projections) box tests keep the pair, +BIG elsewhere."""
    return _registry.snn_filter(q, aq, r, thresh, xs, alphas, half_norms,
                                pq, px, bn=bn)


def snn_count(q, aq, r, thresh, xs, alphas, half_norms, pq=None, px=None, *,
              bn: int = 512, mixed: bool = False):
    """Per-query neighbour counts (m_pad,) int32 over one segment;
    ``mixed=True`` counts with bf16 products under the margin certificate
    (the counts stay the float32 counts)."""
    return _registry.snn_count(q, aq, r, thresh, xs, alphas, half_norms, pq,
                               px, bn=bn, mixed=mixed)


def snn_compact(q, aq, r, thresh, offsets, xs, alphas, half_norms, pq=None,
                px=None, *, nnz: int, bn: int = 512):
    """Pass-2 CSR compaction over one segment.

    Returns (idx (nnz,) int32 sorted-row positions, dhalf (nnz,) f32);
    query k's survivors fill slots ``offsets[k]`` onward, and the other
    slots, the trailing trash slot included, hold -1 / +BIG.
    """
    return _registry.snn_compact(q, aq, r, thresh, offsets, xs, alphas,
                                 half_norms, pq, px, nnz=nnz, bn=bn)


def snn_filter_tiles(qt, aqt, rt, tht, xt, alt, hnt, pqt=None, pxt=None):
    """Candidate-compacted tile filter: (T, p, C) masked half distances.

    ``qt`` (T, p, d) query tiles against ``xt`` (T, C, d) gathered candidate
    rows; padding candidate slots must carry alpha = half_norm = +BIG.  A
    kept entry is the dense `snn_filter`'s value for the same pair up to
    the float32 rounding of a differently shaped product.
    """
    return _registry.snn_filter_tiles(qt, aqt, rt, tht, xt, alt, hnt, pqt,
                                      pxt)


def snn_count_tiles(qt, aqt, rt, tht, xt, alt, hnt, pqt=None, pxt=None, *,
                    mixed: bool = False):
    """Candidate-compacted tile counts: (T, p) int32 survivors per query."""
    return _registry.snn_count_tiles(qt, aqt, rt, tht, xt, alt, hnt, pqt,
                                     pxt, mixed=mixed)


def snn_csr_compacted_stacked(q, aq, r, thresh, xs, alphas, half_norms,
                              pq=None, px=None, *, ptile: int, ccap: int,
                              nnz_cap: int):
    """Single-dispatch candidate-compacted CSR over a segment stack.

    Speculative static capacities ``ccap``/``nnz_cap``; see
    `kernels.ref.snn_csr_compacted_stacked_ref` for the overflow contract.
    """
    return _registry.snn_csr_compacted_stacked(
        q, aq, r, thresh, xs, alphas, half_norms, pq, px, ptile=ptile,
        ccap=ccap, nnz_cap=nnz_cap)


def embedding_bag(ids, table, *, mode: str = "sum"):
    """EmbeddingBag over (B, F) int32 ids with -1 (any id < 0) padding:
    (B, D) in the table's dtype; modes ``sum`` | ``mean``.

    The sum is the kernel's (slot order, rounded to the table's dtype after
    each add); ``mean`` divides it by ``max(#ids >= 0, 1)`` in the table's
    dtype, as ``repro.kernels.ops.embedding_bag`` does.  An id at or above
    V reads row V - 1, on the card and on the CPU alike (the Pallas
    kernel's clamp; XLA's ``jnp.take`` would give NaN rows instead).
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"unknown mode {mode!r}")
    out = _registry.embedding_bag(ids, table)
    if mode == "mean":
        cnt = (ids >= 0).sum(dim=1).clamp_min(1).to(out.dtype)
        out = out / cnt[:, None]
    return out
