"""Plain PyTorch versions of the kernels, and the predicate formulas.

The counterpart of ``repro.kernels.ref``: the same constants, the same
float32 expression trees, on torch tensors.  The kernel dispatcher
(`kernels.registry`) sends CPU tensors here; CUDA tensors go to the
hand-written kernels of `kernels.snn_query`, which evaluate the same
formulas term for term.  Only a comparison of kernel against plain version
calls these functions on CUDA tensors directly.

Like the kernels, every function takes per-query radius/threshold vectors
``r``/``thresh``; there is no scalar-radius form at this layer.

* ``box_mask`` is the k-dim Cauchy-Schwarz box bound: for any direction v
  with ``||v|| <= 1``, ``||x - q|| <= r`` implies ``|<x, v> - <q, v>| <= r``,
  so extra projections prune pairs without ever dropping a true neighbour.
* ``mixed_keep_ref`` is the bf16 margin certificate: the count pass may take
  its products in bfloat16 as long as every pair whose bf16 half distance
  lands within ``MIX_EPS * ||x|| * ||q||`` of the threshold is re-verified
  with the exact float32 predicate, so mixed counts equal float32 counts.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = float(np.finfo(np.float32).max / 8)

# Box-bound slack, relative to ||x|| + ||q|| + r (see repro.kernels.ref: it
# covers the float32 rounding of the projections and of the predicate, so the
# box may only ever be loose, never clipping).
BOX_EPS = 1e-2

# bf16 margin, relative to ||x|| * ||q||: about 4x the 2^-8 error of rounding
# both operands to bfloat16, up to d ~ 1e5.
MIX_EPS = 1.0 / 64.0


def norm_scales(r, thresh, half_norms):
    """(xnorm (n,), qnorm (m,)) recovered from the predicate operands.

    ``qsq = r^2 - 2*thresh`` inverts `core.snn.prepare_query_predicates`.
    Padding queries (r = thresh = -BIG) overflow to qnorm = +inf, which only
    widens their slack; their alpha window rejects everything anyway.
    """
    xn = torch.sqrt(torch.clamp_min(2.0 * half_norms, 0.0))
    qn = torch.sqrt(torch.clamp_min(r * r - 2.0 * thresh, 0.0))
    return xn, qn


def box_mask(pq, px, r, thresh, half_norms):
    """k-dim box test -> (m, n) bool mask; True means "may be a neighbour".

    ``pq`` (ke, m) / ``px`` (ke, n) are the EXTRA projection components
    (component 0 is the alpha window the caller already applied).
    """
    xn, qn = norm_scales(r, thresh, half_norms)
    lim = r[:, None] + BOX_EPS * (xn[None, :] + qn[:, None]
                                  + torch.abs(r)[:, None])
    ok = torch.abs(px[0][None, :] - pq[0][:, None]) <= lim
    for c in range(1, pq.shape[0]):
        ok = ok & (torch.abs(px[c][None, :] - pq[c][:, None]) <= lim)
    return ok


def _bf16_dhalf(q, xs, half_norms):
    """Half distances with both operands rounded to bfloat16 and the products
    summed in float32 (bf16 x bf16 products are exact in float32)."""
    q16 = q.to(torch.bfloat16).to(torch.float32)
    x16 = xs.to(torch.bfloat16).to(torch.float32)
    return half_norms[None, :] - q16 @ x16.T


def mixed_keep_ref(q, aq, r, thresh, xs, alphas, half_norms,
                   pq=None, px=None):
    """(m, n) keep mask of the bf16 count pass under the margin certificate.

    Equal to the float32 mask: pairs at least ``margin`` below the threshold
    in bf16 are in, at least ``margin`` above are out, and the band between
    is re-verified with the exact float32 predicate.
    """
    geom = torch.abs(alphas[None, :] - aq[:, None]) <= r[:, None]
    if pq is not None:
        geom = geom & box_mask(pq, px, r, thresh, half_norms)
    dh16 = _bf16_dhalf(q, xs, half_norms)
    xn, qn = norm_scales(r, thresh, half_norms)
    margin = MIX_EPS * xn[None, :] * qn[:, None]
    thc = thresh[:, None]
    definite = geom & (dh16 <= thc - margin)
    band = geom & (dh16 > thc - margin) & (dh16 <= thc + margin)
    dh32 = half_norms[None, :] - q @ xs.T
    return definite | (band & (dh32 <= thc))


def snn_filter_ref(q, aq, r, thresh, xs, alphas, half_norms,
                   pq=None, px=None):
    """Masked half distances (m, n): ``hn - q.x`` where the pair is kept,
    +BIG elsewhere.  ``pq``/``px`` (both given or both None) add the box."""
    dhalf = half_norms[None, :] - q @ xs.T
    inwin = torch.abs(alphas[None, :] - aq[:, None]) <= r[:, None]
    keep = inwin & (dhalf <= thresh[:, None])
    if pq is not None:
        keep = keep & box_mask(pq, px, r, thresh, half_norms)
    return torch.where(keep, dhalf, torch.full_like(dhalf, BIG))


def snn_count_ref(q, aq, r, thresh, xs, alphas, half_norms, pq=None,
                  px=None, *, bn: int = 512, mixed: bool = False,
                  with_partials: bool = False):
    """Plain version of `kernels.snn_query.snn_count`: per-query survivor
    counts (m,) int32 over one segment (``mixed`` = the bf16 count pass),
    and with ``with_partials`` also the (m, n_pad // bn) per-row-block
    counts."""
    if mixed:
        keep = mixed_keep_ref(q, aq, r, thresh, xs, alphas, half_norms,
                              pq, px)
    else:
        keep = snn_filter_ref(q, aq, r, thresh, xs, alphas, half_norms,
                              pq, px) < BIG
    counts = keep.sum(dim=1, dtype=torch.int32)
    if not with_partials:
        return counts
    m, n_pad = keep.shape
    return counts, keep.reshape(m, n_pad // bn, bn).sum(dim=2,
                                                        dtype=torch.int32)


def snn_compact_ref(q, aq, r, thresh, offsets, xs, alphas, half_norms,
                    pq=None, px=None, *, nnz: int, partials=None):
    """Plain version of `kernels.snn_query.snn_compact`.

    Survivor j of query k (in ascending row order) lands in flat slot
    ``offsets[k] + j`` as (local sorted row, dhalf).  ``nnz`` includes one
    trailing trash slot; a slot outside ``[0, nnz - 1)`` is not written, and
    unwritten slots, the trash slot included, hold -1 / +BIG.  ``partials``
    is accepted for the kernel's signature and not needed here.
    """
    del partials
    dev = q.device
    out_idx = torch.full((nnz,), -1, dtype=torch.int32, device=dev)
    out_dh = torch.full((nnz,), BIG, dtype=torch.float32, device=dev)
    dh = snn_filter_ref(q, aq, r, thresh, xs, alphas, half_norms, pq, px)
    keep = dh < BIG
    within = torch.cumsum(keep, dim=1) - 1
    rows, cols = torch.nonzero(keep, as_tuple=True)
    slots = offsets[rows].to(torch.int64) + within[rows, cols]
    ok = (slots >= 0) & (slots < nnz - 1)
    out_idx[slots[ok]] = cols[ok].to(torch.int32)
    out_dh[slots[ok]] = dh[rows[ok], cols[ok]]
    return out_idx, out_dh


def _flatten_stacked(xs, alphas, half_norms, px):
    """A (S, n_pad, d) stack as one (S*n_pad, d) database (pack-flat rows);
    ``px`` (S, ke, n_pad) becomes (ke, S*n_pad)."""
    flat = (xs.reshape(-1, xs.shape[-1]), alphas.reshape(-1),
            half_norms.reshape(-1))
    if px is None:
        return flat + (None,)
    return flat + (px.permute(1, 0, 2).reshape(px.shape[1], -1),)


def snn_count_stacked_ref(q, aq, r, thresh, xs, alphas, half_norms,
                          pq=None, px=None, *, bn: int = 512,
                          mixed: bool = False, with_partials: bool = False):
    """Plain version of `kernels.snn_query.snn_count_stacked`.

    Returns per-(segment, query) survivor counts (S, m) int32, and with
    ``with_partials`` also the (S, m, n_pad // bn) per-row-block counts.
    The stack is flattened into one database, so the pass is one product.
    """
    S, n_pad, _ = xs.shape
    m = q.shape[0]
    xf, alf, hnf, pxf = _flatten_stacked(xs, alphas, half_norms, px)
    if mixed:
        keep = mixed_keep_ref(q, aq, r, thresh, xf, alf, hnf, pq, pxf)
    else:
        keep = snn_filter_ref(q, aq, r, thresh, xf, alf, hnf, pq, pxf) < BIG
    per = keep.reshape(m, S, n_pad).sum(dim=2, dtype=torch.int32).T
    per = per.contiguous()
    if not with_partials:
        return per
    partials = keep.reshape(m, S, n_pad // bn, bn).sum(dim=3,
                                                       dtype=torch.int32)
    return per, partials.permute(1, 0, 2).contiguous()


def stacked_prefix(per):
    """Prefix sums of the packed engine, on the tensors' own device.

    ``per`` is (S, m) int32.  Returns (counts (m,), indptr (m+1,),
    offsets (S, m)), all int32: ``offsets[s, k]`` is the flat CSR slot of
    segment s's first survivor for query k, the global row base plus the
    segment-axis exclusive prefix.
    """
    counts = per.sum(dim=0, dtype=torch.int32)
    indptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=per.device),
                        torch.cumsum(counts, 0, dtype=torch.int32)])
    offsets = indptr[:-1][None, :] + (torch.cumsum(per, 0, dtype=torch.int32)
                                      - per)
    return counts, indptr, offsets


def snn_compact_stacked_ref(q, aq, r, thresh, offsets, xs, alphas,
                            half_norms, pq=None, px=None, *, nnz: int,
                            partials=None):
    """Plain version of `kernels.snn_query.snn_compact_stacked`.

    Returns flat (idx (nnz,) int32 pack-flat ids ``s * n_pad + row``,
    dhalf (nnz,) float32).  Survivor k of segment s for query i lands in slot
    ``offsets[s, i] + (its rank in that row)``; unwritten slots and the
    trailing trash slot hold -1 / +BIG.  When ``total + 1 > nnz`` nothing is
    written.  ``partials`` (pass 1's per-row-block counts, which spare the
    kernel a recount) is accepted for the same signature and not needed here.
    """
    del partials
    S, n_pad, _ = xs.shape
    m = q.shape[0]
    dev = q.device
    out_idx = torch.full((nnz,), -1, dtype=torch.int32, device=dev)
    out_dh = torch.full((nnz,), BIG, dtype=torch.float32, device=dev)
    xf, alf, hnf, pxf = _flatten_stacked(xs, alphas, half_norms, px)
    dh = snn_filter_ref(q, aq, r, thresh, xf, alf, hnf, pq, pxf)
    rows, cols = torch.nonzero(dh < BIG, as_tuple=True)  # row-major order
    if rows.numel() + 1 > nnz:
        return out_idx, out_dh
    if rows.numel() == 0:
        return out_idx, out_dh
    # rank of each survivor within its (query, segment) group: survivors of
    # a group are contiguous in row-major order
    seg = torch.div(cols, n_pad, rounding_mode="floor")
    group = rows * S + seg
    pos = torch.arange(group.numel(), device=dev)
    first = torch.ones_like(group, dtype=torch.bool)
    first[1:] = group[1:] != group[:-1]
    start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                         dim=0).values
    slots = offsets[seg, rows].to(torch.int64) + (pos - start)
    out_idx[slots] = cols.to(torch.int32)
    out_dh[slots] = dh[rows, cols]
    return out_idx, out_dh


def embedding_bag_ref(ids, table):
    """Plain version of the embedding_bag kernel: (B, F) int32 ids over a
    (V, D) table -> (B, D) in the table's dtype.

    It follows the Pallas TPU kernel's arithmetic
    (``repro.kernels.embedding_bag._bag_kernel``), not XLA's reduce: the
    output starts at zero in the table's dtype and adds
    ``w_f * table[max(id, 0)]``, ``w_f = (id >= 0)``, for f = 0 .. F-1 in
    order, rounding to the table's dtype after each add.  For float32 that
    is the plain sequential sum; for bfloat16 bags of more than one id it
    can differ from ``repro.kernels.ref.embedding_bag_ref``, which XLA sums
    in another order and rounds once.

    An id at or above V reads row V - 1, as the Pallas kernel's block index
    does off the TPU (its dynamic slice is clamped into the table) and as
    the CUDA kernel does.
    """
    out = torch.zeros((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    last = table.shape[0] - 1
    for f in range(ids.shape[1]):
        col = ids[:, f]
        w = (col >= 0).to(table.dtype)[:, None]
        out = out + w * table[col.clamp(0, last).long()]
    return out


def bag_range_keys(ids, n_rows: int, rows_per_range: int):
    """Plain version of the blocked order's range key: the range
    ``clamp(id, 0, n_rows - 1) // rows_per_range`` of table rows each id
    reads (padding reads row 0, an id past the table row n_rows - 1), as
    int64."""
    rows = ids.to(torch.int64).clamp(0, n_rows - 1)
    return torch.div(rows, rows_per_range, rounding_mode="floor")


# --------------------------------------------------------------------------- #
# Filter-derived passes and the candidate-compacted tile evaluation            #
# --------------------------------------------------------------------------- #
# The host lane's executors (`core.engine`, ``oracle=True``) evaluate one
# masked filter and derive both passes from it, or evaluate the same
# predicate on gathered candidate rows only.  The reference runs these as
# XLA on every lane; here they are torch operations on the tensors' own
# device.  A gathered candidate keeps the dense decision because the keep
# expressions are the same elementwise float32 formulas as `snn_filter_ref`
# and `box_mask`, evaluated on the same operand values.


def stacked_counts_from_filter(dh, *, n_seg: int):
    """(m, S*n_pad) masked filter -> per-(segment, query) counts (S, m)."""
    m = dh.shape[0]
    keep = (dh < BIG).reshape(m, n_seg, -1)
    return keep.sum(dim=2, dtype=torch.int32).T.contiguous()


def snn_compact_stacked_from_filter(dh, offsets, *, n_seg: int, nnz: int):
    """Pass-2 scatter from an already evaluated stacked filter.

    ``dh`` is the (m, S*n_pad) `snn_filter_ref` output over the flattened
    stack, ``offsets`` `stacked_prefix`'s (S, m).  Returns pack-flat (idx,
    dhalf) under `snn_compact_stacked_ref`'s conventions: survivor j of
    segment s for query i lands in ``offsets[s, i] + j``; slots at or past
    the trailing trash slot are dropped, and the trash slot ends -1 / +BIG.
    """
    m, cols_n = dh.shape
    dev = dh.device
    keep3 = (dh < BIG).reshape(m, n_seg, -1)
    within = torch.cumsum(keep3, dim=2, dtype=torch.int64) - 1
    trash = nnz - 1
    pos = torch.where(keep3, offsets.T[:, :, None].to(torch.int64) + within,
                      torch.full_like(within, trash)).reshape(-1)
    cols = torch.arange(cols_n, dtype=torch.int32,
                        device=dev).expand(m, cols_n).reshape(-1)
    ok = (pos >= 0) & (pos < nnz)
    out_idx = torch.full((nnz,), -1, dtype=torch.int32, device=dev)
    out_dh = torch.full((nnz,), BIG, dtype=torch.float32, device=dev)
    out_idx[pos[ok]] = cols[ok]
    out_dh[pos[ok]] = dh.reshape(-1)[ok]
    out_idx[trash] = -1
    out_dh[trash] = BIG
    return out_idx, out_dh


def _box_mask_tiles(pqt, pxt, rt, tht, hnt):
    """`box_mask` over candidate tiles: (ke, T, p) x (ke, T, C) -> (T, p, C),
    the same float32 expression tree element for element."""
    xn = torch.sqrt(torch.clamp_min(2.0 * hnt, 0.0))              # (T, C)
    qn = torch.sqrt(torch.clamp_min(rt * rt - 2.0 * tht, 0.0))    # (T, p)
    lim = rt[:, :, None] + BOX_EPS * (xn[:, None, :] + qn[:, :, None]
                                      + torch.abs(rt)[:, :, None])
    ok = torch.abs(pxt[0][:, None, :] - pqt[0][:, :, None]) <= lim
    for c in range(1, pqt.shape[0]):
        ok = ok & (torch.abs(pxt[c][:, None, :] - pqt[c][:, :, None]) <= lim)
    return ok


def _tiles_body(qt, aqt, rt, tht, xt, alt, hnt, pqt=None, pxt=None):
    """(keep, dhalf) over query tiles x gathered candidate tiles.

    ``qt`` (T, p, d) query tiles against ``xt`` (T, C, d) gathered
    candidate rows, one batched product (``torch.bmm``) that reduces each
    pair's d-length vectors as the dense ``q @ xs.T`` does; per-tile
    vectors follow.
    """
    dhalf = hnt[:, None, :] - torch.bmm(qt, xt.transpose(1, 2))
    keep = (torch.abs(alt[:, None, :] - aqt[:, :, None]) <= rt[:, :, None]) \
        & (dhalf <= tht[:, :, None])
    if pqt is not None:
        keep = keep & _box_mask_tiles(pqt, pxt, rt, tht, hnt)
    return keep, dhalf


def snn_filter_tiles_ref(qt, aqt, rt, tht, xt, alt, hnt, pqt=None, pxt=None):
    """Masked half distances over candidate tiles: (T, p, C), +BIG where
    the pair is not kept.  Padding candidate slots carry alpha = half_norm
    = +BIG, so no predicate keeps them."""
    keep, dhalf = _tiles_body(qt, aqt, rt, tht, xt, alt, hnt, pqt, pxt)
    return torch.where(keep, dhalf, torch.full_like(dhalf, BIG))


def snn_count_tiles_ref(qt, aqt, rt, tht, xt, alt, hnt, pqt=None, pxt=None,
                        *, mixed: bool = False):
    """Per-query survivor counts (T, p) int32 over candidate tiles;
    ``mixed`` takes the products in bfloat16 under the margin certificate
    (`mixed_keep_ref`), whose counts equal the float32 counts."""
    if not mixed:
        keep, _ = _tiles_body(qt, aqt, rt, tht, xt, alt, hnt, pqt, pxt)
        return keep.sum(dim=2, dtype=torch.int32)
    geom = torch.abs(alt[:, None, :] - aqt[:, :, None]) <= rt[:, :, None]
    if pqt is not None:
        geom = geom & _box_mask_tiles(pqt, pxt, rt, tht, hnt)
    q16 = qt.to(torch.bfloat16).to(torch.float32)
    x16 = xt.to(torch.bfloat16).to(torch.float32)
    dh16 = hnt[:, None, :] - torch.bmm(q16, x16.transpose(1, 2))
    xn = torch.sqrt(torch.clamp_min(2.0 * hnt, 0.0))
    qn = torch.sqrt(torch.clamp_min(rt * rt - 2.0 * tht, 0.0))
    margin = MIX_EPS * xn[:, None, :] * qn[:, :, None]
    thc = tht[:, :, None]
    definite = geom & (dh16 <= thc - margin)
    band = geom & (dh16 > thc - margin) & (dh16 <= thc + margin)
    _, dh32 = _tiles_body(qt, aqt, rt, tht, xt, alt, hnt)
    keep = definite | (band & (dh32 <= thc))
    return keep.sum(dim=2, dtype=torch.int32)


def snn_csr_compacted_stacked_ref(q, aq, r, thresh, xs, alphas, half_norms,
                                  pq=None, px=None, *, ptile: int, ccap: int,
                                  nnz_cap: int):
    """Candidate-compacted two-pass CSR over a segment stack, on the
    tensors' device with no host sync.

    Chains (1) the window and box predicate on the resident projections,
    unioned over each ``ptile``-query tile; (2) an exclusive scan that
    compacts the surviving pack-flat rows into dense (T, ccap) candidate
    tiles; (3) the float32 contraction on the gathered rows only
    (`_tiles_body`); (4) per-query counts, the CSR prefix and the flat
    scatter.

    Returns ``(indptr (m_pad+1,) i32, idx (nnz_cap,) i32 pack-flat, dhalf
    (nnz_cap,) f32, total () i32, cand_max () i32)``.  ``ccap`` and
    ``nnz_cap`` are speculative capacities: when ``cand_max > ccap`` or
    ``total + 1 > nnz_cap`` the compact outputs are invalid (the writes
    past a capacity are dropped, never made out of bounds) and the caller
    reruns a path of the right size.
    """
    S, n_pad, d = xs.shape
    N = S * n_pad
    dev = xs.device
    xf = xs.reshape(N, d)
    alf = alphas.reshape(N)
    hnf = half_norms.reshape(N)
    pxf = None if px is None else px.permute(1, 0, 2).reshape(px.shape[1], N)
    m_pad = q.shape[0]
    T = m_pad // ptile
    qt = q.reshape(T, ptile, d)
    aqt, rt, tht = (a.reshape(T, ptile) for a in (aq, r, thresh))
    pqt = None if pq is None else pq.reshape(pq.shape[0], T, ptile)

    # (1) the cheap predicate, unioned over the tile's queries
    sel = torch.abs(alf[None, None, :] - aqt[:, :, None]) <= rt[:, :, None]
    if pqt is not None:
        xn = torch.sqrt(torch.clamp_min(2.0 * hnf, 0.0))
        qn = torch.sqrt(torch.clamp_min(rt * rt - 2.0 * tht, 0.0))
        lim = rt[:, :, None] + BOX_EPS * (xn[None, None, :] + qn[:, :, None]
                                          + torch.abs(rt)[:, :, None])
        for c in range(pqt.shape[0]):
            sel = sel & (torch.abs(pxf[c][None, None, :]
                                   - pqt[c][:, :, None]) <= lim)
    candmask = sel.any(dim=1)                                 # (T, N)

    # (2) exclusive-scan compaction into dense candidate tiles
    cpos = torch.cumsum(candmask, dim=1, dtype=torch.int32)
    cand_max = cpos[:, -1].max() if N else torch.zeros((), dtype=torch.int32,
                                                       device=dev)
    cpos = cpos - 1
    tt, cc = torch.nonzero(candmask & (cpos < ccap), as_tuple=True)
    cand = torch.full((T, ccap), N, dtype=torch.int32, device=dev)
    cand[tt, cpos[tt, cc].to(torch.int64)] = cc.to(torch.int32)

    # (3) gather and the float32 evaluation on the candidates only
    valid = cand < N
    candc = torch.clamp_max(cand, N - 1).to(torch.int64)
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
    xt = xf[candc]
    alt = torch.where(valid, alf[candc], big)
    hnt = torch.where(valid, hnf[candc], big)
    pxt = None
    if pxf is not None:
        pxt = torch.where(valid[None, :, :], pxf[:, candc], big)
    keep, dhalf = _tiles_body(qt, aqt, rt, tht, xt, alt, hnt, pqt, pxt)

    # (4) counts, the CSR prefix and the flat scatter
    counts = keep.sum(dim=2, dtype=torch.int32).reshape(m_pad)
    indptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(counts, 0, dtype=torch.int32)])
    total = indptr[-1]
    within = torch.cumsum(keep, dim=2, dtype=torch.int64) - 1
    trash = nnz_cap - 1
    base = indptr[:-1].reshape(T, ptile).to(torch.int64)
    pos = torch.where(keep, base[:, :, None] + within,
                      torch.full_like(within, trash)).reshape(-1)
    ok = pos < nnz_cap
    flat_cols = cand[:, None, :].expand(keep.shape).reshape(-1)
    out_idx = torch.full((nnz_cap,), -1, dtype=torch.int32, device=dev)
    out_dh = torch.full((nnz_cap,), BIG, dtype=torch.float32, device=dev)
    out_idx[pos[ok]] = flat_cols[ok]
    out_dh[pos[ok]] = dhalf.reshape(-1)[ok]
    out_idx[trash] = -1
    out_dh[trash] = BIG
    return indptr, out_idx, out_dh, total, cand_max.to(torch.int32)
