"""The port's main path against the JAX reference: query_radius_csr.

Both packages query the very same index: the JAX package builds it and the
port takes its arrays through `index_from_arrays`.  Everything runs on the
CPU (``device="cpu"``), where the port's engine runs its device
orchestration with the plain versions of the kernels.

Tolerances, and why: ``indptr`` and ``indices`` must be equal, row order
included.  The two packages take their float32 products in different
libraries, so a pair may be decided differently only when its half
distance lies within the float32 rounding band of the threshold,
``d * 2^-23 * (hn + |q.x|)``; every such pair is asserted to lie in the
band.  For the same reason half distances agree to that band, and
native distances to rtol 1e-5.  On the exact constructions of
``tests/test_exactness_certificate.py`` (integer lattices, ulp plants)
there is no rounding at all, and results must be identical to the
reference and to a float64 oracle.
"""
import importlib

import numpy as np
import pytest

from repro.core import snn as jsnn
from repro_torch.core import engine as tengine
from repro_torch.core import snn as tsnn
from repro_torch.kernels import ops as tops

# the package exports the function `join`, which shadows the module name
tjoin = importlib.import_module("repro_torch.core.join")

EPS32 = 2.0 ** -23


def _port_index(index):
    """The port's view of a JAX-built index (the state carried across)."""
    return tsnn.index_from_arrays(index.mu, index.v1, index.xs, index.alphas,
                                  index.half_norms, index.order, index.metric,
                                  index.xi, index.vs, index.projs,
                                  device="cpu")


def _band(index, q, radius, rows_pos):
    """|dhalf64 - thresh64| and the rounding band for (query, sorted row)."""
    xq, _, _, thresh, _ = jsnn.prepare_query_predicates(index, q, radius)
    qi, pos = rows_pos
    x64 = np.asarray(index.xs, np.float64)[pos]
    q64 = np.asarray(xq, np.float64)[qi]
    hn = np.asarray(index.half_norms, np.float64)[pos]
    dot = np.einsum("ij,ij->i", x64, q64)
    gap = np.abs(hn - dot - thresh.astype(np.float64)[qi])
    return gap, index.d * EPS32 * (hn + np.abs(dot))


def _assert_parity(index, q, radius, want, got):
    """Rows equal (order included) up to pairs inside the rounding band."""
    inv = np.empty_like(index.order)
    inv[index.order] = np.arange(index.n)
    band = []
    for i in range(want.m):
        a, b = want.row(i)[0], got.row(i)[0]
        if not np.array_equal(a, b):
            diff = np.setxor1d(a, b)
            band += [(i, int(inv[j])) for j in diff]
            keep_a, keep_b = a[~np.isin(a, diff)], b[~np.isin(b, diff)]
            np.testing.assert_array_equal(keep_a, keep_b)
    if band:
        gap, tol = _band(index, q, radius, np.asarray(band).T)
        assert np.all(gap <= tol), "a pair outside the rounding band differs"
    else:
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
    return len(band)


METRIC_CASES = {
    # metric: (radius, per-query radius range)
    "euclidean": (2.6, (2.0, 3.2)),
    "cosine": (0.45, (0.3, 0.6)),
    "angular": (0.95, (0.8, 1.1)),
    "mips": (1.5, (0.5, 2.5)),
}


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("metric", sorted(METRIC_CASES))
def test_query_radius_csr_matches_reference(metric, per_query):
    rng = np.random.default_rng(100 + len(metric) + per_query)
    x = rng.normal(size=(900, 10)).astype(np.float32)
    x[:, 5:] *= 0.3
    q = rng.normal(size=(45, 10)).astype(np.float32)
    r0, (lo, hi) = METRIC_CASES[metric]
    radius = rng.uniform(lo, hi, size=45) if per_query else r0
    jidx = jsnn.build_index(x, metric=metric)
    tidx = _port_index(jidx)
    want = jsnn.query_radius_csr(jidx, q, radius)
    got = tsnn.query_radius_csr(tidx, q, radius, device="cpu")
    assert want.nnz > 0
    assert _assert_parity(jidx, q, radius, want, got) == 0
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5)
    # half distances agree to the band (squared Euclidean = 2 dhalf + |q|^2)
    sq_w = jsnn.query_radius_csr(jidx, q, radius, native=False).distances
    sq_g = tsnn.query_radius_csr(tidx, q, radius, native=False,
                                 device="cpu").distances
    qi = np.repeat(np.arange(want.m), np.diff(want.indptr))
    inv = np.empty_like(jidx.order)
    inv[jidx.order] = np.arange(jidx.n)
    _, tol = _band(jidx, q, radius, (qi, inv[want.indices]))
    assert np.all(np.abs(sq_g - sq_w) / 2.0 <= tol)
    # counts, mixed and the fused second batch through the same slice
    counts = tjoin.query_counts(tidx, q, radius, device="cpu")
    np.testing.assert_array_equal(tjoin.indptr_from_counts(counts),
                                  got.indptr)
    for res in (tsnn.query_radius_csr(tidx, q, radius, mixed=True,
                                      device="cpu"),
                tsnn.query_radius_csr(tidx, q, radius, device="cpu")):
        np.testing.assert_array_equal(res.indptr, got.indptr)
        np.testing.assert_array_equal(res.indices, got.indices)
        np.testing.assert_array_equal(res.distances, got.distances)


# --------------------------------------------------------------------------- #
# (d) the fused path                                                           #
# --------------------------------------------------------------------------- #
def _fused_setup():
    rng = np.random.default_rng(21)
    jidx = jsnn.build_index(rng.normal(size=(800, 8)).astype(np.float32))
    tidx = _port_index(jidx)
    q = rng.normal(size=(50, 8)).astype(np.float32)
    return jidx, tidx, q, tidx.pack(512, "cpu")


def _run(tidx, pack, q, radius, fused=True):
    tengine.DISPATCH_STATS.reset()
    res = tjoin.single_query(tidx, q, radius, pack=pack, fused=fused)
    return res, tengine.DISPATCH_STATS.snapshot()


def test_fused_second_batch_one_transfer_and_identical():
    jidx, tidx, q, pack = _fused_setup()
    first, s1 = _run(tidx, pack, q, 1.4)
    second, s2 = _run(tidx, pack, q, 1.4)
    classic, s3 = _run(tidx, pack, q, 1.4, fused=False)
    assert s1["host_transfers"] == 3      # classic: indptr, then ids, dhalf
    assert s2["host_transfers"] == 1      # fused: one copy of the result
    assert s3["host_transfers"] == 3
    for res in (second, classic):
        np.testing.assert_array_equal(res.indptr, first.indptr)
        np.testing.assert_array_equal(res.indices, first.indices)
        np.testing.assert_array_equal(res.distances, first.distances)
    want = jsnn.query_radius_csr(jidx, q, 1.4)
    np.testing.assert_array_equal(second.indices, want.indices)


def test_fused_capacity_ratchet_after_overflow():
    jidx, tidx, q, pack = _fused_setup()
    small, _ = _run(tidx, pack, q, 0.8)
    (spec,) = pack._spec.values()
    cap0 = spec["nnz_cap"]
    assert cap0 == tops.csr_capacity(small.nnz)
    big, s_over = _run(tidx, pack, q, 2.5)   # overflows the speculation
    assert big.nnz + 1 > cap0
    assert s_over["host_transfers"] == 1 + 3   # fused try, then classic
    assert spec["nnz_cap"] == tops.csr_capacity(big.nnz) > cap0
    again, s_again = _run(tidx, pack, q, 2.5)
    assert s_again["host_transfers"] == 1      # fused at the new capacity
    want = jsnn.query_radius_csr(jidx, q, 2.5)
    for res in (big, again):
        np.testing.assert_array_equal(res.indptr, want.indptr)
        np.testing.assert_array_equal(res.indices, want.indices)
    # a successor plan adopts the learned capacity and opens fused
    succ = tengine.pack_from_index(tidx, device="cpu")
    succ.adopt_spec(pack)
    _, s_succ = _run(tidx, succ, q, 2.5)
    assert s_succ["host_transfers"] == 1


def test_memory_plan_accounted_once_per_bucket():
    _, tidx, q, pack = _fused_setup()
    tengine.DISPATCH_STATS.reset()
    tjoin.single_query(tidx, q, 1.0, pack=pack)
    planned = tengine.DISPATCH_STATS.bytes_planned
    plan = pack.memory_plan(128, 128)
    assert planned == plan.total_bytes > 0
    names = {b[0] for b in plan.buffers}
    assert {"stacked_xs", "queries", "counts", "partials", "indptr",
            "offsets", "csr_flat_idx"} <= names
    tjoin.single_query(tidx, q, 1.0, pack=pack)
    assert tengine.DISPATCH_STATS.bytes_planned == planned
