"""The port's count-only joins and reverse neighbours against the JAX
reference (repro.core.join): `count_pass`, `join_counts`,
`degree_histogram` and `reverse_neighbors`.

Both packages work on the very same index (built by the JAX package, taken
by the port through `index_from_arrays(device="cpu")`), where the port's
engine runs on the plain versions of the kernels.  Inputs are seeded numpy
data, a few thousand rows, d <= 32, all four metrics.

Tolerances, and why: counts, histograms and CSR indices are exact, with no
pair allowed inside the float32 rounding band (the data keep the band
empty, as `_assert_parity` checks); reverse-neighbour distances, which are
the forward join's, to rtol 1e-5.  Counts must also equal the row lengths
of the port's own CSR paths exactly: one predicate pipeline.
"""
import importlib

import numpy as np
import pytest
from test_torch_snn import METRIC_CASES, _assert_parity, _port_index

from repro.core import engine as jengine
from repro.core import snn as jsnn
from repro_torch.core import engine as tengine
from repro_torch.core import graph as tgraph
from repro_torch.core import snn as tsnn

# both packages export a function named `join`, which shadows the module
jjoin = importlib.import_module("repro.core.join")
tjoin = importlib.import_module("repro_torch.core.join")

KW = dict(query_chunk=128, segment_rows=256, block=128)


def _data(seed, n=2500, d=12, m=300):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, d // 2:] *= 0.4
    a = rng.normal(size=(m, d)).astype(np.float32)
    return x, a, rng


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("metric", sorted(METRIC_CASES))
def test_join_counts_match_reference(metric, per_row):
    x, a, rng = _data(3 + len(metric) + per_row)
    r0, (lo, hi) = METRIC_CASES[metric]
    radius = rng.uniform(lo, hi, size=a.shape[0]) if per_row else r0
    jidx = jsnn.build_index(x, metric=metric)
    tidx = _port_index(jidx)
    want = jjoin.join_counts(a, None, radius, b_index=jidx, **KW)
    got = tjoin.join_counts(a, None, radius, b_index=tidx, device="cpu",
                            **KW)
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)
    # the pass-1 twin of the join: its row lengths, exactly
    csr = tjoin.join(a, None, radius, b_index=tidx, device="cpu", **KW)
    assert _assert_parity(jidx, a, radius,
                          jjoin.join(a, None, radius, b_index=jidx, **KW),
                          csr) == 0
    np.testing.assert_array_equal(got, np.diff(csr.indptr))


def test_join_counts_build_their_own_index_and_handle_empty_sides():
    x, a, _ = _data(9, n=900, d=6, m=40)
    got = tjoin.join_counts(a, x, 1.5, device="cpu")
    # a float64 oracle over the raw rows: equal up to the pairs whose
    # squared distance lies within the float32 band of r^2 = 2.25
    x64, a64 = x.astype(np.float64), a.astype(np.float64)
    sq = np.sum((a64[:, None, :] - x64[None, :, :]) ** 2, axis=2)
    scale = np.sum(x64 * x64, axis=1)[None, :] + np.sum(a64 * a64, axis=1)[
        :, None]
    band = np.abs(sq - 2.25) <= 6 * 2.0 ** -23 * (scale + 2.25)
    want = np.sum(sq <= 2.25, axis=1)
    assert got.sum() > 0
    assert np.all(np.abs(got - want) <= band.sum(axis=1))
    assert tjoin.join_counts(a[:0], x, 1.5, device="cpu").shape == (0,)
    empty = tjoin.join_counts(a, np.zeros((0, 6), np.float32), 1.5,
                              device="cpu")
    np.testing.assert_array_equal(empty, np.zeros(40, np.int64))
    with pytest.raises(ValueError, match="b points or a b_index"):
        tjoin.join_counts(a, None, 1.5, device="cpu")
    with pytest.raises(ValueError, match="per-row"):
        tjoin.join_counts(a, x, np.ones(3), device="cpu")


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_degree_histogram_matches_reference_and_the_graph(metric):
    x, _, _ = _data(21, n=2000, d=8)
    eps = {"euclidean": 1.6, "cosine": 0.12}[metric]
    jidx = jsnn.build_index(x, metric=metric)
    tidx = _port_index(jidx)
    whist, wdeg = jjoin.degree_histogram(x, eps, index=jidx, query_chunk=256,
                                         block=128)
    hist, deg = tjoin.degree_histogram(x, eps, index=tidx, query_chunk=256,
                                       block=128, device="cpu")
    np.testing.assert_array_equal(deg, wdeg)
    np.testing.assert_array_equal(hist, whist)
    np.testing.assert_array_equal(hist, np.bincount(deg))
    assert deg.min() >= 1   # every point is its own neighbour
    g = tgraph.build_neighbor_graph(x, eps, index=tidx, query_chunk=256,
                                    segment_rows=128, block=128,
                                    device="cpu")
    np.testing.assert_array_equal(deg, np.diff(g.indptr))


@pytest.mark.parametrize("return_distance", [False, True])
@pytest.mark.parametrize("per_point", [False, True])
def test_reverse_neighbors_match_reference(per_point, return_distance):
    x, a, rng = _data(31 + per_point, n=1500, d=10, m=400)
    radii = rng.uniform(1.8, 2.6, size=400) if per_point else 2.2
    jidx = jsnn.build_index(x)
    tidx = _port_index(jidx)
    kw = dict(target_index=jidx, return_distance=return_distance, **KW)
    want = jjoin.reverse_neighbors(a, x, radii, **kw)
    kw["target_index"] = tidx
    got = tjoin.reverse_neighbors(a, x, radii, device="cpu", **kw)
    assert got.m == x.shape[0] and want.nnz > 0
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    if return_distance:
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5)
    else:
        assert got.distances is None
    # the transpose of the forward join, pair for pair
    fwd = tjoin.join(a, None, radii, b_index=tidx, return_distance=False,
                     device="cpu", **KW)
    rows = np.repeat(np.arange(a.shape[0]), np.diff(fwd.indptr))
    back = np.repeat(np.arange(x.shape[0]), np.diff(got.indptr))
    assert (sorted(zip(rows.tolist(), fwd.indices.tolist()))
            == sorted(zip(got.indices.tolist(), back.tolist())))


def test_count_pass_matches_reference_and_the_csr_counts():
    x, a, rng = _data(41, n=2000, d=8, m=150)
    jidx = jsnn.build_index(x)
    tidx = _port_index(jidx)
    xq, aq, _, _, qsq = jsnn.prepare_query_predicates(jidx, a, 1.0)
    r = rng.uniform(1.2, 2.2, size=150)
    pq = jsnn.query_extra_projections(jidx, xq)
    want = jjoin.count_pass(jengine.pack_from_index(jidx, block=128), xq,
                            aq, qsq, r, pq=pq)
    tpack = tengine.pack_from_index(tidx, block=128, device="cpu")
    for bucket in (True, False):
        got = tjoin.count_pass(tpack, xq, aq, qsq, r, pq=pq, bucket=bucket)
        np.testing.assert_array_equal(got, want)
    csr = tsnn.query_radius_csr(tidx, a, r, block=128, device="cpu")
    np.testing.assert_array_equal(want, np.diff(csr.indptr))
