"""The port's looped executor, join, neighbour graph and DBSCAN against the
JAX reference (repro.core.{engine,join,graph,dbscan}).

Both packages work on the very same index: the JAX package builds it and
the port takes its arrays through `index_from_arrays(device="cpu")`, where
the port's engine runs its device orchestration on the plain versions of the
kernels.  Inputs are seeded numpy data, a few thousand rows, d <= 32.

Tolerances, and why: ``indptr`` and ``indices`` must be equal, row order
included, except for pairs whose half distance lies inside the float32
rounding band of the threshold, ``d * 2^-23 * (hn + |q.x|)`` (the two
packages take their float32 products in different libraries); every such
pair is asserted to lie in the band.  Squared Euclidean distances agree to
twice that band, native distances to rtol 1e-5.  The port's two executors
(packed and looped) must agree bit for bit: they evaluate one predicate on
the same inputs.
"""
import importlib

import numpy as np
import pytest
from test_torch_snn import _assert_parity, _band, _port_index

from repro.core import engine as jengine
from repro.core import graph as jgraph
from repro.core import snn as jsnn
from repro_torch.core import engine as tengine
from repro_torch.core import graph as tgraph
from repro_torch.core import snn as tsnn

# both packages export functions named `join` and `dbscan`, which shadow the
# modules of those names
jjoin = importlib.import_module("repro.core.join")
jdb = importlib.import_module("repro.core.dbscan")
tjoin = importlib.import_module("repro_torch.core.join")
tdb = importlib.import_module("repro_torch.core.dbscan")


def _data(seed, n=2000, d=12, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, d // 2:] *= 0.4
    return x + np.float32(shift)


def _sq_band_ok(index, q, radius, want, got_sq, want_sq):
    """Squared Euclidean distances agree to twice the rounding band."""
    qi = np.repeat(np.arange(want.m), np.diff(want.indptr))
    inv = np.empty_like(index.order)
    inv[index.order] = np.arange(index.n)
    _, tol = _band(index, q, radius, (qi, inv[want.indices]))
    assert np.all(np.abs(got_sq - want_sq) <= 2.0 * tol)


GRAPH_KW = dict(query_chunk=512, segment_rows=128, block=128)
METRIC_EPS = {"euclidean": 2.2, "cosine": 0.35}


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("metric", sorted(METRIC_EPS))
def test_graph_matches_reference(metric, symmetric, packed):
    x = _data(1 + len(metric), shift=0.3 if metric == "cosine" else 0.0)
    eps = METRIC_EPS[metric]
    jidx = jsnn.build_index(x, metric=metric)
    tidx = _port_index(jidx)
    kw = dict(GRAPH_KW, symmetric=symmetric, packed=packed,
              return_distance=True)
    want = jgraph.build_neighbor_graph(x, eps, index=jidx, **kw)
    got = tgraph.build_neighbor_graph(x, eps, index=tidx, device="cpu", **kw)
    assert want.nnz > 5 * x.shape[0]
    assert _assert_parity(jidx, x, eps, want, got) == 0
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5,
                               atol=1e-6)
    # the port's other executor and the plain schedule give the same graph
    other = tgraph.build_neighbor_graph(
        x, eps, index=tidx, device="cpu",
        **dict(kw, packed=not packed, symmetric=False))
    np.testing.assert_array_equal(other.indptr, got.indptr)
    np.testing.assert_array_equal(other.indices, got.indices)
    # a graph row is the point query of that row alone
    for i in (0, 17, x.shape[0] - 1):
        row = tsnn.query_radius_csr(tidx, x[i:i + 1], eps, device="cpu")
        np.testing.assert_array_equal(got.row(i)[0], row.row(0)[0])


@pytest.mark.parametrize("packed", [True, False])
def test_graph_per_point_eps_matches_reference(packed):
    x = _data(7)
    eps = np.random.default_rng(8).uniform(1.6, 2.6, size=x.shape[0])
    jidx = jsnn.build_index(x)
    tidx = _port_index(jidx)
    want = jgraph.build_neighbor_graph(x, eps, index=jidx, packed=packed,
                                       **GRAPH_KW)
    got = tgraph.build_neighbor_graph(x, eps, index=tidx, packed=packed,
                                      device="cpu", **GRAPH_KW)
    assert want.nnz > 0 and got.distances is None
    assert _assert_parity(jidx, x, eps, want, got) == 0
    with pytest.raises(ValueError, match="scalar eps"):
        tgraph.build_neighbor_graph(x, eps, index=tidx, symmetric=True,
                                    device="cpu")


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("packed", [True, False])
def test_join_matches_reference(packed, per_row):
    rng = np.random.default_rng(30 + per_row)
    b = _data(31, n=1500, d=10)
    a = rng.normal(size=(700, 10)).astype(np.float32)
    radius = rng.uniform(1.5, 2.5, size=700) if per_row else 2.0
    jidx = jsnn.build_index(b)
    tidx = _port_index(jidx)
    kw = dict(query_chunk=256, segment_rows=128, block=128, packed=packed)
    want = jjoin.join(a, None, radius, b_index=jidx, **kw)
    got = tjoin.join(a, None, radius, b_index=tidx, device="cpu", **kw)
    assert want.nnz > 0
    assert _assert_parity(jidx, a, radius, want, got) == 0
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5)
    # per row it is the point query of the whole batch
    point = tsnn.query_radius_csr(tidx, a, radius, device="cpu")
    np.testing.assert_array_equal(got.indptr, point.indptr)
    np.testing.assert_array_equal(got.indices, point.indices)
    np.testing.assert_array_equal(got.distances, point.distances)


def _blobs(seed, n=2400, d=8):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-6.0, 6.0, size=(5, d))
    lab = rng.integers(0, 5, size=n)
    x = centres[lab] + rng.normal(scale=0.6, size=(n, d))
    x[: n // 20] = rng.uniform(-9.0, 9.0, size=(n // 20, d))  # noise
    return x.astype(np.float32), lab


@pytest.mark.parametrize("backend",
                         ["snn-csr", "snn-graph", "snn", "brute", "kdtree"])
def test_dbscan_labels_match_reference(backend):
    x, truth = _blobs(3)
    eps, min_samples = 1.1, 5
    want = jdb.dbscan(x, eps, min_samples, backend=backend, query_chunk=512)
    got = tdb.dbscan(x, eps, min_samples, backend=backend, query_chunk=512,
                     device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.max() >= 3 and (got == -1).any()
    # labels from the JAX package's graph, through the port's clustering
    jidx = jsnn.build_index(x)
    g = jgraph.build_neighbor_graph(x, eps, index=jidx, query_chunk=512)
    np.testing.assert_array_equal(tdb.labels_from_graph(g, min_samples),
                                  jdb.labels_from_graph(g, min_samples))
    nmi = tdb.normalized_mutual_information(got, truth)
    assert nmi == pytest.approx(jdb.normalized_mutual_information(want, truth),
                                rel=1e-12)
    assert 0.5 < nmi <= 1.0


def test_dbscan_unported_backends_say_so():
    # every backend of the reference is ported (their labels are held
    # against it above); only a name neither package knows is refused
    assert tdb.BACKENDS == jdb.BACKENDS
    x, _ = _blobs(4, n=50)
    with pytest.raises(ValueError, match="unknown backend"):
        tdb.dbscan(x, 1.0, backend="nope", device="cpu")


HAND_GRAPHS = {
    # name: (n, edges, labels)
    "path": (5, [(0, 1), (1, 2), (2, 3), (3, 4)], [0, 0, 0, 0, 0]),
    "reversed path": (5, [(4, 3), (3, 2), (2, 1), (1, 0)], [0, 0, 0, 0, 0]),
    "two parts and a loner": (7, [(1, 3), (3, 5), (2, 6), (6, 4)],
                              [0, 1, 2, 1, 2, 1, 2]),
    "self loops": (3, [(0, 0), (2, 2)], [0, 1, 2]),
    "no edges": (4, [], [0, 1, 2, 3]),
    "star to the top id": (6, [(5, 0), (5, 1), (5, 2), (5, 3), (5, 4)],
                           [0] * 6),
    "empty": (0, [], []),
}


@pytest.mark.parametrize("name", sorted(HAND_GRAPHS))
def test_min_label_components_hand_graphs(name):
    n, edges, labels = HAND_GRAPHS[name]
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    got = tgraph.min_label_components(n, e[:, 0], e[:, 1])
    np.testing.assert_array_equal(got, np.asarray(labels, np.int64))
    np.testing.assert_array_equal(
        got, jgraph.min_label_components(n, e[:, 0], e[:, 1]))


@pytest.mark.parametrize("query_chunk,align", [
    (2048, None), (None, None), (2048, 512), (300, 128), (100, 128),
    (0, 512), (1, None), (1000, 512),
])
def test_resolve_chunk_matches_reference(query_chunk, align):
    # without a memory budget (tests/test_torch_budget.py covers budgets)
    want = jjoin.resolve_chunk(10_000, query_chunk, None, align, 512)
    assert tjoin.resolve_chunk(10_000, query_chunk, None, align, 512) == want


def test_csr_plumbing_matches_reference():
    rng = np.random.default_rng(12)
    n = 300
    counts = rng.integers(0, 9, size=n)
    indptr = tjoin.indptr_from_counts(counts)
    cols = np.concatenate([np.sort(rng.choice(n, c, replace=False))
                           for c in counts]).astype(np.int64)
    d = rng.uniform(size=cols.size)
    dest = rng.permutation(n)
    for fn, args in (("permute_rows", (indptr, cols, d, dest)),
                     ("transpose_csr", (indptr, cols, d, n)),
                     ("mirror_merge", (indptr, cols, d, 64))):
        want = getattr(jjoin, fn)(*args)
        got = getattr(tjoin, fn)(*args)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_query_radius_csr_looped_equals_packed(metric):
    rng = np.random.default_rng(40)
    x = _data(41, n=1800, d=16, shift=0.2)
    q = rng.normal(size=(90, 16)).astype(np.float32) + np.float32(0.2)
    radius = 2.4 if metric == "euclidean" else 0.9
    jidx = jsnn.build_index(x, metric=metric)
    tidx = _port_index(jidx)
    packed = tsnn.query_radius_csr(tidx, q, radius, device="cpu")
    looped = [tsnn.query_radius_csr(tidx, q, radius, packed=False,
                                    device="cpu"),
              tsnn.query_radius_csr(tidx, q, radius, packed=False,
                                    mixed=True, device="cpu")]
    assert packed.nnz > 0
    for res in looped:
        np.testing.assert_array_equal(res.indptr, packed.indptr)
        np.testing.assert_array_equal(res.indices, packed.indices)
        np.testing.assert_array_equal(res.distances, packed.distances)
    want = jsnn.query_radius_csr(jidx, q, radius, packed=False)
    assert _assert_parity(jidx, q, radius, want, looped[0]) == 0
    _sq_band_ok(jidx, q, radius, want,
                tsnn.query_radius_csr(tidx, q, radius, packed=False,
                                      native=False, device="cpu").distances,
                jsnn.query_radius_csr(jidx, q, radius, packed=False,
                                      native=False).distances)


@pytest.mark.parametrize("box", [False, True])
def test_run_csr_dispatch_stats_match_reference(box):
    # JAX's device lane (its Pallas kernels, interpret mode off the TPU) and
    # the port's looped executor on the same segments: the same launches
    # and host transfers, and the same CSR
    rng = np.random.default_rng(50 + box)
    x = _data(51, n=330, d=6)
    q = rng.normal(size=(20, 6)).astype(np.float32)
    jidx = jsnn.build_index(x, n_components=3 if box else 1)
    tidx = _port_index(jidx)
    jsegs = jengine.segments_from_index(jidx, rows_per_segment=64, block=128)
    tsegs = tengine.segments_from_index(tidx, rows_per_segment=64, block=128,
                                        device="cpu")
    assert len(jsegs) == len(tsegs) == 6
    xq, aq, r, th, _ = jsnn.prepare_query_predicates(jidx, q, 0.9)
    qp, aqp, rp, thp, m = tengine._ops.pad_queries(xq, aq, r, th, tq=128)
    pq = jsnn.query_extra_projections(jidx, xq)
    pqp = None if pq is None else tengine._ops.pad_components(pq, 128)
    jengine.DISPATCH_STATS.reset()
    want = jengine.run_csr(jsegs, qp, aqp, rp, thp, m, use_pallas=True,
                           pq=pqp)
    jstats = jengine.DISPATCH_STATS.snapshot()
    tengine.DISPATCH_STATS.reset()
    got = tengine.run_csr(tsegs, qp, aqp, rp, thp, m, pq=pqp)
    tstats = tengine.DISPATCH_STATS.snapshot()
    for f in ("kernel_launches", "host_transfers"):
        assert tstats[f] == jstats[f], f
    assert 2 < jstats["kernel_launches"] < 2 * 2 * len(jsegs)  # some pruned
    for a, b in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(b, a)
    assert got[2].size > 0
