"""``memory_budget_mb`` on the port's front-ends against the JAX reference.

`join.resolve_chunk` must pick the reference's chunk over a grid of (n,
query_chunk, budget, align, block): a budget is a ceiling of
``budget // (4 * n_pad)`` rows, never inflated by alignment.  Under a
budget, `join`, `degree_histogram`, `reverse_neighbors` and
`build_neighbor_graph` must give results bit-identical to the unbudgeted
calls (the schedule reorders work, it never changes it) and run the
number of chunks the reference's chunk implies.
"""
import importlib
import itertools

import numpy as np
import pytest
from test_torch_snn import _port_index

from repro.core import snn as jsnn
from repro_torch.core import engine as tengine
from repro_torch.core import graph as tgraph
from repro_torch.core import knn as tknn

# both packages export a function named `join`, which shadows the module
jjoin = importlib.import_module("repro.core.join")
tjoin = importlib.import_module("repro_torch.core.join")

NS = (0, 1, 500, 4097, 1_000_000)
CHUNKS = (None, 0, 96, 2048)
BLOCKS = (64, 512)


@pytest.mark.parametrize("align", [None, 1, 48, 512])
@pytest.mark.parametrize("budget", [None, 0.0, 0.001, 0.25, 3, 64.5])
def test_resolve_chunk_is_the_references(budget, align):
    for n, qc, block in itertools.product(NS, CHUNKS, BLOCKS):
        want = jjoin.resolve_chunk(n, qc, budget, align, block)
        assert tjoin.resolve_chunk(n, qc, budget, align, block) == want, (
            n, qc, block)


def _bits(a):
    return np.asarray(a).view(np.int64)


def _same(got, want):
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    if want.distances is not None:
        np.testing.assert_array_equal(_bits(got.distances),
                                      _bits(want.distances))


@pytest.fixture
def chunk_calls(monkeypatch):
    """Counts the engine executions (one a chunk) by executor."""
    calls = {"csr": 0, "counts": 0}
    run_csr, run_counts = tengine.run_csr_packed, tengine.run_counts_packed

    def csr(*a, **k):
        calls["csr"] += 1
        return run_csr(*a, **k)

    def counts(*a, **k):
        calls["counts"] += 1
        return run_counts(*a, **k)

    monkeypatch.setattr(tengine, "run_csr_packed", csr)
    monkeypatch.setattr(tengine, "run_counts_packed", counts)
    return calls


def _data():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1500, 8)).astype(np.float32)
    a = rng.normal(size=(700, 8)).astype(np.float32)
    return x, a


BUDGET = 0.5     # MiB: 81 rows of float32 over 1,536 padded rows
KW = dict(block=128, segment_rows=128)


def _chunks(n, m, budget, align=None, block=128):
    return -(-m // jjoin.resolve_chunk(n, 2048, budget, align, block))


def test_join_under_a_budget(chunk_calls):
    x, a = _data()
    tidx = _port_index(jsnn.build_index(x))
    kw = dict(KW, b_index=tidx, device="cpu")
    want = tjoin.join(a, None, 2.0, **kw)
    chunk_calls["csr"] = 0
    got = tjoin.join(a, None, 2.0, memory_budget_mb=BUDGET, **kw)
    assert chunk_calls["csr"] == _chunks(tidx.n, a.shape[0], BUDGET) > 1
    assert want.nnz > 10 * a.shape[0]
    _same(got, want)
    rev = tjoin.reverse_neighbors(a, x, 2.0, target_index=tidx,
                                  memory_budget_mb=BUDGET, device="cpu",
                                  **KW)
    _same(rev, tjoin.reverse_neighbors(a, x, 2.0, target_index=tidx,
                                       device="cpu", **KW))


def test_degree_histogram_under_a_budget(chunk_calls):
    x, _ = _data()
    tidx = _port_index(jsnn.build_index(x))
    kw = dict(index=tidx, block=128, device="cpu")
    hist, deg = tjoin.degree_histogram(x, 2.0, **kw)
    chunk_calls["counts"] = 0
    bhist, bdeg = tjoin.degree_histogram(x, 2.0, memory_budget_mb=BUDGET,
                                         **kw)
    assert chunk_calls["counts"] == _chunks(tidx.n, tidx.n, BUDGET) > 1
    np.testing.assert_array_equal(bdeg, deg)
    np.testing.assert_array_equal(bhist, hist)


@pytest.mark.parametrize("symmetric", [False, True])
def test_graph_under_a_budget(chunk_calls, symmetric):
    x, _ = _data()
    tidx = _port_index(jsnn.build_index(x))
    kw = dict(KW, index=tidx, symmetric=symmetric, return_distance=True,
              device="cpu")
    want = tgraph.build_neighbor_graph(x, 2.0, **kw)
    chunk_calls["csr"] = 0
    got = tgraph.build_neighbor_graph(x, 2.0, memory_budget_mb=BUDGET, **kw)
    align = 128 if symmetric else None
    assert chunk_calls["csr"] == _chunks(tidx.n, tidx.n, BUDGET, align) > 1
    if symmetric:
        # the triangular schedule evaluates each cross-chunk pair once, so
        # another chunking may differ from the plain graph only on the
        # float32 boundary; none of these pairs is there
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        return
    _same(got, want)
    chunk_calls["csr"] = 0
    sharded = tgraph.build_neighbor_graph_sharded(
        x, 4, 2.0, index=tidx, return_distance=True, block=128,
        memory_budget_mb=BUDGET)
    assert chunk_calls["csr"] == _chunks(tidx.n, tidx.n, BUDGET)
    _same(sharded, want)


def test_query_knn_takes_the_budget(chunk_calls):
    x, a = _data()
    tidx = _port_index(jsnn.build_index(x))
    k = np.random.default_rng(5).integers(0, 12, size=200)
    want = tknn.query_knn(tidx, a[:200], k, device="cpu")
    chunk_calls["csr"] = 0
    got = tknn.query_knn(tidx, a[:200], k, memory_budget_mb=BUDGET,
                         device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # one search (one final compact) for each budgeted chunk of queries
    assert chunk_calls["csr"] == _chunks(tidx.n, 200, BUDGET, block=512) > 1
