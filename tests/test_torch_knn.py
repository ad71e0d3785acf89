"""The port's exact kNN (`core.knn.query_knn`) against the JAX reference.

Both packages query the very same index (built by the JAX package, taken by
the port through `index_from_arrays(device="cpu")`), where the port's
engine runs the plain versions of the kernels.  Inputs are seeded numpy
data, a few thousand rows, d <= 32, all four metrics.

Tolerances, and why: the ids are exact, ties by id included, because both
packages refine the same float32 rows in float64 on the host and select by
``(distance, id)``; the final pass's candidate set may differ only by pairs
inside the float32 band at the inflated radius, which lies beyond the k-th
neighbour, so no id moves.  Distances are the same float64 computation on
the same rows, so they are equal (mips and the angle go through the same
numpy conversion).  The expansion rounds are the port's own count passes
and are only checked to be at least one.  Against the kd-tree baseline,
which measures the raw rows and not the centred float32 ones, distances
agree to rtol 1e-6.
"""
import numpy as np
import pytest
from test_torch_snn import _port_index

from repro.core import baselines as jb
from repro.core import knn as jknn
from repro.core import snn as jsnn
from repro.core import streaming as jst
from repro_torch.core import knn as tknn
from repro_torch.core import snn as tsnn
from repro_torch.core import streaming as tst

METRICS = ["euclidean", "cosine", "angular", "mips"]


def _data(seed, n=3000, d=16, m=64):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, d)) + 0.1).astype(np.float32)
    x[:, d // 2:] *= 0.5
    q = (rng.random((m, d)) + 0.1).astype(np.float32)
    return x, q, rng


def _pair(x, metric="euclidean"):
    jidx = jsnn.build_index(x, metric=metric)
    return jidx, _port_index(jidx)


@pytest.mark.parametrize("metric", METRICS)
def test_query_knn_matches_reference(metric):
    x, q, _ = _data(1 + len(metric))
    jidx, tidx = _pair(x, metric)
    for k in (1, 10, 37):
        want_i, want_d = jknn.query_knn(jidx, q, k)
        tknn.KNN_STATS.reset()
        got_i, got_d = tknn.query_knn(tidx, q, k, device="cpu")
        assert tknn.KNN_STATS.rounds >= 1
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_d, want_d)
    sq_w = jknn.query_knn(jidx, q, 5, native=False)[1]
    sq_g = tknn.query_knn(tidx, q, 5, native=False, device="cpu")[1]
    np.testing.assert_array_equal(sq_g, sq_w)
    np.testing.assert_array_equal(
        tknn.query_knn(tidx, q, 5, return_distance=False, device="cpu"),
        jknn.query_knn(jidx, q, 5, return_distance=False))


def test_query_knn_per_query_k_and_k_past_n():
    x, q, rng = _data(11, n=2000, d=8, m=40)
    jidx, tidx = _pair(x)
    k = rng.integers(0, 30, size=40)
    k[3] = 0
    wi, wd = jknn.query_knn(jidx, q, k)
    gi, gd = tknn.query_knn(tidx, q, k, device="cpu")
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    assert np.all(gi[3] == -1) and np.all(np.isinf(gd[3]))
    # k > n: the tail holds -1 / +inf
    small = x[:50]
    jsm, tsm = _pair(small)
    wi, wd = jknn.query_knn(jsm, q[:5], 80)
    gi, gd = tknn.query_knn(tsm, q[:5], 80, device="cpu")
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    assert np.all(gi[:, 50:] == -1) and np.all(np.isinf(gd[:, 50:]))
    assert np.all(np.sort(gi[:, :50], axis=1) == np.arange(50))


def test_query_knn_ties_by_id_on_duplicates():
    rng = np.random.default_rng(21)
    base = rng.integers(-3, 4, size=(200, 6)).astype(np.float32)
    x = np.concatenate([base, base, base])
    q = base[:20] + np.float32(0.25)
    jidx, tidx = _pair(x)
    wi, wd = jknn.query_knn(jidx, q, 9)
    gi, gd = tknn.query_knn(tidx, q, 9, device="cpu")
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    # the three copies of a row sit side by side, ascending id
    same = gd[:, 1:] == gd[:, :-1]
    assert same.any() and np.all(gi[:, 1:][same] > gi[:, :-1][same])


def test_query_knn_agrees_with_the_kdtree_baseline():
    x, q, _ = _data(31, n=2500, d=6, m=50)
    _, tidx = _pair(x)
    gi, gd = tknn.query_knn(tidx, q, 12, device="cpu")
    wi, wd = jb.KDTree(x).query_knn(q, 12)
    np.testing.assert_array_equal(gi, wi)
    # the tree measures raw rows, the index centred float32 rows
    np.testing.assert_allclose(gd, wd, rtol=1e-6)


def test_query_knn_rejects_bad_k_and_handles_empty_inputs():
    x, q, _ = _data(41, n=300, d=5, m=4)
    _, tidx = _pair(x)
    with pytest.raises(ValueError, match="per-query"):
        tknn.query_knn(tidx, q, np.ones(3, np.int64), device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        tknn.query_knn(tidx, q, -1, device="cpu")
    gi, gd = tknn.query_knn(tidx, q, 0, device="cpu")
    assert gi.shape == gd.shape == (4, 0)
    gi = tknn.query_knn(tidx, q[:0], 5, return_distance=False, device="cpu")
    assert gi.shape == jknn.query_knn(jsnn.build_index(x), q[:0], 5,
                                      return_distance=False).shape
    empty = _port_index(jsnn.build_index(np.zeros((0, 5), np.float32)))
    gi, gd = tknn.query_knn(empty, q, 3, device="cpu")
    assert np.all(gi == -1) and np.all(np.isinf(gd))


def test_query_knn_on_a_streaming_index_matches_reference():
    x, q, rng = _data(51, n=2000, d=10, m=30)
    js = jst.StreamingSNNIndex(x, block=128)
    ts = tst.StreamingSNNIndex.from_state(*js.state_leaves(), device="cpu")
    for _ in range(3):
        b = (rng.random((150, 10)) + 0.1).astype(np.float32)
        js.append(b)
        ts.append(b)
    assert len(ts.parts) == 4
    wi, wd = js.query_knn(q, 15)
    gi, gd = ts.query_knn(q, 15)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    # and the same neighbours as a fresh port index over every row
    fresh = tsnn.build_index(ts.raw, device="cpu")
    np.testing.assert_array_equal(
        tknn.query_knn(fresh, q, 15, return_distance=False, device="cpu"),
        gi)
