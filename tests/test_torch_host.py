"""The port's baselines, host Algorithm 2 queries and fixed-shape query
against the JAX reference (repro.core.{baselines,snn}).

Both packages query the very same index: the JAX package builds it and the
port takes its arrays through `index_from_arrays(device="cpu")`.  Inputs are
seeded numpy data, a few thousand rows, d <= 32, all four metrics.

Tolerances, and why:
* the baselines are the same numpy code, so they are bit-equal;
* the host queries take each window's product in float32 in another library
  (torch here, numpy there): neighbour lists equal, order included, except
  for pairs inside the float32 rounding band of the threshold, each asserted
  to lie in it; distances to rtol 1e-5; counts exact (no pair in the band);
* `query_radius_fixed` takes the filter's half distances (XLA's GEMM
  there): ids, the valid mask and counts exact where no pair lies in the
  band; squared distances to 4 float32 ulp of their scale
  ``2 * (hn + |q.x|) + |q|^2``.
"""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
from test_torch_snn import METRIC_CASES, _assert_parity, _port_index

from repro.core import baselines as jb
from repro.core import snn as jsnn
from repro_torch.core import baselines as tb
from repro_torch.core import snn as tsnn
from repro_torch.kernels import ops as tops

# the packages export functions named `dbscan`, which shadow the modules
jdb = importlib.import_module("repro.core.dbscan")
tdb = importlib.import_module("repro_torch.core.dbscan")

EPS32 = 2.0 ** -23
METRICS = sorted(METRIC_CASES)


def _data(seed, n=2000, d=10, m=40):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, d // 2:] *= 0.3
    q = rng.normal(size=(m, d)).astype(np.float32)
    return x, q


def _radius(rng, metric, m, per_query):
    r0, (lo, hi) = METRIC_CASES[metric]
    return rng.uniform(lo, hi, size=m) if per_query else r0


def _csr(lists):
    """Per-query (ids, distances) lists as a `CSRNeighbors`."""
    indptr = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(i) for i, _ in lists], out=indptr[1:])
    cat = (lambda k: np.concatenate([r[k] for r in lists]) if lists
           else np.zeros(0))
    return jsnn.CSRNeighbors(indptr, cat(0).astype(np.int64), cat(1))


# --------------------------------------------------------------------------- #
# baselines: the same numpy code, bit-equal                                    #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("metric", METRICS)
def test_baselines_bit_equal_to_reference(metric):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1200, 6)).astype(np.float32)
    q = rng.normal(size=(25, 6)).astype(np.float32)
    radius = _radius(rng, metric, 25, True)
    for name in ("BruteForce1", "BruteForce2", "KDTree"):
        want = getattr(jb, name)(x, metric=metric).query_radius(q, radius)
        got = getattr(tb, name)(x, metric=metric).query_radius(q, radius)
        assert sum(len(w) for w in want) > 0
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
    wi, wd = jb.KDTree(x, metric=metric).query_knn(q, 7)
    gi, gd = tb.KDTree(x, metric=metric).query_knn(q, 7)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)


def test_grid_index_bit_equal_to_reference():
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(2000, 3)).astype(np.float32)
    q = rng.uniform(size=(30, 3)).astype(np.float32)
    want = jb.GridIndex(x, n_cells=8).query_radius(q, 0.12)
    got = tb.GridIndex(x, n_cells=8).query_radius(q, 0.12)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


# --------------------------------------------------------------------------- #
# the host Algorithm 2 queries                                                 #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_query_radius_batch_matches_reference(metric, per_query):
    rng = np.random.default_rng(10 + len(metric) + per_query)
    x, q = _data(11 + per_query)
    radius = _radius(rng, metric, q.shape[0], per_query)
    jidx = jsnn.build_index(x, metric=metric)
    tidx = _port_index(jidx)
    want = jsnn.query_radius_batch(jidx, q, radius, group_size=16)
    got = tsnn.query_radius_batch(tidx, q, radius, group_size=16)
    w, g = _csr(want), _csr(got)
    assert w.nnz > 0
    assert _assert_parity(jidx, q, radius, w, g) == 0
    np.testing.assert_allclose(g.distances, w.distances, rtol=1e-5)
    # ids only, and the counts built on them
    ids = tsnn.query_radius_batch(tidx, q, radius, return_distance=False,
                                  group_size=16)
    for a, (b, _) in zip(ids, got):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tsnn.query_counts(tidx, q, radius, group_size=16),
        jsnn.query_counts(jidx, q, radius, group_size=16))


@pytest.mark.parametrize("metric", METRICS)
def test_query_radius_matches_reference(metric):
    x, q = _data(20 + len(metric))
    radius = METRIC_CASES[metric][0]
    jidx = jsnn.build_index(x, metric=metric)
    tidx = _port_index(jidx)
    hits = 0
    for i in range(8):
        wi, wd = jsnn.query_radius(jidx, q[i], radius)
        gi, gd = tsnn.query_radius(tidx, q[i], radius)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, rtol=1e-5)
        np.testing.assert_array_equal(
            tsnn.query_radius(tidx, q[i], radius, return_distance=False), wi)
        hits += wi.size
    assert hits > 0


_TF32_CASE = """
import numpy as np, torch
from repro_torch.core import snn as tsnn
m = torch.backends.cuda.matmul
how = {how!r}
if how == "allow_tf32":
    m.allow_tf32 = True
elif how == "precision":
    torch.set_float32_matmul_precision("high")
elif how == "fp32_precision":
    m.fp32_precision = "tf32"
def state():
    try:
        return m.allow_tf32
    except RuntimeError:   # set through the newer interface only
        return m.fp32_precision
before = state()
with tsnn._full_float32():
    with tsnn._full_float32():   # a second user, as another thread
        inside = state()
    still = state()
rng = np.random.default_rng(0)
idx = tsnn.build_index(rng.normal(size=(300, 6)).astype(np.float32),
                       device="cpu")
tsnn.query_radius(idx, rng.normal(size=6).astype(np.float32), 1.0)
tsnn.query_radius_batch(idx, rng.normal(size=(5, 6)).astype(np.float32), 1.0)
print(before, inside, still, state())
"""


@pytest.mark.parametrize("how", ["off", "allow_tf32", "precision",
                                 "fp32_precision"])
def test_host_products_turn_tf32_off_and_restore_the_callers_setting(how):
    """The window products run with TF32 off however the caller turned it
    on, and leave the caller's setting as it was (a process of its own, as
    the setting is process-wide)."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _TF32_CASE.format(how=how)],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    before, inside, still, after = out.stdout.split()
    on = {"off": "False", "fp32_precision": "tf32"}.get(how, "True")
    assert (before, after) == (on, on)
    assert (inside, still) == ("False", "False")


def test_host_queries_match_the_csr_path_and_handle_empty_windows():
    x, q = _data(30)
    tidx = _port_index(jsnn.build_index(x))
    csr = tsnn.query_radius_csr(tidx, q, 2.6, device="cpu")
    batch = tsnn.query_radius_batch(tidx, q, 2.6)
    for i, (ids, _) in enumerate(batch):
        np.testing.assert_array_equal(ids, csr.row(i)[0])
    far = q + np.float32(100.0)   # every window empty
    assert all(r.size == 0 for r in tsnn.query_radius_batch(
        tidx, far, 0.5, return_distance=False))
    i, d = tsnn.query_radius(tidx, far[0], 0.5)
    assert i.size == 0 and d.size == 0


# --------------------------------------------------------------------------- #
# query_radius_fixed through the filter                                        #
# --------------------------------------------------------------------------- #
def _fixed_parity(jidx, q, radius, want, got):
    """Ids, valid mask and counts exact; squared distances to 4 ulp."""
    wi, ws, wv, wc = want
    gi, gs, gv, gc = got
    assert gi.shape == wi.shape and gs.shape == ws.shape
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi, wi)
    xq, _ = jidx.prepare_queries(q, radius)
    qsq = np.einsum("ij,ij->i", xq.astype(np.float64), xq)
    inv = np.empty_like(jidx.order)
    inv[jidx.order] = np.arange(jidx.n)
    rows, cols = np.nonzero(wv)
    x64 = np.asarray(jidx.xs, np.float64)[inv[wi[rows, cols]]]
    hn = 0.5 * np.einsum("ij,ij->i", x64, x64)
    dot = np.abs(np.einsum("ij,ij->i", x64, xq[rows].astype(np.float64)))
    tol = 4 * EPS32 * (2.0 * (hn + dot) + qsq[rows])
    assert np.all(np.abs(gs[rows, cols] - ws[rows, cols]) <= tol)
    assert np.all(np.isinf(gs[~gv])) and np.all(gi[~gv] == -1)


@pytest.mark.parametrize("metric", METRICS)
def test_query_radius_fixed_matches_reference(metric):
    rng = np.random.default_rng(40 + len(metric))
    x, q = _data(41 + len(metric), n=3000, d=16)
    radius = _radius(rng, metric, q.shape[0], True)
    jidx = jsnn.build_index(x, metric=metric)
    tidx = _port_index(jidx)
    for k in (5, 64):
        want = jsnn.query_radius_fixed(jidx, q, radius, k, block=512)
        got = tsnn.query_radius_fixed(tidx, q, radius, k, block=512)
        assert want[2].any()
        _fixed_parity(jidx, q, radius, want, got)
    # counts are the CSR path's
    np.testing.assert_array_equal(
        got[3], np.diff(tsnn.query_radius_csr(tidx, q, radius,
                                              device="cpu").indptr))


def test_query_radius_fixed_orders_ties_by_sorted_row():
    # duplicated rows tie exactly: among equal distances the reference's
    # top_k keeps the lower column first, and so must the port, both in
    # the order of the kept ones and in which of them a cut at K keeps
    rng = np.random.default_rng(50)
    base = rng.integers(-2, 3, size=(300, 8)).astype(np.float32)
    x = np.concatenate([base] * 6)
    q = rng.integers(-2, 3, size=(30, 8)).astype(np.float32)
    jidx = jsnn.build_index(x)
    tidx = _port_index(jidx)
    # squared distances are integers: r^2 = 9.5 keeps every pair far from
    # the threshold, so the only near-equal distances are exact ties
    radius = float(np.sqrt(9.5))
    for k in (1, 7, 24, 40):
        want = jsnn.query_radius_fixed(jidx, q, radius, k, block=128)
        got = tsnn.query_radius_fixed(tidx, q, radius, k, block=128)
        assert (want[3] > k).any()   # some rows are cut inside a tie
        _fixed_parity(jidx, q, radius, want, got)


def test_query_radius_fixed_clamps_k_and_handles_an_empty_index():
    x, q = _data(60, n=300, d=8, m=6)
    jidx = jsnn.build_index(x)
    tidx = _port_index(jidx)
    want = jsnn.query_radius_fixed(jidx, q, 3.0, 10_000, block=128)
    got = tsnn.query_radius_fixed(tidx, q, 3.0, 10_000, block=128)
    n_pad = tops.round_up(300, 128)
    assert got[0].shape == want[0].shape == (6, n_pad)
    _fixed_parity(jidx, q, 3.0, want, got)
    empty = _port_index(jsnn.build_index(np.zeros((0, 8), np.float32)))
    gi, gs, gv, gc = tsnn.query_radius_fixed(empty, q, 3.0, 5)
    assert gi.shape == gs.shape == gv.shape == (6, 0)
    np.testing.assert_array_equal(gc, np.zeros(6, np.int64))


def test_query_radius_fixed_rows_do_not_depend_on_the_batch():
    # each pair's half distance is one float32 product whatever the batch
    # (the padded batch is one query tile), so a row is the same alone and
    # among others, bit for bit
    rng = np.random.default_rng(70)
    x, q = _data(71, n=2500, d=12, m=6)
    radius = rng.uniform(2.0, 3.2, size=6)
    tidx = _port_index(jsnn.build_index(x))
    batch = tsnn.query_radius_fixed(tidx, q, radius, 16)
    assert batch[2].any()
    for i in range(6):
        one = tsnn.query_radius_fixed(tidx, q[i:i + 1], radius[i:i + 1], 16)
        for a, b in zip(one, batch):
            np.testing.assert_array_equal(a[0], b[i])


# --------------------------------------------------------------------------- #
# the host graph backends                                                      #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["snn", "brute", "kdtree"])
def test_neighbor_graph_host_backends_match_reference(backend):
    x, _ = _data(80, n=1500, d=6)
    want = jdb.neighbor_graph(x, 1.1, backend)
    got = tdb.neighbor_graph(x, 1.1, backend, device="cpu")
    assert want.nnz > 1500
    np.testing.assert_array_equal(got.indptr, want.indptr)
    if backend == "snn":
        # the port's own index: rows as sets (the sorted order may differ)
        for i in range(got.m):
            np.testing.assert_array_equal(np.sort(got.row(i)),
                                          np.sort(want.row(i)))
    else:
        np.testing.assert_array_equal(got.indices, want.indices)
