"""The port's exact boundaries against the JAX reference and float64.

The constructions of ``tests/test_exactness_certificate.py`` (integer
lattices with boundary shells at exactly representable radii, ulp-nudged
plants, orthogonal cosine bases, a Pythagorean mips lift, angular margin
plants) leave no rounding ambiguity, so every boundary point must flip
exactly as in the reference: the port's CSR output on the CPU must equal the
JAX package's and a float64 oracle's, distances included, for the float32
count and the certified bf16 count alike.
"""
import numpy as np
import pytest

from repro.core import engine as jengine
from repro.core import snn as jsnn
from repro_torch.core import engine as tengine
from repro_torch.core import snn as tsnn


def _port_index(index):
    """The port's view of a JAX-built index (the state carried across)."""
    return tsnn.index_from_arrays(index.mu, index.v1, index.xs, index.alphas,
                                  index.half_norms, index.order, index.metric,
                                  index.xi, index.vs, index.projs,
                                  device="cpu")


def _oracle_csr(index, q, radius):
    """Float64 membership ``||x - q||^2 <= r^2`` over the stored rows."""
    xq, r = index.prepare_queries(np.atleast_2d(np.asarray(q)), radius)
    xq64 = np.asarray(xq, np.float64)
    xs64 = np.asarray(index.xs, np.float64)
    indptr = np.zeros(xq64.shape[0] + 1, np.int64)
    rows = []
    for i in range(xq64.shape[0]):
        sq = ((xs64 - xq64[i]) ** 2).sum(axis=1)
        sel = np.nonzero(sq <= r[i] * r[i])[0]
        rows.append(np.asarray(index.order)[sel])
        indptr[i + 1] = indptr[i] + sel.size
    return indptr, np.concatenate(rows).astype(np.int64)


def _nudge(vec, i, ulps):
    v = np.asarray(vec, np.float32).copy()
    x = np.float32(v[i])
    toward = np.float32(np.sign(ulps) * np.inf)
    for _ in range(abs(int(ulps))):
        x = np.nextafter(x, toward, dtype=np.float32)
    v[i] = x
    return v


def _sym(points):
    p = np.asarray(points, np.float32)
    return np.concatenate([p, -p], axis=0)


def _assert_exact(jidx, q, radius, block=512):
    """Port == reference == float64 oracle, distances identical, for f32
    and the certified mixed count pass."""
    want_indptr, want_ids = _oracle_csr(jidx, q, radius)
    ref = jsnn.query_radius_csr(jidx, q, radius, block=block)
    tidx = _port_index(jidx)
    for mixed in (False, True):
        got = tsnn.query_radius_csr(tidx, q, radius, block=block, mixed=mixed,
                                    device="cpu")
        np.testing.assert_array_equal(got.indptr, want_indptr)
        np.testing.assert_array_equal(got.indices, want_ids)
        np.testing.assert_array_equal(got.indptr, ref.indptr)
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_array_equal(got.distances, ref.distances)
    return want_indptr, want_ids


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_euclidean_exact_boundary_shell(dtype):
    shell = [(3, 4, 0), (0, 3, 4), (4, 0, 3), (5, 0, 0), (0, 0, 5)]
    inner = [(1, 1, 1), (2, 2, 0), (1, 0, 2)]
    outer = [(6, 0, 0), (4, 4, 4), (0, 7, 1)]
    jidx = jsnn.build_index(_sym(shell + inner + outer), dtype=dtype)
    q = np.array([[0, 0, 0], [1, 0, 0], [2, 2, 2]], np.float32)
    indptr, _ = _assert_exact(jidx, q, 5.0)
    assert indptr[1] == 2 * len(shell) + 2 * len(inner)
    below, _ = _assert_exact(jidx, q, 5.0 * (1.0 - 1e-5))
    above, _ = _assert_exact(jidx, q, 5.0 * (1.0 + 1e-5))
    assert above[1] - below[1] == 2 * len(shell)   # the shell flips


def test_euclidean_ulp_plants():
    plants = [_nudge((3, 4, 0), 0, +4), _nudge((3, 4, 0), 0, -4),
              _nudge((0, 3, 4), 2, +4), _nudge((0, 3, 4), 2, -4),
              _nudge((5, 0, 0), 0, +4), _nudge((5, 0, 0), 0, -4)]
    anchors = [(1, 1, 0), (2, 0, 1), (6, 1, 0)]
    jidx = jsnn.build_index(_sym(np.concatenate(
        [np.stack(plants), np.asarray(anchors, np.float32)])))
    indptr, _ = _assert_exact(jidx, np.zeros((1, 3), np.float32), 5.0)
    assert indptr[1] == 2 * 3 + 2 * 2   # the inward plants and two anchors


def test_cosine_exact_orthogonal_boundary():
    d = 6
    jidx = jsnn.build_index(_sym(7.0 * np.eye(d, dtype=np.float32)),
                            metric="cosine")
    q = 3.0 * np.eye(d, dtype=np.float32)[:2]
    indptr, _ = _assert_exact(jidx, q, 1.0)
    assert np.all(np.diff(indptr) == 1 + 2 * (d - 1))
    ip2, _ = _assert_exact(jidx, q, 1.0 - 1e-6)
    assert np.all(np.diff(ip2) == 1)
    ip3, _ = _assert_exact(jidx, q, 2.0 + 1e-6)
    assert np.all(np.diff(ip3) == 2 * d)


def test_mips_exact_inner_product_boundary():
    jidx = jsnn.build_index(_sym([(3, 0), (0, 4), (5, 0), (0, 0)]),
                            metric="mips")
    q = np.array([[3, 0]], np.float32)
    indptr, ids = _assert_exact(jidx, q, 9.0)
    assert indptr[1] == 2 and set(ids[:2].tolist()) == {0, 2}
    ip2, ids2 = _assert_exact(jidx, q, 9.0 + 1e-4)
    assert ip2[1] == 1 and ids2[0] == 2    # the boundary point drops out
    ip3, _ = _assert_exact(jidx, q, 9.0 - 1e-4)
    assert ip3[1] == 2


def test_angular_margin_plants():
    theta = 0.8
    angles = [theta - 1e-3, theta + 1e-3, 0.0, 0.3, 1.4, 2.0, 2.8]
    emb = np.zeros((len(angles), 4), np.float32)
    emb[:, 0] = np.cos(angles)
    emb[:, 1] = np.sin(angles)
    jidx = jsnn.build_index(5.0 * emb, metric="angular")
    q = np.zeros((1, 4), np.float32)
    q[0, 0] = 2.0
    indptr, ids = _assert_exact(jidx, q, theta)
    assert indptr[1] == 3 and set(ids.tolist()) == {0, 2, 3}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lattice_multisegment_vector_radius(seed):
    # per-query radii over lattice data, with block=128 making the live-
    # segment and window-skip decisions matter
    rng = np.random.default_rng(seed)
    x = _sym(rng.integers(-6, 7, size=(200, 4)).astype(np.float32))
    q = rng.integers(-6, 7, size=(7, 4)).astype(np.float32)
    radius = rng.choice([1.0, 1.5, 2.0, 2.5, 3.0, 4.0], size=7)
    _assert_exact(jsnn.build_index(x), q, radius, block=128)


def test_multisegment_pack_matches_reference_engine():
    # one index cut into segments, the same cut in both packages: the port's
    # stacked executor against the reference's packed engine
    rng = np.random.default_rng(12)
    jidx = jsnn.build_index(
        _sym(rng.integers(-5, 6, size=(300, 5)).astype(np.float32)))
    q = rng.integers(-5, 6, size=(20, 5)).astype(np.float32)
    radius = rng.choice([1.0, 2.0, 3.0], size=20)
    cuts = [0, 170, 400, jidx.n]
    jsegs, tsegs = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        sl = slice(a, b)
        args = (jidx.xs[sl], jidx.alphas[sl], jidx.half_norms[sl],
                jidx.order[sl])
        jsegs.append(jengine.make_segment(*args, block=128,
                                          projs=jidx.projs[1:, sl]))
        tsegs.append(tengine.make_segment(*args, block=128,
                                          projs=jidx.projs[1:, sl],
                                          device="cpu"))
    jpack = jengine.SegmentPack.build(jsegs)
    tpack = tengine.SegmentPack.build(tsegs)
    tidx = _port_index(jidx)
    for r in (radius, 0.5):
        want = jengine.query_csr_packed(jidx, jpack, q, r)
        got = tengine.query_csr_packed(tidx, tpack, q, r)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.distances, want.distances)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_torch_built_index_matches_float64_oracle(metric):
    # an index built by the port itself: its per-row neighbour sets must
    # equal the float64 host oracle on an exact lattice
    rng = np.random.default_rng(8)
    pts = rng.integers(-4, 5, size=(150, 4)).astype(np.float32)
    if metric == "cosine":
        pts = pts[np.abs(pts).sum(axis=1) > 0]
    x = _sym(np.concatenate([pts, 2.0 * np.eye(4, dtype=np.float32)]))
    q = rng.integers(-4, 5, size=(9, 4)).astype(np.float32)
    radius = 2.5 if metric == "euclidean" else 0.3
    idx = tsnn.build_index(x, metric=metric, device="cpu")
    assert idx.vs.shape == (3, 4) and idx.projs.shape == (3, x.shape[0])
    assert np.all(np.diff(idx.alphas.numpy()) >= 0)
    got = tsnn.query_radius_csr(idx, q, radius, device="cpu")
    xq, r = idx.prepare_queries(q, radius)
    xs = idx.xs.numpy().astype(np.float64)
    for i in range(q.shape[0]):
        sq = ((xs - xq[i].astype(np.float64)) ** 2).sum(axis=1)
        want = np.sort(idx.order[np.nonzero(sq <= r[i] * r[i])[0]])
        np.testing.assert_array_equal(np.sort(got.row(i)[0]), want)
