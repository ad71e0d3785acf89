"""The port's host lane (``oracle=True``) against the JAX oracle lane.

The reference reaches its CPU executors with ``use_pallas=False``: one
dense filter feeding both passes, candidate pruning per query tile
(``compacted=False``), candidate compaction into one batched tile launch
(the default), the looped executor with its cached filters, and the
``memory_budget_mb`` fallbacks between them.  The port reaches the same
executors with ``oracle=True`` on CPU tensors.  Both engines here get the
very same padded operands, made once by the JAX package.

Tolerances, and why: ``indptr`` and ``indices`` must be equal, row order
included; the two packages take their float32 products in different
libraries, so half distances agree to 4 float32 ulp of the largest
magnitude in the result, not bit for bit.  On the exact lattices of
``tests/test_exactness_certificate.py`` there is no rounding at all, and
the host lane must flip every boundary point as the reference does.
"""
import importlib

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import snn as jsnn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import engine as teng
from repro_torch.core import snn as tsnn
from repro_torch.core import streaming as tst
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_boundaries import _nudge, _oracle_csr, _port_index, _sym

# the package exports the function `join`, which shadows the module name
tjoin = importlib.import_module("repro_torch.core.join")

ULPS = 4


def _assert_dh_close(got, want):
    """Within 4 float32 ulp of the largest magnitude in the result: a half
    distance ``hn - q.x`` cancels, so its rounding error scales with its
    terms, not with itself."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if got.size:
        scale = max(np.abs(got).max(), np.abs(want).max())
        tol = ULPS * np.spacing(np.float32(scale))
        assert np.all(np.abs(got - want) <= tol)


def _assert_quad(got, want):
    """(indptr, counts, ids, dhalf) equal up to the distances' ulps."""
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    _assert_dh_close(got[3], want[3])


@pytest.fixture(scope="module")
def case():
    """One 3-component index cut into 5 segments, both packages, and the
    padded operands of 37 queries with per-query radii."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1300, 10)).astype(np.float32)
    q = rng.normal(size=(37, 10)).astype(np.float32)
    radius = rng.uniform(2.2, 3.0, size=37)
    jidx = jsnn.build_index(x)
    assert jidx.projs.shape[0] == 3
    tidx = _port_index(jidx)
    jsegs = jeng.segments_from_index(jidx, rows_per_segment=300, block=128)
    tsegs = teng.segments_from_index(tidx, rows_per_segment=300, block=128,
                                     device="cpu")
    xq, aq, r, th, _ = jsnn.prepare_query_predicates(jidx, q, radius)
    qp, aqp, rp, thp, m = jops.pad_queries(xq, aq, r, th, tq=64)
    pq = jops.pad_components(jsnn.query_extra_projections(jidx, xq),
                             qp.shape[0])
    ops = tuple(np.asarray(a) for a in (qp, aqp, rp, thp))
    return dict(jidx=jidx, tidx=tidx, jsegs=jsegs, tsegs=tsegs, q=q,
                radius=radius, ops=ops, m=m, pq=np.asarray(pq), x=x)


def _both(fn_j, fn_t):
    """Run the JAX and the port call, each from reset counters; return the
    results and the (launches, transfers) each made."""
    out = []
    for eng, fn in ((jeng, fn_j), (teng, fn_t)):
        eng.DISPATCH_STATS.reset()
        res = fn()
        snap = eng.DISPATCH_STATS.snapshot()
        out.append((res, (snap["kernel_launches"], snap["host_transfers"])))
    return out


PACKED = [(c, True, mx) for c in (None, True, False) for mx in (False, True)]
PACKED += [(None, False, mx) for mx in (False, True)]


@pytest.mark.parametrize("compacted,with_pq,mixed", PACKED)
def test_packed_host_executors_match_the_oracle_lane(case, compacted,
                                                     with_pq, mixed):
    ops, m = case["ops"], case["m"]
    pq = case["pq"] if with_pq else None
    jpack = jeng.SegmentPack.build(case["jsegs"])
    tpack = teng.SegmentPack.build(case["tsegs"])
    kw = dict(query_tile=64, pq=pq, mixed=mixed, compacted=compacted)
    (want, jst), (got, tst_) = _both(
        lambda: jeng.run_csr_packed(jpack, *ops, m, use_pallas=False, **kw),
        lambda: teng.run_csr_packed(tpack, *ops, m, oracle=True, **kw))
    _assert_quad(got, want)
    assert tst_ == jst
    assert int(want[0][-1]) > 5 * m           # a real result, not empty
    (cw, jc), (cg, tc) = _both(
        lambda: jeng.run_counts_packed(jpack, *ops, m, use_pallas=False,
                                       **kw),
        lambda: teng.run_counts_packed(tpack, *ops, m, oracle=True, **kw))
    np.testing.assert_array_equal(cg, cw)
    np.testing.assert_array_equal(cg, got[1])
    assert tc == jc


@pytest.mark.parametrize("with_pq", [True, False])
@pytest.mark.parametrize("mixed", [False, True])
def test_looped_host_executor_matches_the_oracle_lane(case, with_pq, mixed):
    ops, m = case["ops"], case["m"]
    pq = case["pq"] if with_pq else None
    for budget in (None, 0.01):   # 0.01 MB keeps one of five filters cached
        kw = dict(query_tile=64, pq=pq, mixed=mixed, memory_budget_mb=budget)
        (want, jst), (got, tst_) = _both(
            lambda: jeng.run_csr(case["jsegs"], *ops, m, use_pallas=False,
                                 **kw),
            lambda: teng.run_csr(case["tsegs"], *ops, m, oracle=True, **kw))
        _assert_quad(got, want)
        assert tst_ == jst


def test_host_paths_agree_within_the_port_and_with_float64(case):
    ops, m, pq = case["ops"], case["m"], case["pq"]
    tpack = teng.SegmentPack.build(case["tsegs"])
    runs = {
        "stacked": teng.run_csr_packed(tpack, *ops, m, pq=pq),
        "dense": teng.run_csr_packed(tpack, *ops, m, oracle=True),
        "pruned": teng.run_csr_packed(tpack, *ops, m, pq=pq, oracle=True,
                                      compacted=False),
        "compacted": teng.run_csr_packed(tpack, *ops, m, pq=pq, oracle=True),
        "looped": teng.run_csr(case["tsegs"], *ops, m, pq=pq, oracle=True,
                               memory_budget_mb=0.0),
    }
    want = runs.pop("stacked")
    for name, got in runs.items():
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w, err_msg=name)
        _assert_dh_close(got[3], want[3])
    # per-row sets against the float64 brute force over the stored rows
    indptr, ids = _oracle_csr(case["jidx"], case["q"], case["radius"])
    np.testing.assert_array_equal(want[0], indptr)
    for i in range(m):
        np.testing.assert_array_equal(
            np.sort(want[2][want[0][i]:want[0][i + 1]]),
            np.sort(ids[indptr[i]:indptr[i + 1]]))


def _calls(monkeypatch):
    """Record the port's looped calls (the budget fallback's target)."""
    seen = []
    real = teng.run_csr

    def spy(*a, **k):
        seen.append(k.get("memory_budget_mb"))
        return real(*a, **k)

    monkeypatch.setattr(teng, "run_csr", spy)
    return seen


@pytest.mark.parametrize("with_pq", [True, False])
def test_budget_falls_back_where_the_reference_does(case, monkeypatch,
                                                    with_pq):
    ops, m = case["ops"], case["m"]
    pq = case["pq"] if with_pq else None
    m_pad = ops[0].shape[0]
    rows = sum(s.xs.shape[0] for s in case["tsegs"])
    # the packed filter (m_pad x rows) or, with components, the largest
    # tile gather (query_tile x (rows + 1)), in float32 bytes
    need = (64 * (rows + 1) if with_pq else m_pad * rows) * 4 / 2**20
    seen = _calls(monkeypatch)
    jpack = jeng.SegmentPack.build(case["jsegs"])
    tpack = teng.SegmentPack.build(case["tsegs"])
    for budget, falls in ((None, False), (2 * need, False),
                          (0.5 * need, True), (1e-4, True)):
        seen.clear()
        kw = dict(query_tile=64, pq=pq, memory_budget_mb=budget)
        (want, jst), (got, tst_) = _both(
            lambda: jeng.run_csr_packed(jpack, *ops, m, use_pallas=False,
                                        **kw),
            lambda: teng.run_csr_packed(tpack, *ops, m, oracle=True, **kw))
        _assert_quad(got, want)
        assert tst_ == jst
        assert seen == ([budget] if falls else [])
        # the counts' fallback: one filter a live segment
        (cw, jc), (cg, tc) = _both(
            lambda: jeng.run_counts_packed(jpack, *ops, m, use_pallas=False,
                                           **kw),
            lambda: teng.run_counts_packed(tpack, *ops, m, oracle=True,
                                           **kw))
        np.testing.assert_array_equal(cg, cw)
        assert tc == jc


def test_triangular_schedule_empty_live_set_and_single_rows():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(256, 4)).astype(np.float32)
    q = rng.normal(size=(6, 4)).astype(np.float32)
    jidx = jsnn.build_index(x)
    tidx = _port_index(jidx)
    xq, aq, r, th, _ = jsnn.prepare_query_predicates(jidx, q, 1.8)
    ops = tuple(np.asarray(a) for a in jops.pad_queries(xq, aq, r, th,
                                                        tq=32)[:4])
    for rows in (32, 1):
        jsegs = jeng.segments_from_index(jidx, rows_per_segment=rows,
                                         block=32)
        tsegs = teng.segments_from_index(tidx, rows_per_segment=rows,
                                         block=32, device="cpu")
        jpack, tpack = (jeng.SegmentPack.build(jsegs),
                        teng.SegmentPack.build(tsegs))
        for k0 in (0, 3, len(tsegs)):
            want = jeng.run_csr_packed(jpack, *ops, 6, query_tile=32,
                                       use_pallas=False, first_seg=k0)
            got = teng.run_csr_packed(tpack, *ops, 6, query_tile=32,
                                      oracle=True, first_seg=k0)
            looped = teng.run_csr(tsegs[k0:], *ops, 6, query_tile=32,
                                  oracle=True)
            _assert_quad(got, want)
            _assert_quad(looped, want)
    # the host oracle's sets on the single-row pack
    indptr, ids = _oracle_csr(jidx, q, 1.8)
    got = teng.query_csr_packed(tidx, tpack, q, 1.8, query_tile=32,
                                oracle=True)
    np.testing.assert_array_equal(got.indptr, indptr)
    for i in range(6):
        np.testing.assert_array_equal(np.sort(got.row(i)[0]),
                                      np.sort(ids[indptr[i]:indptr[i + 1]]))
    # no live segment: windows far from every row, and an empty plan
    far = ops[1] + np.float32(1e3)
    for pack in (tpack, teng.SegmentPack.build([])):
        out = teng.run_csr_packed(pack, ops[0], far, *ops[2:], 6,
                                  query_tile=32, oracle=True)
        assert out[0].tolist() == [0] * 7 and out[2].size == 0
        assert teng.run_counts_packed(pack, ops[0], far, *ops[2:], 6,
                                      oracle=True).tolist() == [0] * 6


def _tile_inputs(seed=5, T=3, p=4, C=24, d=8, ke=2):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(T, C, d)).astype(f)
    qt = rng.normal(size=(T, p, d)).astype(f)
    hnt = (0.5 * (x * x).sum(-1)).astype(f)
    alt = rng.normal(size=(T, C)).astype(f)
    aqt = rng.normal(size=(T, p)).astype(f)
    rt = rng.uniform(1.0, 3.0, size=(T, p)).astype(f)
    tht = (0.5 * (rt * rt - (qt * qt).sum(-1))).astype(f)
    pxt = rng.normal(size=(ke, T, C)).astype(f)
    pqt = rng.normal(size=(ke, T, p)).astype(f)
    # a padding slot per tile: +BIG in alpha and half norm
    alt[:, -1] = hnt[:, -1] = f(tref.BIG)
    return qt, aqt, rt, tht, x, alt, hnt, pqt, pxt


@pytest.mark.parametrize("with_pq", [True, False])
def test_tile_ops_match_the_reference(with_pq):
    args = _tile_inputs()
    if not with_pq:
        args = args[:7]
    t_args = [torch.from_numpy(a) for a in args]
    want = np.asarray(jref.snn_filter_tiles_ref(*args))
    got = tops.snn_filter_tiles(*t_args).numpy()
    np.testing.assert_array_equal(got < tref.BIG, want < jref.BIG)
    _assert_dh_close(np.where(got < tref.BIG, got, 0),
                     np.where(want < jref.BIG, want, 0))
    assert 0 < (got < tref.BIG).sum() < got.size
    for mixed in (False, True):
        np.testing.assert_array_equal(
            tops.snn_count_tiles(*t_args, mixed=mixed).numpy(),
            np.asarray(jref.snn_count_tiles_ref(*args, mixed=mixed)))


def _stack_inputs():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(600, 6)).astype(np.float32)
    q = rng.normal(size=(40, 6)).astype(np.float32)
    jidx = jsnn.build_index(x)
    pack = jeng.SegmentPack.build(jeng.segments_from_index(
        jidx, rows_per_segment=200, block=128))
    xs, al, hn, _ = pack.stacked()
    px = pack.stacked_projs()
    xq, aq, r, th, _ = jsnn.prepare_query_predicates(jidx, q, 1.6)
    qp, aqp, rp, thp, _ = jops.pad_queries(xq, aq, r, th, tq=64)
    pq = jops.pad_components(jsnn.query_extra_projections(jidx, xq),
                             qp.shape[0])
    return [np.asarray(a) for a in (qp, aqp, rp, thp, xs, al, hn, pq, px)]


def test_compacted_stacked_matches_the_reference_and_its_overflows():
    args = _stack_inputs()
    t_args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    # the stacked count and compact kernels' plain versions: the true sizes
    per = tref.snn_count_stacked_ref(*t_args, bn=128)
    total = int(per.sum())
    _, big = jref.snn_csr_compacted_stacked_ref(
        *args, ptile=16, ccap=1024, nnz_cap=8192)[3:]
    cand_max = int(big)
    assert 0 < total and 0 < cand_max < 600
    ccap, nnz_cap = tops.csr_capacity(cand_max), tops.csr_capacity(total)
    for cc, nc in ((ccap, nnz_cap), (ccap // 4, nnz_cap),
                   (ccap, nnz_cap // 4)):
        want = jref.snn_csr_compacted_stacked_ref(*args, ptile=16, ccap=cc,
                                                  nnz_cap=nc)
        got = tops.snn_csr_compacted_stacked(*t_args, ptile=16, ccap=cc,
                                             nnz_cap=nc)
        # the overflow flags: cand_max > ccap, total + 1 > nnz_cap (past
        # ccap the total counts the kept candidates only)
        assert int(got[4]) == int(want[4]) == cand_max
        assert int(got[3]) == int(want[3])
        assert (int(got[3]) == total) == (cc >= cand_max)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        if cc < cand_max or total + 1 > nc:
            assert got[1].shape == (nc,)    # invalid, and nothing past it
            continue
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        _assert_dh_close(got[2].numpy(), np.asarray(want[2]))
        # against the stacked passes: the same pairs, in the same slots
        _, indptr, offsets = tref.stacked_prefix(per)
        fi, _ = tref.snn_compact_stacked_ref(*t_args[:4], offsets,
                                             *t_args[4:], nnz=nnz_cap)
        np.testing.assert_array_equal(got[0].numpy(), indptr.numpy())
        np.testing.assert_array_equal(got[1][:total].numpy(),
                                      fi[:total].numpy())
    # the filter-derived stacked passes
    dh = tref.snn_filter_ref(*t_args[:4], t_args[4].reshape(-1, 128),
                             t_args[5].reshape(-1), t_args[6].reshape(-1),
                             t_args[7], t_args[8].permute(1, 0, 2)
                             .reshape(2, -1))
    cnt = tref.stacked_counts_from_filter(dh, n_seg=3)
    np.testing.assert_array_equal(cnt.numpy(), per.numpy())
    _, _, offsets = tref.stacked_prefix(cnt)
    fi2, _ = tref.snn_compact_stacked_from_filter(dh, offsets, n_seg=3,
                                                  nnz=nnz_cap)
    jfi2, _ = jref.snn_compact_stacked_from_filter(
        dh.numpy(), offsets.numpy(), n_seg=3, nnz=nnz_cap)
    np.testing.assert_array_equal(fi2.numpy(), np.asarray(jfi2))


def test_flat_scratch_reuse_owned_past_the_cap_and_reserve(monkeypatch):
    scratch = teng._FlatScratch()
    ids, dh, owned = scratch.take(100)
    assert not owned and ids.size == 100 and (ids == -1).all()
    ids[:] = 7
    ids2, _, owned2 = scratch.take(50)
    assert not owned2 and np.shares_memory(ids, ids2) and (ids2 == -1).all()
    monkeypatch.setattr(teng, "_SCRATCH_CACHE_MAX", 64)
    ids3, dh3, owned3 = scratch.take(65)
    assert owned3 and not np.shares_memory(ids3, scratch.ids)
    assert (dh3 == np.float32(tref.BIG)).all()
    monkeypatch.undo()
    monkeypatch.setattr(teng, "_SCRATCH", teng._FlatScratch())
    rng = np.random.default_rng(1)
    tidx = tsnn.build_index(rng.normal(size=(300, 5)).astype(np.float32),
                            device="cpu")
    plan = tidx.pack(128, "cpu").memory_plan(256, 128)
    assert plan.staging_cap == tops.csr_capacity(256 * 300 + 1)
    plan.reserve()
    assert teng._SCRATCH.ids.size == plan.staging_cap


def test_concat_after_extend(case):
    tsegs = case["tsegs"]
    base = teng.SegmentPack.build(tsegs[:3])
    base.concat()
    base.concat_projs()
    ext = base.extend(tsegs[3:])
    fresh = teng.SegmentPack.build(tsegs)
    assert ext._concat is not None and ext.epoch == 1
    for a, b in zip(ext.concat(), fresh.concat()):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ext.concat_projs().numpy(),
                                  fresh.concat_projs().numpy())
    # the extended plan answers as the fresh one, on the host lane
    ops, m, pq = case["ops"], case["m"], case["pq"]
    for c in (None, False):
        _assert_quad(teng.run_csr_packed(ext, *ops, m, pq=pq, oracle=True,
                                         compacted=c),
                     teng.run_csr_packed(fresh, *ops, m, pq=pq))


def test_oracle_refuses_a_pack_on_the_card(case, monkeypatch):
    tpack = teng.SegmentPack.build(case["tsegs"])
    ops, m = case["ops"], case["m"]
    monkeypatch.setattr(teng.SegmentPack, "device",
                        property(lambda self: torch.device("cuda")))
    for call in (teng.run_csr_packed, teng.run_counts_packed):
        with pytest.raises(ValueError, match="oracle=True"):
            call(tpack, *ops, m, oracle=True)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="oracle=True"):
        teng._host_only(torch.device("cuda"))


def test_front_ends_take_the_host_lane(case):
    tidx, q, radius = case["tidx"], case["q"], case["radius"]
    want = tsnn.query_radius_csr(tidx, q, radius, device="cpu")
    teng.DISPATCH_STATS.reset()
    for kw in (dict(oracle=True), dict(oracle=True, compacted=False),
               dict(oracle=True, memory_budget_mb=0.0),
               dict(oracle=True, packed=False, memory_budget_mb=0.0)):
        got = tsnn.query_radius_csr(tidx, q, radius, device="cpu", **kw)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5)
    counts = np.diff(want.indptr)
    for c in (None, False):
        np.testing.assert_array_equal(
            tjoin.query_counts(tidx, q, radius, device="cpu", oracle=True,
                               compacted=c), counts)
    x = case["x"]
    a = q[:12]
    j0 = tjoin.join(a, x, 2.5, device="cpu", segment_rows=300)
    j1 = tjoin.join(a, x, 2.5, device="cpu", segment_rows=300, oracle=True,
                    memory_budget_mb=0.05)
    np.testing.assert_array_equal(j1.indptr, j0.indptr)
    np.testing.assert_array_equal(j1.indices, j0.indices)
    np.testing.assert_array_equal(
        tjoin.join_counts(a, None, 2.5, b_index=tidx, device="cpu",
                          oracle=True),
        tjoin.join_counts(a, None, 2.5, b_index=tidx, device="cpu"))
    st = tst.StreamingSNNIndex(x[:900], device="cpu")
    st.append(x[900:])
    s0 = st.query_radius_csr(a, 2.5)
    s1 = st.query_radius_csr(a, 2.5, oracle=True)
    np.testing.assert_array_equal(s1.indptr, s0.indptr)
    np.testing.assert_array_equal(s1.indices, s0.indices)
    np.testing.assert_array_equal(st.query_counts_device(a, 2.5, oracle=True),
                                  np.diff(s0.indptr))


def _host_exact(jidx, q, radius, block=512):
    """The host lane's executors == reference oracle lane == float64."""
    want_indptr, want_ids = _oracle_csr(jidx, q, radius)
    tidx = _port_index(jidx)
    ref = jsnn.query_radius_csr(jidx, q, radius, block=block,
                                use_pallas=False)
    for kw in (dict(), dict(compacted=False), dict(memory_budget_mb=0.0),
               dict(packed=False), dict(mixed=True)):
        got = tsnn.query_radius_csr(tidx, q, radius, block=block,
                                    device="cpu", oracle=True, **kw)
        np.testing.assert_array_equal(got.indptr, want_indptr)
        np.testing.assert_array_equal(got.indices, want_ids)
        np.testing.assert_array_equal(got.indptr, ref.indptr)
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_array_equal(got.distances, ref.distances)
    return want_indptr


def test_lattice_boundaries_flip_on_the_host_lane():
    shell = [(3, 4, 0), (0, 3, 4), (4, 0, 3), (5, 0, 0), (0, 0, 5)]
    inner = [(1, 1, 1), (2, 2, 0), (1, 0, 2)]
    outer = [(6, 0, 0), (4, 4, 4), (0, 7, 1)]
    jidx = jsnn.build_index(_sym(shell + inner + outer))
    q = np.array([[0, 0, 0], [1, 0, 0], [2, 2, 2]], np.float32)
    assert _host_exact(jidx, q, 5.0)[1] == 2 * len(shell) + 2 * len(inner)
    below = _host_exact(jidx, q, 5.0 * (1.0 - 1e-5))
    above = _host_exact(jidx, q, 5.0 * (1.0 + 1e-5))
    assert above[1] - below[1] == 2 * len(shell)   # the shell flips
    plants = [_nudge((3, 4, 0), 0, +4), _nudge((3, 4, 0), 0, -4),
              _nudge((0, 3, 4), 2, +4), _nudge((0, 3, 4), 2, -4)]
    jidx = jsnn.build_index(_sym(np.concatenate(
        [np.stack(plants), np.asarray([(1, 1, 0), (6, 1, 0)], np.float32)])))
    assert _host_exact(jidx, np.zeros((1, 3), np.float32), 5.0)[1] == 2 * 3
    jidx = jsnn.build_index(_sym([(3, 0), (0, 4), (5, 0), (0, 0)]),
                            metric="mips")
    assert _host_exact(jidx, np.array([[3, 0]], np.float32),
                       9.0 + 1e-4)[1] == 1


def test_host_lane_launch_signatures_follow_the_two_ladders():
    # the reference's ladder test on the host lane: bucketed batches keep
    # the query-shaped ops at O(log m) signatures, and the tile ops at the
    # product of the tile-count and candidate-capacity ladders
    from repro_torch.kernels import registry

    rng = np.random.default_rng(42)
    tidx = tsnn.build_index(rng.normal(size=(600, 8)).astype(np.float32),
                            device="cpu")
    sizes = rng.integers(1, 513, size=12)
    registry.reset_compile_counts()
    teng.DISPATCH_STATS.reset()
    for m in sizes:
        q = rng.normal(size=(int(m), 8)).astype(np.float32)
        tsnn.query_radius_csr(tidx, q, 1.0, device="cpu", oracle=True)
    allowed = int(np.ceil(np.log2(max(int(sizes.max()), 128) / 128))) + 2
    counts = registry.compile_counts()
    assert counts.get("snn_filter_tiles", 0) > 0
    for op, n_sigs in counts.items():
        bound = (allowed + 4) ** 2 if "tiles" in op else allowed
        assert n_sigs <= bound, (op, n_sigs, counts)
    assert teng.DISPATCH_STATS.jit_compiles == sum(counts.values())
