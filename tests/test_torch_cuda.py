"""The port's CUDA kernels and its main path on the card.

Every test here needs a CUDA device: each is marked ``cuda`` and skips
without one.  The file imports nothing of JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs are integer lattices, on which every product and threshold is exact
in float32: kernels and plain versions must agree with zero tolerance, and
the main path on the card must equal the same path on the CPU.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch import utils
from repro_torch.core import snn as tsnn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import snn_query as tsq
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import recsys as trs
from repro_torch.utils import tree_leaves, tree_map

# the package exports the function `join`, which shadows the module name
tjoin = importlib.import_module("repro_torch.core.join")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lattice_stack(seed, ke, S=2, n_pad=512, d=5, d_pad=128, m=90,
                   m_pad=128):
    """A segment stack of lattice points (alpha = coordinate 0, the extra
    projections = coordinates 1..ke) and padded lattice queries."""
    rng = np.random.default_rng(seed)
    big = np.float32(tref.BIG)
    xs = np.zeros((S, n_pad, d_pad), np.float32)
    al = np.full((S, n_pad), big, np.float32)
    hn = np.full((S, n_pad), big, np.float32)
    px = np.full((S, ke, n_pad), big, np.float32)
    for s in range(S):
        n_s = n_pad - 70 * (s + 1)
        pts = rng.integers(-3, 4, size=(n_s, d)).astype(np.float32)
        pts[:, 0] += 5 * s
        pts = pts[np.argsort(pts[:, 0], kind="stable")]
        xs[s, :n_s, :d] = pts
        al[s, :n_s] = pts[:, 0]
        hn[s, :n_s] = 0.5 * np.sum(pts * pts, axis=1)
        px[s, :, :n_s] = pts[:, 1:1 + ke].T
    qi = rng.integers(-3, 4, size=(m, d)).astype(np.float32)
    qi[:, 0] += rng.integers(0, 6, size=m)
    r = rng.choice([1.0, 1.5, 2.0, 2.5, 3.0], size=m).astype(np.float32)
    th = ((r * r - np.sum(qi * qi, axis=1)) / 2.0).astype(np.float32)
    q, aq, r, th, _ = tops.pad_queries(qi, qi[:, 0], r, th, tq=m_pad)
    pq = tops.pad_components(qi[:, 1:1 + ke].T, m_pad)
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in (q, aq, r, th, xs, al, hn, pq if ke else None,
                      px if ke else None)]


@pytest.mark.parametrize("ke", [0, 2])
@pytest.mark.parametrize("mixed", [False, True])
def test_cuda_kernels_match_plain_versions(card, ke, mixed):
    ops = [None if t is None else t.to(card)
           for t in _lattice_stack(31 + ke, ke)]
    q, aq, r, th, xs, al, hn, pq, px = ops
    per, part = tsq.snn_count_stacked(*ops, bn=128, mixed=mixed,
                                      with_partials=True)
    want, want_part = tref.snn_count_stacked_ref(*ops, bn=128,
                                                 with_partials=True)
    assert int(want.sum()) > 0
    assert torch.equal(per, want) and torch.equal(part, want_part)
    _, _, off = tref.stacked_prefix(want)
    total = int(want.sum())
    nnz = tops.csr_capacity(total)
    ki, kd = tsq.snn_compact_stacked(q, aq, r, th, off, xs, al, hn, pq, px,
                                     nnz=nnz, bn=128, partials=part)
    pi, pd = tref.snn_compact_stacked_ref(q, aq, r, th, off, xs, al, hn, pq,
                                          px, nnz=nnz)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    # the overflow guard: a capacity without room writes nothing
    oi, od = tsq.snn_compact_stacked(q, aq, r, th, off, xs, al, hn, pq, px,
                                     nnz=total, bn=128, partials=part)
    assert bool((oi == -1).all()) and bool((od == tref.BIG).all())


def test_main_path_on_the_card_equals_the_cpu(card):
    rng = np.random.default_rng(2)
    pts = rng.integers(-5, 6, size=(1500, 6)).astype(np.float32)
    x = np.concatenate([pts, -pts])
    q = rng.integers(-5, 6, size=(70, 6)).astype(np.float32)
    radius = rng.choice([2.0, 3.0, 4.0], size=70)
    cpu_idx = tsnn.build_index(x, device="cpu")
    idx = tsnn.index_from_arrays(cpu_idx.mu, cpu_idx.v1, cpu_idx.xs.numpy(),
                                 cpu_idx.alphas.numpy(),
                                 cpu_idx.half_norms.numpy(), cpu_idx.order,
                                 vs=cpu_idx.vs, projs=cpu_idx.projs.numpy())
    assert idx.xs.is_cuda
    want = tsnn.query_radius_csr(cpu_idx, q, radius, device="cpu")
    tsq.reset_launch_counts()
    runs = [tsnn.query_radius_csr(idx, q, radius),
            tsnn.query_radius_csr(idx, q, radius),             # fused
            tsnn.query_radius_csr(idx, q, radius, mixed=True)]
    assert tsq.snn_count_stacked.launches > 0
    assert tsq.snn_compact_stacked.launches > 0
    for got in runs:
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.distances, want.distances)
    np.testing.assert_array_equal(tjoin.query_counts(idx, q, radius),
                                  np.diff(want.indptr))


def _lattice_segment(card, seed, ke):
    """One lattice segment (a stack of one, unstacked) on the card."""
    q, aq, r, th, xs, al, hn, pq, px = _lattice_stack(seed, ke, S=1,
                                                      n_pad=1024)
    return [None if t is None else t.to(card).contiguous()
            for t in (q, aq, r, th, xs[0], al[0], hn[0], pq,
                      None if px is None else px[0])]


def _arranged_segment(card, seed, ke, m_pad, arrange):
    """A lattice segment (1024 rows, 70 of them padding) and m_pad - m_pad
    // 8 real lattice queries, the rest padding (alpha 0, so they land
    inside the alpha order), the real ones sorted by alpha, reversed, in
    random order, or all moved to alpha 1."""
    m = m_pad - max(1, m_pad // 8)
    q, aq, r, th, xs, al, hn, pq, px = _lattice_stack(
        seed, ke, S=1, n_pad=1024, m=m, m_pad=m_pad)
    if arrange == "one alpha":
        q[:m, 0] = 1.0
        aq[:m] = 1.0
        th[:m] = (r[:m] * r[:m] - (q[:m] * q[:m]).sum(1)) / 2.0  # exact
    else:
        up = torch.argsort(aq[:m], stable=True)
        perm = {"sorted": up, "reversed": up.flip(0),
                "random": torch.from_numpy(
                    np.random.default_rng(seed).permutation(m))}[arrange]
        for t in (q, aq, r, th):
            t[:m] = t[:m][perm]
        if pq is not None:
            pq[:, :m] = pq[:, :m][:, perm]
    return [None if t is None else t.to(card).contiguous()
            for t in (q, aq, r, th, xs[0], al[0], hn[0], pq,
                      None if px is None else px[0])]


@pytest.mark.parametrize("ke", [0, 2])
@pytest.mark.parametrize("m_pad", [8, 128, 136, 1024])
@pytest.mark.parametrize("arrange", ["sorted", "reversed", "random",
                                     "one alpha"])
def test_cuda_snn_filter_matches_plain(card, ke, m_pad, arrange):
    ops = _arranged_segment(card, 41 + ke + m_pad, ke, m_pad, arrange)
    tsq.reset_launch_counts()
    got = tsq.snn_filter(*ops, bn=256)
    want = tref.snn_filter_ref(*ops)
    torch.cuda.synchronize()
    assert tsq.snn_filter.launches == 1
    assert 0 < int((want < tref.BIG).sum()) < want.numel()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("ke", [0, 2])
def test_cuda_snn_filter_finite_entries_are_the_compacts_survivors(card, ke):
    """Real-valued rows and queries, with float32 rounding in every dot: the
    filter's finite entries are exactly the compact's survivors, in the same
    (query, row) order, and their bits are the survivors' dhalf."""
    q, aq, r, th, xs, al, hn, pq, px = (
        None if t is None else t.to(card)
        for t in _real_stack(13 + ke, 1, ke, n_pad=4096, m_pad=1024))
    seg = (xs[0].contiguous(), al[0].contiguous(), hn[0].contiguous(), pq,
           None if px is None else px[0].contiguous())
    ops = (q, aq, r, th, *seg)
    f = tsq.snn_filter(*ops, bn=512)
    cnt, part = tsq.snn_count(*ops, bn=512, with_partials=True)
    total = int(cnt.sum())
    off = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
    ki, kd = tsq.snn_compact(q, aq, r, th, off, *seg,
                             nnz=tops.csr_capacity(total), bn=512,
                             partials=part)
    torch.cuda.synchronize()
    fq, fj = torch.nonzero(f < tref.BIG, as_tuple=True)
    assert total > 0 and fq.numel() == total
    rows = torch.arange(q.shape[0], device=card).repeat_interleave(cnt)
    assert torch.equal(fq, rows) and torch.equal(fj, ki[:total].long())
    assert torch.equal(f[fq, fj].view(torch.int32),
                       kd[:total].view(torch.int32))


@pytest.mark.parametrize("ke", [0, 2])
@pytest.mark.parametrize("mixed", [False, True])
def test_cuda_snn_count_matches_plain(card, ke, mixed):
    ops = _lattice_segment(card, 51 + ke, ke)
    got, part = tsq.snn_count(*ops, bn=256, mixed=mixed, with_partials=True)
    want, want_part = tref.snn_count_ref(*ops, bn=256, with_partials=True)
    torch.cuda.synchronize()
    assert int(want.sum()) > 0
    assert torch.equal(got, want) and torch.equal(part, want_part)


@pytest.mark.parametrize("ke", [0, 2])
def test_cuda_snn_compact_matches_plain(card, ke):
    q, aq, r, th, xs, al, hn, pq, px = _lattice_segment(card, 61 + ke, ke)
    counts = tref.snn_count_ref(q, aq, r, th, xs, al, hn, pq, px)
    total = int(counts.sum())
    off = (torch.cumsum(counts, 0, dtype=torch.int32) - counts) + 5
    nnz = tops.csr_capacity(total + 5)
    want = tref.snn_compact_ref(q, aq, r, th, off, xs, al, hn, pq, px,
                                nnz=nnz)
    for handed in (True, False):
        part = tsq.snn_count(q, aq, r, th, xs, al, hn, pq, px, bn=256,
                             with_partials=True)[1] if handed else None
        ki, kd = tsq.snn_compact(q, aq, r, th, off, xs, al, hn, pq, px,
                                 nnz=nnz, bn=256, partials=part)
        torch.cuda.synchronize()
        assert torch.equal(ki, want[0])
        assert torch.equal(kd.view(torch.int32), want[1].view(torch.int32))
        assert bool((ki[:5] == -1).all()) and bool((ki[5:5 + total] >= 0)
                                                   .all())
        assert bool((ki[5 + total:] == -1).all())


def _sparse_stack(seed, ke, S=2, n_pad=12288, m=290, m_pad=300):
    """A stack on which survivors are rare, on exact lattice points: rows in
    groups of 16 at one alpha (two apart), on a 4 x 4 grid of pitch 3 in
    coordinates 1-2 with (0, 0) last in odd groups and first in even ones,
    so rows 127 and 128 are (14, 0, 0) and (16, 0, 0).  Query 0 at
    (15, 0, 0), r = 1, has exactly those two survivors, across a 128-row
    sub-tile boundary; queries 1-127 sit between the points (windows meet
    rows, balls none); the rest sit on rows of two row blocks with r = 1 or
    3, or between the points.  m_pad is not a multiple of 128."""
    rng = np.random.default_rng(seed)
    big = np.float32(tref.BIG)
    d, d_pad, n_s, a_seg = 3, 128, n_pad - 200, 2000.0
    grid = np.array([(y, z) for y in (0, 3, 6, 9) for z in (0, 3, 6, 9)],
                    np.float32)
    xs = np.zeros((S, n_pad, d_pad), np.float32)
    al = np.full((S, n_pad), big, np.float32)
    hn = np.full((S, n_pad), big, np.float32)
    px = np.full((S, ke, n_pad), big, np.float32)
    g = np.arange(n_s) // 16
    pos = np.where(g % 2 == 1, 15 - np.arange(n_s) % 16, np.arange(n_s) % 16)
    for s in range(S):
        pts = np.zeros((n_s, d), np.float32)
        pts[:, 0] = 2.0 * g + a_seg * s
        pts[:, 1:3] = grid[pos]
        xs[s, :n_s, :d] = pts
        al[s, :n_s] = pts[:, 0]
        hn[s, :n_s] = 0.5 * np.sum(pts * pts, axis=1)
        px[s, :, :n_s] = pts[:, 1:1 + ke].T

    def between(k):
        a = 2.0 * rng.integers(0, n_s // 16 - 1, k) + 1
        return np.stack([a + a_seg * rng.integers(0, S, k), np.ones(k),
                         np.ones(k)], 1)

    qi = np.zeros((m, d), np.float32)
    r = np.ones(m, np.float32)
    qi[0] = (15.0, 0.0, 0.0)
    qi[1:128] = between(127)
    kind = rng.integers(0, 3, m - 128)
    rows = 512 * rng.choice([5, 17], m - 128) + rng.integers(0, 512, m - 128)
    qi[128:] = xs[rng.integers(0, S, m - 128), rows, :d]
    r[128:] = np.where(kind == 0, 1.0, np.where(kind == 1, 3.0, 0.5))
    qi[128:][kind == 2] = between(int((kind == 2).sum()))
    th = ((r * r - np.sum(qi * qi, axis=1)) / 2.0).astype(np.float32)
    q, aq, r, th, _ = tops.pad_queries(qi, qi[:, 0], r, th, tq=m_pad)
    pq = tops.pad_components(qi[:, 1:1 + ke].T, m_pad)
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in (q, aq, r, th, xs, al, hn, pq if ke else None,
                      px if ke else None)]


@pytest.mark.parametrize("ke", [0, 2])
@pytest.mark.parametrize("mixed", [False, True])
def test_cuda_sparse_survivors_match_plain_stacked(card, ke, mixed):
    ops = [None if t is None else t.to(card) for t in _sparse_stack(81 + ke,
                                                                    ke)]
    q, aq, r, th, xs, al, hn, pq, px = ops
    per, part = tsq.snn_count_stacked(*ops, bn=512, mixed=mixed,
                                      with_partials=True)
    want, want_part = tref.snn_count_stacked_ref(*ops, bn=512,
                                                 with_partials=True)
    torch.cuda.synchronize()
    assert int(want[0, 0]) == 2 and int(want[:, 1:128].sum()) == 0
    assert float((want_part == 0).float().mean()) > 0.9
    assert torch.equal(per, want) and torch.equal(part, want_part)
    _, _, off = tref.stacked_prefix(want)
    total = int(want.sum())
    nnz = tops.csr_capacity(total)
    pi, pd = tref.snn_compact_stacked_ref(q, aq, r, th, off, xs, al, hn, pq,
                                          px, nnz=nnz)
    for handed in (part, None):
        ki, kd = tsq.snn_compact_stacked(q, aq, r, th, off, xs, al, hn, pq,
                                         px, nnz=nnz, bn=512, partials=handed)
        torch.cuda.synchronize()
        assert torch.equal(ki, pi)
        assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    # query 0's survivors are the last row of one sub-tile and the first of
    # the next, in that order
    assert ki[:2].tolist() == [127, 128]
    oi, od = tsq.snn_compact_stacked(q, aq, r, th, off, xs, al, hn, pq, px,
                                     nnz=total, bn=512, partials=part)
    assert bool((oi == -1).all()) and bool((od == tref.BIG).all())


@pytest.mark.parametrize("ke", [0, 2])
@pytest.mark.parametrize("mixed", [False, True])
def test_cuda_sparse_survivors_match_plain_single(card, ke, mixed):
    ops = [None if t is None else t.to(card) for t in _sparse_stack(91 + ke,
                                                                    ke)]
    q, aq, r, th, xs, al, hn, pq, px = ops
    stacked = tsq.snn_count_stacked(*ops, bn=512)
    for s in range(xs.shape[0]):
        seg = (xs[s].contiguous(), al[s].contiguous(), hn[s].contiguous(), pq,
               None if px is None else px[s].contiguous())
        cnt, part = tsq.snn_count(q, aq, r, th, *seg, bn=512, mixed=mixed,
                                  with_partials=True)
        want, want_part = tref.snn_count_ref(q, aq, r, th, *seg, bn=512,
                                             with_partials=True)
        torch.cuda.synchronize()
        assert torch.equal(cnt, want) and torch.equal(part, want_part)
        assert torch.equal(cnt, stacked[s])
        total = int(want.sum())
        off = (torch.cumsum(want, 0, dtype=torch.int32) - want) + 3
        for nnz in (tops.csr_capacity(total + 3), 3 + total // 2 + 1):
            pi, pd = tref.snn_compact_ref(q, aq, r, th, off, *seg, nnz=nnz)
            ki, kd = tsq.snn_compact(q, aq, r, th, off, *seg, nnz=nnz, bn=512,
                                     partials=part)
            torch.cuda.synchronize()
            assert torch.equal(ki, pi)
            assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))


def _real_stack(seed, S, ke, n_pad=512, d=128, m_pad=2048):
    """Real-valued Gaussian rows cut into S sorted 512-row segments, and
    2048 Gaussian queries at a radius that keeps about one pair in a
    thousand: the graph builder's segment shape, with float32 rounding."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S * n_pad, d)).astype(np.float32)
    x = x[np.argsort(x[:, 0], kind="stable")]
    qi = rng.normal(size=(m_pad, d)).astype(np.float32)
    d2 = ((qi[:64, None, :] - x[None, ::97, :]) ** 2).sum(-1)
    r = np.full(m_pad, np.sqrt(np.quantile(d2, 1e-3)), np.float32)
    th = ((r * r - np.sum(qi * qi, axis=1)) / 2.0).astype(np.float32)
    xs = x.reshape(S, n_pad, d)
    hn = (0.5 * np.sum(xs * xs, axis=2)).astype(np.float32)
    px = np.ascontiguousarray(xs[:, :, 1:1 + ke].transpose(0, 2, 1))
    pq = np.ascontiguousarray(qi[:, 1:1 + ke].T)
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in (qi, qi[:, 0], r, th, xs, xs[:, :, 0], hn,
                      pq if ke else None, px if ke else None)]


@pytest.mark.parametrize("ke", [0, 2])
def test_cuda_looped_equals_packed_at_the_graph_segment_shape(card, ke):
    """One stack of 12 segments against each segment alone: different query
    tiles and block counts, the same fmaf chain a pair, so counts, ids and
    dhalf agree bit for bit."""
    ops = [None if t is None else t.to(card) for t in _real_stack(7, 12, ke)]
    q, aq, r, th, xs, al, hn, pq, px = ops
    S, n_pad = xs.shape[:2]
    assert tsq.launch_geometry("count", S, 2048, n_pad, 512, ke) != \
        tsq.launch_geometry("count", 1, 2048, n_pad, 512, ke)
    per, part = tsq.snn_count_stacked(*ops, bn=512, with_partials=True)
    _, _, off = tref.stacked_prefix(per)
    total = int(per.sum())
    assert total > 0
    nnz = tops.csr_capacity(total)
    pi, pd = tsq.snn_compact_stacked(q, aq, r, th, off, xs, al, hn, pq, px,
                                     nnz=nnz, bn=512, partials=part)
    for s in range(S):
        seg = (xs[s].contiguous(), al[s].contiguous(), hn[s].contiguous(), pq,
               None if px is None else px[s].contiguous())
        cnt, spart = tsq.snn_count(q, aq, r, th, *seg, bn=512,
                                   with_partials=True)
        assert torch.equal(cnt, per[s]) and torch.equal(spart, part[s])
        li, ld = tsq.snn_compact(q, aq, r, th, off[s].contiguous(), *seg,
                                 nnz=nnz, bn=512, partials=spart)
        torch.cuda.synchronize()
        mine = li >= 0
        assert torch.equal(li[mine] + s * n_pad, pi[mine])
        assert torch.equal(ld[mine].view(torch.int32),
                           pd[mine].view(torch.int32))
        assert int(mine.sum()) == int(per[s].sum())


def test_cuda_graph_segment_shape_fills_the_card(card):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for kernel in ("count", "compact"):
        small = tsq.launch_geometry(kernel, 1, 2048, 512, 512, 2)
        assert small["blocks"] >= sms
        big = tsq.launch_geometry(kernel, 1, 1024, 1_000_448, 512, 2)
        assert big["query_tile"] == 128 and big["threads"] == 256


def test_looped_and_packed_graph_on_the_card_equal_the_cpu(card):
    from repro_torch.core import graph as tgraph

    # a point set symmetric about 0 has mean 0 exactly, so the centred rows
    # stay integer and every predicate is exact on both devices
    rng = np.random.default_rng(3)
    pts = rng.integers(-4, 5, size=(1500, 6)).astype(np.float32)
    x = np.concatenate([pts, -pts])
    cpu_idx = tsnn.build_index(x, device="cpu")
    idx = tsnn.index_from_arrays(cpu_idx.mu, cpu_idx.v1, cpu_idx.xs.numpy(),
                                 cpu_idx.alphas.numpy(),
                                 cpu_idx.half_norms.numpy(), cpu_idx.order,
                                 vs=cpu_idx.vs, projs=cpu_idx.projs.numpy())
    want = tgraph.build_neighbor_graph(x, 3.0, index=cpu_idx, device="cpu")
    tsq.reset_launch_counts()
    for kw in (dict(), dict(packed=False), dict(symmetric=True)):
        got = tgraph.build_neighbor_graph(x, 3.0, index=idx, **kw)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
    assert tsq.snn_count.launches > 0 and tsq.snn_compact.launches > 0
    assert tsq.snn_count_stacked.launches > 0



def _symmetric_lattice(seed, n=1500, d=6):
    """Integer points and their negatives (mean 0 exactly, so the centred
    rows stay integer) and an index over them on the CPU and on the card:
    every predicate is exact on both devices."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    x = np.concatenate([pts, -pts])
    cpu_idx = tsnn.build_index(x, device="cpu")
    idx = tsnn.index_from_arrays(cpu_idx.mu, cpu_idx.v1, cpu_idx.xs.numpy(),
                                 cpu_idx.alphas.numpy(),
                                 cpu_idx.half_norms.numpy(), cpu_idx.order,
                                 vs=cpu_idx.vs, projs=cpu_idx.projs.numpy())
    q = rng.integers(-4, 5, size=(90, d)).astype(np.float32)
    return x, q, cpu_idx, idx, rng


def test_cuda_query_knn_equals_the_cpu(card):
    from repro_torch.core import knn as tknn

    _, q, cpu_idx, idx, rng = _symmetric_lattice(5)
    k = rng.integers(1, 60, size=q.shape[0])
    want = tknn.query_knn(cpu_idx, q, k, device="cpu")
    tsq.reset_launch_counts()
    got = tknn.query_knn(idx, q, k)
    assert tsq.snn_count_stacked.launches >= 2   # a round and the final pass
    assert tsq.snn_compact_stacked.launches >= 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_cuda_join_counts_and_reverse_neighbors_equal_the_cpu(card):
    x, q, cpu_idx, idx, rng = _symmetric_lattice(6)
    radii = rng.choice([1.5, 2.5, 3.5], size=q.shape[0])
    kw = dict(query_chunk=32, segment_rows=256, block=256)
    want = tjoin.join_counts(q, None, radii, b_index=cpu_idx, device="cpu",
                             **kw)
    tsq.reset_launch_counts()
    got = tjoin.join_counts(q, None, radii, b_index=idx, **kw)
    assert tsq.snn_count_stacked.launches > 0
    assert tsq.snn_compact_stacked.launches == 0
    np.testing.assert_array_equal(got, want)
    hkw = dict(query_chunk=256, block=256)
    hist, deg = tjoin.degree_histogram(x, 2.5, index=idx, **hkw)
    whist, wdeg = tjoin.degree_histogram(x, 2.5, index=cpu_idx,
                                         device="cpu", **hkw)
    np.testing.assert_array_equal(deg, wdeg)
    np.testing.assert_array_equal(hist, whist)
    rev = tjoin.reverse_neighbors(q, x, radii, target_index=idx, **kw)
    wrev = tjoin.reverse_neighbors(q, x, radii, target_index=cpu_idx,
                                   device="cpu", **kw)
    np.testing.assert_array_equal(rev.indptr, wrev.indptr)
    np.testing.assert_array_equal(rev.indices, wrev.indices)


def test_cuda_query_radius_fixed_equals_the_cpu(card):
    _, q, cpu_idx, idx, rng = _symmetric_lattice(7)
    radii = rng.choice([1.5, 2.5, 3.5], size=q.shape[0])
    for k in (1, 16, 300):
        want = tsnn.query_radius_fixed(cpu_idx, q, radii, k, block=256)
        tsq.reset_launch_counts()
        got = tsnn.query_radius_fixed(idx, q, radii, k, block=256)
        assert tsq.snn_filter.launches == 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert (want[3] > 16).any()   # cuts inside ties of equal distance


@pytest.mark.parametrize("packed", [True, False])
def test_cuda_sharded_csr_equals_the_single_device_csr(card, packed):
    from repro_torch.core import sharded as tsh

    _, q, cpu_idx, idx, rng = _symmetric_lattice(10)
    radii = rng.choice([1.5, 2.5, 3.5], size=q.shape[0])
    kw = dict(block=128, query_tile=128, packed=packed)
    want = tsnn.query_radius_csr(cpu_idx, q, radii, device="cpu",
                                 block=128)
    tsq.reset_launch_counts()
    pack = tsh.mesh_pack(idx, 8, block=128) if packed else None
    runs = [tsh.query_radius_csr_sharded(idx, 8, q, radii, pack=pack, **kw)
            for _ in range(2)]
    if packed:
        assert tsq.snn_count_stacked.launches > 0
        assert tsq.snn_count.launches == 0
    else:
        assert tsq.snn_count.launches > 0 and tsq.snn_compact.launches > 0
    single = tsnn.query_radius_csr(idx, q, radii, block=128)
    for got in runs + [single]:
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.distances, want.distances)


@pytest.mark.parametrize("nshards", [3, 8])
def test_cuda_graph_sharded_equals_the_plain_graph(card, nshards):
    from repro_torch.core import graph as tgraph

    x, _, cpu_idx, idx, rng = _symmetric_lattice(11)
    eps = rng.choice([2.0, 2.5, 3.0], size=x.shape[0])
    kw = dict(return_distance=True, query_chunk=256, block=128)
    want = tgraph.build_neighbor_graph(x, eps, index=cpu_idx, device="cpu",
                                       **kw)
    tsq.reset_launch_counts()
    got = tgraph.build_neighbor_graph_sharded(x, nshards, eps, index=idx,
                                              **kw)
    assert tsq.snn_count_stacked.launches > 0
    plain = tgraph.build_neighbor_graph(x, eps, index=idx, **kw)
    for g in (got, plain):
        np.testing.assert_array_equal(g.indptr, want.indptr)
        np.testing.assert_array_equal(g.indices, want.indices)
        np.testing.assert_array_equal(g.distances, want.distances)


def test_cuda_collectives_and_service_step_on_nccl(card, tmp_path):
    import torch.distributed as dist

    from repro_torch.core import sharded as tsh
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import snn_cell

    _, q, cpu_idx, idx, rng = _symmetric_lattice(12)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = tmesh.make_host_mesh()
        shard = tsh.shard_index(idx, mesh, block=128)
        assert shard[0].is_cuda
        qa = tsh.prepare_query_arrays(idx, q, 2.5)
        tsq.reset_launch_counts()
        count = tsh.make_sharded_count_fn(mesh)(*shard[:3], *qa)
        per = tsh.make_sharded_percount_fn(mesh)(*shard[:3], *qa)
        exact = tsnn.query_counts(cpu_idx, q, 2.5)
        ids, _ = tsh.make_sharded_topk_fn(mesh, int(exact.max()) + 1)(
            *shard, *qa)
        assert tsq.snn_filter.launches == 3
        np.testing.assert_array_equal(count.cpu().numpy(), exact)
        np.testing.assert_array_equal(per.cpu().numpy(), exact[None, :])
        want = tsnn.query_radius_batch(cpu_idx, q, 2.5,
                                       return_distance=False)
        ids = ids.cpu().numpy()
        for i in range(q.shape[0]):
            assert set(ids[i][ids[i] >= 0].tolist()) == set(want[i].tolist())
        # the service step: one stacked count launch over 128-row slabs
        xs, al, hn, _, _, _ = tsh._pad_for_shards(idx, 1, block=1024)
        cxs, cal, chn, _, _, _ = tsh._pad_for_shards(cpu_idx, 1, block=1024)
        qp = [t[:64] for t in qa]
        cq = [t.cpu() for t in qp]
        for prune in (True, False):
            kw = dict(q_chunk=64, n_chunk=1024, prune=prune)
            tsq.reset_launch_counts()
            got = snn_cell.make_service_count_step(mesh, "data", **kw)(
                xs, al, hn, *qp)
            assert tsq.snn_count_stacked.launches == 1
            plain = snn_cell.make_service_count_step(None, "data", **kw)(
                cxs, cal, chn, *cq)
            np.testing.assert_array_equal(got.cpu().numpy(), plain.numpy())
            np.testing.assert_array_equal(plain.numpy(), exact[:64])
    finally:
        dist.destroy_process_group()


def test_cuda_streaming_sequence_equals_the_cpu(card):
    from repro_torch.core import streaming as tst

    x, q, _, _, rng = _symmetric_lattice(8)
    host = tst.StreamingSNNIndex(x, block=256, max_deltas=2,
                                 delta_ratio=10.0, device="cpu")
    leaves, extra = host.state_leaves()
    cpu = tst.StreamingSNNIndex.from_state(leaves, extra, device="cpu")
    dev = tst.StreamingSNNIndex.from_state(leaves, extra)
    dev.set_plan_warming(m_pads=(128,))
    assert dev.base.xs.is_cuda
    for gen in range(4):   # two deltas, a merge, a delta
        b = rng.integers(-4, 5, size=(200, x.shape[1])).astype(np.float32)
        cpu.append(b)
        dev.append(b)
        for a, w in zip(dev.state_leaves()[0], cpu.state_leaves()[0]):
            np.testing.assert_array_equal(a, w)
        want = cpu.query_radius_csr(q, 2.5)
        for got in (dev.query_radius_csr(q, 2.5),
                    dev.query_radius_csr(q, 2.5, packed=False)):
            np.testing.assert_array_equal(got.indptr, want.indptr)
            np.testing.assert_array_equal(got.indices, want.indices)
            np.testing.assert_array_equal(got.distances, want.distances)
        np.testing.assert_array_equal(dev.query_counts_device(q, 2.5),
                                      np.diff(want.indptr))
        np.testing.assert_array_equal(dev.query_knn(q, 9)[0],
                                      cpu.query_knn(q, 9)[0])
        for a, w in zip(dev.query_radius_fixed(q, 2.5, 20),
                        cpu.query_radius_fixed(q, 2.5, 20)):
            np.testing.assert_array_equal(a, w)
    assert dev.warm_runs == 4 and dev.warm_failures == 0


def test_cuda_server_mixed_batch_equals_the_cpu(card):
    """A server on the card answers a mixed batch (radius, join with
    per-row radii, count, reverse, kNN with mixed k) as the CPU port does
    on the same `from_state` leaves, bit for bit, on a lattice, in two
    rounds (the second fused), and on the fixed path (the filter) too."""
    from repro_torch.configs.snn_default import SNNConfig
    from repro_torch.core import streaming as tst
    from repro_torch.serving import IndexRegistry, Request, SNNServer

    x, q, _, _, rng = _symmetric_lattice(9)
    host = tst.StreamingSNNIndex(x, block=256, device="cpu")
    host.append(rng.integers(-4, 5, size=(150, x.shape[1]))
                .astype(np.float32))
    leaves, extra = host.state_leaves()
    rr = rng.choice([1.5, 2.0, 2.5], size=host.n)
    jr = rng.choice([2.0, 3.0], 8)

    def batch():
        return [Request(query=q[0], radius=2.5, id=0),
                Request(query=q[1:9], radius=jr, id=1),
                Request(query=q[9], radius=2.5, count_only=True, id=2),
                Request(query=q[10:13], reverse=True, id=3),
                Request(query=q[13], k=5, id=4),
                Request(query=q[14], k=11, id=5)]

    answers = {}
    for dev in ("cpu", "cuda"):
        for cfg in (SNNConfig(), SNNConfig(serve_exact=False)):
            reg = IndexRegistry(cfg, device=dev)
            reg.add("default", tst.StreamingSNNIndex.from_state(
                leaves, extra, device=dev))
            server = SNNServer(registry=reg, cfg=cfg, device=dev)
            server.set_reverse_radii(rr)
            tsq.reset_launch_counts()
            for rnd in range(2):
                server._run_batch(batch())
                answers[dev, cfg.serve_exact, rnd] = dict(server._results)
                server._results.clear()
            if dev == "cuda":
                # the exact path never reaches the filter, the fixed one does
                assert (tsq.snn_filter.launches == 0) == cfg.serve_exact
                assert tsq.snn_count_stacked.launches > 0
    for exact in (True, False):
        for rnd in range(2):
            want, got = answers["cpu", exact, rnd], answers["cuda", exact, rnd]
            assert sorted(got) == sorted(want) == list(range(6))
            for rid in range(6):
                w, g = want[rid], got[rid]
                assert (g.error is None) == (w.error is None), rid
                assert (g.error is None) == (exact or rid in (0, 4, 5)), rid
                np.testing.assert_array_equal(g.indices, w.indices)
                np.testing.assert_array_equal(g.sq_dists, w.sq_dists)
                for f in ("indptr", "counts"):
                    a, b = getattr(w, f), getattr(g, f)
                    assert (a is None) == (b is None)
                    if a is not None:
                        np.testing.assert_array_equal(b, a)


@pytest.fixture
def tf32_on():
    """TF32 turned on process-wide, as an application may set it, and
    turned back afterwards."""
    m = torch.backends.cuda.matmul
    before = m.allow_tf32
    m.allow_tf32 = True
    yield
    m.allow_tf32 = before


def test_cuda_host_batch_query_is_exact_with_tf32_on(card, tf32_on):
    """`query_radius_batch` takes its window products with TF32 off, so a
    caller's TF32 setting does not change its answer: every pair outside
    the float32 band of the threshold agrees with a float64 brute force, as
    on the CPU.  Random rows at d = 16, not a lattice: TF32 is exact on
    small integers, and at this width its error is several times the band.
    The same product taken with TF32 on does flip pairs outside the band,
    so the check can see the fault it guards against."""
    rng = np.random.default_rng(9)
    n, d, m = 4000, 16, 256
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = (x[rng.choice(n, m, replace=False)]
         + 0.5 * rng.normal(size=(m, d))).astype(np.float32)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    d2 = (np.sum(x64 * x64, 1)[None, :] + np.sum(q64 * q64, 1)[:, None]
          - 2.0 * q64 @ x64.T)
    r2 = np.sort(d2, axis=1)[:, 200]      # a boundary inside the data
    xn2 = np.sum(x64 * x64, 1)[None, :]
    qn2 = np.sum(q64 * q64, 1)[:, None]
    tol = 4.0 * d * 2.0 ** -23 * (xn2 + qn2 + np.sqrt(xn2 * qn2))
    out = np.abs(d2 - r2[:, None]) > tol
    cpu_idx = tsnn.build_index(x, device="cpu")
    idx = tsnn.index_from_arrays(cpu_idx.mu, cpu_idx.v1, cpu_idx.xs.numpy(),
                                 cpu_idx.alphas.numpy(),
                                 cpu_idx.half_norms.numpy(), cpu_idx.order,
                                 vs=cpu_idx.vs, projs=cpu_idx.projs.numpy())

    def wrong(lists):
        got = np.zeros((m, n), bool)
        for i, ids in enumerate(lists):
            got[i, ids] = True
        return int(np.sum((got != (d2 <= r2[:, None])) & out))

    radius = np.sqrt(r2)
    for dev_idx in (idx, cpu_idx):
        res = tsnn.query_radius_batch(dev_idx, q, radius, group_size=16)
        assert wrong([ids for ids, _ in res]) == 0
    assert torch.backends.cuda.matmul.allow_tf32
    # the same product with TF32 on, in the index's sorted order
    xq = torch.from_numpy(q - cpu_idx.mu).to(card)
    hn = idx.half_norms[:, None]
    dh = (hn - idx.xs @ xq.T).cpu().numpy().T
    th = (r2 - np.sum((q - cpu_idx.mu) ** 2, 1)) / 2.0
    raw = [idx.order[np.nonzero(dh[i] <= th[i])[0]] for i in range(m)]
    assert wrong(raw) > 0


# --------------------------------------------------------------------------- #
# embedding_bag and the recsys serving path                                    #
# --------------------------------------------------------------------------- #
def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _lattice_bags(seed, B, F, D, V, dtype):
    """(B, F) ids with -1 padding (bag 1 all padding) over an integer-valued
    (V, D) table: sums up to 400 in magnitude, so bfloat16 rounds on the way
    (after each add in slot order, as the plain version does)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, F)).astype(np.int32)
    ids[rng.random((B, F)) < 0.2] = -1
    ids[1, :] = -1
    table = rng.integers(-4, 5, (V, D)).astype(np.float32)
    return torch.from_numpy(ids), torch.from_numpy(table).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 3, 32, 64, 128])
@pytest.mark.parametrize("F", [1, 40, 100])
def test_cuda_embedding_bag_matches_plain(card, dtype, D, F):
    ids, table = _lattice_bags(D + F, 300, F, D, 1000, dtype)
    ids, table = ids.to(card), table.to(card)
    tsq.reset_launch_counts()
    got = tsq.embedding_bag(ids, table)
    want = tref.embedding_bag_ref(ids, table)
    torch.cuda.synchronize()
    assert tsq.embedding_bag.launches == 1
    assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))
    assert not bool(got[1].any())
    mean = tops.embedding_bag(ids, table, mode="mean")
    assert torch.equal(_bits(mean.cpu()), _bits(tops.embedding_bag(
        ids.cpu(), table.cpu(), mode="mean")))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_embedding_bag_unaligned_table_takes_the_scalar_path(card,
                                                                  dtype):
    ids, table = _lattice_bags(5, 64, 7, 128, 200, dtype)
    buf = torch.zeros(table.numel() + 1, dtype=dtype, device=card)
    buf[1:] = table.reshape(-1).to(card)
    view = buf[1:].view(table.shape)               # 2 or 4 bytes off 16
    got = tsq.embedding_bag(ids.to(card), view)
    assert torch.equal(_bits(got.cpu()),
                       _bits(tref.embedding_bag_ref(ids, table)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_embedding_bag_ids_past_the_table_read_its_last_row(card,
                                                                 dtype):
    # the CUDA kernel, the plain version and the Pallas kernel off the TPU
    # all read row V - 1 for an id at or above V
    ids, table = _lattice_bags(6, 32, 5, 64, 100, dtype)
    ids[0, :] = torch.tensor([100, 101, 2 ** 31 - 1, -1, 3])
    ids[4, 2] = 99
    got = tsq.embedding_bag(ids.to(card), table.to(card))
    want = tref.embedding_bag_ref(ids, table)
    assert torch.equal(_bits(got.cpu()), _bits(want))
    assert torch.equal(want, tref.embedding_bag_ref(ids.clamp_max(99), table))


def test_cuda_embedding_bag_reads_rows_past_2_31_elements(card):
    # a bfloat16 table of 2^31 / D + 64 rows (4.3 GB): the last rows start
    # past element 2^31, so their offsets need 64 bits
    D = 128
    V = 2 ** 31 // D + 64
    table = torch.zeros((V, D), dtype=torch.bfloat16, device=card)
    rows = torch.arange(V - 128, V, device=card)
    vals = (rows[:, None] * 7 + torch.arange(D, device=card)[None, :]) % 9 - 4
    table[rows] = vals.to(torch.bfloat16)
    ids = rows.to(torch.int32).view(16, 8).clone()
    ids[3, ::2] = -1
    ids[0, 0] = 2 ** 31 // D                       # the first row past 2^31
    ids[0, 1] = V - 1
    got = tsq.embedding_bag(ids, table)
    want = tref.embedding_bag_ref(ids, table)
    exact = (table[ids.clamp_min(0).long()].double()
             * (ids >= 0)[..., None]).sum(1)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(got.double(), exact) and bool(got.any())


def _blocked_bags(card, dtype, n_bags, seed):
    """Bags of one over a table larger than the L2: 1M x 64 float32 or 1M x
    128 bfloat16 (256 MB), integer values, every fourth row all -0.0, row 0
    NaN and +-inf; ids with -1 padding (a tenth) and ids at or past V."""
    V, D = 1_000_000, 64 if dtype == torch.float32 else 128
    g = torch.Generator(device=card).manual_seed(seed)
    table = torch.randint(-4, 5, (V, D), generator=g, device=card).to(dtype)
    table[::4] = -0.0
    table[0] = float("nan")
    table[0, ::3] = float("inf")
    table[0, 1::3] = -float("inf")
    ids = torch.randint(0, V, (n_bags, 1), generator=g, device=card,
                        dtype=torch.int32)
    ids[::10] = -1
    ids[5::97, 0] = V + torch.arange(ids[5::97].shape[0], device=card,
                                     dtype=torch.int32)
    ids[7] = 2 ** 31 - 1
    return ids, table


def _same_or_both_nan(got, want):
    """NaN where the plain version has NaN (the NaN's bits may differ: the
    kernel rounds a bfloat16 NaN to 0x7fff, PyTorch to 0x7fc0), bit-equal
    everywhere else."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(_bits(got)[~nan], _bits(want)[~nan]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_bags,kernel,order", [
    (4_000_000, "bag of one", "blocked"), (600_000, "bag of one", "direct"),
    (5_000, "per chunk", "direct")])
def test_cuda_embedding_bag_bags_of_one_both_orders(card, dtype, n_bags,
                                                    kernel, order):
    # -0.0 rows give +0.0, padded bags 0 * row0 (NaN for row 0's NaN and
    # infs), ids past the table row V - 1, in either order of the walk, and
    # on the per-chunk kernel that takes bags too few for a block an SM
    ids, table = _blocked_bags(card, dtype, n_bags, 70)
    path = tsq.bag_path(ids, table)
    assert (path["path"], path["order"]) == (kernel, order)
    tsq.reset_launch_counts()
    got = tsq.embedding_bag(ids, table)
    want = tref.embedding_bag_ref(ids, table)
    torch.cuda.synchronize()
    assert tsq.embedding_bag.launches == 1
    assert _same_or_both_nan(got, want)
    zero = (ids[:, 0] > 0) & (ids[:, 0] % 4 == 0) & (ids[:, 0] < 1_000_000)
    assert int(zero.sum()) > 0 and not bool(_bits(got[zero]).any())
    assert bool(torch.isnan(got[ids[:, 0] < 0]).all())


def test_cuda_embedding_bag_blocked_order_matches_plain(card):
    # the blocked order at a size that takes it: 1M x 64 float32, 4M bags of
    # one with -1 padding and ids >= V, the table free of NaN, bit-equal;
    # its list a permutation of the bags grouped by range in range order
    ids, table = _blocked_bags(card, torch.float32, 4_000_000, 71)
    table[0] = 3.0
    path = tsq.bag_path(ids, table)
    assert path["order"] == "blocked" and 1 < path["n_ranges"] <= 1024
    got = tsq.embedding_bag(ids, table)
    want = tref.embedding_bag_ref(ids, table)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    pairs, counts = tsq.bag_range_list(ids, table.shape[0],
                                       path["rows_per_range"],
                                       path["n_ranges"])
    keys = tref.bag_range_keys(ids[:, 0], table.shape[0],
                               path["rows_per_range"])
    sorted_keys, _ = torch.sort(keys, stable=True)
    bags = pairs[:, 0].long()
    assert torch.equal(torch.sort(bags).values,
                       torch.arange(ids.shape[0], device=card))
    assert torch.equal(pairs[:, 1], ids[bags, 0])
    assert torch.equal(keys[bags], sorted_keys)
    assert torch.equal(counts.long(),
                       torch.bincount(keys, minlength=path["n_ranges"]))


@pytest.mark.parametrize("dtype,D", [(torch.float32, 1), (torch.float32, 3),
                                     (torch.bfloat16, 1), (torch.bfloat16, 7)])
def test_cuda_embedding_bag_staged_wide_bag(card, dtype, D):
    # the wide model's bag of 40 ids over rows narrower than 16 bytes takes
    # the staged path, a warp of bags a block; a ragged last block, -1
    # padding, ids past V and an all-padding bag
    ids, table = _lattice_bags(72 + D, 20_001, 40, D, 100_000, dtype)
    ids[3, 5:9] = torch.tensor([100_000, 2 ** 31 - 1, 99_999, -5])
    ids, table = ids.to(card), table.to(card)
    path = tsq.bag_path(ids, table)
    assert path["path"] == "staged"
    got = tsq.embedding_bag(ids, table)
    want = tref.embedding_bag_ref(ids, table)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want)) and not bool(got[1].any())


@pytest.mark.parametrize("arch,lookups", [("dlrm-mlperf", 1),
                                          ("wide-deep", 2), ("mind", 1)])
def test_cuda_serve_steps_equal_the_cpu(card, arch, lookups):
    sd = tsteps.build_step(arch, "serve_p99", reduced=True)
    model, batch = sd.init_args(device="cpu")
    want = sd.fn(model, batch)
    model = model.to(card)
    batch = {k: v.to(card) for k, v in batch.items()}
    tsq.reset_launch_counts()
    got = sd.fn(model, batch)
    torch.cuda.synchronize()
    assert tsq.embedding_bag.launches == lookups
    # float32 GEMMs in another order than the CPU's: 2^-16 of the scale
    tol = 2.0 ** -16 * float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= tol


# --------------------------------------------------------------------------- #
# recsys training and the ranking retrieval                                    #
# --------------------------------------------------------------------------- #
def _to_card(model, opt_state, batch, card):
    return (model.to(card), tree_map(lambda t: t.to(card), opt_state),
            {k: v.to(card) for k, v in batch.items()})


@pytest.mark.parametrize("arch,lookups", [("dlrm-mlperf", 1),
                                          ("wide-deep", 2), ("mind", 1)])
def test_cuda_train_steps_equal_the_cpu(card, arch, lookups):
    # three steps from the same state on the CPU (the plain lookups) and on
    # the card (the kernel): losses within 2^-16; float32 leaves within
    # 2^-16 of the leaf's scale plus 2^-12 of AdamW's lr a step (where a
    # gradient element is near eps, its rounding moves the update); the
    # bfloat16 table (row-wise SGD) within one bfloat16 ulp (2^-7 of the
    # value) a row whose float32 gradient sum rounds the other way
    sd = tsteps.build_step(arch, "train_batch", reduced=True)
    model, opt_state, batch = sd.init_args(device="cpu")
    card_args = _to_card(*sd.init_args(device="cpu"), card)
    for _ in range(3):
        want = float(sd.fn(model, opt_state, batch)["loss"])
        tsq.reset_launch_counts()
        got = float(sd.fn(*card_args)["loss"])
        assert tsq.embedding_bag.launches == lookups
        assert abs(got - want) <= 2.0 ** -16 * abs(want)
    for a, b in zip(tree_leaves(model.tree()),
                    tree_leaves(card_args[0].tree())):
        err = (a.float() - b.cpu().float()).abs()
        if a.dtype == torch.bfloat16:
            assert bool((err <= 2.0 ** -7 * a.float().abs()).all())
        else:
            tol = 2.0 ** -16 * float(a.abs().max()) + 3 * 2.0 ** -12 * 1e-3
            assert float(err.max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_row_grad_equals_the_cpu(card, dtype):
    # 200,000 bags of one over 50 rows (4,000 a row) and bags of 7 with -1
    # padding: the card's sort and segment sum give the CPU's rows, and the
    # same bits on every call
    g = torch.Generator().manual_seed(3)
    for shape in ((200_000, 1), (30_000, 7)):
        ids = torch.randint(-1, 50, shape, generator=g, dtype=torch.int32)
        cot = torch.randn(shape[0], 64, generator=g).to(dtype)
        want = trs.row_grad(ids, cot, 50)
        got = trs.row_grad(ids.to(card), cot.to(card), 50)
        again = trs.row_grad(ids.to(card), cot.to(card), 50)
        assert torch.equal(got.indices().cpu(), want.indices())
        assert torch.equal(got.values(), again.values())
        scale = float(want.values().float().abs().max())
        u = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
        err = float((got.values().cpu().float()
                     - want.values().float()).abs().max())
        assert err <= 2 * u * scale + shape[0] * 2.0 ** -24 * scale


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "wide-deep"])
def test_cuda_ranking_retrieval_equals_the_cpu(card, arch):
    # bfloat16 scores within 2^-6 of the largest; the top-100 ids equal the
    # CPU's except between candidates whose CPU scores are that close
    sd = tsteps.build_step(arch, "retrieval_cand", reduced=True)
    model, q = sd.init_args(device="cpu")
    want_vals, want_idx = sd.fn(model, q)
    model = model.to(card)
    tsq.reset_launch_counts()
    got_vals, got_idx = sd.fn(model, {k: v.to(card) for k, v in q.items()})
    torch.cuda.synchronize()
    assert tsq.embedding_bag.launches == (1 if arch == "dlrm-mlperf" else 2)
    with torch.inference_mode():
        cpu_scores = trs.rank_candidates(model.cpu(), q["dense"], q["sparse"],
                                         q["cand_ids"])
    tol = 2.0 ** -6 * float(cpu_scores.abs().max())
    assert float((got_vals.cpu() - want_vals).abs().max()) <= tol
    differ = got_idx.cpu() != want_idx
    if differ.any():
        gap = (cpu_scores[got_idx.cpu()[differ]]
               - cpu_scores[want_idx[differ]]).abs().max()
        assert float(gap) <= tol


def test_cuda_top_k_follows_the_cpu_on_ties(card):
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 4, (5, 100_000), generator=g).float()
    x[1] = 2.0
    x[2, ::2] = -0.0
    x[2, 1::2] = 0.0
    for k in (1, 100, 1000):
        for largest in (True, False):
            cv, ci = utils.top_k(x, k, largest=largest)
            gv, gi = utils.top_k(x.to(card), k, largest=largest)
            assert torch.equal(gi.cpu(), ci)
            assert torch.equal(gv.cpu().view(torch.int32),
                               cv.view(torch.int32))


def test_cuda_trainer_runs_on_the_card(card):
    model = ttrain.main(["--arch", "wide-deep", "--reduced", "--steps", "3"])
    assert model.emb.is_cuda


def test_cuda_checkpoint_of_a_bfloat16_table_takes_no_room_on_the_card(
        card, tmp_path):
    """Saving a bfloat16 table and restoring it in place (the trainer's
    ``--resume``) allocate nothing of its size on the card: no float32
    copy and no second copy, which a table filling more than half of the
    card (DLRM's 48.07 GB) has no room for."""
    from repro_torch.ft import CheckpointManager

    def table():
        gen = torch.Generator(device=card).manual_seed(3)
        return torch.randn((1 << 22, 128), generator=gen, device=card,
                           dtype=torch.bfloat16)       # 1 GiB

    t = table()
    nbytes = t.numel() * t.element_size()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(0, {"table": t})
    t.zero_()
    back, step, _ = cm.restore({"table": t})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert step == 0 and back["table"] is t
    assert peak - base < nbytes // 8
    assert torch.equal(t.view(torch.int16), table().view(torch.int16))


# --------------------------------------------------------------------------- #
# LM and BERT4Rec serving                                                      #
# --------------------------------------------------------------------------- #
LM_CELLS = [("nemotron-4-15b", "prefill_32k"), ("internlm2-20b", "decode_32k"),
            ("minicpm3-4b", "prefill_32k"), ("minicpm3-4b", "decode_32k"),
            ("llama4-scout-17b-a16e", "long_500k"),
            ("qwen3-moe-235b-a22b", "prefill_32k"),
            ("qwen3-moe-235b-a22b", "decode_32k"),
            ("bert4rec", "retrieval_cand")]


def _bf16_ulp(magnitude: float) -> float:
    """One bfloat16 ulp at ``magnitude``: 2^(e - 7) in [2^e, 2^(e + 1))."""
    return 2.0 ** (np.floor(np.log2(max(magnitude, 2.0 ** -126))) - 7)


def _close_to_cpu(got, want):
    """float32 within 2^-16 of the largest magnitude (TF32 off), bfloat16
    (the caches) within one ulp at it, integers equal."""
    got = got.cpu()
    if not got.is_floating_point():
        assert torch.equal(got, want)
        return
    top = float(want.float().abs().max())
    tol = 2.0 ** -16 * top if got.dtype == torch.float32 else _bf16_ulp(top)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("arch,shape", LM_CELLS)
def test_cuda_lm_steps_equal_the_cpu(card, arch, shape):
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sd = tsteps.build_step(arch, shape, reduced=True)
        args = sd.init_args()
        host = tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor)
                        else t, list(args))
        got, want = sd.fn(*args), sd.fn(*host)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        _close_to_cpu(g, w)
    if "decode" in sd.name:
        assert got[1] is args[1]                  # the cache, in place


def test_cuda_attention_pieces_and_tied_routers(card, monkeypatch):
    """The score pieces of `attention._attend` (heads by KV group, then
    query rows) agree with one whole call on the card to a bfloat16 ulp
    (cuBLAS may order a row's sums by its shapes); a zero router's tied
    probabilities take the lowest experts on the card as on the CPU."""
    from repro_torch.models import attention as ta
    from repro_torch.models import moe as tm

    gen = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn(s, generator=gen, device=card,
                           dtype=torch.bfloat16)
               for s in ((2, 256, 12, 64), (2, 256, 4, 64), (2, 256, 4, 64)))
    scale = ta.softmax_scale(64, torch.bfloat16)
    whole = ta.full_attention(q, k, v, causal=True, scale=scale, chunk_q=128)
    monkeypatch.setattr(ta, "SCORE_BYTES", 2 * 256 * 4 * 3 * 37)
    pieces = ta.full_attention(q, k, v, causal=True, scale=scale, chunk_q=128)
    assert float((pieces.float() - whole.float()).abs().max()) <= \
        _bf16_ulp(float(whole.float().abs().max()))
    cfg = tm.MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32)
    p = tm.moe_params(cfg, generator=gen, device=card)
    p["router"].zero_()
    x = torch.randn((96, 64), generator=gen, device=card)
    y, aux = tm.moe_apply(p, x, cfg)
    hp = tree_map(lambda t: t.cpu(), p)
    y_cpu, aux_cpu = tm.moe_apply(hp, x.cpu(), cfg)
    _close_to_cpu(y, y_cpu)
    # the mean over 32 groups, summed in another order
    assert abs(float(aux["dropped_frac"]) - float(aux_cpu["dropped_frac"])
               ) <= 2.0 ** -20 and float(aux_cpu["dropped_frac"]) > 0


def test_cuda_lm_parameters_are_held_in_the_compute_dtype(card):
    sd = tsteps.build_step("llama4-scout-17b-a16e", "decode_32k",
                           reduced=True,
                           cfg_override={"dtype": torch.bfloat16})
    params, cache, toks, pos = sd.init_args()
    assert {(t.dtype, t.device.type) for t in tree_leaves(params)} == {
        (torch.bfloat16, "cuda")}
    f32 = tree_map(lambda t: t.float(), params)
    c2 = tree_map(torch.clone, cache)
    a, _ = sd.fn(params, cache, toks, pos)
    b, _ = sd.fn(f32, c2, toks, pos)
    assert torch.equal(a, b)
    assert all(torch.equal(cache[n], c2[n]) for n in cache)


# --------------------------------------------------------------------------- #
# Training: the LMs, BERT4Rec and the GAT                                      #
# --------------------------------------------------------------------------- #
TRAIN_CELLS = ([(a, "train_4k", 3e-4) for a in (
    "nemotron-4-15b", "internlm2-20b", "minicpm3-4b", "llama4-scout-17b-a16e",
    "qwen3-moe-235b-a22b")]
               + [("bert4rec", "train_batch", 1e-3)]
               + [("gat-cora", s, 5e-3) for s in ("full_graph_sm",
                                                  "minibatch_lg",
                                                  "ogb_products",
                                                  "molecule")])


def _trained_close(got_tree, want_tree, lr: float, steps: int):
    """The card's parameters against the CPU's after ``steps`` AdamW (or
    SGD) steps: at least 999 in 1,000 elements within 2^-16 of the leaf's
    largest magnitude plus 2^-12 of lr a step, every element within 2 lr a
    step (AdamW's update ``m / (sqrt(v) + eps)`` amplifies the rounding of
    a gradient whose moments are small; a near-tied MoE router or a ReLU
    kink takes the other branch)."""
    far = total = 0
    for a, b in zip(tree_leaves(want_tree), tree_leaves(got_tree)):
        err = (a.float() - b.cpu().float()).abs()
        assert float(err.max()) <= 2 * lr * steps
        tol = 2.0 ** -16 * float(a.abs().max()) + 2.0 ** -12 * lr * steps
        far += int((err > tol).sum())
        total += err.numel()
    assert far * 1000 <= total, (far, total)


@pytest.mark.parametrize("arch,shape,lr", TRAIN_CELLS)
def test_cuda_train_steps_of_lms_bert4rec_and_gat_equal_the_cpu(card, arch,
                                                               shape, lr):
    """Three training steps from the same state on the CPU and on the card
    (TF32 off): each loss within 2^-16, then the parameters."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sd = tsteps.build_step(arch, shape, reduced=True)
        params, state, batch = sd.init_args()
        host = tree_map(lambda t: t.cpu().clone(), [params, state, batch])
        for _ in range(3):
            got = float(sd.fn(params, state, batch)["loss"])
            want = float(sd.fn(*host)["loss"])
            assert abs(got - want) <= 2.0 ** -16 * abs(want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert {t.device.type for t in tree_leaves(params)} == {"cuda"}
    _trained_close(params, host[0], lr, 3)


def test_cuda_in_place_adamw_is_bit_equal_to_the_functional(card,
                                                            monkeypatch):
    """On the card too: clip_by_global_norm_ and adamw's update_, large
    leaves in pieces, against the functional forms, bit for bit."""
    from repro_torch.optim import optimizers as topt

    monkeypatch.setattr(topt, "PIECE", 4096)
    gen = torch.Generator(device=card).manual_seed(2)
    p_fun = {"a": torch.randn((3, 2, 5000), generator=gen, device=card),
             "b": [torch.randn((7,), generator=gen, device=card)]}
    p_in = tree_map(torch.clone, p_fun)
    opt = topt.adamw(lr=3e-4, weight_decay=0.1)
    s_fun, s_in = opt.init(p_fun), opt.init(p_in)
    for _ in range(3):
        g = tree_map(lambda t: 5 * torch.randn(t.shape, generator=gen,
                                               device=card), p_fun)
        clipped, gn = topt.clip_by_global_norm(g, 1.0)
        upd, s_fun = opt.update(clipped, s_fun, p_fun)
        topt.apply_updates(p_fun, upd)
        assert torch.equal(topt.clip_by_global_norm_(g, 1.0), gn)
        opt.update_(g, s_in, p_in)
    for a, b in zip(tree_leaves((p_fun, s_fun)), tree_leaves((p_in, s_in))):
        assert torch.equal(a, b)


def test_cuda_gat_scatter_sum_and_tied_max_equal_the_cpu(card):
    """edge_aggregate and segment_max (ties at a segment's max, an empty
    segment) and their gradients on the card against the CPU: the scatter
    sums' atomics add in another order (float32 within 2^-20 of the
    largest magnitude); the tied gradient split exactly."""
    from repro_torch.models import gnn as tg

    gen = torch.Generator().manual_seed(3)
    alpha = torch.rand((300, 4), generator=gen)
    h = torch.randn((40, 4, 8), generator=gen)
    src = torch.randint(0, 40, (300,), generator=gen)
    dst = torch.randint(1, 40, (300,), generator=gen)
    e = torch.randint(0, 3, (300, 4), generator=gen).float()  # many ties
    g = torch.randn((40, 4, 8), generator=gen)
    out = []
    for dev in ("cpu", card):
        a = alpha.to(dev, copy=True).requires_grad_()
        hh = h.to(dev, copy=True).requires_grad_()
        ee = e.to(dev, copy=True).requires_grad_()
        y = tg.edge_aggregate(a, hh, src.to(dev), dst.to(dev), 40)
        m = tg.segment_max(ee, dst.to(dev), 40)
        assert bool(torch.isinf(m[0]).all())
        (torch.sum(y * g.to(dev)) + torch.where(torch.isfinite(m), m, 0.0)
         .sum()).backward()
        out.append([t.detach().cpu() for t in (y, a.grad, hh.grad, m,
                                                ee.grad)])
    for got, want in zip(out[1][:3], out[0][:3]):
        assert float((got - want).abs().max()) <= 2.0 ** -20 * max(
            1.0, float(want.abs().max()))
    assert torch.equal(out[1][3], out[0][3])          # a max is exact
    assert torch.equal(out[1][4], out[0][4])


# --------------------------------------------------------------------------- #
# The engine's host lane and the candidate-compacted op on the card            #
# --------------------------------------------------------------------------- #
def test_oracle_on_a_card_pack_raises(card):
    rng = np.random.default_rng(2)
    idx = tsnn.build_index(rng.normal(size=(500, 6)).astype(np.float32))
    q = rng.normal(size=(8, 6)).astype(np.float32)
    with pytest.raises(ValueError, match="oracle=True"):
        tsnn.query_radius_csr(idx, q, 1.0, oracle=True)
    with pytest.raises(ValueError, match="oracle=True"):
        tjoin.query_counts(idx, q, 1.0, oracle=True)
    # the default route stays the card's stacked kernels; the host lane
    # takes the same index through a plan on the CPU
    want = tsnn.query_radius_csr(idx, q, 1.0)
    got = tsnn.query_radius_csr(idx, q, 1.0, device="cpu", oracle=True)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)


def _compacted_lattice(seed: int, S: int = 3, n: int = 200,
                       n_pad: int = 256, m: int = 64, d: int = 8):
    """A (S, n_pad, d) stack of integer lattice rows, sorted by alpha =
    coordinate 0 in each segment (+BIG padding rows), the extra
    projections coordinates 1 and 2, and m lattice queries with integer
    squared radii: every product and threshold exact in float32."""
    rng = np.random.default_rng(seed)
    big = np.float32(tref.BIG)
    xs = np.zeros((S, n_pad, d), np.float32)
    al = np.full((S, n_pad), big, np.float32)
    hn = np.full((S, n_pad), big, np.float32)
    px = np.full((S, 2, n_pad), big, np.float32)
    for k in range(S):
        x = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
        x = x[np.argsort(x[:, 0], kind="stable")]
        xs[k, :n], al[k, :n] = x, x[:, 0]
        hn[k, :n] = 0.5 * (x * x).sum(1)
        px[k, :, :n] = x[:, 1:3].T
    q = rng.integers(-4, 5, size=(m, d)).astype(np.float32)
    r = np.sqrt(rng.choice([16.0, 25.0, 36.0], size=m)).astype(np.float32)
    th = (0.5 * (r * r - (q * q).sum(1))).astype(np.float32)
    ops = (q, q[:, 0].copy(), r, th, xs, al, hn, q[:, 1:3].T.copy(), px)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in ops]


def test_compacted_stacked_on_the_card_equals_the_cpu(card):
    args = _compacted_lattice(9)
    total = int(tref.snn_count_stacked_ref(*args, bn=128).sum())
    for cc, nc in ((1024, 8192), (8, 8192), (1024, 64)):
        # (8: the candidate overflow; 64: the flat overflow)
        cpu = tops.snn_csr_compacted_stacked(*args, ptile=16, ccap=cc,
                                             nnz_cap=nc)
        on_card = tops.snn_csr_compacted_stacked(
            *[a.to(card) for a in args], ptile=16, ccap=cc, nnz_cap=nc)
        assert on_card[1].device.type == "cuda"
        for c, g in zip(cpu, on_card):
            np.testing.assert_array_equal(g.cpu().numpy(), c.numpy())
        assert (int(cpu[3]) == total) == (int(cpu[4]) <= cc)


def test_cuda_lm_serving_on_a_one_rank_mesh_is_bit_equal(card, tmp_path):
    """The sharded prefill and decode steps (the reduced LMs, llama4's
    ``long_500k`` too) on a (1, 1) NCCL mesh equal the unsharded steps on
    the card bit for bit: logits and caches."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mesh = tmesh.make_host_mesh()
        for arch, shape in (("internlm2-20b", "decode_32k"),
                            ("minicpm3-4b", "decode_32k"),
                            ("qwen3-moe-235b-a22b", "decode_32k"),
                            ("llama4-scout-17b-a16e", "long_500k")):
            for cell in ("prefill_32k", shape):
                sd = tsteps.build_step(arch, cell, reduced=True, mesh=mesh)
                plain = tsteps.build_step(arch, cell, reduced=True)
                got = sd.fn(*sd.init_args())
                want = plain.fn(*plain.init_args())
                assert got[0].is_cuda
                for g, w in zip(tree_leaves(got), tree_leaves(want)):
                    assert torch.equal(g, w), (arch, cell)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        dist.destroy_process_group()


def test_cuda_recsys_and_gat_on_a_one_rank_mesh_are_bit_equal(card,
                                                               tmp_path):
    """The sharded recsys and GAT steps (the reduced cells) on a (1, 1)
    NCCL mesh equal the unsharded steps on the card bit for bit, and a
    sharded lookup of a CUDA table launches the embedding_bag kernel (the
    ids localized to the table's row block, never a plain version)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = tmesh.make_host_mesh()
        for arch, shape in (("dlrm-mlperf", "train_batch"),
                            ("wide-deep", "retrieval_cand"),
                            ("mind", "serve_p99"),
                            ("bert4rec", "train_batch"),
                            ("gat-cora", "full_graph_sm"),
                            ("gat-cora", "molecule")):
            sd = tsteps.build_step(arch, shape, reduced=True, mesh=mesh)
            plain = tsteps.build_step(arch, shape, reduced=True)
            args, want_args = sd.init_args(), plain.init_args()
            tsq.reset_launch_counts()
            got = sd.fn(*args)
            launches = tsq.embedding_bag.launches
            want = plain.fn(*want_args)
            if arch in ("dlrm-mlperf", "wide-deep", "mind"):
                assert launches > 0, (arch, shape)
            trees = [(got, want)]
            if shape == "train_batch" or arch == "gat-cora":
                trees.append((args[0] if isinstance(args[0], dict)
                              else args[0].tree(),
                              want_args[0] if isinstance(want_args[0], dict)
                              else want_args[0].tree()))
            for a, b in trees:
                for g, w in zip(tree_leaves(a), tree_leaves(b)):
                    assert g.is_cuda and torch.equal(g, w), (arch, shape)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        dist.destroy_process_group()


def test_cuda_sequence_and_node_row_ops_on_a_one_rank_mesh(card, tmp_path):
    """The reference's sequence-parallel ``act_btd`` (the LMs' training and
    prefill steps) and the GAT's hidden node rows on a (1, 1) NCCL mesh:
    their gathers and scatters run (each a copy through NCCL) and the
    gradients and the prefill's logits and cache equal the unsharded
    steps' on the card bit for bit."""
    import torch.distributed as dist

    from repro_torch.distributed import parallel
    from repro_torch.launch import mesh as tmesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = tmesh.make_host_mesh()
        parallel.OP_COUNTS.clear()
        for arch, shape in (("minicpm3-4b", "train_4k"),
                            ("qwen3-moe-235b-a22b", "train_4k"),
                            ("nemotron-4-15b", "prefill_32k"),
                            ("gat-cora", "full_graph_sm")):
            sd = tsteps.build_step(arch, shape, reduced=True, mesh=mesh)
            plain = tsteps.build_step(arch, shape, reduced=True)
            args, want_args = sd.init_args(), plain.init_args()
            if shape == "prefill_32k":
                got, want = sd.fn(*args), plain.fn(*want_args)
            else:
                got = sd.grad_fn(args[0], args[-1])
                want = plain.grad_fn(want_args[0], want_args[-1])
            for g, w in zip(tree_leaves(got), tree_leaves(want)):
                assert g.is_cuda and torch.equal(g, w), (arch, shape)
        for op in ("gather_seq", "scatter_seq", "last_token", "to_edges",
                   "node_scatter"):
            assert parallel.OP_COUNTS[op] > 0, op
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        dist.destroy_process_group()
