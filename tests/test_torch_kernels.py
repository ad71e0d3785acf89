"""The port's kernel modules against the JAX reference (repro.kernels).

The same inputs, made from a numpy seed, go through the JAX package's plain
versions (and, on one small case, its Pallas TPU kernels in interpret mode)
and through the port's.  The inputs are integer lattices, on which every
product and every threshold is exact in float32, so the tolerance is zero:
counts and flat ids equal, dhalf bit-equal.

The CUDA kernels themselves run only on the card; ``test_torch_cuda.py``
holds them against their plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import embedding_bag as jbag
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import snn_query as jsq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import registry as treg
from repro_torch.kernels import snn_query as tsq


def _lattice_stack(seed, ke, S=2, n_pad=256, d=5, d_pad=128, m=27, m_pad=32):
    """A segment stack of lattice points (alpha = coordinate 0, the extra
    projections = coordinates 1..ke) and lattice queries, padded by the
    reference contract; returns float32 numpy operands."""
    rng = np.random.default_rng(seed)
    big = np.float32(jref.BIG)
    xs = np.zeros((S, n_pad, d_pad), np.float32)
    al = np.full((S, n_pad), big, np.float32)
    hn = np.full((S, n_pad), big, np.float32)
    px = np.full((S, ke, n_pad), big, np.float32)
    for s in range(S):
        n_s = n_pad - 40 * (s + 1)
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
    return q, aq, r, th, xs, al, hn, (pq if ke else None), (px if ke else None)


def _torch(arrs):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrs]


def _jax(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("ke", [0, 2])
@pytest.mark.parametrize("mixed", [False, True])
def test_plain_count_stacked_matches_reference(ke, mixed):
    ops = _lattice_stack(11 + ke, ke)
    want = np.asarray(jref.snn_count_stacked_ref(*_jax(ops), n_seg=2,
                                                 mixed=mixed))
    got, partials = tref.snn_count_stacked_ref(*_torch(ops), bn=128,
                                               mixed=mixed,
                                               with_partials=True)
    assert want.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)
    # the per-row-block partials sum to the counts
    np.testing.assert_array_equal(partials.sum(dim=2).numpy(), want)


@pytest.mark.parametrize("ke", [0, 2])
def test_plain_compact_stacked_and_prefix_match_reference(ke):
    ops = _lattice_stack(21 + ke, ke)
    q, aq, r, th, xs, al, hn, pq, px = ops
    per = jref.snn_count_stacked_ref(*_jax(ops), n_seg=2)
    counts_j, indptr_j, off_j = jref.stacked_prefix(per)
    counts_t, indptr_t, off_t = tref.stacked_prefix(
        torch.from_numpy(np.array(per)))
    for a, b in ((counts_j, counts_t), (indptr_j, indptr_t),
                 (off_j, off_t)):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    total = int(indptr_j[-1])
    nnz = tops.csr_capacity(total)
    assert nnz == jops.csr_capacity(total)
    wi, wd = jref.snn_compact_stacked_ref(
        *_jax((q, aq, r, th)), off_j, *_jax((xs, al, hn, pq, px)), n_seg=2,
        nnz=nnz)
    gi, gd = tref.snn_compact_stacked_ref(
        *_torch((q, aq, r, th)), off_t, *_torch((xs, al, hn, pq, px)),
        nnz=nnz)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy().view(np.int32),
                                  np.asarray(wd).view(np.int32))
    assert (gi.numpy()[total:] == -1).all()
    # the overflow guard writes nothing
    oi, od = tref.snn_compact_stacked_ref(
        *_torch((q, aq, r, th)), off_t, *_torch((xs, al, hn, pq, px)),
        nnz=total)
    assert (oi.numpy() == -1).all() and (od.numpy() == tref.BIG).all()


@pytest.mark.parametrize("mixed", [False, True])
def test_plain_versions_match_pallas_tpu_interpret(mixed):
    # the TPU kernels themselves, run by Pallas' interpreter, on one small
    # case with the box prune on
    ops = _lattice_stack(5, 2, n_pad=128, m=13, m_pad=16)
    q, aq, r, th, xs, al, hn, pq, px = ops
    per_k = np.asarray(jsq.snn_count_stacked(*_jax(ops), tq=16, bn=64,
                                             interpret=True, mixed=mixed))
    per_t = tref.snn_count_stacked_ref(*_torch(ops), bn=64, mixed=mixed)
    assert per_k.sum() > 0
    np.testing.assert_array_equal(per_t.numpy(), per_k)
    if mixed:
        return
    _, _, off = tref.stacked_prefix(per_t)
    nnz = tops.csr_capacity(int(per_t.sum()))
    ki, kd = jsq.snn_compact_stacked(
        *_jax((q, aq, r, th)), jnp.asarray(off.numpy()),
        *_jax((xs, al, hn, pq, px)), nnz=nnz, tq=16, bn=64, interpret=True)
    ti, td = tref.snn_compact_stacked_ref(
        *_torch((q, aq, r, th)), off, *_torch((xs, al, hn, pq, px)), nnz=nnz)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ki))
    np.testing.assert_array_equal(td.numpy().view(np.int32),
                                  np.asarray(kd).view(np.int32))


def test_formulas_match_reference():
    rng = np.random.default_rng(3)
    m, n = 9, 40
    r = rng.uniform(0.1, 2.0, m).astype(np.float32)
    r[-1] = -jref.BIG                       # a padding query overflows to inf
    th = rng.uniform(-2.0, 1.0, m).astype(np.float32)
    th[-1] = -jref.BIG
    hn = rng.uniform(0.0, 3.0, n).astype(np.float32)
    hn[-3:] = jref.BIG                      # padding rows
    pq = rng.normal(size=(2, m)).astype(np.float32)
    px = rng.normal(size=(2, n)).astype(np.float32)
    for a, b in zip(jref.norm_scales(*_jax((r, th, hn))),
                    tref.norm_scales(*_torch((r, th, hn)))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        tref.box_mask(*_torch((pq, px, r, th, hn))).numpy(),
        np.asarray(jref.box_mask(*_jax((pq, px, r, th, hn)))))
    assert (tref.BIG, tref.BOX_EPS, tref.MIX_EPS) == \
        (jref.BIG, jref.BOX_EPS, jref.MIX_EPS)


def test_padding_contract_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(700, 13)).astype(np.float32)
    al = np.sort(rng.normal(size=700)).astype(np.float32)
    hn = rng.uniform(size=700).astype(np.float32)
    want = jops.pad_database(x, al, hn, bn=512)
    got = tops.pad_database(*_torch((x, al, hn)), bn=512)
    for a, b in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert want[3:] == got[3:]
    q = rng.normal(size=(37, 13)).astype(np.float32)
    for bucket in (False, True):
        w = jops.pad_queries(q, q[:, 0], q[:, 1], q[:, 2], tq=32,
                             bucket=bucket)
        g = tops.pad_queries(q, q[:, 0], q[:, 1], q[:, 2], tq=32,
                             bucket=bucket)
        for a, b in zip(w[:4], g[:4]):
            np.testing.assert_array_equal(b, np.asarray(a))
        assert w[4] == g[4]
    p = rng.normal(size=(2, 37)).astype(np.float32)
    np.testing.assert_array_equal(tops.pad_components(p, 64, tops.BIG),
                                  np.asarray(jops.pad_components(p, 64,
                                                                 jops.BIG)))
    for m in (0, 1, 128, 129, 1000):
        assert tops.bucket_rows(m) == jops.bucket_rows(m)
    for t in (0, 1, 127, 128, 5000):
        assert tops.csr_capacity(t) == jops.csr_capacity(t)


@pytest.mark.parametrize("ke", [0, 2])
@pytest.mark.parametrize("bn", [128, 256])
def test_write_bases_place_each_row_block_at_its_first_survivor(ke, bn):
    """The compact kernel's write bases, built on the CPU from the count
    pass's partials: each (segment, query, row block) cell's slots, from its
    base on for its partial, hold that cell's survivors in the plain stacked
    compact, and the bases of consecutive blocks are partials apart."""
    q, aq, r, th, xs, al, hn, pq, px = _torch(_lattice_stack(21 + ke, ke))
    per, part = tref.snn_count_stacked_ref(q, aq, r, th, xs, al, hn, pq, px,
                                           bn=bn, with_partials=True)
    _, _, off = tref.stacked_prefix(per)
    bases = tsq.write_bases(off, part)
    S, m_pad, nb = part.shape
    assert bases.dtype == torch.int32 and tuple(bases.shape) == (S, m_pad, nb)
    assert torch.equal(bases[:, :, 0], off)
    assert torch.equal(bases[:, :, 1:] - bases[:, :, :-1], part[:, :, :-1])
    total = int(per.sum())
    idx, _ = tref.snn_compact_stacked_ref(q, aq, r, th, off, xs, al, hn, pq,
                                          px, nnz=tops.csr_capacity(total))
    n_pad = xs.shape[1]
    block = (idx[:total] % n_pad) // bn          # row block of every slot
    seg = idx[:total] // n_pad
    for s, k, b in torch.nonzero(part).tolist():
        lo = int(bases[s, k, b])
        hi = lo + int(part[s, k, b])
        assert bool((seg[lo:hi] == s).all()) and bool((block[lo:hi] == b)
                                                      .all())
    # the single-segment form: offsets (m_pad,), partials (m_pad, nb)
    assert torch.equal(tsq.write_bases(off[1], part[1]), bases[1])


def test_registry_sends_cpu_tensors_to_plain_versions():
    ops = _torch(_lattice_stack(9, 2))
    tsq.reset_launch_counts()
    treg.reset_compile_counts()
    per = treg.snn_count_stacked(*ops, bn=128)
    again = treg.snn_count_stacked(*ops, bn=128)
    np.testing.assert_array_equal(
        per.numpy(), tref.snn_count_stacked_ref(*ops, bn=128).numpy())
    assert torch.equal(per, again)
    # no kernel launched for CPU tensors; one signature for two calls
    assert tsq.snn_count_stacked.launches == 0
    assert treg.compile_counts() == {"snn_count_stacked": 1}


def test_kernel_wrappers_refuse_cpu_tensors():
    ops = _torch(_lattice_stack(9, 0))
    q, aq, r, th, xs, al, hn, pq, px = ops
    tsq.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsq.snn_count_stacked(*ops, bn=128)
    off = torch.zeros((2, q.shape[0]), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsq.snn_compact_stacked(q, aq, r, th, off, xs, al, hn, nnz=128,
                                bn=128)
    assert tsq.snn_count_stacked.launches == 0
    assert tsq.snn_compact_stacked.launches == 0


# --------------------------------------------------------------------------- #
# the single-segment kernels: snn_filter, snn_count, snn_compact               #
# --------------------------------------------------------------------------- #
def _lattice_segment(seed, ke, n_pad=1024, d=128, m=100, m_pad=128,
                     spread=False):
    """One segment of sparse ternary lattice points in d = 128 (alpha =
    coordinate 0, shifted so windows prune blocks; the extra projections =
    coordinates 1..ke) and lattice queries: every product and threshold is
    exact in float32.  With ``spread`` the query alphas are drawn over -4..16,
    past both ends of the rows' -1..12, in no order."""
    rng = np.random.default_rng(seed)
    big = np.float32(jref.BIG)
    n = n_pad - 90

    def points(k):
        p = rng.integers(-1, 2, size=(k, d)) * (rng.random((k, d)) < 0.06)
        p = p.astype(np.float32)
        p[:, 0] += rng.integers(0, 12, size=k)
        return p

    pts = points(n)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    xs = np.zeros((n_pad, d), np.float32)
    xs[:n] = pts
    al = np.full(n_pad, big, np.float32)
    al[:n] = pts[:, 0]
    hn = np.full(n_pad, big, np.float32)
    hn[:n] = 0.5 * np.sum(pts * pts, axis=1)
    px = np.full((ke, n_pad), big, np.float32)
    px[:, :n] = pts[:, 1:1 + ke].T
    qi = points(m)
    if spread:
        qi[:, 0] = rng.integers(-4, 17, size=m)
    r = rng.choice([2.0, 2.5, 3.0, 3.5], size=m).astype(np.float32)
    th = ((r * r - np.sum(qi * qi, axis=1)) / 2.0).astype(np.float32)
    q, aq, r, th, _ = tops.pad_queries(qi, qi[:, 0], r, th, tq=m_pad)
    pq = tops.pad_components(qi[:, 1:1 + ke].T, m_pad)
    return q, aq, r, th, xs, al, hn, (pq if ke else None), (px if ke else None)


@pytest.mark.parametrize("ke,spread", [(0, False), (2, False), (0, True),
                                       (2, True)],
                         ids=["0", "2", "spread-0", "spread-2"])
def test_plain_filter_matches_pallas_tpu_interpret(ke, spread):
    # spread: 230 real queries of 256 over two query tiles, their alphas in
    # no order and past the rows' range, so some windows meet no row block
    shape = dict(m=230, m_pad=256, spread=True) if spread else {}
    ops = _lattice_segment(41 + ke, ke, **shape)
    want = np.asarray(jsq.snn_filter(*_jax(ops), tq=128, bn=512,
                                     interpret=True))
    got = tref.snn_filter_ref(*_torch(ops)).numpy()
    finite = want < jref.BIG
    assert 0 < finite.sum() < finite.size
    if spread:
        aq = ops[1][:230]
        assert np.any(np.diff(aq) < 0) and aq.min() < -1 and aq.max() > 12
        assert not finite[np.argmax(aq)].any()   # alpha 16, r <= 3.5
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("ke", [0, 2])
@pytest.mark.parametrize("mixed", [False, True])
def test_plain_count_matches_pallas_tpu_interpret(ke, mixed):
    ops = _lattice_segment(51 + ke, ke)
    want = np.asarray(jsq.snn_count(*_jax(ops), tq=128, bn=512,
                                    interpret=True, mixed=mixed))
    got, partials = tref.snn_count_ref(*_torch(ops), bn=512, mixed=mixed,
                                       with_partials=True)
    assert want.sum() > 0 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(partials.shape) == (128, 2)
    np.testing.assert_array_equal(partials.sum(dim=1).numpy(), want)


@pytest.mark.parametrize("ke", [0, 2])
def test_plain_compact_matches_pallas_tpu_interpret(ke):
    ops = _lattice_segment(61 + ke, ke)
    q, aq, r, th, xs, al, hn, pq, px = ops
    counts = tref.snn_count_ref(*_torch(ops)).numpy().astype(np.int64)
    total = int(counts.sum())
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    nnz = tops.csr_capacity(total)
    ki, kd = jsq.snn_compact(*_jax((q, aq, r, th, offsets)),
                             *_jax((xs, al, hn, pq, px)), nnz=nnz, tq=128,
                             bn=512, interpret=True)
    ti, td = tref.snn_compact_ref(*_torch((q, aq, r, th, offsets)),
                                  *_torch((xs, al, hn, pq, px)), nnz=nnz)
    assert total > 0 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ki))
    np.testing.assert_array_equal(td.numpy().view(np.int32),
                                  np.asarray(kd).view(np.int32))
    # -1 / +BIG in every unwritten slot and the trash slot; data all written
    assert (ti.numpy()[total:] == -1).all()
    assert (td.numpy()[total:] == tref.BIG).all()
    assert (ti.numpy()[:total] >= 0).all()


def test_single_segment_ops_dispatch_to_plain_versions():
    ops = _torch(_lattice_segment(71, 2))
    q, aq, r, th, xs, al, hn, pq, px = ops
    tsq.reset_launch_counts()
    treg.reset_compile_counts()
    dh = tops.snn_filter(*ops)
    counts = tops.snn_count(*ops)
    np.testing.assert_array_equal(counts.numpy(),
                                  (dh < tref.BIG).sum(dim=1).numpy())
    off = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    nnz = tops.csr_capacity(int(counts.sum()))
    idx, dhc = tops.snn_compact(q, aq, r, th, off, xs, al, hn, pq, px,
                                nnz=nnz)
    rows, cols = torch.nonzero(dh < tref.BIG, as_tuple=True)
    np.testing.assert_array_equal(idx[:rows.numel()].numpy(), cols.numpy())
    np.testing.assert_array_equal(dhc[:rows.numel()].numpy(),
                                  dh[rows, cols].numpy())
    # the stacked filter is the single one over the flattened stack, its
    # columns pack-flat: cut the segment into a stack of two and compare
    px2 = px.reshape(2, 2, 512).permute(1, 0, 2).contiguous()
    st = treg.snn_filter_stacked(q, aq, r, th, xs.reshape(2, 512, -1),
                                 al.reshape(2, 512), hn.reshape(2, 512), pq,
                                 px2, bn=512)
    assert torch.equal(st, dh)
    assert all(fn.launches == 0 for fn in tsq.KERNELS)
    assert set(treg.compile_counts()) >= {"snn_filter", "snn_count",
                                          "snn_compact"}


def test_single_segment_wrappers_refuse_cpu_tensors():
    ops = _torch(_lattice_segment(72, 0))
    q, aq, r, th, xs, al, hn, _, _ = ops
    off = torch.zeros(q.shape[0], dtype=torch.int32)
    for call in (lambda: tsq.snn_filter(*ops),
                 lambda: tsq.snn_count(*ops),
                 lambda: tsq.snn_compact(q, aq, r, th, off, xs, al, hn,
                                         nnz=128)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert all(fn.launches == 0 for fn in tsq.KERNELS)


# --------------------------------------------------------------------------- #
# embedding_bag                                                                #
# --------------------------------------------------------------------------- #
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bag_operands(seed, B, F, D, V=300, dtype="float32"):
    """(B, F) ids with -1 padding (about a fifth, and bag 1 all padding) and
    a (V, D) normal table in ``dtype``, as (jax ids, jax table, torch ids,
    torch table) with the same bits on both sides."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, F)).astype(np.int32)
    ids[rng.random((B, F)) < 0.2] = -1
    ids[1, :] = -1
    jdt, tdt = DTYPES[dtype]
    jt = jnp.asarray(rng.normal(size=(V, D)).astype(np.float32)).astype(jdt)
    tt = torch.from_numpy(np.array(_bits(jt))).view(tdt)
    return jnp.asarray(ids), jt, torch.from_numpy(ids), tt


def _bits(a):
    """The raw bits of a float32 or bfloat16 array or tensor, as numpy."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16 if a.element_size() == 2
                      else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1, 128])
@pytest.mark.parametrize("F", [1, 40])
def test_embedding_bag_matches_pallas_tpu_interpret(dtype, D, F):
    # the plain version (what ops.embedding_bag runs on a CPU tensor) is the
    # Pallas kernel's arithmetic: slot order, rounded after each add
    jids, jt, tids, tt = _bag_operands(10 + D + F, 6, F, D, dtype=dtype)
    want = jbag.embedding_bag(jids, jt, interpret=True)
    got = tops.embedding_bag(tids, tt)
    assert got.dtype == tt.dtype and tuple(got.shape) == (6, D)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not got[1].any()                          # the all-padding bag


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_mean_matches_reference_ops(dtype):
    jids, jt, tids, tt = _bag_operands(21, 9, 7, 16, dtype=dtype)
    want = jops.embedding_bag(jids, jt, mode="mean", use_pallas=True)
    got = tops.embedding_bag(tids, tt, mode="mean")
    np.testing.assert_array_equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="unknown mode"):
        tops.embedding_bag(tids, tt, mode="max")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_plain_version_against_xla_reference(dtype):
    """What the JAX package's XLA oracle (``ref.embedding_bag_ref``, a
    gather and a reduce) gives beside the kernel's arithmetic.  Bags of one
    are the gathered row in both (0 + 1 * row): bit-equal.  For bags of 40
    the two sum in different orders: on this input XLA's float32 sum
    differs from the slot-order sum in the last bits, and in bfloat16 it
    rounds once where the kernel rounds after every add, so the two differ
    by bfloat16 rounding steps; both stay within the recursive-summation
    bound F * u * sum |row| (u = 2^-24, or 2^-8 for bfloat16)."""
    for F, seed in ((1, 31), (40, 32)):
        jids, jt, tids, tt = _bag_operands(seed, 16, F, 64, dtype=dtype)
        xla = np.asarray(jref.embedding_bag_ref(jids, jt).astype(jnp.float32))
        got = tops.embedding_bag(tids, tt).float().numpy()
        if F == 1:
            np.testing.assert_array_equal(got, xla)
            continue
        assert not np.array_equal(got, xla)
        rows = np.abs(tt.float().numpy())[np.maximum(tids.numpy(), 0)]
        absum = (rows * (tids.numpy() >= 0)[..., None]).sum(1)
        u = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -24
        assert np.all(np.abs(got - xla) <= F * u * absum)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_ids_past_the_table_read_its_last_row(dtype):
    """Ids at or above V: the Pallas kernel off the TPU clamps its block
    index into the table and reads row V - 1; the port does the same on the
    CPU (and the CUDA kernel on the card), bit for bit."""
    jids, jt, tids, tt = _bag_operands(43, 6, 5, 8, V=50, dtype=dtype)
    ids = tids.numpy().copy()
    ids[0, :] = [50, 51, 2 ** 31 - 1, -1, 3]
    ids[2, 1] = 49
    want = jbag.embedding_bag(jnp.asarray(ids), jt, interpret=True)
    got = tops.embedding_bag(torch.from_numpy(ids), tt)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    clamped = torch.from_numpy(np.minimum(ids, 49))
    assert torch.equal(got, tops.embedding_bag(clamped, tt))


def test_embedding_bag_registry_sends_cpu_tensors_to_plain_version():
    _, _, tids, tt = _bag_operands(41, 5, 3, 8)
    tsq.reset_launch_counts()
    treg.reset_compile_counts()
    got = treg.embedding_bag(tids, tt)
    assert torch.equal(got, tref.embedding_bag_ref(tids, tt))
    assert tsq.embedding_bag.launches == 0
    assert treg.compile_counts() == {"embedding_bag": 1}


def test_embedding_bag_wrapper_refuses_cpu_tensors():
    _, _, tids, tt = _bag_operands(42, 5, 3, 8)
    tsq.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsq.embedding_bag(tids, tt)
    assert tsq.embedding_bag.launches == 0


# the semantics the CUDA kernel's paths keep (bags of one, the staged wide
# bag), on the plain version against the Pallas kernel in interpret mode
def _bag_case(case, seed, B, F, D, V, dtype):
    jids, jt, tids, tt = _bag_operands(seed, B, F, D, V=V, dtype=dtype)
    ids, table = tids.numpy().copy(), tt.float().numpy().copy()
    if case == "negative zero":
        table[1::2] = -0.0                      # every odd row all -0.0
        ids[:, 0] = 2 * np.arange(B) % V + 1
    elif case == "nan row 0":
        table[0, :] = np.float32(np.nan)
        table[0, ::3] = np.inf
        table[0, 1::3] = -np.inf
        ids[::2, :] = -1                         # padded bags read row 0
    else:                                        # "past V"
        ids[:, 0] = V + np.arange(B)
        ids[0, 0] = 2 ** 31 - 1
        ids[1, 0] = V - 1
    jdt, tdt = DTYPES[dtype]
    jt = jnp.asarray(table).astype(jdt)
    tt = torch.from_numpy(np.array(_bits(jt))).view(tdt)
    return jnp.asarray(ids), jt, torch.from_numpy(ids), tt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 40])
@pytest.mark.parametrize("case", ["negative zero", "nan row 0", "past V"])
def test_embedding_bag_semantics_the_kernel_paths_keep(case, F, dtype):
    """A table of -0.0 rows gives +0.0 (the sum starts at +0.0), a padded
    slot reads row 0 and gives 0 * row0, NaN where row 0 holds a NaN or an
    inf, and an id at or above V reads row V - 1: the plain version equals
    the Pallas kernel, NaN for NaN and bit for bit elsewhere."""
    D = 1 if F > 1 else 64
    jids, jt, tids, tt = _bag_case(case, 50 + F, 12, F, D, 30, dtype)
    want = np.asarray(jbag.embedding_bag(jids, jt, interpret=True))
    got = tops.embedding_bag(tids, tt)
    nan = torch.isnan(got).numpy()
    np.testing.assert_array_equal(nan, np.isnan(want.astype(np.float32)))
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])
    if case == "negative zero" and F == 1:
        assert not _bits(got).any()              # +0.0, all bits clear
    if case == "nan row 0":
        assert nan[::2].all()                    # 0 * NaN and 0 * inf
    if case == "past V":
        clamped = torch.from_numpy(np.minimum(tids.numpy(), 29))
        assert torch.equal(got, tops.embedding_bag(clamped, tt))


# shapes (bags, slots, table rows, row bytes) of every lookup of the recsys
# serve steps: the configs' widths at each serve shape
def _serve_lookups():
    from repro_torch.configs import registry as creg

    out = {}
    for arch in ("dlrm-mlperf", "wide-deep", "mind"):
        spec = creg.get_arch(arch)
        for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
            if shape == "retrieval_cand" and arch != "mind":
                continue
            cfg = spec.make_config(shape)
            b = spec.shapes[shape]["batch"]
            if arch == "mind":
                out[(arch, shape, "history gather")] = (
                    b * cfg.hist_len, 1, cfg.n_items, 4 * cfg.embed_dim)
                continue
            v, f = sum(cfg.vocab_sizes), len(cfg.vocab_sizes)
            size = 2 if arch == "dlrm-mlperf" else 4
            out[(arch, shape, "lookup")] = (b * f, 1, v, size * cfg.embed_dim)
            if arch == "wide-deep":
                out[(arch, shape, "wide bag")] = (b, f, v, 4)
    return out


H100_L2 = 50 * 2 ** 20          # what cudaDevAttrL2CacheSize gives there


def test_bag_order_rule_takes_blocked_for_mind_and_the_deep_lookup():
    """MIND's bulk history gather (13.1 ids a row over a 256 MB table) and
    Wide & Deep's bulk deep lookup (2.6 ids a row over 512 MB) walk their
    bags grouped by range; DLRM (fewer ids than rows), the wide bag (40
    ids a bag) and every serve_p99 and retrieval lookup walk in bag
    order."""
    lookups = _serve_lookups()
    assert len(lookups) == 9
    blocked = {k for k, s in lookups.items()
               if tsq.bag_order(*s, H100_L2) == "blocked"}
    assert blocked == {("mind", "serve_bulk", "history gather"),
                       ("wide-deep", "serve_bulk", "lookup")}
    # the rule's conditions, each alone
    n, v, row = 4_000_000, 1_000_000, 256
    assert tsq.bag_order(n, 1, v, row, H100_L2) == "blocked"
    assert tsq.bag_order(n, 1, v, 128, H100_L2) == "blocked"
    assert tsq.bag_order(n, 2, v, row, H100_L2) == "direct"     # many ids
    assert tsq.bag_order(n, 1, v, 264, H100_L2) == "direct"     # ragged row
    assert tsq.bag_order(v, 1, v, row, H100_L2) == "direct"     # ids <= rows
    assert tsq.bag_order(n, 1, v, row, v * row) == "direct"     # fits the L2


@pytest.mark.parametrize("n_rows,row_bytes,l2,want", [
    (1_000_000, 256, H100_L2, (25_600, 40)),         # MIND's items
    (4_000_000, 128, H100_L2, (51_200, 79)),         # Wide & Deep's deep
    (1000, 256, H100_L2, (25_600, 1)),               # one range
    (187_767_424, 256, H100_L2, (183_367, 1024)),    # capped at 1024 ranges
    (10, 16, 16, (1, 10)),                           # ranges of one row
])
def test_bag_ranges(n_rows, row_bytes, l2, want):
    rows, n = tsq.bag_ranges(n_rows, row_bytes, l2)
    assert (rows, n) == want
    assert n <= tsq.MAX_BAG_RANGES and (n - 1) * rows < n_rows <= n * rows
    keys = tref.bag_range_keys(torch.tensor([-7, -1, 0, n_rows - 1, n_rows,
                                             2 ** 31 - 1], dtype=torch.int32),
                               n_rows, rows)
    # padding reads row 0 (range 0); ids at or past the table row n_rows - 1
    assert keys.tolist() == [0, 0, 0, n - 1, n - 1, n - 1]


def test_bag_range_keys_group_the_rows_in_order():
    rng = np.random.default_rng(60)
    ids = torch.from_numpy(rng.integers(-1, 1200, 5000).astype(np.int32))
    rows, n = tsq.bag_ranges(1000, 64, 64 * 800)
    assert (rows, n) == (100, 10)
    keys = tref.bag_range_keys(ids, 1000, rows)
    row = ids.long().clamp(0, 999)
    assert torch.equal(keys, row // 100)
    assert int(keys.min()) == 0 and int(keys.max()) == n - 1
    assert torch.equal(torch.bincount(keys, minlength=n).sum(),
                       torch.tensor(5000))


_P99_LOOKUPS = sorted(k for k in _serve_lookups() if k[1] != "serve_bulk")


@pytest.mark.parametrize("lookup", _P99_LOOKUPS + [
    ("dlrm-mlperf", "serve_bulk", "lookup"),
    ("wide-deep", "serve_bulk", "wide bag")])
def test_bag_order_in_the_wrapper_skips_the_device_for_bag_order(
        monkeypatch, lookup):
    """The wrapper's order test on every call: each serve_p99 and retrieval
    lookup, DLRM's bulk lookup and the wide bag walk in bag order without
    asking the device for its L2 or reading the table's address (a serve
    batch pays for each call on the host)."""
    B, F, V, row = _serve_lookups()[lookup]

    def no_device(*_):
        raise AssertionError("asked the device")

    class Table:
        data_ptr = no_device
        device = property(no_device)

    monkeypatch.setattr(tsq, "l2_bytes", no_device)
    assert tsq._blocked_ranges(B, F, V, row, Table()) == (0, 0)


@pytest.mark.parametrize("lookup,want", [
    (("mind", "serve_bulk", "history gather"), (25_600, 40)),
    (("wide-deep", "serve_bulk", "lookup"), (51_200, 79))])
def test_bag_order_in_the_wrapper_takes_the_ranges_of_the_l2(monkeypatch,
                                                              lookup, want):
    B, F, V, row = _serve_lookups()[lookup]
    table = torch.zeros(4)
    monkeypatch.setattr(tsq, "l2_bytes", lambda device: H100_L2)
    assert tsq._blocked_ranges(B, F, V, row, table) == want
